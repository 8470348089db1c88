"""Unified sparse/dense grouped matmul on the card (CoQMoE section 4.2(b)):
y[t] = x[t] @ w[g(t)] over expert-sorted rows, fp32, int8, or W4A8 (int8
rows against a nibble-packed int4 ``uint8`` stack), the integer modes with
the fused per-expert ``w_scale`` and per-tensor ``a_scale`` rescale.

The CUDA kernel is ``csrc/grouped_matmul.cu`` (it replaces the Pallas
kernel ``repro/kernels/expert_linear.py:grouped_matmul``); its plain
versions are ``ref.grouped_matmul_ref`` / ``ref.grouped_matmul_q_ref`` /
``ref.grouped_matmul_q4_ref``, which ``kernels/ops.py`` takes for CPU
tensors.

Every call is one kernel launch: each block derives its work item from
``group_sizes`` itself. ``route_metadata`` is the port of the reference's
``_route_metadata``, the table those blocks derive item by item; the CUDA
path does not call it. Each mode has three variants, and ``choose_variant``
picks one from the shape, the operands' alignment and the mode:

  * 1, ``mma``: tensor-core tiles over (group, 64-row tile) items, for
    groups of many rows (prefill, vision, calibration): s8 MMAs for the
    integer modes, 3xTF32 MMAs for f32 (items start at each group's first
    row, and a warp skips the m16 tiles its item leaves empty);
  * 2, ``stream``: each active expert's weight streamed once per 64-column
    strip, for a few rows a group (decode);
  * 3, ``dp4a`` (integer) or ``fma`` (f32): the first port's tiles, for
    what neither takes (integer: Din % 16 != 0; f32: Din % 8 != 0; either:
    Dout % 8 != 0, or an operand off the 16-byte grid).

Variants 1 and 2 of a mode give the same bits: the integer modes
accumulate exactly, and f32 adds each k8 chunk's 3xTF32 MMAs (x and w cut
into tf32 hi + lo; lo.hi + hi.lo + hi.hi from zero) to the sum in k order
with one rounding, so a row's output depends only on its x row and its
expert's weights. Variant 3 of f32 sums in another order (within f32
rounding of the others).

``grouped_matmul.launches_by_mode`` counts launches per mode (``int8``,
``w4a8``, ``f32``) and per mode and variant (``int8/stream``, ``f32/mma``).

``grouped_wgrad`` is the f32 mode's weight gradient, dw[g] = x[rows of
g]^T @ dy[rows of g] (``csrc/grouped_wgrad.cu``; it replaces no Pallas
kernel: the reference takes XLA's transpose rule of ``ragged_dot``). Its
plain version is ``ref.grouped_wgrad_ref``; ``kernels/autograd.py`` calls
it in the backward of the f32 mode. Two variants, ``choose_wgrad_variant``
picking one from the widths and the operands' alignment:

  * 1, ``mma``: 3xTF32 tensor-core tiles, one block a group and output
    tile, the grid's rows taking the groups heaviest first
    (``wgrad_order``; Din and Dout multiples of 4, operands on the 16-byte
    grid);
  * 2, ``fma``: the first design, f32 FMAs, one block a group and output
    tile walking all of its rows (any width).

Each gives the same bits on the same inputs; the two differ by f32
rounding. ``grouped_wgrad.launches_by_variant`` counts launches per
variant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

BLOCK_M = 64  # row tile of the work items, every variant
VARIANTS = {1: "mma", 2: "stream", 3: "dp4a"}  # the integer modes
F32_VARIANTS = {1: "mma", 2: "stream", 3: "fma"}
WGRAD_VARIANTS = {1: "mma", 2: "fma"}  # grouped_wgrad
WGRAD_RANKED = 256  # grouped_wgrad's mma orders at most this many groups
STREAM_ROWS_PER_GROUP = 2  # variant 2 when T <= 2 G
MAX_GROUPS = 65535  # variant 2's grid has one row of blocks a group


def route_metadata(group_sizes: torch.Tensor, block_m: int, n_work: int):
    """Work-item table of length ``n_work``: (g_ids, m_ids, row_start,
    row_end) int32 per item, one item per (group, row tile) pair that holds
    rows of the group. Padding items carry an empty row range."""
    sizes = group_sizes.to(torch.int32)
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    starts = ends - sizes
    n_m = torch.clamp((ends[-1] + block_m - 1) // block_m, min=1)
    first = starts // block_m
    last = torch.where(sizes > 0, (ends - 1) // block_m, first)
    tiles = torch.where(sizes > 0, last - first + 1, 0).to(torch.int32)
    off = torch.cumsum(tiles, 0, dtype=torch.int32)  # inclusive prefix
    w = torch.arange(n_work, dtype=torch.int32, device=sizes.device)
    active = w < off[-1]
    g = torch.searchsorted(off, w, right=True).clamp(0, sizes.shape[0] - 1)
    off_excl = off - tiles
    m = torch.clamp(first[g] + (w - off_excl[g]), min=0)
    m = torch.minimum(m, n_m - 1)
    zero = torch.zeros((), dtype=torch.int32, device=sizes.device)
    row_start = torch.where(active, starts[g], zero)
    row_end = torch.where(active, ends[g], zero)
    return g.to(torch.int32), m.to(torch.int32), row_start, row_end


def choose_variant(T: int, G: int, Din: int, Dout: int, aligned: bool = True,
                   f32: bool = False) -> int:
    """1, 2 or 3 (see the module docstring) for T sorted rows over G groups,
    [T, Din] @ [G, Din, Dout], in the integer modes or (``f32``) the f32
    mode: the weight-streaming variant when the rows are at most two a
    group on average (a decode tick: nearly every group fits one m16 tile),
    the MMA tiles otherwise, the first port's tiles where neither takes the
    widths."""
    if not takes(1, Din, Dout, aligned, f32):
        return 3
    return 2 if T <= STREAM_ROWS_PER_GROUP * G else 1


def takes(variant: int, Din: int, Dout: int, aligned: bool = True, f32: bool = False) -> bool:
    """Whether ``variant`` computes the integer modes (or, ``f32``, the f32
    mode) at these widths: variant 3 takes every shape; 1 and 2 any row
    count, Din a multiple of 16 (f32: of 8), Dout of 8, operands on the
    16-byte grid."""
    if variant == 3:
        return True
    return (variant in VARIANTS and aligned and Din % (8 if f32 else 16) == 0
            and Dout % 8 == 0)


def choose_wgrad_variant(Din: int, Dout: int, aligned: bool = True) -> int:
    """``grouped_wgrad``'s variant (``WGRAD_VARIANTS``) at these widths: the
    tensor-core tiles wherever they take the shape, else the FMA tiles."""
    return 1 if wgrad_takes(1, Din, Dout, aligned) else 2


def wgrad_takes(variant: int, Din: int, Dout: int, aligned: bool = True) -> bool:
    """Whether ``grouped_wgrad``'s ``variant`` computes these widths:
    variant 2 any; variant 1 Din and Dout multiples of 4 (16-byte rows of x
    and dy for its cp.async stages and of dw for its stores), every operand
    on the 16-byte grid."""
    if variant == 2:
        return True
    return variant == 1 and aligned and Din % 4 == 0 and Dout % 4 == 0


def wgrad_order(group_sizes) -> list:
    """The plain enumeration of the groups in the order ``grouped_wgrad``'s
    variant 1 takes them, one per row of its grid: sizes descending, ties
    by the lower index (up to ``WGRAD_RANKED`` groups; beyond, index order).
    Each block derives its row's group from the sizes on the card."""
    sizes = [int(v) for v in group_sizes]
    if len(sizes) > WGRAD_RANKED:
        return list(range(len(sizes)))
    return sorted(range(len(sizes)), key=lambda g: (-sizes[g], g))


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def integer_mode(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``grouped_matmul`` runs x and w in an integer mode (else f32)."""
    return x.dtype == torch.int8 and w.dtype in (torch.int8, torch.uint8)


def variant_takes(variant: int, x: torch.Tensor, w: torch.Tensor,
                  w_scale: Optional[torch.Tensor] = None) -> bool:
    """Whether ``grouped_matmul(x, w, ..., variant=variant)`` takes these
    operands: ``takes`` at their widths and at the alignment the wrapper
    sees (an operand it copies -- not contiguous, or a scale not f32 -- is
    a fresh allocation, so aligned; its output always is)."""
    in_place = [t for t in (x, w) if t.is_contiguous()]
    if w_scale is not None and w_scale.is_contiguous() and w_scale.dtype == torch.float32:
        in_place.append(w_scale)
    return takes(variant, x.shape[1], w.shape[2], _aligned(*in_place),
                 f32=not integer_mode(x, w))


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   *, w_scale: Optional[torch.Tensor] = None,
                   a_scale=None, variant: Optional[int] = None) -> torch.Tensor:
    """x [T, Din] rows sorted by group, w [G, Din, Dout] (W4A8: uint8
    [G, ceil(Din/2), Dout]), group_sizes [G] (sum == T) -> f32 [T, Dout].
    int8 x with int8 or packed w: integer modes with optional ``w_scale``
    [G, Dout] and ``a_scale``; f32 x and w: fp32 mode, no scales. CUDA
    tensors only. ``variant`` forces one of ``VARIANTS`` (f32:
    ``F32_VARIANTS``; it must take the shape); by default ``choose_variant``
    picks it. One kernel launch a call (none when T == 0)."""
    _build.require_cuda("grouped_matmul", x, w, group_sizes, w_scale, a_scale)
    T, Din = x.shape
    G, w_rows, Dout = w.shape
    packed = w.dtype == torch.uint8
    if w_rows != (-(-Din // 2) if packed else Din) or group_sizes.shape != (G,) or (
            w_scale is not None and w_scale.shape != (G, Dout)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    int8 = integer_mode(x, w)
    if not int8 and not (x.dtype == torch.float32 and w.dtype == torch.float32):
        raise TypeError(f"int8/int8, int8/packed-int4 or f32/f32 operands required, "
                        f"got {x.dtype}, {w.dtype}")
    if not int8 and (w_scale is not None or a_scale is not None):
        raise ValueError("scales apply to integer operands only")
    if not 0 < G <= MAX_GROUPS:
        raise ValueError(f"{G} groups: 1..{MAX_GROUPS} supported")
    out = torch.empty((T, Dout), dtype=torch.float32, device=x.device)
    if T == 0:  # nothing routed
        return out
    sizes = group_sizes.to(torch.int32).contiguous()
    x, w = x.contiguous(), w.contiguous()
    ws = None if w_scale is None else w_scale.to(torch.float32).contiguous()
    aligned = _aligned(x, w, ws, out)
    if variant is None:
        variant = choose_variant(T, G, Din, Dout, aligned, f32=not int8)
    elif not takes(variant, Din, Dout, aligned, f32=not int8):
        raise ValueError(f"grouped_matmul variant {variant} cannot take "
                         f"Din={Din}, Dout={Dout} (16-byte aligned: {aligned})")
    lib, stream = _build.library(), _build.stream(x)
    with torch.cuda.device(x.device):
        if int8:
            as_ = None if a_scale is None else _build.scalar(a_scale, x)
            err = lib.grouped_matmul_i8_launch(
                x.data_ptr(), w.data_ptr(), int(packed), sizes.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if as_ is None else as_.data_ptr(), out.data_ptr(),
                T, G, Din, Dout, variant, stream)
        else:
            err = lib.grouped_matmul_f32_launch(
                x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
                T, G, Din, Dout, variant, stream)
    mode = "w4a8" if packed else ("int8" if int8 else "f32")
    name = (VARIANTS if int8 else F32_VARIANTS)[variant]
    _build.check(err, f"grouped_matmul ({mode}, {name})")
    grouped_matmul.launches += 1
    by_mode = grouped_matmul.launches_by_mode
    for key in (mode, f"{mode}/{name}"):
        by_mode[key] = by_mode.get(key, 0) + 1
    return out


grouped_matmul.launches = 0
grouped_matmul.launches_by_mode = {}


def grouped_wgrad(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor, *,
                  variant: Optional[int] = None) -> torch.Tensor:
    """x [T, Din] and dy [T, Dout] f32, rows sorted by group, group_sizes
    [G] (sum == T) -> dw [G, Din, Dout] f32, dw[g] = x[rows of g]^T @
    dy[rows of g] (zeros for an empty group). CUDA tensors only. One kernel
    launch a call, in ``variant`` (default: ``choose_wgrad_variant``). Each
    output is summed over its group's rows in row order by one block, with
    no float atomics: the same inputs give the same bits."""
    _build.require_cuda("grouped_wgrad", x, dy, group_sizes)
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"f32 x and dy required, got {x.dtype}, {dy.dtype}")
    T, Din = x.shape
    G = group_sizes.shape[0]
    if dy.dim() != 2 or dy.shape[0] != T or group_sizes.dim() != 1:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    if not 0 < G <= MAX_GROUPS:
        raise ValueError(f"{G} groups: 1..{MAX_GROUPS} supported")
    Dout = dy.shape[1]
    dw = torch.empty((G, Din, Dout), dtype=torch.float32, device=x.device)
    sizes = group_sizes.to(torch.int32).contiguous()
    x, dy = x.contiguous(), dy.contiguous()
    aligned = _aligned(x, dy, dw)
    if variant is None:
        variant = choose_wgrad_variant(Din, Dout, aligned)
    elif not wgrad_takes(variant, Din, Dout, aligned):
        raise ValueError(f"grouped_wgrad variant {variant} cannot take Din={Din}, "
                         f"Dout={Dout} (16-byte aligned: {aligned})")
    with torch.cuda.device(x.device):
        err = _build.library().grouped_wgrad_launch(
            x.data_ptr(), dy.data_ptr(), sizes.data_ptr(), dw.data_ptr(), T, G, Din, Dout,
            variant, _build.stream(x))
    name = WGRAD_VARIANTS[variant]
    _build.check(err, f"grouped_wgrad ({name})")
    grouped_wgrad.launches += 1
    grouped_wgrad.launches_by_variant[name] = grouped_wgrad.launches_by_variant.get(name, 0) + 1
    return dw


grouped_wgrad.launches = 0
grouped_wgrad.launches_by_variant = {}
