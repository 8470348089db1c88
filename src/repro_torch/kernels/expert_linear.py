"""Unified sparse/dense grouped matmul on the card (CoQMoE section 4.2(b)):
y[t] = x[t] @ w[g(t)] over expert-sorted rows, fp32 or int8 with the fused
per-expert ``w_scale`` and per-tensor ``a_scale`` rescale.

The CUDA kernel is ``csrc/grouped_matmul.cu`` (it replaces the Pallas
kernel ``repro/kernels/expert_linear.py:grouped_matmul``); its plain
versions are ``ref.grouped_matmul_ref`` / ``ref.grouped_matmul_q_ref``,
which ``kernels/ops.py`` takes for CPU tensors. The work table is the port
of the reference's ``_route_metadata``, built with torch ops on the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

BLOCK_M = 64  # row tile of the work table; the kernel refuses any other


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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   *, w_scale: Optional[torch.Tensor] = None,
                   a_scale=None) -> torch.Tensor:
    """x [T, Din] rows sorted by group, w [G, Din, Dout], group_sizes [G]
    (sum == T) -> f32 [T, Dout]. int8 x and w: int8 mode with optional
    ``w_scale`` [G, Dout] and ``a_scale``; f32 x and w: fp32 mode, no
    scales. CUDA tensors only."""
    _build.require_cuda("grouped_matmul", x, w, group_sizes, w_scale, a_scale)
    if w.dtype == torch.uint8:
        raise NotImplementedError(
            "nibble-packed int4 (W4A8) expert stacks are not ported to CUDA yet")
    T, Din = x.shape
    G, Din2, Dout = w.shape
    if Din != Din2 or group_sizes.shape != (G,) or (
            w_scale is not None and w_scale.shape != (G, Dout)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    int8 = x.dtype == torch.int8 and w.dtype == torch.int8
    if not int8 and not (x.dtype == torch.float32 and w.dtype == torch.float32):
        raise TypeError(f"int8/int8 or f32/f32 operands required, got {x.dtype}, {w.dtype}")
    if not int8 and (w_scale is not None or a_scale is not None):
        raise ValueError("scales apply to int8 operands only")
    out = torch.empty((T, Dout), dtype=torch.float32, device=x.device)
    if T == 0:  # nothing routed
        return out
    n_work = -(-T // BLOCK_M) + G
    g_ids, m_ids, row_start, row_end = route_metadata(group_sizes, BLOCK_M, n_work)
    x, w = x.contiguous(), w.contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        if int8:
            ws = None if w_scale is None else w_scale.to(torch.float32).contiguous()
            as_ = None if a_scale is None else _build.scalar(a_scale, x)
            err = lib.grouped_matmul_i8_launch(
                x.data_ptr(), w.data_ptr(), g_ids.data_ptr(), m_ids.data_ptr(),
                row_start.data_ptr(), row_end.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if as_ is None else as_.data_ptr(), out.data_ptr(),
                Din, Dout, n_work, BLOCK_M, _build.stream(x))
        else:
            err = lib.grouped_matmul_f32_launch(
                x.data_ptr(), w.data_ptr(), g_ids.data_ptr(), m_ids.data_ptr(),
                row_start.data_ptr(), row_end.data_ptr(), out.data_ptr(),
                Din, Dout, n_work, BLOCK_M, _build.stream(x))
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
