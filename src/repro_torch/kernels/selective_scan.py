"""Mamba-1 selective scan on the card: h = exp(dt A) h + (dt x) B,
y = h C + D x, with the state kept in registers for the whole sequence.

The CUDA kernels are in ``csrc/selective_scan.cu`` (they replace the Pallas
kernel ``repro/kernels/selective_scan.py:selective_scan``); their plain
version is ``ref.selective_scan_ref``, which ``kernels/ops.py`` takes for CPU
tensors. Two variants compute the same h_last bit for bit:

  * 1, ``states``: a thread holds several states of one channel, the count
    per shape from ``scan_layout``; any state size up to ``MAX_STATE``,
    f32 or bf16 x, dt, B and C. The wrapper always takes it;
  * 2, ``lane``: the first port's kernel, one thread a state, f32 and N in
    ``LANE_STATE_DIMS`` only; kept as the yardstick ``chip_smoke.py`` times
    the states variant against, reached only by ``variant=2``.

``selective_scan.launches`` counts every launch and
``selective_scan.launches_by_mode[name]`` the launches of each variant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

VARIANTS = {1: "states", 2: "lane"}
SCAN_THREADS = 128  # threads of a states block (csrc/selective_scan.cu)
STATES_PER_THREAD = (16, 8, 4)  # the states variant's choices, widest first
MAX_LANES = 32  # lanes sharing a channel: one warp
MAX_STATE = STATES_PER_THREAD[0] * MAX_LANES
LANE_STATE_DIMS = (8, 16)
H100_SMS = 132
# warps a busy SM needs per state a thread: 12 at 16 states, 6 at 8, 3 at 4
# (the layout sweep of chip_smoke.py: [B, 256, 8192, 16], B 1..8)
LATENCY_WARPS_PER_STATE = 0.75
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def scan_layouts(N: int) -> list[tuple[int, int]]:
    """Every (states a thread, lanes a channel) of the states variant that
    covers N padded to a power of two Np >= 4 exactly (lanes x states = Np,
    lanes within one warp), widest states a thread first."""
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {N} not in 1..{MAX_STATE}")
    padded = max(4, 1 << (N - 1).bit_length())
    return [(s, padded // s) for s in STATES_PER_THREAD
            if s <= padded and padded // s <= MAX_LANES]


def scan_layout(B: int, di: int, N: int) -> tuple[int, int]:
    """The states variant's layout for [B, *, di, N]: of ``scan_layouts(N)``
    the one with the least work an SM, ceil(blocks / ``H100_SMS``) x
    states a thread (the blocks come in whole waves), among those that
    give a busy SM at least ``LATENCY_WARPS_PER_STATE`` x states a thread
    warps (a thread's states are independent chains, but a wider thread
    issues fewer of them at once for the latency of its loads and expf to
    hide); ties go to the widest. Where none qualifies, the narrowest
    (most threads)."""
    layouts = scan_layouts(N)
    best = None
    for spt, lanes in layouts:
        blocks = B * -(-di * lanes // SCAN_THREADS)
        per_sm = -(-blocks // H100_SMS)
        if per_sm * SCAN_THREADS // 32 < LATENCY_WARPS_PER_STATE * spt:
            continue
        if best is None or per_sm * spt < best[0]:
            best = (per_sm * spt, (spt, lanes))
    return layouts[-1] if best is None else best[1]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   variant: Optional[int] = None,
                   layout: Optional[tuple[int, int]] = None):
    """x, dt [B, S, di] (dt after softplus), b, c [B, S, N], all four f32
    or all bf16; a f32 [di, N] (negative decay rates), d f32 [di] -> (y
    [B, S, di] in x's dtype, h_last f32 [B, di, N]); CUDA tensors only.
    ``variant`` forces one of ``VARIANTS`` (default: 1); ``layout`` forces
    one of ``scan_layouts(N)`` on the states variant (default:
    ``scan_layout``; ``chip_smoke.py`` checks and times every layout)."""
    variant = 1 if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"selective_scan variant {variant}: one of {VARIANTS}")
    if not (x.dtype == dt.dtype == b.dtype == c.dtype) or x.dtype not in _X_TYPES \
            or a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError("selective_scan takes x, dt, b, c all f32 or all bf16 and f32 "
                        f"a, d, got {[str(t.dtype) for t in (x, dt, b, c, a, d)]}")
    B, S, di = x.shape
    N = b.shape[-1]
    if (dt.shape != x.shape or b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape != (di, N) or d.shape != (di,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, d "
            f"{tuple(d.shape)}")
    if variant == 2 and (x.dtype != torch.float32 or N not in LANE_STATE_DIMS):
        raise ValueError(f"the lane variant takes f32 and N in {LANE_STATE_DIMS}")
    if layout is None:
        layout = scan_layout(B, di, N)
    elif variant != 1 or tuple(layout) not in scan_layouts(N):
        raise ValueError(f"selective_scan layout {layout}: the states variant takes one of "
                         f"{scan_layouts(N)} at N={N}")
    spt, lanes = layout
    _build.require_cuda("selective_scan", x, dt, b, c, a, d)
    x, dt, b, c, a, d = (t.contiguous() for t in (x, dt, b, c, a, d))
    y = torch.empty_like(x)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    ptrs = [t.data_ptr() for t in (x, dt, b, c, a, d, y, h_last)]
    with torch.cuda.device(x.device):
        if variant == 1:
            err = lib.selective_scan_launch(*ptrs, B, S, di, N, _X_TYPES[x.dtype], spt,
                                            lanes, _build.stream(x))
        else:
            err = lib.selective_scan_lane_launch(*ptrs, B, S, di, N, _build.stream(x))
    _build.check(err, f"selective_scan ({VARIANTS[variant]})")
    selective_scan.launches += 1
    mode = VARIANTS[variant]
    selective_scan.launches_by_mode[mode] = selective_scan.launches_by_mode.get(mode, 0) + 1
    return y, h_last


selective_scan.launches = 0
selective_scan.launches_by_mode = {}
