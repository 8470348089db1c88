"""Mamba-1 selective scan on the card: h = exp(dt A) h + (dt x) B,
y = h C + D x, with the state kept in registers for the whole sequence.

The CUDA kernel is ``csrc/selective_scan.cu`` (it replaces the Pallas kernel
``repro/kernels/selective_scan.py:selective_scan``); its plain version is
``ref.selective_scan_ref``, which ``kernels/ops.py`` takes for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)  # built for: falcon-mamba-7b (16) and its smoke config (8)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """x, dt f32 [B, S, di] (dt after softplus), b, c f32 [B, S, N], a f32
    [di, N] (negative decay rates), d f32 [di] -> (y f32 [B, S, di],
    h_last f32 [B, di, N]); CUDA tensors only."""
    _build.require_cuda("selective_scan", x, dt, b, c, a, d)
    args = (x, dt, b, c, a, d)
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("selective_scan takes f32 operands, got "
                        f"{[str(t.dtype) for t in args]}")
    B, S, di = x.shape
    N = b.shape[-1]
    if (dt.shape != x.shape or b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape != (di, N) or d.shape != (di,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, d "
            f"{tuple(d.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"selective_scan: state size {N} not in {STATE_DIMS}")
    x, dt, b, c, a, d = (t.contiguous() for t in args)
    y = torch.empty_like(x)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
            d.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, di, N,
            _build.stream(x))
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
