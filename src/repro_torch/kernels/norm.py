"""RMSNorm on the card: y = x * rsqrt(mean(x^2) + eps) * (1 + gamma) over
the last dim, one launch a call.

The CUDA kernel is ``csrc/rmsnorm.cu`` (it replaces the reference's plain
XLA ``repro/models/layers.py:rmsnorm``); its plain version is
``ref.rmsnorm_ref``, which ``kernels/ops.py`` takes for CPU tensors. One
warp sums a row in an order fixed by the row's width alone, so a row gives
the same bits among 8 rows (a decode tick) as among 512 (a packed prefill).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] f32 or bf16, gamma [D] f32 or bf16 -> y in x's dtype
    (``ref.rmsnorm_ref``'s contract). CUDA tensors only. A view whose rows
    lie one stride apart (``x[:, -1:]``) is read in place: one launch."""
    if x.dtype not in _BF16 or gamma.dtype not in _BF16:
        raise TypeError(f"rmsnorm takes f32 or bf16 x and gamma, got {x.dtype}, {gamma.dtype}")
    D = x.shape[-1]
    if gamma.shape != (D,):
        raise ValueError(f"gamma {tuple(gamma.shape)} for rows of {D}")
    _build.require_cuda("rmsnorm", x, gamma)
    rows = x.reshape(-1, D) if D else x  # a view wherever one row stride spans the rows
    if D and rows.stride(-1) != 1:
        rows = rows.contiguous()
    gamma = gamma.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().rmsnorm_launch(
            rows.data_ptr(), gamma.data_ptr(), y.data_ptr(), x.numel() // max(D, 1), D,
            rows.stride(0) if D else 0, _BF16[x.dtype], _BF16[gamma.dtype], float(eps),
            _build.stream(x))
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
