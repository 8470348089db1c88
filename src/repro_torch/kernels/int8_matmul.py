"""W8A8 matmul on the card (paper Eqs. 7/9): int8 x int8 -> int32 tiles,
one product-of-scales rescale at the flush, bias fused into it.

The CUDA kernel is ``csrc/int8_matmul.cu`` (it replaces the Pallas kernel
``repro/kernels/int8_matmul.py:int8_matmul``); its plain version is
``ref.int8_matmul_ref``, which ``kernels/ops.py`` takes for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_q int8 [M, K] @ w_q int8 [K, N] -> f32 [M, N] with
    ``float(acc) * (x_scale * w_scale[n]) (+ bias[n])``; CUDA tensors only."""
    _build.require_cuda("int8_matmul", x_q, w_q, x_scale, w_scale, bias)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x_q.dtype}, {w_q.dtype}")
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2 or w_scale.shape != (N,):
        raise ValueError(f"shape mismatch: x {tuple(x_q.shape)}, w "
                         f"{tuple(w_q.shape)}, w_scale {tuple(w_scale.shape)}")
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    xs = _build.scalar(x_scale, x_q)
    ws = w_scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    with torch.cuda.device(x_q.device):
        err = _build.library().int8_matmul_launch(
            x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
            _build.stream(x_q))
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
