"""Streaming attention on the card with the paper's 3-pass log-sqrt2
quantized softmax (CoQMoE sections 4.2(a) + 4.3).

The CUDA kernel is ``csrc/quant_attention.cu`` (it replaces the Pallas
kernel ``repro/kernels/quant_attention.py:streaming_attention`` for the
non-causal ``quant_bits > 0`` case the vision models run); its plain version
is ``ref.flash_attention_ref``, which ``kernels/ops.py`` takes for CPU
tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_SMEM = 232_448  # dynamic shared memory one H100 block may use


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, quant_bits: int) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Sk, KVH, hd] f32 -> [B, Sq, H, hd] f32,
    non-causal, ``quant_bits`` in 1..8. CUDA tensors only."""
    _build.require_cuda("streaming_attention", q, k, v)
    if not 0 < quant_bits <= 8:
        raise NotImplementedError(
            f"quant_bits={quant_bits}: only the 3-pass quantized schedule "
            "(1..8 bits) is ported to CUDA")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"f32 q/k/v required, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    lib = _build.library()
    smem = lib.quant_attention_smem_bytes(Sk, hd)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"Sk={Sk}, hd={hd}: K and V of one head must fit in shared memory "
            f"({smem} > {MAX_SMEM} bytes); longer sequences need the "
            "streaming kernel of the LM path")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.quant_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KVH, hd, quant_bits, 1.0 / math.sqrt(hd), _build.stream(q))
    _build.check(err, "streaming_attention")
    streaming_attention.launches += 1
    return out


streaming_attention.launches = 0
