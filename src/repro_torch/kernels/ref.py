"""Plain PyTorch versions of the hand-written kernels (the ``ref.py``
contract), ported from ``repro.kernels.ref``.

They are the CPU path of ``kernels/ops.py`` and the ground truth the CUDA
kernels are held against on the card. Integer products are taken in
float64, whose 53-bit mantissa holds every int8 x int8 sum of these widths
exactly (127^2 * K < 2^53): the result is the int32 accumulator of the
reference, on any device, whatever order the sum runs in (CUDA has no
integer matmul).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant.softmax_quant import logsqrt2_dequantize

LOG2E = 1.4426950408889634  # log2(e)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, quant_bits: int = 0) -> torch.Tensor:
    """Non-causal attention over q [B, Sq, H, hd] and GQA k/v [B, Sk, KVH,
    hd], with the log-sqrt2 quantized softmax numerator when ``quant_bits``
    > 0 (paper sections 3.2/4.3): codes are taken against the exact row
    max, the denominator is the exact sum of exp(s - m)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    m = torch.clamp(torch.amax(scores, dim=-1, keepdim=True), min=-1e30)
    f = torch.exp(scores - m)
    l = torch.sum(f, dim=-1, keepdim=True)
    if quant_bits > 0:
        # Eq. 18 in affine-code form: -2 log2(exp(s - m)) == -2 log2(e) (s - m)
        codes = torch.clamp(
            torch.round(-2.0 * LOG2E * (scores - m)), 0, 2**quant_bits - 1)
        f = logsqrt2_dequantize(codes.to(torch.int32))
    out = torch.einsum("bkgqs,bskh->bqkgh", f, v.float()) / torch.clamp(
        l.permute(0, 3, 1, 2, 4), min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _group_bounds(group_sizes: torch.Tensor):
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    return zip([0] + ends[:-1], ends)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Row t multiplies the weight of its group: y[t] = x[t] @ w[g(t)]
    (x: [T, Din] sorted by group; w: [G, Din, Dout])."""
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for g, (s, e) in enumerate(_group_bounds(group_sizes)):
        if e > s:
            y[s:e] = x[s:e].float() @ w[g].float()
    return y.to(x.dtype)


def grouped_matmul_q_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                         group_sizes: torch.Tensor, w_scale: torch.Tensor,
                         a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 grouped product: exact integer accumulate, then the Eq. 9
    product-of-scales rescale (per-expert per-channel, then per-tensor)."""
    acc = torch.zeros((x_q.shape[0], w_q.shape[2]), dtype=torch.float64,
                      device=x_q.device)
    seg = torch.zeros(x_q.shape[0], dtype=torch.long, device=x_q.device)
    for g, (s, e) in enumerate(_group_bounds(group_sizes)):
        if e > s:
            acc[s:e] = x_q[s:e].double() @ w_q[g].double()
            seg[s:e] = g
    y = acc.float() * w_scale[seg]
    if a_scale is not None:
        y = y * a_scale
    return y


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8: int8 [M, K] x int8 [K, N] -> f32(acc) * (x_scale * w_scale[n])
    (+ bias[n])."""
    acc = x_q.double() @ w_q.double()
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias
    return y
