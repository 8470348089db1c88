"""INT8 symmetric linear-layer quantization (paper Eqs. 7/9), ported from
``repro.core.quant.linear_quant``: per-output-channel weights, per-tensor
activations with a calibrated static scale."""
from __future__ import annotations

import torch

from repro_torch.core.quant.qtypes import qmax, quantize_sym, sym_scale_from_absmax


def quantize_weight(w: torch.Tensor, bits: int = 8):
    """Per-output-channel symmetric quant; w: [..., in, out] -> (w_q,
    scale [..., out])."""
    absmax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scale = sym_scale_from_absmax(absmax, bits)
    return quantize_sym(w, scale, bits), scale.squeeze(-2)


def fake_quant_activation(x: torch.Tensor, a_scale, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize (the oracle of the int8 path)."""
    q = torch.clamp(torch.round(x / a_scale), -(2 ** (bits - 1)), qmax(bits))
    return q * a_scale


def fake_quant_weight(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-output-channel symmetric quantize-dequantize (PTQ simulation)."""
    w_q, scale = quantize_weight(w, bits)
    return (w_q.to(torch.float32) * scale[..., None, :]).to(w.dtype)
