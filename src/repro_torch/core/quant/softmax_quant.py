"""Post-softmax log-sqrt2 dequantization (CoQMoE section 3.2, Eq. 19),
ported from ``repro.core.quant.softmax_quant``.

    A_hat = 2^{-ceil(A_q/2)} * (1 + odd(A_q) (sqrt2 - 1))

(The paper's Eq. 21 prints floor; ceil is required for odd codes to land on
2^{-(2k+1)/2}.)
"""
from __future__ import annotations

import torch

SQRT2 = 1.4142135623730951


def logsqrt2_dequantize(a_q: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Eq. 19: exponent shift + parity LUT (exact)."""
    a_q = a_q.to(torch.int32)
    shift = (a_q + 1) // 2  # ceil(A_q / 2)
    parity = (a_q & 1).to(dtype)  # 1 at odd codes
    base = torch.exp2(-shift.to(dtype))
    return base * (1.0 + parity * (SQRT2 - 1.0))
