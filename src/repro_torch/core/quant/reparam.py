"""Post-norm scale reparameterization (CoQMoE section 3.1, Eqs. 10-16),
ported from ``repro.core.quant.reparam``.

Converts *per-channel asymmetric* quantization of post-norm activations
into *per-layer symmetric* quantization by folding transformation factors
into the norm's (gamma, beta) and inversely into every consumer linear
layer's (W, b): the QKV projections, the MLP's fc1, and in MoE blocks every
expert's fc1 and the gate (Eqs. 15-16).

The paper's Eq. 10 prints ``r1 = s_tilde / s``; the equivalence of Eq. 13
with integer-grid alignment needs ``r1 = s / s_tilde`` (the RepQ-ViT
convention), which the reference uses and so does this port. With it:

    X'_d = (X_d + s_d r2_d) / r1_d            (Eq. 12)
    round(X'_d / s_tilde) = round(X_d / s_d) + z_d - 2^{b-1}

so per-layer symmetric quantization of X' reproduces the per-channel
asymmetric integer grid of X exactly, and

    X' (diag(r1) W) + (b - W^T (s . r2)) == X W + b   (Eq. 13, any r1)

RMSNorm (no additive beta): per-channel *symmetric* scales (z == 2^{b-1},
r2 == 0), and only r1 is folded. ``core/quant/ptq.py`` keeps its own
inline fold over stacked layers, as the reference's does; these are the
per-tensor functions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.quant.qtypes import qmax


class ReparamFactors(NamedTuple):
    r1: torch.Tensor  # f32 [D]   = s / s_tilde
    r2: torch.Tensor  # f32 [D]   = z - 2^{b-1}  (zeros for symmetric / RMSNorm)
    s: torch.Tensor  # f32 [D]    per-channel scales (calibrated)
    s_tilde: torch.Tensor  # f32 scalar  unified per-layer scale


# ---------------------------------------------------------------------------
# calibration of the per-channel quantizer (offline only)
# ---------------------------------------------------------------------------

def calibrate_per_channel_asym(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned-convention per-channel asymmetric params from samples x
    [..., D]: (s [D], z [D]) with X_qu = round(X / s) + z in [0, 2^b - 1].
    z is not clipped into [0, 2^b - 1]: a channel whose range does not
    straddle zero needs an out-of-range zero point for an exact grid; the
    reparameterization folds it away."""
    flat = x.reshape(-1, x.shape[-1])
    xmin = torch.amin(flat, dim=0)
    xmax = torch.amax(flat, dim=0)
    span = torch.clamp(xmax - xmin, min=1e-8)
    s = span / (2**bits - 1)
    z = torch.round(-xmin / s)
    return s.to(torch.float32), z.to(torch.float32)


def calibrate_per_channel_sym(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-channel symmetric scales (the RMSNorm path: no zero point)."""
    flat = x.reshape(-1, x.shape[-1])
    absmax = torch.clamp(torch.amax(torch.abs(flat), dim=0), min=1e-8)
    return (absmax / qmax(bits)).to(torch.float32)


def factors_from_minmax(xmin: torch.Tensor, xmax: torch.Tensor, bits: int,
                        symmetric: bool) -> ReparamFactors:
    """Factors straight from calibrated per-channel min / max (a
    ``TapCollector``'s). ``symmetric`` is the RMSNorm path: per-channel
    symmetric scales, r2 == 0."""
    if symmetric:
        absmax = torch.clamp(torch.maximum(torch.abs(xmin), torch.abs(xmax)), min=1e-8)
        return reparam_factors((absmax / qmax(bits)).to(torch.float32), None, bits)
    span = torch.clamp(xmax - xmin, min=1e-8)
    s = span / (2**bits - 1)
    z = torch.round(-xmin / s)
    return reparam_factors(s.to(torch.float32), z.to(torch.float32), bits)


def reparam_factors(s: torch.Tensor, z: Optional[torch.Tensor], bits: int) -> ReparamFactors:
    """Eq. 10 (corrected): r1 = s / s_tilde, r2 = z - 2^{b-1}; s_tilde = E[s]."""
    s_tilde = torch.mean(s)
    r1 = s / s_tilde
    r2 = torch.zeros_like(s) if z is None else z - 2.0 ** (bits - 1)
    return ReparamFactors(r1=r1, r2=r2, s=s, s_tilde=s_tilde)


# ---------------------------------------------------------------------------
# folding (Eqs. 11, 14, 15, 16)
# ---------------------------------------------------------------------------

def apply_to_layernorm(gamma: torch.Tensor, beta: torch.Tensor,
                       f: ReparamFactors) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 11: beta' = (beta + s r2) / r1, gamma' = gamma / r1."""
    return gamma / f.r1, (beta + f.s * f.r2) / f.r1


def apply_to_rmsnorm(gamma: torch.Tensor, f: ReparamFactors) -> torch.Tensor:
    """The RMSNorm variant: r2 == 0 by construction, r1 folded alone."""
    return gamma / f.r1


def apply_to_consumer(w: torch.Tensor, b: Optional[torch.Tensor],
                      f: ReparamFactors) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 14 (and 15 / 16 for the experts and the gate): W' = diag(r1) W,
    b' = b - W^T (s r2), for a consumer weight w [D, out] whose input is the
    reparameterized activation."""
    corr = torch.einsum("do,d->o", w, f.s * f.r2)
    return w * f.r1[:, None], (b if b is not None else 0.0) - corr


def transform_activation(x: torch.Tensor, f: ReparamFactors) -> torch.Tensor:
    """Eq. 12 (a reference: at run time the fold into gamma / beta does it)."""
    return (x + f.s * f.r2) / f.r1
