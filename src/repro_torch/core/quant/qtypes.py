"""Quantization primitives: symmetric uniform quantizer (paper Eq. 7) and
int4 nibble packing, ported from ``repro.core.quant.qtypes``.

``quantize_sym`` divides by the scale and rounds half to even, as
``jnp.round`` does (``torch.round`` is half-to-even too); multiplying by a
reciprocal instead would move values that sit on a rounding boundary.
"""
from __future__ import annotations

from typing import Optional

import torch

# QuantizedParams leaf naming: a stored-integer weight ``<key>`` rides with a
# per-output-channel dequant scale ``<key>_scale`` and, where a calibrated
# static activation scale exists, a folded per-site scale ``<key>_as``.
SCALE_SUFFIX = "_scale"
ASCALE_SUFFIX = "_as"


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def qmin(bits: int) -> int:
    return -(2 ** (bits - 1))


def sym_scale_from_absmax(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-8) / qmax(bits)


def quantize_sym(x: torch.Tensor, scale, bits: int) -> torch.Tensor:
    q = torch.round(x / scale)
    return torch.clamp(q, qmin(bits), qmax(bits)).to(
        torch.int8 if bits <= 8 else torch.int16)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued ``q`` ([..., Din, Dout], values in [-8, 7]) into
    nibble-packed ``uint8`` [..., ceil(Din/2), Dout]: the low nibble holds
    the even input row 2p, the high nibble the odd row 2p+1; an odd Din is
    zero-padded."""
    if q.shape[-2] % 2:
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
    lo = q[..., 0::2, :].to(torch.int32) & 0xF
    hi = q[..., 1::2, :].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, din: Optional[int] = None) -> torch.Tensor:
    """Invert :func:`pack_int4`: ``uint8`` [..., P, Dout] -> sign-extended
    int4 values held in ``int8`` [..., din (default 2*P), Dout]."""
    b = packed.to(torch.int32)
    lo = b & 0xF
    hi = (b >> 4) & 0xF
    # two's-complement sign extension of a 4-bit field: v - 16*(v>>3)
    lo = lo - ((lo & 0x8) << 1)
    hi = hi - ((hi & 0x8) << 1)
    full = torch.stack([lo, hi], dim=-2)  # [..., P, 2, Dout]
    full = full.reshape(packed.shape[:-2] + (2 * packed.shape[-2],
                                             packed.shape[-1]))
    if din is not None:
        full = full[..., :din, :]
    return full.to(torch.int8)
