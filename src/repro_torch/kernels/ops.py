"""Dispatch to the hand-written kernels, ported from ``repro.kernels.ops``.

The device of the tensors chooses, and nothing else: a CUDA tensor goes to
the CUDA kernel (which launches or raises), a CPU tensor to the kernel's
plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.core.quant.linear_quant import fake_quant_activation
from repro_torch.core.quant.qtypes import quantize_sym
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.expert_linear import grouped_matmul as _gmm_kernel
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_kernel
from repro_torch.kernels.norm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.quant_attention import (
    fits_in_shared_memory,
    lm_attention,
    streaming_attention,
)
from repro_torch.kernels.selective_scan import selective_scan as _scan_kernel


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset=0, quant_bits: int = 0,
              logit_softcap: float = 0.0, local_window: int = 0,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              kv_valid_len: Optional[torch.Tensor] = None,
              q_segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming attention over [B, S, H, hd] (GQA-native k/v), the
    reference's keyword contract. On the card the non-causal, cache-free,
    quantized f32 case of the vision models takes ``streaming_attention``
    (K/V of a head in shared memory) while it fits; every other case takes
    ``lm_attention``."""
    kw = dict(causal=causal, q_offset=q_offset, quant_bits=quant_bits,
              logit_softcap=logit_softcap, local_window=local_window,
              k_scale=k_scale, v_scale=v_scale, kv_valid_len=kv_valid_len,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    if not q.is_cuda:
        return _ref.flash_attention_ref(q, k, v, **kw)
    vision = (not causal and quant_bits > 0 and not logit_softcap
              and not local_window and isinstance(q_offset, int) and q_offset == 0
              and k_scale is None and kv_valid_len is None and q_segment_ids is None
              and q.dtype == k.dtype == v.dtype == torch.float32
              and fits_in_shared_memory(k.shape[1], q.shape[-1]))
    if vision:
        return streaming_attention(q, k, v, quant_bits=quant_bits)
    return lm_attention(q, k, v, **kw)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   *, w_scale: Optional[torch.Tensor] = None,
                   a_scale: Optional[torch.Tensor] = None,
                   a_bits: int = 8) -> torch.Tensor:
    """Unified sparse/dense linear: y[t] = x[t] @ w[group(t)].

    int8 weights and nibble-packed int4 (``uint8``, W4A8) stacks execute as
    stored: an fp ``x`` is quantized here with the folded ``a_scale``, the
    contraction accumulates in int32 and the product-of-scales dequant
    lands once on the accumulator."""
    integer_w = w.dtype in (torch.int8, torch.uint8)
    if integer_w and x.dtype != torch.int8:
        if a_scale is None:
            raise ValueError(
                f"{'int4' if w.dtype == torch.uint8 else 'int8'} grouped weights "
                "need the folded activation scale (a PTQ QuantizedParams tree "
                "carries it as the `wi_as` / `wo_a_scale` leaf)")
        x = quantize_sym(x.float(), a_scale, a_bits)
    if x.is_cuda:
        return _gmm_kernel(x, w, group_sizes, w_scale=w_scale, a_scale=a_scale)
    if w.dtype == torch.uint8:
        return _ref.grouped_matmul_q4_ref(x, w, group_sizes, w_scale, a_scale)
    if w.dtype == torch.int8:
        return _ref.grouped_matmul_q_ref(x, w, group_sizes, w_scale, a_scale)
    return _ref.grouped_matmul_ref(x, w, group_sizes)


def row_groups(group_sizes: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Group id of each row of an expert-sorted buffer."""
    ends = torch.cumsum(group_sizes, 0)
    rows = torch.arange(n_rows, device=group_sizes.device, dtype=ends.dtype)
    return torch.searchsorted(ends, rows, right=True)


def grouped_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                group_sizes: torch.Tensor, *, act: str = "silu", glu: bool = True,
                bi: Optional[torch.Tensor] = None, bo: Optional[torch.Tensor] = None,
                taps=None, mid_a_scale: Optional[torch.Tensor] = None,
                a_bits: int = 8, wi_scale: Optional[torch.Tensor] = None,
                wo_scale: Optional[torch.Tensor] = None,
                wi_a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert MLP over sorted rows: fc1 (+bi) -> act -> fc2 (+bo), with the
    fc2 input quantized by ``mid_a_scale`` (int8 or packed-int4 fc2: the
    real quantizer; fp fc2: its fake-quant oracle)."""
    from repro_torch.models.layers import act_fn  # lazy: layers imports ops

    seg = None
    if bi is not None or bo is not None:
        seg = row_groups(group_sizes, x.shape[0])
    h = grouped_matmul(x, wi, group_sizes, w_scale=wi_scale,
                       a_scale=wi_a_scale, a_bits=a_bits)
    if bi is not None:
        h = h + bi[seg]
    if glu:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act_fn(act)(g) * u
    else:
        h = act_fn(act)(h)
    maybe_record(taps, "moe_mid", h)
    if wo.dtype in (torch.int8, torch.uint8):
        y = grouped_matmul(h, wo, group_sizes, w_scale=wo_scale,
                           a_scale=mid_a_scale, a_bits=a_bits)
    else:
        if mid_a_scale is not None:
            h = fake_quant_activation(h.float(), mid_a_scale, bits=a_bits).to(h.dtype)
        y = grouped_matmul(h, wo, group_sizes)
    if bo is not None:
        y = y + bo[seg]
    return y


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 matmul with the Eq. 9 rescale at the flush."""
    if x_q.is_cuda:
        return _int8_kernel(x_q, w_q, x_scale, w_scale, bias)
    return _ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale, bias)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, (1 + gamma) scale; on the card one launch
    whose row sums do not depend on the number of rows."""
    if x.is_cuda:
        return _rmsnorm_kernel(x, gamma, eps)
    return _ref.rmsnorm_ref(x, gamma, eps)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """Mamba-1 selective scan, the state on-chip for the whole sequence
    (O(S d) device-memory traffic). Returns (y [B, S, di], h_last
    [B, di, N] f32)."""
    if x.is_cuda:
        return _scan_kernel(x, dt, b, c, a, d)
    return _ref.selective_scan_ref(x, dt, b, c, a, d)
