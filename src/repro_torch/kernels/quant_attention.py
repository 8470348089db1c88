"""Streaming attention on the card with the paper's 3-pass log-sqrt2
quantized softmax (CoQMoE sections 4.2(a) + 4.3).

Two CUDA kernels replace the Pallas kernel
``repro/kernels/quant_attention.py:streaming_attention``:

  * ``streaming_attention`` (``csrc/quant_attention.cu``): the non-causal,
    cache-free ``quant_bits > 0`` case the vision models run, with one
    head's K and V held in shared memory;
  * ``lm_attention`` (``csrc/lm_attention.cu``): every mode of the LM path,
    K/V streamed through shared memory in tiles (any length), causal and
    window masks on absolute positions, per-row ``q_offset`` and
    ``kv_valid_len``, packed-prefill segment ids, f32/bf16/int8 K/V with
    per-position scales, ``quant_bits`` 0 (online softmax) or 1..8.

Their plain version is ``ref.flash_attention_ref``, which ``kernels/ops.py``
takes for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_SMEM = 232_448  # dynamic shared memory one H100 block may use
MAX_HEAD_DIM = 128  # lm_attention keeps hd / 32 accumulators a lane
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def fits_in_shared_memory(Sk: int, hd: int) -> bool:
    """Whether ``streaming_attention`` can hold one head's K and V."""
    return _build.library().quant_attention_smem_bytes(Sk, hd) <= MAX_SMEM


def _per_row(x, B: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] integer as a contiguous int32 [B] tensor on
    ``like``'s device; a Python int is filled on the device (no copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int32).expand(B).contiguous()
    return torch.full((B,), int(x), dtype=torch.int32, device=like.device)


def lm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, q_offset=0, quant_bits: int = 0,
                 logit_softcap: float = 0.0, local_window: int = 0,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 kv_valid_len: Optional[torch.Tensor] = None,
                 q_segment_ids: Optional[torch.Tensor] = None,
                 kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q f32 [B, Sq, H, hd], k/v [B, Sk, KVH, hd] f32, bf16 or int8 (int8
    with f32 ``k_scale``/``v_scale`` [B, Sk, KVH]) -> f32 [B, Sq, H, hd]:
    ``ref.flash_attention_ref``'s contract. CUDA tensors only."""
    _build.require_cuda("lm_attention", q, k, v, k_scale, v_scale, kv_valid_len,
                        q_segment_ids, kv_segment_ids)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if q.dtype != torch.float32 or k.dtype != v.dtype or k.dtype not in _KV_TYPES:
        raise TypeError(f"f32 q and f32/bf16/int8 k, v required, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if (k.dtype == torch.int8) != (k_scale is not None) or (
            (k_scale is None) != (v_scale is None)):
        raise ValueError("int8 K/V need both k_scale and v_scale (and only int8 K/V)")
    if not 0 <= quant_bits <= 8:
        raise ValueError(f"quant_bits={quant_bits}: 0 (online softmax) or 1..8")
    if k_scale is not None and (k_scale.shape != (B, Sk, KVH)
                                or v_scale.shape != (B, Sk, KVH)):
        raise ValueError(f"scales must be [B, Sk, KVH] = {(B, Sk, KVH)}")
    kv_seg = q_segment_ids if kv_segment_ids is None else kv_segment_ids
    if q_segment_ids is not None and (q_segment_ids.shape != (B, Sq)
                                      or kv_seg.shape != (B, Sk)):
        raise ValueError("segment ids must be q [B, Sq] and kv [B, Sk]")

    # converted operands stay referenced here until the launch is enqueued
    side = [None if t is None else t.to(dt).contiguous() for t, dt in (
        (k_scale, torch.float32), (v_scale, torch.float32),
        (q_segment_ids, torch.int32), (kv_seg, torch.int32))]
    ks, vs, qseg, kseg = (None if t is None else t.data_ptr() for t in side)
    off = _per_row(q_offset, B, q)
    valid = _per_row(Sk if kv_valid_len is None else kv_valid_len, B, q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().lm_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _KV_TYPES[k.dtype],
            ks, vs, off.data_ptr(), valid.data_ptr(), qseg, kseg,
            out.data_ptr(), B, Sq, Sk, H, KVH, hd,
            int(causal), quant_bits, local_window, float(logit_softcap),
            math.sqrt(hd), _build.stream(q))
    _build.check(err, "lm_attention")
    mode = (f"{'causal' if causal else 'full'}/{str(k.dtype).removeprefix('torch.')}"
            f"/qb{quant_bits}" + ("/segments" if q_segment_ids is not None else "")
            + ("/decode" if Sq == 1 else ""))
    lm_attention.launches += 1
    lm_attention.launches_by_mode[mode] = lm_attention.launches_by_mode.get(mode, 0) + 1
    return out


lm_attention.launches = 0
lm_attention.launches_by_mode = {}
