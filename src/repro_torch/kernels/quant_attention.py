"""Streaming attention on the card with the paper's 3-pass log-sqrt2
quantized softmax (CoQMoE sections 4.2(a) + 4.3).

Two CUDA kernels replace the Pallas kernel
``repro/kernels/quant_attention.py:streaming_attention``:

  * ``streaming_attention`` (``csrc/quant_attention.cu``): the non-causal,
    cache-free ``quant_bits > 0`` case the vision models run: 32 query rows
    a block, K and then V streamed in 64-key chunks, scores and P.V formed
    from 4 x 4 register micro-tiles, the tile's scores kept in shared
    memory (``vision_layout``);
  * ``lm_attention`` (``csrc/lm_attention.cu``): every mode of the LM path,
    causal and window masks on absolute positions, per-row ``q_offset`` and
    ``kv_valid_len`` (a [B] tensor, or a Python int passed as a scalar),
    packed-prefill segment ids, f32/bf16/int8 K/V with per-position scales,
    ``quant_bits`` 0 or 1..8, any head dim up to 256 (two head-dim
    classes, <= 128 and <= 256, each its own instantiation). One launch a
    call, of one of two schedules that ``choose_schedule`` picks:
    ``decode`` (hd 128 or 256: a block a KV head and all its <= 4 query
    rows; K and V read once, the scores held in shared memory) and ``tile``
    (16 query rows a block, K/V tiles double-buffered -- one tile at a time
    for f32 K/V above hd 128, whose two stages would not fit -- dead tiles
    skipped by position and by segment).
    With segment ids the tile schedule is keyed to the segment: its blocks
    are cut at every change of q id and start their key tiles at the
    segment's first key (``tests/test_torch_attention.py`` models the
    plan), so a packed prefill gives a prompt's rows the bits of a prefill
    of that prompt alone.
    Both form q.k with the same exact split-precision tensor-core products
    (q in three bf16 pieces against int8 and bf16 K, three tf32 pieces of
    q and two of k against f32 K), so they give the same scores and codes
    bit for bit.

Their plain version is ``ref.flash_attention_ref``, which ``kernels/ops.py``
takes for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_SMEM = 232_448  # dynamic shared memory one H100 block may use
MAX_HEAD_DIM = 128  # the widest head of the vision tile kernel
LM_MAX_HEAD_DIM = 256  # the widest head of lm_attention
# lm_attention's schedules: 0 decode (K/V streamed once, scores kept in
# shared memory), 1 tile (16 query rows a block)
SCHEDULES = {0: "decode", 1: "tile"}
DECODE_HEAD_DIMS = (128, 256)  # one decode instantiation each
DECODE_MAX_ROWS = 4  # query rows a decode block: Sq x H/KVH
DECODE_SCORE_BYTES = 64 * 1024  # the decode block's f32 scores, rows x Sk
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


VISION_ROWS = 32  # query rows of a tile block: 8 row lanes x 4
VISION_KEYS = 64  # keys of a staged K or V chunk: 16 key lanes x 4
VISION_HEAD_DIMS = (16, 32, 64, 128)  # hd is zero-padded to the first >= hd


def vision_layout(Sk: int, hd: int) -> tuple[int, int, int]:
    """The vision kernel's shared memory for Sk keys of head dim hd <=
    ``MAX_HEAD_DIM``: (padded head dim, the score tile's row in floats,
    bytes). A q tile of ``VISION_ROWS`` rows of hdp + 4 floats; the score
    tile, its rows Sk rounded up to 16 floats, 16 more where that is a
    multiple of 32 (the two row lanes of a warp then write 32 distinct
    banks); two ``VISION_KEYS``-key chunk slots of hdp + 4 floats a row."""
    hdp = next(p for p in VISION_HEAD_DIMS if p >= hd)
    ps_ld = -(-Sk // 16) * 16
    ps_ld += 16 if ps_ld % 32 == 0 else 0
    floats = VISION_ROWS * (hdp + 4) + VISION_ROWS * ps_ld + 2 * VISION_KEYS * (hdp + 4)
    return hdp, ps_ld, 4 * floats


def fits_in_shared_memory(Sk: int, hd: int) -> bool:
    """Whether ``streaming_attention`` takes Sk keys of head dim hd."""
    return 0 < hd <= MAX_HEAD_DIM and Sk > 0 and vision_layout(Sk, hd)[2] <= MAX_SMEM


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, quant_bits: int) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Sk, KVH, hd] f32 -> [B, Sq, H, hd] f32,
    non-causal, ``quant_bits`` in 1..8. CUDA tensors only; Sk and hd as
    ``fits_in_shared_memory`` admits."""
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
    if not fits_in_shared_memory(Sk, hd):
        raise NotImplementedError(
            f"Sk={Sk}, hd={hd}: the tile block's shared memory exceeds {MAX_SMEM} "
            f"bytes or hd > {MAX_HEAD_DIM}; longer sequences take lm_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    hdp, ps_ld, _ = vision_layout(Sk, hd)
    with torch.cuda.device(q.device):
        err = _build.library().quant_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KVH, hd,
            hdp, ps_ld, quant_bits, math.sqrt(hd), _build.stream(q))
    _build.check(err, "streaming_attention")
    streaming_attention.launches += 1
    return out


streaming_attention.launches = 0


def choose_schedule(Sq: int, Sk: int, H: int, KVH: int, hd: int,
                    aligned: bool = True) -> int:
    """``lm_attention``'s schedule: 0 (decode: one block a KV head holds
    the scores of its <= 4 query rows, so K and V are each read once) when
    hd is one of ``DECODE_HEAD_DIMS``, the operands are 16-byte aligned, Sq
    x H/KVH <= 4 and those scores fit ``DECODE_SCORE_BYTES``; else 1
    (tile)."""
    rows = Sq * (H // KVH)
    if (hd in DECODE_HEAD_DIMS and aligned and rows <= DECODE_MAX_ROWS
            and 4 * rows * Sk <= DECODE_SCORE_BYTES):
        return 0
    return 1


TILE_ROWS = 16  # the tile schedule's query rows a block


def _offset(x, B: int, like: torch.Tensor):
    """A [B] (or broadcastable) integer tensor as a contiguous int32 [B]
    tensor on ``like``'s device and no scalar, or a Python int as the
    scalar and no tensor (nothing is launched for it)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int32).expand(B).contiguous(), 0
    return None, int(x)


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def schedule_takes(schedule: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``lm_attention(q, k, v, ..., schedule=schedule)`` takes these
    operands: the tile schedule always, the decode schedule where
    ``choose_schedule`` picks it at the alignment the wrapper sees (an
    operand it copies is a fresh allocation, so aligned)."""
    if schedule != 0:
        return schedule in SCHEDULES
    B, Sq, H, hd = q.shape
    aligned = _aligned(*(t for t in (q, k, v) if t.is_contiguous()))
    return choose_schedule(Sq, k.shape[1], H, k.shape[2], hd, aligned) == 0


def lm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, q_offset=0, quant_bits: int = 0,
                 logit_softcap: float = 0.0, local_window: int = 0,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 kv_valid_len: Optional[torch.Tensor] = None,
                 q_segment_ids: Optional[torch.Tensor] = None,
                 kv_segment_ids: Optional[torch.Tensor] = None,
                 segments: Optional[int] = None,
                 schedule: Optional[int] = None) -> torch.Tensor:
    """q f32 [B, Sq, H, hd], k/v [B, Sk, KVH, hd] f32, bf16 or int8 (int8
    with f32 ``k_scale``/``v_scale`` [B, Sk, KVH]) -> f32 [B, Sq, H, hd]:
    ``ref.flash_attention_ref``'s contract. CUDA tensors only; hd at most
    ``LM_MAX_HEAD_DIM``. ``schedule`` forces one of ``SCHEDULES`` (the decode
    schedule only where ``choose_schedule`` picks it; ``chip_smoke.py``
    holds the tile schedule at the decode shapes against it); by default
    ``choose_schedule`` picks it. ``segments`` (with segment ids): the most
    runs of equal q ids a batch row holds (a pack's prompts and its pad
    tail); the tile grid gets that many blocks beyond ceil(Sq / 16), one a
    block of the segment-keyed plan. Fewer stay correct (a block then takes
    several in turn); the default is ceil(Sq / 16). One kernel launch a
    call."""
    _build.require_cuda("lm_attention", q, k, v, k_scale, v_scale, kv_valid_len,
                        q_segment_ids, kv_segment_ids)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KVH, hd) or v.shape != k.shape or H % KVH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not 0 < hd <= LM_MAX_HEAD_DIM:
        raise NotImplementedError(f"head dim {hd}: lm_attention takes 1..{LM_MAX_HEAD_DIM}")
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
    off, off0 = _offset(q_offset, B, q)
    valid, valid0 = _offset(Sk if kv_valid_len is None else kv_valid_len, B, q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    pick = choose_schedule(Sq, Sk, H, KVH, hd, _aligned(q, k, v, out))
    if schedule is None:
        schedule = pick
    elif schedule not in SCHEDULES or (schedule == 0 and pick != 0):
        raise ValueError(f"lm_attention schedule {schedule} cannot take q {tuple(q.shape)} "
                         f"over Sk={Sk}, KVH={KVH}")
    if segments is None:
        segments = -(-Sq // TILE_ROWS)
    elif segments < 0:
        raise ValueError(f"segments={segments}: a count of q id runs, >= 0")
    lib = _build.library()
    kv_type = _KV_TYPES[k.dtype]
    smem = lib.lm_attention_smem_bytes(kv_type, hd, Sq, H // KVH, Sk, schedule)
    if smem > MAX_SMEM:
        raise NotImplementedError(f"Sk={Sk}: {smem} bytes of shared memory > {MAX_SMEM}")
    with torch.cuda.device(q.device):
        err = lib.lm_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_type,
            ks, vs, None if off is None else off.data_ptr(),
            None if valid is None else valid.data_ptr(), qseg, kseg,
            out.data_ptr(), B, Sq, Sk, H, KVH, hd, off0, valid0,
            int(causal), quant_bits, local_window, float(logit_softcap),
            math.sqrt(hd), schedule, int(segments), _build.stream(q))
    _build.check(err, f"lm_attention ({SCHEDULES[schedule]})")
    mode = (f"{'causal' if causal else 'full'}/{str(k.dtype).removeprefix('torch.')}"
            f"/qb{quant_bits}" + ("/segments" if q_segment_ids is not None else "")
            + ("/decode" if Sq == 1 else ""))
    lm_attention.launches += 1
    lm_attention.launches_by_mode[mode] = lm_attention.launches_by_mode.get(mode, 0) + 1
    return out


lm_attention.launches = 0
lm_attention.launches_by_mode = {}
