"""Shared model layers, ported from ``repro.models.layers``: LayerNorm and
RMSNorm, RoPE, the quantized/full-precision linear seam, the MLP, the int8
K/V quantizer and the attention block (cache-free, over a K/V cache with
per-slot fill positions and packed-prefill segment ids, and the
encoder-decoder's cross-attention over an encoder memory). Plain
functions over nested dicts of tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.core.quant.linear_quant import fake_quant_activation
from repro_torch.core.quant.qtypes import (
    ASCALE_SUFFIX,
    SCALE_SUFFIX,
    quantize_sym,
    unpack_int4,
)
from repro_torch.kernels import ops


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(dt)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, gamma, eps)  # gemma-style (1+g); init gamma=0


def apply_norm(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        y = layernorm(x, p["scale"], p["bias"])
    else:
        y = rmsnorm(x, p["scale"])
    if "a_scale" in p:
        # PTQ runtime: per-layer symmetric quantizer with the reparam scale
        y = fake_quant_activation(y.float(), p["a_scale"],
                                  bits=cfg.quant.a_bits).to(y.dtype)
    return y


def maybe_fake_quant(x: torch.Tensor, p: dict, key: str, cfg: ModelConfig):
    """Per-tensor symmetric activation quant at a linear input site."""
    if key in p:
        return fake_quant_activation(x.float(), p[key],
                                     bits=cfg.quant.a_bits).to(x.dtype)
    return x


def quant_linear(x: torch.Tensor, p: dict, key: str,
                 cfg: ModelConfig) -> torch.Tensor:
    """Apply the linear layer stored at ``p[key]``: the single seam every
    linear call site routes through, dispatched on the weight dtype.

      * fp leaf: the plain matmul (fp and fake-quant trees);
      * int8 leaf: quantize x with the folded ``<key>_as`` scale (for key
        ``"wo"``, the ``wo_a_scale`` leaf) and run the int8 kernel, which
        dequantizes once on the int32 accumulator (Eq. 9). Sites with no
        activation scale (``patch_proj``) keep x fp: the per-output-channel
        weight scale factors out of the contraction;
      * uint8 leaf (nibble-packed int4): unpacked to int8 values first.
    """
    w = p[key]
    if w.dtype == torch.uint8:
        w = unpack_int4(w, x.shape[-1])
    if w.dtype != torch.int8:
        return x @ w
    w_scale = p[key + SCALE_SUFFIX]
    a_scale = p.get(key + ASCALE_SUFFIX,
                    p.get("wo_a_scale") if key == "wo" else None)
    lead, d_in = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d_in)
    if a_scale is None:
        y = (x2.float() @ w.float()) * w_scale
    else:
        x_q = quantize_sym(x2.float(), a_scale, cfg.quant.a_bits)
        y = ops.int8_matmul(x_q, w, a_scale, w_scale)
    return y.reshape(lead + (w.shape[-1],)).to(x.dtype)


def act_fn(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":  # the tanh form, as jax.nn.gelu(approximate=True)
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def mlp_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, taps=None) -> torch.Tensor:
    """GLU (wi fused [d, 2ff]) or plain MLP (wi [d, ff]); wo [ff, d]."""
    h = quant_linear(x, p, "wi", cfg)
    if "bi" in p:
        h = h + p["bi"]
    if cfg.glu:
        gate, up = torch.chunk(h, 2, dim=-1)
        h = act_fn(cfg.act)(gate) * up
    else:
        h = act_fn(cfg.act)(h)
    maybe_record(taps, "mlp_mid", h)
    if p["wo"].dtype != torch.int8:
        h = maybe_fake_quant(h, p, "wo_a_scale", cfg)
    y = quant_linear(h, p, "wo", cfg)
    if "bo" in p:
        y = y + p["bo"]
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding with f32 angles. x: [..., S, H, hd];
    positions: [..., S] integer."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def quantize_kv(x: torch.Tensor):
    """Per (position, head) symmetric int8: x [B, S, KVH, hd] -> (int8,
    f32 scale [B, S, KVH]); divides by the scale and rounds half to even."""
    xf = x.float()
    absmax = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-6)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127)
    return q.to(torch.int8), scale


def _cache_put(buf: torch.Tensor, new: torch.Tensor, idx) -> None:
    """Write ``new`` [B, S, ...] into ``buf`` [B, Smax, ...] at row ``idx``
    (an int, or a [B] tensor: one fill position per slot), in place. The
    start clamps so the rows fit, as ``lax.dynamic_update_slice`` does (a
    ring cache passes ``idx % Smax`` with S = 1, which always fits)."""
    S, smax = new.shape[1], buf.shape[1]
    if isinstance(idx, int):
        start = min(max(idx, 0), smax - S)
        buf[:, start:start + S] = new.to(buf.dtype)
        return
    start = torch.clamp(idx.long(), 0, smax - S)
    rows = start[:, None] + torch.arange(S, device=buf.device)  # [B, S]
    batch = torch.arange(buf.shape[0], device=buf.device)[:, None].expand_as(rows)
    buf[batch, rows] = new.to(buf.dtype)


def _ring_fill(buf: torch.Tensor, new: torch.Tensor) -> None:
    """A prefill of S rows into a ring of ``smax`` rows, in place: the last
    ``smax`` rows, rolled so that position p lands in slot p % smax (rows
    from 0 when S < smax)."""
    S, smax = new.shape[1], buf.shape[1]
    if S >= smax:
        new = torch.roll(new[:, -smax:], (S - smax) % smax, dims=1)
    buf[:, :new.shape[1]] = new.to(buf.dtype)


def project_memory_kv(memory: torch.Tensor, p: dict, a: AttnConfig,
                      cfg: Optional[ModelConfig] = None) -> tuple:
    """K/V [B, S, KVH, hd] projected from ``memory`` [B, S, D]: a
    cross-attention's from the encoder output (computed once at prefill,
    then cached), or a self-attention's from the block's own input."""
    B, S_enc = memory.shape[0], memory.shape[1]
    k = quant_linear(memory, p, "wk", cfg).reshape(B, S_enc, a.num_kv_heads, a.head_dim)
    v = quant_linear(memory, p, "wv", cfg).reshape(B, S_enc, a.num_kv_heads, a.head_dim)
    if "bk" in p:
        k = k + p["bk"].reshape(1, 1, a.num_kv_heads, a.head_dim)
        v = v + p["bv"].reshape(1, 1, a.num_kv_heads, a.head_dim)
    return k, v


def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig, a: AttnConfig, *,
                    positions: Optional[torch.Tensor] = None, causal: bool = True,
                    local_window: int = 0, cache: Optional[dict] = None,
                    cache_index=None, memory: Optional[torch.Tensor] = None,
                    memory_kv: Optional[tuple] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    segments: Optional[int] = None, taps=None):
    """MSA block: qkv proj -> (QK-norm) -> RoPE -> streaming attention ->
    out proj. Returns (y, cache).

    Cross-attention (the encoder-decoder's): ``memory`` [B, S_enc, D]
    projects K/V from the encoder output, ``memory_kv`` passes them
    precomputed (``project_memory_kv``; no QK-norm is applied to them). A
    cross call is non-causal, takes no RoPE, window or segment ids, and no
    cache.

    cache: {"k", "v": [B, Smax, KVH, hd] (int8 or fp), with int8 also
    "k_scale", "v_scale": [B, Smax, KVH]}. The new K/V rows are written
    into it IN PLACE at ``cache_index`` (an int, or a [B] tensor of per-slot
    fill positions) -- the reference returns a new cache; the port updates
    the one it is given and returns it -- and attention runs over the whole
    buffer with ``kv_valid_len = cache_index + S``.

    A sliding-window layer whose cache holds no more rows than its window
    (``0 < local_window`` and ``Smax <= local_window``) keeps a ring: a
    prefill (S > 1, from position ``cache_index`` = 0) writes its last Smax
    rows so that position p sits in slot p % Smax and attends over its own
    fresh K/V with the window; a decode step writes slot ``cache_index %
    Smax`` and attends over the ``min(cache_index + S, Smax)`` filled slots
    with no window mask (the ring holds exactly the window). RoPE is applied
    at the absolute position before caching, so slot order does not matter.

    segment_ids [B, S] (packed prefill): attention is confined to equal
    ids; RoPE uses ``positions`` (within-segment) while causal masking runs
    on buffer indices, equal to within-segment distances inside a
    contiguous segment. Cache rows beyond S carry the never-matching id -2.
    ``segments``: the most runs of equal ids a row holds, the attention
    kernel's grid hint (``ops.attention``).
    """
    B, S, _ = x.shape
    cross = memory is not None or memory_kv is not None
    if cross and cache is not None:
        raise ValueError("cross-attention takes no cache: pass memory_kv instead")
    q = quant_linear(x, p, "wq", cfg).reshape(B, S, a.num_heads, a.head_dim)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, a.num_heads, a.head_dim)
    if memory_kv is not None:
        k, v = memory_kv
    else:
        k, v = project_memory_kv(x if memory is None else memory, p, a, cfg)
    if a.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        if memory_kv is None:
            k = rmsnorm(k, p["k_norm"])
    if not cross:  # no RoPE over the encoder memory
        if positions is not None:
            q = rope(q, positions, a.rope_theta)
            k = rope(k, positions, a.rope_theta)
        elif a.rope_theta > 0:
            raise ValueError("RoPE needs positions")
    quant_bits = cfg.quant.attn_bits if cfg.quant.enable else 0
    if cache is None:
        out = ops.attention(
            q, k, v, causal=causal and not cross, quant_bits=quant_bits,
            logit_softcap=a.logit_softcap, local_window=0 if cross else local_window,
            q_segment_ids=(None if segment_ids is None or cross
                           else segment_ids.to(torch.int32)), segments=segments)
    else:
        smax = cache["k"].shape[1]
        ring = 0 < local_window and smax <= local_window
        if ring and segment_ids is not None:
            raise NotImplementedError(
                "packed prefill cannot take a ring (sliding-window) cache: the "
                "engine keeps the grouped admission path for alternating "
                "local/global archs")
        idx = cache_index
        if isinstance(idx, torch.Tensor):
            idx = idx.to(device=x.device, dtype=torch.int32).expand(B)
        new = {"k": k, "v": v}
        if cache["k"].dtype == torch.int8:
            new["k"], new["k_scale"] = quantize_kv(k)
            new["v"], new["v_scale"] = quantize_kv(v)
        if ring and S > 1:
            if not isinstance(idx, int) or idx != 0:
                raise ValueError("a prefill into a ring cache starts at position 0")
            for name, rows in new.items():
                _ring_fill(cache[name], rows)
            out = ops.attention(
                q, new["k"], new["v"], causal=causal, q_offset=idx,
                quant_bits=quant_bits, logit_softcap=a.logit_softcap,
                local_window=local_window, k_scale=new.get("k_scale"),
                v_scale=new.get("v_scale"))
            return _attention_out(out, p, cfg, a, taps), cache
        write = idx % smax if ring else idx
        for name, rows in new.items():
            _cache_put(cache[name], rows, write)
        ks, vs = cache.get("k_scale"), cache.get("v_scale")
        if isinstance(idx, torch.Tensor):
            valid = torch.clamp(idx + S, max=smax) if ring else idx + S
        else:
            valid = torch.full((B,), min(idx + S, smax) if ring else idx + S,
                               dtype=torch.int32, device=x.device)
        kv_segs = None
        if segment_ids is not None:
            kv_segs = torch.nn.functional.pad(
                segment_ids.to(torch.int32), (0, smax - S), value=-2)
        out = ops.attention(
            q, cache["k"], cache["v"], causal=causal, q_offset=idx,
            quant_bits=quant_bits, logit_softcap=a.logit_softcap,
            local_window=0 if ring else local_window, k_scale=ks, v_scale=vs,
            kv_valid_len=valid,
            q_segment_ids=(None if segment_ids is None
                           else segment_ids.to(torch.int32)),
            kv_segment_ids=kv_segs, segments=segments)
    return _attention_out(out, p, cfg, a, taps), cache


def _attention_out(out: torch.Tensor, p: dict, cfg: ModelConfig, a: AttnConfig,
                   taps) -> torch.Tensor:
    """The attention heads [B, S, H, hd] through the out projection."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, a.num_heads * a.head_dim)
    maybe_record(taps, "attn_out", out)
    if p["wo"].dtype != torch.int8:
        out = maybe_fake_quant(out, p, "wo_a_scale", cfg)
    y = quant_linear(out, p, "wo", cfg)
    if "bo" in p:
        y = y + p["bo"]
    return y
