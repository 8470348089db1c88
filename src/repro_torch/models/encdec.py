"""seamless-m4t encoder-decoder, ported from ``repro.models.encdec``. The
audio frontend is a stub: the encoder consumes precomputed frame embeddings
[B, S_enc, frontend_dim], projected by a plain matmul (``frontend_proj``).

Decoder layers carry causal self-attention (cached) and cross-attention
over the encoder memory, whose K/V are computed once at prefill
(``compute_cross_kv``) and cached. Layers are walked by a Python loop,
where the reference scans.

Decode state: ``{"self": {"k", "v": [L, B, rows, KVH, hd], ...}, "cross":
{"k", "v": [L, B, S_enc, KVH, hd]}}``; the self cache is written in place
(``layers.attention_block``). As in the reference, ``prefill`` gives the
self cache ``max_len`` rows and ``init_cache`` ``dec_len_for(max_len)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.models.layers import (
    apply_norm,
    attention_block,
    mlp_apply,
    project_memory_kv,
)
from repro_torch.models.param import PDef, dense, require_device, stack_tree
from repro_torch.models.transformer import (
    _attn_pdefs,
    _mlp_pdefs,
    _norm_pdefs,
    kv_cache,
    layer,
    logits_from_hidden,
)


def dec_len_for(seq_len: int) -> int:
    """Decoder token length for an encoder frame length (shape cells)."""
    return max(seq_len // 4, 128)


def abstract_params(cfg: ModelConfig) -> dict:
    enc_layer = {
        "ln1": _norm_pdefs(cfg),
        "attn": _attn_pdefs(cfg, bias=True),
        "ln2": _norm_pdefs(cfg),
        "mlp": _mlp_pdefs(cfg, cfg.d_ff, bias=True),
    }
    dec_layer = {
        "ln1": _norm_pdefs(cfg),
        "attn": _attn_pdefs(cfg, bias=True),
        "lnx": _norm_pdefs(cfg),
        "xattn": _attn_pdefs(cfg, bias=True),
        "ln2": _norm_pdefs(cfg),
        "mlp": _mlp_pdefs(cfg, cfg.d_ff, bias=True),
    }
    return {
        "embed": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="small_normal"),
        "frontend_proj": dense(cfg.frontend_dim, cfg.d_model, None, "embed"),
        "enc_layers": stack_tree(enc_layer, cfg.encoder_layers),
        "enc_norm": _norm_pdefs(cfg),
        "dec_layers": stack_tree(dec_layer, cfg.decoder_layers),
        "final_norm": _norm_pdefs(cfg),
        "lm_head": dense(cfg.d_model, cfg.vocab_size, "embed", "vocab", scale=0.02),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor, taps=None) -> torch.Tensor:
    """Frames [B, S_enc, frontend_dim] -> encoder memory [B, S_enc, D]
    (non-causal self-attention with RoPE, then ``enc_norm``). ``taps``
    records each layer's sites under ``Lenc{i:03d}`` and the memory as
    ``enc_norm_out``."""
    x = frames.to(params["frontend_proj"].dtype) @ params["frontend_proj"]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.encoder_layers):
        lp = layer(params["enc_layers"], i)
        lt = None if taps is None else taps.scoped(f"Lenc{i:03d}")
        h = apply_norm(x, lp["ln1"], cfg)
        maybe_record(lt, "post_ln1", h)
        attn, _ = attention_block(h, lp["attn"], cfg, cfg.attn, positions=positions,
                                  causal=False, taps=lt)
        x = x + attn
        h = apply_norm(x, lp["ln2"], cfg)
        maybe_record(lt, "post_ln2", h)
        x = x + mlp_apply(h, lp["mlp"], cfg, taps=lt)
    x = apply_norm(x, params["enc_norm"], cfg)
    maybe_record(taps, "enc_norm_out", x)
    return x


def _decoder(params, cfg: ModelConfig, x, *, positions, memory=None, caches=None,
             cross_kv=None, cache_index=None, taps=None):
    """Every decoder layer in order. ``cross_kv`` (prefill, decode): each
    layer's precomputed cross K/V, stacked [L, B, S_enc, KVH, hd]; without
    it the cross K/V is projected from ``memory`` inline (forward).
    ``caches``: the self-attention K/V, written in place. ``taps`` records
    under ``Ldec{i:03d}``, the cross-attention's sites under
    ``Ldec{i:03d}.x``."""
    for i in range(cfg.decoder_layers):
        lp = layer(params["dec_layers"], i)
        lt = None if taps is None else taps.scoped(f"Ldec{i:03d}")
        h = apply_norm(x, lp["ln1"], cfg)
        maybe_record(lt, "post_ln1", h)
        cache = None if caches is None else layer(caches, i)
        attn, _ = attention_block(h, lp["attn"], cfg, cfg.attn, positions=positions,
                                  causal=True, cache=cache, cache_index=cache_index, taps=lt)
        x = x + attn
        h = apply_norm(x, lp["lnx"], cfg)
        maybe_record(lt, "post_lnx", h)
        mkv = None if cross_kv is None else (cross_kv["k"][i], cross_kv["v"][i])
        xattn, _ = attention_block(h, lp["xattn"], cfg, cfg.attn, memory=memory,
                                   memory_kv=mkv, taps=None if lt is None else lt.scoped("x"))
        x = x + xattn
        h = apply_norm(x, lp["ln2"], cfg)
        maybe_record(lt, "post_ln2", h)
        x = x + mlp_apply(h, lp["mlp"], cfg, taps=lt)
    return x


def compute_cross_kv(params, cfg: ModelConfig, memory: torch.Tensor) -> dict:
    """Every decoder layer's cross K/V from the encoder memory (once, at
    prefill), stacked {"k", "v": [L, B, S_enc, KVH, hd]}."""
    kvs = [project_memory_kv(memory, layer(params["dec_layers"], i)["xattn"], cfg.attn, cfg)
           for i in range(cfg.decoder_layers)]
    return {"k": torch.stack([k for k, _ in kvs]), "v": torch.stack([v for _, v in kvs])}


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, taps=None):
    """Teacher-forced: encode the frames, decode the tokens [B, S]. Returns
    (logits [B, S, V], 0)."""
    memory = encode(params, cfg, frontend_embeds, taps=taps)
    x = params["embed"][tokens.long()]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = _decoder(params, cfg, x, positions=positions, memory=memory, taps=taps)
    return (logits_from_hidden(params, cfg, x, taps=taps),
            torch.zeros((), device=x.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Decode cache: the self K/V of ``dec_len_for(max_len)`` rows (the
    decoder's share of a cell's budget; int8 under quantized serving) and
    the cross K/V over an encoder memory of ``max_len`` frames at ``dtype``
    (written once, at prefill)."""
    a = cfg.attn
    device = require_device(device)
    shape = (cfg.decoder_layers, batch, max_len, a.num_kv_heads, a.head_dim)
    return {
        "self": kv_cache(cfg, cfg.decoder_layers, batch, dec_len_for(max_len), dtype, device),
        "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)},
    }


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """The cache's tree on the ``meta`` device: shapes and dtypes."""
    return init_cache(cfg, batch, max_len, dtype=dtype, device="meta")


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, max_len: Optional[int] = None):
    """Encode the frames, compute the cross K/V and run the decoder prompt
    [B, S] into a self cache of ``max_len`` rows (default S). Returns
    (last-position logits [B, 1, V], {"self": ..., "cross": ...})."""
    memory = encode(params, cfg, frontend_embeds)
    cross = compute_cross_kv(params, cfg, memory)
    del memory
    x = params["embed"][tokens.long()]
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    self_kv = kv_cache(cfg, cfg.decoder_layers, B, max_len or S, x.dtype, x.device)
    x = _decoder(params, cfg, x, positions=positions, caches=self_kv, cross_kv=cross,
                 cache_index=0)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), {"self": self_kv, "cross": cross}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches, index):
    """One step of tokens [B, 1] at ``index`` (an int, or a [B] tensor of
    per-row fill positions); the self cache is updated in place. Returns
    (logits [B, 1, V], caches)."""
    x = params["embed"][tokens.long()]
    if isinstance(index, torch.Tensor):
        index = index.to(device=x.device, dtype=torch.int32)
        positions = (index[:, None] if index.dim() else index) + torch.arange(
            1, dtype=torch.int32, device=x.device)
    else:
        positions = torch.full((1,), index, dtype=torch.int32, device=x.device)
    x = _decoder(params, cfg, x, positions=positions, caches=caches["self"],
                 cross_kv=caches["cross"], cache_index=index)
    return logits_from_hidden(params, cfg, x), caches
