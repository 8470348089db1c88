"""zamba2-7b hybrid, ported from ``repro.models.hybrid``: a Mamba-2 backbone
and ONE shared attention + MLP block (a single weight set) applied after
every ``shared_attn_every``-th layer.

The shared block runs after layer i when ``i % every == every - 1``, as
application ``i // every``; the layers past the last multiple get none (81
layers every 6: 13 applications, layers 78-80 none). Each application has
its own K/V cache slice, ``kv["k"][a]`` [B, max_len, KVH, hd], written in
place through ``layers.attention_block``. The block's input re-injects the
embedding stream (x + x0), the reference's simplification of the released
concat + LoRA. Layers are walked by a Python loop, where the reference
scans.

Decode state: ``{"ssm": {"h": [L, B, H, P, N] f32, "conv": [L, B, W-1,
conv_dim]}, "kv": {"k", "v": [A, B, max_len, KVH, hd], ...}}``. The conv
history is kept in f32 whatever ``init_cache``'s ``dtype`` (the reference's
default is bf16), the dtype ``prefill`` and ``decode_step`` produce, as the
port's SSM family keeps it. ``decode_step`` takes the scalar index of the
reference's; a [B] index raises (the reference's RoPE positions have no S
axis there and its decode fails).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.models.layers import apply_norm, attention_block, mlp_apply
from repro_torch.models.param import PDef, require_device, stack_tree
from repro_torch.models.ssm import mamba2_block, mamba2_pdefs
from repro_torch.models.transformer import (
    _attn_pdefs,
    _mlp_pdefs,
    _norm_pdefs,
    kv_cache,
    layer,
    logits_from_hidden,
)


def n_apps(cfg: ModelConfig) -> int:
    """Applications of the shared block in one pass over the layers."""
    return cfg.num_layers // cfg.shared_attn_every


def abstract_params(cfg: ModelConfig) -> dict:
    tree = {
        "embed": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="small_normal"),
        "layers": stack_tree({"ln": _norm_pdefs(cfg), "mamba": mamba2_pdefs(cfg)},
                             cfg.num_layers),
        "shared": {
            "ln1": _norm_pdefs(cfg),
            "attn": _attn_pdefs(cfg),
            "ln2": _norm_pdefs(cfg),
            "mlp": _mlp_pdefs(cfg, cfg.d_ff),
        },
        "final_norm": _norm_pdefs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = PDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                               init="small_normal")
    return tree


def _shared_block(x, x0, params, cfg: ModelConfig, *, positions, cache=None,
                  cache_index=None, taps=None):
    """One application of the shared attention + MLP block; returns x plus
    the block's residual delta, in the reference's order of operations."""
    sp = params["shared"]
    inp = x + x0
    h = apply_norm(inp, sp["ln1"], cfg)
    maybe_record(taps, "post_ln1", h)
    attn_out, _ = attention_block(h, sp["attn"], cfg, cfg.attn, positions=positions,
                                  causal=True, cache=cache, cache_index=cache_index,
                                  taps=taps)
    y = inp + attn_out
    h = apply_norm(y, sp["ln2"], cfg)
    maybe_record(taps, "post_ln2", h)
    y = y + mlp_apply(h, sp["mlp"], cfg, taps=taps)
    return x + y - inp


def _run(params, cfg: ModelConfig, x, *, positions, states=None, kv=None,
         cache_index=None, keep_states: bool = False, taps=None):
    """Every layer in order, the shared block after every ``every``-th.
    Returns (x, the new SSM states stacked like ``init_cache``'s or None
    unless ``keep_states``). ``kv`` (updated in place) gives application a
    its slice ``kv[..][a]``. ``taps`` records each layer's ``post_ln1``
    under ``L{i:03d}`` and every application's sites under one ``shared``
    scope (one weight set: the statistics of all applications merge)."""
    every = cfg.shared_attn_every
    x0 = x
    new = None
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = apply_norm(x, lp["ln"], cfg)
        if taps is not None:
            maybe_record(taps.scoped(f"L{i:03d}"), "post_ln1", h)
        y, st = mamba2_block(h, lp["mamba"], cfg,
                             state=None if states is None else layer(states, i))
        x = x + y
        if keep_states:
            if new is None:  # written layer by layer: no list of L states
                new = {k: v.new_empty((cfg.num_layers,) + tuple(v.shape))
                       for k, v in st.items()}
            for k, v in st.items():
                new[k][i] = v
        if i % every == every - 1:
            x = _shared_block(x, x0, params, cfg, positions=positions,
                              cache=None if kv is None else layer(kv, i // every),
                              cache_index=cache_index,
                              taps=None if taps is None else taps.scoped("shared"))
    return x, new


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, frontend_embeds=None,
            taps=None):
    """Teacher-forced forward: tokens [B, S] -> (logits [B, S, V], 0)."""
    x = params["embed"][tokens.long()]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, _ = _run(params, cfg, x, positions=positions, taps=taps)
    return (logits_from_hidden(params, cfg, x, taps=taps),
            torch.zeros((), device=x.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed decode state: the SSM states (``h`` and the conv history in
    f32) and the shared block's K/V at ``dtype`` (int8 under quantized
    serving)."""
    s = cfg.ssm
    device = require_device(device)
    L = cfg.num_layers
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.state_dim
    return {
        "ssm": {
            "h": torch.zeros((L, batch, s.num_ssm_heads(cfg.d_model), s.head_dim,
                              s.state_dim), dtype=torch.float32, device=device),
            "conv": torch.zeros((L, batch, s.conv_width - 1, conv_dim),
                                dtype=torch.float32, device=device),
        },
        "kv": kv_cache(cfg, n_apps(cfg), batch, max_len, dtype, device),
    }


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """The decode state's tree on the ``meta`` device: shapes and dtypes."""
    return init_cache(cfg, batch, max_len, dtype=dtype, device="meta")


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, frontend_embeds=None,
            max_len: Optional[int] = None):
    """Run the prompts [B, S] from a zero state, building K/V caches of
    ``max_len`` rows (default S) at the activation dtype. Returns
    (last-position logits [B, 1, V], {"ssm": states, "kv": caches})."""
    x = params["embed"][tokens.long()]
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    kv = kv_cache(cfg, n_apps(cfg), B, max_len or S, x.dtype, x.device)
    x, states = _run(params, cfg, x, positions=positions, kv=kv, cache_index=0,
                     keep_states=True)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), {"ssm": states, "kv": kv}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches, index):
    """One step of tokens [B, 1] at fill position ``index`` (an int or a
    0-d tensor: the batch decodes in lockstep). The K/V caches are updated
    in place; the SSM states come back as new tensors. Returns (logits [B,
    1, V], {"ssm": new states, "kv": caches})."""
    x = params["embed"][tokens.long()]
    if isinstance(index, torch.Tensor):
        if index.dim():
            raise ValueError(
                f"hybrid decode_step takes a scalar index, got shape {tuple(index.shape)}: "
                "the reference builds positions = index + arange(1), which at a [B] "
                "index has no S axis and fails in RoPE")
        index = index.to(device=x.device, dtype=torch.int32)
        positions = index + torch.arange(1, dtype=torch.int32, device=x.device)
    else:
        positions = torch.full((1,), index, dtype=torch.int32, device=x.device)
    x, states = _run(params, cfg, x, positions=positions, states=caches["ssm"],
                     kv=caches["kv"], cache_index=index, keep_states=True)
    return logits_from_hidden(params, cfg, x), {"ssm": states, "kv": caches["kv"]}
