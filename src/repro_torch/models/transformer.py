"""Decoder-only LM (dense and all-layer MoE families) and the block pieces
the vision models share, ported from ``repro.models.transformer``.

Layers are stacked (a leading layer dim on every leaf under ``layers``) and
walked by a Python loop, where the reference scans. The K/V cache is one
stacked buffer per tensor, [layers, B, max_len, KVH, hd]; each layer writes
its rows into its slice in place (``layers.attention_block``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe.dispatch import grouped_combine, grouped_dispatch
from repro_torch.core.moe.router import route_topk
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_norm,
    attention_block,
    mlp_apply,
    quant_linear,
)
from repro_torch.models.param import PDef, dense, require_device, stack_tree, vector


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------

def _norm_pdefs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": vector(d, "ones"), "bias": vector(d, "zeros")}
    return {"scale": vector(d, "zeros")}  # rmsnorm (1+g) convention


def _attn_pdefs(cfg: ModelConfig, bias: bool = False) -> dict:
    a = cfg.attn
    d = cfg.d_model
    p = {
        "wq": dense(d, a.q_dim),
        "wk": dense(d, a.kv_dim),
        "wv": dense(d, a.kv_dim),
        "wo": dense(a.q_dim, d),
    }
    if bias:
        p["bq"] = vector(a.q_dim)
        p["bk"] = vector(a.kv_dim)
        p["bv"] = vector(a.kv_dim)
        p["bo"] = vector(d)
    if a.qk_norm:
        p["q_norm"] = vector(a.head_dim)
        p["k_norm"] = vector(a.head_dim)
    return p


def _mlp_pdefs(cfg: ModelConfig, d_ff: int, bias: bool = False) -> dict:
    d = cfg.d_model
    hid = 2 * d_ff if cfg.glu else d_ff
    p = {"wi": dense(d, hid), "wo": dense(d_ff, d)}
    if bias:
        p["bi"] = vector(hid)
        p["bo"] = vector(d)
    return p


def _moe_pdefs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    hid = 2 * m.d_ff if cfg.glu else m.d_ff
    return {
        "gate": dense(d, m.num_experts, scale=0.02),
        "wi": PDef((m.num_experts, d, hid)),
        "wo": PDef((m.num_experts, m.d_ff, d)),
    }


def _layer_pdefs(cfg: ModelConfig) -> dict:
    p = {"ln1": _norm_pdefs(cfg), "ln2": _norm_pdefs(cfg), "attn": _attn_pdefs(cfg)}
    if cfg.moe is not None and cfg.moe.moe_every == 1:
        p["moe"] = _moe_pdefs(cfg)
    else:
        p["mlp"] = _mlp_pdefs(cfg, cfg.d_ff)
    if cfg.post_block_norm:
        p["post_ln1"] = _norm_pdefs(cfg)
        p["post_ln2"] = _norm_pdefs(cfg)
    return p


def abstract_params(cfg: ModelConfig) -> dict:
    """The LM's parameter tree: embedding, stacked layers, final norm and
    (untied) LM head."""
    d = cfg.d_model
    tree: dict = {
        "embed": PDef((cfg.vocab_size, d), init="small_normal"),
        "final_norm": _norm_pdefs(cfg),
        "layers": stack_tree(_layer_pdefs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense(d, cfg.vocab_size, scale=0.02)
    return tree


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _expert_count_zeros(cfg: ModelConfig, device) -> torch.Tensor:
    """Per-expert routed-token counter ([E] int32; [0] for non-MoE)."""
    n_e = cfg.moe.num_experts if cfg.moe is not None else 0
    return torch.zeros((n_e,), dtype=torch.int32, device=device)


def _moe_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, taps=None):
    """Grouped MoE FFN on [B, S, D]; returns (y, aux_loss, expert_counts
    [E] int32), the routed (token, slot) histogram of this layer."""
    m = cfg.moe
    if m.impl != "grouped" or m.moe_exec != "single":
        raise NotImplementedError(
            f"MoE impl={m.impl!r}, moe_exec={m.moe_exec!r}: only the grouped "
            "single-device path is ported (serving_config switches to it)")
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    # int8 gate: its matmul runs through the quant seam; the gate bias is
    # added inside route_topk
    gate_logits = (quant_linear(xt, p, "gate", cfg)
                   if p["gate"].dtype == torch.int8 else None)
    r = route_topk(xt, p["gate"], p.get("gate_b"), m.top_k, logits=gate_logits)
    dsp = grouped_dispatch(xt, r.experts, r.weights, m.num_experts)
    y_sorted = ops.grouped_mlp(
        dsp.x_sorted, p["wi"], p["wo"], dsp.group_sizes,
        act=cfg.act, glu=cfg.glu, bi=p.get("bi"), bo=p.get("bo"),
        taps=taps, mid_a_scale=p.get("wo_a_scale"), a_bits=cfg.quant.a_bits,
        wi_scale=p.get("wi_scale"), wo_scale=p.get("wo_scale"),
        wi_a_scale=p.get("wi_as"),
    )
    y = grouped_combine(y_sorted, dsp, B * S)
    return y.reshape(B, S, D), r.aux_loss, dsp.group_sizes


def layer(tree, i: int):
    """Layer ``i`` of a stacked subtree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(x, p, cfg, *, positions, local_window=0, causal=True, cache=None,
           cache_index=None, segment_ids=None, taps=None):
    """One pre-norm transformer block; returns (x, aux_loss,
    expert_counts, cache)."""
    h = apply_norm(x, p["ln1"], cfg)
    maybe_record(taps, "post_ln1", h)
    attn_out, cache = attention_block(
        h, p["attn"], cfg, cfg.attn, positions=positions, causal=causal,
        local_window=local_window, cache=cache, cache_index=cache_index,
        segment_ids=segment_ids, taps=taps)
    if cfg.post_block_norm:
        attn_out = apply_norm(attn_out, p["post_ln1"], cfg)
    x = x + attn_out
    h = apply_norm(x, p["ln2"], cfg)
    maybe_record(taps, "post_ln2", h)
    aux = torch.zeros((), device=x.device)
    ec = _expert_count_zeros(cfg, x.device)
    if "moe" in p:
        ff, aux, ec = _moe_apply(h, p["moe"], cfg, taps=taps)
    else:
        ff = mlp_apply(h, p["mlp"], cfg, taps=taps)
    if cfg.post_block_norm:
        ff = apply_norm(ff, p["post_ln2"], cfg)
    return x + ff, aux, ec, cache


# ---------------------------------------------------------------------------
# Forward (teacher-forced), prefill, decode
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]  # [B, S, D]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _run_layers(params, cfg: ModelConfig, x, *, positions, caches=None,
                cache_index=None, segment_ids=None, taps=None):
    """Every layer in order (the reference's scan as a loop). Returns (x,
    aux_total, expert_counts summed over the MoE layers, caches)."""
    if taps is not None:
        return _run_layers_eager(params, cfg, x, positions=positions, taps=taps)
    aux_total = torch.zeros((), device=x.device)
    ec_total = _expert_count_zeros(cfg, x.device)
    for i in range(cfg.num_layers):
        cache = None if caches is None else layer(caches, i)
        x, aux, ec, _ = _block(x, layer(params["layers"], i), cfg,
                               positions=positions, local_window=cfg.attn.local_window,
                               cache=cache, cache_index=cache_index,
                               segment_ids=segment_ids)
        aux_total = aux_total + aux
        ec_total = ec_total + ec
    return x, aux_total, ec_total, caches


def _run_layers_eager(params, cfg: ModelConfig, x, *, positions, taps):
    """The calibration loop: records activation taps under ``L{i:03d}``."""
    aux_total = torch.zeros((), device=x.device)
    ec_total = _expert_count_zeros(cfg, x.device)
    for i in range(cfg.num_layers):
        x, aux, ec, _ = _block(x, layer(params["layers"], i), cfg,
                               positions=positions, local_window=cfg.attn.local_window,
                               taps=taps.scoped(f"L{i:03d}"))
        aux_total = aux_total + aux
        ec_total = ec_total + ec
    return x, aux_total, ec_total, None


def logits_from_hidden(params, cfg: ModelConfig, x, taps=None):
    x = apply_norm(x, params["final_norm"], cfg)
    maybe_record(taps, "final_norm", x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = quant_linear(x, params, "lm_head", cfg)
        if "lm_head_b" in params:  # PTQ final-norm fold correction
            logits = logits + params["lm_head_b"]
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, taps=None):
    """Teacher-forced forward: tokens [B, S] -> (logits [B, S, V], aux)."""
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux, _, _ = _run_layers(params, cfg, x, positions=positions, taps=taps)
    return logits_from_hidden(params, cfg, x, taps=taps), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed K/V cache [layers, batch, max_len, KVH, hd]: int8 with f32
    per-(position, head) scales when ``cfg.quant.enable`` and
    ``kv_cache_int8``, else ``dtype``."""
    a = cfg.attn
    device = require_device(device)
    int8 = cfg.quant.enable and cfg.quant.kv_cache_int8
    shape = (cfg.num_layers, batch, max_len, a.num_kv_heads, a.head_dim)
    kv_dtype = torch.int8 if int8 else dtype
    c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
         "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if int8:
        c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return c


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None):
    """Run the prompts [B, S], building a cache of ``max_len`` rows (default
    S). Returns (last-position logits [B, 1, V], cache)."""
    x = _embed_inputs(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, B, max_len or S, dtype=x.dtype, device=x.device)
    x, _, _, cache = _run_layers(params, cfg, x, positions=positions,
                                 caches=cache, cache_index=0)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), cache


def prefill_packed(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, segment_ids: torch.Tensor,
                   last_idx: torch.Tensor, max_len: Optional[int] = None):
    """Continuous-batching prefill: N variable-length prompts packed into one
    batch row.

    tokens [1, P] prompts back to back (+ pad tail); positions [P]
    within-segment positions (RoPE); segment_ids [P] prompt index per slot,
    -1 on the pad tail; last_idx [N] buffer index of each prompt's last
    token. Returns (next-token logits [N, V], the packed cache [layers, 1,
    max_len, ...]); the engine scatters each segment's rows into its slot.
    """
    x = _embed_inputs(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if B != 1:
        raise ValueError("packed prefill uses a single batch row")
    seg = segment_ids.reshape(B, S).to(torch.int32)
    cache = init_cache(cfg, B, max_len or S, dtype=x.dtype, device=x.device)
    x, _, _, cache = _run_layers(
        params, cfg, x, positions=positions.reshape(S).to(torch.int32),
        caches=cache, cache_index=0, segment_ids=seg)
    h_last = x[0].index_select(0, last_idx.long())  # [N, D]
    return logits_from_hidden(params, cfg, h_last), cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches,
                index, *, with_stats: bool = False):
    """One decode step: tokens [B, 1] against ``caches``, which is updated
    in place at ``index`` (the fill position: an int for a lockstep batch,
    a [B] tensor for per-slot continuous batching) and returned.

    ``with_stats=True`` also returns ``{"expert_tokens": [E] int32}``, the
    routed-token histogram of the step summed over the MoE layers."""
    x = _embed_inputs(params, cfg, tokens)
    if isinstance(index, torch.Tensor):
        index = index.to(device=x.device, dtype=torch.int32)
        positions = (index[:, None] if index.dim() else index) + torch.arange(
            1, dtype=torch.int32, device=x.device)
    else:
        positions = torch.full((1,), index, dtype=torch.int32, device=x.device)
    x, _, ec, caches = _run_layers(params, cfg, x, positions=positions,
                                   caches=caches, cache_index=index)
    logits = logits_from_hidden(params, cfg, x)
    if with_stats:
        return logits, caches, {"expert_tokens": ec}
    return logits, caches
