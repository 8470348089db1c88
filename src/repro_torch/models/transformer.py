"""Decoder-only LM (dense, all-layer MoE and vlm families) and the block
pieces the vision models share, ported from ``repro.models.transformer``.
The vlm's frontend stub projects precomputed patch embeddings
(``frontend_proj``) and prepends them to the token embeddings
(``_embed_inputs``); the serving engine runs it text-only.

Layers are stacked (a leading layer dim on every leaf under ``layers``) and
walked by a Python loop, where the reference scans. The K/V cache is one
stacked buffer per tensor, [layers, B, max_len, KVH, hd]; each layer writes
its rows into its slice in place (``layers.attention_block``).

The MoE FFN (``_moe_apply``) takes ``MoEConfig.impl``'s path: ``grouped``
(the sort-based unified kernel; with ``moe_exec="expert_parallel"`` over
the slots of the ambient EP mesh, ``distributed/expert_parallel.py``) or
``gshard`` (capacity dispatch/combine einsums, which drop overflow slots).

gemma2's alternating local/global attention (``attn.alternate_local_global``)
keeps two stacks of L/2 layers, ``layers_local`` and ``layers_global``,
walked in (local, global) pairs, and a nested cache ``{"local": ...,
"global": ...}``: the local layers' cache is a ring of min(max_len,
local_window) rows, the global layers' max_len rows.

With ``cfg.remat`` a training forward (grad recorded, no cache) runs each
layer under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of its scan body: the layer is recomputed in the backward pass.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe.dispatch import (
    capacity,
    grouped_combine,
    grouped_dispatch,
    gshard_dispatch_combine,
)
from repro_torch.core.moe.router import route_topk
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.core.quant.qtypes import unpack_int4
from repro_torch.kernels import autograd, ops
from repro_torch.models.layers import (
    act_fn,
    apply_norm,
    attention_block,
    mlp_apply,
    quant_linear,
)
from repro_torch.models.param import (
    PDef,
    dense,
    require_device,
    stack_tree,
    tree_leaves,
    vector,
)


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------

def _norm_pdefs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": vector(d, "embed", "ones"), "bias": vector(d, "embed", "zeros")}
    return {"scale": vector(d, "embed", "zeros")}  # rmsnorm (1+g) convention


def _attn_pdefs(cfg: ModelConfig, bias: bool = False) -> dict:
    a = cfg.attn
    d = cfg.d_model
    p = {
        "wq": dense(d, a.q_dim, "embed", "qkv"),
        "wk": dense(d, a.kv_dim, "embed", "qkv"),
        "wv": dense(d, a.kv_dim, "embed", "qkv"),
        "wo": dense(a.q_dim, d, "qkv", "embed"),
    }
    if bias:
        p["bq"] = vector(a.q_dim, "qkv")
        p["bk"] = vector(a.kv_dim, "qkv")
        p["bv"] = vector(a.kv_dim, "qkv")
        p["bo"] = vector(d, "embed")
    if a.qk_norm:
        p["q_norm"] = vector(a.head_dim, None)
        p["k_norm"] = vector(a.head_dim, None)
    return p


def _mlp_pdefs(cfg: ModelConfig, d_ff: int, bias: bool = False) -> dict:
    d = cfg.d_model
    hid = 2 * d_ff if cfg.glu else d_ff
    p = {"wi": dense(d, hid, "embed", "mlp"), "wo": dense(d_ff, d, "mlp", "embed")}
    if bias:
        p["bi"] = vector(hid, "mlp")
        p["bo"] = vector(d, "embed")
    return p


def _moe_pdefs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    hid = 2 * m.d_ff if cfg.glu else m.d_ff
    return {
        "gate": dense(d, m.num_experts, "embed", None, scale=0.02),
        "wi": PDef((m.num_experts, d, hid), ("expert", "embed", "mlp")),
        "wo": PDef((m.num_experts, m.d_ff, d), ("expert", "mlp", "embed")),
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


def _alternating(cfg: ModelConfig) -> bool:
    return cfg.attn is not None and cfg.attn.alternate_local_global


def abstract_params(cfg: ModelConfig) -> dict:
    """The LM's parameter tree: embedding, stacked layers (alternating
    archs: ``layers_local`` and ``layers_global``, L/2 each), final norm,
    (untied) LM head and (vlm) the frontend projection."""
    d = cfg.d_model
    tree: dict = {
        "embed": PDef((cfg.vocab_size, d), ("vocab", "embed"), init="small_normal"),
        "final_norm": _norm_pdefs(cfg),
    }
    if _alternating(cfg):
        if cfg.num_layers % 2:
            raise ValueError(f"alternating local/global needs an even layer count, "
                             f"got {cfg.num_layers}")
        tree["layers_local"] = stack_tree(_layer_pdefs(cfg), cfg.num_layers // 2)
        tree["layers_global"] = stack_tree(_layer_pdefs(cfg), cfg.num_layers // 2)
    else:
        tree["layers"] = stack_tree(_layer_pdefs(cfg), cfg.num_layers)
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense(d, cfg.vocab_size, "embed", "vocab", scale=0.02)
    if cfg.frontend:  # the vlm's projection of the stub's patch embeddings
        tree["frontend_proj"] = dense(cfg.frontend_dim, d, None, "embed")
    return tree


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _expert_count_zeros(cfg: ModelConfig, device) -> torch.Tensor:
    """Per-expert routed-token counter ([E] int32; [0] for non-MoE)."""
    n_e = cfg.moe.num_experts if cfg.moe is not None else 0
    return torch.zeros((n_e,), dtype=torch.int32, device=device)


def _moe_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, taps=None):
    """MoE FFN on [B, S, D]; returns (y, aux_loss, expert_counts [E]
    int32), the routed (token, slot) histogram of this layer (gshard: the
    slots not dropped)."""
    m = cfg.moe
    if m.moe_exec == "expert_parallel" and taps is None:
        # the grouped path over the slots of the ambient EP mesh;
        # calibration keeps the single path, so taps record in one place
        from repro_torch.distributed.expert_parallel import expert_parallel_moe

        return expert_parallel_moe(x, p, cfg)
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    # int8 gate: its matmul runs through the quant seam; the gate bias is
    # added inside route_topk
    gate_logits = (quant_linear(xt, p, "gate", cfg)
                   if p["gate"].dtype == torch.int8 else None)
    r = route_topk(xt, p["gate"], p.get("gate_b"), m.top_k, logits=gate_logits)
    if m.impl == "gshard":
        y, counts = _gshard_ffn(xt, p, cfg, r.experts, r.weights, B, taps)
    else:  # grouped: the paper's sort-based unified kernel
        dsp = grouped_dispatch(xt, r.experts, r.weights, m.num_experts)
        counts = dsp.group_sizes
        y_sorted = ops.grouped_mlp(
            dsp.x_sorted, p["wi"], p["wo"], dsp.group_sizes,
            act=cfg.act, glu=cfg.glu, bi=p.get("bi"), bo=p.get("bo"),
            taps=taps, mid_a_scale=p.get("wo_a_scale"), a_bits=cfg.quant.a_bits,
            wi_scale=p.get("wi_scale"), wo_scale=p.get("wo_scale"),
            wi_a_scale=p.get("wi_as"),
        )
        y = grouped_combine(y_sorted, dsp, T)
    return y.reshape(B, S, D), r.aux_loss, counts


def _gshard_ffn(xt, p, cfg: ModelConfig, experts, weights, B: int, taps):
    """The capacity-einsum (GShard) expert FFN over tokens [T, D]; returns
    (y [T, D], routed-and-kept slots per expert [E] int32). The reference
    runs these as plain XLA einsums, so they are plain ``torch.einsum``
    here. Integer stacks (nibble-packed int4 unpacked first) are
    dequantized on the fly: this path has no integer contraction."""
    m = cfg.moe
    T, D = xt.shape
    wi, wo = p["wi"], p["wo"]
    if wi.dtype in (torch.int8, torch.uint8):
        if wi.dtype == torch.uint8:
            hid = wi.shape[-1]
            wi = unpack_int4(wi, D)
            wo = unpack_int4(wo, hid // 2 if cfg.glu else hid)
        wi = wi.float() * p["wi_scale"][..., None, :]
        wo = wo.float() * p["wo_scale"][..., None, :]
    # hierarchical groups with a capacity each, so the dispatch one-hot is
    # [G, Tg, E, C] (the flat [T, E, C] form grows as T^2)
    if T >= 2048 and T % 2048 == 0:
        G = T // 2048
    elif T % B == 0:
        G = B
    else:
        G = 1
    Tg = T // G
    cap = capacity(Tg, m.top_k, m.num_experts, m.capacity_factor)
    xg = xt.reshape(G, Tg, D)
    disp, comb = gshard_dispatch_combine(
        xg, experts.reshape(G, Tg, m.top_k), weights.reshape(G, Tg, m.top_k),
        m.num_experts, cap)
    ein = torch.einsum("gtec,gtd->gecd", disp.to(xt.dtype), xg)
    h = torch.einsum("gecd,edh->gech", ein, wi)
    if "bi" in p:
        h = h + p["bi"][None, :, None, :]
    if cfg.glu:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act_fn(cfg.act)(g) * u
    else:
        h = act_fn(cfg.act)(h)
    # the fc2-input site: a gshard-calibrated model still gets the
    # wo_a_scale leaf the grouped serving path quantizes with
    maybe_record(taps, "moe_mid", h)
    eout = torch.einsum("gech,ehd->gecd", h, wo)
    if "bo" in p:
        eout = eout + p["bo"][None, :, None, :]
    y = torch.einsum("gtec,gecd->gtd", comb.to(xt.dtype), eout).reshape(T, D)
    return y, torch.sum(disp, dim=(0, 1, 3)).to(torch.int32)


def remat_active(cfg: ModelConfig, x: torch.Tensor, tree) -> bool:
    """Whether a block (or layer pair) over ``x`` with the params ``tree``
    is recomputed in the backward pass: ``cfg.remat`` (the reference's
    ``jax.checkpoint`` of its scan body) where autograd records the
    forward. Serving (no grad, or a cache) never is, so its steps run as
    before bit for bit."""
    return cfg.remat and autograd.needs_grad(x, *tree_leaves(tree))


def layer(tree, i: int):
    """Layer ``i`` of a stacked subtree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(x, p, cfg, *, positions, local_window=0, causal=True, cache=None,
           cache_index=None, segment_ids=None, segments=None, taps=None):
    """One pre-norm transformer block; returns (x, aux_loss,
    expert_counts, cache)."""
    h = apply_norm(x, p["ln1"], cfg)
    maybe_record(taps, "post_ln1", h)
    attn_out, cache = attention_block(
        h, p["attn"], cfg, cfg.attn, positions=positions, causal=causal,
        local_window=local_window, cache=cache, cache_index=cache_index,
        segment_ids=segment_ids, segments=segments, taps=taps)
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

def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [B, S, D]; with a frontend (vlm) and its embeds
    [B, F, frontend_dim], their ``frontend_proj`` projection (through the
    quant seam) in front: [B, F + S, D]."""
    x = params["embed"][tokens.long()]  # [B, S, D]
    if cfg.frontend and frontend_embeds is not None:
        fe = quant_linear(frontend_embeds.to(x.dtype), params, "frontend_proj", cfg)
        x = torch.cat([fe, x], dim=1)
    if cfg.embed_scale:
        # a fill on the device, not a copy from the host: capture-safe
        x = x * torch.full((), cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _layer_walk(cfg: ModelConfig):
    """The layers in order as (params key, cache key or None, index in the
    stack, local window, tap scope): alternating archs walk the (local,
    global) pairs, windows ``local_window`` then 0, scopes ``Llocal{i:03d}``
    and ``Lglobal{i:03d}``; every other arch its one stack, ``L{i:03d}``."""
    if _alternating(cfg):
        for i in range(cfg.num_layers // 2):
            yield "layers_local", "local", i, cfg.attn.local_window, f"Llocal{i:03d}"
            yield "layers_global", "global", i, 0, f"Lglobal{i:03d}"
    else:
        for i in range(cfg.num_layers):
            yield "layers", None, i, cfg.attn.local_window, f"L{i:03d}"


def _run_layers(params, cfg: ModelConfig, x, *, positions, caches=None,
                cache_index=None, segment_ids=None, segments=None, taps=None):
    """Every layer in order (the reference's scan as a loop). Returns (x,
    aux_total, expert_counts summed over the MoE layers, caches)."""
    if taps is not None:
        return _run_layers_eager(params, cfg, x, positions=positions, taps=taps)
    aux_total = torch.zeros((), device=x.device)
    ec_total = _expert_count_zeros(cfg, x.device)
    for key, ckey, i, window, _ in _layer_walk(cfg):
        cache = None
        if caches is not None:
            cache = layer(caches if ckey is None else caches[ckey], i)
        lp = layer(params[key], i)
        if cache is None and remat_active(cfg, x, lp):
            x, aux, ec, _ = checkpoint(_block, x, lp, cfg, positions=positions,
                                       local_window=window, segment_ids=segment_ids,
                                       segments=segments, use_reentrant=False)
        else:
            x, aux, ec, _ = _block(x, lp, cfg,
                                   positions=positions, local_window=window,
                                   cache=cache, cache_index=cache_index,
                                   segment_ids=segment_ids, segments=segments)
        aux_total = aux_total + aux
        ec_total = ec_total + ec
    return x, aux_total, ec_total, caches


def _run_layers_eager(params, cfg: ModelConfig, x, *, positions, taps):
    """The calibration loop: records activation taps under each layer's
    scope (``_layer_walk``)."""
    aux_total = torch.zeros((), device=x.device)
    ec_total = _expert_count_zeros(cfg, x.device)
    for key, _, i, window, scope in _layer_walk(cfg):
        x, aux, ec, _ = _block(x, layer(params[key], i), cfg,
                               positions=positions, local_window=window,
                               taps=taps.scoped(scope))
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


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, taps=None):
    """Teacher-forced forward: tokens [B, S] -> (logits [B, S, V], aux); a
    vlm's ``frontend_embeds`` [B, F, frontend_dim] prepend F positions
    (logits [B, F + S, V])."""
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux, _, _ = _run_layers(params, cfg, x, positions=positions, taps=taps)
    return logits_from_hidden(params, cfg, x, taps=taps), aux


def kv_cache(cfg: ModelConfig, n: int, batch: int, length: int, dtype, device) -> dict:
    """Zeroed K/V of ``n`` stacked attention layers [n, batch, length, KVH,
    hd]: int8 with f32 per-(position, head) scales [n, batch, length, KVH]
    when ``cfg.quant.enable`` and ``kv_cache_int8``, else ``dtype``."""
    a = cfg.attn
    int8 = cfg.quant.enable and cfg.quant.kv_cache_int8
    shape = (n, batch, length, a.num_kv_heads, a.head_dim)
    kv_dtype = torch.int8 if int8 else dtype
    c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
         "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if int8:
        c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed K/V cache [layers, batch, max_len, KVH, hd] (``kv_cache``).
    Alternating archs: ``{"local": ring of min(max_len, local_window)
    rows, "global": max_len rows}``, L/2 layers each."""
    a = cfg.attn
    device = require_device(device)
    if _alternating(cfg):
        n = cfg.num_layers // 2
        local = min(max_len, a.local_window) if a.local_window else max_len
        return {"local": kv_cache(cfg, n, batch, local, dtype, device),
                "global": kv_cache(cfg, n, batch, max_len, dtype, device)}
    return kv_cache(cfg, cfg.num_layers, batch, max_len, dtype, device)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """The cache's tree of tensors on the ``meta`` device: shapes and
    dtypes, nothing allocated (the reference's ``jax.eval_shape`` form)."""
    return init_cache(cfg, batch, max_len, dtype=dtype, device="meta")


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, max_len: Optional[int] = None):
    """Run the prompts [B, S] (a vlm's frontend embeds in front), building a
    cache of ``max_len`` rows (default the stream's length). Returns
    (last-position logits [B, 1, V], cache)."""
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
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
    The attention kernel's grid takes N + 1 runs of equal ids (the prompts
    and the pad tail), so it is fixed by (P, N).
    """
    x = _embed_inputs(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if B != 1:
        raise ValueError("packed prefill uses a single batch row")
    seg = segment_ids.reshape(B, S).to(torch.int32)
    cache = init_cache(cfg, B, max_len or S, dtype=x.dtype, device=x.device)
    x, _, _, cache = _run_layers(
        params, cfg, x, positions=positions.reshape(S).to(torch.int32),
        caches=cache, cache_index=0, segment_ids=seg, segments=last_idx.shape[0] + 1)
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
