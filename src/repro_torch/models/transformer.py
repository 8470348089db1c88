"""Block building pieces shared with the LM families, ported from
``repro.models.transformer``: the param-def helpers and the grouped
(sort-based, dropless) MoE FFN."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe.dispatch import grouped_combine, grouped_dispatch
from repro_torch.core.moe.router import route_topk
from repro_torch.kernels import ops
from repro_torch.models.layers import quant_linear
from repro_torch.models.param import PDef, dense, vector


def _norm_pdefs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"scale": vector(d, "ones"), "bias": vector(d, "zeros")}  # layernorm


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
            "single-device path is ported")
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
