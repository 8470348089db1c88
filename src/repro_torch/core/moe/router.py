"""Top-k gating network (paper Eqs. 4-5) with the load-balance auxiliary
loss, ported from ``repro.core.moe.router``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RouterOut(NamedTuple):
    weights: torch.Tensor  # [T, k] combine weights (softmax over top-k logits)
    experts: torch.Tensor  # [T, k] int32 expert ids
    aux_loss: torch.Tensor  # scalar load-balance loss
    logits: torch.Tensor  # [T, E] router logits


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim with ties broken toward the lower index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order among
    equal values). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(x: torch.Tensor, w_gate: torch.Tensor,
               b_gate: Optional[torch.Tensor], top_k: int, *,
               logits: Optional[torch.Tensor] = None) -> RouterOut:
    """x: [T, D] tokens; w_gate: [D, E]. Eq. 4: softmax over the top-k
    logits. ``logits``: precomputed (pre-bias) gate logits [T, E], which
    callers with an int8 gate compute through ``models.layers.quant_linear``
    (``w_gate`` is then used for nothing else)."""
    if logits is None:
        logits = x.float() @ w_gate.float()
    logits = logits.float()
    if b_gate is not None:
        logits = logits + b_gate
    E = logits.shape[-1]
    top_vals, top_idx = topk_stable(logits, top_k)
    weights = torch.softmax(top_vals, dim=-1)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(top_idx[:, 0], E).float()
    f = torch.mean(onehot, dim=0)
    p = torch.mean(probs, dim=0)
    aux = E * torch.sum(f * p)
    return RouterOut(weights=weights, experts=top_idx.to(torch.int32),
                     aux_loss=aux, logits=logits)
