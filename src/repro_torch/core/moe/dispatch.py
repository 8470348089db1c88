"""Sort-based token dispatch for the grouped MoE path (the paper's unified
kernel orchestration), ported from ``repro.core.moe.dispatch``.

Tokens are sorted by expert id (a stable sort, so equal ids keep token
order), the grouped matmul streams each expert's weights once per layer, and
the combine scatter-adds the weighted rows back to token order. Every step
stays on the device: nothing here waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GroupedDispatch(NamedTuple):
    x_sorted: torch.Tensor  # [T*k, D] tokens gathered in expert order
    group_sizes: torch.Tensor  # [E] int32 tokens per expert
    sort_idx: torch.Tensor  # [T*k] permutation into expert order
    token_idx: torch.Tensor  # [T*k] source token of each sorted row
    weights_sorted: torch.Tensor  # [T*k] combine weight of each sorted row


def grouped_dispatch(x: torch.Tensor, experts: torch.Tensor,
                     weights: torch.Tensor, num_experts: int) -> GroupedDispatch:
    """x: [T, D]; experts/weights: [T, k]."""
    T, k = experts.shape
    flat_e = experts.reshape(-1).long()
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    sort_idx = torch.sort(flat_e, stable=True).indices
    token_idx = flat_t[sort_idx]
    # a scatter-add histogram: torch.bincount on a CUDA tensor reads the
    # maximum back to the host, which would stall the dispatch stream
    group_sizes = torch.zeros(num_experts, dtype=torch.int32, device=x.device)
    group_sizes.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    return GroupedDispatch(
        x_sorted=x[token_idx],
        group_sizes=group_sizes,
        sort_idx=sort_idx,
        token_idx=token_idx,
        weights_sorted=weights.reshape(-1)[sort_idx],
    )


def grouped_combine(y_sorted: torch.Tensor, d: GroupedDispatch,
                    num_tokens: int) -> torch.Tensor:
    """Weighted scatter-add back to token order (Eq. 5 aggregation)."""
    y_w = y_sorted * d.weights_sorted[:, None].to(y_sorted.dtype)
    out = torch.zeros((num_tokens, y_sorted.shape[-1]), dtype=y_sorted.dtype,
                      device=y_sorted.device)
    return out.index_add_(0, d.token_idx, y_w)
