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
    """Weighted sum back to token order (Eq. 5 aggregation).

    The reference scatter-adds the rows into zeros in buffer order. Here
    the inverse of the dispatch permutation lines each token's k rows up,
    sorting those k buffer positions restores their buffer order, and one
    op adds them one after another in that order, in f32, on either
    device: the sum neither changes from run to run (a float scatter-add
    on the card is atomic, and the same prompt would not decode the same
    way twice) nor with the number of tokens in the batch. On the card
    that op is a cumsum over the k rows (a sequential scan along a middle
    dim; a sum there may split the k rows across threads by tensor size);
    on the CPU a sum (sequential there; the CPU cumsum accumulates in
    f64)."""
    n, D = y_sorted.shape
    k = n // max(num_tokens, 1)
    inv = torch.empty_like(d.sort_idx)
    inv[d.sort_idx] = torch.arange(n, device=inv.device)
    order = inv.view(num_tokens, k).sort(dim=1).values.reshape(-1)
    rows = y_sorted[order] * d.weights_sorted[order, None].to(y_sorted.dtype)
    rows = rows.view(num_tokens, k, D)
    if rows.is_cuda and k:
        return rows.cumsum(dim=1)[:, -1]
    return rows.sum(dim=1)
