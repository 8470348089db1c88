"""Token dispatch for MoE expert computation, ported from
``repro.core.moe.dispatch``, in the reference's two modes:

``grouped``  the paper's unified-kernel orchestration: tokens are sorted by
             expert id (a stable sort, so equal ids keep token order), the
             grouped matmul streams each expert's weights once per layer,
             and the combine adds the weighted rows back in token order.
             The expert-parallel exchange plan (``ep_exchange_plan``,
             ``distributed/expert_parallel.py``) works on its sorted rows.
``gshard``   capacity-based dispatch/combine tensors for einsums; the
             slots past an expert's capacity are dropped.

Every step stays on the device: nothing here waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.quant.qtypes import quantize_sym


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
    # the source token of each (token, slot) row, with no host sync
    flat_t = torch.div(torch.arange(T * k, device=x.device), max(k, 1), rounding_mode="floor")
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


# ---------------------------------------------------------------------------
# Expert-parallel exchange plan (distributed/expert_parallel.py)
# ---------------------------------------------------------------------------

def expert_of_sorted_rows(group_sizes: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Group (expert) id of each row of an expert-sorted buffer ([n_rows]
    int32): row i belongs to the group whose cumulative-size interval holds
    i. Rows past ``sum(group_sizes)`` map past the last group."""
    ends = torch.cumsum(group_sizes, 0)
    rows = torch.arange(n_rows, device=group_sizes.device, dtype=ends.dtype)
    return torch.searchsorted(ends, rows, right=True).to(torch.int32)


class EPExchangePlan(NamedTuple):
    """Where each expert-sorted row goes in the all_to_all send buffer.
    Shard ``s`` of ``n_shards`` owns experts ``[s*E_local, (s+1)*E_local)``,
    so each destination's rows form one contiguous run of the sorted
    buffer."""

    row_shard: torch.Tensor  # [R] destination shard of each sorted row
    row_pos: torch.Tensor  # [R] position within that shard's send slice
    row_local_expert: torch.Tensor  # [R] expert id local to the dest shard
    shard_counts: torch.Tensor  # [n_shards] rows bound for each shard


def ep_exchange_plan(group_sizes: torch.Tensor, n_shards: int,
                     n_rows: int) -> EPExchangePlan:
    """Static-shape send plan for the expert-parallel token exchange (all
    int32)."""
    num_experts = group_sizes.shape[0]
    e_local = num_experts // n_shards
    shard_counts = group_sizes.reshape(n_shards, e_local).sum(-1).to(torch.int32)
    start = torch.cumsum(shard_counts, 0, dtype=torch.int32) - shard_counts
    # rows past sum(group_sizes) (none: dispatch is dropless) would index
    # past the table; the clamp keeps the gather in bounds
    row_expert = torch.clamp(expert_of_sorted_rows(group_sizes, n_rows),
                             max=num_experts - 1)
    row_shard = torch.div(row_expert, e_local, rounding_mode="floor")
    rows = torch.arange(n_rows, dtype=torch.int32, device=group_sizes.device)
    return EPExchangePlan(
        row_shard=row_shard,
        row_pos=rows - start[row_shard.long()],
        row_local_expert=row_expert % e_local,
        shard_counts=shard_counts,
    )


def quantize_ep_payload(x_sorted: torch.Tensor, a_scale: torch.Tensor,
                        bits: int = 8) -> torch.Tensor:
    """Expert-sorted exchange rows quantized to int8 with the folded fc1
    activation scale (the ``wi_as`` leaf of a QuantizedParams tree): the
    quantizer ``kernels.ops.grouped_matmul`` applies to fp rows, row by row,
    so quantizing before the exchange gives the bits of quantizing after it
    while moving a quarter of the bytes; the grouped kernel takes the int8
    rows as they are."""
    return quantize_sym(x_sorted.float(), a_scale, bits)


# ---------------------------------------------------------------------------
# GShard-style capacity dispatch
# ---------------------------------------------------------------------------

def capacity(T: int, k: int, E: int, factor: float) -> int:
    """Slots per expert for T tokens of k choices over E experts."""
    c = int(T * k * factor / E) + 1
    return max(4, min(c, T))


def gshard_dispatch_combine(x: torch.Tensor, experts: torch.Tensor,
                            weights: torch.Tensor, num_experts: int,
                            cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [..., T, E, C], combine [..., T, E, C]) f32 for
    experts/weights [..., T, k] (leading dims: independent token groups;
    ``x`` is not read, as in the reference). A (token, slot)'s position in
    its expert's queue follows routing priority; slots past ``cap`` are
    dropped (standard GShard)."""
    *lead, T, k = experts.shape
    onehot = torch.nn.functional.one_hot(experts.long(), num_experts)  # [..., T, k, E]
    flat = onehot.reshape(*lead, T * k, num_experts)
    pos = torch.cumsum(flat, dim=-2) - flat  # position in the expert's queue
    pos = torch.sum(pos * flat, dim=-1).reshape(*lead, T, k)
    keep = pos < cap
    pos = torch.where(keep, pos, 0)  # clamped; masked out by ``keep``
    e_hot = onehot.float() * keep[..., None]
    c_hot = torch.nn.functional.one_hot(pos, cap).float()
    disp = torch.einsum("...tke,...tkc->...tec", e_hot, c_hot)
    comb = torch.einsum("...tk,...tke,...tkc->...tec", weights.float(), e_hot, c_hot)
    return disp, comb
