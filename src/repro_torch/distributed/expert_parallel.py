"""Expert-parallel grouped MoE execution, ported from
``repro.distributed.expert_parallel`` (DESIGN.md section 7).

One controller drives every shard, as in the reference (one process runs
``shard_map`` over its devices): the mesh (``launch/mesh.py``) is an
ordered array of shard slots, each naming the ``torch.device`` it runs on,
and ``torch.distributed`` is not used. The per-shard body runs once per
slot, and the ``all_to_all`` is a function over the slots' send buffers.

  * the expert stacks are sharded over the expert dim: slot ``s`` computes
    with experts ``[s*E/n, (s+1)*E/n)``, slices of the layer's ``[E, ...]``
    leaves, which are contiguous views (nothing is copied per call);
  * routing runs once, on slot 0's device (the int8 gate through
    ``quant_linear``), then the tokens are split over the slots, each slot
    sorts its tokens by expert (``grouped_dispatch``) and the exchange hands
    every slot exactly the rows bound for its experts;
  * the per-shard compute is the ``kernels.ops.grouped_mlp`` the single
    path runs (on the card the grouped kernel), over the local experts;
  * the results return to their source slot through a second exchange and
    combine there with the routing weights (Eq. 5).

Capacity is worst-case (``C = T_loc * top_k`` rows per (source,
destination) pair), so the exchange drops nothing, and every row's
arithmetic is the single path's: the integer trees' output is bit-equal to
the single path, the fp tree's equal up to the fp32 sums of the plain
version (the grouped kernel's variants 1 and 2 are row-independent).

**Padding rows.** A send slot that no row fills carries a zero row
addressed to local expert ``E/n`` (one past the last). The reference
appends a zero "dump" expert to every shard's stacks inside its traced body
to absorb them; done eagerly here that would copy every shard's stacks at
every MoE layer of every step. Instead the padding rows, which sort last,
are folded into the last local expert's group: the grouped kernel computes
them with that expert's weights (a row's output depends only on its own row
and its expert's weights) and their outputs are dropped before the return
exchange, as the reference drops the dump expert's (``y_back[row_shard,
row_pos]``), so the real rows get the same bits. Their work in the last
group is the work the reference spends in its dump group.

**Placement.** A slot's token rows, weight slices and exchange buffers are
moved to its device with ``.to(device, non_blocking=True)``, a no-op on
slot 0's device. The engines take meshes whose slots name one device only
(``launch.mesh.single_device``); a mesh over several cards would copy the
weight slices every call here.

The mesh is ambient state: the engines run every program inside
``use_ep_mesh(mesh)``, so a captured CUDA graph holds every shard's work.
``moe_exec="expert_parallel"`` on ``MoEConfig`` routes
``models.transformer._moe_apply`` through here.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe.dispatch import (
    ep_exchange_plan,
    grouped_combine,
    grouped_dispatch,
    quantize_ep_payload,
)
from repro_torch.core.moe.router import route_topk
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, single_device
from repro_torch.models.layers import quant_linear
from repro_torch.models.param import require_device

EP_AXIS = "model"

# expert-stack leaves sliced over the expert dim (axis 0 of a layer's
# leaf); the gate and the per-tensor activation scales are shared
_SHARDED_LEAVES = ("wi", "wo", "wi_scale", "wo_scale", "bi", "bo")
_SCALAR_LEAVES = ("wi_as", "wo_a_scale")

_EP_MESH: Optional[Mesh] = None


def set_ep_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or clear, with None) the ambient expert-parallel mesh."""
    global _EP_MESH
    _EP_MESH = mesh


def get_ep_mesh() -> Optional[Mesh]:
    return _EP_MESH


@contextlib.contextmanager
def use_ep_mesh(mesh: Mesh):
    """Scope the ambient EP mesh around any forward whose config carries
    ``moe_exec="expert_parallel"`` (the engines wrap every program, so a
    CUDA graph captured inside holds the shards' work)."""
    global _EP_MESH
    prev = _EP_MESH
    _EP_MESH = mesh
    try:
        yield mesh
    finally:
        _EP_MESH = prev


def in_ep_mesh(fn, mesh: Mesh):
    """``fn`` called inside ``use_ep_mesh(mesh)`` every time (an engine's
    step, eager or while a CUDA graph captures it)."""
    def run(*args, **kw):
        with use_ep_mesh(mesh):
            return fn(*args, **kw)
    return run


def engine_placement(cfg: ModelConfig, mesh: Optional[Mesh], device):
    """(whether ``cfg`` runs expert-parallel, the engine's device) for an
    engine built with ``mesh`` and ``device``: an expert-parallel config
    needs a mesh that ``validate_ep`` accepts, and a mesh pins the engine to
    its slots' one device (``launch.mesh.single_device``) in place of
    ``device``."""
    ep = cfg.moe is not None and cfg.moe.moe_exec == "expert_parallel"
    if ep:
        if mesh is None:
            raise ValueError(
                "moe_exec='expert_parallel' needs mesh= (a 'model'-axis "
                "mesh whose size divides num_experts)")
        validate_ep(cfg, mesh)
    return ep, require_device(single_device(mesh) if mesh is not None else device)


def validate_ep(cfg: ModelConfig, mesh: Mesh) -> int:
    """Check that (cfg, mesh) supports expert parallelism; returns the
    shard count."""
    if cfg.moe is None:
        raise ValueError("expert_parallel: config has no MoE block")
    if cfg.moe.impl != "grouped":
        raise ValueError(
            "expert_parallel requires the grouped MoE path "
            f"(impl={cfg.moe.impl!r}); gshard is GSPMD-native already")
    if EP_AXIS not in mesh.axis_names:
        raise ValueError(f"expert_parallel mesh needs a {EP_AXIS!r} axis: "
                         f"{mesh.axis_names}")
    n = mesh.shape[EP_AXIS]
    if cfg.moe.num_experts % n != 0:
        raise ValueError(
            f"num_experts={cfg.moe.num_experts} not divisible by "
            f"{EP_AXIS!r} axis size {n}")
    return n


def all_to_all(send: Sequence[torch.Tensor], devices: Sequence[torch.device]
               ) -> List[torch.Tensor]:
    """The exchange over the slots: ``send[s]`` is slot ``s``'s buffer
    [n, C, ...] whose slice ``d`` is bound for slot ``d``. Returns ``recv``,
    ``recv[d][s] = send[s][d]``, each on slot ``d``'s device."""
    n = len(send)
    return [torch.stack([send[s][d].to(devices[d], non_blocking=True) for s in range(n)])
            for d in range(n)]


def expert_parallel_moe(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                        quantize_exchange: Optional[bool] = None):
    """Expert-parallel MoE FFN on [B, S, D] (on slot 0's device), the
    grouped branch of ``_moe_apply`` over the ambient mesh's slots; returns
    (y, aux_loss, expert_counts [E] int32).

    ``quantize_exchange`` sends the token rows as int8, quantized with the
    folded fc1 activation scale (``wi_as``); by default (None) it is on for
    int8 and nibble-packed int4 stacks that carry ``wi_as``, whose kernel
    takes int8 rows (it would quantize fp rows the same way)."""
    mesh = _EP_MESH
    if mesh is None:
        raise RuntimeError(
            "moe_exec='expert_parallel' but no EP mesh is set: wrap the "
            "forward in distributed.expert_parallel.use_ep_mesh(mesh)")
    n = validate_ep(cfg, mesh)
    devices = list(mesh.devices.flat)
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    e_local = E // n
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)

    # routing once, as on the single path (so the routing is its routing)
    gate_logits = (quant_linear(xt, p, "gate", cfg)
                   if p["gate"].dtype == torch.int8 else None)
    r = route_topk(xt, p["gate"], p.get("gate_b"), k, logits=gate_logits)
    flat_e = r.experts.reshape(-1).long()
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))

    if quantize_exchange is None:
        quantize_exchange = (p["wi"].dtype in (torch.int8, torch.uint8)
                             and "wi_as" in p)
    elif quantize_exchange and "wi_as" not in p:
        raise ValueError(
            "quantize_exchange needs the folded fc1 activation scale "
            "(`wi_as`): only materialized int8/int4 QuantizedParams trees "
            "carry it")

    # pad the tokens to a multiple of the slots; pad rows route to expert 0
    # with combine weight 0 (they cost exchange slots, never output)
    T_loc = -(-T // n)
    pad = T_loc * n - T
    xp = torch.nn.functional.pad(xt, (0, 0, 0, pad))
    ep = torch.nn.functional.pad(r.experts, (0, 0, 0, pad))
    wp = torch.nn.functional.pad(r.weights, (0, 0, 0, pad))
    C = T_loc * k  # rows a slot sends to each slot at most: dropless

    # per slot: local sort by expert, the send plan, the packed buffers
    dsps, plans, send_x, send_e = [], [], [], []
    for s, dev in enumerate(devices):
        rows = slice(s * T_loc, (s + 1) * T_loc)
        d = grouped_dispatch(xp[rows].to(dev, non_blocking=True),
                             ep[rows].to(dev, non_blocking=True),
                             wp[rows].to(dev, non_blocking=True), E)
        plan = ep_exchange_plan(d.group_sizes, n, C)
        xr = d.x_sorted
        if quantize_exchange:
            xr = quantize_ep_payload(xr, p["wi_as"].to(dev, non_blocking=True),
                                     cfg.quant.a_bits)
        at = (plan.row_shard.long(), plan.row_pos.long())
        sx = xr.new_zeros((n, C, D))
        sx[at] = xr
        se = torch.full((n, C), e_local, dtype=torch.int32, device=dev)
        se[at] = plan.row_local_expert
        dsps.append(d)
        plans.append(plan)
        send_x.append(sx)
        send_e.append(se)
    recv_x = all_to_all(send_x, devices)
    recv_e = all_to_all(send_e, devices)

    # per slot: sort the received rows by local expert (stable: sources
    # stay in order), the grouped MLP over the local experts' views, unsort
    send_y = []
    for s, dev in enumerate(devices):
        fe = recv_e[s].reshape(n * C)
        order = torch.sort(fe, stable=True).indices
        xs = recv_x[s].reshape(n * C, D)[order]
        # the padding rows (id e_local) sorted last: the last group's tail
        last = torch.clamp(fe, max=e_local - 1).long()
        gs = torch.zeros(e_local, dtype=torch.int32, device=dev)
        gs.index_add_(0, last, torch.ones_like(last, dtype=torch.int32))
        lo, hi = s * e_local, (s + 1) * e_local
        w = {name: p[name][lo:hi].to(dev, non_blocking=True)
             for name in _SHARDED_LEAVES if name in p}
        sc = {name: p[name].to(dev, non_blocking=True)
              for name in _SCALAR_LEAVES if name in p}
        y_sorted = ops.grouped_mlp(
            xs, w["wi"], w["wo"], gs, act=cfg.act, glu=cfg.glu,
            bi=w.get("bi"), bo=w.get("bo"), mid_a_scale=sc.get("wo_a_scale"),
            a_bits=cfg.quant.a_bits, wi_scale=w.get("wi_scale"),
            wo_scale=w.get("wo_scale"), wi_a_scale=sc.get("wi_as"))
        y_flat = torch.empty_like(y_sorted)
        y_flat[order] = y_sorted
        send_y.append(y_flat.reshape(n, C, -1))
    back = all_to_all(send_y, devices)

    # per slot: the rows of its own tokens, combined; gathered on slot 0
    y = torch.cat([
        grouped_combine(back[s][plans[s].row_shard.long(), plans[s].row_pos.long()],
                        dsps[s], T_loc).to(x.device, non_blocking=True)
        for s in range(n)])
    return y[:T].reshape(B, S, -1), r.aux_loss, counts
