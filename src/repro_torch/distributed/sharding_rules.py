"""Logical-axis -> mesh-axis sharding rules, ported from
``repro.distributed.sharding_rules`` (MaxText-style).

Weight rules (single- and multi-pod; the pod axis carries pure DP):

  vocab / qkv / kv / mlp / expert / ssm_inner -> 'model'   (TP / EP)
  embed                                       -> 'data'    (FSDP)
  layers / None                               -> replicated

A spec may not reuse a mesh axis, so rules apply left to right and later
duplicates degrade to replicated (MoE expert tensors [layers, expert, embed,
mlp] become (None, 'model', 'data', None)); an axis whose dimension the mesh
axis does not divide, or that the mesh lacks, degrades too.

A spec is a tuple with one entry per dimension: a mesh-axis name, a tuple
of names, or None (replicated); the empty tuple replicates a whole leaf,
as the reference's ``PartitionSpec()`` does. Meshes are the port's
``launch.mesh.Mesh`` (its ``shape`` maps axis names to sizes); anything
with such a ``shape`` and ``axis_names`` will do. ``named`` places a spec
tree on a mesh: the port drives every slot from one process and its slots
share one card, so each leaf is replicated on that card's device
(``launch.mesh.single_device``). The rules are what a multi-card placement
would shard by, and what ``launch/dryrun.py`` checks shapes against.

Activations: batch -> ('pod', 'data'); long-context decode (global_batch=1)
shards the KV / state *sequence* dim over 'data' instead. Optimizer state
inherits the param spec when shapes match (ZeRO), else is replicated
(Adafactor's factored vectors).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.param import tree_leaves, tree_map

Spec = Tuple  # one entry a dimension: a mesh-axis name, a tuple of names, or None

DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("vocab", "model"),
    ("embed", "data"),
    ("qkv", "model"),
    ("kv", "model"),
    ("heads", "model"),
    ("mlp", "model"),
    ("expert", "model"),
    ("ssm_inner", "model"),
    ("layers", None),
)

# Serving (decode) rules: weight-stationary TP, no FSDP on the embed dim
# (decode would re-gather FSDP-sharded params every step).
SERVING_RULES: Tuple[Tuple[str, Optional[str]], ...] = tuple(
    (k, None if k == "embed" else v) for k, v in DEFAULT_RULES
)

# Expert-parallel serving rules: only the expert dim is sharded (over
# 'model'); attention, dense MLPs and norms replicate on every slot
# (distributed/expert_parallel.py).
EXPERT_PARALLEL_RULES: Tuple[Tuple[str, Optional[str]], ...] = tuple(
    (k, v if k == "expert" else None) for k, v in DEFAULT_RULES
)


def spec_for_axes(axes: Tuple[Optional[str], ...], rules=DEFAULT_RULES,
                  shape: Optional[Tuple[int, ...]] = None, mesh=None) -> Spec:
    """Resolve one tensor's logical axes, deduping mesh axes left to right.
    With ``shape`` and ``mesh``, an axis whose dimension the mesh axis does
    not divide degrades to replicated (seamless's vocab 256206 is not
    16-divisible), as does one the mesh lacks."""
    table = dict(rules)
    used = set()
    out = []
    for i, ax in enumerate(axes):
        mesh_ax = table.get(ax) if ax is not None else None
        if mesh_ax is not None and mesh is not None and mesh_ax not in mesh.shape:
            mesh_ax = None  # the mesh lacks the axis (a ('model',)-only mesh)
        if mesh_ax is not None and shape is not None and mesh is not None:
            if shape[i] % mesh.shape.get(mesh_ax, 1) != 0:
                mesh_ax = None
        if mesh_ax is None or mesh_ax in used:
            out.append(None)
        else:
            used.add(mesh_ax)
            out.append(mesh_ax)
    return tuple(out)


def param_specs(cfg: ModelConfig, mesh=None, rules=DEFAULT_RULES):
    """The spec tree matching the model's param tree."""
    from repro_torch import models

    abstract = models.abstract_params(cfg)
    if mesh is None:
        return tree_map(lambda p: spec_for_axes(p.axes, rules), abstract)
    return tree_map(lambda p: spec_for_axes(p.axes, rules, tuple(p.shape), mesh), abstract)


def fit_specs_to_tree(specs_tree, params_tree):
    """Extend a PDef-derived spec tree to cover a transformed param tree (a
    PTQ'd tree's ``<w>_scale``, ``<w>_as``, ``a_scale`` and bias-correction
    leaves): a leaf whose path the spec tree has keeps its spec (an int8
    weight has its fp ancestor's shape and axes); every other leaf
    replicates (scale vectors are tiny)."""
    def walk(spec_node, tree_node):
        if isinstance(tree_node, dict):
            base = spec_node if isinstance(spec_node, dict) else {}
            return {k: walk(base.get(k), v) for k, v in tree_node.items()}
        return spec_node if isinstance(spec_node, tuple) else ()

    return walk(specs_tree, params_tree)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(mesh.shape.get(a, 1) for a in ax)
    return mesh.shape.get(ax, 1)


def _fit(entries, shape, mesh) -> Spec:
    """Drop spec entries whose dim is not divisible, whose mesh axis is
    already used, or whose axis the mesh does not carry (a replica's slice
    is a 1-axis ('model',) mesh: batch entries naming 'data' degrade)."""
    used = set()
    out = []
    for dim, ax in zip(shape, entries):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        if (ax is None or any(a in used for a in axes)
                or any(a not in mesh.shape for a in axes)
                or dim % _axis_size(mesh, ax) != 0):
            out.append(None)
        else:
            used.update(axes)
            out.append(ax)
    return tuple(out)


def _cache_leaf_spec(key: str, shape, mesh, batch, seq_ax) -> Spec:
    """The spec of one KV-cache or SSM-state leaf by key name and rank. GQA
    archs with fewer KV heads than the model axis shard the cache sequence
    over 'model' (context-parallel decode: QK and PV stay local, only the
    per-row softmax stats and the [B, H, 1, hd] output are reduced)."""
    ndim = len(shape)
    if key in ("k", "v"):  # [L, B, S, KVH, hd]
        if shape[3] % _axis_size(mesh, "model") == 0:
            ent = (None, batch, seq_ax, "model", None)
        elif seq_ax is None:
            ent = (None, batch, "model", None, None)  # context parallel
        else:
            ent = (None, batch, seq_ax, None, "model")
        return _fit(ent, shape, mesh)
    if key in ("k_scale", "v_scale"):  # [L, B, S, KVH]
        if shape[3] % _axis_size(mesh, "model") == 0:
            ent = (None, batch, seq_ax, "model")
        elif seq_ax is None:
            ent = (None, batch, "model", None)
        else:
            ent = (None, batch, seq_ax, None)
        return _fit(ent, shape, mesh)
    if key == "h":  # mamba1 [L, B, di, N] | mamba2 [L, B, H, P, N]
        return _fit((None, batch, "model") + (None,) * (ndim - 3), shape, mesh)
    if key == "conv":  # [L, B, W-1, C]
        return _fit((None, batch, None, "model"), shape, mesh)
    return ()


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, cache_tree):
    """The spec tree of a decode cache (the structure of ``cache_shapes``;
    leaves with a ``shape``)."""
    ba = batch_axes(mesh)
    if shape.global_batch == 1:
        batch, seq_ax = None, "data"  # context parallelism
    else:
        batch, seq_ax = (ba if len(ba) > 1 else ba[0]), None

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else _cache_leaf_spec(k, tuple(v.shape), mesh, batch, seq_ax)
                for k, v in tree.items()}

    return walk(cache_tree)


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, specs_tree):
    """The spec tree of a step's inputs: ``specs_tree`` maps each input name
    to a leaf with a ``shape`` (a meta tensor, an array), ``cache`` to a
    cache tree and ``index`` to the decode index."""
    ba = batch_axes(mesh)
    batch = ba if len(ba) > 1 else ba[0]
    if shape.global_batch == 1:
        batch = None
    out = {}
    for name, spec in specs_tree.items():
        if name == "cache":
            out["cache"] = cache_specs(cfg, shape, mesh, spec)
        elif name == "index":
            out["index"] = ()
        else:
            sh = tuple(spec.shape)
            out[name] = _fit((batch,) + (None,) * (len(sh) - 1), sh, mesh) if sh else ()
    return out


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def opt_state_specs(opt_state_shapes, params_specs, params_shapes):
    """Optimizer-state specs: a leaf inherits the spec of the first param of
    its shape (AdamW's m and v, Adafactor's unfactored v), else replicates
    (factored vr / vc). Shape leaves are tensors, arrays or shape tuples."""
    by_shape = {}
    for sh, sp in zip(map(_shape, tree_leaves(params_shapes)), tree_leaves(params_specs)):
        by_shape.setdefault(sh, sp)
    return tree_map(lambda leaf: by_shape.get(_shape(leaf), ()), opt_state_shapes)


def named(mesh, spec_tree):
    """Each spec of the tree placed on the mesh: the device its leaf lives
    on. The port's meshes share one card, so every leaf is replicated
    there (``launch.mesh.single_device`` raises for a mesh over several
    cards)."""
    from repro_torch.launch.mesh import single_device

    dev = single_device(mesh)
    return tree_map(lambda _: dev, spec_tree)
