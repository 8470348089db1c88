"""The port's sharding rules (``distributed/sharding_rules.py``), the
optimizers' ``state_specs`` and ``train_step.state_specs`` against the
reference's, on the CPU.

A reference ``PartitionSpec`` is compared as the tuple of its entries (the
port's spec form; ``P()`` is ``()``). Meshes: the port's ``Mesh`` over CPU
slots, and on the reference side a stand-in with the same ``shape`` and
``axis_names`` (all the reference's rules read). Every comparison is exact.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models as M
from repro.configs import ASSIGNED
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import shape_applicable
from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import sharding_rules as jsr
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import constant as jax_constant
from repro.train.train_step import state_specs as jax_state_specs

from repro_torch import models
from repro_torch.configs import REGISTRY, get_config, get_shape, smoke_config
from repro_torch.distributed.sharding_rules import (
    DEFAULT_RULES,
    EXPERT_PARALLEL_RULES,
    SERVING_RULES,
    fit_specs_to_tree,
    input_shardings,
    named,
    opt_state_specs,
    param_specs,
    spec_for_axes,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import adafactor, adamw, constant
from repro_torch.train.train_step import state_specs

MESHES = [((2, 4, 8), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((8,), ("model",))]


class _JaxMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)


def _meshes(sizes, names):
    n = int(np.prod(sizes))
    port = Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(sizes), names)
    return port, _JaxMesh(sizes, names)


def _tuples(jtree):
    """A reference spec tree as nested dicts of tuples."""
    if isinstance(jtree, dict):
        return {k: _tuples(v) for k, v in jtree.items()}
    assert isinstance(jtree, P), jtree
    return tuple(jtree)


def _meta(jshapes):
    """A reference ShapeDtypeStruct tree as meta tensors."""
    if isinstance(jshapes, dict):
        return {k: _meta(v) for k, v in jshapes.items()}
    return torch.empty(tuple(jshapes.shape), device="meta")


# ---------------------------------------------------------------------------
# the reference's five sharding tests (tests/test_data_sharding.py), on the port
# ---------------------------------------------------------------------------

def test_spec_dedupes_mesh_axes():
    # MoE expert tensor: expert wins 'model', mlp degrades to None
    assert spec_for_axes(("layers", "expert", "embed", "mlp")) == (None, "model", "data", None)


def test_spec_respects_divisibility():
    mesh, _ = _meshes((1, 1), ("data", "model"))
    assert spec_for_axes(("vocab", "embed"), shape=(256206, 1024), mesh=mesh) == ("model", "data")
    mesh, _ = _meshes((2, 16), ("data", "model"))
    assert spec_for_axes(("vocab", "embed"), shape=(256206, 1024), mesh=mesh) == (None, "data")


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_param_specs_tree_matches_param_tree(arch):
    cfg = smoke_config(arch)
    specs, abstract = param_specs(cfg), models.abstract_params(cfg)
    tree_map(lambda s, p: None, specs, abstract)  # same structure
    for s, p in zip(tree_leaves(specs), tree_leaves(abstract)):
        assert isinstance(s, tuple) and len(s) <= len(p.shape)


def test_opt_state_specs_inherit_param_spec():
    cfg = smoke_config("llama3-8b")
    p_specs = param_specs(cfg)
    p_shapes = tree_map(lambda p: p.shape, models.abstract_params(cfg))
    o_specs = adamw(constant(1e-3)).state_specs(p_specs, p_shapes)
    assert tree_leaves(o_specs["m"]) == tree_leaves(p_specs)  # ZeRO: m / v mirror the params
    fct = adafactor(constant(1e-3))
    f_specs = fct.state_specs(p_specs, p_shapes)
    f_state = fct.init(tree_map(lambda s: torch.empty(s, device="meta"), p_shapes))
    tree_map(lambda spec, st: None, f_specs, f_state)  # the real state's structure
    assert all(isinstance(s, tuple) for s in tree_leaves(f_specs))


def test_input_shardings_match_input_specs_structure():
    mesh, jmesh = _meshes((1, 1), ("data", "model"))
    for arch in ("llama3-8b", "falcon-mamba-7b", "seamless-m4t-medium"):
        for shape_name in ("train_4k", "decode_32k"):
            jcfg, jshape = jax_get_config(arch), jax_get_shape(shape_name)
            if not shape_applicable(jcfg, jshape)[0]:
                continue
            tree = _meta(M.input_specs(jcfg, jshape))
            specs = input_shardings(get_config(arch), get_shape(shape_name), mesh, tree)
            assert set(specs) == set(tree)


# ---------------------------------------------------------------------------
# against the reference, field by field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_match_reference(arch):
    """Every registered arch at its full config, with no mesh and on each of
    ``MESHES``, under each rule set."""
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for rules, jrules in ((DEFAULT_RULES, jsr.DEFAULT_RULES), (SERVING_RULES, jsr.SERVING_RULES),
                          (EXPERT_PARALLEL_RULES, jsr.EXPERT_PARALLEL_RULES)):
        assert rules == jrules
        assert param_specs(cfg, rules=rules) == _tuples(jsr.param_specs(jcfg, rules=jrules))
        for sizes, names in MESHES:
            mesh, jmesh = _meshes(sizes, names)
            assert param_specs(cfg, mesh, rules) == _tuples(jsr.param_specs(jcfg, jmesh, jrules)), (
                sizes, names)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_specs_match_reference(name):
    """Both optimizers' ``state_specs`` and ``opt_state_specs`` over the
    state's shapes, for llama3-8b and olmoe-1b-7b on a pod mesh."""
    mesh, jmesh = _meshes(*MESHES[0])
    for arch in ("llama3-8b", "olmoe-1b-7b"):
        cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
        opt = {"adamw": adamw, "adafactor": adafactor}[name](constant(1e-3))
        jopt = {"adamw": jax_adamw, "adafactor": jax_adafactor}[name](jax_constant(1e-3))
        p_specs, jp_specs = param_specs(cfg, mesh), jsr.param_specs(jcfg, jmesh)
        jshapes = M.model_param_shapes(jcfg)
        shapes = tree_map(lambda p: p.shape, models.abstract_params(cfg))
        assert opt.state_specs(p_specs, shapes) == _tuples(jopt.state_specs(jp_specs, jshapes))
        state = opt.init(_meta(jshapes))
        jstate = jax.eval_shape(jopt.init, jshapes)
        assert opt_state_specs(state, p_specs, _meta(jshapes)) == _tuples(
            jsr.opt_state_specs(jstate, jp_specs, jshapes))


@pytest.mark.parametrize("grad_compress", [False, True])
def test_train_state_specs_match_reference(grad_compress):
    cfg, jcfg = smoke_config("olmoe-1b-7b"), jax_smoke_config("olmoe-1b-7b")
    mesh, jmesh = _meshes(*MESHES[0])
    got = state_specs(cfg, adamw(constant(1e-3)), mesh, grad_compress=grad_compress)
    want = jax_state_specs(jcfg, jax_adamw(jax_constant(1e-3)), jmesh,
                           grad_compress=grad_compress)
    assert got.params == _tuples(want.params)
    assert got.opt_state == _tuples(want.opt_state)
    assert got.step == tuple(want.step) == ()
    if grad_compress:
        assert got.compress.residual == _tuples(want.compress.residual)
    else:
        assert got.compress is None and want.compress is None


def test_input_and_cache_shardings_match_reference():
    """Batch and cache specs of every arch that takes the shape, on each of
    ``MESHES`` (decode_32k's global batch of 1 shards the cache sequence)."""
    checked = 0
    for arch in ("llama3-8b", "gemma2-2b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b",
                 "seamless-m4t-medium", "m3vit-small"):
        jcfg = jax_get_config(arch)
        for shape_name in ("train_4k", "decode_32k"):
            jshape = jax_get_shape(shape_name)
            if not shape_applicable(jcfg, jshape)[0]:
                continue
            jtree = M.input_specs(jcfg, jshape)
            for sizes, names in MESHES:
                mesh, jmesh = _meshes(sizes, names)
                got = input_shardings(get_config(arch), get_shape(shape_name), mesh,
                                      _meta(jtree))
                assert got == _tuples(jsr.input_shardings(jcfg, jshape, jmesh, jtree)), (
                    arch, shape_name, sizes)
                checked += 1
    assert checked >= 20


def test_fit_specs_to_tree_matches_reference():
    """A PTQ-shaped tree: leaves the spec tree has keep their spec, new ones
    (scales) replicate."""
    mesh, jmesh = _meshes(*MESHES[0])
    cfg, jcfg = smoke_config("llama3-8b"), jax_smoke_config("llama3-8b")
    tree = tree_map(lambda p: torch.empty(p.shape, device="meta"), models.abstract_params(cfg))
    tree["layers"]["attn"]["wq_scale"] = torch.empty((2, 8), device="meta")
    tree["lm_head_as"] = torch.empty((), device="meta")
    jtree = tree_map(lambda t: np.zeros(t.shape, np.float32), tree)
    got = fit_specs_to_tree(param_specs(cfg, mesh), tree)
    want = jsr.fit_specs_to_tree(jsr.param_specs(jcfg, jmesh), jtree)
    assert got == _tuples(want)
    assert got["layers"]["attn"]["wq_scale"] == () and got["lm_head_as"] == ()


def test_named_places_every_leaf_on_the_mesh_device():
    mesh, _ = _meshes(*MESHES[0])
    placed = named(mesh, param_specs(smoke_config("falcon-mamba-7b"), mesh))
    assert {str(d) for d in tree_leaves(placed)} == {"cpu"}
    two = Mesh(np.array([torch.device("cpu"), torch.device("meta")], dtype=object), ("pod",))
    with pytest.raises(NotImplementedError):
        named(two, {"w": ("pod",)})
