"""The port's expert parallelism and GShard capacity path against the JAX
reference at smoke size, on the CPU (the kernels' plain versions).

The reference's contract (``tests/test_expert_parallel.py``): the
expert-parallel forward, expert stacks split over the mesh's slots and
tokens exchanged, reproduces the single-device grouped forward, because the
exchange drops nothing. Here a mesh's slots all name the CPU (the
counterpart of the reference's fake host devices), at 1, 2, 4 and 8 slots
over M3ViT-S's 8 smoke experts.

Tolerances: the fp tree within atol 1e-4 of ``repro.models.forward`` (the
reference's own EP tolerance); the int8 and int4 trees bit-equal to the
port's single path (every contraction is exact and each token's expert
rows combine in the same order) and the int8 tree's logits within atol
1e-2 of the reference with the argmax equal: on this fixture's batch the
port's single path is 5.5e-3 from the reference on one image, the size of
one int8 activation rounding the other way (noise of 1e-5 on the patches
moves the reference's own int8 logits by 7.8e-3), over the 2e-3 that
``tests/test_torch_model.py`` holds on its input. GShard: the fp
tree within atol 1e-5 of the reference's ``forward``, the dequantized
int8/int4 trees within atol 5e-3 (``tests/test_torch_lm.py``'s quantized
tolerance: their activations are quantized on the dense sites), dispatch
helpers and routed counts bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import get_shape
from repro.configs import smoke_config as jax_smoke_config
from repro.core.moe import dispatch as jdispatch
from repro.core.quant.ptq import calibrate_model as jax_calibrate
from repro.core.quant.ptq import ptq_model as jax_ptq
from repro.core.quant.ptq import quantized_config as jax_quantized_config
from repro.distributed.fault_tolerance import elastic_mesh as jax_elastic_mesh
from repro.serving.cluster import replica_meshes as jax_replica_meshes
from repro.serving.engine import serving_config as jax_serving_config

from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.core.moe import dispatch
from repro_torch.core.quant.ptq import calibrate_model, quantized_config
from repro_torch.distributed import expert_parallel as ep
from repro_torch.distributed.fault_tolerance import elastic_mesh
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_ep_mesh, make_host_mesh
from repro_torch.models import classify, forward, synth_batch, transformer
from repro_torch.serving import (
    Request,
    ServeEngine,
    ServingCluster,
    VisionEngine,
    serving_config,
    synth_requests,
)
from repro_torch.serving.cluster import replica_meshes

VIT, LM = "m3vit-small", "olmoe-1b-7b"
SLOTS = (1, 2, 4, 8)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _ep(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, moe_exec="expert_parallel"))


def _mesh(n):
    return make_ep_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def vit():
    """The reference's EP fixture: smoke M3ViT-S (8 experts), calibrated on
    2 batches, its int8 and int4 trees, one batch, and the reference's
    forward of each tree on it."""
    cfg = jax_smoke_config(VIT).replace(remat=False)
    shape = get_shape("train_4k").replace(seq_len=24, global_batch=2)
    params = M.init_model_params(cfg, jax.random.PRNGKey(0))
    batches = [M.synth_batch(cfg, shape, jax.random.PRNGKey(i)) for i in range(2)]
    taps = jax_calibrate(cfg, params, batches)
    trees = {"fp": params, "int8": jax_ptq(cfg, params, taps, materialize="int8"),
             "int4": jax_ptq(cfg, params, taps, materialize="int4")}
    batch = M.synth_batch(cfg, shape, jax.random.PRNGKey(7))
    ref = {}
    for kind, tree in trees.items():
        jcfg = cfg if kind == "fp" else jax_quantized_config(cfg)
        logits, aux = M.forward(tree, jcfg, batch)
        ref[kind] = (np.asarray(logits), float(aux))
    tcfg = smoke_config(VIT)
    return {"cfg": {"fp": tcfg, "int8": quantized_config(tcfg), "int4": quantized_config(tcfg)},
            "tp": {k: bridge.params_from_numpy(_np_tree(t), "cpu") for k, t in trees.items()},
            "patches": torch.from_numpy(np.asarray(batch["patches"], np.float32)),
            "ref": ref}


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_ep_forward_matches_single_path_and_reference(vit, kind, n):
    cfg, tp, x = vit["cfg"][kind], vit["tp"][kind], vit["patches"]
    single, aux_single = forward(tp, cfg, x)
    with ep.use_ep_mesh(_mesh(n)):
        y, aux = forward(tp, _ep(cfg), x)
    ref, aux_ref = vit["ref"][kind]
    if kind == "fp":
        np.testing.assert_allclose(y.numpy(), ref, atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(aux), aux_ref, rtol=1e-5)
        return
    assert torch.equal(y, single) and torch.equal(aux, aux_single)
    if kind == "int8":
        np.testing.assert_allclose(y.numpy(), ref, atol=1e-2, rtol=0)
        np.testing.assert_array_equal(y.argmax(-1).numpy(), ref.argmax(-1))


@pytest.mark.parametrize("n", SLOTS)
def test_ep_classify_matches_single_path(vit, n):
    cfg, tp = vit["cfg"]["int8"], vit["tp"]["int8"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, cfg.image_tokens - 1, 768)).astype(np.float32))
    want = classify(tp, cfg, x, top_k=3)
    with ep.use_ep_mesh(_mesh(n)):
        got = classify(tp, _ep(cfg), x, top_k=3)
    assert torch.equal(got["classes"], want["classes"])
    assert torch.equal(got["probs"], want["probs"])
    assert torch.equal(got["expert_tokens"], want["expert_tokens"])


def _moe_layer(tree):
    return {k: v[0] for k, v in tree["pairs_moe"]["moe"].items()}


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_ep_layer_counts_exchange_and_local_slices(vit, monkeypatch, kind, n):
    """One MoE layer over ``n`` slots: counts sum to B*S*k (dropless) and
    equal the single path's; the token exchange of an int8 or packed tree
    moves int8 rows, and sending them as fp32 instead gives the same bits;
    each slot's grouped MLP takes E/n-expert weight views."""
    cfg = _ep(vit["cfg"][kind])
    lp = _moe_layer(vit["tp"][kind])
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    _, _, single_counts = transformer._moe_apply(x, lp, vit["cfg"][kind])
    exchanged, weights = [], []
    real_a2a, real_mlp = ep.all_to_all, ops.grouped_mlp

    def a2a(send, devices):
        exchanged.append(send[0].dtype)
        return real_a2a(send, devices)

    def mlp(x, wi, wo, *args, **kw):
        weights.append((tuple(wi.shape), tuple(wo.shape), wi.dtype))
        return real_mlp(x, wi, wo, *args, **kw)

    monkeypatch.setattr(ep, "all_to_all", a2a)
    monkeypatch.setattr(ops, "grouped_mlp", mlp)
    with ep.use_ep_mesh(_mesh(n)):
        y, aux, counts = ep.expert_parallel_moe(x, lp, cfg)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    assert y.shape == x.shape and torch.isfinite(y).all() and np.isfinite(float(aux))
    assert int(counts.sum()) == 2 * 9 * k
    assert torch.equal(counts, single_counts)
    # three exchanges: token rows, their local expert ids, the results
    assert exchanged == [torch.int8 if kind != "fp" else torch.float32, torch.int32,
                         torch.float32]
    assert [w[0][0] for w in weights] == [E // n] * n
    assert [w[1][0] for w in weights] == [E // n] * n
    assert {w[2] for w in weights} == {lp["wi"].dtype}
    if kind != "fp":
        with ep.use_ep_mesh(_mesh(n)):
            y_fp, _, _ = ep.expert_parallel_moe(x, lp, cfg, quantize_exchange=False)
        assert torch.equal(y, y_fp)
        assert exchanged[3] == torch.float32
    else:
        with pytest.raises(ValueError, match="wi_as"), ep.use_ep_mesh(_mesh(n)):
            ep.expert_parallel_moe(x, lp, cfg, quantize_exchange=True)


def test_validate_ep_rejects_bad_configs_and_no_mesh_raises(vit):
    cfg = smoke_config(VIT)  # 8 experts
    assert ep.validate_ep(cfg, _mesh(1)) == 1
    bad = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=6))
    with pytest.raises(ValueError, match="not divisible"):
        ep.validate_ep(bad, _mesh(4))
    gshard = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="gshard"))
    with pytest.raises(ValueError, match="grouped"):
        ep.validate_ep(gshard, _mesh(1))
    with pytest.raises(ValueError, match="no MoE"):
        ep.validate_ep(smoke_config("vit-tiny"), _mesh(1))
    with pytest.raises(ValueError, match="'model' axis"):
        ep.validate_ep(cfg, Mesh(["cpu"], ("data",)))
    assert ep.get_ep_mesh() is None
    with pytest.raises(RuntimeError, match="no EP mesh"):
        forward(vit["tp"]["fp"], _ep(cfg), vit["patches"])
    mesh = _mesh(2)
    ep.set_ep_mesh(mesh)
    try:
        assert ep.get_ep_mesh() is mesh
    finally:
        ep.set_ep_mesh(None)


# ---------------------------------------------------------------------------
# dispatch helpers, bit for bit
# ---------------------------------------------------------------------------

def _routing(rng, T, k, E):
    experts = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    weights = rng.random((T, k)).astype(np.float32)
    return experts, weights


@pytest.mark.parametrize("E,n,rows", [(8, 2, 40), (8, 8, 16), (64, 4, 96), (16, 1, 7)])
def test_exchange_plan_and_payload_match_reference(E, n, rows):
    rng = np.random.default_rng(E + n)
    sizes = rng.multinomial(rows, np.ones(E) / E).astype(np.int32)
    for n_rows in (rows, rows + 5):
        np.testing.assert_array_equal(
            dispatch.expert_of_sorted_rows(torch.from_numpy(sizes), n_rows).numpy(),
            np.asarray(jdispatch.expert_of_sorted_rows(jnp.asarray(sizes), n_rows)))
    plan = dispatch.ep_exchange_plan(torch.from_numpy(sizes), n, rows)
    ref = jdispatch.ep_exchange_plan(jnp.asarray(sizes), n, rows)
    for name in plan._fields:
        got, want = getattr(plan, name), np.asarray(getattr(ref, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    x = (rng.standard_normal((rows, 16)) * 3).astype(np.float32)
    for bits in (8, 4):
        got = dispatch.quantize_ep_payload(torch.from_numpy(x), torch.tensor(0.11), bits)
        want = np.asarray(jdispatch.quantize_ep_payload(jnp.asarray(x), jnp.float32(0.11), bits))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,k,E,factor", [(11, 2, 8, 1.25), (64, 2, 8, 0.5), (512, 8, 64, 4.0),
                                          (2048, 8, 64, 1.25), (3, 1, 16, 1.0), (100, 4, 4, 2.0)])
def test_capacity_and_gshard_dispatch_combine_match_reference(T, k, E, factor):
    cap = dispatch.capacity(T, k, E, factor)
    assert cap == jdispatch.capacity(T, k, E, factor)
    if T > 512:
        return
    rng = np.random.default_rng(T)
    experts, weights = _routing(rng, T, k, E)
    x = rng.standard_normal((T, 4)).astype(np.float32)
    disp, comb = dispatch.gshard_dispatch_combine(
        torch.from_numpy(x), torch.from_numpy(experts), torch.from_numpy(weights), E, cap)
    j_disp, j_comb = jdispatch.gshard_dispatch_combine(
        jnp.asarray(x), jnp.asarray(experts), jnp.asarray(weights), E, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(j_disp))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(j_comb))


# ---------------------------------------------------------------------------
# GShard: the registry's OLMoE config (impl="gshard") against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """Smoke OLMoE: params, the taps of the registry config (gshard) on 2
    batches of 2 x 16 tokens, and the int8 / int4 trees PTQ makes from them
    for the serving config (grouped)."""
    jgs = jax_smoke_config(LM).replace(remat=False)
    jcfg = jax_serving_config(jgs)
    tcfg = serving_config(smoke_config(LM))
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    batches = [synth_batch(tcfg, 2, 16, seed=s) for s in (1, 2)]
    taps = jax_calibrate(jgs, params, [{"tokens": jnp.asarray(b)} for b in batches])
    return {"jgs": jgs, "tgs": smoke_config(LM), "tcfg": tcfg, "batches": batches,
            "gs_taps": taps,
            "trees": {"fp": _np_tree(params),
                      "int8": _np_tree(jax_ptq(jcfg, params, taps, materialize="int8")),
                      "int4": _np_tree(jax_ptq(jcfg, params, taps, materialize="int4"))}}


jmod = M.module_for(jax_smoke_config(LM))


@pytest.mark.parametrize("kind,atol", [("fp", 1e-5), ("int8", 5e-3), ("int4", 5e-3)])
def test_gshard_forward_matches_reference(lm, kind, atol):
    assert lm["tgs"].moe.impl == "gshard"
    jcfg, tcfg = lm["jgs"], lm["tgs"]
    if kind != "fp":
        jcfg, tcfg = jax_quantized_config(jcfg), quantized_config(tcfg)
    tree = lm["trees"][kind]
    tokens = synth_batch(tcfg, 2, 11, seed=5)
    j_logits, j_aux = jmod.forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tokens))
    t_logits, t_aux = transformer.forward(bridge.params_from_numpy(tree, "cpu"), tcfg,
                                          torch.from_numpy(tokens))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=atol, rtol=0)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)


@pytest.mark.parametrize("factor,drops", [(4.0, False), (0.5, True)])
def test_gshard_layer_drops_the_reference_slots(lm, factor, drops):
    """One gshard MoE layer at B=1, S=64 (one group of 64 tokens): with a
    small capacity factor slots drop; the kept-slot counts and the output
    equal the reference's."""
    jcfg = lm["jgs"].replace(moe=dataclasses.replace(lm["jgs"].moe, capacity_factor=factor))
    tcfg = lm["tgs"].replace(moe=dataclasses.replace(lm["tgs"].moe, capacity_factor=factor))
    lp = {k: v[0] for k, v in lm["trees"]["fp"]["layers"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal((1, 64, tcfg.d_model)).astype(np.float32)
    j_y, _, j_counts = jmod._moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jcfg)
    t_y, _, t_counts = transformer._moe_apply(
        torch.from_numpy(x), bridge.params_from_numpy(lp, "cpu"), tcfg)
    assert t_counts.dtype == torch.int32
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    assert (int(t_counts.sum()) < 64 * tcfg.moe.top_k) == drops
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), atol=1e-5, rtol=0)


def test_gshard_calibration_matches_reference_taps(lm):
    tp = bridge.params_from_numpy(lm["trees"]["fp"], "cpu")
    taps = calibrate_model(lm["tgs"], tp, [torch.from_numpy(b) for b in lm["batches"]])
    ref = lm["gs_taps"].stats
    assert sorted(taps.stats) == sorted(ref)
    assert any(site.endswith("moe_mid") for site in ref)
    for site, st in ref.items():
        for key in ("min", "max", "absmax"):
            np.testing.assert_allclose(taps.stats[site][key], st[key],
                                       rtol=1e-5, atol=1e-5, err_msg=site)


# ---------------------------------------------------------------------------
# engines and cluster
# ---------------------------------------------------------------------------

def _prompts(cfg, n=5, seed=5):
    rng = np.random.default_rng(seed)
    return [synth_batch(cfg, 1, int(k), seed=seed + i)[0]
            for i, k in enumerate(rng.integers(3, 12, n))]


def _serve(eng, prompts, n_new=4):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.status == "completed" for r in reqs)
    return [r.generated for r in reqs]


@pytest.fixture(scope="module")
def lm_int8(lm):
    qcfg = quantized_config(lm["tcfg"])
    tp = bridge.params_from_numpy(lm["trees"]["int8"], "cpu")
    single = ServeEngine(qcfg, tp, batch_slots=4, max_len=32, device="cpu")
    return qcfg, tp, _serve(single, _prompts(qcfg))


@pytest.mark.parametrize("n", [2, 4])
def test_ep_serve_engine_matches_single_engine(lm_int8, n):
    qcfg, tp, want = lm_int8
    eng = ServeEngine(_ep(qcfg), tp, batch_slots=4, max_len=32, mesh=_mesh(n))
    assert eng._packed and eng.device == torch.device("cpu")
    eng.warmup()
    assert _serve(eng, _prompts(qcfg)) == want
    assert eng.metrics.counters.get("retraces", 0) == 0
    assert eng.metrics.expert_tokens.sum() > 0
    with pytest.raises(ValueError, match="needs mesh="):
        ServeEngine(_ep(qcfg), tp, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_ep_vision_engine_matches_single_engine(vit, n):
    cfg, tp = vit["cfg"]["int8"], vit["tp"]["int8"]
    served = {}
    for tag, eng in (("single", VisionEngine(cfg, tp, batch_buckets=(1, 4), device="cpu")),
                     ("ep", VisionEngine(_ep(cfg), tp, batch_buckets=(1, 4), mesh=_mesh(n)))):
        eng.warmup()
        served[tag] = synth_requests(cfg, 5, seed=3)
        for r in served[tag]:
            eng.submit(r)
        eng.flush()
        served[tag + "_tokens"] = eng.metrics.expert_tokens.copy()
    for a, b in zip(served["single"], served["ep"]):
        np.testing.assert_array_equal(a.classes, b.classes)
        np.testing.assert_array_equal(a.probs, b.probs)
    np.testing.assert_array_equal(served["single_tokens"], served["ep_tokens"])
    with pytest.raises(ValueError, match="needs mesh="):
        VisionEngine(_ep(cfg), tp, device="cpu")


def test_ep_cluster_is_one_replica_over_every_slot_and_grows_whole(lm_int8):
    qcfg, tp, want = lm_int8
    cluster = ServingCluster(_ep(qcfg), tp, devices=["cpu"] * 4, engine="lm",
                             batch_slots=4, max_len=32)
    assert cluster.num_replicas == 1 and len(cluster.meshes) == 1
    eng = cluster.engines[0]
    assert eng.mesh.shape == {"model": 4} and eng.device == torch.device("cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts(qcfg))]
    for r in reqs:
        cluster.submit(r)
        cluster.step()
    cluster.flush()
    assert [r.generated for r in reqs] == want
    # a replica grown past the pool (the autoscaler's scale_up with no
    # standby left: a cold spawn) spans the whole mesh
    assert cluster.scale_up() and cluster.num_replicas == 2
    grown = cluster.engines[-1]
    assert grown is not eng and grown.mesh.shape == {"model": 4}


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_replica_meshes_and_elastic_mesh_match_reference(n_dev):
    """Groupings of the port's meshes (devices named, nothing allocated)
    against the reference's over stand-in device objects."""

    class Dev:
        def __init__(self, i):
            self.id = i

    port_devs = [torch.device("cuda", i) for i in range(n_dev)]
    ref_devs = [Dev(i) for i in range(n_dev)]
    for n_rep in range(1, 10):
        port = replica_meshes(n_rep, port_devs)
        ref = jax_replica_meshes(n_rep, ref_devs)
        assert [[d.index for d in m.devices.flat] for m in port] == \
            [[d.id for d in m.devices.flat] for m in ref]
        assert [m.shape for m in port] == [dict(m.shape) for m in ref]
    for shape, names in (((4, 2), ("data", "model")), ((8,), ("data",)), ((2, 2, 2), ("pod", "data", "model"))):
        try:
            ref = jax_elastic_mesh(shape, names, ref_devs)
        except ValueError:
            with pytest.raises(ValueError, match="cannot fit"):
                elastic_mesh(shape, names, port_devs)
            continue
        port = elastic_mesh(shape, names, port_devs)
        assert port.shape == dict(ref.shape) and port.axis_names == tuple(ref.axis_names)
        assert [d.index for d in port.devices.flat] == [d.id for d in ref.devices.flat]


def test_meshes_default_to_the_card_and_refuse_without_one():
    host = make_host_mesh(2, devices=["cpu"] * 4)
    assert host.shape == {"data": 2, "model": 2} and host.size == 4
    assert make_ep_mesh(devices=["cpu"] * 3).shape == {"model": 3}
    with pytest.raises(ValueError, match="must be >="):
        make_ep_mesh(4, devices=["cpu"] * 2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are usable")
    for fn in (make_ep_mesh, make_host_mesh, lambda: elastic_mesh((1,), ("data",))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
