"""The PyTorch port's M3ViT forward, PTQ and serving against the JAX
reference at smoke size, on the CPU (the port's plain kernel versions).

Same numpy weights and inputs go through ``repro`` and ``repro_torch``:
  * fp and fake-quant trees: logits within atol 1e-5 (f32 sums in another
    order);
  * the materialized-int8 tree: logits and probs within atol 2e-3 with
    top-1 equal -- an activation that lands within rounding noise of a
    quantizer boundary may round the other way and move a probability by
    ~1e-3, the same size as the reference's own int8-vs-fake difference;
  * routed-token histograms (``expert_tokens``) equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape
from repro.configs import smoke_config as jax_smoke_config
from repro.core.quant.ptq import calibrate_model as jax_calibrate
from repro.core.quant.ptq import ptq_model as jax_ptq
from repro.core.quant.ptq import quantized_config as jax_quantized_config
from repro.serving.scheduler import MicroBatcher as JaxMicroBatcher
from repro.serving.metrics import LatencyTracker as JaxLatencyTracker

from repro_torch import bridge
from repro_torch.configs import REGISTRY, get_config, smoke_config
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.models import ViTClassifier, classify, forward, init_model_params
from repro_torch.models.param import tree_bytes
from repro_torch.serving import MicroBatcher, VisionEngine, synth_requests
from repro_torch.serving.metrics import LatencyTracker

ARCH = "m3vit-small"


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def trees():
    """JAX smoke M3ViT-S: fp params, calibration taps, fake and int8 PTQ."""
    cfg = jax_smoke_config(ARCH).replace(remat=False)
    params = M.init_model_params(cfg, jax.random.PRNGKey(0))
    shape = get_shape("train_4k").replace(seq_len=24, global_batch=2)
    batches = [M.synth_batch(cfg, shape, jax.random.PRNGKey(i)) for i in range(2)]
    taps = jax_calibrate(cfg, params, batches)
    return {
        "cfg": cfg,
        "batches": [np.asarray(b["patches"], np.float32) for b in batches],
        "taps": taps,
        "fp": _np_tree(params),
        "fake": _np_tree(jax_ptq(cfg, params, taps)),
        "int8": _np_tree(jax_ptq(cfg, params, taps, materialize="int8")),
    }


def _patches(cfg, n=3, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.image_tokens - 1, 768)).astype(np.float32)


def _both(trees, kind, x):
    """(jax classify/forward outputs, port outputs) on the same tree."""
    jcfg = trees["cfg"] if kind == "fp" else jax_quantized_config(trees["cfg"])
    tcfg = smoke_config(ARCH)
    jp = jax.tree.map(jnp.asarray, trees[kind])
    tp = bridge.params_from_numpy(trees[kind], "cpu")
    j_logits, _ = M.forward(jp, jcfg, {"patches": jnp.asarray(x)})
    j_cls = M.classify(jp, jcfg, jnp.asarray(x), top_k=5)
    xt = torch.from_numpy(x)
    t_logits, _ = forward(tp, tcfg, xt)
    t_cls = classify(tp, tcfg, xt, top_k=5)
    return np.asarray(j_logits), j_cls, t_logits.numpy(), t_cls


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_configs_match_reference(name):
    for port, ref in ((get_config(name), jax_get_config(name)),
                      (smoke_config(name), jax_smoke_config(name))):
        for f in dataclasses.fields(port):
            a, b = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                for g in dataclasses.fields(a):
                    assert getattr(a, g.name) == getattr(b, g.name), (f.name, g.name)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("kind,atol", [("fp", 1e-5), ("fake", 1e-5), ("int8", 2e-3)])
def test_forward_and_classify_match_reference(trees, kind, atol):
    x = _patches(trees["cfg"])
    j_logits, j_cls, t_logits, t_cls = _both(trees, kind, x)
    np.testing.assert_allclose(t_logits, j_logits, atol=atol, rtol=0)
    np.testing.assert_allclose(t_cls["probs"].numpy(), np.asarray(j_cls["probs"]),
                               atol=atol, rtol=0)
    np.testing.assert_array_equal(t_cls["classes"].numpy()[:, 0],
                                  np.asarray(j_cls["classes"])[:, 0])
    np.testing.assert_array_equal(t_cls["expert_tokens"].numpy(),
                                  np.asarray(j_cls["expert_tokens"]))


def test_int8_tree_is_executed_as_stored(trees):
    """The bridge keeps int8 weights int8 (and the fp32 leaves fp32), so the
    port's forward runs the int8 path, at a quarter of the weight bytes."""
    tp = bridge.params_from_numpy(trees["int8"], "cpu")
    assert tp["pairs_moe"]["moe"]["wi"].dtype == torch.int8
    assert tp["pairs_moe"]["moe"]["wi_scale"].dtype == torch.float32
    assert tp["pairs_dense"]["attn"]["wo_a_scale"].shape == (2,)
    assert tp["head_as"].shape == ()
    fp = bridge.params_from_numpy(trees["fp"], "cpu")
    assert tree_bytes(tp) < 0.3 * tree_bytes(fp)
    back = bridge.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, trees["int8"])


def test_calibration_taps_match_reference(trees):
    tcfg = smoke_config(ARCH)
    tp = bridge.params_from_numpy(trees["fp"], "cpu")
    taps = calibrate_model(tcfg, tp, [torch.from_numpy(b) for b in trees["batches"]])
    ref = trees["taps"].stats
    assert sorted(taps.stats) == sorted(ref)
    for site, st in ref.items():
        for key in ("min", "max", "absmax"):
            np.testing.assert_allclose(taps.stats[site][key], st[key],
                                       rtol=1e-5, atol=1e-5, err_msg=site)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("materialize,fold_only", [("fake", False), ("int8", False),
                                                   ("fake", True)])
def test_ptq_matches_reference_leaf_by_leaf(trees, materialize, fold_only):
    """Same taps into both PTQ drivers. Scales agree to rtol 1e-6, folded
    fp leaves to rtol 1e-5 (products of those scales); int8
    leaves are equal except for 1-LSB steps on a tiny fraction, because
    s_tilde is a mean whose reduction order differs between the frameworks
    and a weight on a rounding boundary may round the other way."""
    cfg = jax_quantized_config(trees["cfg"])
    jp = jax.tree.map(jnp.asarray, trees["fp"])
    ref = _flat(_np_tree(jax_ptq(cfg, jp, trees["taps"], fold_only=fold_only,
                                 materialize=materialize)))
    taps = TapCollector()
    taps.stats = trees["taps"].stats
    port = _flat(bridge.params_to_numpy(ptq_model(
        quantized_config(smoke_config(ARCH)),
        bridge.params_from_numpy(trees["fp"], "cpu"), taps,
        fold_only=fold_only, materialize=materialize)))
    assert sorted(port) == sorted(ref)
    for name, r in ref.items():
        t = port[name]
        assert t.dtype == r.dtype and t.shape == r.shape, name
        if r.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
        elif name.endswith(("scale", "_as")):
            np.testing.assert_allclose(t, r, rtol=1e-6, atol=0, err_msg=name)
        else:  # folded fp weights and biases
            np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6, err_msg=name)


def test_vit_classifier_module_matches_classify(trees):
    tcfg = quantized_config(smoke_config(ARCH))
    tp = bridge.params_from_numpy(trees["int8"], "cpu")
    model = ViTClassifier(tcfg, tp, device="cpu", top_k=3)
    assert model.get_buffer("pairs_moe/moe/wi").dtype == torch.int8
    x = torch.from_numpy(_patches(trees["cfg"], n=2))
    out, direct = model(x), classify(tp, tcfg, x, top_k=3)
    for k in ("classes", "probs", "expert_tokens"):
        torch.testing.assert_close(out[k], direct[k], rtol=0, atol=0)


def test_seeded_init_is_reproducible_and_shaped_like_reference(trees):
    cfg = smoke_config(ARCH)
    a, b = init_model_params(cfg, 3, "cpu"), init_model_params(cfg, 3, "cpu")
    jax.tree.map(np.testing.assert_array_equal, bridge.params_to_numpy(a),
                 bridge.params_to_numpy(b))
    shapes = jax.tree.map(lambda t: t.shape, bridge.params_to_numpy(a))
    assert shapes == jax.tree.map(lambda t: t.shape, trees["fp"])


def test_vision_engine_serves_padded_batches_like_direct_classify(trees):
    """Bucketed, padded serving returns each image's direct classify result
    (padding never leaks), and meters requests, frames and occupancy."""
    tcfg = quantized_config(smoke_config(ARCH))
    tp = bridge.params_from_numpy(trees["int8"], "cpu")
    reqs = synth_requests(tcfg, 7, seed=3)
    eng = VisionEngine(tcfg, tp, batch_buckets=(1, 4), max_wait_s=1.0, top_k=3,
                       device="cpu")
    for r in reqs:
        eng.submit(r)
        eng.step()  # dispatches only the full bucket of 4
    eng.flush()  # releases the partial batch of 3, padded to 4
    assert all(r.done for r in reqs)
    for r in reqs:
        out = classify(tp, tcfg, torch.from_numpy(r.patches)[None], top_k=3)
        np.testing.assert_array_equal(r.classes, out["classes"].numpy()[0])
        np.testing.assert_allclose(r.probs, out["probs"].numpy()[0], atol=1e-6)
    snap = eng.metrics.snapshot()
    assert snap["counters"]["completed"] == snap["counters"]["frames"] == 7
    assert snap["counters"]["batches"] == 2  # 4 + 3 padded to 4
    assert snap["latency_ms"]["n"] == 7
    assert sum(snap["expert_tokens"]) > 0


def test_vision_engine_keeps_two_batches_in_flight(trees):
    tcfg = smoke_config(ARCH)
    eng = VisionEngine(tcfg, bridge.params_from_numpy(trees["fp"], "cpu"),
                       batch_buckets=(2,), max_wait_s=0.0, max_inflight=2,
                       device="cpu")
    for r in synth_requests(tcfg, 4, seed=1):
        eng.submit(r)
    eng._dispatch_ready()
    assert eng.inflight == 4
    eng.flush()
    assert eng.metrics.counters["frames"] == 4 and eng.idle


def test_backpressure_surfaces_to_clients(trees):
    from repro_torch.serving import Backpressure

    tcfg = smoke_config(ARCH)
    eng = VisionEngine(tcfg, bridge.params_from_numpy(trees["fp"], "cpu"),
                       batch_buckets=(4,), max_wait_s=100.0, max_pending=2,
                       device="cpu")
    reqs = synth_requests(tcfg, 3)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(Backpressure):
        eng.submit(reqs[2])
    assert eng.metrics.counters["rejected"] == 1
    eng.flush()  # queued work still completes
    assert reqs[0].done and reqs[1].done and not reqs[2].done


def test_synth_requests_match_reference(trees):
    from repro.serving.vision import synth_requests as jax_synth

    for a, b in zip(synth_requests(smoke_config(ARCH), 3, seed=4),
                    jax_synth(trees["cfg"], 3, seed=4)):
        np.testing.assert_array_equal(a.patches, b.patches)


def test_micro_batcher_matches_reference():
    """A scripted admission sequence forms the same batches in both."""
    script = [("submit", 0.0), ("submit", 0.1), ("poll", 0.2), ("submit", 0.3),
              ("submit", 0.3), ("submit", 0.35), ("poll", 0.4), ("poll", 0.9),
              ("drain", 1.0), ("poll", 1.0)]
    seen = []
    for cls in (MicroBatcher, JaxMicroBatcher):
        mb = cls(batch_sizes=(1, 2, 4), max_wait_s=0.5, max_pending=8,
                 bucket_of=lambda i: i % 2)
        out, uid = [], 0
        for op, t in script:
            if op == "submit":
                mb.submit(uid, now=t)
                uid += 1
            elif op == "drain":
                mb.drain(True)
            else:
                b = mb.poll(now=t)
                out.append(None if b is None else (b.items, b.pad_to))
        seen.append(out)
    assert seen[0] == seen[1]


def test_latency_tracker_matches_reference():
    samples = np.random.default_rng(0).lognormal(-5, 1, 300)
    port, ref = LatencyTracker(maxlen=100), JaxLatencyTracker(maxlen=100)
    for s in samples:
        port.record(s)
        ref.record(s)
    assert port.snapshot() == ref.snapshot()
