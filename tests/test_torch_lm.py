"""The port's OLMoE LM path (forward, prefill, packed prefill, per-slot
decode, calibration, PTQ int8/int4, ServeEngine) against the JAX reference
at smoke size, on the CPU (the port's plain kernel versions).

Both packages get the serving config (grouped experts): the reference's
OLMoE config names the gshard capacity path, which its calibration would
otherwise run. Weights are the reference's, carried over by the bridge.

Tolerances:
  * fp tree: logits and f32 caches within atol 1e-4 (f32 sums in another
    order through 4 layers and top-2 routing);
  * PTQ leaves: scales rtol 1e-6, folded fp leaves rtol 1e-5, stored
    integer leaves equal except 1-LSB steps on a tiny fraction (s_tilde is a
    mean whose reduction order differs);
  * quantized trees (int8 activations, int8 K/V, 4-bit attention): logits
    within atol 5e-3, the size of one activation LSB flip at a rounding
    boundary; int8 K/V rows within 1 LSB.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import smoke_config as jax_smoke_config
from repro.core.quant.ptq import calibrate_model as jax_calibrate
from repro.core.quant.ptq import ptq_model as jax_ptq
from repro.core.quant.ptq import quantized_config as jax_quantized_config
from repro.serving.engine import serving_config as jax_serving_config

from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.models import init_model_params, synth_batch, transformer
from repro_torch.serving import Backpressure, Request, ServeEngine, serving_config

ARCH = "olmoe-1b-7b"
jmod = M.module_for(jax_smoke_config(ARCH))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def lm():
    """JAX smoke OLMoE (serving config): fp params, calibration on 2
    batches of 2 x 16 tokens, int8 and int4 PTQ trees."""
    jcfg = jax_serving_config(jax_smoke_config(ARCH)).replace(remat=False)
    tcfg = serving_config(smoke_config(ARCH))
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    batches = [synth_batch(tcfg, 2, 16, seed=s) for s in (1, 2)]
    taps = jax_calibrate(jcfg, params, [{"tokens": jnp.asarray(b)} for b in batches])
    return {
        "jcfg": jcfg, "tcfg": tcfg, "batches": batches, "taps": taps,
        "fp": _np_tree(params),
        "int8": _np_tree(jax_ptq(jcfg, params, taps, materialize="int8")),
        "int4": _np_tree(jax_ptq(jcfg, params, taps, materialize="int4")),
    }


def _cfgs(lm, kind):
    if kind == "fp":
        return lm["jcfg"], lm["tcfg"]
    return jax_quantized_config(lm["jcfg"]), quantized_config(lm["tcfg"])


def _trees(lm, kind):
    return (jax.tree.map(jnp.asarray, lm[kind]),
            bridge.params_from_numpy(lm[kind], "cpu"))


def _atol(kind):
    return 1e-4 if kind == "fp" else 5e-3


def _close_cache(t_cache, j_cache, kind):
    for name, j in j_cache.items():
        t, j = t_cache[name].float().numpy(), np.asarray(j, np.float32)
        if name in ("k", "v") and kind != "fp":
            assert np.abs(t - j).max() <= 1, name  # int8 rows: at most 1 LSB
        elif name.endswith("scale"):
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, atol=_atol(kind), rtol=0, err_msg=name)


def test_forward_matches_reference(lm):
    jp, tp = _trees(lm, "fp")
    tokens = synth_batch(lm["tcfg"], 2, 11, seed=5)
    j_logits, j_aux = jmod.forward(jp, lm["jcfg"], jnp.asarray(tokens))
    t_logits, t_aux = transformer.forward(tp, lm["tcfg"], torch.from_numpy(tokens))
    assert t_logits.shape == (2, 11, lm["tcfg"].vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_prefill_matches_reference(lm, kind):
    jcfg, tcfg = _cfgs(lm, kind)
    jp, tp = _trees(lm, kind)
    tokens = synth_batch(tcfg, 2, 9, seed=6)
    j_logits, j_cache = jmod.prefill(jp, jcfg, jnp.asarray(tokens), max_len=12)
    t_logits, t_cache = transformer.prefill(tp, tcfg, torch.from_numpy(tokens), max_len=12)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=_atol(kind), rtol=0)
    assert sorted(t_cache) == sorted(j_cache)
    _close_cache(t_cache, j_cache, kind)


def _pack(lengths, bucket, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, bucket), np.int32)
    positions = np.zeros(bucket, np.int32)
    seg = np.full(bucket, -1, np.int32)
    last, cursor = [], 0
    for i, n in enumerate(lengths):
        tokens[0, cursor:cursor + n] = rng.integers(0, 256, n)
        positions[cursor:cursor + n] = np.arange(n)
        seg[cursor:cursor + n] = i
        last.append(cursor + n - 1)
        cursor += n
    return tokens, positions, seg, np.asarray(last + [0], np.int32)  # + a dummy


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_prefill_packed_matches_reference(lm, kind):
    """Logits per prompt and the packed cache, three segments and a pad
    tail in one row (and a dummy last_idx entry, as the engine pads)."""
    jcfg, tcfg = _cfgs(lm, kind)
    jp, tp = _trees(lm, kind)
    args = _pack((5, 9, 3), 32, seed=7)
    j_logits, j_cache = jmod.prefill_packed(jp, jcfg, *map(jnp.asarray, args), max_len=32)
    t_logits, t_cache = transformer.prefill_packed(
        tp, tcfg, *map(torch.from_numpy, args), max_len=32)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=_atol(kind), rtol=0)
    # the pad tail (ids -1) attends among itself: compare the real rows
    real = {n: (c[:, :, :17] if isinstance(c, torch.Tensor) else np.asarray(c)[:, :, :17])
            for n, c in t_cache.items()}
    _close_cache(real, {n: np.asarray(c)[:, :, :17] for n, c in j_cache.items()}, kind)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_decode_steps_match_reference(lm, kind):
    """Four decode steps with per-slot fill positions over a cache that a
    prefill filled: logits every step and the cache at the end."""
    jcfg, tcfg = _cfgs(lm, kind)
    jp, tp = _trees(lm, kind)
    prompt = synth_batch(tcfg, 2, 8, seed=8)
    _, j_cache = jmod.prefill(jp, jcfg, jnp.asarray(prompt), max_len=16)
    _, t_cache = transformer.prefill(tp, tcfg, torch.from_numpy(prompt), max_len=16)
    index = np.asarray([8, 5], np.int32)  # slot 1 restarts inside its prompt
    rng = np.random.default_rng(9)
    for _ in range(4):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        j_logits, j_cache, j_stats = jmod.decode_step(
            jp, jcfg, jnp.asarray(tok), j_cache, jnp.asarray(index), with_stats=True)
        t_logits, t_cache, t_stats = transformer.decode_step(
            tp, tcfg, torch.from_numpy(tok), t_cache, torch.from_numpy(index),
            with_stats=True)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=_atol(kind), rtol=0)
        np.testing.assert_array_equal(t_stats["expert_tokens"].numpy(),
                                      np.asarray(j_stats["expert_tokens"]))
        index = index + 1
    _close_cache(t_cache, j_cache, kind)


def test_calibration_taps_match_reference(lm):
    tp = bridge.params_from_numpy(lm["fp"], "cpu")
    taps = calibrate_model(lm["tcfg"], tp, [torch.from_numpy(b) for b in lm["batches"]])
    ref = lm["taps"].stats
    assert sorted(taps.stats) == sorted(ref)
    for site, st in ref.items():
        for key in ("min", "max", "absmax"):
            np.testing.assert_allclose(taps.stats[site][key], st[key],
                                       rtol=1e-5, atol=1e-5, err_msg=site)


@pytest.mark.parametrize("materialize", ["fake", "int8", "int4"])
def test_ptq_matches_reference_leaf_by_leaf(lm, materialize):
    """Same taps into both drivers: the RMSNorm fold, the gate fold, the
    activation scales and the stored int8 / nibble-packed int4 leaves."""
    jcfg = jax_quantized_config(lm["jcfg"])
    jp = jax.tree.map(jnp.asarray, lm["fp"])
    ref = _flat(_np_tree(jax_ptq(jcfg, jp, lm["taps"], materialize=materialize)))
    taps = TapCollector()
    taps.stats = lm["taps"].stats
    port = _flat(bridge.params_to_numpy(ptq_model(
        quantized_config(lm["tcfg"]), bridge.params_from_numpy(lm["fp"], "cpu"), taps,
        materialize=materialize)))
    assert sorted(port) == sorted(ref)
    for name, r in ref.items():
        t = port[name]
        assert t.dtype == r.dtype and t.shape == r.shape, name
        if r.dtype == np.uint8:  # nibble pairs: compare the unpacked values
            from repro.core.quant.qtypes import unpack_int4
            diff = np.abs(np.asarray(unpack_int4(jnp.asarray(t))).astype(np.int32)
                          - np.asarray(unpack_int4(jnp.asarray(r))).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
        elif r.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
        elif name.endswith(("_scale", "_as")):
            np.testing.assert_allclose(t, r, rtol=1e-6, atol=0, err_msg=name)
        else:  # folded fp leaves; RMSNorm's (1+g)/r1 - 1 cancels to small values
            np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6, err_msg=name)
    if materialize == "int4":
        assert port["layers.moe.wi"].dtype == np.uint8
        assert port["layers.moe.gate"].dtype == np.int8


def test_ptq_scheme_map_validation(lm):
    tcfg = quantized_config(lm["tcfg"])
    tp = bridge.params_from_numpy(lm["fp"], "cpu")
    taps = TapCollector()
    taps.stats = lm["taps"].stats
    bad = tcfg.replace(quant=dataclasses.replace(tcfg.quant, scheme_map=(("attn.wq", "int4"),)))
    with pytest.raises(ValueError, match="int4"):
        ptq_model(bad, tp, taps, materialize="int4")
    with pytest.raises(ValueError, match="materialize"):
        ptq_model(tcfg, tp, taps, materialize="int2")


def _greedy_loop(tp, cfg, prompt, n_new):
    """The slowest correct generation: a full teacher-forced forward per
    token over the growing sequence. Returns tokens and their logits."""
    toks, out, logits = list(map(int, prompt)), [], []
    for _ in range(n_new):
        lg = transformer.forward(tp, cfg, torch.tensor([toks]))[0][0, -1]
        out.append(int(torch.argmax(lg)))
        logits.append(lg)
        toks.append(out[-1])
    return out, logits


def _serve(cfg, tp, prompts, n_new, **kw):
    eng = ServeEngine(cfg, tp, device="cpu", **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, reqs


def test_engine_greedy_tokens_follow_teacher_forced_loop(lm):
    """Packed admission of mixed lengths + per-slot decode over the bf16
    cache: each token the engine emits is the teacher-forced argmax, or
    within 1e-2 of it (a bf16 K/V rounding can flip a near tie)."""
    tp = bridge.params_from_numpy(lm["fp"], "cpu")
    prompts = [synth_batch(lm["tcfg"], 1, n, seed=20 + n)[0] for n in (4, 11, 7, 9, 5)]
    eng, reqs = _serve(lm["tcfg"], tp, prompts, 4, batch_slots=4, max_len=32)
    assert eng.metrics.counters["completed"] == 5
    assert eng.metrics.counters["tokens"] == sum(len(r.generated) - 1 for r in reqs)
    for r in reqs:
        assert len(r.generated) == 4
        toks = list(map(int, r.prompt))
        for t in r.generated:
            lg = transformer.forward(tp, lm["tcfg"], torch.tensor([toks]))[0][0, -1]
            assert float(lg[t]) >= float(lg.max()) - 1e-2, r.uid
            toks.append(t)
    want, _ = _greedy_loop(tp, lm["tcfg"], prompts[0], 4)
    assert reqs[0].generated == want


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_packed_admission_matches_solo_runs(lm, kind):
    """Mixed-length prompts admitted through ONE packed dispatch give each
    prompt's solo generation through the same engine exactly: segment
    masking, within-segment RoPE and the merge into slots leak nothing."""
    _, tcfg = _cfgs(lm, kind)
    tp = bridge.params_from_numpy(lm[kind], "cpu")
    prompts = [synth_batch(tcfg, 1, n, seed=30 + n)[0] for n in (4, 11, 7, 9)]
    solo_eng = ServeEngine(tcfg, tp, batch_slots=4, max_len=32, device="cpu")
    solo = []
    for i, p in enumerate(prompts):
        req = Request(uid=100 + i, prompt=p, max_new_tokens=3)
        solo_eng.submit(req)
        solo_eng.run_until_drained()
        solo.append(req.generated)
    eng, reqs = _serve(tcfg, tp, prompts, 3, batch_slots=4, max_len=32)
    assert eng.metrics.counters["prefill_batches"] == 1
    assert eng.metrics.counters["pack_real_tokens"] == 31
    assert eng.metrics.counters["pack_pad_tokens"] == 1
    assert solo_eng.metrics.counters["prefill_batches"] == 4
    assert [r.generated for r in reqs] == solo
    if tcfg.moe is not None:
        assert eng.metrics.expert_tokens.sum() > 0


def test_engine_eos_deadline_and_admission_limits(lm):
    tp = bridge.params_from_numpy(lm["fp"], "cpu")
    cfg = lm["tcfg"]
    prompt = synth_batch(cfg, 1, 6, seed=40)[0]
    _, [ref_req] = _serve(cfg, tp, [prompt], 5, batch_slots=2, max_len=32)
    eos = ref_req.generated[1]
    eng = ServeEngine(cfg, tp, batch_slots=2, max_len=32, eos_id=eos, device="cpu",
                      max_pending=1)
    req = Request(uid=0, prompt=prompt, max_new_tokens=5)
    eng.submit(req)
    eng.run_until_drained()
    assert req.generated[:2] == ref_req.generated[:2] and req.eos_seen
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(Request(uid=1, prompt=np.zeros(32, np.int32), max_new_tokens=1))
    clock = [0.0]
    eng = ServeEngine(cfg, tp, batch_slots=1, max_len=32, device="cpu",
                      max_pending=1, clock=lambda: clock[0])
    late = Request(uid=2, prompt=prompt, max_new_tokens=3, deadline=0.5)
    eng.submit(Request(uid=3, prompt=prompt, max_new_tokens=3))
    eng.submit(late)  # the first is admitted into the free slot
    with pytest.raises(Backpressure):
        eng.submit(Request(uid=4, prompt=prompt, max_new_tokens=3))
    clock[0] = 1.0
    eng.run_until_drained()
    assert late.status == "cancelled" and eng.metrics.counters["cancelled"] == 1


def test_late_retirement_reads_the_tokens_each_tick_decoded(lm):
    """One slot: the tick that ends the first request frees the slot and
    the next admission refills it. The retirement thread, held back until
    everything is served, still reads the tokens each tick decoded (not
    the next request's first token), as inline retirement does."""
    import dataclasses
    import threading

    tp = bridge.params_from_numpy(lm["fp"], "cpu")
    cfg = lm["tcfg"]
    prompts = [synth_batch(cfg, 1, n, seed=60 + n)[0] for n in (5, 7, 6)]
    inline = cfg.replace(serve=dataclasses.replace(cfg.serve, async_retire=False))
    _, want = _serve(inline, tp, prompts, 3, batch_slots=1, max_len=32)
    eng = ServeEngine(cfg, tp, batch_slots=1, max_len=32, device="cpu")
    assert eng._async
    gate, consume = threading.Event(), eng._consume
    eng._consume = lambda ev: (gate.wait(), consume(ev))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while eng.active or eng.scheduler.depth:
        eng.step()
    gate.set()
    eng._rq.join()
    assert [r.generated for r in reqs] == [r.generated for r in want]


def test_seeded_lm_init_matches_reference_shapes(lm):
    cfg = lm["tcfg"]
    a, b = init_model_params(cfg, 3, "cpu"), init_model_params(cfg, 3, "cpu")
    fa, fb = _flat(bridge.params_to_numpy(a)), _flat(bridge.params_to_numpy(b))
    ref = _flat(lm["fp"])
    assert sorted(fa) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(fa[name], fb[name])
        assert fa[name].shape == r.shape and fa[name].dtype == r.dtype, name
    assert float(np.std(fa["embed"])) == pytest.approx(0.02, rel=0.1)


def test_bridge_carries_quantized_lm_trees(lm):
    for kind in ("int8", "int4"):
        tp = bridge.params_from_numpy(lm[kind], "cpu")
        assert tp["layers"]["attn"]["wq"].dtype == torch.int8
        assert tp["layers"]["attn"]["wq"].shape[0] == lm["tcfg"].num_layers
        assert tp["layers"]["moe"]["wi"].dtype == (torch.uint8 if kind == "int4"
                                                    else torch.int8)
        assert "lm_head_as" in tp and "wo_a_scale" in tp["layers"]["moe"]
        jax.tree.map(np.testing.assert_array_equal, bridge.params_to_numpy(tp), lm[kind])


def test_grouped_combine_adds_each_token_in_buffer_order():
    """The combine lines each token's k rows up in buffer order and sums
    them with no atomics: on the CPU bit for bit the sequential scatter-add
    the reference describes, and the same from run to run on any device."""
    from repro_torch.core.moe.dispatch import grouped_combine, grouped_dispatch

    g = torch.Generator().manual_seed(0)
    T, k, E, D = 37, 8, 64, 96
    x = torch.randn(T, D, generator=g)
    experts = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)]).int()
    d = grouped_dispatch(x, experts, torch.rand(T, k, generator=g), E)
    y = torch.randn(T * k, D, generator=g)
    want = torch.zeros(T, D)
    for row in range(T * k):  # the scatter-add, one row at a time
        t = int(d.token_idx[row])
        want[t] = want[t] + y[row] * d.weights_sorted[row]
    assert torch.equal(grouped_combine(y, d, T), want)


def test_async_retirement_loses_no_update_under_thread_switching(lm):
    """The retirement thread appends tokens and counts completions while
    the decode loop admits and ticks: with a tiny switch interval, every
    request still ends with exactly its tokens and the counters add up."""
    import sys

    tp = bridge.params_from_numpy(lm["fp"], "cpu")
    cfg = lm["tcfg"]
    done = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng = ServeEngine(cfg, tp, batch_slots=3, max_len=32, device="cpu")
        assert eng._async
        reqs = [Request(uid=i, prompt=synth_batch(cfg, 1, 3 + i % 5, seed=50 + i)[0],
                        max_new_tokens=2 + i % 3, on_done=done.append)
                for i in range(8)]
        for r in reqs:
            eng.submit(r)
            eng.step()
        eng.run_until_drained()
    finally:
        sys.setswitchinterval(old)
    assert eng._rthread.is_alive() and eng.idle
    assert sorted(r.uid for r in done) == list(range(8))
    for r in reqs:
        assert r.status == "completed" and len(r.generated) == r.max_new_tokens, r.uid
    c = eng.metrics.counters
    assert c["completed"] == 8 and c["submitted"] == 8
    assert c["tokens"] == sum(len(r.generated) - 1 for r in reqs)


def test_dropped_engine_is_freed_and_its_retirement_thread_ends(lm):
    """The retirement thread holds its engine weakly: once the caller drops
    the engine, the engine (with its weights' references and its cache) is
    collected and the thread exits."""
    import gc
    import weakref

    cfg = lm["tcfg"]
    eng = ServeEngine(cfg, bridge.params_from_numpy(lm["fp"], "cpu"), batch_slots=2,
                      max_len=32, device="cpu")
    req = Request(uid=0, prompt=synth_batch(cfg, 1, 5, seed=80)[0], max_new_tokens=3)
    eng.submit(req)
    eng.run_until_drained()
    thread, cache, ref = eng._rthread, eng.cache["k"], weakref.ref(eng)
    assert thread.is_alive() and req.status == "completed"
    cache_ref = weakref.ref(cache)
    del eng, cache
    gc.collect()
    assert ref() is None and cache_ref() is None
    thread.join(timeout=10)
    assert not thread.is_alive()
