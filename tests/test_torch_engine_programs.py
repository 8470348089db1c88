"""The port's serving programs (``serving/engine.py``, ``serving/vision.py``,
``serving/programs.py``) on the CPU, where every program runs eagerly
through the code a CUDA graph captures on the card: the reference's
program-cache keys, the fixed-shape masked merge of a pack into its slots,
``retraces`` after ``warmup()``, and the same tokens, classes and
probabilities with ``aot_warmup`` on and off. Seeded random weights at
smoke size; every comparison is exact (the same arithmetic on one device).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.serving.engine import ServeEngine as JaxServeEngine

from repro_torch.configs import smoke_config
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.models import init_model_params, ssm_lm, synth_batch, synth_patches
from repro_torch.serving import Request, ServeEngine, VisionEngine, serving_config
from repro_torch.serving import programs
from repro_torch.serving.engine import merge_pack
from repro_torch.serving.vision import synth_requests


def _aot(cfg, on: bool):
    return cfg.replace(serve=dataclasses.replace(cfg.serve, aot_warmup=on))


@pytest.fixture(scope="module")
def olmoe():
    """Smoke OLMoE (serving config): fp params and its int8 tree."""
    cfg = serving_config(smoke_config("olmoe-1b-7b"))
    params = init_model_params(cfg, seed=0, device="cpu")
    calib = [torch.from_numpy(synth_batch(cfg, 2, 16, seed=s)) for s in (1, 2)]
    taps = calibrate_model(cfg, params, calib)
    qcfg = quantized_config(cfg)
    return {"fp": (cfg, params), "int8": (qcfg, ptq_model(qcfg, params, taps,
                                                           materialize="int8"))}


def _prompts(cfg, lens, seed):
    return [synth_batch(cfg, 1, n, seed=seed + i)[0] for i, n in enumerate(lens)]


def _serve(eng, prompts, n_new=4):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("B,S,prog,kv", [
    (8, 512, "decode", {}),
    (8, 512, "packed_prefill", {"bucket": 32, "n": 1}),
    (4, 256, "packed_prefill", {"n": 4, "bucket": 256}),
    (1, 64, "packed_prefill", {"bucket": 64, "n": 1}),
])
def test_program_keys_match_reference(B, S, prog, kv):
    """``_program_key`` gives the reference engine's string for the same
    slots, cache length and keys: ``serve/<prog>|B=..|S=..|k=v``, keys
    sorted."""
    fake = types.SimpleNamespace(B=B, max_len=S)
    want = JaxServeEngine._program_key(fake, prog, **kv)
    assert ServeEngine._program_key(fake, prog, **kv) == want
    assert want.startswith(f"serve/{prog}|B={B}|S={S}")


def _loop_merge(cache, part, starts, lens, slots):
    """The merge the packed admission ran before: each real entry's rows
    copied into its slot with host integers."""
    for s, n, slot in zip(starts, lens, slots):
        if n:
            for name, buf in cache.items():
                buf[:, slot, :n] = part[name][:, 0, s:s + n]


@pytest.mark.parametrize("seed", range(8))
def test_masked_merge_equals_the_loop_merge(seed):
    """``merge_pack`` (fixed shapes, device indices, a keep mask a row)
    writes what the host-indexed loop wrote, on random packs whose prompt
    count is padded with dummy entries (``len == 0``, slot 0, which a real
    entry may hold too): a dummy is an exact no-op, and rows past a
    prompt's length keep the slot's own contents."""
    rng = np.random.default_rng(seed)
    L, B, max_len, KVH, hd = 2, 4, 64, 2, 4
    bucket = int(rng.choice([16, 32, 64]))
    n_real = int(rng.integers(1, B + 1))
    nb = 1 << (n_real - 1).bit_length()
    lens = np.zeros(nb, np.int32)
    cuts = np.sort(rng.choice(np.arange(1, bucket), n_real - 1, replace=False)) \
        if n_real > 1 else np.array([], int)
    edges = np.concatenate([[0], cuts, [int(rng.integers(cuts[-1] + 1 if n_real > 1 else 1,
                                                         bucket + 1))]])
    lens[:n_real] = np.diff(edges)
    starts = np.zeros(nb, np.int32)
    starts[:n_real] = edges[:-1]
    slots = np.zeros(nb, np.int32)
    slots[:n_real] = rng.permutation(B)[:n_real]

    def tensors(shape_tail_int8, shape_tail_f32, gen):
        return {"k": torch.from_numpy(gen.integers(-128, 128, shape_tail_int8).astype(np.int8)),
                "v": torch.from_numpy(gen.integers(-128, 128, shape_tail_int8).astype(np.int8)),
                "k_scale": torch.from_numpy(gen.random(shape_tail_f32).astype(np.float32)),
                "v_scale": torch.from_numpy(gen.random(shape_tail_f32).astype(np.float32))}

    cache = tensors((L, B, max_len, KVH, hd), (L, B, max_len, KVH), rng)
    part = tensors((L, 1, bucket, KVH, hd), (L, 1, bucket, KVH), rng)
    want = {k: v.clone() for k, v in cache.items()}
    _loop_merge(want, part, starts, lens, slots)
    merge_pack(cache, part, torch.from_numpy(starts), torch.from_numpy(lens),
               torch.from_numpy(slots), min(max_len, bucket))
    for name in cache:
        assert torch.equal(cache[name], want[name]), name


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_warmup_builds_every_program_and_serving_retraces_nothing(olmoe, kind):
    """``warmup()`` builds the tick and every (bucket x prompt count)
    admission program under their reference keys, with ``retraces`` 0;
    serving mixed lengths through several admissions keeps it 0."""
    cfg, params = olmoe[kind]
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    eng.warmup()
    want = {eng._program_key("decode")} | {
        eng._program_key("packed_prefill", bucket=b, n=n)
        for b in eng._buckets for n in eng._nb_ladder}
    assert set(eng._programs) == want and len(want) == 1 + 2 * 3
    assert eng.metrics.counters.get("retraces", 0) == 0
    reqs = _serve(eng, _prompts(cfg, (3, 30, 9, 17, 5, 40, 2), seed=40))
    c = eng.metrics.counters
    assert c["completed"] == len(reqs) and c["prefill_batches"] >= 2
    assert c.get("retraces", 0) == 0


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_aot_warmup_on_and_off_serve_the_same_tokens(olmoe, kind):
    """The eager switch (``aot_warmup=False``: programs built on first
    use, counted as retraces, as the reference counts its lazy compiles)
    serves the same tokens and logits as the warmed engine."""
    cfg, params = olmoe[kind]
    prompts = _prompts(cfg, (6, 21, 2, 13, 30), seed=50)
    got = {}
    for on in (True, False):
        eng = ServeEngine(_aot(cfg, on), params, batch_slots=4, max_len=64, device="cpu",
                          keep_logits=True)
        eng.warmup()
        got[on] = (_serve(eng, prompts), eng.metrics.counters.get("retraces", 0))
    (warm, r_on), (cold, r_off) = got[True], got[False]
    assert r_on == 0 and r_off > 0
    for a, b in zip(warm, cold):
        assert a.generated == b.generated
        assert all(torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))


def test_admission_drops_dummy_entries_from_the_feed(olmoe):
    """Three prompts pad to four pack entries: the dummy (slot 0, length 0)
    neither touches the feed of slot 0 nor its cache rows; each prompt's
    first token lands in its slot's feed entry and its K/V rows in its
    slot, as a prefill of it alone computes them."""
    cfg, params = olmoe["int8"]
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    eng.warmup()
    prompts = _prompts(cfg, (5, 12, 7), seed=60)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=1) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    eng._rq.join()
    assert eng.metrics.counters["prefill_batches"] == 1
    for slot, (r, p) in enumerate(zip(reqs, prompts)):
        assert int(eng._tok[slot]) == r.generated[0]
        with torch.inference_mode():
            _, solo = eng.mod.prefill(params, cfg, torch.from_numpy(p[None]), max_len=len(p))
        for name, buf in eng.cache.items():
            assert torch.equal(buf[:, slot, :len(p)], solo[name][:, 0]), (slot, name)


def test_grouped_engine_programs(olmoe):
    """falcon-mamba's grouped path: the tick is the one program (its
    prefill per length stays eager), warmup leaves ``retraces`` 0, and
    serving with ``aot_warmup`` on and off gives the same tokens and
    logits. The tick writes the new state over the old
    (``decode_step(out=)``), bit for bit the functional step's."""
    cfg = smoke_config("falcon-mamba-7b")
    params = init_model_params(cfg, seed=1, device="cpu")
    prompts = _prompts(cfg, (5, 8, 5, 12, 8), seed=70)
    got = []
    for on in (True, False):
        eng = ServeEngine(_aot(cfg, on), params, batch_slots=4, max_len=64, device="cpu",
                          keep_logits=True)
        eng.warmup()
        assert set(eng._programs) == {eng._program_key("decode")}
        got.append(_serve(eng, prompts))
        assert eng.metrics.counters.get("retraces", 0) == 0
    for a, b in zip(*got):
        assert a.generated == b.generated
        assert all(torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))
    states = ssm_lm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    tok = torch.tensor([[3], [7]])
    for _ in range(2):
        logits, new = ssm_lm.decode_step(params, cfg, tok, states)
        before = {k: v.clone() for k, v in states.items()}
        logits2, same = ssm_lm.decode_step(params, cfg, tok, before, out=before)
        assert same is before and torch.equal(logits, logits2)
        assert all(torch.equal(new[k], before[k]) for k in new)
        states = new


def test_vision_programs_classify_as_before():
    """``VisionEngine`` (the int8 smoke M3ViT-S): one program a bucket
    under the reference's step key, built by ``warmup()`` (``retraces``
    0), serving the classes and probabilities of a direct ``classify``,
    the same with ``aot_warmup`` on and off."""
    from repro_torch.models import classify

    cfg = smoke_config("m3vit-small")
    params = init_model_params(cfg, seed=2, device="cpu")
    calib = [torch.from_numpy(synth_patches(cfg, 2, seed=s)) for s in (1, 2)]
    qcfg = quantized_config(cfg)
    params = ptq_model(qcfg, params, calibrate_model(cfg, params, calib), materialize="int8")
    reqs = {}
    for on in (True, False):
        eng = VisionEngine(_aot(qcfg, on), params, batch_buckets=(1, 4), max_wait_s=1.0,
                           top_k=3, device="cpu")
        eng.warmup()
        assert set(eng._programs) == {"classify|b=1", "classify|b=4"}
        reqs[on] = synth_requests(qcfg, 6, seed=3)
        for r in reqs[on]:
            eng.submit(r)
            eng.step()
        eng.flush()
        assert eng.metrics.counters["batches"] == 2  # 4, then 2 padded to 4
        assert eng.metrics.counters.get("retraces", 0) == 0
    for a, b in zip(reqs[True], reqs[False]):
        out = classify(params, qcfg, torch.from_numpy(a.patches)[None], top_k=3)
        np.testing.assert_array_equal(a.classes, out["classes"].numpy()[0])
        np.testing.assert_array_equal(a.classes, b.classes)
        np.testing.assert_array_equal(a.probs, b.probs)


def test_launch_count_bookkeeping_round_trips():
    """A captured program takes its capture's launches off the wrapper
    counters and adds them back a replay (``programs._add_counts``): by
    wrapper and by mode, with no zero entries left behind."""
    from repro_torch.kernels.int8_matmul import int8_matmul

    saved = int8_matmul.launches, dict(int8_matmul.launches_by_mode)
    try:
        before = programs.launch_counts()
        diff = {"int8_matmul": 3, "int8_matmul:mma": 2, "int8_matmul:stream": 1}
        programs._add_counts(diff)
        after = programs.launch_counts()
        assert {k: after[k] - before.get(k, 0) for k in diff} == diff
        programs._add_counts(diff, -1)
        assert programs.launch_counts() == before
    finally:
        int8_matmul.launches, int8_matmul.launches_by_mode = saved
    eager = programs.EagerProgram(lambda x: x + 1, torch.device("cpu"))
    out = eager(np.arange(3, dtype=np.int32))
    assert programs.own(eager, out) is out and out.tolist() == [1, 2, 3]
