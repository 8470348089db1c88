"""The port's kernel autotuner (``kernels/autotune.py``) on the CPU, against
the reference's ``repro.kernels.autotune`` where the two share a contract.

Oracles come from reference surfaces that pass: its key functions, and the
keys it collects around ``prefill``, ``decode_step`` (a ``[B]`` index),
``prefill_packed`` and ``classify`` traced with ``jax.eval_shape`` under
``REPRO_PALLAS=interpret`` (its engines' ``_tune_trace`` fails on the CPU,
a ``vmap`` axis-spec error in its decode trace). The port collects the same
keys by running its functions eagerly. The table, candidates, sweep,
threading into the kernels and the engines' warmup are held to the port's
own contract: the port tunes the grouped kernel's variant and
``lm_attention``'s schedule, not tiles. Smoke configs (a 2-layer OLMoE on
the grouped MoE path, M3ViT-S), seeded weights; every comparison is exact.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import smoke_config as jax_smoke_config
from repro.core.quant.ptq import quantized_config as jax_quantized_config
from repro.kernels import autotune as jat
from repro.serving.engine import serving_config as jax_serving_config

from repro_torch import bridge
from repro_torch.configs import AutotuneConfig, smoke_config
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.kernels import autotune, expert_linear, ops, quant_attention
from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models import init_model_params, module_for, synth_batch, synth_patches
from repro_torch.models.vit import PATCH_DIM
from repro_torch.serving import Request, ServeEngine, VisionEngine, serving_config
from repro_torch.serving.vision import synth_requests

LM, VIT = "olmoe-1b-7b", "m3vit-small"


@pytest.fixture(autouse=True)
def _no_active_table():
    """The active table is process-global: never leak one across tests."""
    autotune.deactivate()
    jat.deactivate()
    yield
    autotune.deactivate()
    jat.deactivate()


@pytest.fixture(scope="module")
def trees():
    """2-layer smoke OLMoE (grouped) fp, int8 and int4 trees and smoke
    M3ViT-S int8, the port's PTQ on 2 calibration batches each."""
    cfg = serving_config(smoke_config(LM)).replace(num_layers=2)
    params = init_model_params(cfg, seed=0, device="cpu")
    taps = calibrate_model(cfg, params, [torch.from_numpy(synth_batch(cfg, 2, 16, seed=s))
                                         for s in (1, 2)])
    qcfg = quantized_config(cfg)
    vcfg = smoke_config(VIT)
    vparams = init_model_params(vcfg, seed=0, device="cpu")
    vtaps = calibrate_model(vcfg, vparams, [torch.from_numpy(synth_patches(vcfg, 2, seed=s))
                                            for s in (1, 2)])
    vqcfg = quantized_config(vcfg)
    return {"fp": (cfg, params),
            "int8": (qcfg, ptq_model(qcfg, params, taps, materialize="int8")),
            "int4": (qcfg, ptq_model(qcfg, params, taps, materialize="int4")),
            "vit": (vqcfg, ptq_model(vqcfg, vparams, vtaps, materialize="int8"))}


def _jcfg(kind):
    if kind == "vit":
        return jax_quantized_config(jax_smoke_config(VIT))
    cfg = jax_serving_config(jax_smoke_config(LM)).replace(remat=False, num_layers=2)
    return cfg if kind == "fp" else jax_quantized_config(cfg)


def _abstract(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        bridge.params_to_numpy(tree))


def _port_keys(fn):
    with autotune.collecting() as reqs, torch.inference_mode():
        fn()
    return set(reqs)


def _ref_keys(monkeypatch, fn):
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    with jat.collecting() as reqs:
        fn()
    return set(reqs)


def _tuned(cfg, tmp_path, **kw):
    return cfg.replace(autotune=AutotuneConfig(enable=True, cache_dir=str(tmp_path), **kw))


# ---------------------------------------------------------------------------
# Keys: the reference's strings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 100, 512, 513, 5000])
def test_bucket_pow2_matches_reference(n):
    for lo in (1, 8):
        assert autotune.bucket_pow2(n, lo=lo) == jat.bucket_pow2(n, lo=lo)


@pytest.mark.parametrize("T,G,din,dout,xdt,wdt,ws,as_", [
    (64, 64, 2048, 2048, torch.int8, torch.int8, True, True),
    (3152, 16, 384, 1536, torch.int8, torch.int8, True, False),
    (37, 8, 64, 48, torch.int8, torch.uint8, True, True),  # packed int4
    (4096, 64, 2048, 1024, torch.float32, torch.float32, False, False),
    (5, 3, 24, 40, torch.float32, torch.float32, False, False),
])
def test_grouped_keys_match_reference(T, G, din, dout, xdt, wdt, ws, as_):
    jnp_dt = {torch.int8: jnp.int8, torch.uint8: jnp.uint8, torch.float32: jnp.float32}
    got = autotune.gmm_request(T, G, din, dout, x_dtype=xdt, w_dtype=wdt, scaled=ws,
                               ascaled=as_).key
    assert got == jat.gmm_request(T, G, din, dout, x_dtype=jnp_dt[xdt], w_dtype=jnp_dt[wdt],
                                  scaled=ws, ascaled=as_).key


@pytest.mark.parametrize("B,H,kvh,hd,sq,sk,causal,qb,ks,kdt,lw", [
    (8, 16, 16, 128, 1, 512, True, 4, True, torch.int8, 0),  # decode, int8 K/V
    (8, 8, 4, 256, 1, 512, True, 0, False, torch.bfloat16, 0),  # gemma2 decode
    (1, 16, 16, 128, 512, 512, True, 4, True, torch.int8, 0),  # packed prefill
    (2, 8, 4, 256, 100, 100, True, 0, False, torch.float32, 4096),  # window
    (8, 6, 6, 64, 197, 197, False, 4, False, torch.float32, 0),  # vision
])
def test_attention_keys_match_reference(B, H, kvh, hd, sq, sk, causal, qb, ks, kdt, lw):
    jnp_dt = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    got = autotune.attn_request(B, H, kvh, hd, sq, sk, causal=causal, quant_bits=qb,
                                scaled=ks, q_dtype=torch.float32, k_dtype=kdt,
                                local_window=lw).key
    assert got == jat.attn_request(B, H, kvh, hd, sq, sk, causal=causal, quant_bits=qb,
                                   scaled=ks, q_dtype=jnp.float32, k_dtype=jnp_dt[kdt],
                                   local_window=lw).key
    assert autotune.request_from_key(got).key == got


# ---------------------------------------------------------------------------
# Collected keys: the reference's, around the same functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_lm_collected_keys_match_reference(trees, monkeypatch, kind):
    """prefill [2, 9], decode_step [2, 1] at a [B] index over a 16-row
    cache, prefill_packed over a 32-token bucket: the same key set."""
    cfg, params = trees[kind]
    jcfg, jp, mod = _jcfg(kind), _abstract(params), module_for(cfg)
    jmod = M.module_for(jcfg)
    B, S, L, P = 2, 16, 9, 32
    i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)  # noqa: E731
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731

    def port():
        mod.prefill(params, cfg, z(B, L), max_len=S)
        mod.decode_step(params, cfg, z(B, 1), mod.init_cache(cfg, B, S, device="cpu"), z(B),
                        with_stats=True)
        mod.prefill_packed(params, cfg, z(1, P), z(P), z(P), z(2), max_len=P)

    def ref():
        jax.eval_shape(lambda p, t: jmod.prefill(p, jcfg, t, max_len=S), jp, i32(B, L))
        cache = jax.eval_shape(lambda: jmod.init_cache(jcfg, B, S))
        jax.eval_shape(lambda p, t, c, i: jmod.decode_step(p, jcfg, t, c, i, with_stats=True),
                       jp, i32(B, 1), cache, i32(B))
        jax.eval_shape(lambda p, t, pos, seg, li: jmod.prefill_packed(p, jcfg, t, pos, seg, li,
                                                                      max_len=P),
                       jp, i32(1, P), i32(P), i32(P), i32(2))

    got = _port_keys(port)
    assert got == _ref_keys(monkeypatch, ref)
    assert {k.split("|")[0] for k in got} == {"grouped_matmul", "streaming_attention"}


def test_vision_collected_keys_match_reference(trees, monkeypatch):
    from repro_torch.models.vit import classify

    cfg, params = trees["vit"]
    jcfg, jp = _jcfg("vit"), _abstract(params)
    for b in (1, 4, 8):
        got = _port_keys(lambda: classify(
            params, cfg, torch.zeros(b, cfg.image_tokens - 1, PATCH_DIM), top_k=5))
        want = _ref_keys(monkeypatch, lambda: jax.eval_shape(
            lambda p, x: M.classify(p, jcfg, x, top_k=5), jp,
            jax.ShapeDtypeStruct((b, cfg.image_tokens - 1, PATCH_DIM), jnp.float32)))
        assert got == want and got


def test_engine_tune_trace_is_the_union_of_its_programs(trees, monkeypatch):
    """A packed ServeEngine collects its decode tick's keys and every
    bucket's admission's; a VisionEngine every bucket's classify: the
    reference's keys around those functions at the engine's shapes."""
    cfg, params = trees["int8"]
    jcfg, jp = _jcfg("int8"), _abstract(params)
    jmod = M.module_for(jcfg)
    B, S = 2, 64
    eng = ServeEngine(cfg, params, batch_slots=B, max_len=S, device="cpu")
    i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)  # noqa: E731

    def ref():
        cache = jax.eval_shape(lambda: jmod.init_cache(jcfg, B, S))
        jax.eval_shape(lambda p, t, c, i: jmod.decode_step(p, jcfg, t, c, i, with_stats=True),
                       jp, i32(B, 1), cache, i32(B))
        for P in eng._buckets:
            for nb in eng._nb_ladder:
                jax.eval_shape(lambda p, t, pos, seg, li, P=P: jmod.prefill_packed(
                    p, jcfg, t, pos, seg, li, max_len=P), jp, i32(1, P), i32(P), i32(P),
                    i32(nb))

    assert _port_keys(eng._tune_trace) == _ref_keys(monkeypatch, ref)

    vcfg, vparams = trees["vit"]
    veng = VisionEngine(vcfg, vparams, batch_buckets=(1, 4), device="cpu")
    want = set()
    for b in (1, 4):
        want |= _ref_keys(monkeypatch, lambda: jax.eval_shape(
            lambda p, x: M.classify(p, _jcfg("vit"), x, top_k=5), _abstract(vparams),
            jax.ShapeDtypeStruct((b, vcfg.image_tokens - 1, PATCH_DIM), jnp.float32)))
    assert _port_keys(veng._tune_trace) == want


def test_expert_parallel_keys_carry_the_local_group_count(trees):
    """Under an EP mesh of 2 slots the grouped keys carry G = E / 2: the
    port folds a slot's padding rows into its last group. The reference
    appends a dump expert to every shard, so its keys carry E / 2 + 1; the
    two tables do not share EP entries."""
    cfg, params = trees["int8"]
    E = cfg.moe.num_experts
    ep_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, moe_exec="expert_parallel"))
    eng = ServeEngine(ep_cfg, params, batch_slots=2, max_len=32,
                      mesh=make_ep_mesh(2, devices=["cpu"] * 2))
    single = ServeEngine(cfg, params, batch_slots=2, max_len=32, device="cpu")
    got, one = _port_keys(eng._tune_trace), _port_keys(single._tune_trace)
    groups = {autotune.request_from_key(k).get("G") for k in got if k.startswith("grouped")}
    assert groups == {E // 2} and E // 2 + 1 not in groups
    assert {k for k in got if k.startswith("streaming")} == \
        {k for k in one if k.startswith("streaming")}


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,G,din,dout,integer", [
    (64, 64, 2048, 2048, True), (4096, 64, 2048, 1024, True), (64, 8, 40, 48, True),
    (64, 64, 2048, 2048, False), (4096, 64, 2048, 1024, False), (64, 8, 36, 48, False),
])
def test_grouped_candidates_are_the_rule_first_then_what_takes(T, G, din, dout, integer):
    dt = torch.int8 if integer else torch.float32
    req = autotune.gmm_request(T, G, din, dout, x_dtype=dt, w_dtype=dt, scaled=integer,
                               ascaled=integer)
    names = expert_linear.VARIANTS if integer else expert_linear.F32_VARIANTS
    ids = {n: v for v, n in names.items()}
    cands = autotune.gmm_candidates(req)
    pick = expert_linear.choose_variant(req.get("T"), G, din, dout, f32=not integer)
    assert cands[0] == names[pick] and len(set(cands)) == len(cands)
    assert all(expert_linear.takes(ids[c], din, dout, f32=not integer) for c in cands)
    if integer:
        assert set(cands) == {n for v, n in names.items()
                              if expert_linear.takes(v, din, dout)}
    else:  # fma sums in another order: only as the rule's pick
        assert ("fma" in cands) == (pick == 3) and (cands == ["fma"]) == (pick == 3)


@pytest.mark.parametrize("B,H,kvh,hd,sq,sk", [
    (8, 16, 16, 128, 1, 512), (8, 8, 4, 256, 1, 512), (8, 8, 4, 256, 1, 8192),
    (1, 16, 16, 128, 512, 512), (4, 32, 8, 128, 1, 512), (8, 32, 32, 112, 1, 512),
])
def test_attention_candidates_follow_choose_schedule(B, H, kvh, hd, sq, sk):
    req = autotune.attn_request(B, H, kvh, hd, sq, sk, causal=True, quant_bits=4,
                                scaled=True, q_dtype=torch.float32, k_dtype=torch.int8)
    decode = quant_attention.choose_schedule(sq, sk, H, kvh, hd) == 0
    assert autotune.attn_candidates(req) == (["decode", "tile"] if decode else ["tile"])


def test_vision_key_has_one_candidate_and_budget_caps():
    req = autotune.attn_request(8, 6, 6, 64, 197, 197, causal=False, quant_bits=4,
                                scaled=False, q_dtype=torch.float32, k_dtype=torch.float32)
    assert autotune.attn_candidates(req) == [autotune.VISION]
    gmm = autotune.gmm_request(4096, 16, 384, 1536, x_dtype=torch.int8, w_dtype=torch.int8,
                               scaled=True, ascaled=True)
    calls = []
    timer = lambda fn, c, reps=1: calls.append(c) or 1.0  # noqa: E731
    entry = _sweep(gmm, AutotuneConfig(budget=2), timer)
    assert calls == autotune.gmm_candidates(gmm)[:2] and len(entry["candidates"]) == 2


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------

_GMM = "grouped_matmul|T=64|G=8|din=64|dout=64|xdt=int8|wdt=int8|ws=1|as=1|pk=0"
_ATT = ("streaming_attention|B=8|H=8|kvh=4|hd=256|sq=1|sk=512|causal=1|lw=0|qb=0|ks=0"
        "|qdt=float32|kdt=bfloat16")


def test_table_round_trip_is_deterministic(tmp_path):
    path = str(tmp_path / "t.json")
    t = autotune.TuningTable("cpu", path)
    t.put(_GMM, "mma", 0.0197, "swept", {"stream": 0.0536, "mma": 0.0197, "dp4a": 0.1})
    t.put(_ATT, "decode", None, "default")
    t.save()
    raw = open(path).read()
    t2 = autotune.TuningTable.load(path, "cpu")
    assert t2.entries == t.entries
    assert t2.stats == {"hits": 0, "misses": 0, "swept": 0, "untakeable": 0}
    t2.save()
    assert open(path).read() == raw


def test_corrupt_cache_falls_back_to_empty(tmp_path):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        f.write("{this is not json")
    t = autotune.TuningTable.load(path, "cpu")
    assert t.entries == {}
    t.put(_GMM, "stream", None, "default")
    t.save()
    assert autotune.TuningTable.load(path, "cpu").entries


def test_stale_foreign_and_malformed_entries_are_dropped(tmp_path):
    path = str(tmp_path / "t.json")
    t = autotune.TuningTable("cpu", path)
    t.put(_GMM, "mma", 1.0, "swept")
    t.put(_ATT, "tile", 2.0, "swept")

    def write(raw):
        with open(path, "w") as f:
            json.dump(raw, f)
        return autotune.TuningTable.load(path, "cpu").entries

    raw = t.to_json()
    raw["kernel_versions"]["grouped_matmul"] -= 1
    assert set(write(raw)) == {_ATT}
    assert autotune.TuningTable.load(path, "NVIDIA-H100-80GB-HBM3").entries == {}
    raw = t.to_json()
    raw["table_version"] += 1
    assert write(raw) == {}
    for bad in ({"choice": "big-tiles"}, {"choice": "tile"}, {"blocks": [64, 128]}, "nope"):
        raw = json.loads(json.dumps(t.to_json()))
        raw["entries"][_GMM] = bad
        assert set(write(raw)) == {_ATT}


def test_the_reference_table_file_is_not_read(tmp_path):
    """Both packages call the CPU's kind ``cpu``; the port's file is
    ``autotune_torch_cpu.json`` and never the reference's."""
    cfg = AutotuneConfig(enable=True, cache_dir=str(tmp_path))
    jpath = jat.table_path(jat.AutotuneConfig(cache_dir=str(tmp_path)), "cpu")
    jt = jat.TuningTable("cpu", jpath)
    jt.put(_GMM, (64, 128), 1.0, "swept")
    jt.save()
    path = autotune.table_path(cfg, "cpu")
    assert os.path.basename(path) == "autotune_torch_cpu.json" and path != jpath
    assert autotune.ensure_tuned(cfg, None, device="cpu").entries == {}
    assert not os.path.exists(path)


def test_overrides_take_precedence_and_persist(tmp_path):
    cfg = AutotuneConfig(enable=True, cache_dir=str(tmp_path), overrides=((_GMM, "dp4a"),))
    t = autotune.TuningTable("cpu", autotune.table_path(cfg, "cpu"))
    t.put(_GMM, "mma", 0.01, "swept")
    t.save()
    table = autotune.ensure_tuned(cfg, None, device="cpu")
    assert table.get(_GMM) == {"choice": "dp4a", "ms": None, "source": "override",
                               "candidates": {}}
    reloaded = autotune.TuningTable.load(autotune.table_path(cfg, "cpu"), "cpu")
    assert reloaded.get(_GMM)["source"] == "override"
    autotune.deactivate()
    with pytest.raises(ValueError):
        autotune.ensure_tuned(dataclasses.replace(cfg, overrides=((_GMM, "decode"),)),
                              device="cpu")


def test_disabled_tuning_is_inert(tmp_path, trees):
    cfg = AutotuneConfig(enable=False, cache_dir=str(tmp_path))
    assert autotune.ensure_tuned(cfg, None) is None
    mcfg, params = trees["fp"]
    eng = ServeEngine(mcfg.replace(autotune=cfg), params, batch_slots=2, max_len=16,
                      device="cpu")
    eng.warmup()
    assert autotune.active_table() is None and not os.listdir(tmp_path)


def test_no_sweep_inside_a_capture(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="captured"):
        autotune.ensure_tuned(AutotuneConfig(enable=True, cache_dir=str(tmp_path)),
                              device="cuda")


# ---------------------------------------------------------------------------
# Sweep
# ---------------------------------------------------------------------------

def _sweep(req, cfg, timer, outputs=None, monkeypatch=None):
    """sweep_request with fake candidates: each returns ``outputs[choice]``
    (zeros by default); operands are not made."""
    mp = monkeypatch or pytest.MonkeyPatch()
    try:
        mp.setattr(autotune, "make_operands", lambda req, device: None)
        mp.setattr(autotune, "build_candidate", lambda req, c, operands: (
            lambda: (outputs or {}).get(c, torch.zeros(3))))
        return autotune.sweep_request(req, cfg, timer=timer, device="cpu")
    finally:
        if monkeypatch is None:
            mp.undo()


def test_sweep_picks_the_fastest_with_an_injected_timer(monkeypatch):
    req = autotune.gmm_request(4096, 64, 2048, 2048, x_dtype=torch.int8,
                               w_dtype=torch.int8, scaled=True, ascaled=True)
    cands = autotune.gmm_candidates(req)
    want = cands[2]
    timer = lambda fn, c, reps=1: 1.0 if c == want else 5.0  # noqa: E731
    entry = _sweep(req, AutotuneConfig(), timer, monkeypatch=monkeypatch)
    assert entry["choice"] == want and entry["ms"] == 1.0 and entry["source"] == "swept"
    assert entry["candidates"] == {c: (1.0 if c == want else 5.0) for c in cands}
    tie = _sweep(req, AutotuneConfig(), lambda fn, c, reps=1: 2.0, monkeypatch=monkeypatch)
    assert tie["choice"] == cands[0]  # a tie keeps the rule's pick


def test_sweep_without_a_card_gives_the_rule_pick():
    req = autotune.gmm_request(64, 64, 2048, 2048, x_dtype=torch.float32,
                               w_dtype=torch.float32, scaled=False, ascaled=False)
    e1 = autotune.sweep_request(req, AutotuneConfig(), device="cpu")
    assert e1 == autotune.sweep_request(req, AutotuneConfig(), device="cpu")
    assert e1 == {"choice": "stream", "ms": None, "source": "default", "candidates": {}}


def test_sweep_raises_on_a_candidate_that_differs_or_fails(monkeypatch):
    req = autotune.attn_request(8, 16, 16, 128, 1, 512, causal=True, quant_bits=4,
                                scaled=True, q_dtype=torch.float32, k_dtype=torch.int8)
    assert autotune.attn_candidates(req) == ["decode", "tile"]
    with pytest.raises(RuntimeError, match="kernel fault"):
        _sweep(req, AutotuneConfig(), lambda fn, c, reps=1: 1.0,
               {"decode": torch.zeros(3), "tile": torch.tensor([0.0, 0.0, 1e-7])},
               monkeypatch=monkeypatch)

    def fails(fn, c, reps=1):
        raise RuntimeError(f"lm_attention ({c}): CUDA error 1 at launch")

    with pytest.raises(RuntimeError, match="at launch"):
        _sweep(req, AutotuneConfig(), fails, monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# Threading into the kernels (``kernels/ops.py``)
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that ``ops`` takes for a CUDA one (its branch reads
    ``is_cuda``): the kernel entry is monkeypatched, nothing launches."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def test_the_tuned_variant_and_schedule_reach_the_kernels(monkeypatch):
    from repro_torch.kernels import ref

    seen = {}

    def gmm_spy(x, w, sizes, *, w_scale=None, a_scale=None, variant=None):
        seen["variant"] = variant
        return ref.grouped_matmul_q_ref(x, w, sizes, w_scale, a_scale)

    def attn_spy(q, k, v, *, schedule=None, segments=None, **kw):
        seen["schedule"] = schedule
        return ref.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(ops, "_gmm_kernel", gmm_spy)
    monkeypatch.setattr(ops, "lm_attention", attn_spy)
    g = torch.Generator().manual_seed(0)
    T, G, Din, Dout = 40, 8, 64, 48
    x = _card(torch.randint(-127, 128, (T, Din), generator=g, dtype=torch.int8))
    w = _card(torch.randint(-127, 128, (G, Din, Dout), generator=g, dtype=torch.int8))
    ws, sizes = torch.rand((G, Dout), generator=g), torch.full((G,), T // G, dtype=torch.int32)
    q = _card(torch.randn((2, 1, 2, 256), generator=g))
    kv = _card(torch.randn((2, 64, 1, 256), generator=g))
    gkey = autotune.gmm_request(T, G, Din, Dout, x_dtype=torch.int8, w_dtype=torch.int8,
                                scaled=True, ascaled=False).key
    akey = autotune.attn_request(2, 2, 1, 256, 1, 64, causal=True, quant_bits=0,
                                 scaled=False, q_dtype=torch.float32,
                                 k_dtype=torch.float32).key

    def call():
        ops.grouped_matmul(x, w, sizes, w_scale=ws)
        ops.attention(q, kv, kv, causal=True, q_offset=63)
        return seen["variant"], seen["schedule"]

    assert call() == (None, None)  # no table: the kernels' rules pick
    table = autotune.TuningTable("cpu")
    autotune.activate(table)
    assert call() == (None, None) and table.stats["misses"] == 2
    for variant, name in expert_linear.VARIANTS.items():
        for schedule, sname in quant_attention.SCHEDULES.items():
            table.put(gkey, name, None, "override")
            table.put(akey, sname, None, "override")
            assert call() == (variant, schedule)
    assert table.stats["untakeable"] == 0
    # a pick the operands cannot take: the rule's pick, counted
    table.put(gkey, "fma", None, "override")
    assert call()[0] is None and table.stats["untakeable"] == 1
    wide = _card(torch.randint(-127, 128, (T, 40), generator=g, dtype=torch.int8))
    wkey = autotune.gmm_request(T, G, 40, Dout, x_dtype=torch.int8, w_dtype=torch.int8,
                                scaled=True, ascaled=False).key
    table.put(wkey, "mma", None, "override")  # Din % 16 != 0: only dp4a takes it
    ops.grouped_matmul(wide, _card(torch.zeros((G, 40, Dout), dtype=torch.int8)), sizes,
                       w_scale=ws)
    assert seen["variant"] is None and table.stats["untakeable"] == 2


# ---------------------------------------------------------------------------
# Warmup: collect, fill, cache hits; the same answers
# ---------------------------------------------------------------------------

def _serve(eng, prompts, n_new=4):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.generated for r in reqs]


def test_warmup_tunes_then_every_later_warmup_is_a_cache_hit(tmp_path, trees):
    cfg, params = trees["int8"]
    tcfg = _tuned(cfg, tmp_path)
    prompts = [synth_batch(cfg, 1, n, seed=20 + n)[0] for n in (5, 9, 14)]
    want = _serve(_warmed(ServeEngine(cfg, params, batch_slots=2, max_len=32,
                                      device="cpu")), prompts)
    assert autotune.active_table() is None

    eng = ServeEngine(tcfg, params, batch_slots=2, max_len=32, device="cpu")
    eng.warmup()
    table = autotune.active_table()
    swept = table.stats["swept"]
    assert swept == len(table.entries) > 0
    assert {k.split("|")[0] for k in table.entries} == {"grouped_matmul", "streaming_attention"}
    assert all(e["source"] == "default" and e["ms"] is None for e in table.entries.values())
    assert os.path.exists(autotune.table_path(tcfg.autotune, "cpu"))
    eng.warmup()
    eng2 = ServeEngine(tcfg, params, batch_slots=2, max_len=32, device="cpu")
    eng2.warmup()
    assert table.stats["swept"] == swept
    assert _serve(eng2, prompts) == want
    assert table.stats["misses"] == 0 and table.stats["untakeable"] == 0

    autotune.deactivate()  # a new process: the table from disk
    ServeEngine(tcfg, params, batch_slots=2, max_len=32, device="cpu").warmup()
    t2 = autotune.active_table()
    assert t2 is not table and t2.stats["swept"] == 0 and t2.entries == table.entries
    print(autotune.summary())


def _warmed(eng):
    eng.warmup()
    return eng


def test_grouped_path_covers_every_served_prefill(tmp_path, trees):
    """Without packed prefill the engine prefills each group of same-length
    prompts eagerly while serving; the warmup's ladder of (count, length)
    buckets covers them all: no lookup misses."""
    cfg, params = trees["fp"]
    gcfg = _tuned(cfg, tmp_path).replace(
        serve=dataclasses.replace(cfg.serve, packed_prefill=False))
    eng = _warmed(ServeEngine(gcfg, params, batch_slots=4, max_len=32, device="cpu"))
    table = autotune.active_table()
    prompts = [synth_batch(cfg, 1, n, seed=n)[0] for n in (1, 3, 3, 7, 12, 12, 12, 30)]
    tokens = _serve(eng, prompts, n_new=1)
    assert table.stats["misses"] == 0 and table.stats["hits"] > 0
    autotune.deactivate()
    plain = cfg.replace(serve=gcfg.serve)
    assert _serve(_warmed(ServeEngine(plain, params, batch_slots=4, max_len=32,
                                      device="cpu")), prompts, n_new=1) == tokens


def test_warmup_survives_a_corrupt_cache_file(tmp_path, trees):
    cfg, params = trees["fp"]
    tcfg = _tuned(cfg, tmp_path)
    path = autotune.table_path(tcfg.autotune, "cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("]]corrupt[[")
    ServeEngine(tcfg, params, batch_slots=2, max_len=16, device="cpu").warmup()
    assert autotune.active_table().stats["swept"] > 0
    assert autotune.TuningTable.load(path, "cpu").entries


def test_tuned_vision_engine_classifies_as_the_untuned_one(tmp_path, trees):
    cfg, params = trees["vit"]
    reqs = {}
    for label, c in (("plain", cfg), ("tuned", _tuned(cfg, tmp_path)),
                     ("again", _tuned(cfg, tmp_path))):
        eng = _warmed(VisionEngine(c, params, batch_buckets=(1, 4), device="cpu"))
        reqs[label] = synth_requests(cfg, 5, seed=3)
        for r in reqs[label]:
            eng.submit(r)
        eng.flush()
    table = autotune.active_table()
    assert table.stats["swept"] == len(table.entries) > 0
    assert table.stats["misses"] == 0
    for label in ("tuned", "again"):
        for a, b in zip(reqs["plain"], reqs[label]):
            assert np.array_equal(a.classes, b.classes) and np.array_equal(a.probs, b.probs)


def test_launcher_prints_the_summary(tmp_path, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", LM, "--smoke", "--device", "cpu", "--requests", "2",
                "--new-tokens", "2", "--max-len", "64", "--autotune",
                "--autotune-cache", str(tmp_path)])
    out = capsys.readouterr().out
    assert "autotune[cpu]: " in out and "swept_now=" in out
    assert os.path.exists(tmp_path / "autotune_torch_cpu.json")
