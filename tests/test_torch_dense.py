"""The port's dense LM path against the JAX reference at smoke size, on the
CPU (the port's plain kernel versions): gemma2-2b's alternating
local/global layers and its sliding-window ring cache, llama3-8b and
gemma-7b, PTQ of the alternating tree, ``ServeEngine`` over the nested
cache, and the attention plain version at head dim 256.

gemma2 smoke: 4 layers (2 local/global pairs), d 64, 4 heads of 16 over 2
KV heads, local window 16, logit softcap 50, final softcap 30, sandwich
norms, tied embeddings. Weights are the reference's, carried over by the
bridge.

Tolerances: fp logits and f32 caches within atol 1e-5 (f32 sums in
another order); PTQ leaves as ``tests/test_torch_lm.py`` holds them;
quantized trees (int8 activations, int8 K/V, 4-bit attention) within atol
5e-3, one activation LSB flip at a rounding boundary, int8 K/V rows
within 1 LSB.
"""
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
from repro.kernels import ref as jref

from repro_torch import bridge
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.kernels import ref
from repro_torch.models import synth_batch, transformer, tree_bytes
from repro_torch.models.layers import attention_block
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.programs import EagerProgram

ARCH = "gemma2-2b"
W = 16  # the smoke config's local window


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
def g2():
    """JAX smoke gemma2: fp params, calibration on 2 batches of 2 x 24
    tokens (past the window), the int8 PTQ tree."""
    jcfg = jax_smoke_config(ARCH).replace(remat=False)
    tcfg = smoke_config(ARCH)
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    batches = [synth_batch(tcfg, 2, 24, seed=s) for s in (1, 2)]
    taps = jax_calibrate(jcfg, params, [{"tokens": jnp.asarray(b)} for b in batches])
    return {"jcfg": jcfg, "tcfg": tcfg, "mod": M.module_for(jcfg), "batches": batches,
            "decode": jax.jit(M.module_for(jcfg).decode_step, static_argnums=1),
            "taps": taps, "fp": _np_tree(params),
            "int8": _np_tree(jax_ptq(jcfg, params, taps, materialize="int8"))}


def _cfgs(g2, kind):
    if kind == "fp":
        return g2["jcfg"], g2["tcfg"]
    return jax_quantized_config(g2["jcfg"]), quantized_config(g2["tcfg"])


def _trees(g2, kind):
    return jax.tree.map(jnp.asarray, g2[kind]), bridge.params_from_numpy(g2[kind], "cpu")


def _atol(kind):
    return 1e-5 if kind == "fp" else 5e-3


def _close_cache(t_cache, j_cache, kind):
    t_flat, j_flat = _flat(t_cache), _flat(jax.tree.map(np.asarray, j_cache))
    assert sorted(t_flat) == sorted(j_flat)
    for name, j in j_flat.items():
        t, j = t_flat[name].float().numpy(), np.asarray(j, np.float32)
        assert t.shape == j.shape, name
        if name.endswith((".k", ".v")) and kind != "fp":
            assert np.abs(t - j).max() <= 1, name  # int8 rows: at most 1 LSB
        elif name.endswith("scale"):
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, atol=_atol(kind), rtol=0, err_msg=name)


def test_gemma2_tree_and_cache_layout(g2):
    """Two stacks of L/2 layers; the bridge carries both ways; the cache is
    {"local": a ring of min(max_len, window) rows, "global": max_len};
    ``cache_shapes`` matches the reference's on the meta device at full
    width, allocating nothing."""
    tp = bridge.params_from_numpy(g2["fp"], "cpu")
    assert "layers" not in tp and tp["layers_local"]["attn"]["wq"].shape[0] == 2
    assert tp["layers_global"]["post_ln2"]["scale"].shape == (2, 64)
    jax.tree.map(np.testing.assert_array_equal, bridge.params_to_numpy(tp), g2["fp"])
    assert tree_bytes(tp) == sum(a.nbytes for a in jax.tree.leaves(g2["fp"]))
    cache = transformer.init_cache(g2["tcfg"], 2, 40, device="cpu")
    assert cache["local"]["k"].shape == (2, 2, W, 2, 16)
    assert cache["global"]["k"].shape == (2, 2, 40, 2, 16)
    assert transformer.init_cache(g2["tcfg"], 1, 8, device="cpu")["local"]["v"].shape[2] == 8
    for arch in (ARCH, "llama3-8b"):
        cfg = get_config(arch)
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            M.module_for(cfg).cache_shapes(cfg, 8, 8192))
        got = transformer.cache_shapes(cfg, 8, 8192)
        assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                            got) == want


def test_gemma2_forward_matches_reference(g2):
    """21 tokens: the local layers' window masks."""
    jp, tp = _trees(g2, "fp")
    tokens = synth_batch(g2["tcfg"], 2, W + 5, seed=5)
    j_logits, _ = g2["mod"].forward(jp, g2["jcfg"], jnp.asarray(tokens))
    t_logits, _ = transformer.forward(tp, g2["tcfg"], torch.from_numpy(tokens))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("S,max_len", [(9, 12), (20, 20), (21, 32)],
                         ids=["short-ring", "ring-full", "ring-rolled"])
def test_gemma2_prefill_matches_reference(g2, kind, S, max_len):
    """Logits and both caches: a prompt shorter than the ring (rows from
    0), one filling it, and one past it, whose last W rows are rolled so
    that position p sits in slot p % W."""
    jcfg, tcfg = _cfgs(g2, kind)
    jp, tp = _trees(g2, kind)
    tokens = synth_batch(tcfg, 2, S, seed=6)
    j_logits, j_cache = g2["mod"].prefill(jp, jcfg, jnp.asarray(tokens), max_len=max_len)
    t_logits, t_cache = transformer.prefill(tp, tcfg, torch.from_numpy(tokens),
                                            max_len=max_len)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=_atol(kind),
                               rtol=0)
    _close_cache(t_cache, j_cache, kind)


def test_ring_prefill_rolls_positions_into_their_slots():
    """The roll alone: a prefill of S >= W rows leaves position p in slot
    p % W, rows past W dropped."""
    from repro_torch.models.layers import _ring_fill

    for S in (W, W + 1, W + 5, 3 * W + 7):
        buf = torch.full((1, W, 1, 1), -1.0)
        _ring_fill(buf, torch.arange(S, dtype=torch.float32).reshape(1, S, 1, 1))
        pos = buf.flatten().long()
        assert (pos % W == torch.arange(W)).all() and (pos >= S - W).all(), S


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_gemma2_decode_past_the_window_matches_reference(g2, kind):
    """The reference's ``test_gemma2_ring_cache_wraparound``: 4 prompt
    tokens, then decode to S = W + 9 at a scalar index; every step's logits
    against the reference's decode step, and (fp) against the teacher-forced
    forward; the caches at the end."""
    jcfg, tcfg = _cfgs(g2, kind)
    jp, tp = _trees(g2, kind)
    S = W + 9
    tok = synth_batch(tcfg, 1, S, seed=11)
    j_lg, j_cache = g2["mod"].prefill(jp, jcfg, jnp.asarray(tok[:, :4]), max_len=S)
    t_lg, t_cache = transformer.prefill(tp, tcfg, torch.from_numpy(tok[:, :4]), max_len=S)
    assert t_cache["local"]["k"].shape[2] == W
    full = transformer.forward(tp, tcfg, torch.from_numpy(tok))[0] if kind == "fp" else None
    for t in range(4, S):
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), atol=_atol(kind), rtol=0)
        if full is not None:
            np.testing.assert_allclose(t_lg[:, 0].numpy(), full[:, t - 1].numpy(),
                                       atol=1e-4, rtol=0)
        j_lg, j_cache = g2["decode"](jp, jcfg, jnp.asarray(tok[:, t:t + 1]), j_cache,
                                     jnp.asarray(t, jnp.int32))
        t_lg, t_cache = transformer.decode_step(tp, tcfg, torch.from_numpy(tok[:, t:t + 1]),
                                                t_cache, t)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), atol=_atol(kind), rtol=0)
    _close_cache(t_cache, j_cache, kind)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_gemma2_per_slot_decode_matches_reference(g2, kind):
    """A [B] index with slots at their own fills: slot 0 past the ring,
    slot 1 inside it, slot 2 wrapped twice over; four steps from one cache
    (the reference's prefill, handed to both: the prefill has its own test,
    and an int8 activation that rounds the other way there, a 1-LSB flip,
    would reach every later step through the cache)."""
    jcfg, tcfg = _cfgs(g2, kind)
    jp, tp = _trees(g2, kind)
    prompt = synth_batch(tcfg, 3, 20, seed=12)
    _, j_cache = g2["mod"].prefill(jp, jcfg, jnp.asarray(prompt), max_len=48)
    t_cache = bridge.params_from_numpy(jax.tree.map(np.asarray, j_cache), "cpu")
    index = np.asarray([20, 7, 37], np.int32)
    rng = np.random.default_rng(13)
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
        j_lg, j_cache = g2["decode"](jp, jcfg, jnp.asarray(tok), j_cache, jnp.asarray(index))
        t_lg, t_cache = transformer.decode_step(tp, tcfg, torch.from_numpy(tok), t_cache,
                                                torch.from_numpy(index))
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), atol=_atol(kind), rtol=0)
        index = index + 1
    _close_cache(t_cache, j_cache, kind)


def test_gemma2_calibration_taps_match_reference(g2):
    """The tap scopes Llocal{i:03d} / Lglobal{i:03d}, every site's stats."""
    tp = bridge.params_from_numpy(g2["fp"], "cpu")
    taps = calibrate_model(g2["tcfg"], tp, [torch.from_numpy(b) for b in g2["batches"]])
    ref_stats = g2["taps"].stats
    assert sorted(taps.stats) == sorted(ref_stats)
    assert any(s.startswith("Llocal001") for s in taps.stats)
    for site, st in ref_stats.items():
        for key in ("min", "max", "absmax"):
            np.testing.assert_allclose(taps.stats[site][key], st[key],
                                       rtol=1e-5, atol=1e-5, err_msg=site)


@pytest.mark.parametrize("materialize", ["fake", "int8"])
def test_gemma2_ptq_matches_reference_leaf_by_leaf(g2, materialize):
    """Same taps into both packages' PTQ: the Llocal/Lglobal groups' RMSNorm
    folds (sandwich norms stay fp), the activation scales, the stored int8
    leaves; the tied embedding stays f32 (the LM head is its transpose)."""
    jcfg = jax_quantized_config(g2["jcfg"])
    jp = jax.tree.map(jnp.asarray, g2["fp"])
    want = _flat(_np_tree(jax_ptq(jcfg, jp, g2["taps"], materialize=materialize)))
    taps = TapCollector()
    taps.stats = g2["taps"].stats
    got = _flat(bridge.params_to_numpy(ptq_model(
        quantized_config(g2["tcfg"]), bridge.params_from_numpy(g2["fp"], "cpu"), taps,
        materialize=materialize)))
    assert sorted(got) == sorted(want)
    for name, r in want.items():
        t = got[name]
        assert t.dtype == r.dtype and t.shape == r.shape, name
        if r.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
        elif name.endswith(("_scale", "_as")):
            np.testing.assert_allclose(t, r, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6, err_msg=name)
    if materialize == "int8":
        assert got["layers_local.attn.wq"].dtype == np.int8
        assert got["layers_global.mlp.wo"].dtype == np.int8
        assert got["embed"].dtype == np.float32


def test_ring_cache_refuses_a_packed_prefill(g2):
    tp = bridge.params_from_numpy(g2["fp"], "cpu")
    cfg, a = g2["tcfg"], g2["tcfg"].attn
    cache = transformer.layer(transformer.init_cache(cfg, 1, 32, device="cpu")["local"], 0)
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(NotImplementedError, match="ring"):
        attention_block(x, transformer.layer(tp["layers_local"], 0)["attn"], cfg, a,
                        positions=torch.arange(8), local_window=W, cache=cache,
                        cache_index=0, segment_ids=torch.zeros((1, 8), dtype=torch.int32))


def _engine(tcfg, tp, prompts, n_new, **kw):
    eng = ServeEngine(tcfg, tp, device="cpu", keep_logits=True, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_gemma2_engine_follows_the_teacher_forced_loop(g2, kind):
    """Grouped admission (no packed prefill over a ring); a request decodes
    across the ring (10 + 14 tokens > W); each emitted token is the argmax
    of ``prefill`` over its prefix and its logits match it (fp: the f32
    cache within 1e-4; int8: the engine's int8 cache against prefill's
    int8 cache, within 5e-3)."""
    _, tcfg = _cfgs(g2, kind)
    tp = bridge.params_from_numpy(g2[kind], "cpu")
    prompts = [synth_batch(tcfg, 1, n, seed=40 + n)[0] for n in (10, 5, 10, 7)]
    dtype = {"dtype": torch.float32} if kind == "fp" else {}
    init = transformer.init_cache
    transformer.init_cache = lambda *a, **k: init(*a, **{**k, **dtype})
    try:
        eng, reqs = _engine(tcfg, tp, prompts, 14, batch_slots=3, max_len=40)
    finally:
        transformer.init_cache = init
    assert not eng._packed and eng.cache["local"]["k"].shape[2] == W
    assert eng.metrics.counters["completed"] == 4
    for r in reqs:
        assert len(r.generated) == 14
        toks = list(map(int, r.prompt))
        for t, tok in enumerate(r.generated):
            lg = transformer.prefill(tp, tcfg, torch.tensor([toks]))[0][0, -1]
            np.testing.assert_allclose(r.step_logits[t].numpy(), lg.numpy(),
                                       atol=1e-4 if kind == "fp" else 5e-3, rtol=0)
            assert tok == int(torch.argmax(lg)), (r.uid, t)
            toks.append(tok)


def test_engine_tick_capture_restores_the_nested_cache(g2):
    """The tick's capture runs one decode step (its warm-up call): every
    leaf of the nested cache and the token feed are put back bit for bit.
    On the CPU the capture is stood in for by a program that runs the step
    once, as the capture's warm-up does."""
    tp = bridge.params_from_numpy(g2["fp"], "cpu")
    eng = ServeEngine(g2["tcfg"], tp, batch_slots=2, max_len=24, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for group in eng.cache.values():
        for t in group.values():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    eng._feed.copy_(torch.tensor([3, 5, 7], dtype=torch.int32))
    before = [t.clone() for t in (*_flat(eng.cache).values(), eng._feed)]
    moved = []

    def capture(fn, *example):
        prog = EagerProgram(fn, eng.device)
        prog(*example)
        moved.append(any(not torch.equal(a, b) for a, b in zip(_flat(eng.cache).values(),
                                                                 before)))
        return prog

    eng._graphs, eng._program = True, capture
    eng._build_tick()
    assert moved == [True]  # the warm-up step wrote the caches
    after = [*_flat(eng.cache).values(), eng._feed]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-7b"])
def test_dense_forward_and_decode_match_reference(arch):
    """Smoke llama3-8b (4 heads over 1 KV head, RoPE theta 5e5) and
    gemma-7b (GeGLU, tied embeddings, embed scale): forward, prefill and
    three per-slot decode steps within 1e-5."""
    jcfg = jax_smoke_config(arch).replace(remat=False)
    tcfg = smoke_config(arch)
    jmod = M.module_for(jcfg)
    params = _np_tree(M.init_model_params(jcfg, jax.random.PRNGKey(3)))
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.params_from_numpy(params, "cpu")
    tokens = synth_batch(tcfg, 2, 9, seed=14)
    j_logits, _ = jmod.forward(jp, jcfg, jnp.asarray(tokens))
    t_logits, _ = transformer.forward(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=0)
    _, j_cache = jmod.prefill(jp, jcfg, jnp.asarray(tokens), max_len=16)
    _, t_cache = transformer.prefill(tp, tcfg, torch.from_numpy(tokens), max_len=16)
    index = np.asarray([9, 6], np.int32)
    for step in range(3):
        tok = synth_batch(tcfg, 2, 1, seed=15 + step)
        j_lg, j_cache = jmod.decode_step(jp, jcfg, jnp.asarray(tok), j_cache,
                                         jnp.asarray(index))
        t_lg, t_cache = transformer.decode_step(tp, tcfg, torch.from_numpy(tok), t_cache,
                                                torch.from_numpy(index))
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), atol=1e-5, rtol=0)
        index = index + 1
    _close_cache(t_cache, j_cache, "fp")


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_attention_plain_version_at_head_dim_256(kv):
    """``ref.flash_attention_ref`` against ``repro.kernels.ref`` at gemma2's
    head (8 heads of 256 over 4 KV heads, softcap 50), a 24-key window over
    40 keys, 2-row queries at per-slot offsets, fill levels; int8 K/V with
    scales and 4-bit codes."""
    rng = np.random.default_rng(21)
    B, Sq, Sk, H, KVH, hd = 2, 2, 40, 8, 4, 256
    q = (rng.integers(-3, 4, (B, Sq, H, hd)) * 0.25).astype(np.float32)
    k = (rng.integers(-3, 4, (B, Sk, KVH, hd)) * 0.25).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, hd)).astype(np.float32)
    off, valid = np.asarray([30, 37], np.int32), np.asarray([32, 39], np.int32)
    kw = dict(causal=True, logit_softcap=50.0, local_window=24,
              quant_bits=4 if kv == "int8" else 0)
    ks = vs = None
    if kv == "int8":
        k = rng.integers(-127, 128, k.shape).astype(np.int8)
        v = rng.integers(-127, 128, v.shape).astype(np.int8)
        ks, vs = (rng.uniform(0.01, 0.05, (B, Sk, KVH)).astype(np.float32) for _ in "kv")
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kv == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jk, jv, q_offset=jnp.asarray(off), kv_valid_len=jnp.asarray(valid),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), **kw))
    got = ref.flash_attention_ref(
        torch.from_numpy(q), tk, tv, q_offset=torch.from_numpy(off),
        kv_valid_len=torch.from_numpy(valid),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs), **kw).numpy()
    assert got.shape == (B, Sq, H, hd) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
