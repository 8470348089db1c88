"""The port's Mamba-1 path (selective scan, causal conv, the Mamba block,
the falcon-mamba LM, its PTQ and the grouped ``ServeEngine`` admission)
against the JAX reference at smoke size, on the CPU (the scan's plain
version).

The reference runs with ``REPRO_PALLAS=ref`` (its chunked associative scan)
and, where it reaches the Pallas kernel, also with ``REPRO_PALLAS=interpret``.
Weights are the reference's, carried over by the bridge.

Tolerances:
  * the scan: y and h_last within atol 1e-5, rtol 1e-5 of both reference
    forms. Against the Pallas kernel only the order of the N-term sum in y
    differs; the associative scan also forms the decay products in another
    order. A run padded with dt = 0 steps gives the same h_last exactly
    (exp(0) = 1 and a zero input are exact no-ops);
  * causal_conv1d: exact (the same multiply-adds in the same order);
  * the block, the LM and the engine's logits: atol 1e-4 (f32 sums in
    another order through 4 layers); the transformer on the grouped path
    keeps its K/V in bf16, as the reference's engine does: its decode
    ticks within atol 5e-3;
  * at full depth (64 layers, d_model 128), the decode loop no farther
    from the f64 forward than the f32 forward is, within a factor 1.5;
  * PTQ leaves: scales rtol 1e-6; folded and fake-quantized fp leaves
    rtol 1e-5, atol 1e-6 (s_tilde is a mean whose reduction order differs).
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
from repro.kernels import ops as jax_ops
from repro.kernels.selective_scan import selective_scan as jax_scan_kernel
from repro.models import ssm as jax_ssm

from repro_torch import bridge
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.ptq import calibrate_model, ptq_model
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels.ref import selective_scan_ref
from repro_torch.kernels.selective_scan import selective_scan as scan_kernel
from repro_torch.models import init_model_params, module_for, ssm_lm, synth_batch
from repro_torch.models.ssm import causal_conv1d, mamba1_block
from repro_torch.models.transformer import layer
from repro_torch.serving import Request, ServeEngine

ARCH = "falcon-mamba-7b"
jmod = M.module_for(jax_smoke_config(ARCH))
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
LM_TOL = dict(atol=1e-4, rtol=0)


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
def ssm():
    """JAX smoke falcon-mamba: fp params and calibration taps on 2 batches
    of 2 x 16 tokens."""
    jcfg = jax_smoke_config(ARCH).replace(remat=False)
    tcfg = smoke_config(ARCH)
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    batches = [synth_batch(tcfg, 2, 16, seed=s) for s in (1, 2)]
    taps = jax_calibrate(jcfg, params, [{"tokens": jnp.asarray(b)} for b in batches])
    return {"jcfg": jcfg, "tcfg": tcfg, "batches": batches, "taps": taps,
            "fp": _np_tree(params)}


def _trees(ssm, kind="fp"):
    return (jax.tree.map(jnp.asarray, ssm[kind]),
            bridge.params_from_numpy(ssm[kind], "cpu"))


def _scan_inputs(rng, B, S, di, N):
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, di))) * 0.1).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    a = -np.abs(rng.standard_normal((di, N))).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    return x, dt, b, c, a, d


# ---------------------------------------------------------------------------
# (a, b) the selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,di,N,bs,bd,dtype", [
    (2, 64, 32, 8, 16, 16, "float32"),
    (1, 100, 64, 16, 32, 32, "float32"),  # ragged S (the Pallas kernel pads it)
    (2, 17, 16, 4, 8, 16, "float32"),
    (2, 40, 32, 12, 16, 16, "float32"),  # a state size off the powers of two
    (1, 24, 16, 32, 8, 16, "float32"),
    (2, 33, 32, 16, 16, 16, "bfloat16"),  # bf16 x, dt, B, C; y in bf16
    (1, 20, 16, 12, 8, 16, "bfloat16"),
])
def test_scan_matches_pallas_kernel_and_reference_ops(monkeypatch, B, S, di, N, bs, bd,
                                                      dtype):
    """f32: y and h_last within SCAN_TOL of both reference forms. bf16
    operands: against the Pallas kernel, which widens them to f32 first as
    the port does (the reference's associative-scan ops form rounds dt x to
    bf16 before widening, ``repro/kernels/ref.py:199``, and so computes
    another function); h_last (f32) within SCAN_TOL, y each side's f32 y
    rounded once to bf16, so within one bf16 step (rtol 2^-7)."""
    rng = np.random.default_rng(S)
    args = _scan_inputs(rng, B, S, di, N)
    wide = [torch.from_numpy(a) for a in args]
    targs = [t.to(getattr(torch, dtype)) if i < 4 else t for i, t in enumerate(wide)]
    y, h = ops.selective_scan(*targs)
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    assert y.dtype == targs[0].dtype and h.dtype == torch.float32
    jargs = [jnp.asarray(t.float().numpy()).astype(dtype) if i < 4 else jnp.asarray(a)
             for i, (t, a) in enumerate(zip(targs, args))]
    ky, kh = jax_scan_kernel(*jargs, block_s=bs, block_d=bd, interpret=True)
    monkeypatch.setenv("REPRO_PALLAS", "ref")
    ry, rh = jax_ops.selective_scan(*jargs)
    y_tol = SCAN_TOL if dtype == "float32" else dict(atol=1e-5, rtol=2.0**-7)
    for want_y, want_h in ((ky, kh), (ry, rh))[:2 if dtype == "float32" else 1]:
        assert want_y.dtype == dtype
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **y_tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("di", [256, 8192])
@pytest.mark.parametrize("N", [1, 4, 8, 12, 16, 32, 64, 200])
def test_scan_layout_fills_the_card_and_covers_every_state_once(B, di, N):
    """The states variant's grid (csrc/selective_scan.cu): blocks of
    SCAN_THREADS threads over (128 / lanes channels, batch row), thread t
    holding channel t // lanes, states (t % lanes) spt + k. Every (b, d, n)
    with d < di and n < N is held by exactly one thread (the padded states
    by threads of live channels only), lanes a channel are a power of two
    within one warp, and the layout is, of those that give a busy SM at
    least LATENCY_WARPS_PER_STATE x states-a-thread warps, the one with
    the least wave-quantized work an SM (ties: the widest), or the one with
    the most threads when none qualifies."""
    spt, lanes = ss.scan_layout(B, di, N)
    assert spt in ss.STATES_PER_THREAD and lanes & (lanes - 1) == 0
    assert lanes <= ss.MAX_LANES
    ch = ss.SCAN_THREADS // lanes
    t = np.arange(ss.SCAN_THREADS)
    blocks = -(-di // ch)
    d = (np.arange(blocks)[:, None] * ch + t[None, :] // lanes).reshape(-1)
    n = ((t % lanes)[:, None] * spt + np.arange(spt)[None, :])  # [threads, spt]
    d_all = np.repeat(d, spt)
    n_all = np.tile(n.reshape(-1), blocks)
    live = (d_all < di) & (n_all < N)
    flat = d_all[live] * N + n_all[live]
    counts = np.bincount(flat, minlength=di * N)
    assert counts.min() == counts.max() == 1  # one batch row; every row alike
    padded = spt * lanes
    assert padded == max(4, 1 << (N - 1).bit_length())
    options = {s: padded // s for s in ss.STATES_PER_THREAD
               if s <= padded and padded // s <= ss.MAX_LANES}

    def per_sm(s):  # blocks of SCAN_THREADS an SM takes, in whole waves
        return -(-B * -(-di // (ss.SCAN_THREADS // options[s])) // ss.H100_SMS)

    ok = [s for s in options
          if per_sm(s) * ss.SCAN_THREADS / 32 >= ss.LATENCY_WARPS_PER_STATE * s]
    if ok:
        least = min(per_sm(s) * s for s in ok)
        assert spt == max(s for s in ok if per_sm(s) * s == least)
    else:  # none hides the latency: the most threads
        assert lanes == max(options.values())


@pytest.mark.parametrize("N", [1, 4, 5, 8, 16, 17, 32, 64, 128, 200, 256, 512])
def test_scan_layouts_cover_the_padded_state_exactly(N):
    """scan_layouts(N) lists every (states a thread, lanes a channel) of the
    states variant whose product is N padded to a power of two >= 4, lanes
    within one warp, widest states a thread first; scan_layout picks one
    of them at every B and d_inner."""
    padded = max(4, 1 << (N - 1).bit_length())
    layouts = ss.scan_layouts(N)
    assert layouts and all(s * n == padded and n <= ss.MAX_LANES for s, n in layouts)
    assert [s for s, _ in layouts] == sorted((s for s, _ in layouts), reverse=True)
    assert {s for s, _ in layouts} == {s for s in ss.STATES_PER_THREAD
                                      if s <= padded and padded // s <= ss.MAX_LANES}
    for B in range(1, 9):
        for di in (256, 8192):
            assert ss.scan_layout(B, di, N) in layouts


def test_scan_layout_at_the_falcon_mamba_prefill_groups():
    """At d_inner 8192, state 16 a grouped admission of 1-8 prompts takes
    each of the three layouts: 4 states a thread for one prompt, 8 for B
    2-5 and 7, 16 for B 6 and 8, the fastest of the three at every B in
    chip_smoke.py's layout sweep (which checks each at B 1, 4 and 8)."""
    picks = {B: ss.scan_layout(B, 8192, 16) for B in range(1, 9)}
    assert picks[1] == (4, 4)
    assert {picks[B] for B in (2, 3, 4, 5, 7)} == {(8, 2)}
    assert {picks[B] for B in (6, 8)} == {(16, 1)}
    assert ss.scan_layout(8, 8192, 32) == (16, 2)  # chip_smoke.py's SCAN_WIDE


def test_scan_wrapper_refuses_a_layout_that_does_not_cover_the_state():
    """A forced layout must be one of scan_layouts(N), on the states
    variant; the check comes before the device check."""
    def args(N, di=8, S=4):
        return [torch.zeros((1, S, di)), torch.zeros((1, S, di)), torch.zeros((1, S, N)),
                torch.zeros((1, S, N)), torch.zeros((di, N)), torch.zeros(di)]

    for N, layout in ((16, (4, 2)), (16, (3, 5)), (4, (8, 1)), (512, (8, 64))):
        with pytest.raises(ValueError, match="layout"):
            scan_kernel(*args(N), layout=layout)
    with pytest.raises(ValueError, match="layout"):
        scan_kernel(*args(16), variant=2, layout=(16, 1))
    for layout in ss.scan_layouts(16):
        with pytest.raises(ValueError, match="CUDA"):
            scan_kernel(*args(16), layout=layout)
    assert scan_kernel.launches == 0


def test_scan_wrapper_takes_any_state_size_and_bf16():
    """The wrapper's contract checks pass every N up to MAX_STATE and bf16
    operands, and stop only at the device (CPU tensors never reach a
    kernel); mixed operand types and N past MAX_STATE are refused first."""
    def args(N, dtype, di=8, S=4):
        xs = [torch.zeros((1, S, di), dtype=dtype), torch.zeros((1, S, di), dtype=dtype),
              torch.zeros((1, S, N), dtype=dtype), torch.zeros((1, S, N), dtype=dtype)]
        return xs + [torch.zeros((di, N)), torch.zeros(di)]

    for N, dtype in ((3, torch.float32), (12, torch.bfloat16), (64, torch.float32),
                     (ss.MAX_STATE, torch.bfloat16)):
        with pytest.raises(ValueError, match="CUDA"):
            scan_kernel(*args(N, dtype))
    with pytest.raises(ValueError, match="state size"):
        scan_kernel(*args(ss.MAX_STATE + 1, torch.float32))
    mixed = args(16, torch.float32)
    mixed[2] = mixed[2].bfloat16()
    with pytest.raises(TypeError):
        scan_kernel(*mixed)
    with pytest.raises(ValueError, match="lane variant"):
        scan_kernel(*args(12, torch.float32), variant=2)
    assert scan_kernel.launches == 0


def test_scan_padded_with_zero_dt_steps_keeps_h_last_exactly():
    rng = np.random.default_rng(3)
    x, dt, b, c, a, d = map(torch.from_numpy, _scan_inputs(rng, 2, 37, 24, 16))
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :27])], 1)  # noqa: E731
    xr = torch.from_numpy(rng.standard_normal((2, 27, 24)).astype(np.float32))
    y, h = selective_scan_ref(x, dt, b, c, a, d)
    yp, hp = selective_scan_ref(torch.cat([x, xr], 1), pad(dt), pad(b), pad(c), a, d)
    assert torch.equal(hp, h)
    assert torch.equal(yp[:, :37], y)


def test_scan_state_is_the_last_step_of_the_recurrence():
    """h_last continues the sequence: scanning the two halves with the
    second started from the first's state gives the whole scan's state."""
    rng = np.random.default_rng(4)
    x, dt, b, c, a, d = map(torch.from_numpy, _scan_inputs(rng, 1, 12, 8, 4))
    _, h = selective_scan_ref(x, dt, b, c, a, d)
    _, h1 = selective_scan_ref(x[:, :7], dt[:, :7], b[:, :7], c[:, :7], a, d)
    hh = h1
    for t in range(7, 12):
        hh = torch.exp(dt[:, t, :, None] * a) * hh + (dt[:, t] * x[:, t])[:, :, None] \
            * b[:, t, None, :]
    assert torch.equal(hh, h)


def test_scan_kernel_wrapper_takes_cuda_tensors_only():
    args = [torch.zeros(s) for s in ((1, 4, 8), (1, 4, 8), (1, 4, 16), (1, 4, 16),
                                     (8, 16), (8,))]
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel(*args)
    assert scan_kernel.launches == 0


# ---------------------------------------------------------------------------
# (c, d) causal conv and the Mamba-1 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv1d_is_exact(with_history):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    hist = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_history else None
    jy, js = jax_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   None if hist is None else jnp.asarray(hist))
    ty, ts = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                           None if hist is None else torch.from_numpy(hist))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_mamba1_block_prefill_and_decode_match_reference(ssm, monkeypatch, mode):
    monkeypatch.setenv("REPRO_PALLAS", mode)
    jp, tp = _trees(ssm)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["mamba"])
    tl = layer(tp["layers"], 1)["mamba"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    j_out, j_st = jax_ssm.mamba1_block(jnp.asarray(x), jl, ssm["jcfg"])
    t_out, t_st = mamba1_block(torch.from_numpy(x), tl, ssm["tcfg"])
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LM_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]), **LM_TOL)
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    j_out, j_st = jax_ssm.mamba1_block(jnp.asarray(x1), jl, ssm["jcfg"], state=j_st)
    t_out, t_st = mamba1_block(torch.from_numpy(x1), tl, ssm["tcfg"], state=t_st)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LM_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]), **LM_TOL)


# ---------------------------------------------------------------------------
# (e) the LM: forward, prefill, decode, cache layout, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_forward_matches_reference(ssm, monkeypatch, mode):
    monkeypatch.setenv("REPRO_PALLAS", mode)
    jp, tp = _trees(ssm)
    tokens = synth_batch(ssm["tcfg"], 2, 13, seed=5)
    j_logits, _ = jmod.forward(jp, ssm["jcfg"], jnp.asarray(tokens))
    t_logits, t_aux = ssm_lm.forward(tp, ssm["tcfg"], torch.from_numpy(tokens))
    assert t_logits.shape == (2, 13, ssm["tcfg"].vocab_size) and float(t_aux) == 0.0
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **LM_TOL)


def test_prefill_and_decode_steps_match_reference(ssm):
    jp, tp = _trees(ssm)
    tokens = synth_batch(ssm["tcfg"], 2, 9, seed=6)
    j_logits, j_st = jmod.prefill(jp, ssm["jcfg"], jnp.asarray(tokens), max_len=32)
    t_logits, t_st = ssm_lm.prefill(tp, ssm["tcfg"], torch.from_numpy(tokens), max_len=32)
    assert t_logits.shape == (2, 1, ssm["tcfg"].vocab_size)
    for step in range(4):
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **LM_TOL)
        assert sorted(t_st) == sorted(j_st)
        for k, j in j_st.items():
            assert t_st[k].shape == j.shape, k
            np.testing.assert_allclose(t_st[k].float().numpy(), np.asarray(j, np.float32),
                                       err_msg=f"{k} step {step}", **LM_TOL)
        nxt = synth_batch(ssm["tcfg"], 2, 1, seed=70 + step)
        h_before = t_st["h"].clone()
        j_logits, j_st = jmod.decode_step(jp, ssm["jcfg"], jnp.asarray(nxt), j_st, index=9)
        t_logits, t_new = ssm_lm.decode_step(tp, ssm["tcfg"], torch.from_numpy(nxt), t_st,
                                             index=9)
        assert torch.equal(t_st["h"], h_before)  # the states given are left as they were
        t_st = t_new


def _f64(tree):
    return {k: _f64(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.double()


def test_deep_decode_is_as_accurate_as_forward(capsys):
    """falcon-mamba at its full depth (64 layers) and d_model 128, seeded
    random weights: the greedy prefill + decode_step logits are no farther
    from the f64 forward than the f32 forward is (factor 1.5). Both read
    ~3e-4 relative (max |difference| / max |logit|): 64 random layers
    amplify f32 rounding ~1e3-1e4-fold, which is why the card's
    teacher-forced gate (``chip_smoke.py``, phase 8) sits at ~1e-3, not at
    f32's 1e-7."""
    cfg = get_config(ARCH).replace(d_model=128, vocab_size=1024)
    params = init_model_params(cfg, 0, "cpu")
    P, n_new = 24, 16
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, (1, P)).astype(np.int32))
    with torch.no_grad():
        logits, st = ssm_lm.prefill(params, cfg, prompt)
        steps, toks = [logits[0, -1]], [int(logits[0, -1].argmax())]
        for _ in range(n_new - 1):
            logits, st = ssm_lm.decode_step(params, cfg, torch.tensor([[toks[-1]]]), st)
            steps.append(logits[0, -1])
            toks.append(int(logits[0, -1].argmax()))
        seq = torch.cat([prompt, torch.tensor([toks[:-1]], dtype=torch.int32)], 1)
        f32 = ssm_lm.forward(params, cfg, seq)[0][0, P - 1:].double()
        f64 = ssm_lm.forward(_f64(params), cfg, seq)[0][0, P - 1:]
    scale = f64.abs().amax(-1)
    decode = ((torch.stack(steps).double() - f64).abs().amax(-1) / scale).numpy()
    forward = ((f32 - f64).abs().amax(-1) / scale).numpy()
    with capsys.disabled():
        print(f"\n64 layers, d_model 128, {n_new} steps, relative to the f64 forward: "
              f"decode max {decode.max():.3g} median {np.median(decode):.3g}; f32 "
              f"forward max {forward.max():.3g} median {np.median(forward):.3g}")
    assert decode.max() <= 1.5 * forward.max()
    assert np.median(decode) <= 1.5 * np.median(forward)


def test_init_cache_layout_matches_reference(ssm):
    j = jmod.init_cache(ssm["jcfg"], 3, 16)
    t = ssm_lm.init_cache(ssm["tcfg"], 3, 16, device="cpu")
    assert sorted(t) == sorted(j)
    for k, v in j.items():
        assert tuple(t[k].shape) == v.shape, k
        assert str(t[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert not t[k].any()


def test_seeded_init_matches_reference_tree_and_bridge_carries_it(ssm):
    cfg = ssm["tcfg"]
    a, b = init_model_params(cfg, 3, "cpu"), init_model_params(cfg, 3, "cpu")
    fa, fb = _flat(bridge.params_to_numpy(a)), _flat(bridge.params_to_numpy(b))
    ref = _flat(ssm["fp"])
    assert sorted(fa) == sorted(ref)
    assert "lm_head" not in fa  # tied embeddings
    for name, r in ref.items():
        np.testing.assert_array_equal(fa[name], fb[name])
        assert fa[name].shape == r.shape and fa[name].dtype == r.dtype, name
    tp = bridge.params_from_numpy(ssm["fp"], "cpu")
    for key in ("A_log", "D", "dt_bias", "conv_w", "conv_b", "in_proj", "x_proj",
                "dt_proj", "out_proj"):
        leaf = tp["layers"]["mamba"][key]
        assert leaf.shape[0] == cfg.num_layers and leaf.dtype == torch.float32, key
    jax.tree.map(np.testing.assert_array_equal, bridge.params_to_numpy(tp), ssm["fp"])
    assert module_for(cfg) is ssm_lm


# ---------------------------------------------------------------------------
# (f) PTQ of the ssm family
# ---------------------------------------------------------------------------

def test_calibration_taps_match_reference(ssm):
    tp = bridge.params_from_numpy(ssm["fp"], "cpu")
    taps = calibrate_model(ssm["tcfg"], tp, [torch.from_numpy(b) for b in ssm["batches"]])
    ref = ssm["taps"].stats
    assert sorted(taps.stats) == sorted(ref)
    assert "L000.post_ln1" in ref and "final_norm" in ref
    for site, st in ref.items():
        for key in ("min", "max", "absmax"):
            np.testing.assert_allclose(taps.stats[site][key], st[key],
                                       rtol=1e-5, atol=1e-5, err_msg=site)


def _port_taps(ssm):
    taps = TapCollector()
    taps.stats = ssm["taps"].stats
    return taps


def test_ptq_fold_only_keeps_the_function(ssm):
    tp = bridge.params_from_numpy(ssm["fp"], "cpu")
    folded = ptq_model(ssm["tcfg"], tp, _port_taps(ssm), fold_only=True)
    assert not torch.equal(folded["layers"]["ln"]["scale"], tp["layers"]["ln"]["scale"])
    assert torch.equal(folded["final_norm"]["scale"], tp["final_norm"]["scale"])
    tokens = torch.from_numpy(synth_batch(ssm["tcfg"], 2, 10, seed=8))
    want = ssm_lm.forward(tp, ssm["tcfg"], tokens)[0]
    got = ssm_lm.forward(folded, ssm["tcfg"], tokens)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LM_TOL)


def test_ptq_fake_matches_reference_leaf_by_leaf(ssm):
    """The RMSNorm fold into in_proj, the ln ``a_scale`` and the
    fake-quantized in_proj / out_proj; the tied head folds nothing."""
    jp = jax.tree.map(jnp.asarray, ssm["fp"])
    ref = _flat(_np_tree(jax_ptq(ssm["jcfg"], jp, ssm["taps"], materialize="fake")))
    port = _flat(bridge.params_to_numpy(ptq_model(
        ssm["tcfg"], bridge.params_from_numpy(ssm["fp"], "cpu"), _port_taps(ssm),
        materialize="fake")))
    assert sorted(port) == sorted(ref)
    assert "layers.ln.a_scale" in port and "final_norm.a_scale" not in port
    for name, r in ref.items():
        t = port[name]
        assert t.dtype == r.dtype and t.shape == r.shape, name
        if name.endswith("_scale"):
            np.testing.assert_allclose(t, r, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6, err_msg=name)
    # the fake tree runs, and quantizes what the reference quantizes
    fp = _flat(ssm["fp"])
    assert not np.array_equal(port["layers.mamba.out_proj"], fp["layers.mamba.out_proj"])
    np.testing.assert_array_equal(port["layers.mamba.x_proj"], fp["layers.mamba.x_proj"])


@pytest.mark.parametrize("materialize", ["int8", "int4"])
def test_ptq_stored_integer_trees_refuse_the_ssm_family(ssm, materialize):
    tp = bridge.params_from_numpy(ssm["fp"], "cpu")
    with pytest.raises(NotImplementedError, match="ssm"):
        ptq_model(ssm["tcfg"], tp, _port_taps(ssm), materialize=materialize)


# ---------------------------------------------------------------------------
# (g, h) the grouped admission path of ServeEngine, and the launcher
# ---------------------------------------------------------------------------

def _greedy(tp, cfg, prompt, n_new):
    """The port's own greedy loop: prefill, then decode_step from its state."""
    logits, st = ssm_lm.prefill(tp, cfg, torch.from_numpy(prompt[None]))
    out = []
    for _ in range(n_new):
        out.append(int(torch.argmax(logits[0, -1])))
        logits, st = ssm_lm.decode_step(tp, cfg, torch.tensor([[out[-1]]]), st)
    return out


def test_grouped_engine_serves_same_length_groups(ssm):
    """11 requests on 4 slots, prompts of 5, 8 and 12 tokens: same-length
    groups prefill together, later prompts enter freed slots while others
    decode. Every token is the port's greedy loop's, and every logit the
    engine emits matches the reference's forward over the same prefix."""
    jp, tp = _trees(ssm)
    cfg = ssm["tcfg"]
    lens = (5, 8, 12, 8, 5, 12, 8, 5, 12, 8, 5)
    prompts = [synth_batch(cfg, 1, n, seed=90 + i)[0] for i, n in enumerate(lens)]
    eng = ServeEngine(cfg, tp, batch_slots=4, max_len=64, device="cpu", keep_logits=True)
    assert not eng._packed and not eng._async
    assert eng.cache["conv"].dtype == torch.float32
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3 + i % 3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()  # the first admission: 4 polled prompts of lengths 5, 8, 12, 8
    assert eng.metrics.counters["prefill_batches"] == 3
    eng.run_until_drained()
    c = eng.metrics.counters
    assert c["completed"] == len(reqs) and eng.idle
    assert c["prefill_batches"] < len(reqs)  # some groups held several prompts
    for r in reqs:
        assert r.status == "completed" and len(r.generated) == r.max_new_tokens
        assert r.generated == _greedy(tp, cfg, r.prompt, r.max_new_tokens), r.uid
        toks = list(map(int, r.prompt)) + r.generated
        j_logits, _ = jmod.forward(jp, ssm["jcfg"], jnp.asarray([toks]))
        want = np.asarray(j_logits)[0, len(r.prompt) - 1:-1]
        got = torch.stack(r.step_logits).numpy()
        np.testing.assert_allclose(got, want, err_msg=str(r.uid), **LM_TOL)


def test_grouped_engine_eos_frees_the_slot(ssm):
    tp = bridge.params_from_numpy(ssm["fp"], "cpu")
    cfg = ssm["tcfg"]
    prompt = synth_batch(cfg, 1, 6, seed=40)[0]
    want = _greedy(tp, cfg, prompt, 5)
    eng = ServeEngine(cfg, tp, batch_slots=1, max_len=32, eos_id=want[2], device="cpu")
    first = Request(uid=0, prompt=prompt, max_new_tokens=5)
    second = Request(uid=1, prompt=prompt, max_new_tokens=2)
    eng.submit(first)
    eng.submit(second)
    eng.run_until_drained()
    cut = want.index(want[2]) + 1  # the first emission of the EOS token
    assert first.generated == want[:cut] and first.eos_seen
    assert second.status == "completed" and second.generated == want[:2]
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(Request(uid=2, prompt=np.zeros(32, np.int32), max_new_tokens=1))


def test_transformer_without_packed_prefill_takes_the_grouped_path():
    """The rule is the reference's: a family with ``prefill_packed`` takes
    the grouped path when ``serve.packed_prefill`` is off. Its K/V cache
    keeps ``init_cache``'s bf16, as the reference's engine does (only a
    recurrent state is kept in f32). Every logit the engine emits matches
    the reference's forward over the same prefix on the same weights: the
    first (prefill, f32) within atol 1e-4; the decode ticks within atol
    5e-3, the size of K/V rounded to bf16 (2^-9 relative) through 4 layers
    (read ~1.7e-3 at |logit| <= 0.63)."""
    from repro.serving.engine import serving_config as jax_serving_config

    from repro_torch.serving import serving_config

    arch = "olmoe-1b-7b"
    jcfg = jax_serving_config(jax_smoke_config(arch)).replace(remat=False)
    cfg = serving_config(smoke_config(arch))
    cfg = cfg.replace(serve=dataclasses.replace(cfg.serve, packed_prefill=False))
    jp = M.init_model_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.params_from_numpy(_np_tree(jp), "cpu")
    eng = ServeEngine(cfg, tp, batch_slots=2, max_len=32, device="cpu", keep_logits=True)
    assert not eng._packed and eng.cache["k"].dtype == torch.bfloat16
    prompts = [synth_batch(cfg, 1, n, seed=n)[0] for n in (4, 6, 4)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert eng.metrics.counters["completed"] == 3
    for r in reqs:
        toks = list(map(int, r.prompt)) + r.generated
        j_logits, _ = M.module_for(jcfg).forward(jp, jcfg, jnp.asarray([toks]))
        want = np.asarray(j_logits)[0, len(r.prompt) - 1:-1]
        got = torch.stack(r.step_logits).numpy()
        np.testing.assert_allclose(got[0], want[0], err_msg=str(r.uid), **LM_TOL)
        np.testing.assert_allclose(got[1:], want[1:], atol=5e-3, rtol=0,
                                   err_msg=str(r.uid))


def test_launch_serve_runs_falcon_mamba_smoke(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5",
          "--prompt-len", "6", "--new-tokens", "3", "--slots", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "generated 15 tokens" in out and "completed=5" in out
    assert "prefill_batches=3" in out  # 2 + 2 + 1 same-length prompts
