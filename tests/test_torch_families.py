"""The port's remaining model families against the JAX reference at smoke
size, on the CPU (the port's plain kernel versions): the Mamba-2 block and
the zamba2 hybrid, the seamless encoder-decoder and its cross-attention,
the internvl2 vlm with its frontend embeds, nemotron (relu2, LayerNorm, GQA)
and qwen3-moe (QK-norm, 8 experts of the smoke config, top-2); PTQ of the
hybrid and encoder-decoder trees and the vlm's int8 tree; the engine's and
the launcher's refusal of the hybrid and encoder-decoder families; the vlm
served text-only by ``ServeEngine``.

Smoke configs (``configs.smoke_config``): d 64, 4 heads of 16; zamba2 5
Mamba-2 layers (state 8, heads of 16) with the shared block every 2 (after
layers 1 and 3; layer 4 gets none); seamless 2 + 2 layers, frames 48 wide;
internvl2 8 frontend positions 48 wide. Weights are the reference's,
carried over by the bridge; inputs come from numpy with a seed.

Tolerances: f32 logits within atol 1e-5 (f32 sums in another order; the
logits are O(1)), caches and states within atol = rtol = 1e-5. PTQ
leaves as ``tests/test_torch_lm.py`` holds them, fake-quantized weights
within one step of their per-channel grid. Quantized trees' logits
within atol 5e-3, the vlm's int8 tree's within 2e-2 with the argmax
equal (one code on a rounding boundary that rounds the other way moves
every later position; see its test). The vlm engine's tokens as
``tests/test_torch_lm.py`` holds the LM engine's: each the teacher-forced
argmax, or within 1e-2 of it (a bf16 K/V rounding can flip a near tie).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import smoke_config as jax_smoke_config
from repro.core.quant.ptq import calibrate_model as jax_calibrate
from repro.core.quant.ptq import ptq_model as jax_ptq
from repro.core.quant.ptq import quantized_config as jax_quantized_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.serving.engine import serving_config as jax_serving_config

from repro_torch import bridge
from repro_torch.configs import REGISTRY, SHAPES, get_config, smoke_config
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.models import encdec, hybrid, module_for, text_tokens_for, transformer
from repro_torch.models import forward as models_forward
from repro_torch.models.layers import attention_block, project_memory_kv
from repro_torch.models.param import tree_bytes
from repro_torch.models.ssm import mamba2_block
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.engine import serving_config

ATOL = 1e-5
FAMILY_ARCHS = ["zamba2-7b", "seamless-m4t-medium", "internvl2-26b", "nemotron-4-340b",
                "qwen3-moe-235b-a22b"]
B, S, PROMPT = 2, 12, 8  # batch, teacher-forced length, prefill prompt
N_FRAMES = 10  # the encoder-decoder's frames: not the decoder's length


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


def _frontend(cfg, rng):
    """The frontend input of a batch: a vlm's patch embeddings (prepended,
    8 positions), an encoder-decoder's frames; (embeds or None, positions
    they prepend to the decoder stream)."""
    if cfg.family == "encdec":
        return rng.standard_normal((B, N_FRAMES, cfg.frontend_dim)).astype(np.float32), 0
    if cfg.frontend:
        return rng.standard_normal((B, 8, cfg.frontend_dim)).astype(np.float32), 8
    return None, 0


_CACHE = {}


def _setup(arch):
    """The reference's smoke model (its serving config), its weights on
    both sides and one seeded batch."""
    if arch not in _CACHE:
        jcfg = jax_serving_config(jax_smoke_config(arch).replace(remat=False))
        tcfg = serving_config(smoke_config(arch))
        params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        fe, nf = _frontend(jcfg, rng)
        _CACHE[arch] = {"jcfg": jcfg, "tcfg": tcfg, "jp": params, "np": _np_tree(params),
                        "tokens": tokens, "fe": fe, "nf": nf}
    return _CACHE[arch]


def _fe_kw(s, torch_side: bool):
    if s["fe"] is None:
        return {}
    return {"frontend_embeds": torch.from_numpy(s["fe"]) if torch_side
            else jnp.asarray(s["fe"])}


def _close_tree(t_tree, j_tree):
    """Every leaf of a cache or state within atol = rtol = 1e-5 (a Mamba
    state sums over the sequence and grows past O(1))."""
    t_flat, j_flat = _flat(t_tree), _flat(_np_tree(j_tree))
    assert sorted(t_flat) == sorted(j_flat)
    for name, j in j_flat.items():
        t = t_flat[name]
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=ATOL,
                                   rtol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# configs, trees, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_count_and_text_tokens_match_reference(arch):
    """``param_count`` (the hybrid's one shared block, the decoder's
    cross-attention) and ``text_tokens_for`` (the frontend's positions, the
    decoder's length) at every shape, for every registry config."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for name in SHAPES:
        assert text_tokens_for(cfg, SHAPES[name]) == M.text_tokens_for(ref, jax_get_shape(name))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_trees_and_bridge_match_reference(arch):
    """The port's parameter tree has the reference's leaves and shapes at
    full width (on the meta device: nothing allocated) and at smoke size,
    and the bridge carries the smoke weights (the hybrid's ``shared``
    block and stacked Mamba-2 leaves, ``enc_layers`` / ``dec_layers``,
    ``frontend_proj``) both ways unchanged."""
    from repro_torch.models import abstract_params
    from repro_torch.models.param import init_params

    for cfg, ref in ((get_config(arch), jax_get_config(arch)),
                     (smoke_config(arch), jax_smoke_config(arch))):
        got = _flat(init_params(abstract_params(cfg), None, "meta"))
        want = _flat(M.model_param_shapes(ref))
        assert sorted(got) == sorted(want)
        for name, spec in want.items():
            assert tuple(got[name].shape) == tuple(spec.shape), name
    s = _setup(arch)
    tp = bridge.params_from_numpy(s["np"], "cpu")
    assert tree_bytes(tp) == sum(a.nbytes for a in jax.tree.leaves(s["np"]))
    jax.tree.map(np.testing.assert_array_equal, bridge.params_to_numpy(tp), s["np"])


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_cache_shapes_match_reference(arch):
    """The decode state's layout at full width on the meta device against
    the reference's ``cache_shapes``; the one difference is the hybrid's
    conv history, kept in f32 (the reference's ``init_cache`` default is
    bf16, while its ``prefill`` and ``decode_step`` produce f32)."""
    cfg = get_config(arch)
    want = _flat(jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                              M.module_for(jax_get_config(arch)).cache_shapes(
                                  jax_get_config(arch), 4, 1024)))
    got = _flat(module_for(cfg).cache_shapes(cfg, 4, 1024))
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()}
    if arch == "zamba2-7b":
        assert got.pop("ssm.conv") == (want.pop("ssm.conv")[0], "float32")
        assert got["kv.k"][0][0] == 13  # 81 layers, every 6: 13 applications
    else:
        assert got["self.k"][0][2] == encdec.dec_len_for(1024)
    assert got == want


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

def test_mamba2_block_prefill_and_decode_match_reference():
    """The chunked SSD prefill at a length that is not a multiple of the
    chunk (21 over chunks of 8: a zero-padded last chunk), then three
    one-step decodes continuing its state; nonzero A_log, dt_bias, D,
    norm_scale and conv_b; y, h and the conv history within 1e-5. The port
    also agrees with itself: the prefill's state equals the one a prefill
    of 18 and three decodes reach."""
    jcfg = jax_smoke_config("zamba2-7b")
    jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, scan_chunk=8))
    tcfg = smoke_config("zamba2-7b")
    tcfg = tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, scan_chunk=8))
    p = _np_tree(M.param.init_params(jssm.mamba2_pdefs(jcfg), jax.random.PRNGKey(3),
                                     jnp.float32))
    rng = np.random.default_rng(4)
    for k in ("A_log", "dt_bias", "D", "norm_scale", "conv_b"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, "cpu")
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    jy, jst = jssm.mamba2_block(jnp.asarray(x), jp, jcfg)
    ty, tst = mamba2_block(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    _close_tree(tst, jst)
    assert tst["h"].dtype == torch.float32
    for t in range(3):
        xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jssm.mamba2_block(jnp.asarray(xd), jp, jcfg, state=jst)
        ty, tst = mamba2_block(torch.from_numpy(xd), tp, tcfg, state=tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
        _close_tree(tst, jst)
    _, st18 = mamba2_block(torch.from_numpy(x[:, :18]), tp, tcfg)
    for t in range(18, 21):
        _, st18 = mamba2_block(torch.from_numpy(x[:, t:t + 1]), tp, tcfg, state=st18)
    _, st21 = mamba2_block(torch.from_numpy(x), tp, tcfg)
    torch.testing.assert_close(st18["h"], st21["h"], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# forward, prefill and decode of every new family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    """``forward`` over S tokens (with the frontend's input), ``prefill``
    of the first 8 into a cache of S (+ frontend) rows and two
    ``decode_step``s at a scalar index: logits and every cache / state
    leaf within 1e-5 of the reference's; the decodes also within 5e-4 of
    the teacher-forced forward, as the reference's own test holds them."""
    s = _setup(arch)
    jcfg, tcfg, nf = s["jcfg"], s["tcfg"], s["nf"]
    jmod, tmod = M.module_for(jcfg), module_for(tcfg)
    tp = bridge.params_from_numpy(s["np"], "cpu")
    tok = s["tokens"]
    jfull, _ = jmod.forward(s["jp"], jcfg, jnp.asarray(tok), **_fe_kw(s, False))
    tfull, _ = tmod.forward(tp, tcfg, torch.from_numpy(tok), **_fe_kw(s, True))
    assert tfull.shape == (B, S + nf, jcfg.vocab_size)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), atol=ATOL, rtol=0)
    jl, jc = jmod.prefill(s["jp"], jcfg, jnp.asarray(tok[:, :PROMPT]), max_len=S + nf,
                          **_fe_kw(s, False))
    tl, tc = tmod.prefill(tp, tcfg, torch.from_numpy(tok[:, :PROMPT]), max_len=S + nf,
                          **_fe_kw(s, True))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _close_tree(tc, jc)
    for t in (PROMPT, PROMPT + 1):
        idx = t + nf
        jl, jc = jmod.decode_step(s["jp"], jcfg, jnp.asarray(tok[:, t:t + 1]), jc,
                                  jnp.asarray(idx, jnp.int32))
        tl, tc = tmod.decode_step(tp, tcfg, torch.from_numpy(tok[:, t:t + 1]), tc,
                                  torch.tensor(idx) if t == PROMPT else idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        _close_tree(tc, jc)
        np.testing.assert_allclose(tl[:, 0].numpy(), tfull[:, idx].numpy(), atol=5e-4,
                                   rtol=5e-4)


def test_hybrid_shared_block_schedule_and_scalar_index(monkeypatch):
    """The smoke config's 5 layers with the shared block every 2: two
    applications a pass (after layers 1 and 3; layer 4 gets none), each
    writing its own K/V slice, the rows past the prompt untouched; the conv
    history f32; a [B] index raises, as the reference's decode fails
    there."""
    s = _setup("zamba2-7b")
    tcfg = s["tcfg"]
    tp = bridge.params_from_numpy(s["np"], "cpu")
    assert hybrid.n_apps(tcfg) == 2 and tcfg.num_layers == 5
    calls = []
    block = hybrid._shared_block
    monkeypatch.setattr(hybrid, "_shared_block",
                        lambda *a, **kw: calls.append(kw["cache"]) or block(*a, **kw))
    tok = torch.from_numpy(s["tokens"])
    _, cache = hybrid.prefill(tp, tcfg, tok[:, :PROMPT], max_len=S)
    assert len(calls) == 2
    k = cache["kv"]["k"]
    assert k.shape == (2, B, S, 4, 16)
    assert [c["k"].data_ptr() for c in calls] == [k[0].data_ptr(), k[1].data_ptr()]
    assert (k[:, :, :PROMPT].abs().amax(dim=(-1, -2)) > 0).all()
    assert (k[:, :, PROMPT:] == 0).all()
    assert cache["ssm"]["conv"].dtype == torch.float32
    with pytest.raises(ValueError, match="scalar index"):
        hybrid.decode_step(tp, tcfg, tok[:, PROMPT:PROMPT + 1], cache,
                           torch.full((B,), PROMPT, dtype=torch.int32))


def test_cross_attention_and_project_memory_kv_match_reference():
    """The encoder-decoder's memory branch of ``attention_block`` (K/V
    projected from the memory, and precomputed by ``project_memory_kv``):
    no RoPE, non-causal, Sq != Sk, biases; against the reference's, and the
    two forms equal."""
    s = _setup("seamless-m4t-medium")
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jx = _np_tree(jax.tree.map(lambda a: a[1], s["jp"]["dec_layers"]["xattn"]))
    rng = np.random.default_rng(11)
    for k in ("bq", "bk", "bv", "bo"):
        jx[k] = (0.1 * rng.standard_normal(jx[k].shape)).astype(np.float32)
    tx = bridge.params_from_numpy(jx, "cpu")
    jxj = jax.tree.map(jnp.asarray, jx)
    h = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, N_FRAMES, jcfg.d_model)).astype(np.float32)
    pos = jnp.arange(5, dtype=jnp.int32)
    jk, jv = jlayers.project_memory_kv(jnp.asarray(mem), jxj, jcfg.attn, jcfg)
    tk, tv = project_memory_kv(torch.from_numpy(mem), tx, tcfg.attn, tcfg)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    jy, _ = jlayers.attention_block(jnp.asarray(h), jxj, jcfg, jcfg.attn, positions=pos,
                                    memory=jnp.asarray(mem))
    ty, _ = attention_block(torch.from_numpy(h), tx, tcfg, tcfg.attn,
                            positions=torch.arange(5), memory=torch.from_numpy(mem))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    ty2, _ = attention_block(torch.from_numpy(h), tx, tcfg, tcfg.attn, memory_kv=(tk, tv))
    torch.testing.assert_close(ty2, ty, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="no cache"):
        attention_block(torch.from_numpy(h), tx, tcfg, tcfg.attn, memory_kv=(tk, tv),
                        cache={"k": tk, "v": tv}, cache_index=0)


# ---------------------------------------------------------------------------
# calibration and PTQ
# ---------------------------------------------------------------------------

def _batches(s, seeds=(21,)):
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        b = {"tokens": rng.integers(0, s["jcfg"].vocab_size, (B, S)).astype(np.int32)}
        fe, _ = _frontend(s["jcfg"], rng)
        if fe is not None:
            b["frontend_embeds"] = fe
        out.append(b)
    return out


_TAPS = {}


def _taps(arch):
    """Both packages' calibration taps over the same batch of 2 x 12 tokens
    (the reference's calibration runs op by op: one batch keeps the file
    short)."""
    if arch not in _TAPS:
        s = _setup(arch)
        bs = _batches(s)
        jt = jax_calibrate(s["jcfg"], s["jp"], [jax.tree.map(jnp.asarray, b) for b in bs])
        tt = calibrate_model(s["tcfg"], bridge.params_from_numpy(s["np"], "cpu"),
                             [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs])
        _TAPS[arch] = (jt, tt)
    return _TAPS[arch]


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium", "internvl2-26b"])
def test_calibration_taps_match_reference(arch):
    """The same sites (the hybrid's shared block under one ``shared`` scope,
    every application merged; ``Ldec{i}.x.attn_out`` for the cross
    attention; ``enc_norm_out``) with min / max / absmax within atol = rtol
    = 1e-5."""
    jt, tt = _taps(arch)
    assert sorted(tt.stats) == sorted(jt.stats)
    if arch == "zamba2-7b":
        assert "shared.post_ln1" in tt.stats and "shared.mlp_mid" in tt.stats
        assert not any(k.startswith("L") and "attn" in k for k in tt.stats)
    if arch == "seamless-m4t-medium":
        assert {"Ldec001.x.attn_out", "Ldec000.post_lnx", "enc_norm_out"} <= set(tt.stats)
    for site, st in jt.stats.items():
        for k in ("min", "max"):
            np.testing.assert_allclose(tt.stats[site][k], st[k], atol=ATOL, rtol=ATOL,
                                       err_msg=site)
        np.testing.assert_allclose(tt.absmax(site), jt.absmax(site), atol=ATOL, rtol=ATOL)


def _shared_taps(jt):
    taps = TapCollector()
    taps.stats = jt.stats
    return taps


def _check_leaves(port, ref, grid_keys=()):
    """Leaf by leaf: dtypes and shapes equal; stored integers within 1
    code; scales to 1e-6; fake-quantized weights (``grid_keys``) within one
    step of their per-output-channel grid (a value on a rounding boundary);
    every other (folded fp) leaf within rtol 1e-5, atol 1e-6."""
    assert sorted(port) == sorted(ref)
    for name, r in ref.items():
        t = port[name]
        assert t.dtype == r.dtype and t.shape == r.shape, name
        if r.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
        elif name.endswith(("_scale", "_as")):
            np.testing.assert_allclose(t, r, rtol=1e-6, atol=0, err_msg=name)
        elif name.split(".")[-1] in grid_keys:
            step = np.abs(r).max(axis=-2, keepdims=True) / 127.0
            diff = np.abs(t - r)
            assert (diff <= step * 1.0001 + 1e-7).all(), name
            assert (diff > 1e-6).mean() < 1e-2, name
        else:
            np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
@pytest.mark.parametrize("mode", ["fold_only", "fake"])
def test_ptq_matches_reference_leaf_by_leaf(arch, mode):
    """The reference's taps into both packages' ``ptq_model``: the
    hybrid's Mamba in_proj fold (RMSNorm: no bias), its shared block
    folded once; the
    encoder-decoder's LayerNorm folds with their bias corrections
    (``post_lnx`` into the cross q, ``enc_norm`` into every layer's cross
    k and v), the ``x.attn_out`` mid scale; ``frontend_proj``
    fake-quantized weight-only."""
    from repro_torch.core.quant.ptq import QUANT_WEIGHT_KEYS

    s = _setup(arch)
    jt, _ = _taps(arch)
    kw = {"fold_only": True} if mode == "fold_only" else {"materialize": "fake"}
    ref = _flat(_np_tree(jax_ptq(s["jcfg"], s["jp"], jt, **kw)))
    port = _flat(bridge.params_to_numpy(ptq_model(
        s["tcfg"], bridge.params_from_numpy(s["np"], "cpu"), _shared_taps(jt), **kw)))
    _check_leaves(port, ref, QUANT_WEIGHT_KEYS if mode == "fake" else ())
    if arch == "seamless-m4t-medium":
        # LayerNorm: the final norm's fold gives the head a bias, the
        # encoder norm's every decoder layer's cross k / v biases a correction
        assert "lm_head_b" in port
        assert not np.allclose(port["dec_layers.xattn.bk"], s["np"]["dec_layers"]["xattn"]["bk"])
        if mode == "fake":
            assert "dec_layers.xattn.wo_a_scale" in port and "enc_norm.a_scale" in port
            assert not np.array_equal(port["frontend_proj"], s["np"]["frontend_proj"])
    else:
        assert "layers.mamba.in_bias" not in port  # RMSNorm fold: no bias
        if mode == "fake":
            assert port["shared.attn.wo_a_scale"].shape == ()


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_fold_only_tree_is_the_fp_model(arch):
    """The Eq. 10-16 fold (LayerNorm with r2 != 0 on the encoder-decoder)
    changes the function by rounding only: logits within 1e-2 of std(logits)
    of the fp model's (the reference test's rule), and within 1e-5 of the
    reference's fold-only logits."""
    s = _setup(arch)
    jt, _ = _taps(arch)
    tcfg = s["tcfg"]
    tp = bridge.params_from_numpy(s["np"], "cpu")
    folded = ptq_model(tcfg, tp, _shared_taps(jt), fold_only=True)
    tok = torch.from_numpy(s["tokens"])
    fp = module_for(tcfg).forward(tp, tcfg, tok, **_fe_kw(s, True))[0]
    got = module_for(tcfg).forward(folded, tcfg, tok, **_fe_kw(s, True))[0]
    assert float((got - fp).abs().max() / fp.std()) < 1e-2
    jf = jax_ptq(s["jcfg"], s["jp"], jt, fold_only=True)
    want = M.module_for(s["jcfg"]).forward(jf, s["jcfg"], jnp.asarray(s["tokens"]),
                                           **_fe_kw(s, False))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_fake_quant_tree_matches_reference(arch):
    """The fake-quant tree (``quantized_config``: 8-bit activations at every
    norm and mid site, 4-bit attention) runs the families' quantized path:
    logits within 5e-3 of the reference's on the reference's tree."""
    s = _setup(arch)
    jt, _ = _taps(arch)
    jfake = jax_ptq(s["jcfg"], s["jp"], jt)
    tfake = bridge.params_from_numpy(_np_tree(jfake), "cpu")
    jq, tq = jax_quantized_config(s["jcfg"]), quantized_config(s["tcfg"])
    want = M.module_for(jq).forward(jfake, jq, jnp.asarray(s["tokens"]), **_fe_kw(s, False))[0]
    got = module_for(tq).forward(tfake, tq, torch.from_numpy(s["tokens"]),
                                 **_fe_kw(s, True))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=0)


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
@pytest.mark.parametrize("materialize", ["int8", "int4"])
def test_ptq_stored_integer_trees_refuse_the_family(arch, materialize):
    s = _setup(arch)
    with pytest.raises(NotImplementedError, match=s["tcfg"].family):
        ptq_model(s["tcfg"], bridge.params_from_numpy(s["np"], "cpu"),
                  _shared_taps(_taps(arch)[0]), materialize=materialize)


def test_vlm_int8_tree_matches_reference():
    """The vlm's stored int8 tree leaf by leaf (``frontend_proj`` int8 with
    its per-channel scale and no activation scale: weight-only), and its
    forward with frontend embeds (int8 activations, 4-bit attention) within
    2e-2 of the reference's with the argmax equal at every position: one
    4-bit attention code or int8 activation that rounds the other way at a
    boundary (f32 sums in another order) moves every later position's
    logits, by up to 1.3e-2 from batch row 0's third position on these
    inputs, the other row exact."""
    s = _setup("internvl2-26b")
    jt, _ = _taps("internvl2-26b")
    jq, tq = jax_quantized_config(s["jcfg"]), quantized_config(s["tcfg"])
    jint8 = jax_ptq(jq, s["jp"], jt, materialize="int8")
    ref = _flat(_np_tree(jint8))
    port_tree = ptq_model(tq, bridge.params_from_numpy(s["np"], "cpu"), _shared_taps(jt),
                          materialize="int8")
    port = _flat(bridge.params_to_numpy(port_tree))
    _check_leaves(port, ref)
    assert port["frontend_proj"].dtype == np.int8 and "frontend_proj_as" not in port
    tint8 = bridge.params_from_numpy(_np_tree(jint8), "cpu")
    want = M.module_for(jq).forward(jint8, jq, jnp.asarray(s["tokens"]), **_fe_kw(s, False))[0]
    got = models_forward(tint8, tq, {"tokens": torch.from_numpy(s["tokens"]),
                                     "frontend_embeds": torch.from_numpy(s["fe"])})[0]
    assert got.shape == (B, S + 8, s["jcfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_engine_and_launcher_refuse_the_family(arch):
    """``ServeEngine`` refuses the hybrid and the encoder-decoder at
    construction, naming the reference engine's failure, and so does
    ``launch/serve.py`` before it builds any weights."""
    from repro_torch.launch.serve import main as serve_main

    s = _setup(arch)
    why = "RoPE" if arch == "zamba2-7b" else "frontend_embeds=None"
    with pytest.raises(ValueError, match=why):
        ServeEngine(s["tcfg"], bridge.params_from_numpy(s["np"], "cpu"), device="cpu")
    with pytest.raises(ValueError, match=why):
        serve_main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_vlm_engine_matches_reference_teacher_forced_prefill():
    """The vlm served text-only by ``ServeEngine`` (packed admission, bf16
    cache): every emitted token is the argmax of the reference's
    teacher-forced logits over its prefix, or within 1e-2 of it, and the
    engine's logits of each step within 5e-2 of them (bf16 K/V rounding).
    The reference's teacher-forced logits are its ``forward`` over the
    whole sequence, whose row t is ``prefill``'s over the first t + 1
    tokens (held here at each request's first step)."""
    s = _setup("internvl2-26b")
    tcfg, jcfg = s["tcfg"], s["jcfg"]
    jmod = M.module_for(jcfg)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (5, 9)]
    eng = ServeEngine(tcfg, bridge.params_from_numpy(s["np"], "cpu"), batch_slots=4,
                      max_len=32, device="cpu", keep_logits=True)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert eng.metrics.counters["completed"] == 2
    assert eng.metrics.counters["prefill_batches"] == 1  # the packed path
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
        full = np.asarray(jmod.forward(s["jp"], jcfg, jnp.asarray(seq[None]))[0][0])
        first = np.asarray(jmod.prefill(s["jp"], jcfg, jnp.asarray(r.prompt[None]))[0][0, -1])
        np.testing.assert_allclose(full[len(r.prompt) - 1], first, atol=ATOL, rtol=0)
        for j, (t, lg) in enumerate(zip(r.generated, r.step_logits)):
            want = full[len(r.prompt) - 1 + j]
            assert want[t] >= want.max() - 1e-2, r.uid
            np.testing.assert_allclose(lg.float().numpy(), want, atol=5e-2, rtol=0)


# ---------------------------------------------------------------------------
# the frontend families' pipeline batches and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-medium"])
def test_pipeline_frontend_batches_and_loss_match_reference(arch):
    """``SyntheticPipeline`` batches of a frontend family bit-equal to the
    reference's (tokens, labels and ``frontend_embeds``: a vlm's patches,
    an encoder-decoder's frames), and ``loss_and_metrics`` over one (the
    frontend positions carry no labels) within rtol 1e-5."""
    from repro.data import SyntheticPipeline as JaxPipeline
    from repro.train.losses import loss_and_metrics as jax_loss_and_metrics

    from repro_torch.configs import get_shape
    from repro_torch.data import SyntheticPipeline, batch_to
    from repro_torch.train.losses import loss_and_metrics

    s = _setup(arch)
    shape = get_shape("train_4k").replace(seq_len=24, global_batch=2)
    jshape = jax_get_shape("train_4k").replace(seq_len=24, global_batch=2)
    for step in (0, 3):
        a = JaxPipeline(s["jcfg"], jshape, seed=5).batch_for_step(step)
        b = SyntheticPipeline(s["tcfg"], shape, seed=5).batch_for_step(step)
        assert sorted(a) == sorted(b) == ["frontend_embeds", "labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    want, wm = jax_loss_and_metrics(s["jp"], s["jcfg"], jax.tree.map(jnp.asarray, a))
    with torch.no_grad():
        got, gm = loss_and_metrics(bridge.params_from_numpy(s["np"], "cpu"), s["tcfg"],
                                   batch_to(b, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gm["acc"]), float(wm["acc"]), rtol=1e-5)
