"""The port's quantization primitives, router, dispatch and norm against
the JAX reference on the same numpy inputs (CPU).

Integer results and quantizer grids are compared exactly; fp results within
atol 1e-6 (the same f32 formula, sums possibly in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.moe.dispatch import grouped_combine as jax_combine
from repro.core.moe.dispatch import grouped_dispatch as jax_dispatch
from repro.core.moe.router import route_topk as jax_route_topk
from repro.core.quant import linear_quant as jlq
from repro.core.quant import qtypes as jqt
from repro.core.quant.softmax_quant import logsqrt2_dequantize as jax_dequant
from repro.models.layers import act_fn as jax_act_fn
from repro.models.layers import layernorm as jax_layernorm

from repro_torch.core.moe.dispatch import grouped_combine, grouped_dispatch
from repro_torch.core.moe.router import route_topk
from repro_torch.core.quant import linear_quant as tlq
from repro_torch.core.quant import qtypes as tqt
from repro_torch.core.quant.softmax_quant import logsqrt2_dequantize
from repro_torch.models.layers import act_fn, layernorm


def test_quantize_sym_rounds_half_to_even_like_reference():
    """Values on .5 boundaries (and ones that only a reciprocal multiply
    would move) quantize to the reference's codes, clipped to int8."""
    scale = np.float32(0.1)
    x = np.concatenate([
        np.arange(-20.5, 21, 1.0) * scale,  # exact .5 multiples of the scale
        np.random.default_rng(0).standard_normal(2000) * 8,
    ]).astype(np.float32)
    want = np.asarray(jqt.quantize_sym(jnp.asarray(x), jnp.asarray(scale), 8))
    got = tqt.quantize_sym(torch.from_numpy(x), torch.tensor(scale), 8).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("din", [6, 7])
def test_int4_pack_unpack_match_reference(din):
    q = np.random.default_rng(din).integers(-8, 8, (2, din, 5)).astype(np.int8)
    want = np.asarray(jqt.pack_int4(jnp.asarray(q)))
    got = tqt.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tqt.unpack_int4(got, din).numpy(), q)


def test_logsqrt2_dequantize_matches_reference_on_every_code():
    codes = np.arange(0, 16, dtype=np.int32)
    np.testing.assert_array_equal(logsqrt2_dequantize(torch.from_numpy(codes)).numpy(),
                                  np.asarray(jax_dequant(jnp.asarray(codes))))


def test_weight_and_activation_quantizers_match_reference():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 24, 10)).astype(np.float32)
    jq, js = jlq.quantize_weight(jnp.asarray(w))
    tq, ts = tlq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tlq.fake_quant_weight(torch.from_numpy(w)).numpy(),
                                  np.asarray(jlq.fake_quant_weight(jnp.asarray(w))))
    x = rng.standard_normal((50, 24)).astype(np.float32) * 3
    a_s = np.float32(0.021)
    np.testing.assert_array_equal(
        tlq.fake_quant_activation(torch.from_numpy(x), torch.tensor(a_s)).numpy(),
        np.asarray(jlq.fake_quant_activation(jnp.asarray(x), jnp.asarray(a_s))))


def _route_both(logits, k, bias=None):
    T, E = logits.shape
    x = np.zeros((T, 4), np.float32)
    w = np.zeros((4, E), np.float32)
    j = jax_route_topk(jnp.asarray(x), jnp.asarray(w),
                       None if bias is None else jnp.asarray(bias), k,
                       logits=jnp.asarray(logits))
    t = route_topk(torch.from_numpy(x), torch.from_numpy(w),
                   None if bias is None else torch.from_numpy(bias), k,
                   logits=torch.from_numpy(logits))
    return j, t


def test_router_breaks_ties_toward_the_lower_expert_like_reference():
    """Equal logits (an int8 gate produces them) pick the lower expert id
    first, as ``jax.lax.top_k`` does."""
    logits = np.array([
        [1.0, 1.0, 1.0, 1.0, 0.0, 0.0],
        [0.0, 2.0, 0.5, 2.0, 2.0, 0.5],
        [0.25, 0.25, 0.25, 0.25, 0.25, 0.25],
        [3.0, -1.0, 3.0, 3.0, -1.0, 1.0],
    ], np.float32)
    j, t = _route_both(logits, 2)
    np.testing.assert_array_equal(t.experts.numpy(), np.asarray(j.experts))
    np.testing.assert_array_equal(t.experts.numpy(), [[0, 1], [1, 3], [0, 1], [0, 2]])
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))


def test_router_weights_and_aux_loss_match_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32) * 0.1
    j, t = _route_both(logits, 2, bias)
    np.testing.assert_array_equal(t.experts.numpy(), np.asarray(j.experts))
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), atol=1e-6)
    np.testing.assert_allclose(float(t.aux_loss), float(j.aux_loss), rtol=1e-6)


def test_grouped_dispatch_and_combine_match_reference():
    rng = np.random.default_rng(3)
    T, D, E, k = 23, 6, 5, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    experts = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    experts[:4] = [[4, 1]] * 4  # a crowded expert and an empty one (0 or 2)
    weights = rng.uniform(0.1, 1, (T, k)).astype(np.float32)
    jd = jax_dispatch(jnp.asarray(x), jnp.asarray(experts), jnp.asarray(weights), E)
    td = grouped_dispatch(torch.from_numpy(x), torch.from_numpy(experts),
                          torch.from_numpy(weights), E)
    for name in ("x_sorted", "group_sizes", "sort_idx", "token_idx", "weights_sorted"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    assert td.group_sizes.dtype == torch.int32
    y = rng.standard_normal((T * k, D)).astype(np.float32)
    np.testing.assert_allclose(grouped_combine(torch.from_numpy(y), td, T).numpy(),
                               np.asarray(jax_combine(jnp.asarray(y), jd, T)), atol=1e-6)


def test_layernorm_and_gelu_match_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 17, 64)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layernorm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy(),
        np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
        atol=1e-5)
    np.testing.assert_allclose(act_fn("gelu")(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_act_fn("gelu")(jnp.asarray(x))), atol=1e-6)


# ---------------------------------------------------------------------------
# post-norm reparameterization (Eqs. 10-16): core/quant/reparam.py
# ---------------------------------------------------------------------------

from repro.core.quant import reparam as jrp  # noqa: E402

from repro_torch.core import quant as tq  # noqa: E402


def _post_norm_samples(seed, n=64, d=12):
    """Channels with their own spread and offset (some not straddling 0)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * rng.uniform(0.1, 5, d)
            + rng.uniform(-3, 3, d)).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
def test_reparam_calibration_matches_reference(bits):
    """Per-channel asymmetric (s, z) and symmetric s: exact (the same f32
    min / max, division and round)."""
    x = _post_norm_samples(bits)
    js, jz = jrp.calibrate_per_channel_asym(jnp.asarray(x), bits)
    ts, tz = tq.calibrate_per_channel_asym(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tq.calibrate_per_channel_sym(torch.from_numpy(x), bits).numpy(),
                                  np.asarray(jrp.calibrate_per_channel_sym(jnp.asarray(x), bits)))


@pytest.mark.parametrize("symmetric", [False, True])
def test_reparam_factors_match_reference(symmetric):
    """``factors_from_minmax`` and ``reparam_factors``: r1, r2, s, s_tilde
    within rtol 1e-6 (s_tilde is a mean, summed in another order)."""
    x = _post_norm_samples(3)
    xmin, xmax = x.min(0), x.max(0)
    want = jrp.factors_from_minmax(jnp.asarray(xmin), jnp.asarray(xmax), 8, symmetric)
    got = tq.factors_from_minmax(torch.from_numpy(xmin), torch.from_numpy(xmax), 8, symmetric)
    assert isinstance(got, tq.ReparamFactors)
    for name in tq.ReparamFactors._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    if symmetric:
        assert not got.r2.any()
    s, z = jrp.calibrate_per_channel_asym(jnp.asarray(x), 8)
    want = jrp.reparam_factors(s, None if symmetric else z, 8)
    got = tq.reparam_factors(torch.tensor(np.asarray(s)),
                             None if symmetric else torch.tensor(np.asarray(z)), 8)
    for name in tq.ReparamFactors._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_reparam_folds_match_reference():
    """``apply_to_layernorm``, ``apply_to_rmsnorm``, ``apply_to_consumer``
    (with and without a bias) and ``transform_activation`` on the same
    factors: rtol 1e-6, atol 1e-6."""
    rng = np.random.default_rng(4)
    x = _post_norm_samples(4)
    d = x.shape[1]
    s, z = jrp.calibrate_per_channel_asym(jnp.asarray(x), 8)
    jf = jrp.reparam_factors(s, z, 8)
    tf = tq.ReparamFactors(*(torch.tensor(np.asarray(v)) for v in jf))
    gamma = rng.uniform(0.5, 2, d).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    w = rng.standard_normal((d, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    pairs = [
        (tq.apply_to_layernorm(torch.from_numpy(gamma), torch.from_numpy(beta), tf),
         jrp.apply_to_layernorm(jnp.asarray(gamma), jnp.asarray(beta), jf)),
        ((tq.apply_to_rmsnorm(torch.from_numpy(gamma), tf),),
         (jrp.apply_to_rmsnorm(jnp.asarray(gamma), jf),)),
        (tq.apply_to_consumer(torch.from_numpy(w), torch.from_numpy(b), tf),
         jrp.apply_to_consumer(jnp.asarray(w), jnp.asarray(b), jf)),
        (tq.apply_to_consumer(torch.from_numpy(w), None, tf),
         jrp.apply_to_consumer(jnp.asarray(w), None, jf)),
        ((tq.transform_activation(torch.from_numpy(x), tf),),
         (jrp.transform_activation(jnp.asarray(x), jf),)),
    ]
    for got, want in pairs:
        for g, v in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(v), **tol)


@pytest.mark.parametrize("d,n", [(2, 4), (7, 19), (16, 32)])
def test_reparam_linear_equivalence(d, n):
    """Eq. 13 on the port: X W + b == X' (diag(r1) W) + (b - W^T (s r2)),
    rtol = atol = 2e-4 (the reference test's tolerance)."""
    rng = np.random.default_rng(d * 100 + n)
    x = torch.from_numpy((rng.standard_normal((n, d)) * rng.uniform(0.1, 5, d)
                          + rng.uniform(-3, 3, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    f = tq.reparam_factors(*tq.calibrate_per_channel_asym(x, 8), 8)
    w_p, b_p = tq.apply_to_consumer(w, b, f)
    np.testing.assert_allclose((x @ w + b).numpy(),
                               (tq.transform_activation(x, f) @ w_p + b_p).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_reparam_integer_grid_alignment():
    """round(X' / s_tilde) is the per-channel asymmetric integer grid of X
    shifted by 2^(b-1), within one code (the reference test's bound)."""
    x = torch.from_numpy(_post_norm_samples(0, n=256, d=8))
    s, z = tq.calibrate_per_channel_asym(x, 8)
    f = tq.reparam_factors(s, z, 8)
    grid_sym = torch.round(tq.transform_activation(x, f) / f.s_tilde)
    grid_asym = torch.round(x / s) + z - 2.0**7
    np.testing.assert_allclose(grid_sym.numpy(), grid_asym.numpy(), atol=1 + 1e-5)


def test_reparam_layernorm_fold():
    """Folding into (gamma, beta) gives X' with no run-time op (Eq. 11),
    through the port's ``layernorm``: rtol = atol = 2e-4."""
    rng = np.random.default_rng(1)
    d, n = 16, 64
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 2, d).astype(np.float32))
    beta = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    y = layernorm(x, gamma, beta)
    f = tq.reparam_factors(*tq.calibrate_per_channel_asym(y, 8), 8)
    g_p, b_p = tq.apply_to_layernorm(gamma, beta, f)
    np.testing.assert_allclose(layernorm(x, g_p, b_p).numpy(),
                               tq.transform_activation(y, f).numpy(), rtol=2e-4, atol=2e-4)
