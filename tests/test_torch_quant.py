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
