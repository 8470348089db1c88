"""The port's optimizers, schedules, clipping and gradient compression
(``repro_torch.optim``) against the reference's (``repro.optim``) on the CPU.

The same numpy parameters and gradients go to both. Tolerances:
  * schedules: rtol 1e-6 (both f32; pow and cos may differ in the last bit);
  * AdamW and Adafactor, 5 steps leaf by leaf (factored and unfactored
    Adafactor leaves): atol 1e-7, rtol 1e-5 (f32; the reductions of
    Adafactor's row and column means sum in another order);
  * ``clip_by_global_norm``: rtol 1e-6;
  * ``compress_grads``: codes bit-equal, scales and residuals rtol 1e-6.
Then the reference's own optimizer tests (a quadratic, error feedback) run
on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as J
import repro_torch.optim as T
from repro_torch.models.param import tree_leaves, tree_map


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _close(a, b, **tol):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k], **tol)
    else:
        np.testing.assert_allclose(a, b, **tol)


def _params(rng):
    return {
        "w": rng.standard_normal((8, 6)).astype(np.float32),  # factored
        "stack": rng.standard_normal((2, 4, 3)).astype(np.float32),  # factored
        "b": rng.standard_normal(5).astype(np.float32),  # unfactored
        "row": rng.standard_normal((1, 7)).astype(np.float32),  # unfactored (one row)
        "inner": {"s": np.float32(rng.standard_normal())},  # scalar
    }


SCHEDULES = [
    ("constant", (3e-4,), {}),
    ("warmup_linear", (1e-3, 5, 20), {}),
    ("warmup_linear", (1e-3, 5, 20), {"floor": 1e-4}),
    ("warmup_cosine", (1e-3, 5, 20), {}),
    ("warmup_cosine", (5e-3, 1, 4), {"floor": 2e-4}),
    ("warmup_cosine", (1e-3, 0, 10), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedules_match_reference(name, args, kw):
    fj, ft = getattr(J, name)(*args, **kw), getattr(T, name)(*args, **kw)
    for step in range(25):
        want = np.asarray(fj(jnp.asarray(step, jnp.int32)))
        got = ft(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizers_match_reference_leaf_by_leaf(opt_name):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jo = J.make_optimizer(opt_name, J.warmup_cosine(1e-2, 2, 5))
    to = T.make_optimizer(opt_name, T.warmup_cosine(1e-2, 2, 5))
    jp, tp = jax.tree.map(jnp.asarray, p0), _torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    _close(ts, js, atol=0, rtol=0)
    for step in range(5):
        g = _params(rng)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(step, jnp.int32))
        tp, ts = to.update(_torch(g), ts, tp, torch.tensor(step, dtype=torch.int32))
        _close(tp, jp, atol=1e-7, rtol=1e-5)
        _close(ts, js, atol=1e-7, rtol=1e-5)


def test_adafactor_state_is_factored():
    st = T.adafactor(T.constant(0.1)).init(_torch(_params(np.random.default_rng(1))))["v"]
    assert st["w"]["vr"].shape == (8,) and st["w"]["vc"].shape == (6,)
    assert st["stack"]["vr"].shape == (2, 4) and st["stack"]["vc"].shape == (2, 3)
    assert st["b"]["v"].shape == (5,) and st["row"]["v"].shape == (1, 7)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _params(np.random.default_rng(2))
    jg, jn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = T.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(T.global_norm(_torch(g)).numpy(),
                               np.asarray(J.global_norm(jax.tree.map(jnp.asarray, g))),
                               rtol=1e-6)
    _close(tg, jg, atol=0, rtol=1e-6)


def test_compress_grads_codes_bit_equal():
    rng = np.random.default_rng(3)
    g = _params(rng)
    js = J.init_compress_state(jax.tree.map(jnp.asarray, g))
    ts = T.init_compress_state(_torch(g))
    for _ in range(3):
        g = _params(rng)
        jc, jsc, js = J.compress_grads(jax.tree.map(jnp.asarray, g), js)
        tc, tsc, ts = T.compress_grads(_torch(g), ts)
        for a, b in zip(jax.tree.leaves(jc), [_np(x) for x in tree_leaves(tc)]):
            assert b.dtype == np.int8
            np.testing.assert_array_equal(b, np.asarray(a))
        _close(tsc, jsc, atol=0, rtol=1e-6)
        _close(ts.residual, js.residual, atol=1e-7, rtol=1e-6)
    jd = J.decompress_sum(jax.tree.map(lambda c: c.astype(jnp.int32), jc), jsc, 2)
    td = T.decompress_sum(_int32(tc), tsc, 2)
    _close(td, jd, atol=0, rtol=1e-6)


def _int32(tree):
    return tree_map(lambda c: c.to(torch.int32), tree)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizers_reduce_quadratic(opt_name):
    """The reference's test on the port: both optimizers minimize a toy
    quadratic."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8))}
    opt = T.make_optimizer(opt_name, T.constant(0.1))
    state = opt.init(params)
    for step in range(200):
        grads = {"w": params["w"] - target}
        params, state = opt.update(grads, state, params, torch.tensor(step, dtype=torch.int32))
    assert float(torch.mean(torch.abs(params["w"] - target))) < 0.05


def test_grad_compression_error_feedback(rng):
    """The reference's test on the port: with error feedback the mean of
    the dequantized gradients over steps is the true gradient."""
    g_true = {"w": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))}
    state = T.init_compress_state(g_true)
    applied = torch.zeros_like(g_true["w"])
    for _ in range(50):
        codes, scales, state = T.compress_grads(g_true, state)
        applied = applied + T.decompress_sum(_int32(codes), scales, 1)["w"]
    np.testing.assert_allclose((applied / 50).numpy(), g_true["w"].numpy(), atol=1e-3)
