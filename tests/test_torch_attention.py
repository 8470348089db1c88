"""The port's attention and grouped W4A8 plain versions against the JAX
reference on the CPU, in every mode the LM path runs.

The same numpy inputs go through ``repro.kernels.ref.flash_attention_ref``
(and, at two shapes, the Pallas kernel in interpret mode) and through
``repro_torch.kernels.ops.attention``, which on the CPU runs the port's
plain version. q and fp k lie on a 1/4 grid and hd=16 keeps 1/sqrt(hd) a
power of two, so every score is exact in f32 in both frameworks and the
log-sqrt2 codes agree exactly; only exp and the P.V sums differ in order.

Tolerances:
  * f32 and int8 K/V: atol 1e-5 (f32 sums in another order);
  * bf16 K/V: atol 1e-5 as well -- both sides round the probabilities to
    bf16 before P.V, and the inputs keep them identical;
  * softcap rows: atol 1e-5 with quant_bits=0 (tanh differs in the last
    bit between the libraries, which a code boundary would amplify);
  * grouped W4A8: bit-equal (exact integer accumulation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant_attention import streaming_attention as jax_attention

from repro_torch.kernels import ops, ref
from repro_torch.core.quant.qtypes import pack_int4


def _grid(rng, shape):
    return (rng.integers(-3, 4, shape) * 0.25).astype(np.float32)


def _inputs(rng, B, Sq, Sk, H, KVH, hd, kv):
    """q on the 1/4 grid; k, v f32 (grid k), bf16 (grid k) or int8 with
    positive per-(position, head) scales."""
    q = _grid(rng, (B, Sq, H, hd))
    if kv == "int8":
        k = rng.integers(-127, 128, (B, Sk, KVH, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, Sk, KVH, hd)).astype(np.int8)
        ks = (2.0 ** rng.integers(-9, -5, (B, Sk, KVH))).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (B, Sk, KVH)).astype(np.float32)
        return q, k, v, ks, vs
    k = _grid(rng, (B, Sk, KVH, hd))
    v = rng.standard_normal((B, Sk, KVH, hd)).astype(np.float32)
    if kv == "bf16":
        v = torch.from_numpy(v).bfloat16().float().numpy()  # bf16-exact values
    return q, k, v, None, None


def _to_jax(a, kv):
    if a is None:
        return None
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if kv == "bf16" and a.dtype == np.float32 else x


def _to_torch(a, kv):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.bfloat16() if kv == "bf16" and t.dtype == torch.float32 else t


SEGS = np.asarray([[0] * 7 + [1] * 5 + [2] * 6 + [-1] * 2], np.int32)

# (id, B, Sq, Sk, H, KVH, hd, kv, kwargs)
CASES = [
    ("calibration-causal-qb0", 2, 12, 12, 4, 4, 16, "f32", dict(quant_bits=0)),
    ("causal-qb4-gqa", 2, 12, 12, 4, 2, 16, "f32", dict(quant_bits=4)),
    ("packed-prefill-int8-qb4", 1, 20, 20, 4, 4, 16, "int8",
     dict(quant_bits=4, segs=SEGS, valid=np.asarray([20], np.int32))),
    ("packed-prefill-f32-qb0", 1, 20, 20, 4, 2, 16, "f32",
     dict(quant_bits=0, segs=SEGS)),
    ("decode-int8-qb4-per-row", 3, 1, 24, 4, 4, 16, "int8",
     dict(quant_bits=4, q_offset=np.asarray([3, 17, 0], np.int32),
          valid=np.asarray([4, 18, 1], np.int32))),
    ("decode-bf16-qb0-per-row", 3, 1, 24, 4, 2, 16, "bf16",
     dict(quant_bits=0, q_offset=np.asarray([5, 23, 9], np.int32),
          valid=np.asarray([6, 24, 10], np.int32))),
    ("decode-int8-qb0-scalar", 2, 1, 16, 4, 4, 16, "int8",
     dict(quant_bits=0, q_offset=7, valid=np.asarray([8, 8], np.int32))),
    ("chunk-over-cache-qb4", 2, 4, 16, 4, 4, 16, "f32",
     dict(quant_bits=4, q_offset=6, valid=np.asarray([10, 10], np.int32))),
    ("window-qb4", 2, 16, 16, 4, 4, 16, "f32", dict(quant_bits=4, local_window=5)),
    ("window-softcap-qb0", 2, 16, 16, 4, 4, 16, "f32",
     dict(quant_bits=0, local_window=5, logit_softcap=3.0)),
    ("noncausal-qb3", 2, 9, 9, 2, 1, 16, "f32", dict(quant_bits=3, causal=False)),
]


def _run_both(B, Sq, Sk, H, KVH, hd, kv, kw, seed):
    rng = np.random.default_rng(seed)
    q, k, v, ks, vs = _inputs(rng, B, Sq, Sk, H, KVH, hd, kv)
    kw = dict(kw)
    segs, valid = kw.pop("segs", None), kw.pop("valid", None)
    off = kw.pop("q_offset", 0)
    common = dict(causal=kw.pop("causal", True), **kw)
    jout = jref.flash_attention_ref(
        jnp.asarray(q), _to_jax(k, kv), _to_jax(v, kv),
        q_offset=jnp.asarray(off) if isinstance(off, np.ndarray) else off,
        k_scale=_to_jax(ks, kv), v_scale=_to_jax(vs, kv),
        kv_valid_len=None if valid is None else jnp.asarray(valid),
        q_segment_ids=None if segs is None else jnp.asarray(segs), **common)
    tout = ops.attention(
        torch.from_numpy(q), _to_torch(k, kv), _to_torch(v, kv),
        q_offset=torch.from_numpy(off) if isinstance(off, np.ndarray) else off,
        k_scale=_to_torch(ks, kv), v_scale=_to_torch(vs, kv),
        kv_valid_len=None if valid is None else torch.from_numpy(valid),
        q_segment_ids=None if segs is None else torch.from_numpy(segs), **common)
    return (q, k, v, ks, vs, off, valid, segs, common), np.asarray(jout), tout.numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attention_plain_version_matches_reference(case):
    _, B, Sq, Sk, H, KVH, hd, kv, kw = case
    _, jout, tout = _run_both(B, Sq, Sk, H, KVH, hd, kv, kw, seed=B * Sq + Sk)
    assert tout.dtype == np.float32 and tout.shape == (B, Sq, H, hd)
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)


def test_fully_masked_rows_give_exact_zeros():
    """Pad-tail rows whose id matches no key (q -1 against k -2) come out
    exactly 0 in both frameworks, never NaN."""
    rng = np.random.default_rng(3)
    q, k, v, _, _ = _inputs(rng, 1, 8, 8, 2, 2, 16, "f32")
    qseg = np.asarray([[0, 0, 0, 1, 1, -1, -1, -1]], np.int32)
    kseg = np.asarray([[0, 0, 0, 1, 1, -2, -2, -2]], np.int32)
    for qb in (0, 4):
        got = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            quant_bits=qb, q_segment_ids=torch.from_numpy(qseg),
                            kv_segment_ids=torch.from_numpy(kseg)).numpy()
        want = np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), quant_bits=qb,
            q_segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg)))
        assert (got[0, 5:] == 0).all() and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["packed-prefill-int8-qb4", "decode-int8-qb4-per-row"])
def test_attention_plain_version_matches_pallas_kernel(name):
    """The Pallas kernel itself (interpret mode), at a packed-prefill and a
    per-slot decode shape."""
    _, B, Sq, Sk, H, KVH, hd, kv, kw = next(c for c in CASES if c[0] == name)
    (q, k, v, ks, vs, off, valid, segs, common), _, tout = _run_both(
        B, Sq, Sk, H, KVH, hd, kv, kw, seed=B * Sq + Sk)
    kout = jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(off) if isinstance(off, np.ndarray) else off,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        kv_valid_len=None if valid is None else jnp.asarray(valid),
        q_segment_ids=None if segs is None else jnp.asarray(segs),
        block_q=16, block_k=16, interpret=True, **common)
    np.testing.assert_allclose(tout, np.asarray(kout), atol=1e-5, rtol=0)


@pytest.mark.parametrize("G,Din,Dout,sizes", [
    (4, 64, 96, [40, 0, 17, 71]),
    (8, 33, 48, [0, 0, 5, 0, 23, 1, 0, 16]),  # odd Din: the pad nibble
    (3, 32, 48, [0, 0, 0]),  # nothing routed
])
def test_grouped_w4a8_matches_reference_bit_for_bit(G, Din, Dout, sizes):
    rng = np.random.default_rng(G + Din)
    T = sum(sizes)
    gs = np.asarray(sizes, np.int32)
    x = rng.integers(-127, 128, (T, Din)).astype(np.int8)
    w4 = rng.integers(-8, 8, (G, Din, Dout)).astype(np.int8)
    packed = pack_int4(torch.from_numpy(w4)).numpy()
    ws = rng.uniform(1e-4, 1e-2, (G, Dout)).astype(np.float32)
    a_s = np.float32(0.02)
    want = jref.grouped_matmul_q4_ref(jnp.asarray(x), jnp.asarray(packed),
                                      jnp.asarray(gs), jnp.asarray(ws), jnp.asarray(a_s))
    args = (torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(gs))
    plain = ref.grouped_matmul_q4_ref(*args, torch.from_numpy(ws), torch.tensor(a_s))
    via_ops = ops.grouped_matmul(*args, w_scale=torch.from_numpy(ws),
                                 a_scale=torch.tensor(a_s))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    np.testing.assert_array_equal(via_ops.numpy(), np.asarray(want))
    assert via_ops.shape == (T, Dout)


def test_grouped_w4a8_quantizes_fp_rows_like_reference():
    """fp rows against a packed stack are quantized with the folded scale
    first, exactly as the reference's ops.grouped_matmul does."""
    rng = np.random.default_rng(11)
    gs = np.asarray([6, 0, 9], np.int32)
    x = rng.standard_normal((15, 32)).astype(np.float32)
    packed = pack_int4(torch.from_numpy(
        rng.integers(-8, 8, (3, 32, 24)).astype(np.int8))).numpy()
    ws = rng.uniform(1e-3, 1e-2, (3, 24)).astype(np.float32)
    a_s = np.float32(0.03)
    want = jops.grouped_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(gs),
                               w_scale=jnp.asarray(ws), a_scale=jnp.asarray(a_s))
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                             torch.from_numpy(gs), w_scale=torch.from_numpy(ws),
                             a_scale=torch.tensor(a_s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="activation scale"):
        ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                           torch.from_numpy(gs), w_scale=torch.from_numpy(ws))
