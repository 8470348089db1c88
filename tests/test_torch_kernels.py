"""The port's kernel modules against the JAX reference on the CPU.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain version;
these tests hold those against the reference's Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) and its ``kernels/ref.py``
oracles, on the same numpy inputs. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.

Tolerances:
  * int8 matmul and grouped int8: bit-equal (exact integer accumulation,
    the same rescale order), including ragged N, empty groups and T = 0;
  * grouped fp32: atol 1e-5 (f32 sums in another order);
  * attention, quant_bits=4: atol 1e-4. The score dot products run in
    another order, which can move a score across a .5 code boundary and
    change that key's weight by a factor of sqrt(2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pathlib import Path

from repro.kernels import ref as jref
from repro.kernels.expert_linear import _route_metadata as jax_route_metadata
from repro.kernels.expert_linear import grouped_matmul as jax_grouped_matmul
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro.kernels.quant_attention import streaming_attention as jax_attention

from repro_torch.kernels import ops
from repro_torch.kernels.expert_linear import grouped_matmul, route_metadata
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.quant_attention import streaming_attention


def _i8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("M,K,N,bias", [
    (37, 64, 10, False),  # ragged M and N (10 classes)
    (17, 64, 16, True),  # the 16-expert gate width
    (1, 128, 64, False),  # one row (bucket of 1, head)
    (40, 96, 130, True),
])
def test_int8_matmul_matches_reference_bit_for_bit(M, K, N, bias):
    rng = np.random.default_rng(M + K + N)
    x, w = _i8(rng, M, K), _i8(rng, K, N)
    xs = np.float32(rng.uniform(1e-3, 5e-2))
    ws = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    j_kernel = jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs),
                               jnp.asarray(ws), jb, block_m=16, block_n=32,
                               block_k=32, interpret=True)
    j_ref = jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs),
                                 jnp.asarray(ws), jb)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.tensor(xs),
            torch.from_numpy(ws))
    port = ops.int8_matmul(*args, None if b is None else torch.from_numpy(b))
    if b is None:
        np.testing.assert_array_equal(port.numpy(), np.asarray(j_ref))
        np.testing.assert_array_equal(port.numpy(), np.asarray(j_kernel))
    else:
        # the bias is a separate rounded add after the rescale (the CUDA
        # flush uses __fadd_rn); XLA on the CPU may contract the reference's
        # multiply-add into one FMA, a last-bit difference
        np.testing.assert_array_equal(
            port.numpy(), (ops.int8_matmul(*args) + torch.from_numpy(b)).numpy())
        np.testing.assert_allclose(port.numpy(), np.asarray(j_ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port.numpy(), np.asarray(j_kernel), rtol=1e-6,
                                   atol=1e-6)


GROUP_CASES = [
    (4, 64, 96, [40, 0, 17, 71]),
    (1, 64, 64, [130]),  # dense mode
    (8, 32, 32, [0, 0, 5, 0, 123, 1, 0, 16]),  # mostly-empty groups
    (3, 32, 48, [0, 0, 0]),  # nothing routed: T = 0
    (5, 64, 64, [0, 300, 0, 0, 1]),
]


@pytest.mark.parametrize("G,Din,Dout,sizes", GROUP_CASES)
@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_grouped_matmul_matches_reference(G, Din, Dout, sizes, mode):
    rng = np.random.default_rng(G * 7 + Din)
    T = sum(sizes)
    gs = np.asarray(sizes, np.int32)
    if mode == "int8":
        x, w = _i8(rng, T, Din), _i8(rng, G, Din, Dout)
        ws = rng.uniform(1e-4, 1e-2, (G, Dout)).astype(np.float32)
        a_s = np.float32(0.02)
        j_kernel = jax_grouped_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), w_scale=jnp.asarray(ws),
            a_scale=jnp.asarray(a_s), block_m=32, block_n=128, interpret=True)
        j_ref = jref.grouped_matmul_q_ref(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(gs), jnp.asarray(ws),
                                          jnp.asarray(a_s))
        port = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(gs), w_scale=torch.from_numpy(ws),
                                  a_scale=torch.tensor(a_s))
        np.testing.assert_array_equal(port.numpy(), np.asarray(j_ref))
        np.testing.assert_array_equal(port.numpy(), np.asarray(j_kernel))
    else:
        x = rng.standard_normal((T, Din)).astype(np.float32)
        w = (rng.standard_normal((G, Din, Dout)) / np.sqrt(Din)).astype(np.float32)
        j_kernel = jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                                      block_m=32, block_n=128, interpret=True)
        port = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(gs))
        np.testing.assert_allclose(port.numpy(), np.asarray(j_kernel), atol=1e-5)
    assert port.shape == (T, Dout)


def test_grouped_matmul_quantizes_fp_rows_with_the_folded_scale():
    """fp rows against int8 weights are quantized with ``a_scale`` first,
    exactly as the reference's ops.grouped_matmul does."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(5)
    gs = np.asarray([3, 0, 9], np.int32)
    x = rng.standard_normal((12, 32)).astype(np.float32)
    w = _i8(rng, 3, 32, 24)
    ws = rng.uniform(1e-3, 1e-2, (3, 24)).astype(np.float32)
    a_s = np.float32(0.03)
    want = jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                               w_scale=jnp.asarray(ws), a_scale=jnp.asarray(a_s))
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(gs), w_scale=torch.from_numpy(ws),
                             a_scale=torch.tensor(a_s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sizes,block_m", [
    ([40, 0, 17, 71], 64), ([0, 0, 5, 0, 123, 1, 0, 16], 64), ([0, 0, 0], 64),
    ([130], 32), ([3, 60, 1, 64, 0, 2], 16),
])
def test_route_metadata_matches_reference(sizes, block_m):
    """The work table the CUDA kernel walks is the reference's, item by
    item."""
    gs = np.asarray(sizes, np.int32)
    n_work = -(-max(sum(sizes), 1) // block_m) + len(sizes)
    want = jax_route_metadata(jnp.asarray(gs), block_m, n_work)
    got = route_metadata(torch.from_numpy(gs), block_m, n_work)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("B,S,H,KVH,hd,qb", [
    (2, 17, 4, 4, 16, 4),  # the smoke ViT attention
    (1, 33, 4, 2, 32, 4),  # GQA, ragged S
    (2, 24, 2, 2, 16, 3),
    (1, 20, 2, 1, 16, 0),  # unquantized softmax (plain version only)
])
def test_attention_matches_reference(B, S, H, KVH, hd, qb):
    rng = np.random.default_rng(S * H + qb)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_kernel = jax_attention(jq, jk, jv, causal=False, quant_bits=qb,
                             block_q=16, block_k=16, interpret=True)
    j_ref = jref.flash_attention_ref(jq, jk, jv, causal=False, quant_bits=qb)
    port = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=False, quant_bits=qb)
    np.testing.assert_allclose(port.numpy(), np.asarray(j_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.numpy(), np.asarray(j_kernel), atol=1e-4, rtol=0)


def test_causal_attention_is_refused():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError):
        ops.attention(x, x, x, causal=True, quant_bits=4)


@pytest.mark.parametrize("call", [
    lambda: int8_matmul(torch.zeros((2, 4), dtype=torch.int8),
                        torch.zeros((4, 3), dtype=torch.int8), 1.0, torch.ones(3)),
    lambda: grouped_matmul(torch.zeros((2, 4)), torch.zeros((1, 4, 3)),
                           torch.tensor([2], dtype=torch.int32)),
    lambda: streaming_attention(torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8)),
                                torch.zeros((1, 4, 2, 8)), quant_bits=4),
], ids=["int8_matmul", "grouped_matmul", "streaming_attention"])
def test_kernel_wrappers_launch_only_on_cuda_tensors(call):
    """A kernel wrapper never falls back to its plain version: given CPU
    tensors it refuses (ops routes CPU tensors to the plain versions)."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_cpu_tensors_never_reach_a_kernel():
    counts = [f.launches for f in (int8_matmul, grouped_matmul, streaming_attention)]
    x = torch.zeros((1, 4, 2, 8))
    ops.attention(x, x, x, quant_bits=4)
    ops.int8_matmul(torch.zeros((2, 4), dtype=torch.int8),
                    torch.zeros((4, 3), dtype=torch.int8), torch.tensor(1.0),
                    torch.ones(3))
    ops.grouped_matmul(torch.zeros((2, 4)), torch.zeros((1, 4, 3)),
                       torch.tensor([2], dtype=torch.int32))
    assert counts == [f.launches
                      for f in (int8_matmul, grouped_matmul, streaming_attention)]


@pytest.mark.parametrize("source", ["int8_matmul.cu", "grouped_matmul.cu",
                                    "quant_attention.cu"])
def test_kernel_sources_carry_their_notes(source):
    """Each CUDA source names the TPU kernel it replaces, what bounds it on
    the H100 and what its design does about that."""
    import repro_torch.kernels as K

    text = (Path(K.__file__).parent / "csrc" / source).read_text()
    assert "Replaces: src/repro/kernels/" in text
    assert "Bound on the H100" in text and "Design:" in text
