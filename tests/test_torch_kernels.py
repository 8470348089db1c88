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
The LM attention modes and grouped W4A8 are held in
tests/test_torch_attention.py.
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

from repro_torch.kernels import expert_linear as gm
from repro_torch.kernels import ops
from repro_torch.kernels.expert_linear import grouped_matmul, route_metadata
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.norm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.quant_attention import lm_attention, streaming_attention
from repro_torch.kernels.selective_scan import selective_scan as scan_kernel


def _i8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("M,K,N,bias", [
    (37, 64, 10, False),  # ragged M and N (10 classes)
    (17, 64, 16, True),  # the 16-expert gate width
    (1, 128, 64, False),  # one row (bucket of 1, head)
    (40, 96, 130, True),
    (16, 64, 24, True),  # the last M of the streaming variant, N % 16 == 8
    (17, 64, 24, False),  # the first M of the tensor-core variant
    (9, 100, 40, True),  # K % 16 != 0 (the dp4a variant)
    (33, 48, 73, False),  # N % 8 != 0 (the dp4a variant)
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


@pytest.mark.parametrize("qb", [0, 4])
def test_causal_attention_on_cpu_matches_reference(qb):
    """Causal attention of CPU tensors runs the plain version (the LM
    kernel's CPU path) and matches the reference oracle."""
    rng = np.random.default_rng(qb)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, quant_bits=qb)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=True, quant_bits=qb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("call", [
    lambda: int8_matmul(torch.zeros((2, 4), dtype=torch.int8),
                        torch.zeros((4, 3), dtype=torch.int8), 1.0, torch.ones(3)),
    lambda: grouped_matmul(torch.zeros((2, 4)), torch.zeros((1, 4, 3)),
                           torch.tensor([2], dtype=torch.int32)),
    lambda: grouped_matmul(torch.zeros((2, 4), dtype=torch.int8),
                           torch.zeros((1, 2, 3), dtype=torch.uint8),
                           torch.tensor([2], dtype=torch.int32)),
    lambda: streaming_attention(torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8)),
                                torch.zeros((1, 4, 2, 8)), quant_bits=4),
    lambda: lm_attention(torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8), dtype=torch.int8),
                         torch.zeros((1, 4, 2, 8), dtype=torch.int8), quant_bits=4,
                         k_scale=torch.ones((1, 4, 2)), v_scale=torch.ones((1, 4, 2))),
    lambda: scan_kernel(*[torch.zeros(s) for s in ((1, 4, 8), (1, 4, 8), (1, 4, 16),
                                                   (1, 4, 16))],
                        torch.zeros((8, 16)), torch.zeros(8), layout=(4, 4)),
    lambda: rmsnorm_kernel(torch.zeros((3, 8)), torch.zeros(8)),
    lambda: scan_kernel(*[torch.zeros(s, dtype=torch.bfloat16) for s in
                          ((1, 4, 8), (1, 4, 8), (1, 4, 12), (1, 4, 12))],
                        torch.zeros((8, 12)), torch.zeros(8)),
], ids=["int8_matmul", "grouped_matmul", "grouped_matmul_w4a8", "streaming_attention",
        "lm_attention", "selective_scan_layout", "rmsnorm", "selective_scan_bf16"])
def test_kernel_wrappers_launch_only_on_cuda_tensors(call):
    """A kernel wrapper never falls back to its plain version: given CPU
    tensors it refuses (ops routes CPU tensors to the plain versions)."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_cpu_tensors_never_reach_a_kernel():
    kernels = (int8_matmul, grouped_matmul, streaming_attention, lm_attention,
               rmsnorm_kernel, scan_kernel)
    counts = [f.launches for f in kernels]
    x = torch.zeros((1, 4, 2, 8))
    x8, s = torch.zeros((1, 4, 2, 8), dtype=torch.int8), torch.ones((1, 4, 2))
    ops.attention(x, x, x, causal=False, quant_bits=4)
    ops.attention(x, x, x, causal=True, quant_bits=0)
    ops.attention(x, x8, x8, quant_bits=4, k_scale=s, v_scale=s,
                  q_offset=torch.tensor([2]), kv_valid_len=torch.tensor([3]))
    ops.int8_matmul(torch.zeros((2, 4), dtype=torch.int8),
                    torch.zeros((4, 3), dtype=torch.int8), torch.tensor(1.0),
                    torch.ones(3))
    ops.grouped_matmul(torch.zeros((2, 4)), torch.zeros((1, 4, 3)),
                       torch.tensor([2], dtype=torch.int32))
    ops.grouped_matmul(torch.zeros((2, 4)), torch.zeros((1, 2, 3), dtype=torch.uint8),
                       torch.tensor([2], dtype=torch.int32), w_scale=torch.ones((1, 3)),
                       a_scale=torch.tensor(0.1))
    ops.rmsnorm(torch.zeros((2, 8)), torch.zeros(8))
    ops.selective_scan(*[torch.zeros(s) for s in ((1, 3, 4), (1, 3, 4), (1, 3, 12), (1, 3, 12),
                                                  (4, 12), (4,))])
    assert counts == [f.launches for f in kernels]


@pytest.mark.parametrize("source,mode", [
    ("int8_matmul.cu", ""), ("grouped_matmul.cu", ""), ("grouped_matmul.cu", "W4A8"),
    ("quant_attention.cu", ""), ("lm_attention.cu", ""), ("int8_mma.cuh", ""),
    ("int8_matmul.cu", "mma"), ("int8_matmul.cu", "stream"), ("int8_matmul.cu", "dp4a"),
    ("grouped_matmul.cu", "mma"), ("grouped_matmul.cu", "stream"),
    ("grouped_matmul.cu", "dp4a"), ("lm_attention.cu", "decode"),
    ("lm_attention.cu", "tile"), ("selective_scan.cu", ""), ("selective_scan.cu", "states"),
    ("selective_scan.cu", "lane"), ("quant_attention.cu", "tile"),
    ("quant_attention.cu", "shared memory"), ("rmsnorm.cu", ""), ("rmsnorm.cu", "registers"),
])
def test_kernel_sources_carry_their_notes(source, mode):
    """Each CUDA source names the TPU kernel it replaces (RMSNorm: the
    reference's plain XLA function), what bounds it on the H100 and what its
    design does about that (for each mode it runs)."""
    import repro_torch.kernels as K

    text = (Path(K.__file__).parent / "csrc" / source).read_text()
    replaced = ("src/repro/models/layers.py:21" if source == "rmsnorm.cu"
                else "src/repro/kernels/")
    assert f"Replaces: {replaced}" in text
    assert "Bound on the H100" in text and "Design:" in text
    assert text.count(mode) >= 3  # named in the summary, the bound and the design


@pytest.mark.parametrize("variant", sorted(i8.VARIANTS))
def test_int8_matmul_notes_cover_each_variant(variant):
    """The head of int8_matmul.cu gives each variant its own bound and
    design; the decode variant's bound is the weight bytes."""
    import repro_torch.kernels as K

    text = (Path(K.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
    head = text[:text.index("#include")]
    start = head.index(f"// Variant {variant}, {i8.VARIANTS[variant]}")
    nxt = head.find("// Variant ", start + 1)
    note = head[start:nxt if nxt > 0 else len(head)]
    assert "Bound on the H100" in note and "Design:" in note
    if i8.VARIANTS[variant] == "stream":
        assert "weight bytes" in note


@pytest.mark.parametrize("variant", sorted(gm.VARIANTS))
def test_grouped_matmul_notes_cover_each_variant(variant):
    """The head of grouped_matmul.cu gives each variant its own bound and
    design; the decode variant's bound is the active experts' weight
    bytes."""
    import repro_torch.kernels as K

    text = (Path(K.__file__).parent / "csrc" / "grouped_matmul.cu").read_text()
    head = text[:text.index("#include")]
    start = head.index(f"// Variant {variant}, {gm.VARIANTS[variant]}")
    nxt = head.find("// Variant ", start + 1)
    note = head[start:nxt if nxt > 0 else head.index("// W4A8 in variants")]
    assert "Bound on the H100" in note and "Design:" in note
    if gm.VARIANTS[variant] == "stream":
        assert "weight bytes" in note


def _m3vit_int8_shapes(B):
    """(M, K, N) of every int8_matmul call of a full-width M3ViT-S int8
    forward at batch B: q/k/v/o, dense fc1/fc2, the router gate, the head
    (the class token alone)."""
    from repro_torch.configs.moe_vit import CONFIG as cfg

    T, d = cfg.image_tokens * B, cfg.d_model
    return [(T, d, d), (T, d, cfg.d_ff), (T, cfg.d_ff, d), (T, d, cfg.moe.num_experts),
            (B, d, cfg.num_classes)]


def _olmoe_int8_shapes(slots=8, max_len=512):
    """(M, K, N) of every int8_matmul call of the full-width OLMoE-1B-7B
    served as in chip_smoke.py: a packed admission at each bucket of the
    ladder (its LM head over the last token of 1..slots prompts) and a
    decode tick of ``slots`` rows."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ContinuousBatchingConfig
    from repro_torch.serving.engine import _pow2_ladder

    cfg = get_config("olmoe-1b-7b")
    d, a = cfg.d_model, cfg.attn
    q, kv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    layer = lambda m: [(m, d, q), (m, d, kv), (m, d, kv), (m, q, d),  # noqa: E731
                       (m, d, cfg.moe.num_experts)]
    shapes = []
    for m in _pow2_ladder(ContinuousBatchingConfig().min_bucket, max_len):
        shapes += layer(m)
    shapes += [(n, d, cfg.vocab_size) for n in range(1, slots + 1)]
    return shapes + layer(slots) + [(slots, d, cfg.vocab_size)]


@pytest.mark.parametrize("shape", sorted({s for B in (1, 4, 8) for s in _m3vit_int8_shapes(B)}
                                         | set(_olmoe_int8_shapes())))
def test_int8_matmul_main_path_shapes_take_the_new_variants(shape):
    """Every int8_matmul call of the served models goes to the tensor-core
    variant (M > 16) or the weight-streaming one (M <= 16), never dp4a."""
    M, K, N = shape
    v = i8.choose_variant(M, K, N, aligned=True)
    assert v == (2 if M <= 16 else 1)
    assert i8.takes(v, M, K, N) and i8.takes(3, M, K, N)


@pytest.mark.parametrize("M,K,N,aligned", [
    (8, 100, 64, True), (197, 100, 384, True),  # K % 16 != 0
    (8, 384, 10, True), (197, 384, 1001, True),  # N % 8 != 0
    (8, 384, 384, False), (1576, 384, 1536, False),  # an operand off the 16-byte grid
])
def test_int8_matmul_ragged_or_misaligned_shapes_take_dp4a(M, K, N, aligned):
    assert i8.choose_variant(M, K, N, aligned) == 3
    assert not i8.takes(1, M, K, N, aligned) and not i8.takes(2, M, K, N, aligned)


def test_int8_matmul_variant_eligibility():
    assert i8.choose_variant(16, 384, 1000) == 2 and i8.choose_variant(17, 384, 1000) == 1
    assert i8.takes(1, 8, 2048, 2048)  # the tensor-core variant takes any M
    assert not i8.takes(2, 17, 2048, 2048)  # streaming holds <= 16 rows
    assert not i8.takes(4, 8, 64, 64)


@pytest.mark.parametrize("M,N,tile", [
    (1576, 1536, (128, 128)),  # M3ViT-S fc1, B = 8: 156 blocks
    (1576, 384, (64, 64)),  # q/k/v/o: 39 blocks at 128 x 128, 150 at 64 x 64
    (512, 2048, (64, 64)),  # OLMoE q/k/v/o prefill
    (512, 50304, (128, 128)),  # OLMoE LM head, 512 rows
    (512, 64, (32, 64)),  # a gate: the smallest tile
    (197, 16, (32, 64)),
])
def test_int8_matmul_mma_tile_fills_the_card(M, N, tile):
    """The tensor-core variant takes the largest tile that still gives
    each of the H100's 132 SMs a block."""
    cfg = i8.mma_config(M, N)
    assert i8.MMA_TILES[cfg] == tile
    bm, bn = tile
    blocks = -(-M // bm) * -(-N // bn)
    assert blocks >= i8.H100_SMS or cfg == len(i8.MMA_TILES) - 1
    for bigger in i8.MMA_TILES[:cfg]:
        assert -(-M // bigger[0]) * -(-N // bigger[1]) < i8.H100_SMS


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 64), (2048, 50304), (384, 1000),
                                 (1536, 384), (384, 16), (48, 64), (0, 64), (100 * 16, 8)])
def test_int8_matmul_stream_split_covers_k_once(K, N):
    """Variant 2 splits the 64-deep k tiles over gridDim.y: every tile in
    exactly one split, no split empty, and about two blocks a SM when the
    columns alone would not fill the card."""
    splits, per = i8.stream_split(K, N)
    ktiles = -(-K // i8.K_TILE)
    strips = -(-N // i8.STREAM_N)
    assert splits >= 1
    if ktiles:
        assert (splits - 1) * per < ktiles <= splits * per
        assert splits * strips >= min(2 * i8.H100_SMS, ktiles * strips) // 2
    else:
        assert (splits, per) == (1, 0)
    if strips >= 2 * i8.H100_SMS:
        assert splits == 1  # the wide LM head streams whole columns: no atomics


def test_c_entry_points_match_their_ctypes_signatures():
    """Each ``extern "C"`` function of csrc/ takes as many arguments as
    ``_build._SIGNATURES`` hands it (ctypes would pass a wrong count
    silently), and every entry point bound exists."""
    import re

    import repro_torch.kernels as K
    from repro_torch.kernels import _build

    found = {}
    for cu in (Path(K.__file__).parent / "csrc").glob("*.cu"):
        for name, params in re.findall(r'extern "C" \w+ (\w+)\(([^)]*)\)', cu.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert set(found) == set(_build._SIGNATURES)
    for name, (_, argtypes) in _build._SIGNATURES.items():
        assert found[name] == len(argtypes), name


def _ldmatrix_x4(smem, addrs, trans):
    """``ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16``: lane t names
    row t % 8 of matrix t // 8; returns each lane's four words as bytes."""
    out = np.zeros((32, 4, 4), np.int8)
    for q in range(4):
        m = np.stack([smem[a:a + 16].view(np.int16) for a in addrs[8 * q:8 * q + 8]])
        for t in range(32):
            pair = m[t // 4, 2 * (t % 4):2 * (t % 4) + 2] if not trans else \
                np.array([m[2 * (t % 4), t // 4], m[2 * (t % 4) + 1, t // 4]], np.int16)
            out[t, q] = pair.view(np.int8)
    return out


def _byte_perm(a, b, sel):
    src = np.concatenate([a, b])
    return np.array([src[(sel >> (4 * i)) & 0xF] for i in range(4)], np.int8)


def _worst_bank_conflict(addr_groups):
    """Most 4-byte accesses to one bank in any group of eight 16-byte
    accesses (one shared-memory phase)."""
    worst = 1
    for group in addr_groups:
        banks = [(a // 4 + i) % 32 for a in group for i in range(4)]
        worst = max(worst, max(banks.count(b) for b in banks))
    return worst


@pytest.mark.parametrize("BN", [64, 128])
def test_int8_mma_fragment_layout_is_exact_and_conflict_free(BN):
    """An emulation of csrc/int8_mma.cuh's layout algebra: x and w tiles
    stored with the header's swizzles (swz_a, swz_b), A fragments by
    ldmatrix, B fragments by ldmatrix.trans over the permuted k rows and
    byte_perm 0x6420 / 0x7531, the m16n8k32 products of the even and odd
    column tiles, and the flush's column map (even d0, odd d0, even d1,
    odd d1 = columns 4t .. 4t+3) give x @ w exactly; every ldmatrix phase
    and every 8-lane cp.async phase touches distinct banks."""
    rng = np.random.default_rng(BN)
    BK = i8.K_TILE
    x = rng.integers(-128, 128, (16, BK)).astype(np.int8)
    w = rng.integers(-128, 128, (BK, BN)).astype(np.int8)
    swz_a = lambda r, c: c ^ ((r >> 1) & 3)  # noqa: E731
    swz_b = (lambda r, c: c ^ ((r & 1) | ((r >> 1) & 6))) if BN == 128 else \
        (lambda r, c: c ^ ((r >> 2) & 3))
    sa, sb = np.zeros(16 * BK, np.int8), np.zeros(BK * BN, np.int8)
    for r in range(16):
        for c in range(BK // 16):
            sa[r * BK + 16 * swz_a(r, c):][:16] = x[r, 16 * c:16 * c + 16]
    for r in range(BK):
        for c in range(BN // 16):
            sb[r * BN + 16 * swz_b(r, c):][:16] = w[r, 16 * c:16 * c + 16]
    acc = np.zeros((16, BN), np.int64)
    phases = []
    for kk in (0, 32):
        lanes = [(t // 8, t % 8) for t in range(32)]
        a_addr = [(i + 8 * (q & 1)) * BK + 16 * swz_a(i + 8 * (q & 1), kk // 16 + (q >> 1))
                  for q, i in lanes]
        a = _ldmatrix_x4(sa, a_addr, trans=False)
        phases += [a_addr[8 * q:8 * q + 8] for q in range(4)]
        for c16 in range(BN // 16):
            rows = [kk + 16 * (q >> 1) + 2 * (q & 1) + 4 * (i >> 1) + (i & 1) for q, i in lanes]
            b_addr = [r * BN + 16 * swz_b(r, c16) for r in rows]
            b = _ldmatrix_x4(sb, b_addr, trans=True)
            phases += [b_addr[8 * q:8 * q + 8] for q in range(4)]
            A = np.zeros((16, 32), np.int64)
            even, odd = np.zeros((32, 8), np.int64), np.zeros((32, 8), np.int64)
            for t in range(32):
                g, k4 = t // 4, 4 * (t % 4)
                A[g, k4:k4 + 4], A[g + 8, k4:k4 + 4] = a[t, 0], a[t, 1]
                A[g, 16 + k4:20 + k4], A[g + 8, 16 + k4:20 + k4] = a[t, 2], a[t, 3]
                even[k4:k4 + 4, g] = _byte_perm(b[t, 0], b[t, 1], 0x6420)
                even[16 + k4:20 + k4, g] = _byte_perm(b[t, 2], b[t, 3], 0x6420)
                odd[k4:k4 + 4, g] = _byte_perm(b[t, 0], b[t, 1], 0x7531)
                odd[16 + k4:20 + k4, g] = _byte_perm(b[t, 2], b[t, 3], 0x7531)
            de, do = A @ even, A @ odd
            for t in range(32):
                g, tc = t // 4, t % 4
                for r in (g, g + 8):
                    acc[r, 16 * c16 + 4 * tc:][:4] += [de[r, 2 * tc], do[r, 2 * tc],
                                                       de[r, 2 * tc + 1], do[r, 2 * tc + 1]]
    np.testing.assert_array_equal(acc, x.astype(np.int64) @ w.astype(np.int64))
    assert _worst_bank_conflict(phases) == 1
    stores = [[r * BN + 16 * swz_b(r, c) for r, c in
               [divmod(e, BN // 16) for e in range(p, p + 8)]] for p in range(0, BK * BN // 16, 8)]
    stores += [[r * BK + 16 * swz_a(r, c) for r, c in
                [divmod(e, BK // 16) for e in range(p, p + 8)]] for p in range(0, 16 * BK // 16, 8)]
    assert _worst_bank_conflict(stores) == 1


# (T, G, Din, Dout) of the grouped calls on the served paths: OLMoE-1B-7B
# expert fc1 (2048 -> 2 x 1024) and fc2 (1024 -> 2048) at decode ticks of
# 1..8 slots (top 8) and at a 512-token packed prefill; M3ViT-S expert fc1 /
# fc2 (top 2 of 16) at batches 1, 4 and 8
GROUPED_PATH = ([(8 * s, 64, din, dout) for s in range(1, 9)
                 for din, dout in ((2048, 2048), (1024, 2048))]
                + [(4096, 64, 2048, 2048), (4096, 64, 1024, 2048)]
                + [(2 * 197 * b, 16, din, dout) for b in (1, 4, 8)
                   for din, dout in ((384, 1536), (1536, 384))])


@pytest.mark.parametrize("T,G,Din,Dout", GROUPED_PATH)
def test_grouped_variant_on_the_path(T, G, Din, Dout):
    """Decode ticks stream each active expert's weight (a few rows a
    group); prefill and vision take the MMA tiles; never dp4a."""
    v = gm.choose_variant(T, G, Din, Dout, aligned=True)
    assert v == (2 if T <= 64 else 1)
    assert gm.takes(v, Din, Dout) and gm.takes(3, Din, Dout)


@pytest.mark.parametrize("T,G,Din,Dout,aligned", [
    (64, 64, 100, 2048, True), (4096, 64, 65, 2048, True),  # Din % 16 != 0 (odd: W4A8 pad)
    (64, 64, 2048, 10, True), (394, 16, 384, 1001, True),  # Dout % 8 != 0
    (64, 64, 2048, 2048, False), (3152, 16, 384, 1536, False),  # off the 16-byte grid
])
def test_grouped_ragged_or_misaligned_shapes_take_dp4a(T, G, Din, Dout, aligned):
    assert gm.choose_variant(T, G, Din, Dout, aligned) == 3
    assert not gm.takes(1, Din, Dout, aligned) and not gm.takes(2, Din, Dout, aligned)


def _block_scan(values, threads):
    """block_scan over the block's threads in order: exclusive prefix and
    the total, a warp's inclusive scan then the warps' sums."""
    assert len(values) == threads
    incl = np.cumsum(values)
    return list(incl - np.asarray(values)), int(incl[-1]) if threads else 0


def _find_item(sizes, T, w, threads, block_m=64):
    """grouped_matmul.cu's find_item for block w, step by step: chunks of
    ``threads`` groups, a scan of the sizes (first rows), a scan of the
    items each group holds (first items); the thread whose range holds w
    publishes (g, m0, lo, hi)."""
    G = len(sizes)
    found = (0, 0, 0, 0)
    rows_before = items_before = 0
    for c0 in range(0, G, threads):
        size = [max(sizes[c0 + i], 0) if c0 + i < G else 0 for i in range(threads)]
        starts, rows_total = _block_scan(size, threads)
        items = []
        for i in range(threads):
            start = rows_before + starts[i]
            first = start // block_m
            items.append((start + size[i] - 1) // block_m - first + 1 if size[i] > 0 else 0)
        i0s, items_total = _block_scan(items, threads)
        for i in range(threads):
            start, i0 = rows_before + starts[i], items_before + i0s[i]
            if i0 <= w < i0 + items[i]:
                first = start // block_m
                m0 = (first + w - i0) * block_m
                found = (c0 + i, m0, max(start, m0), min(start + size[i], m0 + block_m, T))
        rows_before += rows_total
        items_before += items_total
    return found


WORK_CASES = [
    [40, 0, 17, 71], [0, 0, 5, 0, 123, 1, 0, 16], [0, 0, 0], [130], [0, 130, 0, 0],
    [3, 60, 1, 64, 0, 2], [1] * 64, [0] * 20 + [64, 65] + [0] * 20,
    [7] * 300,  # more groups than a block has threads: two chunks
]


@pytest.mark.parametrize("sizes", WORK_CASES)
@pytest.mark.parametrize("threads", [128, 256])
def test_grouped_work_derived_in_the_block_is_the_reference_table(sizes, threads):
    """The work item each block of variants 1 and 3 (and the f32 mode)
    derives from group_sizes is the reference's _route_metadata table,
    item by item, with empty ranges past the last item; every output row is
    written by exactly one item."""
    gs = np.asarray(sizes, np.int32)
    T, G = int(gs.sum()), len(sizes)
    n_work = -(-T // 64) + G  # the launch's grid
    g_ids, m_ids, row_start, row_end = (np.asarray(a) for a in jax_route_metadata(
        jnp.asarray(gs), 64, n_work))
    port = [a.numpy() for a in route_metadata(torch.from_numpy(gs), 64, n_work)]
    for a, b in zip(port, (g_ids, m_ids, row_start, row_end)):
        np.testing.assert_array_equal(a, b)
    written = np.zeros(T, np.int64)
    for w in range(n_work):
        g, m0, lo, hi = _find_item(sizes, T, w, threads)
        ref_lo = max(row_start[w], m_ids[w] * 64)
        ref_hi = min(row_end[w], m_ids[w] * 64 + 64)
        if ref_lo >= ref_hi:  # a padding item: the block writes nothing
            assert lo >= hi
            continue
        assert (g, m0, lo, hi) == (g_ids[w], m_ids[w] * 64, ref_lo, ref_hi)
        written[lo:hi] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("sizes", WORK_CASES + [[3, 0, 40, 1, 0, 16, 17, 0]])
def test_grouped_stream_blocks_read_each_active_strip_once(sizes):
    """Variant 2's grid is (strips, G): a block of an empty expert returns
    before reading; the others find their first row as the sum of the sizes
    before them and take the group's rows 16 at a time, so every row is
    written once and an expert of <= 16 rows reads its strip once."""
    T, Dout = sum(sizes), 128
    strips = -(-Dout // 64)
    written = np.zeros((T, strips), np.int64)
    reads = np.zeros((len(sizes), strips), np.int64)
    for g, size in enumerate(sizes):
        for n in range(strips):
            if size <= 0:
                continue
            # rows_before: thread t sums sizes t, t + 256, ... below g
            parts = [sum(sizes[i] for i in range(t, g, 256)) for t in range(256)]
            start = _block_scan(parts, 256)[1]
            assert start == sum(sizes[:g])
            for lo in range(start, min(start + size, T), 16):
                reads[g, n] += 1
                written[lo:min(start + size, T, lo + 16), n] += 1
    assert (written == 1).all()
    active = np.asarray(sizes) > 0
    np.testing.assert_array_equal(reads[active], -(-np.asarray(sizes)[active, None] // 16)
                                  * np.ones((1, strips), np.int64))
    assert (reads[~active] == 0).all()
    assert (reads[np.asarray(sizes) <= 16] <= 1).all()


def _unpack_word(b):
    """grouped_matmul.cu's unpack_word on a uint32: low and high nibbles,
    0xF0 ORed into each byte whose bit 3 is set."""
    lo, hi = b & 0x0F0F0F0F, (b >> 4) & 0x0F0F0F0F
    return (lo | (((lo & 0x08080808) >> 3) * 0xF0),
            hi | (((hi & 0x08080808) >> 3) * 0xF0))


@pytest.mark.parametrize("threads", [128, 256])
def test_w4a8_stage_unpack_feeds_the_int8_fragments_exactly(threads):
    """An emulation of unpack_stage: a landed packed stage (32 rows x 64
    columns of nibble pairs) unpacked by each thread into the even and odd
    rows of the swizzled s8 B tile, then read by the int8_mma.cuh fragment
    emulation (ldmatrix.trans + byte_perm, m16n8k32 products): exactly x @
    unpack_int4(w); every 8-thread phase of the 16-byte stores hits 32
    banks."""
    from repro_torch.core.quant.qtypes import pack_int4, unpack_int4

    rng = np.random.default_rng(threads)
    BK, BN = i8.K_TILE, 64
    w4 = rng.integers(-8, 8, (BK, BN)).astype(np.int8)
    packed = pack_int4(torch.from_numpy(w4)).numpy()  # [32, 64] uint8
    x = rng.integers(-128, 128, (16, BK)).astype(np.int8)
    swz_b = lambda r, c: c ^ ((r >> 2) & 3)  # noqa: E731
    sb = np.zeros(BK * BN, np.uint8)
    stores = []
    for tid in range(threads):
        phase = []
        for e in range(tid, (BK // 2) * (BN // 16), threads):
            p, c = e >> 2, e & 3
            words = packed[p, 16 * c:16 * c + 16].view(np.uint32)
            lo, hi = zip(*(_unpack_word(int(v)) for v in words))
            lo = np.asarray(lo, np.uint32).view(np.uint8)
            hi = np.asarray(hi, np.uint32).view(np.uint8)
            r0, r1 = 2 * p + (p & 1), 2 * p + 1 - (p & 1)
            for r, data in ((r0, hi if p & 1 else lo), (r1, lo if p & 1 else hi)):
                sb[r * BN + 16 * swz_b(r, c):][:16] = data
                phase.append(r * BN + 16 * swz_b(r, c))
        stores.append(phase)
    # the unpacked tile is the s8 weight, swizzled as int8_mma.cuh lays it
    want = unpack_int4(torch.from_numpy(packed), BK).numpy()
    np.testing.assert_array_equal(want, w4)
    for r in range(BK):
        for c in range(BN // 16):
            np.testing.assert_array_equal(
                sb[r * BN + 16 * swz_b(r, c):][:16].view(np.int8), w4[r, 16 * c:16 * c + 16])
    # each store instruction (first, then second) of 8 consecutive threads
    for k in range(2):
        groups = [[stores[t][k] for t in range(p0, p0 + 8) if len(stores[t]) > k]
                  for p0 in range(0, threads, 8)]
        assert _worst_bank_conflict([g for g in groups if g]) == 1
    # the fragments of the unpacked tile give the exact product
    acc = np.zeros((16, BN), np.int64)
    sbi = sb.view(np.int8)
    for kk in (0, 32):
        lanes = [(t // 8, t % 8) for t in range(32)]
        for c16 in range(BN // 16):
            rows = [kk + 16 * (q >> 1) + 2 * (q & 1) + 4 * (i >> 1) + (i & 1) for q, i in lanes]
            b = _ldmatrix_x4(sbi, [r * BN + 16 * swz_b(r, c16) for r in rows], trans=True)
            for t in range(32):
                g, tc = t // 4, t % 4
                k4 = 4 * tc
                for half, (b0, b1) in enumerate(((b[t, 0], b[t, 1]), (b[t, 2], b[t, 3]))):
                    ev = _byte_perm(b0, b1, 0x6420).astype(np.int64)
                    od = _byte_perm(b0, b1, 0x7531).astype(np.int64)
                    col_e, col_o = 16 * c16 + 2 * g, 16 * c16 + 2 * g + 1
                    ks = slice(kk + 16 * half + k4, kk + 16 * half + k4 + 4)
                    np.testing.assert_array_equal(ev, w4[ks, col_e])
                    np.testing.assert_array_equal(od, w4[ks, col_o])
                    acc[:, col_e] += x[:, ks].astype(np.int64) @ ev
                    acc[:, col_o] += x[:, ks].astype(np.int64) @ od
    # each (k, column) pair is fed by exactly one lane and k half
    np.testing.assert_array_equal(acc, x.astype(np.int64) @ w4.astype(np.int64))
