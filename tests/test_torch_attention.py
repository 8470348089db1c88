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


# ---------------------------------------------------------------------------
# lm_attention.cu's schedules, emulated: which keys a block walks
# ---------------------------------------------------------------------------

from repro_torch.kernels import quant_attention as qa  # noqa: E402

TILE_KEYS, TILE_ROWS = 64, 16  # keys a tile, query rows a block (lm_attention.cu TL_BK, TL_BQ)
DECODE_KEYS, DECODE_WARPS = 64, 8  # the decode schedule's ring tile and warps


def _tile_block_keys(b, q0, bq, Sq, Sk, causal, q_off, valid, window, qseg, kseg):
    """lm_tile_kernel's walk for the block of rows [q0, q0 + bq) of batch b
    without segment ids: the key range [klo, khi) and its 64-key tiles.
    Returns the keys of the tiles walked."""
    n_rows = min(bq, Sq - q0)
    vb = min(valid[b], Sk)
    pos_first, pos_last = q_off[b] + q0, q_off[b] + q0 + n_rows - 1
    khi = min(vb, pos_last + 1) if causal else vb
    klo = max(0, pos_first - window + 1) if window > 0 else 0
    keys = set()
    for k0 in range(klo, khi, TILE_KEYS):
        keys.update(range(k0, min(khi, k0 + TILE_KEYS)))
    return keys


def _tile_plan(qseg, kseg, Sk, *, q_off=0, valid=None, causal=True, window=0):
    """lm_tile_kernel's segment-keyed plan over one batch row (plan_block,
    then tile_block): the rows cut into runs of equal q id, each run into
    blocks of TILE_ROWS rows from its first row; a block's keys [klo, khi)
    start at the first key of its id at or past the window start of its
    first row and are walked in 64-key tiles, a tile live when it holds a
    key of the block's id. Returns (q0, n_rows, klo, live tile starts) a
    block, in plan order."""
    Sq = len(qseg)
    valid = Sk if valid is None else min(valid, Sk)
    plan, r = [], 0
    while r < Sq:
        end = r
        while end < Sq and qseg[end] == qseg[r]:
            end += 1
        for q0 in range(r, end, TILE_ROWS):
            n = min(TILE_ROWS, end - q0)
            sigma = qseg[q0]
            khi = min(valid, q_off + q0 + n) if causal else valid
            lo = max(0, q_off + q0 - window + 1) if window > 0 else 0
            klo = next((k for k in range(lo, khi) if kseg[k] == sigma), max(khi, lo))
            tiles = [k0 for k0 in range(klo, khi, TILE_KEYS)
                     if (kseg[k0:min(k0 + TILE_KEYS, khi)] == sigma).any()]
            plan.append((q0, n, klo, tiles))
        r = end
    return plan


def _plan_block(qseg, pb, threads=256):
    """lm_attention.cu's plan_block, step for step: ids in chunks of
    ``threads`` rows, warp 0 walking each 32 rows at a time with ballots
    (run starts, block starts, the pb-th block start), the run and the id
    before carried from chunk to chunk. Returns (first row, rows) or
    (-1, 0)."""
    Sq, count, run_start, prev, row = len(qseg), 0, 0, 0, -1
    for base in range(0, Sq, threads):
        if row >= 0:
            break
        ids = [int(qseg[base + i]) if base + i < Sq else 0 for i in range(threads)]
        for sub in range(0, threads, 32):
            if base + sub >= Sq or row >= 0:
                break
            r = [base + sub + lane for lane in range(32)]
            before = [ids[sub + lane - 1] if lane else (ids[sub - 1] if sub else prev)
                      for lane in range(32)]
            starts = [r[i] < Sq and (r[i] == 0 or ids[sub + i] != before[i]) for i in range(32)]
            rs = []
            for lane in range(32):
                upto = [i for i in range(lane + 1) if starts[i]]
                rs.append(base + sub + upto[-1] if upto else run_start)
            first = [r[i] < Sq and (r[i] - rs[i]) % TILE_ROWS == 0 for i in range(32)]
            hit = [first[i] and sum(first[:i]) == pb - count for i in range(32)]
            if any(hit):
                row = base + sub + hit.index(True)
            count += sum(first)
            if any(starts):
                run_start = base + sub + max(i for i in range(32) if starts[i])
        prev = ids[threads - 1]
    if row < 0:
        return -1, 0
    n = 0
    while n < TILE_ROWS and row + n < Sq and qseg[row + n] == qseg[row]:
        n += 1
    return row, n


def _random_pack(rng, Sq, Sk=None):
    """Packed q ids [Sq]: prompts of 1.. tokens back to back (starts off
    the 16-row grid), a pad tail of -1; kv ids [Sk] the same, -2 past Sq."""
    Sk = Sq if Sk is None else Sk
    qseg = np.full(Sq, -1, np.int32)
    pos, i = 0, 0
    tail = int(rng.integers(0, max(Sq // 6, 1) + 1))
    while pos < Sq - tail:
        n = int(rng.choice([1, 1, 2, 3, 15, 16, 17, 31, 33, 64, 65, 100]))
        n = min(n, Sq - tail - pos)
        qseg[pos:pos + n] = i
        pos, i = pos + n, i + 1
    kseg = np.full(Sk, -2, np.int32)
    kseg[:Sq] = qseg
    return qseg, kseg


def _visible(B, Sq, Sk, causal, q_off, valid, window, qseg, kseg):
    """The plain version's mask [B, Sq, Sk]."""
    qpos = q_off[:, None] + np.arange(Sq)[None, :]
    kpos = np.arange(Sk)
    ok = np.broadcast_to(kpos[None, None, :] < valid[:, None, None], (B, Sq, Sk)).copy()
    if causal:
        ok &= kpos[None, None, :] <= qpos[:, :, None]
    if window:
        ok &= qpos[:, :, None] - kpos[None, None, :] < window
    if qseg is not None:
        ok &= qseg[:, :, None] == kseg[:, None, :]
    return ok


@pytest.mark.parametrize("seed", range(24))
def test_tile_schedule_never_skips_a_visible_pair(seed):
    """Random masks (causal or not, offsets, fill levels, windows, packed
    segment ids with q pad -1 and kv pad -2): every visible (row, key) pair
    lies in a tile its block walks; with segments (the segment-keyed
    plan), every walked tile holds a key of the block's id, so the tiles of
    the other prompts are skipped."""
    rng = np.random.default_rng(seed)
    B, Sq = 2, int(rng.integers(1, 160))
    Sk = Sq + int(rng.integers(0, 200))
    causal = bool(rng.integers(0, 2)) or seed % 3 == 0
    q_off = rng.integers(0, Sk - Sq + 1, B)
    valid = np.minimum(q_off + Sq + rng.integers(0, 40, B), Sk)
    window = int(rng.integers(1, 90)) if seed % 4 == 1 else 0
    qseg = kseg = None
    if seed % 2 == 0:  # packed prompts: contiguous runs, a pad tail
        kseg = np.full((B, Sk), -2, np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(1, Sq), min(4, Sq - 1), replace=False)) \
                if Sq > 1 else np.array([], int)
            ids = np.searchsorted(cuts, np.arange(Sq), side="right").astype(np.int32)
            ids[Sq - int(rng.integers(0, max(Sq // 8, 1))):] = -1
            kseg[b, :Sq] = ids
        q_off[:] = 0
        qseg = kseg[:, :Sq].copy()
    vis = _visible(B, Sq, Sk, causal, q_off, valid, window, qseg, kseg)
    skipped = 0
    for b in range(B):
        if qseg is None:
            blocks = [(q0, min(TILE_ROWS, Sq - q0), _tile_block_keys(
                b, q0, TILE_ROWS, Sq, Sk, causal, q_off, valid, window, qseg, kseg))
                for q0 in range(0, Sq, TILE_ROWS)]
        else:
            blocks = []
            for q0, n, _, tiles in _tile_plan(qseg[b], kseg[b], Sk, q_off=int(q_off[b]),
                                              valid=int(valid[b]), causal=causal,
                                              window=window):
                khi = min(valid[b], q0 + n) if causal else valid[b]
                walked = set()
                for k0 in tiles:
                    walked.update(range(k0, min(k0 + TILE_KEYS, khi)))
                    assert (kseg[b, k0:min(k0 + TILE_KEYS, khi)] == qseg[b, q0]).any()
                blocks.append((q0, n, walked))
        for q0, n, walked in blocks:
            need = set(np.flatnonzero(vis[b, q0:q0 + n].any(0)))
            assert need <= walked
            skipped += len(set(range(Sk)) - walked)
    assert skipped > 0  # the rule does skip work


@pytest.mark.parametrize("seed", range(16))
def test_segment_plan_keeps_blocks_inside_segments(seed):
    """The segment-keyed plan over random packs (prompts of 1 token, starts
    off the 16-row grid, a pad tail of -1): its blocks cover every row
    once, no block straddles two ids, each starts 16 j rows into its run,
    and the kernel's ballot walk (``_plan_block``, with chunks of 256 and of
    64 rows to cross chunk edges) finds the same blocks and -1 past the
    last; any grid of at least one block takes every plan block once."""
    rng = np.random.default_rng(100 + seed)
    Sq = int(rng.choice([1, 5, 32, 33, 64, 100, 256, 300, 512, 600]))
    qseg, kseg = _random_pack(rng, Sq)
    plan = _tile_plan(qseg, kseg, Sq)
    rows = np.zeros(Sq, int)
    for q0, n, _, _ in plan:
        rows[q0:q0 + n] += 1
        assert (qseg[q0:q0 + n] == qseg[q0]).all()
        run0 = q0
        while run0 > 0 and qseg[run0 - 1] == qseg[q0]:
            run0 -= 1
        assert (q0 - run0) % TILE_ROWS == 0
    assert (rows == 1).all()
    runs = 1 + int((qseg[1:] != qseg[:-1]).sum())
    assert len(plan) <= -(-Sq // TILE_ROWS) + runs  # the grid the engine launches
    for threads in (256, 64):
        got = [_plan_block(qseg, pb, threads) for pb in range(len(plan) + 2)]
        assert got == [(q0, n) for q0, n, _, _ in plan] + [(-1, 0)] * 2
    for grid in (1, 3, len(plan)):
        taken = [pb for x in range(grid) for pb in range(x, len(plan), grid)]
        assert sorted(taken) == list(range(len(plan)))


@pytest.mark.parametrize("seed", range(16))
def test_segment_plan_tiles_start_at_the_segments_first_key(seed):
    """Each block's key tiles start at its segment's first key (the window
    start where that is later), and every visible (row, key) pair is
    scored exactly once: it lies in one walked tile of its row's block,
    taken by one warp (key offset in the tile // 8) and one lane column."""
    rng = np.random.default_rng(200 + seed)
    Sq = int(rng.choice([7, 40, 100, 257, 512]))
    Sk = Sq + int(rng.integers(0, 64))
    window = int(rng.integers(1, 80)) if seed % 3 == 1 else 0
    qseg, kseg = _random_pack(rng, Sq, Sk)
    vis = _visible(1, Sq, Sk, True, np.zeros(1, int), np.asarray([Sk]), window,
                   qseg[None], kseg[None])[0]
    scored = np.zeros((Sq, Sk), int)
    for q0, n, klo, tiles in _tile_plan(qseg, kseg, Sk, window=window):
        start = int(np.flatnonzero(kseg == qseg[q0])[0])
        lo = max(0, q0 - window + 1) if window else 0
        assert klo == max(start, lo)
        assert all((k0 - klo) % TILE_KEYS == 0 for k0 in tiles)
        khi = q0 + n
        for k0 in tiles:
            for j in range(TILE_KEYS):  # warp j // 8, lane column j % 8
                key = k0 + j
                if key < khi:
                    for r in range(q0, q0 + n):
                        scored[r, key] += vis[r, key]
    assert (scored == vis).all()


@pytest.mark.parametrize("seed", range(12))
def test_segment_plan_walk_in_a_pack_equals_the_walk_alone(seed):
    """A prompt at offset s of a pack is walked as a prefill of it alone
    at offset 0 (no segment ids): the same blocks, key ranges and tiles,
    shifted by s. So each key meets the same tile, warp and lane, each
    row the same block row, and the sums run in the same order."""
    rng = np.random.default_rng(300 + seed)
    Sq = int(rng.choice([33, 100, 256, 512]))
    window = int(rng.integers(1, 80)) if seed % 4 == 3 else 0
    qseg, kseg = _random_pack(rng, Sq)
    plan = _tile_plan(qseg, kseg, Sq, window=window)
    for sigma in set(qseg.tolist()) - {-1}:
        where = np.flatnonzero(qseg == sigma)
        s, n = int(where[0]), len(where)
        packed = [(q0 - s, rows, klo - s, [k0 - s for k0 in tiles])
                  for q0, rows, klo, tiles in plan if qseg[q0] == sigma]
        alone = []
        for q0 in range(0, n, TILE_ROWS):
            rows = min(TILE_ROWS, n - q0)
            klo = max(0, q0 - window + 1) if window else 0
            alone.append((q0, rows, klo, list(range(klo, q0 + rows, TILE_KEYS))))
        assert packed == alone


@pytest.mark.parametrize("klo,khi", [(0, 0), (0, 1), (0, 63), (0, 64), (0, 65), (17, 300),
                                     (0, 512), (100, 612), (5, 2048)])
def test_decode_split_scores_every_live_key_once(klo, khi):
    """lm_decode_kernel's key split: ring tile s covers keys klo + 64 s ..;
    pass 1 gives warp w keys 8 w .. 8 w + 7 of it as one MMA tile, lane
    (g, t) scoring keys 2 t and 2 t + 1 for row g; pass 2 gives an
    iteration of a warp 4 keys (8 lanes a key), key klo + 64 s + 32 it +
    4 warp + lane / 8. Keys past khi are zero-filled and masked. In each
    pass every live key is taken exactly once (for each row), and its score
    lands at index key - klo < Sk."""
    n = max(0, khi - klo)
    ntiles = -(-n // DECODE_KEYS)
    scored, weighted = [], []
    for s in range(ntiles):
        k0 = klo + DECODE_KEYS * s
        for warp in range(DECODE_WARPS):
            for t in range(4):  # the lanes of one row g
                for e in range(2):
                    key = k0 + 8 * warp + 2 * t + e
                    if key < khi:
                        scored.append(key)
            for it in range(DECODE_KEYS // (4 * DECODE_WARPS)):
                for kq in range(4):
                    key = k0 + 4 * DECODE_WARPS * it + 4 * warp + kq
                    if key < khi:
                        weighted.append(key)
    assert sorted(scored) == sorted(weighted) == list(range(klo, max(klo, khi)))
    assert all(0 <= k - klo < max(khi, 1) for k in scored)


@pytest.mark.parametrize("shape,aligned,want", [
    ((1, 512, 16, 16, 128), True, 0),  # OLMoE decode tick over the 512-slot cache
    ((1, 512, 32, 8, 128), True, 0),  # GQA decode, 4 heads a KV head
    ((1, 512, 32, 4, 128), True, 1),  # 8 heads a KV head: more rows than a decode block
    ((1, 512, 16, 16, 64), True, 1),  # decode blocks hold hd = 128
    ((1, 512, 32, 32, 112), True, 1),  # zamba2-7b decode: hd = 112
    ((1, 512, 16, 16, 128), False, 1),  # an operand off the 16-byte grid
    ((1, 32768, 16, 16, 128), True, 1),  # the scores of the cache would not fit
    ((512, 512, 16, 16, 128), True, 1),  # packed prefill
    ((32, 32, 16, 16, 128), True, 1),  # calibration
    ((256, 256, 32, 32, 112), True, 1),  # zamba2-7b prefill
    ((1, 512, 8, 4, 256), True, 0),  # gemma2-2b decode, 2 heads a KV head
    ((1, 4096, 8, 4, 256), True, 0),  # gemma2-2b decode over its 4096-row ring
    ((1, 512, 16, 16, 256), True, 0),  # gemma-7b decode
    ((1, 512, 16, 2, 192), True, 1),  # hd 192: the tile schedule
    ((256, 256, 8, 4, 256), True, 1),  # gemma2-2b prefill
])
def test_attention_schedule_choice(shape, aligned, want):
    Sq, Sk, H, KVH, hd = shape
    assert qa.choose_schedule(Sq, Sk, H, KVH, hd, aligned) == want
    assert want in qa.SCHEDULES


# ---------------------------------------------------------------------------
# lm_attention.cu's arithmetic and shared-memory layout, emulated
# ---------------------------------------------------------------------------

def _tf32_rna(x):
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return r.view(np.float32)


def _split3(x):
    hi = _tf32_rna(x)
    r = (x - hi).astype(np.float32)
    mid = _tf32_rna(r)
    lo = _tf32_rna((r - mid).astype(np.float32))
    return hi, mid, lo


def _bf16_rn(x):
    """cvt.rn.bf16.f32 as f32: round to 7 mantissa bits, ties to even."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return r.view(np.float32)


def _split3_bf16(x):
    hi = _bf16_rn(x)
    r = (x - hi).astype(np.float32)
    mid = _bf16_rn(r)
    lo = _bf16_rn((r - mid).astype(np.float32))
    return hi, mid, lo


@pytest.mark.parametrize("pieces,mask", [(_split3, 0x1FFF), (_split3_bf16, 0xFFFF)],
                         ids=["tf32", "bf16"])
@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 3e4, 1e30])
def test_q_pieces_are_exact(pieces, mask, scale):
    """lm_attention.cu's q pieces (split3 for f32 K: tf32; put_q_pieces for
    int8 and bf16 K: bf16): each piece has its dropped mantissa bits clear
    and the three sum to the f32 q exactly, so against an int8 k (exact in
    both) each of the three MMA products is exact (in f64 here) and the
    piece products sum to q.k exactly. The claim holds while the pieces are
    normal numbers (|q| above ~2^-100): a subnormal piece keeps fewer
    bits."""
    rng = np.random.default_rng(0)
    q = (rng.standard_normal(4096) * scale).astype(np.float32)
    hi, mid, lo = pieces(q)
    for piece in (hi, mid, lo):
        assert not (piece.view(np.uint32) & mask).any()
    np.testing.assert_array_equal(hi.astype(np.float64) + mid + lo, q.astype(np.float64))
    k = rng.integers(-127, 128, 4096).astype(np.float32)
    exact = q.astype(np.float64) * k
    parts = hi.astype(np.float64) * k + mid.astype(np.float64) * k + lo.astype(np.float64) * k
    np.testing.assert_array_equal(parts, exact)


def _tile_layout(hd, es):
    """lm_attention.cu tile_layout and q_piece_row: padded head dim and row
    strides (q's pieces in their elements: tf32 for f32 K, bf16 for int8
    and bf16 K; K and V in bytes)."""
    up = lambda x, m: -(-x // m) * m  # noqa: E731
    hdp = up(hd, 16)
    q_row = hdp + 4 if es == 4 else hdp + 8
    return hdp, q_row, up(hdp * es, 32) + 16, up(hdp * es, 128) + (32 if es == 4 else 16)


def _conflicts(words):
    """The most distinct 4-byte words one bank serves for a warp's access
    (1: conflict-free; the same word twice is a broadcast)."""
    by_bank = {}
    for w in words:
        by_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in by_bank.values())


@pytest.mark.parametrize("es", [1, 2, 4])
@pytest.mark.parametrize("hd", [32, 64, 100, 112, 128, 192, 256])
def test_tile_fragment_reads_hit_32_banks(hd, es):
    """The tile schedule's fragment reads from shared memory, lane (g, t) =
    (lane // 4, lane % 4), are conflict-free for every chunk and n8 tile at
    every head dim and K/V width: the score MMAs' q A fragment and K B
    fragment (f32 K, m16n8k8 tf32: rows g and g + 8, dims kk + t and
    kk + t + 4 of q, of key g; int8 and bf16 K, m16n8k16 bf16: the pairs of
    dims kk + 2 t and kk + 2 t + 8), and P.V's V B fragment (keys t and
    t + 4, dim 8 n + g)."""
    hdp, q_row, k_row, v_row = _tile_layout(hd, es)
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    if es == 4:
        for kk in range(0, hdp, 8):
            for dr, dd in ((0, 0), (8, 0), (0, 4), (8, 4)):
                assert _conflicts([(g + dr) * q_row + kk + t + dd for g, t in lanes]) == 1
            for dd in (0, 4):
                assert _conflicts([(g * k_row + (kk + t + dd) * 4) // 4 for g, t in lanes]) == 1
    else:
        for kk in range(0, hdp, 16):
            for dr, dd in ((0, 0), (8, 0), (0, 8), (8, 8)):  # 2-element words
                assert _conflicts([((g + dr) * q_row + kk + 2 * t + dd) // 2
                                   for g, t in lanes]) == 1
            for dd in (0, 8):
                assert _conflicts([(g * k_row + (kk + 2 * t + dd) * es) // 4
                                   for g, t in lanes]) == 1
    worst_v = max(_conflicts([((t + dk) * v_row + (8 * n + g) * es) // 4 for g, t in lanes])
                  for n in range(hdp // 8) for dk in (0, 4))
    assert worst_v == 1
    assert k_row % 16 == 0 and v_row % 16 == 0  # 16-byte cp.async destinations


TILE_STATIC = 2 * 4 + 2 * 8 * 16 * 4 + 256 * 4 + 3 * 4  # tile_block's and plan_block's
DECODE_STATIC = {128: 13_504, 256: 19_648}  # red_m/l, q pieces (4 rows), each warp's P


def test_tile_layout_fits_a_block_at_every_head_dim():
    """lm_attention.cu tile_layout at hd 1..256, each K/V width, Sk up to
    8192 keys: q pieces, one or two stages, P and the live-tile list (and
    the partial outputs, which reuse the same memory) fit a block's
    232,448 bytes with the static shared memory; one stage only for f32 K/V
    above hd 128, the class whose two stages at hd 256 alone exceed a
    block."""
    from repro_torch.kernels.quant_attention import LM_MAX_HEAD_DIM, MAX_SMEM

    two_f32_256 = 2 * (64 * sum(_tile_layout(256, 4)[2:]) + 3 * 64 * 4)
    assert two_f32_256 > MAX_SMEM
    for hd in range(1, LM_MAX_HEAD_DIM + 1):
        for es in (1, 2, 4):
            hdp, q_row, k_row, v_row = _tile_layout(hd, es)
            stage = 64 * (k_row + v_row) + 3 * 64 * 4
            stages = 1 if (es == 4 and hdp > 128) else 2
            body = 3 * 16 * (hdp + 4) * 4 + stages * stage + 8 * 16 * 12 * 4
            size = max(body + 4 * (8192 // 64 + 1), 8 * 16 * (hdp + 8) * 4)
            assert size + TILE_STATIC <= MAX_SMEM, (hd, es, size)


@pytest.mark.parametrize("hd", [128, 256])
def test_decode_ring_fits_a_block_with_its_scores(hd):
    """lm_attention.cu dec_stages: the ring of each K/V width, the most
    scores ``choose_schedule`` admits (``DECODE_SCORE_BYTES``) and the
    static q pieces, P and maxima fit a block; the partial outputs fit the
    ring and scores at every admitted shape."""
    from repro_torch.kernels.quant_attention import DECODE_SCORE_BYTES, MAX_SMEM

    stages = {128: {1: 8, 2: 6, 4: 3}, 256: {1: 8, 2: 4, 4: 2}}[hd]
    for es, n in stages.items():
        ring = n * (64 * (hd * es + 16) + 64 * 8)
        assert ring + DECODE_SCORE_BYTES + DECODE_STATIC[hd] <= MAX_SMEM, (hd, es)
        assert max(ring, 8 * 16 * (hd + 8) * 4) + DECODE_SCORE_BYTES + DECODE_STATIC[hd] \
            <= MAX_SMEM, (hd, es)


# ---------------------------------------------------------------------------
# the vision kernel's tile variant (csrc/quant_attention.cu)
# ---------------------------------------------------------------------------

# a block is TILE_TY x TILE_TX = 8 row lanes x 16 key / head-dim lanes
VISION_TY, VISION_TX = 8, 16


@pytest.mark.parametrize("Sq,Sk", [(197, 197), (1, 1), (33, 77), (50, 50), (64, 1024),
                                   (20, 1440), (100, 65), (31, 16), (40, 17), (8, 257),
                                   (288, 70), (300, 197), (520, 64)])
def test_vision_tiles_score_every_pair_once(Sq, Sk):
    """The vision kernel's work split: blocks of VISION_ROWS query rows;
    thread (ty, tx) scores rows ty + 8 i (i < 4) against keys tx + 16 j of
    each VISION_KEYS-key chunk, j below the chunk's live 16-key groups.
    Every pair of a live row and a live key is scored exactly once; the
    score tile's row holds every key written, and pass 2 (each thread over
    the keys it wrote, tx + 16 m) reaches every key P.V reads (up to Sk
    rounded to 4; past Sk weight 0)."""
    from repro_torch.kernels.quant_attention import VISION_KEYS, VISION_ROWS, vision_layout

    assert VISION_ROWS == 4 * VISION_TY and VISION_KEYS == 4 * VISION_TX
    count = np.zeros((Sq, Sk), int)
    written = set()
    rows = np.arange(VISION_TY)[:, None]
    keys = np.arange(VISION_TX)[None, :]
    for blk in range(-(-Sq // VISION_ROWS)):
        for chunk in range(-(-Sk // VISION_KEYS)):
            live = min(VISION_KEYS, Sk - chunk * VISION_KEYS)
            for i in range(4):
                for j in range(-(-live // 16)):
                    r, k = np.broadcast_arrays(blk * VISION_ROWS + rows + 8 * i,
                                               chunk * VISION_KEYS + keys + 16 * j)
                    written.update(k.ravel().tolist())
                    ok = (r < Sq) & (k < Sk)
                    np.add.at(count, (r[ok], k[ok]), 1)
    assert (count == 1).all()
    _, ps_ld, _ = vision_layout(Sk, 64)
    read = set(range(-(-Sk // 4) * 4))  # P.V's keys: 16-byte reads of the weights
    assert read <= written and max(written) < ps_ld and ps_ld % 4 == 0
    assert ps_ld % 32 == 16  # the two row lanes of a warp: 32 distinct banks


@pytest.mark.parametrize("hdp", [16, 32, 64, 128])
def test_vision_pv_dims_cover_the_head_once_and_hit_32_banks(hdp):
    """P.V: lane tx of a row holds head dims 64 q + 4 tx + e (hdp >= 64,
    16-byte loads) or (hdp / 16) tx + e; the 16 lanes cover each padded
    dim once. The 16-byte K loads of pass 1 (rows tx + 16 j of hdp + 4
    floats) and V loads of pass 3 hit 32 distinct banks in every phase of
    eight lanes."""
    dpt = hdp // VISION_TX
    dims = [64 * (e // 4) + 4 * tx + e % 4 if dpt >= 4 else dpt * tx + e
            for tx in range(VISION_TX) for e in range(dpt)]
    assert sorted(dims) == list(range(hdp))
    ld = hdp + 4
    for phase in range(0, VISION_TX, 8):
        for j in range(4):
            k_banks = [((phase + t + 16 * j) * ld + w) % 32 for t in range(8) for w in range(4)]
            assert len(set(k_banks)) == 32
        if dpt >= 4:
            v_banks = [(ld + 4 * (phase + t) + w) % 32 for t in range(8) for w in range(4)]
            assert len(set(v_banks)) == 32


def test_vision_layout_fits_wherever_it_is_admitted():
    """fits_in_shared_memory admits exactly the (Sk, hd) whose tile block
    fits a block's shared memory, hd up to 128; at M3ViT-S ([197 keys, hd
    64]) three blocks share an SM (228 KB, 1 KB reserved a block)."""
    from repro_torch.kernels.quant_attention import (
        MAX_HEAD_DIM,
        MAX_SMEM,
        fits_in_shared_memory,
        vision_layout,
    )

    for hd in range(1, MAX_HEAD_DIM + 1):
        hdp, ps_ld, _ = vision_layout(1, hd)
        assert hd <= hdp and hdp % 16 == 0
        sizes = [vision_layout(Sk, hd)[2] for Sk in range(1, 2000)]
        admitted = [fits_in_shared_memory(Sk, hd) for Sk in range(1, 2000)]
        assert admitted == [b <= MAX_SMEM for b in sizes]
        assert admitted[196] and not admitted[-1]
    assert not fits_in_shared_memory(197, MAX_HEAD_DIM + 1)
    assert 3 * (vision_layout(197, 64)[2] + 1024) <= 228 * 1024
