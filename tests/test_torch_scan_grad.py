"""The selective scan's backward (``ref.selective_scan_bwd_ref``, the
``autograd.SelectiveScan`` route of ``ops.selective_scan`` and the schedule of
``csrc/selective_scan_bwd.cu``) against torch autograd of the plain forward
and ``jax.vjp`` of the reference's scan (``REPRO_PALLAS=ref``: its
associative scan), on the CPU at smoke size.

Tolerances:
  * against torch autograd of ``selective_scan_ref``: atol 1e-5, rtol 1e-5
    (the same products; autograd sums the n and d terms in its own order);
  * against ``jax.vjp``: atol 2e-5, rtol 2e-5 (the associative scan also
    forms the decay products in another order, so its states differ by
    rounding);
  * the numpy emulation of the kernel's schedule (the saved variant): the
    forward's chunk-start states bit-equal to the plain recurrence's, every
    gradient within atol 1e-5, rtol 1e-5 of the plain backward (its n and
    channel sums run in the kernel's order: per-thread fma chains, lane
    shuffles, channel passes of P parts meeting in a shuffle tree, the
    blocks in order).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops

from repro_torch.kernels import _build, autograd, ops, ref
from repro_torch.kernels import selective_scan as ss

TOL = dict(atol=1e-5, rtol=1e-5)
JAX_TOL = dict(atol=2e-5, rtol=2e-5)
NAMES = ("dx", "ddt", "db", "dc", "da", "dd")


def _operands(B, S, di, N, seed=0):
    """dt as the model makes it (softplus), A as Mamba initializes it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, dt = f(B, S, di), np.log1p(np.exp(f(B, S, di))).astype(np.float32)
    b, c = f(B, S, N), f(B, S, N)
    a = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (di, N)).copy()
    return [x, dt, b, c, a, f(di)], f(B, S, di), f(B, di, N)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrays]


CASES = [(2, 37, 6, 4), (2, 37, 5, 16), (1, 16, 3, 16)]  # S 37: a ragged last chunk


@pytest.mark.parametrize("B,S,di,N", CASES)
@pytest.mark.parametrize("with_dh", [True, False])
def test_bwd_ref_matches_torch_autograd(B, S, di, N, with_dh):
    ins, dy, dh = _operands(B, S, di, N)
    leaves = [t.requires_grad_() for t in _t(ins)]
    y, h = ref.selective_scan_ref(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dh:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy),
                                     torch.from_numpy(dh) if with_dh else None)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("N", [4, 16])
def test_bwd_ref_matches_jax_vjp_of_the_reference_scan(N):
    ins, dy, dh = _operands(2, 37, 6, N, seed=N)
    y, vjp = jax.vjp(jax.jit(jax_ops.selective_scan), *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL, err_msg=name)


@pytest.mark.parametrize("which", [0, 6, 7])  # x, dy, dh_last
def test_bwd_ref_refuses_other_dtypes(which):
    """The plain backward, like the kernel, takes f32 operands only."""
    ins, dy, dh = _operands(1, 5, 2, 4, seed=3)
    args = _t(ins) + [torch.from_numpy(dy), torch.from_numpy(dh)]
    args[which] = args[which].to(torch.bfloat16)
    with pytest.raises(TypeError, match="f32"):
        ref.selective_scan_bwd_ref(*args)


def test_scan_under_grad_runs_the_selective_scan_function():
    """On the CPU, under grad: the plain forward and ``selective_scan_bwd_ref``
    through ``autograd.SelectiveScan``, bit for bit; h_last's gradient
    reaches the inputs too; bf16 raises; no grad, no Function."""
    ins, dy, dh = _operands(2, 21, 4, 8, seed=5)
    leaves = [t.requires_grad_() for t in _t(ins)]
    y, h = ops.selective_scan(*leaves)
    assert "SelectiveScan" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum(),
                              leaves)
    want = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y, _ = ops.selective_scan(*leaves)
    (gx,) = torch.autograd.grad(y.sum(), leaves[0])  # h_last unused: its grad is None
    want = ref.selective_scan_bwd_ref(*_t(ins), torch.ones_like(y))
    assert torch.equal(gx, want[0])
    with pytest.raises(TypeError, match="f32"):
        ops.selective_scan(*(t.detach().bfloat16().requires_grad_() for t in leaves[:4]),
                           *leaves[4:])
    with torch.no_grad():
        y, _ = ops.selective_scan(*leaves)
    assert y.grad_fn is None


class _OnCard(torch.Tensor):
    """A CPU tensor that ``ops`` takes for a CUDA one (its branches read
    ``is_cuda``); the kernel entries are monkeypatched, nothing launches."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t, t.requires_grad)


def _plain(t):
    return None if t is None else t.as_subclass(torch.Tensor)


def test_scan_backward_on_the_card_runs_both_kernels(monkeypatch):
    """On the card, under grad, ``ops.selective_scan`` launches the forward
    kernel once, asking it for the chunk-start states, and the backward
    kernel once, from those states; the gradients are what they return."""
    calls = []
    states = torch.arange(4 * 16, dtype=torch.float32).reshape(1, 1, 4, 16)

    def scan(*args, save_states=False):
        calls.append(("selective_scan", save_states))
        return (*ref.selective_scan_ref(*map(_plain, args)), states)

    def scan_bwd(*args, states=None):
        calls.append(("selective_scan_bwd", torch.equal(_plain(states), states_want)))
        return ref.selective_scan_bwd_ref(*map(_plain, args))

    states_want = states.clone()
    monkeypatch.setattr(ops, "_scan_kernel", scan)
    monkeypatch.setattr(ops, "_scan_bwd_kernel", scan_bwd)
    ins, dy, _ = _operands(1, 19, 4, 16, seed=7)
    leaves = [_card(t).requires_grad_() for t in _t(ins)]
    y, _ = ops.selective_scan(*leaves)
    assert calls == [("selective_scan", True)]
    y.backward(_card(torch.from_numpy(dy)))
    assert calls == [("selective_scan", True), ("selective_scan_bwd", True)]
    want = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy))
    for name, leaf, w in zip(NAMES, leaves, want):
        assert torch.equal(_plain(leaf.grad), w), name


def test_bwd_wrapper_takes_cuda_f32_only():
    ins, dy, _ = _operands(1, 4, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ss.selective_scan_bwd(*_t(ins), torch.from_numpy(dy))
    with pytest.raises(TypeError, match="f32"):
        ss.selective_scan_bwd(*(t.bfloat16() for t in _t(ins)[:4]), *_t(ins)[4:],
                              torch.from_numpy(dy))
    with pytest.raises(ValueError, match="shape"):
        ss.selective_scan_bwd(*_t(ins), torch.from_numpy(dy)[:, :2])
    with pytest.raises(TypeError, match="f32"):
        ref.selective_scan_bwd_ref(*(t.double() for t in _t(ins)), torch.from_numpy(dy).double())
    for kw in ({"variant": 3}, {"variant": 2, "states": torch.zeros(1, 0, 2, 4)},
               {"states": torch.zeros(1, 1, 2, 4)},
               {"states": torch.zeros(1, 0, 2, 4, dtype=torch.float64)}):
        with pytest.raises(ValueError):
            ss.selective_scan_bwd(*_t(ins), torch.from_numpy(dy), **kw)
    with pytest.raises(ValueError, match="saves no states"):
        ss.selective_scan(*_t(ins)[:6], variant=2, save_states=True)
    with pytest.raises(ValueError, match="save_states takes f32"):
        ss.selective_scan(*(t.bfloat16() for t in _t(ins)[:4]), *_t(ins)[4:6], save_states=True)


def test_bwd_layout_and_chunk():
    """The saved variant: 4 states a thread up to N 128 (lanes 1..32), then
    32 lanes; the chunk holds 64 state steps a thread (the a_t registers);
    falcon-mamba's N 16 takes (4, 4): 32 channels a 128-thread block, 16
    steps a chunk, 49.75 KB of shared memory, so four blocks (16 warps) an
    SM. The picked block fits 227 KB at every N up to 512."""
    assert [ss.scan_bwd_layout(n) for n in (1, 4, 5, 8, 16, 33, 64, 128, 129, 256, 512)] == [
        (4, 1), (4, 1), (4, 2), (4, 2), (4, 4), (4, 16), (4, 16), (4, 32), (8, 32), (8, 32),
        (16, 32)]
    assert [ss.scan_bwd_chunk(s) for s in (4, 8, 16)] == [16, 8, 4]
    assert ss.scan_bwd_smem_bytes(4, 4) == 50944 and ss.BWD_THREADS[1] // 4 == 32
    assert 4 * (ss.scan_bwd_smem_bytes(4, 4) + 1024) <= 228 * 1024
    for n in range(1, ss.MAX_STATE + 1):
        spt, lanes = ss.scan_bwd_layout(n)
        assert ss.scan_bwd_smem_bytes(spt, lanes) <= ss.SMEM_PER_BLOCK, (n, spt, lanes)
    for n in (0, 513):
        with pytest.raises(ValueError):
            ss.scan_bwd_layout(n)


def test_bwd_recompute_layout_and_chunk():
    """The recompute variant (the first design): the same (states, lanes)
    rule and chunk, 256-thread blocks (64 channels at N 16) whose history
    [16][4][256] takes 64 KB, two blocks an SM; its workspace at the
    training shape: every chunk's start state and per-block partials (the
    saved variant's states come from the forward; its blocks are half as
    wide, so its partials twice as many)."""
    assert ss.BWD_THREADS[2] == 256
    assert ss.scan_bwd_recompute_smem_bytes(4, 4) == 4 * (16 * 4 * 256 + 2 * 16 * 16 + 3 * 16 * 64)
    assert 2 * ss.scan_bwd_recompute_smem_bytes(4, 4) <= ss.SMEM_PER_BLOCK
    for n in (1, 5, 16, 100, 128, 200, 512):
        assert ss.scan_bwd_recompute_smem_bytes(*ss.scan_bwd_layout(n)) <= ss.SMEM_PER_BLOCK
    old = ss.scan_bwd_workspace(2, 2, 4096, 8192, 16)
    new = ss.scan_bwd_workspace(1, 2, 4096, 8192, 16)
    assert old == {"states": 2 * 256 * 8192 * 16, "partials": 2 * 128 * 2 * 4096 * 16,
                   "da_rows": 2 * 8192 * 16}
    assert new == {"states": 2 * 255 * 8192 * 16, "partials": 2 * 256 * 2 * 4096 * 16,
                   "da_rows": 2 * 8192 * 16}


class _Library:
    """Stands in for the kernel library: records each launch by name, its
    arguments checked against ``_build._SIGNATURES``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            assert len(args) == len(_build._SIGNATURES[name][1]), name
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def card(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for fn in (ss.selective_scan, ss.selective_scan_bwd):  # counts of the card's runs only
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_mode", {})
    return lib


@pytest.mark.parametrize("S,given,launches", [
    (16, False, ["selective_scan_bwd_launch"]),
    (37, False, ["selective_scan_save_launch", "selective_scan_bwd_launch"]),
    (37, True, ["selective_scan_bwd_launch"])])
def test_bwd_launches_the_forward_only_for_missing_states(card, S, given, launches):
    """The saved variant called without states runs the forward's saving
    kernel for them, without y, only where S spans more than one chunk
    (16 steps at N 16); a sequence of one chunk, or states given, launch
    the walk alone, its states pointer null where there are none."""
    ins, dy, _ = _operands(1, S, 8, 16)
    nck = -(-S // ss.scan_bwd_chunk(4))
    states = torch.zeros(1, nck - 1, 8, 16) if given else None
    ss.selective_scan_bwd(*_t(ins), torch.from_numpy(dy), states=states)
    assert [name for name, _ in card.calls] == launches
    if launches[0] == "selective_scan_save_launch":
        args = card.calls[0][1]
        assert args[6] is None and args[8] is not None and args[-2] == 16  # no y; hs; hk
    walk = card.calls[-1][1]
    assert (walk[8] is None) == (nck == 1)


@pytest.mark.parametrize("save_states", [False, True])
def test_forward_saving_states_takes_its_own_kernel(card, save_states):
    """The forward's saving kernel has an entry of its own; without
    ``save_states`` the serving kernel's launch is unchanged."""
    ins, _, _ = _operands(2, 37, 8, 16)
    out = ss.selective_scan(*_t(ins)[:6], save_states=save_states)
    ((name, args),) = card.calls
    if save_states:
        assert name == "selective_scan_save_launch" and args[6] is not None
        assert out[2].shape == (2, 2, 8, 16)
    else:
        assert name == "selective_scan_launch" and len(out) == 2


# ---------------------------------------------------------------------------
# a numpy emulation of csrc/selective_scan_bwd.cu's schedule
# ---------------------------------------------------------------------------

f32 = np.float32


def _exp(v):
    """exp as the plain version takes it (torch's; numpy's may differ in the
    last bit)."""
    return torch.exp(torch.from_numpy(np.ascontiguousarray(v, f32))).numpy()


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(f32)


def _xor_tree(v, width):
    """__shfl_xor_sync sums over ``width`` lanes on the last axis (each lane
    ends with the same total; lane 0's is returned)."""
    o = width // 2
    while o:
        v = (v + v[..., np.arange(v.shape[-1]) ^ o]).astype(f32)
        o //= 2
    return v[..., 0]


def _forward_states(x, dt, b, a, K):
    """The states the forward kernel saves for the backward: the state at
    the start of every chunk of K steps but the first, [B, ceil(S / K) - 1,
    di, N], in the plain recurrence's rounding (each product and sum
    rounded to f32)."""
    B, S, di = x.shape
    h = np.zeros((B, di, b.shape[-1]), f32)
    saved = []
    for t in range(S):
        if t and t % K == 0:
            saved.append(h)
        h = (_exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :]).astype(f32)
    return np.stack(saved, 1) if saved else np.zeros((B, 0, di, b.shape[-1]), f32)


def _channel_pass(terms, w, P):
    """A channel-sum pass of the block: terms [B, K, CH, Np] (times w [B, K,
    CH] by fma where given) summed over the channels; part p of P sums
    channels p, p + P, ... in order, then the parts meet in an xor tree."""
    parts = []
    for p in range(P):
        s = np.zeros(terms.shape[:2] + terms.shape[3:], f32)
        for c in range(p, terms.shape[2], P):
            s = (_fma(terms[:, :, c], w[:, :, c, None], s) if w is not None
                 else (s + terms[:, :, c]).astype(f32))
        parts.append(s)
    return _xor_tree(np.stack(parts, -1), P)


def _emulate_kernel(x, dt, b, c, a, d, dy, dh_last):
    """The saved variant of the backward, block by block in its order of
    operations, from the forward's saved states; returns the gradients and
    those states."""
    B, S, di = x.shape
    N = b.shape[-1]
    spt, L = ss.scan_bwd_layout(N)
    K, CH, Np = ss.scan_bwd_chunk(spt), ss.BWD_THREADS[1] // L, spt * L
    P = max(1, ss.BWD_THREADS[1] // (K * Np // 4))
    nck, blocks = -(-S // K), -(-di // CH)
    pad = lambda v, n: np.concatenate(  # noqa: E731
        [v, np.zeros(v.shape[:-1] + (n - v.shape[-1],), f32)], -1)
    bp, cp = pad(b, Np), pad(c, Np)  # [B, S, Np]
    saved = _forward_states(x, dt, b, a, K)
    dx, ddt = np.zeros_like(x), np.zeros_like(x)
    red = np.zeros((blocks, 2, B, S, Np), f32)  # each block's channel sums
    da_part = np.zeros((B, di, N), f32)
    for j in range(blocks):
        ch_ = np.arange(j * CH, min(di, (j + 1) * CH))
        xs, dts, dys = (np.zeros((B, S, CH), f32) for _ in range(3))
        for src, dst in ((x, xs), (dt, dts), (dy, dys)):
            dst[:, :, :len(ch_)] = src[:, :, ch_]
        av = np.zeros((CH, Np), f32)
        av[:len(ch_), :N] = a[ch_]
        dk = np.zeros(CH, f32)
        dk[:len(ch_)] = d[ch_]
        carry = np.zeros((B, CH, Np), f32)
        if dh_last is not None:
            carry[:, :len(ch_), :N] = dh_last[:, ch_]
        acc = np.zeros((B, CH, Np), f32)
        for ck in reversed(range(nck)):
            t0, tn = ck * K, min(K, S - ck * K)
            h0 = np.zeros((B, CH, Np), f32)
            if ck:
                h0[:, :len(ch_), :N] = saved[:, ck - 1, ch_]
            hist, dec, hcur = [], [], h0  # the rebuild: h_t to the history, a_t kept
            for t in range(t0, t0 + tn):
                dec.append(_exp(dts[:, t, :, None] * av))
                hcur = (dec[-1] * hcur
                        + (dts[:, t] * xs[:, t])[:, :, None] * bp[:, t, None, :]).astype(f32)
                hist.append(hcur)
            red[j, 1, :, t0:t0 + tn] = _channel_pass(np.stack(hist, 1), dys[:, t0:t0 + tn], P)
            for tt in reversed(range(tn)):
                t = t0 + tt
                xt, dtt, dyt = xs[:, t, :, None], dts[:, t, :, None], dys[:, t, :, None]
                hp = hist[tt - 1] if tt else h0
                gk = (dyt * cp[:, t, None, :] + carry).astype(f32)
                ga = (gk * dec[tt]).astype(f32)
                q = (ga * hp).astype(f32)
                # a thread's fma chain over its spt states, then L lanes
                s1 = np.zeros((B, CH, L), f32)
                s2 = np.zeros((B, CH, L), f32)
                for k in range(spt):
                    n = np.arange(L) * spt + k
                    s1 = _fma(gk[:, :, n], bp[:, t][:, n][:, None], s1)
                    s2 = _fma(av[None, :, n], q[:, :, n], s2)
                s1, s2 = _xor_tree(s1, L), _xor_tree(s2, L)
                live = slice(0, len(ch_))
                dx[:, t, ch_] = ((dtt[..., 0] * s1).astype(f32)
                                 + (dk[None] * dyt[..., 0]).astype(f32))[:, live]
                ddt[:, t, ch_] = (s2 + (xt[..., 0] * s1).astype(f32))[:, live]
                acc = (acc + (q * dtt).astype(f32)).astype(f32)
                carry = ga
                hist[tt] = (gk * (dtt * xt).astype(f32)).astype(f32)  # dB's term
            red[j, 0, :, t0:t0 + tn] = _channel_pass(np.stack(hist, 1), None, P)
        da_part[:, ch_] = acc[:, :len(ch_), :N]
    dbc = red[0]  # the blocks' partials in order
    for j in range(1, blocks):
        dbc = (dbc + red[j]).astype(f32)
    da = da_part[0]
    for i in range(1, B):
        da = (da + da_part[i]).astype(f32)
    return (dx, ddt, dbc[0, ..., :N], dbc[1, ..., :N], da), saved


@pytest.mark.parametrize("B,S,di,N", [(2, 37, 70, 4), (1, 29, 9, 16), (2, 21, 3, 5),
                                      (1, 20, 300, 16)])
def test_kernel_schedule_emulation_matches_the_plain_backward(B, S, di, N):
    """The kernel's schedule at a ragged last chunk (S 37, 29, 21, 20 over
    chunks of 16), a block with dead channels (70 of 128 at N 4), several
    blocks along di (300 channels over 32 a block at N 16) and padded states
    (N 5)."""
    ins, dy, dh = _operands(B, S, di, N, seed=11)
    got, saved = _emulate_kernel(*ins, dy, dh)
    want = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL, err_msg=name)
    # the saved chunk starts are the plain recurrence's states, bit for bit
    x, dt, b, _, a, _ = _t(ins)
    K = ss.scan_bwd_chunk(ss.scan_bwd_layout(N)[0])
    assert saved.shape == (B, -(-S // K) - 1, di, N)
    h = torch.zeros((B, di, N))
    for t in range(S):
        if t % K == 0 and t:
            np.testing.assert_array_equal(saved[:, t // K - 1], h.numpy())
        h = ref._scan_step(h, x[:, t], dt[:, t], b[:, t], a)


def test_zero_steps_past_the_end_change_no_gradient():
    """The kernel stages the last chunk's steps past S as zeros (x, dt, dy,
    b, c) and walks them: each is an exact identity (a_t = exp(0) = 1, h
    unchanged, g passed on, q dt = 0 added to dA), so the plain backward
    over the padded sequence gives the real steps' gradients and dA bit for
    bit, dh_last included."""
    ins, dy, dh = _operands(2, 21, 5, 16, seed=13)
    zeros = lambda v: np.zeros(v.shape[:1] + (11,) + v.shape[2:], f32)  # noqa: E731
    padded = [np.concatenate([v, zeros(v)], 1) if i < 4 else v for i, v in enumerate(ins)]
    got = ref.selective_scan_bwd_ref(*_t(padded), torch.from_numpy(
        np.concatenate([dy, zeros(dy)], 1)), torch.from_numpy(dh))
    want = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    for name, g, w in zip(NAMES[:5], got, want):
        assert torch.equal(g[:, :21] if g.dim() == 3 else g, w), name


def test_selective_scan_function_skips_unneeded_grads():
    """``SelectiveScan`` hands the backward dy as zeros where y's gradient
    is None and dh_last as None where h_last's is."""
    seen = []

    def bwd(*args):
        seen.append((bool(args[6].any()), args[7] is None))
        return ref.selective_scan_bwd_ref(*args)

    ins, _, _ = _operands(1, 5, 2, 4)
    leaves = [t.requires_grad_() for t in _t(ins)]
    y, h = autograd.SelectiveScan.apply(*leaves, ref.selective_scan_ref, bwd)
    torch.autograd.grad(h.sum(), leaves[0])
    y, h = autograd.SelectiveScan.apply(*leaves, ref.selective_scan_ref, bwd)
    torch.autograd.grad(y.sum(), leaves[0])
    assert seen == [(False, False), (True, True)]
