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
  * the numpy emulation of the kernel's schedule: the chunk-start states
    bit-equal to the plain recurrence's, every gradient within atol 1e-5,
    rtol 1e-5 of the plain backward (its n and channel sums run in the
    kernel's order: per-thread fma chains, lane shuffles, lane-strided warp
    sums, blocks in order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops

from repro_torch.kernels import autograd, ops, ref
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
    kernel once and the backward kernel once, and the gradients are what
    they return."""
    calls = []

    def scan(*args):
        calls.append("selective_scan")
        return ref.selective_scan_ref(*map(_plain, args))

    def scan_bwd(*args):
        calls.append("selective_scan_bwd")
        return ref.selective_scan_bwd_ref(*map(_plain, args))

    monkeypatch.setattr(ops, "_scan_kernel", scan)
    monkeypatch.setattr(ops, "_scan_bwd_kernel", scan_bwd)
    ins, dy, _ = _operands(1, 19, 4, 16, seed=7)
    leaves = [_card(t).requires_grad_() for t in _t(ins)]
    y, _ = ops.selective_scan(*leaves)
    assert calls == ["selective_scan"]
    y.backward(_card(torch.from_numpy(dy)))
    assert calls == ["selective_scan", "selective_scan_bwd"]
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


def test_bwd_layout_and_chunk():
    """4 states a thread up to N 128 (lanes 1..32), then 32 lanes; the chunk
    holds 64 state steps a thread; falcon-mamba's N 16 takes (4, 4): 64
    channels a block, 16 steps a chunk."""
    assert [ss.scan_bwd_layout(n) for n in (1, 4, 5, 8, 16, 33, 64, 128, 129, 256, 512)] == [
        (4, 1), (4, 1), (4, 2), (4, 2), (4, 4), (4, 16), (4, 16), (4, 32), (8, 32), (8, 32),
        (16, 32)]
    assert [ss.scan_bwd_chunk(s) for s in (4, 8, 16)] == [16, 8, 4]
    for n in (0, 513):
        with pytest.raises(ValueError):
            ss.scan_bwd_layout(n)


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


def _warp_channel_sum(terms):
    """reduce_channels: terms [..., CH] summed by 32 lanes striding over the
    channels, then a 32-lane xor tree."""
    lanes = np.zeros(terms.shape[:-1] + (32,), f32)
    for cc in range(terms.shape[-1]):
        lanes[..., cc % 32] = (lanes[..., cc % 32] + terms[..., cc]).astype(f32)
    return _xor_tree(lanes, 32)


def _emulate_kernel(x, dt, b, c, a, d, dy, dh_last):
    """The four launches of the backward kernel, block by block, in its
    order of operations; returns the gradients and the chunk-start states
    the first launch saves."""
    B, S, di = x.shape
    N = b.shape[-1]
    spt, L = ss.scan_bwd_layout(N)
    K, CH, Np = ss.scan_bwd_chunk(spt), ss.BWD_THREADS // L, spt * L
    nck, blocks = -(-S // K), -(-di // CH)
    pad = lambda v, n: np.concatenate(  # noqa: E731
        [v, np.zeros(v.shape[:-1] + (n - v.shape[-1],), f32)], -1)
    bp, cp = pad(b, Np), pad(c, Np)  # [B, S, Np]
    saved = np.zeros((B, nck, di, N), f32)
    dx, ddt = np.zeros_like(x), np.zeros_like(x)
    part = np.zeros((blocks, 2, B, S, N), f32)
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
        # launch 1: the chunk-start states
        h = np.zeros((B, CH, Np), f32)
        for ck in range(nck):
            if ck:
                saved[:, ck, ch_] = h[:, :len(ch_), :N]
            if ck == nck - 1:
                break
            for t in range(ck * K, (ck + 1) * K):
                decay = _exp(dts[:, t, :, None] * av)
                h = (decay * h + (dts[:, t] * xs[:, t])[:, :, None] * bp[:, t, None, :]).astype(f32)
        # launch 2: the reverse walk
        carry = np.zeros((B, CH, Np), f32)
        if dh_last is not None:
            carry[:, :len(ch_), :N] = dh_last[:, ch_]
        acc = np.zeros((B, CH, Np), f32)
        for ck in reversed(range(nck)):
            t0, tn = ck * K, min(K, S - ck * K)
            h0 = np.zeros((B, CH, Np), f32)
            if ck:
                h0[:, :len(ch_), :N] = saved[:, ck, ch_]
            hist, hcur = [], h0
            for t in range(t0, t0 + tn):
                decay = _exp(dts[:, t, :, None] * av)
                hcur = (decay * hcur
                        + (dts[:, t] * xs[:, t])[:, :, None] * bp[:, t, None, :]).astype(f32)
                hist.append(hcur)
            for tt in range(tn):  # dC_t = sum_c h_t dy_t, lane-strided
                lanes = np.zeros((B, Np, 32), f32)
                for cc in range(CH):
                    lanes[:, :, cc % 32] = _fma(hist[tt][:, cc, :], dys[:, t0 + tt, cc, None],
                                                lanes[:, :, cc % 32])
                part[j, 1, :, t0 + tt] = _xor_tree(lanes, 32)[:, :N]
            for tt in reversed(range(tn)):
                t = t0 + tt
                xt, dtt, dyt = xs[:, t, :, None], dts[:, t, :, None], dys[:, t, :, None]
                hp = hist[tt - 1] if tt else h0
                gk = (dyt * cp[:, t, None, :] + carry).astype(f32)
                at = _exp(dtt * av)
                q = ((gk * at).astype(f32) * hp).astype(f32)
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
                carry = (at * gk).astype(f32)
                hist[tt] = (gk * (dtt * xt).astype(f32)).astype(f32)
            for tt in range(tn):  # dB_t
                part[j, 0, :, t0 + tt] = _warp_channel_sum(
                    np.moveaxis(hist[tt], 1, 2))[:, :N]
        da_part[:, ch_] = acc[:, :len(ch_), :N]
    # launches 3 and 4: the partials in order
    dbc = part[0]
    for j in range(1, blocks):
        dbc = (dbc + part[j]).astype(f32)
    da = da_part[0]
    for i in range(1, B):
        da = (da + da_part[i]).astype(f32)
    return (dx, ddt, dbc[0], dbc[1], da), saved


@pytest.mark.parametrize("B,S,di,N", [(2, 37, 70, 4), (1, 29, 9, 16), (2, 21, 3, 5)])
def test_kernel_schedule_emulation_matches_the_plain_backward(B, S, di, N):
    """The kernel's schedule at a ragged last chunk, several blocks along
    di (70 channels over 64 a block at N 4) and padded states (N 5)."""
    ins, dy, dh = _operands(B, S, di, N, seed=11)
    got, saved = _emulate_kernel(*ins, dy, dh)
    want = ref.selective_scan_bwd_ref(*_t(ins), torch.from_numpy(dy), torch.from_numpy(dh))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL, err_msg=name)
    # the saved chunk starts are the plain recurrence's states, bit for bit
    x, dt, b, _, a, _ = _t(ins)
    K = ss.scan_bwd_chunk(ss.scan_bwd_layout(N)[0])
    h = torch.zeros((B, di, N))
    for t in range(S):
        if t % K == 0 and t:
            np.testing.assert_array_equal(saved[:, t // K], h.numpy())
        h = ref._scan_step(h, x[:, t], dt[:, t], b[:, t], a)


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
