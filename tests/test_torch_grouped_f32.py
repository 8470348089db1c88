"""The f32 mode of the port's grouped matmul (``csrc/grouped_matmul.cu``,
``kernels/expert_linear.py``) on the CPU: which variant each shape of the
served paths takes, the wrapper's variant and launch bookkeeping (through a
stand-in for the kernel library), and a plain-torch emulation of the 3xTF32
chunk arithmetic that variants 1 and 2 share, held against the plain
version and the reference's Pallas kernel (interpret mode).

The emulation rounds hi to tf32 as ``cvt.rna`` does (10-bit mantissa, ties
away from zero), truncates lo to tf32 (the MMA reads a tf32 operand's upper
19 bits), forms each k8 chunk's lo.w_hi + hi.w_lo + hi.w_hi exactly (f64)
and rounds it to f32, then adds the chunks to the f32 sum in k order. The
tensor cores truncate inside a chunk instead of rounding, so the emulation
models the kernel's error, not its bits (the card holds the kernel to the
plain version within 1e-5, and its two variants bit-equal). Tolerance:
atol = rtol = 1e-5, the gate of the mode on the card.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.expert_linear import grouped_matmul as jax_grouped_matmul

from repro_torch.kernels import _build
from repro_torch.kernels import expert_linear as gm
from repro_torch.kernels import ref


# (T, G, Din, Dout) of the f32 grouped calls on the served paths: OLMoE-1B-7B
# expert fc1 (2048 -> 2 x 1024) and fc2 (1024 -> 2048) at decode ticks of
# 1..8 slots (top 8), at packed admissions of each bucket (32..512 tokens)
# and at a calibration forward (2 x 32 tokens); M3ViT-S expert fc1 / fc2
# (top 2 of 16) at its calibration batches of 2 and at a batch of 8
STREAM_PATH = [(8 * s, 64, din, dout) for s in range(1, 9)
               for din, dout in ((2048, 2048), (1024, 2048))]
MMA_PATH = ([(8 * b, 64, din, dout) for b in (32, 64, 128, 256, 512)
             for din, dout in ((2048, 2048), (1024, 2048))]
            + [(2 * 32 * 8, 64, 2048, 2048), (2 * 32 * 8, 64, 1024, 2048)]
            + [(2 * 197 * b, 16, din, dout) for b in (2, 8)
               for din, dout in ((384, 1536), (1536, 384))])


@pytest.mark.parametrize("T,G,Din,Dout", STREAM_PATH + MMA_PATH)
def test_f32_variant_on_the_path(T, G, Din, Dout):
    """A decode tick streams each active expert's f32 weight; admissions
    and both calibrations take the 3xTF32 MMA tiles; never the old tiles."""
    v = gm.choose_variant(T, G, Din, Dout, aligned=True, f32=True)
    assert v == (2 if (T, G, Din, Dout) in STREAM_PATH else 1)
    assert gm.takes(v, Din, Dout, f32=True) and gm.takes(3, Din, Dout, f32=True)


@pytest.mark.parametrize("T,G,Din,Dout,aligned", [
    (64, 64, 100, 2048, True), (4096, 64, 2044, 2048, True),  # Din % 8 != 0
    (64, 64, 2048, 10, True), (394, 16, 384, 1001, True),  # Dout % 8 != 0
    (64, 64, 2048, 2048, False), (3152, 16, 384, 1536, False),  # off the 16-byte grid
])
def test_f32_ragged_or_misaligned_shapes_take_fma(T, G, Din, Dout, aligned):
    assert gm.choose_variant(T, G, Din, Dout, aligned, f32=True) == 3
    assert not gm.takes(1, Din, Dout, aligned, f32=True)
    assert not gm.takes(2, Din, Dout, aligned, f32=True)


def test_f32_takes_widths_the_integer_modes_do_not():
    """The f32 variants step k by 8 (an m16n8k8 tf32 chunk), the integer
    ones by 16 bytes: Din = 24 takes the tensor cores in f32 only."""
    assert gm.takes(1, 24, 64, f32=True) and gm.takes(2, 24, 64, f32=True)
    assert not gm.takes(1, 24, 64) and gm.choose_variant(64, 4, 24, 64) == 3
    assert gm.choose_variant(64, 4, 24, 64, f32=True) == 1
    assert gm.choose_variant(8, 4, 24, 64, f32=True) == 2
    assert not gm.takes(4, 64, 64, f32=True)
    assert gm.F32_VARIANTS[3] == "fma" and gm.VARIANTS[3] == "dp4a"


class _Library:
    """Stands in for the kernel library: records each f32 launch."""

    def __init__(self):
        self.calls = []

    def grouped_matmul_f32_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def card(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(gm.grouped_matmul, "launches", 0)
    monkeypatch.setattr(gm.grouped_matmul, "launches_by_mode", {})
    return lib


def _f32_call(T=64, G=64, Din=64, Dout=64, **kw):
    x = torch.zeros((T, Din))
    w = torch.zeros((G, Din, Dout))
    sizes = torch.full((G,), T // G, dtype=torch.int32)
    return gm.grouped_matmul(x, w, sizes, **kw)


@pytest.mark.parametrize("variant", sorted(gm.F32_VARIANTS))
def test_variant_forces_an_f32_variant(card, variant):
    """``variant=`` is taken for f32 operands: the launch gets it as its
    ninth argument, one launch counted as ``f32`` and ``f32/<variant>``."""
    _f32_call(variant=variant)
    (args,) = card.calls
    assert len(args) == len(_build._SIGNATURES["grouped_matmul_f32_launch"][1])
    assert args[4:9] == (64, 64, 64, 64, variant)
    name = gm.F32_VARIANTS[variant]
    assert gm.grouped_matmul.launches == 1
    assert gm.grouped_matmul.launches_by_mode == {"f32": 1, f"f32/{name}": 1}


@pytest.mark.parametrize("T,variant", [(64, 2), (512, 1)])
def test_f32_variant_defaults_to_choose_variant(card, T, variant):
    _f32_call(T=T)
    assert card.calls[0][8] == variant
    assert gm.grouped_matmul.launches_by_mode == {
        "f32": 1, f"f32/{gm.F32_VARIANTS[variant]}": 1}


def test_f32_variant_that_cannot_take_the_widths_raises(card):
    with pytest.raises(ValueError, match="cannot take"):
        _f32_call(Din=100, variant=1)
    with pytest.raises(ValueError, match="integer operands only"):
        _f32_call(a_scale=torch.tensor(1.0))
    _f32_call(Din=100)  # the old tiles take it
    assert card.calls[0][8] == 3 and not _f32_call(T=0, variant=1).numel()
    assert len(card.calls) == 1  # nothing routed: no launch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as ``cvt.rna.tf32.f32`` rounds finite values:
    half an ulp of the 10-bit mantissa added to the magnitude, the 13 low
    bits cleared (nearest, ties away from zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def emulate_3xtf32(x, w, group_sizes) -> torch.Tensor:
    """The f32 mode's variants 1 and 2 as plain torch (see the module
    docstring): y[t] = x[t] @ w[g(t)], chunk by chunk."""
    T, Din = x.shape
    out = torch.zeros((T, w.shape[2]), dtype=torch.float32)
    xh = tf32_rna(x)
    xl = tf32_trunc(x - xh)
    ends = np.cumsum(group_sizes.numpy())
    for g, (s, e) in enumerate(zip(ends - group_sizes.numpy(), ends)):
        if e <= s:
            continue
        wh = tf32_rna(w[g])
        wl = tf32_trunc(w[g] - wh)
        acc = torch.zeros((e - s, w.shape[2]), dtype=torch.float32)
        for k in range(0, Din, 8):
            a_h, a_l = xh[s:e, k:k + 8, None].double(), xl[s:e, k:k + 8, None].double()
            b_h, b_l = wh[None, k:k + 8].double(), wl[None, k:k + 8].double()
            chunk = (a_l * b_h + a_h * b_l + a_h * b_h).sum(1).float()
            acc = acc + chunk
        out[s:e] = acc
    return out


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,  # a tie: away from zero
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             one + 2.0 ** -11 - 2.0 ** -23: one,  # below the tie
             one + 3 * 2.0 ** -11: one + 2.0 ** -9,  # a tie above an odd mantissa
             2.0 - 2.0 ** -23: 2.0,  # carries into the exponent
             0.0: 0.0}
    got = tf32_rna(torch.tensor(list(cases), dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.float32(list(cases.values())))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32_rna(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert ((x - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    lo = tf32_trunc(x - hi)  # hi + lo leaves less than 2^-21 of x
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()


def _operands(seed, G, Din, Dout, sizes):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((sum(sizes), Din)).astype(np.float32)
    w = (rng.standard_normal((G, Din, Dout)) / np.sqrt(Din)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sizes, dtype=torch.int32)


@pytest.mark.parametrize("Din,Dout", [(2048, 2048), (1024, 2048)])
def test_3xtf32_chunks_stay_within_1e5_of_the_plain_version(Din, Dout):
    """At the OLMoE-1B-7B expert widths (fc1, fc2), with an empty expert."""
    x, w, sizes = _operands(Din, 4, Din, Dout, [5, 0, 3, 4])
    got = emulate_3xtf32(x, w, sizes)
    torch.testing.assert_close(got, ref.grouped_matmul_ref(x, w, sizes), atol=1e-5,
                               rtol=1e-5)


def test_3xtf32_row_alone_equals_the_row_among_others():
    """A row's chunks read only its x row and its expert's weights: alone,
    or at another place among the rows of its group, it gets the same
    bits (what lets the card gate variant 1 against variant 2)."""
    x, w, sizes = _operands(3, 3, 1024, 256, [6, 2, 5])
    full = emulate_3xtf32(x, w, sizes)
    alone = emulate_3xtf32(x[7:8], w, torch.tensor([0, 1, 0], dtype=torch.int32))
    assert torch.equal(alone[0], full[7])
    moved = torch.cat([x[6:8].flip(0), x[8:]])  # rows 6 and 7 swapped in group 1
    assert torch.equal(emulate_3xtf32(torch.cat([x[:6], moved]), w, sizes)[6], full[7])


def test_3xtf32_chunks_match_the_reference_kernel():
    """The same numpy inputs through the reference's Pallas kernel
    (interpret mode, as tests/test_kernels.py runs it) and the emulation."""
    x, w, sizes = _operands(11, 4, 64, 96, [40, 0, 17, 71])
    want = jax_grouped_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                              jnp.asarray(sizes.numpy()), block_m=32, block_n=128,
                              interpret=True)
    np.testing.assert_allclose(emulate_3xtf32(x, w, sizes).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
