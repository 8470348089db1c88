"""The port's RMSNorm against the JAX reference on the CPU.

On the CPU ``ops.rmsnorm`` (and ``models.layers.rmsnorm``, which every
norm of the LM and SSM paths calls) runs the plain version
``ref.rmsnorm_ref``; the CUDA kernel ``csrc/rmsnorm.cu`` is held against it
on the card by ``chip_smoke.py``. Here both the plain version and a numpy
emulation of the kernel's summation order meet ``repro.models.layers.
rmsnorm`` on the same numpy inputs.

Tolerances:
  * f32: atol = rtol = 1e-6 (the mean's sum taken in another order);
  * bf16 x: y is each side's f32 y rounded once to bf16, so within one
    bf16 step (rtol 2^-7); a bf16 gamma is rounded to bf16 after 1 + gamma
    on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import rmsnorm as jax_rmsnorm

from repro_torch.kernels import ops, ref
from repro_torch.kernels.norm import rmsnorm as rmsnorm_kernel
from repro_torch.models import layers

# one element, D % 4 != 0, a qk-norm head, a width past a multiple of 128,
# OLMoE-1B-7B's d_model, falcon-mamba-7b's, and past eight warps' reach
WIDTHS = [1, 6, 128, 300, 2048, 4096, 4100]
TYPES = [("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16")]


def _inputs(D, rows=(3, 5)):
    rng = np.random.default_rng(D)
    x = (3 * rng.standard_normal(rows + (D,))).astype(np.float32)
    gamma = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, gamma


def _tol(dtype):
    return dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-6, rtol=2.0**-7)


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dtype,gamma_dtype", TYPES)
def test_rmsnorm_matches_reference(D, dtype, gamma_dtype):
    x, gamma = _inputs(D)
    want = jax_rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(gamma).astype(gamma_dtype))
    assert want.dtype == dtype
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tg = torch.from_numpy(gamma).to(getattr(torch, gamma_dtype))
    for fn in (ref.rmsnorm_ref, ops.rmsnorm, layers.rmsnorm):
        got = fn(tx, tg)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **_tol(dtype))


def _kernel_emulation(x, gamma, eps=1e-6):
    """csrc/rmsnorm.cu in numpy float32, rows [R, D]: W = min(8, ceil(D /
    512)) warps a row; lane l of warp w (L = 32 w + l) sums the elements c
    + 4 L + j (c = 0, 128 W, ...; j = 0..3) in that order, each square
    rounded on its own; a xor butterfly adds a warp's 32 partial sums, and
    the W warp sums are added in warp order; y = (x r) (1 + gamma), r = 1 /
    sqrt(sum / D + eps), every operation rounded to f32."""
    f = np.float32
    R, D = x.shape
    W = min(8, max(1, -(-D // 512)))
    lanes = np.zeros((R, 32 * W), f)
    for c in range(0, D, 128 * W):
        for j in range(4):
            e = c + 4 * np.arange(32 * W) + j
            v = np.where(e < D, x[:, np.minimum(e, D - 1)], f(0))
            lanes = (lanes + (v * v).astype(f)).astype(f)
    warps = lanes.reshape(R, W, 32)
    for o in (16, 8, 4, 2, 1):
        warps = (warps + warps[:, :, np.arange(32) ^ o]).astype(f)
    assert (warps == warps[:, :, :1]).all()  # every lane ends with its warp's sum
    s = warps[:, 0, :1]
    for w in range(1, W):
        s = (s + warps[:, w, :1]).astype(f)
    inv = (f(1) / np.sqrt((s / f(D)).astype(f) + f(eps))).astype(f)
    return ((x * inv).astype(f) * (f(1) + gamma).astype(f)).astype(f)


@pytest.mark.parametrize("D", WIDTHS)
def test_kernel_summation_order_computes_the_reference(D):
    """The kernel's order (fixed by D alone: a row's sum is the same whether
    the row sits among 8 rows or 512) computes the reference's function."""
    x, gamma = _inputs(D, rows=(12,))
    want = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(gamma)))
    got = _kernel_emulation(x, gamma)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_kernel_emulation(x[:3], gamma), got[:3])


def test_rmsnorm_wrapper_checks_its_contract_and_takes_cuda_tensors_only():
    """f32 and bf16 x and gamma pass the contract checks and stop only at
    the device (a CPU tensor never reaches the kernel); other types and a
    gamma of the wrong width are refused first."""
    before = rmsnorm_kernel.launches
    for dt, gt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm_kernel(torch.zeros((2, 8), dtype=dt), torch.zeros(8, dtype=gt))
    with pytest.raises(TypeError):
        rmsnorm_kernel(torch.zeros((2, 8), dtype=torch.float16), torch.zeros(8))
    with pytest.raises(ValueError, match="gamma"):
        rmsnorm_kernel(torch.zeros((2, 8)), torch.zeros(4))
    ops.rmsnorm(torch.zeros((2, 8)), torch.zeros(8))
    assert rmsnorm_kernel.launches == before
