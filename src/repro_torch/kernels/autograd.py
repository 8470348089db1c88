"""Gradients through the hand-written kernels.

The reference has no backward kernel (no ``custom_vjp`` under
``repro/kernels/``): its gradients are XLA's autodiff of its forward. The
port's wrappers in ``kernels/ops.py`` take these routes when an input
requires grad and grad mode is on:

  * the grouped matmul's f32 mode, ``GroupedMatmul``: forward the grouped
    kernel; ``dx = grouped_matmul(dy, w^T)``, the same kernel on the
    transposed stack (copied to a contiguous ``[G, Dout, Din]``); ``dw``
    the grouped weight-gradient kernel (``expert_linear.grouped_wgrad``).
    This is the backward of the reference's ``jax.lax.ragged_dot``;
  * the selective scan, ``SelectiveScan``: forward the scan kernel, saving
    its inputs; backward the scan's backward kernel
    (``selective_scan.selective_scan_bwd``), which rebuilds the states from
    saved chunk starts. The reference differentiates its chunked
    associative scan with XLA;
  * attention and RMSNorm, ``Recompute``: forward through the kernel,
    saving the inputs; the backward runs the plain version
    (``kernels/ref.py``) again on detached copies with grad enabled and
    returns ``torch.autograd.grad`` of it. That is the reference's own
    gradient (XLA's autodiff of the same plain ops), with its ``remat=True``
    recompute semantics; it keeps the plain version's zero derivatives
    (``round`` and ``clip`` of the 4-bit log-sqrt2 codes: q and k get a
    gradient only through the softmax denominator, v through f / l; no
    straight-through estimator) and its tie rule (``amax`` splits a tie's
    gradient evenly, as ``jnp.max`` does). A hand-written backward kernel
    for these is later speed work;
  * every other kernel (the integer modes of the grouped matmul,
    ``int8_matmul``) raises ``NotImplementedError`` on a CUDA tensor that
    requires grad (``no_backward``): an output with no ``grad_fn`` would
    freeze the weights behind it without a word.

On the CPU the same Functions run with the plain versions in the
kernels' place (``ops.py`` hands them in), so the CPU tests hold the
backward's structure against the reference.
"""
from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these inputs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def no_backward(kernel: str, *tensors) -> None:
    """Raise for a kernel with no backward whose inputs require grad."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward on the card: its output would carry no "
            "gradient to the inputs that require one (train an fp tree, or run "
            "under torch.no_grad())")


class GroupedMatmul(torch.autograd.Function):
    """y = grouped_matmul(x, w, group_sizes) in the f32 mode, with ``dx``
    from the same grouped product on the transposed stack and ``dw`` from
    ``wgrad``. ``matmul`` and ``wgrad`` are the device dispatches of
    ``kernels/ops.py`` (kernel on the card, plain version on the CPU); both
    run with grad off, inside ``forward`` and ``backward``."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, matmul: Callable, wgrad: Callable):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.matmul, ctx.wgrad = matmul, wgrad
        return matmul(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ctx.matmul(dy, w.transpose(1, 2).contiguous(), group_sizes)
        if ctx.needs_input_grad[1]:
            dw = ctx.wgrad(x, dy, group_sizes)
        return dx, dw, None, None, None


class SelectiveScan(torch.autograd.Function):
    """(y, h_last) = scan(x, dt, b, c, a, d), the backward from
    ``scan_bwd(x, dt, b, c, a, d, dy, dh_last)`` on the saved inputs.
    ``scan`` and ``scan_bwd`` are the device dispatches of
    ``kernels/ops.py``. Where ``scan`` returns a third output (the kernel's
    chunk-start states), it is saved with the inputs and handed to
    ``scan_bwd`` as ``states``. An output whose gradient is not needed gets
    None (h_last's in a training step): dy then runs as zeros, dh_last is
    skipped."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, scan: Callable, scan_bwd: Callable):
        y, h_last, *states = scan(x, dt, b, c, a, d)
        ctx.save_for_backward(x, dt, b, c, a, d, *states)
        ctx.scan_bwd = scan_bwd
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, b, c, a, d, *states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy
        kw = {"states": states[0]} if states else {}
        grads = ctx.scan_bwd(x, dt, b, c, a, d, dy, dh_last, **kw)
        return (*grads, None, None)


class Recompute(torch.autograd.Function):
    """``kernel(*inputs)`` forward; the backward differentiates
    ``plain(*inputs)`` recomputed on detached copies. Both are closures over
    every argument that is not among ``inputs``."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        want = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) for t, w in zip(inputs, want)]
            out = ctx.plain(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t, w in zip(leaves, want) if w], grad))
        return (None, None, *(next(grads) if w else None for w in want))

