"""The train step, ported from ``repro.train.train_step``: gradients of
``loss_and_metrics`` (microbatch accumulation when the config asks for it),
the single-pod error-feedback INT8 compression, global-norm clipping and
the optimizer update.

On one card every placement is replicated: the reference's GSPMD
shardings (``distributed/sharding_rules.py``) and its cross-pod compressed
reduction (a ``shard_map`` over a ``pod`` mesh axis) are not ported, and a
mesh with a ``pod`` axis larger than 1 raises ``NotImplementedError``.
Gradients reach the weights through the hand kernels' backward
(``kernels/autograd.py``); with ``cfg.remat`` each block is recomputed in
the backward pass (``models/transformer.py``, ``models/vit.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import batch_to
from repro_torch.models.param import require_device, tree_leaves, tree_map
from repro_torch.optim import (
    CompressState,
    Optimizer,
    clip_by_global_norm,
    compress_grads,
    decompress_sum,
    init_compress_state,
)
from repro_torch.train.losses import loss_and_metrics


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar
    compress: Optional[CompressState] = None


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, seed: int = 0, *,
                     grad_compress: bool = False, device="cuda",
                     params=None) -> TrainState:
    """Step 0: the port's seeded f32 init on ``device`` (or ``params``, a
    tree already on its device: the tests bring the reference's across with
    ``bridge.params_from_numpy``), the optimizer's zero state and, with
    ``grad_compress``, zero residuals."""
    if params is None:
        params = models.init_model_params(cfg, seed, require_device(device))
    dev = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        compress=init_compress_state(params) if grad_compress else None,
    )


def value_and_grad(params, cfg: ModelConfig, batch: dict):
    """(grads, metrics) of ``loss_and_metrics`` at ``params``: the
    reference's ``jax.value_and_grad(loss_and_metrics, has_aux=True)``.
    A leaf the loss does not reach gets a zero gradient, as in JAX."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    with torch.enable_grad():
        loss, metrics = loss_and_metrics(leaves, cfg, batch)
        loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, leaves)
    return grads, {k: v.detach() for k, v in metrics.items()}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh, optimizer: Optimizer, *,
                     grad_compress: bool = False, max_grad_norm: float = 1.0):
    """Returns a ``(state, batch) -> (state, metrics)`` step. ``batch`` is a
    pipeline batch (numpy arrays, or tensors), moved to the params' device.

    With ``cfg.microbatch_size`` below ``shape.global_batch`` the batch is
    cut into that many-row microbatches in order, and their gradients are
    added as ``g / n_micro`` in f32 in microbatch order; the metrics are
    the last microbatch's. ``mesh`` (the port's ``launch.mesh.Mesh``, or
    None): a ``pod`` axis larger than 1 raises ``NotImplementedError``."""
    micro = cfg.microbatch_size
    n_micro = 1
    if micro and shape.global_batch > micro:
        if shape.global_batch % micro:
            raise ValueError(f"global batch {shape.global_batch} is not a multiple of "
                             f"the microbatch {micro}")
        n_micro = shape.global_batch // micro
    if mesh is not None and mesh.shape.get("pod", 1) > 1:
        raise NotImplementedError(
            "the cross-pod compressed-gradient reduction (a pod mesh axis) is not "
            "ported; the port trains on one card")

    def grads_fn(params, batch):
        if n_micro == 1:
            return value_and_grad(params, cfg, batch)
        size = shape.global_batch // n_micro
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        for i in range(n_micro):
            one = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            g, metrics = value_and_grad(params, cfg, one)
            acc = tree_map(lambda a, b: a + b.to(torch.float32) / n_micro, acc, g)
        return acc, metrics

    def step_fn(state: TrainState, batch: dict):
        dev = state.step.device
        batch = batch_to(batch, dev)
        grads, metrics = grads_fn(state.params, batch)
        with torch.no_grad():
            new_compress = state.compress
            if grad_compress and state.compress is not None:
                # single-pod: the compressor's quantize-dequantize with error
                # feedback (the reduction's byte saving needs the pod axis)
                codes, scales, new_compress = compress_grads(grads, state.compress)
                grads = decompress_sum(tree_map(lambda c: c.to(torch.int32), codes),
                                       scales, 1)
            grads, grad_norm = clip_by_global_norm(grads, max_grad_norm)
            new_params, new_opt = optimizer.update(grads, state.opt_state, state.params,
                                                   state.step)
        metrics = dict(metrics, grad_norm=grad_norm)
        return TrainState(params=new_params, opt_state=new_opt, step=state.step + 1,
                          compress=new_compress), metrics

    return step_fn
