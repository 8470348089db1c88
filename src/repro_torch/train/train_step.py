"""The train step, ported from ``repro.train.train_step``: gradients of
``loss_and_metrics`` (microbatch accumulation when the config asks for it),
the single-pod error-feedback INT8 compression, the cross-pod INT8
reduction, global-norm clipping and the optimizer update.

On a mesh whose ``pod`` axis is n > 1, with ``grad_compress``, each pod
slot takes its 1/n slice of the batch and computes its gradients, which are
coded and summed as the reference codes them for its one cross-pod
all-reduce (``optim.pod_compress`` / ``pod_decompress``). The port drives
every slot from one process and the slots share one card (as
expert-parallel slots do): the sum is a loop over the slots' codes, not a
collective. Without ``grad_compress`` the
pod axis is plain data parallelism, the gradient of the whole batch.
``state_specs`` gives the sharding specs of a ``TrainState``
(``distributed/sharding_rules.py``); on one card every placement is
replicated. Gradients reach the weights through the hand kernels' backward
(``kernels/autograd.py``); with ``cfg.remat`` each block is recomputed in
the backward pass (``models/transformer.py``, ``models/vit.py``,
``models/ssm_lm.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import batch_to
from repro_torch.distributed.sharding_rules import param_specs
from repro_torch.launch.mesh import single_device
from repro_torch.models.param import require_device, tree_leaves, tree_map
from repro_torch.optim import (
    CompressState,
    Optimizer,
    clip_by_global_norm,
    compress_grads,
    decompress_sum,
    init_compress_state,
    pod_compress,
    pod_decompress,
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


def state_specs(cfg: ModelConfig, optimizer: Optimizer, mesh=None, *,
                grad_compress: bool = False) -> TrainState:
    """The sharding specs of a ``TrainState``: the params' from the rules,
    the optimizer's from its ``state_specs``, the step replicated, the
    error-feedback residuals as the params."""
    p_specs = param_specs(cfg, mesh)
    shapes = tree_map(lambda p: tuple(p.shape), models.abstract_params(cfg))
    return TrainState(params=p_specs, opt_state=optimizer.state_specs(p_specs, shapes),
                      step=(), compress=CompressState(residual=p_specs) if grad_compress else None)


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
    None): with ``grad_compress``, a ``pod`` axis of n > 1 runs the
    cross-pod reduction (see the module docstring), each pod slot on its
    1/n slice, the metrics averaged over the pods, the error-feedback
    residuals left as they were (the reference's branch); the slots must
    share one device."""
    micro = cfg.microbatch_size
    n_micro = 1
    if micro and shape.global_batch > micro:
        if shape.global_batch % micro:
            raise ValueError(f"global batch {shape.global_batch} is not a multiple of "
                             f"the microbatch {micro}")
        n_micro = shape.global_batch // micro
    n_pods = 1 if mesh is None else mesh.shape.get("pod", 1)
    if grad_compress and n_pods > 1:
        single_device(mesh)  # the slots share one device
        if shape.global_batch % n_pods:
            raise ValueError(f"global batch {shape.global_batch} over {n_pods} pods")

    def grads_fn(params, batch):
        if n_micro == 1:
            return value_and_grad(params, cfg, batch)
        size = len(next(iter(batch.values()))) // n_micro
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
        if grad_compress and n_pods > 1:
            size = shape.global_batch // n_pods
            per = [grads_fn(state.params, {k: v[i * size:(i + 1) * size]
                                           for k, v in batch.items()})
                   for i in range(n_pods)]
            with torch.no_grad():
                grads = pod_decompress(*pod_compress([g for g, _ in per]), n_pods)
            metrics = {k: sum(m[k] for _, m in per) / n_pods for k in per[0][1]}
            del per  # the pods' gradients, before the update allocates its own
        else:
            grads, metrics = grads_fn(state.params, batch)
        with torch.no_grad():
            new_compress = state.compress
            if grad_compress and n_pods == 1 and state.compress is not None:
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
