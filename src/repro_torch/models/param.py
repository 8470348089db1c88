"""Single-source param definitions, ported from ``repro.models.param``.

Each model family describes its parameters once as a nested dict of
``PDef`` (shape + initializer); ``init_params`` materializes it with a
``torch.Generator`` on an explicit device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PDef:
    """Declarative parameter definition."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # stddev override for normal init


def stack_tree(tree, n: int):
    """Prepend a stacked-layers dim to every PDef of ``tree``."""
    if isinstance(tree, dict):
        return {k: stack_tree(v, n) for k, v in tree.items()}
    return dataclasses.replace(tree, shape=(n,) + tree.shape)


def dense(d_in: int, d_out: int, scale: Optional[float] = None) -> PDef:
    return PDef((d_in, d_out), scale=scale)


def vector(d: int, init: str = "zeros") -> PDef:
    return PDef((d,), init=init)


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[-2] if len(shape) >= 2 else max(shape[-1], 1)


def _materialize(p: PDef, gen: torch.Generator, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, device=device)
    std = p.scale if p.scale is not None else 1.0 / math.sqrt(_fan_in(p.shape))
    if p.init == "small_normal":
        std = 0.02
    return torch.randn(p.shape, generator=gen, device=device) * std


def init_params(tree, gen: torch.Generator, device):
    """Materialize a PDef tree into f32 tensors on ``device``, leaves in
    sorted-key order (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: init_params(tree[k], gen, device) for k in sorted(tree)}
    return _materialize(tree, gen, device)


def tree_to(tree, device):
    """A nested dict of tensors moved to ``device`` (leaf dtypes kept)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tree_bytes(tree) -> int:
    """Total bytes of a concrete tree, honoring leaf dtypes."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
