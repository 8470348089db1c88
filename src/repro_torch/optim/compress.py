"""INT8 gradient compression with error feedback, ported from
``repro.optim.compress``.

Each gradient leaf is quantized per-tensor symmetric INT8 (before a
data-parallel reduction, 4x fewer bytes than f32) and dequantized after;
the quantization error is carried in a per-leaf residual and added to the
next step's gradient (error feedback, Karimireddy et al. 2019), which keeps
SGD-style convergence. ``train/train_step.py`` runs the single-pod form
(quantize, then dequantize the codes at once) when ``grad_compress`` is
on, and across pods ``pod_compress`` / ``pod_decompress``: the reference's
cross-pod reduction, with one scale shared by the pods and no residual.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.param import tree_map, tree_unzip


class CompressState(NamedTuple):
    residual: Any  # tree of f32 error-feedback residuals


def init_compress_state(params) -> CompressState:
    return CompressState(
        residual=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _quantize_one(g: torch.Tensor, r: torch.Tensor):
    gf = g.to(torch.float32) + r
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    new_r = gf - q * scale  # error-feedback residual
    return q.to(torch.int8), scale, new_r


def compress_grads(grads, state: CompressState) -> Tuple[Any, Any, CompressState]:
    """Returns (int8 codes tree, scales tree, new residual state)."""
    codes, scales, residual = tree_unzip(tree_map(_quantize_one, grads, state.residual), 3)
    return codes, scales, CompressState(residual=residual)


def decompress_sum(codes_sum, scales, n_participants: int):
    """Dequantize a summed int32 code tree: each leaf times its scale, over
    ``n_participants`` (the mean of a reduction over that many)."""
    return tree_map(lambda c, s: c.to(torch.float32) * s / n_participants, codes_sum, scales)


def pod_compress(pod_grads: list):
    """The cross-pod INT8 coding of per-pod gradient trees, in the
    reference's arithmetic (``repro/train/train_step.py``,
    ``_pod_compressed_grads``), leaf by leaf: scale = max over the pods of
    (max |g| / 127) + 1e-30; codes clip(round(g / scale), -127, 127),
    rounding half to even; their int32 sum over the pods in order. Returns
    (int32 code sums tree, scales tree)."""
    def one(*gs):
        scale = torch.stack([torch.amax(torch.abs(g)) / 127.0 for g in gs]).amax() + 1e-30
        total = torch.zeros(gs[0].shape, dtype=torch.int32, device=gs[0].device)
        for g in gs:
            total += torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
        return total, scale

    return tree_unzip(tree_map(one, *pod_grads), 2)


def pod_decompress(codes_sum, scales, n_pods: int):
    """The mean over ``n_pods`` of ``pod_compress``'s sums: each leaf times
    (scale / n), the reference's order of operations."""
    return tree_map(lambda c, s: c.to(torch.float32) * (s / n_pods), codes_sum, scales)
