"""Weights across the two packages, as numpy arrays.

``params_from_numpy`` turns a nested dict of numpy arrays (for example
``jax.tree.map(np.asarray, params)`` of a ``repro`` tree) into the port's
tree of tensors, keeping every leaf's dtype (f32, int8, nibble-packed
uint8), every QuantizedParams leaf (``<w>_scale``, ``<w>_as``, the norm
``a_scale``, ``wo_a_scale``) and the leading stacked-layer dims.
``params_to_numpy`` goes the other way.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device) -> dict:
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree) -> dict:
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
