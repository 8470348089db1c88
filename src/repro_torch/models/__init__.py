"""Models of the port (``repro.models``): the vision families (ViT, DeiT,
M3ViT) and the decoder-only LM families (dense, MoE), behind one registry.

``module_for(cfg)`` returns the family module; each exposes
``abstract_params(cfg)`` and ``forward(params, cfg, x, taps)`` (x: patches
for the vision families, tokens for the LM), and the LM also ``prefill``,
``prefill_packed``, ``decode_step`` and ``init_cache``.
"""
from types import ModuleType

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer, vit
from repro_torch.models.param import init_params, require_device, tree_bytes
from repro_torch.models.vit import (
    PATCH_DIM,
    ViTClassifier,
    classify,
    synth_patches,
)

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vit": vit,
    "vit_moe": vit,
}


def module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return _FAMILY_MODULES[cfg.family]


def abstract_params(cfg: ModelConfig) -> dict:
    return module_for(cfg).abstract_params(cfg)


def init_model_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random f32 weights of any ported family on ``device`` (a CUDA
    device without a card raises; pass ``device="cpu"`` for the CPU)."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(abstract_params(cfg), gen, dev)


def forward(params, cfg: ModelConfig, x: torch.Tensor, taps=None):
    """Teacher-forced forward of any ported family: patches [B, T, P] ->
    (class logits, aux) or tokens [B, S] -> (logits [B, S, V], aux)."""
    return module_for(cfg).forward(params, cfg, x, taps=taps)


def synth_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0) -> np.ndarray:
    """Seeded synthetic token batch [batch, seq_len] int32 in [0, vocab)
    (numpy, so both frameworks can be fed the same input)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, seq_len)).astype(np.int32)


__all__ = [
    "PATCH_DIM",
    "ViTClassifier",
    "abstract_params",
    "classify",
    "forward",
    "init_model_params",
    "module_for",
    "synth_batch",
    "synth_patches",
    "transformer",
    "tree_bytes",
    "vit",
]
