"""Models of the port (``repro.models``): the vision families (ViT, DeiT,
M3ViT), the decoder-only LM families (dense, MoE, vlm), the Mamba-1 LM
(ssm), the Mamba-2 hybrid (hybrid) and the encoder-decoder (encdec),
behind one registry.

``module_for(cfg)`` returns the family module; each exposes
``abstract_params(cfg)`` and ``forward(params, cfg, x, taps=)`` (x: patches
for the vision families, tokens for the LM; the frontend families also
``frontend_embeds=``), and the LM families also ``prefill``,
``decode_step``, ``init_cache`` and ``cache_shapes`` (the transformer also
``prefill_packed``). ``forward`` also takes a pipeline batch dict, as the
reference's does (``train/losses.py``).
"""
from types import ModuleType

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer, vit
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
    "vlm": transformer,
    "ssm": ssm_lm,
    "hybrid": hybrid,
    "encdec": encdec,
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


def forward(params, cfg: ModelConfig, x, taps=None, frontend_embeds=None):
    """Teacher-forced forward of any ported family: patches [B, T, P] ->
    (class logits, aux) or tokens [B, S] -> (logits [B, S, V], aux), the
    frontend families with ``frontend_embeds`` (the vlm's patch embeddings,
    prepended; the encoder-decoder's frames). ``x`` may also be a batch
    dict (the reference's ``forward(params, cfg, batch)``, a
    ``data.SyntheticPipeline`` batch): its ``patches``, or its ``tokens``
    and ``frontend_embeds``, are taken."""
    if isinstance(x, dict):
        frontend_embeds = x.get("frontend_embeds")
        x = x["patches"] if cfg.family in ("vit", "vit_moe") else x["tokens"]
    if cfg.frontend:
        return module_for(cfg).forward(params, cfg, x, frontend_embeds=frontend_embeds,
                                       taps=taps)
    return module_for(cfg).forward(params, cfg, x, taps=taps)


def frontend_tokens(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Positions the modality frontend contributes to a cell."""
    if not cfg.frontend:
        return 0
    if cfg.family == "encdec":
        return shape.seq_len  # the frames are the encoder's sequence
    return min(cfg.frontend_tokens, max(shape.seq_len // 2, 8))


def text_tokens_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token length of a batch of ``shape``: the patches of a vision model
    (``image_tokens - 1``; [CLS] makes ``image_tokens``), the decoder's
    tokens of an encoder-decoder (``encdec.dec_len_for``), else the
    sequence length less the frontend's positions."""
    if cfg.family == "encdec":
        return encdec.dec_len_for(shape.seq_len)
    if cfg.family in ("vit", "vit_moe"):
        return cfg.image_tokens - 1
    return shape.seq_len - frontend_tokens(cfg, shape)


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
    "encdec",
    "forward",
    "frontend_tokens",
    "hybrid",
    "init_model_params",
    "module_for",
    "ssm_lm",
    "synth_batch",
    "synth_patches",
    "text_tokens_for",
    "transformer",
    "tree_bytes",
    "vit",
]
