"""Architecture registry of the port: the paper's eight vision configs, the
MoE LM it serves (OLMoE-1B-7B), the dense LMs (gemma2-2b, gemma-7b,
llama3-8b) and the Mamba-1 LM (falcon-mamba-7b)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import moe_vit as _moe_vit
from repro_torch.configs.base import (
    AttnConfig,
    AutoscaleConfig,
    AutotuneConfig,
    ContinuousBatchingConfig,
    FaultConfig,
    IntrospectConfig,
    ModelConfig,
    MoEConfig,
    QuantConfig,
    SHAPES,
    TRAIN_4K,
    ShapeConfig,
    SSMConfig,
    TraceConfig,
)
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B

REGISTRY: Dict[str, ModelConfig] = {cfg.name: cfg for cfg in (
    OLMOE_1B_7B, FALCON_MAMBA_7B, GEMMA2_2B, GEMMA_7B, LLAMA3_8B)} | _moe_vit.ALL


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def smoke_config(arch: str) -> ModelConfig:
    """A reduced config of the same family for CPU smoke tests (the rules of
    ``repro.configs.smoke_config``): 4 layers, d=64, 4 heads of 16, 8
    experts with d_ff 32, SSM state 8, vocab at most 256, no gradient
    accumulation; vision configs get 10 classes and 17 tokens."""
    cfg = get_config(arch)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 256) if cfg.vocab_size else 0,
        microbatch_size=0,
    )
    if cfg.attn is not None:
        ratio = max(1, cfg.attn.num_heads // cfg.attn.num_kv_heads)
        kw["attn"] = dataclasses.replace(
            cfg.attn, num_heads=4, num_kv_heads=max(1, 4 // ratio),
            head_dim=16, local_window=16 if cfg.attn.local_window else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=8, head_dim=16 if cfg.ssm.version == 2 else 64)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=32
        )
    if cfg.num_classes:
        kw["num_classes"] = 10
        kw["image_tokens"] = 17
    return cfg.replace(**kw)


__all__ = [
    "REGISTRY",
    "AttnConfig",
    "AutoscaleConfig",
    "AutotuneConfig",
    "ContinuousBatchingConfig",
    "FaultConfig",
    "IntrospectConfig",
    "ModelConfig",
    "MoEConfig",
    "QuantConfig",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "TRAIN_4K",
    "TraceConfig",
    "get_config",
    "get_shape",
    "smoke_config",
]
