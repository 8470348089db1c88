"""Architecture registry of the port: the paper's eight vision configs and
the reference's ten LM configs -- the MoE LMs (OLMoE-1B-7B,
qwen3-moe-235b-a22b), the dense LMs (gemma2-2b, gemma-7b, llama3-8b,
nemotron-4-340b), the Mamba-1 LM (falcon-mamba-7b), the Mamba-2 hybrid
(zamba2-7b), the encoder-decoder (seamless-m4t-medium) and the VLM
(internvl2-26b)."""
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
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.nemotron_4_340b import CONFIG as NEMOTRON_4_340B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

REGISTRY: Dict[str, ModelConfig] = {cfg.name: cfg for cfg in (
    FALCON_MAMBA_7B, QWEN3_MOE_235B, OLMOE_1B_7B, NEMOTRON_4_340B, LLAMA3_8B,
    GEMMA_7B, GEMMA2_2B, ZAMBA2_7B, SEAMLESS_M4T_MEDIUM, INTERNVL2_26B)} | _moe_vit.ALL


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
    accumulation; an encoder-decoder 2 + 2 layers, a frontend 48 wide (a
    patch frontend 8 tokens), the hybrid 5 layers with the shared block
    every 2 (a remainder on purpose); vision configs get 10 classes and 17
    tokens."""
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
    if cfg.family == "encdec":
        kw["num_layers"] = 4
        kw["encoder_layers"] = 2
        kw["decoder_layers"] = 2
    if cfg.frontend:
        kw["frontend_tokens"] = 8 if cfg.frontend == "patch" else 0
        kw["frontend_dim"] = 48
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
        kw["num_layers"] = 5  # not a multiple on purpose: layers after the last block
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
