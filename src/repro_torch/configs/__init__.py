"""Architecture registry of the port: the paper's eight vision configs."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import moe_vit as _moe_vit
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, QuantConfig

REGISTRY: Dict[str, ModelConfig] = dict(_moe_vit.ALL)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch]


def smoke_config(arch: str) -> ModelConfig:
    """A reduced config of the same family for CPU smoke tests (the vision
    rules of ``repro.configs.smoke_config``): 4 layers, d=64, 4 heads of
    16, 8 experts with d_ff 32, 10 classes, 17 tokens."""
    cfg = get_config(arch)
    ratio = max(1, cfg.attn.num_heads // cfg.attn.num_kv_heads)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        attn=dataclasses.replace(
            cfg.attn, num_heads=4, num_kv_heads=max(1, 4 // ratio),
            head_dim=16, local_window=16 if cfg.attn.local_window else 0,
        ),
        num_classes=10,
        image_tokens=17,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=32
        )
    return cfg.replace(**kw)


__all__ = [
    "REGISTRY",
    "AttnConfig",
    "ModelConfig",
    "MoEConfig",
    "QuantConfig",
    "get_config",
    "smoke_config",
]
