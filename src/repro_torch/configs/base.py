"""Config dataclasses of the PyTorch port.

A copy of the fields of ``repro.configs.base`` that the ViT path reads; the
port keeps its own configs so that it never imports the JAX package. The
names, defaults and meanings are the reference's, so a test can compare the
two field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    local_window: int = 0  # 0 = global attention
    logit_softcap: float = 0.0
    qk_norm: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    # grouped = sort-based unified kernel (the only mode the port runs)
    impl: str = "grouped"
    moe_exec: str = "single"


@dataclass(frozen=True)
class QuantConfig:
    """The paper's dual-stage quantization scheme (CoQMoE section 3)."""

    enable: bool = False
    w_bits: int = 8
    a_bits: int = 8
    attn_bits: int = 4  # post-softmax log-sqrt2 quantizer bits
    # per-site mixed-scheme map of int4 materialization (not ported yet)
    scheme_map: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # vit | vit_moe (M3ViT: every other block is MoE)
    num_layers: int
    d_model: int
    d_ff: int
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu | relu2
    glu: bool = True
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    num_classes: int = 0
    image_tokens: int = 0  # 197 for a 224/16 ViT (196 patches + cls)
    quant: QuantConfig = field(default_factory=QuantConfig)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
