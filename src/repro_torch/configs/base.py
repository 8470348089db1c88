"""Config dataclasses of the PyTorch port.

A copy of the fields of ``repro.configs.base`` that the ViT, LM and SSM
serving paths read; the port keeps its own configs so that it never imports the JAX
package. The names, defaults and meanings are the reference's, so a test can
compare the two field by field.
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
    moe_every: int = 1  # every Nth layer is MoE (the port runs 1 only)
    # grouped = sort-based unified kernel (the only mode the port runs;
    # gshard configs are switched to it by ``serving_config``)
    impl: str = "grouped"
    moe_exec: str = "single"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int
    version: int = 1  # 1 = Mamba-1 (falcon-mamba), 2 = Mamba-2 (zamba2)
    expand: int = 2
    conv_width: int = 4
    head_dim: int = 64  # mamba2 only
    dt_rank: int = 0  # mamba1; 0 = ceil(d_model / 16)
    scan_chunk: int = 128  # the reference's chunked-scan length (unused here)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class QuantConfig:
    """The paper's dual-stage quantization scheme (CoQMoE section 3)."""

    enable: bool = False
    w_bits: int = 8
    a_bits: int = 8
    attn_bits: int = 4  # post-softmax log-sqrt2 quantizer bits
    kv_cache_int8: bool = True  # serving: int8 K/V cache
    # per-site mixed-scheme map of ``ptq_model(materialize="int4")``:
    # (dotted-path-suffix pattern, scheme) pairs, longest suffix wins,
    # unmatched sites stay int8; empty = ``ptq.DEFAULT_INT4_SCHEME``
    scheme_map: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class ContinuousBatchingConfig:
    """Continuous-batching knobs of ``serving.engine.ServeEngine``: packed
    prefill of up to ``batch_slots`` prompts in one ``[1, bucket]`` buffer
    (segment-masked attention), power-of-two bucket ladder from
    ``min_bucket`` to ``max_prefill``, and token retirement on a thread."""

    packed_prefill: bool = True
    # token budget of one packed prefill; 0 = the engine max_len
    max_prefill: int = 0
    min_bucket: int = 32
    async_retire: bool = True
    # build every serving program at warmup(): on the card each is a
    # captured CUDA graph (False: every step runs eagerly, programs are
    # built on first use)
    aot_warmup: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # moe | dense | ssm | vit | vit_moe (M3ViT: every other block is MoE)
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu | relu2
    glu: bool = True
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeds by sqrt(d_model)
    post_block_norm: bool = False  # gemma2 sandwich norms
    final_logit_softcap: float = 0.0
    num_classes: int = 0
    image_tokens: int = 0  # 197 for a 224/16 ViT (196 patches + cls)
    quant: QuantConfig = field(default_factory=QuantConfig)
    # continuous-batching serving path (serving/engine.py)
    serve: ContinuousBatchingConfig = field(
        default_factory=ContinuousBatchingConfig)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
