"""The paper's own architectures: ViT-T/S/B, DeiT-T/S/B and M3ViT-T/S
(MoE-ViT per Fan et al. NeurIPS'22, the baseline CoQMoE deploys).

M3ViT replaces every other MLP with a 16-expert top-2 MoE block.
All operate on 224x224 images, patch 16 -> 196 patches + [CLS] = 197 tokens,
ImageNet-1k head. Quantization: W8 A8 Attn4 (the paper's 8/8/4 row).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, QuantConfig

_Q = QuantConfig(enable=True, w_bits=8, a_bits=8, attn_bits=4)


def _vit(name: str, layers: int, d: int, heads: int, moe: bool) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="vit_moe" if moe else "vit",
        num_layers=layers,
        d_model=d,
        d_ff=4 * d,
        norm="layernorm",
        act="gelu",
        glu=False,
        attn=AttnConfig(num_heads=heads, num_kv_heads=heads,
                        head_dim=d // heads, rope_theta=0.0),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=4 * d, moe_every=2)
        if moe else None,
        num_classes=1000,
        image_tokens=197,
        quant=_Q,
    )


VIT_TINY = _vit("vit-tiny", 12, 192, 3, moe=False)
VIT_SMALL = _vit("vit-small", 12, 384, 6, moe=False)
VIT_BASE = _vit("vit-base", 12, 768, 12, moe=False)
DEIT_TINY = VIT_TINY.replace(name="deit-tiny")
DEIT_SMALL = VIT_SMALL.replace(name="deit-small")
DEIT_BASE = VIT_BASE.replace(name="deit-base")
M3VIT_TINY = _vit("m3vit-tiny", 12, 192, 3, moe=True)
M3VIT_SMALL = _vit("m3vit-small", 12, 384, 6, moe=True)

CONFIG = M3VIT_SMALL  # the paper's headline deployment (CoQMoE-C on U280)

ALL = {
    c.name: c
    for c in (VIT_TINY, VIT_SMALL, VIT_BASE, DEIT_TINY, DEIT_SMALL, DEIT_BASE,
              M3VIT_TINY, M3VIT_SMALL)
}
