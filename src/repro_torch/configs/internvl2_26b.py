"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
-- InternViT frontend + InternLM2-20B backbone [arXiv:2404.16821]. The
reference's config, field for field.

The vision tower is a stub: precomputed patch embeddings [B,
frontend_tokens, frontend_dim] are projected into the LM embedding space
(``frontend_proj``) and prepended to the text token embeddings.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab_size=92553,
    norm="rmsnorm",
    act="silu",
    glu=True,
    attn=AttnConfig(num_heads=48, num_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0),
    frontend="patch",
    frontend_tokens=1024,  # 448x448 InternViT pixel-unshuffled token budget
    frontend_dim=3200,  # InternViT-6B hidden size
    quant=QuantConfig(enable=False),
    optimizer="adafactor",
    microbatch_size=16,
)
