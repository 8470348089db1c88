"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000 --
GeGLU, head_dim=256, tied embeddings, sqrt(d) embed scale
[arXiv:2403.08295]. The reference's config, field for field.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    d_ff=24576,
    vocab_size=256000,
    norm="rmsnorm",
    act="gelu",
    glu=True,  # GeGLU
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=256,
                    rope_theta=10_000.0),
    tie_embeddings=True,
    embed_scale=True,
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=32,
)
