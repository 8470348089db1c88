"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [arXiv:2407.21783]. The reference's config, field for field.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    norm="rmsnorm",
    act="silu",
    glu=True,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=32,
)
