"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000
ssm_state=64 -- Mamba-2 backbone + ONE shared attention block applied every 6
Mamba layers [arXiv:2411.15242]. The reference's config, field for field.

As in the reference, the shared block operates on x + x_embed (the embedding
stream re-injected) rather than concat(x, x_embed) with per-invocation LoRA.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,  # the shared attention block's MLP
    vocab_size=32000,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=112,
                    rope_theta=10_000.0),
    ssm=SSMConfig(state_dim=64, version=2, expand=2, conv_width=4, head_dim=64),
    shared_attn_every=6,
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=16,
)
