"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free vocab=65024 ssm_state=16.

Mamba-1 architecture [arXiv:2410.05355]: d_inner 8192, conv width 4, dt
rank 256, RMSNorm, tied embeddings. The reference's config, field for field
(the registry test compares the two).
"""
from repro_torch.configs.base import ModelConfig, QuantConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,  # attention-free, MLP-free: pure Mamba blocks
    vocab_size=65024,
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=16, version=1, expand=2, conv_width=4),
    tie_embeddings=True,
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=16,
)
