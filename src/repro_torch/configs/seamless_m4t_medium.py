"""seamless-m4t-medium [audio]: enc-dec 12L(enc)+12L(dec) d_model=1024 16H
(kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596]. The reference's config,
field for field.

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings [B, S, frontend_dim]; the decoder consumes text tokens.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=24,
    encoder_layers=12,
    decoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    act="gelu",
    glu=False,
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=64,
                    rope_theta=10_000.0),
    frontend="frame",
    frontend_dim=1024,
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=32,
)
