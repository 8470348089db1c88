"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 --
local(4096)+global alternating attention, logit softcap, sandwich norms
[arXiv:2408.00118]. The reference's config, field for field.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256000,
    norm="rmsnorm",
    act="gelu",
    glu=True,  # GeGLU
    attn=AttnConfig(
        num_heads=8, num_kv_heads=4, head_dim=256,
        rope_theta=10_000.0,
        local_window=4096,
        alternate_local_global=True,
        logit_softcap=50.0,
    ),
    tie_embeddings=True,
    embed_scale=True,
    post_block_norm=True,
    final_logit_softcap=30.0,
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=32,
)
