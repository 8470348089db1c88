"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family]. The
reference's config, field for field (``impl="gshard"``: the engines'
``serving_config`` switches it to the grouped kernel).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, QuantConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    d_ff=0,  # every layer MoE
    vocab_size=151936,
    norm="rmsnorm",
    act="silu",
    glu=True,
    attn=AttnConfig(
        num_heads=64, num_kv_heads=4, head_dim=128,
        rope_theta=1_000_000.0, qk_norm=True,
    ),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536, moe_every=1, impl="gshard"),
    quant=QuantConfig(enable=False),
    optimizer="adafactor",
    microbatch_size=16,
)
