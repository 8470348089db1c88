"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060].

The reference's config, field for field: ``impl="gshard"`` is kept (the
registry test compares the two), and ``serving.engine.serving_config``
switches it to the grouped kernel path the port runs.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, QuantConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    d_ff=0,  # all layers MoE
    vocab_size=50304,
    norm="rmsnorm",
    act="silu",
    glu=True,
    attn=AttnConfig(
        num_heads=16, num_kv_heads=16, head_dim=128,
        rope_theta=10_000.0, qk_norm=True,
    ),
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024, moe_every=1,
                  impl="gshard"),
    quant=QuantConfig(enable=False),
    optimizer="adamw",
    microbatch_size=32,
)
