"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 -- GQA, squared-ReLU MLP, LayerNorm [arXiv:2402.16819]. The
reference's config, field for field.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    d_ff=73728,
    vocab_size=256000,
    norm="layernorm",
    act="relu2",  # squared ReLU
    glu=False,
    attn=AttnConfig(num_heads=96, num_kv_heads=8, head_dim=192,
                    rope_theta=10_000.0),
    quant=QuantConfig(enable=False),
    optimizer="adafactor",
    microbatch_size=8,
)
