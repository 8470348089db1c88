"""Shared model layers of the vision path, ported from
``repro.models.layers``: LayerNorm, the quantized/full-precision linear
seam, the MLP and the cache-free non-causal attention block. Plain functions
over nested dicts of tensors."""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.core.quant.linear_quant import fake_quant_activation
from repro_torch.core.quant.qtypes import (
    ASCALE_SUFFIX,
    SCALE_SUFFIX,
    quantize_sym,
    unpack_int4,
)
from repro_torch.kernels import ops


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(dt)


def apply_norm(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm != "layernorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    y = layernorm(x, p["scale"], p["bias"])
    if "a_scale" in p:
        # PTQ runtime: per-layer symmetric quantizer with the reparam scale
        y = fake_quant_activation(y.float(), p["a_scale"],
                                  bits=cfg.quant.a_bits).to(y.dtype)
    return y


def maybe_fake_quant(x: torch.Tensor, p: dict, key: str, cfg: ModelConfig):
    """Per-tensor symmetric activation quant at a linear input site."""
    if key in p:
        return fake_quant_activation(x.float(), p[key],
                                     bits=cfg.quant.a_bits).to(x.dtype)
    return x


def quant_linear(x: torch.Tensor, p: dict, key: str,
                 cfg: ModelConfig) -> torch.Tensor:
    """Apply the linear layer stored at ``p[key]``: the single seam every
    linear call site routes through, dispatched on the weight dtype.

      * fp leaf: the plain matmul (fp and fake-quant trees);
      * int8 leaf: quantize x with the folded ``<key>_as`` scale (for key
        ``"wo"``, the ``wo_a_scale`` leaf) and run the int8 kernel, which
        dequantizes once on the int32 accumulator (Eq. 9). Sites with no
        activation scale (``patch_proj``) keep x fp: the per-output-channel
        weight scale factors out of the contraction;
      * uint8 leaf (nibble-packed int4): unpacked to int8 values first.
    """
    w = p[key]
    if w.dtype == torch.uint8:
        w = unpack_int4(w, x.shape[-1])
    if w.dtype != torch.int8:
        return x @ w
    w_scale = p[key + SCALE_SUFFIX]
    a_scale = p.get(key + ASCALE_SUFFIX,
                    p.get("wo_a_scale") if key == "wo" else None)
    lead, d_in = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d_in)
    if a_scale is None:
        y = (x2.float() @ w.float()) * w_scale
    else:
        x_q = quantize_sym(x2.float(), a_scale, cfg.quant.a_bits)
        y = ops.int8_matmul(x_q, w, a_scale, w_scale)
    return y.reshape(lead + (w.shape[-1],)).to(x.dtype)


def act_fn(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":  # the tanh form, as jax.nn.gelu(approximate=True)
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def mlp_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, taps=None) -> torch.Tensor:
    """GLU (wi fused [d, 2ff]) or plain MLP (wi [d, ff]); wo [ff, d]."""
    h = quant_linear(x, p, "wi", cfg)
    if "bi" in p:
        h = h + p["bi"]
    if cfg.glu:
        gate, up = torch.chunk(h, 2, dim=-1)
        h = act_fn(cfg.act)(gate) * up
    else:
        h = act_fn(cfg.act)(h)
    maybe_record(taps, "mlp_mid", h)
    if p["wo"].dtype != torch.int8:
        h = maybe_fake_quant(h, p, "wo_a_scale", cfg)
    y = quant_linear(h, p, "wo", cfg)
    if "bo" in p:
        y = y + p["bo"]
    return y


def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    a: AttnConfig, taps=None) -> torch.Tensor:
    """Cache-free, non-causal MSA block: qkv proj -> streaming attention ->
    out proj (the vision models' only attention)."""
    if a.rope_theta > 0 or a.qk_norm or a.logit_softcap or a.local_window:
        raise NotImplementedError(
            "RoPE, QK-norm, softcap and local windows come with the LM path")
    B, S, _ = x.shape
    q = quant_linear(x, p, "wq", cfg).reshape(B, S, a.num_heads, a.head_dim)
    k = quant_linear(x, p, "wk", cfg).reshape(B, S, a.num_kv_heads, a.head_dim)
    v = quant_linear(x, p, "wv", cfg).reshape(B, S, a.num_kv_heads, a.head_dim)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, a.num_heads, a.head_dim)
    if "bk" in p:
        k = k + p["bk"].reshape(1, 1, a.num_kv_heads, a.head_dim)
        v = v + p["bv"].reshape(1, 1, a.num_kv_heads, a.head_dim)
    quant_bits = cfg.quant.attn_bits if cfg.quant.enable else 0
    out = ops.attention(q, k, v, causal=False, quant_bits=quant_bits)
    out = out.reshape(B, S, a.num_heads * a.head_dim)
    maybe_record(taps, "attn_out", out)
    if p["wo"].dtype != torch.int8:
        out = maybe_fake_quant(out, p, "wo_a_scale", cfg)
    y = quant_linear(out, p, "wo", cfg)
    if "bo" in p:
        y = y + p["bo"]
    return y
