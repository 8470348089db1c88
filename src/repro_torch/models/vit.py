"""ViT / DeiT / M3ViT (MoE-ViT), the paper's own architectures, ported
from ``repro.models.vit``.

Input is flattened 16x16x3 patches [B, 196, 768]. M3ViT replaces every
other MLP with a 16-expert top-2 MoE block: its parameters are stacked per
(dense, moe) layer pair under ``pairs_dense`` / ``pairs_moe`` with a leading
pair dim, walked by a Python loop over pair i (dense, then MoE).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe.router import topk_stable
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.models.layers import (
    apply_norm,
    attention_block,
    mlp_apply,
    quant_linear,
)
from repro_torch.models.param import (
    PDef,
    dense,
    init_params,
    require_device,
    stack_tree,
    vector,
)
from repro_torch.models.transformer import (
    _attn_pdefs,
    _expert_count_zeros,
    _mlp_pdefs,
    _moe_apply,
    _moe_pdefs,
    _norm_pdefs,
    layer,
)

PATCH_DIM = 768  # 16*16*3


def _vit_layer_pdefs(cfg: ModelConfig, moe: bool) -> dict:
    p = {
        "ln1": _norm_pdefs(cfg),
        "attn": _attn_pdefs(cfg, bias=True),
        "ln2": _norm_pdefs(cfg),
    }
    if moe:
        m = _moe_pdefs(cfg)
        m["gate_b"] = vector(cfg.moe.num_experts)
        hid = 2 * cfg.moe.d_ff if cfg.glu else cfg.moe.d_ff
        m["bi"] = PDef((cfg.moe.num_experts, hid))
        m["bo"] = PDef((cfg.moe.num_experts, cfg.d_model))
        p["moe"] = m
    else:
        p["mlp"] = _mlp_pdefs(cfg, cfg.d_ff, bias=True)
    return p


def abstract_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    tree: dict = {
        "patch_proj": dense(PATCH_DIM, d),
        "patch_bias": vector(d),
        "cls_token": PDef((1, 1, d), init="small_normal"),
        "pos_embed": PDef((cfg.image_tokens, d), init="small_normal"),
        "final_norm": _norm_pdefs(cfg),
        "head": dense(d, cfg.num_classes, scale=0.02),
        "head_b": vector(cfg.num_classes),
    }
    if cfg.family == "vit_moe":
        n_pairs = cfg.num_layers // 2
        tree["pairs_dense"] = stack_tree(_vit_layer_pdefs(cfg, moe=False), n_pairs)
        tree["pairs_moe"] = stack_tree(_vit_layer_pdefs(cfg, moe=True), n_pairs)
    else:
        tree["layers"] = stack_tree(_vit_layer_pdefs(cfg, moe=False), cfg.num_layers)
    return tree


def init_model_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random f32 weights on ``device`` (a CUDA device without a card
    raises; pass ``device="cpu"`` for the CPU)."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(abstract_params(cfg), gen, dev)


def synth_patches(cfg: ModelConfig, batch: int, seed: int = 0,
                  scale: float = 1.0) -> np.ndarray:
    """Seeded synthetic flattened patches [batch, image_tokens - 1,
    PATCH_DIM] f32 (numpy, so both frameworks can be fed the same input)."""
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(
        (batch, cfg.image_tokens - 1, PATCH_DIM))).astype(np.float32)


def embed(params, cfg: ModelConfig, patches: torch.Tensor) -> torch.Tensor:
    """patches [B, image_tokens-1, PATCH_DIM] -> tokens [B, image_tokens, D]
    (patch projection, [CLS], position embedding)."""
    B = patches.shape[0]
    w_pp = params["patch_proj"]
    patches = patches.to(torch.float32 if w_pp.dtype == torch.int8 else w_pp.dtype)
    x = quant_linear(patches, params, "patch_proj", cfg) + params["patch_bias"]
    cls = params["cls_token"].expand(B, 1, cfg.d_model).to(x.dtype)
    return torch.cat([cls, x], dim=1) + params["pos_embed"]


def layers(params, cfg: ModelConfig):
    """(scope, layer params) in execution order: pair i's dense block, then
    its MoE block (vit_moe), or layer i (vit)."""
    if cfg.family == "vit_moe":
        for i in range(cfg.num_layers // 2):
            for kind in ("pairs_dense", "pairs_moe"):
                yield (f"L{kind.removeprefix('pairs_')}{i:03d}",
                       layer(params[kind], i))
    else:
        for i in range(cfg.num_layers):
            yield f"L{i:03d}", layer(params["layers"], i)


def block(x, lp, cfg, taps=None):
    """One pre-norm block; returns (x, aux_loss, expert_counts)."""
    h = apply_norm(x, lp["ln1"], cfg)
    maybe_record(taps, "post_ln1", h)
    x = x + attention_block(h, lp["attn"], cfg, cfg.attn, causal=False, taps=taps)[0]
    h = apply_norm(x, lp["ln2"], cfg)
    maybe_record(taps, "post_ln2", h)
    aux = torch.zeros((), device=x.device)
    ec = _expert_count_zeros(cfg, x.device)
    if "moe" in lp:
        ff, aux, ec = _moe_apply(h, lp["moe"], cfg, taps=taps)
    else:
        ff = mlp_apply(h, lp["mlp"], cfg, taps=taps)
    return x + ff, aux, ec


def head(params, cfg: ModelConfig, x: torch.Tensor, taps=None) -> torch.Tensor:
    """Final norm and the classifier on the [CLS] token -> logits [B, C]."""
    x = apply_norm(x, params["final_norm"], cfg)
    maybe_record(taps, "final_norm", x)
    return quant_linear(x[:, 0, :], params, "head", cfg) + params["head_b"]


def _forward(params, cfg: ModelConfig, patches: torch.Tensor, taps=None):
    """patches [B, image_tokens-1, PATCH_DIM] -> (logits [B, C], aux,
    expert_counts [E] int32 summed over the MoE layers)."""
    x = embed(params, cfg, patches)
    aux_total = torch.zeros((), device=x.device)
    ec_total = _expert_count_zeros(cfg, x.device)
    for scope, lp in layers(params, cfg):
        x, aux, ec = block(x, lp, cfg,
                           taps=None if taps is None else taps.scoped(scope))
        aux_total = aux_total + aux
        ec_total = ec_total + ec
    return head(params, cfg, x, taps=taps), aux_total, ec_total


def forward(params, cfg: ModelConfig, patches: torch.Tensor, taps=None):
    """patches: [B, image_tokens-1, PATCH_DIM] -> (class logits [B, C], aux)."""
    logits, aux, _ = _forward(params, cfg, patches, taps=taps)
    return logits, aux


def classify(params, cfg: ModelConfig, patches: torch.Tensor, *,
             top_k: int = 5) -> dict:
    """Batched serving entry point: patches [B, image_tokens-1, PATCH_DIM]
    -> {"classes" [B, k] int32, "probs" [B, k] f32 (descending),
    "expert_tokens" [E] int32}. Accepts fp, fake-quant or materialized-int8
    trees through the same ``quant_linear`` seam as ``forward``."""
    logits, _, ec = _forward(params, cfg, patches)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = topk_stable(probs, min(top_k, cfg.num_classes))
    return {"classes": top_i.to(torch.int32), "probs": top_p,
            "expert_tokens": ec}


class ViTClassifier(nn.Module):
    """A vision model as an ``nn.Module``: holds the parameter tree as
    buffers (leaf dtypes kept: int8 weights stay int8) and classifies in
    ``forward``. ``params=None`` draws seeded random weights."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device="cuda", top_k: int = 5) -> None:
        super().__init__()
        dev = require_device(device)
        if params is None:
            params = init_model_params(cfg, seed, dev)
        self.cfg = cfg
        self.top_k = top_k
        self._paths = []
        self._register(params, ())
        self.to(dev)

    def _register(self, tree, path) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                self._register(v, path + (k,))
            else:
                self._paths.append(path + (k,))
                self.register_buffer("/".join(path + (k,)), v)

    def params(self) -> dict:
        """The parameter tree, rebuilt from the buffers."""
        tree: dict = {}
        for path in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self.get_buffer("/".join(path))
        return tree

    def forward(self, patches: torch.Tensor) -> dict:
        return classify(self.params(), self.cfg, patches, top_k=self.top_k)
