"""PTQ driver for the vision families (CoQMoE section 3): calibrate ->
reparameterize -> quantize, ported from ``repro.core.quant.ptq``.

  1. ``calibrate_model`` runs the fp model over a few batches while a
     ``TapCollector`` records per-channel min/max at every post-norm site
     and per-tensor absmax at the other linear inputs.
  2. ``ptq_model`` folds the post-norm reparameterization (Eqs. 10-16)
     into each norm and inversely into its consumers (QKV, MLP fc1, every
     expert's fc1 and the gate), inserts the ``a_scale`` / ``wo_a_scale``
     activation scales, and quantizes the weights per output channel:
       * ``materialize="fake"``: quantize-dequantize in f32, the oracle;
       * ``materialize="int8"``: the QuantizedParams tree, int8 weight
         leaves with ``<key>_scale`` and, where an activation scale is
         known, ``<key>_as`` leaves, executed by the int8 kernels.
     ``fold_only=True`` performs only the fold (numerically the fp model).

The port covers the ``vit`` and ``vit_moe`` families; ``materialize="int4"``
and ``QuantConfig.scheme_map`` are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.linear_quant import fake_quant_weight, quantize_weight
from repro_torch.core.quant.qtypes import ASCALE_SUFFIX, SCALE_SUFFIX, qmax

# Leaf keys treated as quantizable linear weights (per-out-channel int8).
QUANT_WEIGHT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "wi", "gate", "head", "patch_proj"}
)

# Per-layer-group norm sites: (norm_path, tap_suffix, [(consumer_w_path,
# bias_key)]).
_ATTN_SITE = (("ln1",), "post_ln1", [(("attn", "wq"), "bq"),
                                     (("attn", "wk"), "bk"),
                                     (("attn", "wv"), "bv")])
_MLP_SITE = (("ln2",), "post_ln2", [(("mlp", "wi"), "bi")])
_MOE_SITE = (("ln2",), "post_ln2", [(("moe", "gate"), "gate_b"),
                                    (("moe", "wi"), "bi")])
_MID_SITES = [  # (subtree, tap_suffix) -> wo_a_scale insertion points
    (("attn",), "attn_out"),
    (("mlp",), "mlp_mid"),
    (("moe",), "moe_mid"),
]


def calibrate_model(cfg: ModelConfig, params, batches: Sequence) -> TapCollector:
    """Run the fp model over calibration batches (patch tensors),
    recording taps."""
    from repro_torch.models import vit

    taps = TapCollector()
    with torch.no_grad():
        for patches in batches:
            vit.forward(params, cfg, patches, taps=taps)
    return taps


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


def _get(tree, path: Tuple[str, ...]):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _set(tree, path: Tuple[str, ...], val):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = val


def _stacked_factors(taps: TapCollector, names: List[str], bits: int,
                     device):
    """Per-layer asymmetric reparam factors from recorded min/max: [L, D]
    (the LayerNorm variant; RMSNorm models are not in the port)."""
    xmin = torch.from_numpy(np.stack([taps.stats[n]["min"] for n in names]))
    xmax = torch.from_numpy(np.stack([taps.stats[n]["max"] for n in names]))
    xmin, xmax = xmin.to(device), xmax.to(device)
    span = torch.clamp(xmax - xmin, min=1e-8)
    s = span / (2**bits - 1)
    z = torch.round(-xmin / s)
    s_tilde = torch.mean(s, dim=-1)  # [L]
    r1 = s / s_tilde[:, None]
    r2 = z - 2.0 ** (bits - 1)
    return r1, r2, s, s_tilde


def _fold_norm(norm_p: dict, r1, r2, s):
    """Eq. 11 on (possibly stacked) LayerNorm params. r1/r2/s: [..., D]."""
    norm_p["bias"] = (norm_p["bias"] + s * r2) / r1
    norm_p["scale"] = norm_p["scale"] / r1


def _fold_consumer(layer_p: dict, w_path: Tuple[str, ...], b_key: str,
                   r1, sr2):
    """Eq. 14/15/16: W' = diag(r1) W, b' = b - W^T (s . r2). W: [..., D, O]
    with the reparam'd dim at axis -2; r1/sr2: [..., D]."""
    w = _get(layer_p, w_path)
    if w is None:
        return
    extra = w.dim() - r1.dim() - 1  # expert axes between layer dim and D
    shp = tuple(r1.shape[:-1]) + (1,) * extra + (r1.shape[-1], 1)
    _set(layer_p, w_path, w * r1.reshape(shp))
    corr = torch.sum(w * sr2.reshape(shp), dim=-2)  # [..., O]
    b_path = w_path[:-1] + (b_key,)
    b = _get(layer_p, b_path)
    _set(layer_p, b_path, -corr if b is None else b - corr)


def _insert_ascale(layer_p: dict, w_path: Tuple[str, ...], val):
    """Fold a per-site activation scale next to the weight it feeds."""
    node = _get(layer_p, w_path[:-1])
    if node is not None and w_path[-1] in node:
        node[w_path[-1] + ASCALE_SUFFIX] = val


def _quantize_weights(tree, bits: int):
    """Fake (quantize-dequantize) materialization."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _quantize_weights(v, bits)
        elif k in QUANT_WEIGHT_KEYS and v.dim() >= 2:
            out[k] = fake_quant_weight(v, bits)
        else:
            out[k] = v
    return out


def _materialize_int8(tree, bits: int):
    """Replace quantizable weight leaves with stored int8 + dequant scale."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _materialize_int8(v, bits)
        elif k in QUANT_WEIGHT_KEYS and v.dim() >= 2:
            out[k], w_scale = quantize_weight(v, bits)
            out[k + SCALE_SUFFIX] = w_scale.to(torch.float32)
        else:
            out[k] = v
    return out


def ptq_model(cfg: ModelConfig, params, taps: TapCollector, *,
              fold_only: bool = False, materialize: str = "fake"):
    """Return the PTQ-transformed param tree (the original is untouched)."""
    if cfg.family not in ("vit", "vit_moe") or cfg.norm != "layernorm":
        raise NotImplementedError(
            f"PTQ of family {cfg.family!r} with {cfg.norm} is not ported "
            "(vit and vit_moe with layernorm only)")
    if materialize not in ("fake", "int8"):
        raise NotImplementedError(
            f"materialize={materialize!r} is not ported (fake, int8 only)")
    if cfg.quant.scheme_map:
        raise NotImplementedError("QuantConfig.scheme_map is not ported")
    a_bits = cfg.quant.a_bits
    ascale = materialize == "int8" and not fold_only
    p = _copy(params)
    device = p["head"].device

    for key, prefix in (("layers", "L"), ("pairs_dense", "Ldense"),
                        ("pairs_moe", "Lmoe")):
        if key not in p:
            continue
        sub = p[key]
        n = sub["ln1"]["scale"].shape[0]
        for norm_path, suffix, consumers in (
                _ATTN_SITE, _MOE_SITE if "moe" in sub else _MLP_SITE):
            names = [f"{prefix}{i:03d}.{suffix}" for i in range(n)]
            if any(nm not in taps.stats for nm in names):
                continue
            r1, r2, s, s_tilde = _stacked_factors(taps, names, a_bits, device)
            _fold_norm(_get(sub, norm_path), r1, r2, s)
            for w_path, b_key in consumers:
                _fold_consumer(sub, w_path, b_key, r1, s * r2)
                if ascale:
                    _insert_ascale(sub, w_path, s_tilde)
            if not fold_only:
                _get(sub, norm_path)["a_scale"] = s_tilde
        if not fold_only:
            for mid_path, suffix in _MID_SITES:
                names = [f"{prefix}{i:03d}.{suffix}" for i in range(n)]
                node = _get(sub, mid_path)
                if node is None or any(nm not in taps.stats for nm in names):
                    continue
                # quant_linear reads wo_a_scale as the wo activation scale,
                # the same leaf the fake oracle uses
                node["wo_a_scale"] = torch.tensor(
                    [taps.absmax(nm) / qmax(a_bits) for nm in names],
                    dtype=torch.float32, device=device)

    # Final norm -> head consumer (single, unstacked site).
    if "final_norm" in taps.stats:
        r1, r2, s, s_tilde = _stacked_factors(taps, ["final_norm"], a_bits,
                                              device)
        _fold_norm(p["final_norm"], r1[0], r2[0], s[0])
        w = p["head"]
        corr = torch.sum(w * (s[0] * r2[0])[:, None], dim=0)
        p["head"] = w * r1[0][:, None]
        p["head_b"] = p["head_b"] - corr
        if not fold_only:
            p["final_norm"]["a_scale"] = s_tilde[0]
        if ascale:
            p["head" + ASCALE_SUFFIX] = s_tilde[0]

    if not fold_only:
        if materialize == "int8":
            p = _materialize_int8(p, cfg.quant.w_bits)
        else:
            p = _quantize_weights(p, cfg.quant.w_bits)
    return p


def quantized_config(cfg: ModelConfig) -> ModelConfig:
    """The runtime config to pair with ``ptq_model`` output (W8A8 + Attn4)."""
    return cfg.replace(quant=dataclasses.replace(cfg.quant, enable=True))
