"""PTQ driver (CoQMoE section 3): calibrate -> reparameterize -> quantize,
ported from ``repro.core.quant.ptq`` for the vision (vit, vit_moe) and LM
(dense, moe) families.

  1. ``calibrate_model`` runs the fp model over a few batches while a
     ``TapCollector`` records per-channel min/max at every post-norm site
     and per-tensor absmax at the other linear inputs.
  2. ``ptq_model`` folds the post-norm reparameterization (Eqs. 10-16)
     into each norm and inversely into its consumers (QKV, MLP fc1, every
     expert's fc1 and the gate; RMSNorm models use the symmetric r2 == 0
     variant, ``(1+g)' = (1+g)/r1 - 1``), inserts the ``a_scale`` /
     ``wo_a_scale`` activation scales, and quantizes the weights per output
     channel:
       * ``materialize="fake"``: quantize-dequantize in f32, the oracle
         (scheme-map sites on the 4-bit grid);
       * ``materialize="int8"``: the QuantizedParams tree, int8 weight
         leaves with ``<key>_scale`` and, where an activation scale is
         known, ``<key>_as`` leaves, executed by the int8 kernels;
       * ``materialize="int4"``: the same with the scheme-map sites (by
         default the MoE expert stacks, ``DEFAULT_INT4_SCHEME``) stored as
         nibble-packed ``uint8``, executed by the grouped W4A8 kernel.
     ``fold_only=True`` performs only the fold (numerically the fp model).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.calibrate import TapCollector
from repro_torch.core.quant.linear_quant import fake_quant_weight, quantize_weight
from repro_torch.core.quant.qtypes import ASCALE_SUFFIX, SCALE_SUFFIX, pack_int4, qmax

# Families whose every linear call site routes through ``quant_linear``.
FAMILIES = frozenset({"dense", "moe", "vit", "vit_moe"})

# Leaf keys treated as quantizable linear weights (per-out-channel int8).
QUANT_WEIGHT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "wi", "gate", "lm_head", "head", "patch_proj"}
)

MATERIALIZE_MODES = ("fake", "int8", "int4")
SITE_SCHEMES = ("int8", "int4")
# ``materialize="int4"`` without a scheme map: only the MoE expert stacks
# drop to int4; router, head and attention stay int8.
DEFAULT_INT4_SCHEME = (("moe.wi", "int4"), ("moe.wo", "int4"))
# the grouped expert path is the only consumer of nibble-packed leaves
_INT4_SITE_KEYS = frozenset({"wi", "wo"})

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


def _scheme_dict(scheme_map) -> Dict[Tuple[str, ...], str]:
    """Validate a scheme map and key it by dotted-path pattern components."""
    out = {}
    for pat, sch in dict(scheme_map).items():
        if sch not in SITE_SCHEMES:
            raise ValueError(
                f"unknown scheme {sch!r} for site pattern {pat!r}; "
                f"supported schemes: {', '.join(SITE_SCHEMES)}")
        parts = tuple(pat.split("."))
        if sch == "int4" and parts[-1] not in _INT4_SITE_KEYS:
            raise ValueError(
                f"int4 scheme requested for site pattern {pat!r}, but only MoE "
                "expert stacks (moe.wi / moe.wo) execute nibble-packed int4; "
                "sensitive sites (router, head, attention) must stay int8")
        out[parts] = sch
    return out


def _scheme_for(path: Tuple[str, ...], scheme: Dict[Tuple[str, ...], str]) -> str:
    """Longest dotted-suffix match of ``path``; unmatched sites are int8."""
    best, best_len = "int8", 0
    for parts, sch in scheme.items():
        if len(parts) <= len(path) and path[-len(parts):] == parts \
                and len(parts) > best_len:
            best, best_len = sch, len(parts)
    return best


def _site_bits(path: Tuple[str, ...], scheme, default_bits: int) -> int:
    if scheme and _scheme_for(path, scheme) == "int4":
        return 4
    return default_bits


def _check_int4_site(path: Tuple[str, ...]) -> None:
    if path[-1] not in _INT4_SITE_KEYS or "moe" not in path[:-1]:
        raise NotImplementedError(
            f"int4 scheme matched non-expert site {'.'.join(path)!r}; only MoE "
            "expert stacks (moe.wi / moe.wo) execute nibble-packed int4")


def calibrate_model(cfg: ModelConfig, params, batches: Sequence) -> TapCollector:
    """Run the fp model over calibration batches (patch tensors for the
    vision families, token tensors for the LM), recording taps. An MoE LM
    config should be the serving one (grouped experts), as in serving."""
    from repro_torch import models

    taps = TapCollector()
    with torch.no_grad():
        for x in batches:
            models.forward(params, cfg, x, taps=taps)
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
                     symmetric: bool, device):
    """Per-layer reparam factors from recorded min/max: [L, D]. symmetric
    (RMSNorm: no zero-point home) gives r2 == 0."""
    xmin = torch.from_numpy(np.stack([taps.stats[n]["min"] for n in names])).to(device)
    xmax = torch.from_numpy(np.stack([taps.stats[n]["max"] for n in names])).to(device)
    if symmetric:
        absmax = torch.clamp(torch.maximum(torch.abs(xmin), torch.abs(xmax)), min=1e-8)
        s = absmax / qmax(bits)
        z = None
    else:
        span = torch.clamp(xmax - xmin, min=1e-8)
        s = span / (2**bits - 1)
        z = torch.round(-xmin / s)
    s_tilde = torch.mean(s, dim=-1)  # [L]
    r1 = s / s_tilde[:, None]
    r2 = torch.zeros_like(s) if z is None else z - 2.0 ** (bits - 1)
    return r1, r2, s, s_tilde


def _fold_norm(norm_p: dict, r1, r2, s, rms: bool):
    """Eq. 11 on (possibly stacked) norm params. r1/r2/s: [..., D]."""
    if rms:
        # (1 + gamma)' = (1 + gamma) / r1  (the (1+g) RMSNorm convention)
        norm_p["scale"] = (1.0 + norm_p["scale"]) / r1 - 1.0
    else:
        norm_p["bias"] = (norm_p["bias"] + s * r2) / r1
        norm_p["scale"] = norm_p["scale"] / r1


def _fold_consumer(layer_p: dict, w_path: Tuple[str, ...], b_key: str,
                   r1, sr2, add_bias: bool):
    """Eq. 14/15/16: W' = diag(r1) W, b' = b - W^T (s . r2). W: [..., D, O]
    with the reparam'd dim at axis -2; r1/sr2: [..., D]."""
    w = _get(layer_p, w_path)
    if w is None:
        return
    extra = w.dim() - r1.dim() - 1  # expert axes between layer dim and D
    shp = tuple(r1.shape[:-1]) + (1,) * extra + (r1.shape[-1], 1)
    _set(layer_p, w_path, w * r1.reshape(shp))
    b_path = w_path[:-1] + (b_key,)
    b = _get(layer_p, b_path)
    if b is None and not add_bias:
        return  # no bias to correct (RMSNorm: s . r2 == 0 anyway)
    corr = torch.sum(w * sr2.reshape(shp), dim=-2)  # [..., O]
    _set(layer_p, b_path, -corr if b is None else b - corr)


def _insert_ascale(layer_p: dict, w_path: Tuple[str, ...], val):
    """Fold a per-site activation scale next to the weight it feeds."""
    node = _get(layer_p, w_path[:-1])
    if node is not None and w_path[-1] in node:
        node[w_path[-1] + ASCALE_SUFFIX] = val


def _quantize_weights(tree, bits: int, scheme=None, path: Tuple[str, ...] = ()):
    """Fake (quantize-dequantize) materialization; scheme-matched sites use
    the 4-bit grid (the oracle of a mixed int4 tree)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _quantize_weights(v, bits, scheme, path + (k,))
        elif k in QUANT_WEIGHT_KEYS and v.dim() >= 2:
            out[k] = fake_quant_weight(v, _site_bits(path + (k,), scheme, bits))
        else:
            out[k] = v
    return out


def _quantize_stored(v: torch.Tensor, bits: int):
    """``quantize_weight`` (packed for 4 bits), one leading slice at a time
    for stacked leaves: the f32 temporaries of a whole expert stack would
    not fit beside the model on the card."""
    def one(w):
        w_q, scale = quantize_weight(w, bits)
        return (pack_int4(w_q) if bits == 4 else w_q), scale

    if v.dim() < 3:
        return one(v)
    first_q, first_s = one(v[0])
    out_q = torch.empty((v.shape[0],) + tuple(first_q.shape), dtype=first_q.dtype,
                        device=v.device)
    out_s = torch.empty((v.shape[0],) + tuple(first_s.shape), dtype=first_s.dtype,
                        device=v.device)
    out_q[0], out_s[0] = first_q, first_s
    for i in range(1, v.shape[0]):
        out_q[i], out_s[i] = one(v[i])
    return out_q, out_s


def _materialize_stored(tree, bits: int, scheme=None, path: Tuple[str, ...] = (),
                        n_int4=None):
    """Replace quantizable weight leaves with stored integers + dequant
    scale: int8 leaves, or nibble-packed uint8 at scheme-matched int4
    sites, on the same per-output-channel grids as ``fake_quant_weight``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _materialize_stored(v, bits, scheme, path + (k,), n_int4)
        elif k in QUANT_WEIGHT_KEYS and v.dim() >= 2:
            leaf_path = path + (k,)
            site_bits = _site_bits(leaf_path, scheme, bits)
            if site_bits == 4:
                _check_int4_site(leaf_path)
                if n_int4 is not None:
                    n_int4[0] += 1
            out[k], w_scale = _quantize_stored(v, site_bits)
            out[k + SCALE_SUFFIX] = w_scale.to(torch.float32)
        else:
            out[k] = v
    return out


def _layer_groups(p) -> List[Tuple[str, str]]:
    return [(key, prefix) for key, prefix in (
        ("layers", "L"), ("pairs_dense", "Ldense"), ("pairs_moe", "Lmoe"))
        if key in p]


def _validated_scheme(cfg: ModelConfig, materialize: str):
    """The scheme map ``materialize`` runs with (None: every site int8)."""
    if materialize == "int4":
        scheme = _scheme_dict(cfg.quant.scheme_map or DEFAULT_INT4_SCHEME)
        if not any(s == "int4" for s in scheme.values()):
            raise ValueError(
                "materialize='int4' with a scheme map that names no int4 site; "
                "drop the map to get the experts-only default "
                "(DEFAULT_INT4_SCHEME) or add moe.wi/moe.wo entries")
        return scheme
    if not cfg.quant.scheme_map:
        return None
    scheme = _scheme_dict(cfg.quant.scheme_map)
    if materialize == "int8":
        if any(s == "int4" for s in scheme.values()):
            raise ValueError("scheme map names int4 sites but materialize='int8'; "
                             "use materialize='int4' for mixed-scheme trees")
        return None  # an all-int8 map is the int8 path exactly
    return scheme


def ptq_model(cfg: ModelConfig, params, taps: TapCollector, *,
              fold_only: bool = False, materialize: str = "fake"):
    """Return the PTQ-transformed param tree (the original is untouched)."""
    if materialize not in MATERIALIZE_MODES:
        raise ValueError(f"unknown materialize mode {materialize!r}; supported "
                         f"modes: {', '.join(MATERIALIZE_MODES)}")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"PTQ of family {cfg.family!r} is not ported (supported: {sorted(FAMILIES)})")
    scheme = _validated_scheme(cfg, materialize)
    rms = cfg.norm == "rmsnorm"
    a_bits = cfg.quant.a_bits
    ascale = materialize in ("int8", "int4") and not fold_only
    p = _copy(params)
    head_key = "head" if cfg.family in ("vit", "vit_moe") else "lm_head"
    device = p["final_norm"]["scale"].device

    for key, prefix in _layer_groups(p):
        sub = p[key]
        n = sub["ln1"]["scale"].shape[0]
        for norm_path, suffix, consumers in (
                _ATTN_SITE, _MOE_SITE if "moe" in sub else _MLP_SITE):
            names = [f"{prefix}{i:03d}.{suffix}" for i in range(n)]
            if any(nm not in taps.stats for nm in names):
                continue
            r1, r2, s, s_tilde = _stacked_factors(taps, names, a_bits, rms, device)
            _fold_norm(_get(sub, norm_path), r1, r2, s, rms)
            for w_path, b_key in consumers:
                _fold_consumer(sub, w_path, b_key, r1, s * r2, add_bias=not rms)
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
    if "final_norm" in taps.stats and head_key in p:
        r1, r2, s, s_tilde = _stacked_factors(taps, ["final_norm"], a_bits, rms,
                                              device)
        _fold_norm(p["final_norm"], r1[0], r2[0], s[0], rms)
        w = p[head_key]
        corr = torch.sum(w * (s[0] * r2[0])[:, None], dim=0)
        p[head_key] = w * r1[0][:, None]
        if head_key == "head":
            p["head_b"] = p["head_b"] - corr
        elif not rms:
            p["lm_head_b"] = -corr  # added to the logits by logits_from_hidden
        if not fold_only:
            p["final_norm"]["a_scale"] = s_tilde[0]
        if ascale:
            p[head_key + ASCALE_SUFFIX] = s_tilde[0]

    if not fold_only:
        w_bits = cfg.quant.w_bits
        if materialize in ("int8", "int4"):
            n_int4 = [0]
            p = _materialize_stored(p, w_bits, scheme, n_int4=n_int4)
            if materialize == "int4" and n_int4[0] == 0:
                raise ValueError(
                    "materialize='int4' produced no int4 leaves: the scheme map "
                    "matched no MoE expert stack in this model")
        else:
            p = _quantize_weights(p, w_bits, scheme)
    return p


def quantized_config(cfg: ModelConfig) -> ModelConfig:
    """The runtime config to pair with ``ptq_model`` output (W8A8 + Attn4,
    int8 K/V cache for the LM)."""
    return cfg.replace(quant=dataclasses.replace(cfg.quant, enable=True))
