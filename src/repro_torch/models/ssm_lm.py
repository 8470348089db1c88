"""falcon-mamba LM, ported from ``repro.models.ssm_lm``: embed -> Mamba-1
blocks (pre-RMSNorm, residual) -> final norm -> tied head. The decode state
is O(1) per layer: ``h`` [L, B, di, N] f32 and the conv history
``conv`` [L, B, W-1, di]. Layers are walked by a Python loop, where the
reference scans. With ``cfg.remat`` a layer that autograd records from a
zero state runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body): a training step keeps each layer's
input only and recomputes the layer, the scan kernel included, in the
backward pass.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.models.layers import apply_norm
from repro_torch.models.param import PDef, require_device, stack_tree
from repro_torch.models.ssm import mamba1_block, mamba1_pdefs
from repro_torch.models.transformer import (
    _norm_pdefs,
    layer,
    logits_from_hidden,
    remat_active,
)


def abstract_params(cfg: ModelConfig) -> dict:
    tree = {
        "embed": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="small_normal"),
        "layers": stack_tree({"ln": _norm_pdefs(cfg), "mamba": mamba1_pdefs(cfg)},
                             cfg.num_layers),
        "final_norm": _norm_pdefs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = PDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                               init="small_normal")
    return tree


def _layer(x: torch.Tensor, lp: dict, cfg: ModelConfig, state=None, taps=None):
    """One pre-norm layer with its residual: (x, the layer's new state)."""
    h = apply_norm(x, lp["ln"], cfg)
    if taps is not None:
        maybe_record(taps, "post_ln1", h)
    y, st = mamba1_block(h, lp["mamba"], cfg, state=state)
    return x + y, st


def _run(params, cfg: ModelConfig, x: torch.Tensor, states=None, taps=None, out=None):
    """Every layer in order. Returns (x, the new states stacked like
    ``init_cache``, written into ``out`` where given; None when recording
    calibration taps or when every layer ran under remat)."""
    new = out
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        if states is None and taps is None and remat_active(cfg, x, lp):
            x = checkpoint(_layer, x, lp, cfg, use_reentrant=False)[0]  # state dropped
            continue
        x, st = _layer(x, lp, cfg, state=None if states is None else layer(states, i),
                       taps=None if taps is None else taps.scoped(f"L{i:03d}"))
        if taps is None:
            if new is None:  # written layer by layer: no list of 64 states
                new = {k: v.new_empty((cfg.num_layers,) + tuple(v.shape))
                       for k, v in st.items()}
            for k, v in st.items():
                new[k][i] = v
    return x, new


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, taps=None):
    """Teacher-forced forward: tokens [B, S] -> (logits [B, S, V], 0)."""
    x = params["embed"][tokens.long()]
    x, _ = _run(params, cfg, x, taps=taps)
    return (logits_from_hidden(params, cfg, x, taps=taps),
            torch.zeros((), device=x.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The SSM 'cache' is the recurrent state; ``max_len`` is irrelevant."""
    s = cfg.ssm
    device = require_device(device)
    di = s.d_inner(cfg.d_model)
    L = cfg.num_layers
    return {
        "h": torch.zeros((L, batch, di, s.state_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((L, batch, s.conv_width - 1, di), dtype=dtype,
                            device=device),
    }


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None):
    """Run the prompts [B, S] from a zero state. Returns (last-position
    logits [B, 1, V], the final states in the ``init_cache`` layout)."""
    x = params["embed"][tokens.long()]
    x, states = _run(params, cfg, x)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), states


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, states,
                index=None, out=None):
    """One step: tokens [B, 1] from ``states`` (left untouched unless it
    is ``out``). Returns (logits [B, 1, V], new states): written into
    ``out`` (a dict like ``states``; it may be ``states`` itself, each
    layer's state is read before it is written) where given, else new
    tensors."""
    x = params["embed"][tokens.long()]
    x, new_states = _run(params, cfg, x, states=states, out=out)
    return logits_from_hidden(params, cfg, x), new_states
