"""Mamba-1 (falcon-mamba) block, ported from ``repro.models.ssm``.

Prefill runs the selective scan through ``kernels.ops.selective_scan`` (the
CUDA kernel on the card, its plain version on the CPU); the reference's
chunked associative scan is its XLA lowering for want of a kernel and is
not ported. Decode (S = 1) is the single fused recurrence step in plain
tensor ops, as the reference runs it in plain XLA. Mamba-2 (the hybrid
family) is not ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.param import PDef, dense, vector


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B, S, C]; w: [C, W]; state: [B, W-1, C]
    history. Returns (y [B, S, C], new_state [B, W-1, C]).

    W shifted multiply-adds, as the reference writes it (``F.conv1d`` would
    sum in another order, and on the card in TF32 by default)."""
    B, S, C = x.shape
    W = w.shape[1]
    hist = state if state is not None else x.new_zeros((B, W - 1, C))
    xp = torch.cat([hist, x], dim=1)  # [B, S+W-1, C], promoted as jnp does
    y = torch.zeros((B, S, C), dtype=x.dtype, device=x.device)
    for i in range(W):  # width is 4: unrolled shift-multiply-accumulate
        y = y + xp[:, i:i + S, :] * w[:, i]
    if b is not None:
        y = y + b
    # a copy, not a view: a view would keep the whole of xp alive
    return y, xp[:, S:S + W - 1, :].clone()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) term for term; torch's
    ``F.softplus`` switches to the identity above a threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba1_pdefs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    dtr = s.dt_rank or -(-d // 16)
    n = s.state_dim
    return {
        "in_proj": dense(d, 2 * di),
        "conv_w": PDef((di, s.conv_width), scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": vector(di),
        "x_proj": dense(di, dtr + 2 * n),
        "dt_proj": dense(dtr, di),
        "dt_bias": vector(di, "ones"),
        "A_log": PDef((di, n), init="ones"),
        "D": vector(di, "ones"),
        "out_proj": dense(di, d),
    }


def mamba1_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x: [B, S, D] -> ([B, S, D], new state). ``state`` (decode, S = 1):
    {'h': [B, di, N] f32, 'conv': [B, W-1, di]}; None runs the whole
    sequence from a zero state (prefill)."""
    s = cfg.ssm
    D = x.shape[-1]
    di = s.d_inner(D)
    dtr = s.dt_rank or -(-D // 16)
    n = s.state_dim
    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]  # [B, S, di]
    xs, new_conv = causal_conv1d(xs, p["conv_w"], p["conv_b"],
                                 state=None if state is None else state["conv"])
    xs = F.silu(xs)
    proj = xs @ p["x_proj"]  # [B, S, dtr + 2n]
    dt, bc, cc = torch.split(proj, [dtr, n, n], dim=-1)
    dt = softplus(dt @ p["dt_proj"] + p["dt_bias"])  # [B, S, di]
    A = -torch.exp(p["A_log"].float())  # [di, N]
    if state is None:
        # y already holds the D x skip term
        y, new_h = ops.selective_scan(xs, dt, bc, cc, A, p["D"])
        y = y.float()
    else:
        # S == 1: one fused step of the recurrence
        a1 = torch.exp(dt[:, 0, :, None].float() * A)
        b1 = (dt * xs)[:, 0, :, None].float() * bc[:, 0, None, :].float()
        new_h = a1 * state["h"] + b1  # [B, di, N]
        y = torch.einsum("bdn,bn->bd", new_h, cc[:, 0].float())[:, None]
        y = y + xs.float() * p["D"]
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    return out, {"h": new_h, "conv": new_conv}
