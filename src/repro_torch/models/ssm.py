"""Mamba-1 (falcon-mamba) and Mamba-2 (the zamba2 hybrid's backbone)
blocks, ported from ``repro.models.ssm``.

Mamba-1's prefill and training forward run the selective scan through
``kernels.ops.selective_scan`` (the CUDA kernel on the card, its plain
version on the CPU; under grad its backward is the scan's backward kernel,
``kernels/autograd.py:SelectiveScan``); the reference's chunked associative
scan is its XLA lowering for want of a kernel and is not ported. Decode (S = 1) is the
single fused recurrence step in plain tensor ops, as the reference runs it
in plain XLA.

Mamba-2 is plain XLA in the reference (no Pallas kernel), so it is plain
torch here: prefill is the chunked SSD in matrix form (per-head scalar
decay: a chunk's intra-chunk term is an attention-like [B, C, C, H] score
product, its inter-chunk term the carried state), decode the one-step
recurrence.
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
        "in_proj": dense(d, 2 * di, "embed", "ssm_inner"),
        "conv_w": PDef((di, s.conv_width), ("ssm_inner", None),
                       scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": vector(di, "ssm_inner"),
        "x_proj": dense(di, dtr + 2 * n, "ssm_inner", None),
        "dt_proj": dense(dtr, di, None, "ssm_inner"),
        "dt_bias": vector(di, "ssm_inner", "ones"),
        "A_log": PDef((di, n), ("ssm_inner", None), init="ones"),
        "D": vector(di, "ssm_inner", "ones"),
        "out_proj": dense(di, d, "ssm_inner", "embed"),
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


# ---------------------------------------------------------------------------
# Mamba-2 (zamba2 backbone): scalar per-head decay, SSD-style
# ---------------------------------------------------------------------------

def _pad_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[B, S, ...] -> [nch, B, C, ...], zero-padded to a chunk multiple."""
    B, S = x.shape[:2]
    nch = -(-S // chunk)
    pad = nch * chunk - S
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad) + tuple(x.shape[2:]))], dim=1)
    return x.reshape((B, nch, chunk) + tuple(x.shape[2:])).movedim(1, 0)


def mamba2_pdefs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_ssm_heads(d)
    n = s.state_dim
    conv_dim = di + 2 * n  # conv over (x, B, C)
    return {
        "in_proj": dense(d, 2 * di + 2 * n + nh, "embed", "ssm_inner"),
        "conv_w": PDef((conv_dim, s.conv_width), ("ssm_inner", None),
                       scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": vector(conv_dim, "ssm_inner"),
        "A_log": vector(nh, "ssm_inner", "ones"),
        "dt_bias": vector(nh, "ssm_inner", "ones"),
        "D": vector(nh, "ssm_inner", "ones"),
        "norm_scale": vector(di, "ssm_inner", "zeros"),
        "out_proj": dense(di, d, "ssm_inner", "embed"),
    }


def _ssd_chunk(h0, dtc, x, bc, cc, A, tri):
    """One chunk of the SSD prefill, f32. h0 [B, H, P, N] carried state;
    dtc [B, C, H], x [B, C, H, P], bc/cc [B, C, N]. Returns (y [B, C, H,
    P], h). Every exponent is of a non-positive value (decay)."""
    lam = torch.cumsum(dtc * A, dim=1)  # [B, C, H], non-increasing
    cb = torch.einsum("btn,bsn->bts", cc, bc)  # [B, C, C]
    seg = lam[:, :, None, :] - lam[:, None, :, :]  # [B, t, s, H], <= 0 on and below the diagonal
    # above the diagonal seg > 0 and exp overflows: zero it first (the
    # reference's double where, which keeps the backward free of inf * 0)
    seg = torch.where(tri, seg, 0.0)
    M = torch.where(tri, torch.exp(seg) * dtc[:, None, :, :] * cb[..., None], 0.0)
    y_intra = torch.einsum("btsh,bshp->bthp", M, x)
    y_inter = torch.exp(lam)[..., None] * torch.einsum("bcn,bhpn->bchp", cc, h0)
    dec = torch.exp(lam[:, -1:, :] - lam) * dtc  # [B, C, H]
    h = (torch.einsum("bshp,bsh,bsn->bhpn", x, dec, bc)
         + torch.exp(lam[:, -1])[..., None, None] * h0)
    return y_intra + y_inter, h


def mamba2_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """SSD block: x [B, S, D] -> ([B, S, D], new state). ``state`` (decode,
    S = 1): {'h': [B, H, P, N] f32, 'conv': [B, W-1, conv_dim]}; None runs
    the whole sequence from a zero state in chunks of ``ssm.scan_chunk``
    (prefill). The carried state stays f32; each chunk's y is cast to the
    activation dtype, as the reference stacks it. ``in_proj`` is a plain
    matmul (no site reads the ``in_bias`` leaf the PTQ fold may write: it
    is zero under the symmetric RMSNorm fold), as in the reference."""
    s = cfg.ssm
    B, S, D = x.shape
    di = s.d_inner(D)
    nh = s.num_ssm_heads(D)
    P = s.head_dim
    n = s.state_dim
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc, new_conv = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                  state=None if state is None else state["conv"])
    xbc = F.silu(xbc)
    xs, bc, cc = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt + p["dt_bias"])  # [B, S, H]
    A = -torch.exp(p["A_log"].float())  # [H]
    xh = xs.reshape(B, S, nh, P)
    if state is None:
        chunk = min(s.scan_chunk, S)
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=x.device))[None, :, :, None]
        chunks = [_pad_chunks(t, chunk) for t in (dt, xh, bc, cc)]
        new_h = torch.zeros((B, nh, P, n), dtype=torch.float32, device=x.device)
        ys = []
        for dtc, xc, bcc, ccc in zip(*chunks):
            y, new_h = _ssd_chunk(new_h, dtc.float(), xc.float(), bcc.float(), ccc.float(),
                                  A, tri)
            ys.append(y.to(xh.dtype))
        y = torch.stack(ys, dim=1).reshape(B, -1, nh, P)[:, :S]
    else:
        a1 = torch.exp(dt[:, 0].float() * A)[..., None, None]  # [B, H, 1, 1]
        b1 = ((dt[:, 0, :, None] * xh[:, 0].float())[..., None]
              * bc[:, 0, None, None, :].float())  # [B, H, P, N]
        new_h = a1 * state["h"] + b1
        y = torch.einsum("bhpn,bn->bhp", new_h, cc[:, 0].float())[:, None]
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)), eps 1e-6, scale (1 + g)
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * (1.0 + p["norm_scale"])
    out = y.to(x.dtype) @ p["out_proj"]
    return out, {"h": new_h, "conv": new_conv}
