"""Plain PyTorch versions of the hand-written kernels (the ``ref.py``
contract), ported from ``repro.kernels.ref``.

They are the CPU path of ``kernels/ops.py`` and the ground truth the CUDA
kernels are held against on the card. Integer products are taken in
float64, whose 53-bit mantissa holds every int8 x int8 sum of these widths
exactly (127^2 * K < 2^53): the result is the int32 accumulator of the
reference, on any device, whatever order the sum runs in (CUDA has no
integer matmul).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant.qtypes import unpack_int4
from repro_torch.core.quant.softmax_quant import logsqrt2_dequantize

LOG2E = 1.4426950408889634  # log2(e)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset=0, quant_bits: int = 0,
                        logit_softcap: float = 0.0, local_window: int = 0,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        kv_valid_len: Optional[torch.Tensor] = None,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over q [B, Sq, H, hd] and GQA k/v [B, Sk, KVH, hd] (f32,
    bf16 or int8 with per-(position, head) ``k_scale``/``v_scale`` [B, Sk,
    KVH]): causal and local-window masks on absolute positions (``q_offset``
    scalar or [B], the position of q[0]), ``kv_valid_len`` [B] fill levels,
    packed-prefill segment ids (a position attends only within its own id),
    tanh ``logit_softcap``, and the log-sqrt2 quantized softmax numerator
    when ``quant_bits`` > 0 (paper sections 3.2/4.3): codes against the
    exact row max, the denominator the exact sum of exp(s - m), masked keys
    exactly zero. A row with no visible key gives 0.

    The reference's order of operations is kept: scores are
    ``(q.k) * k_scale / sqrt(hd)``, the V scale is folded into the
    probabilities, and with a bf16 V the probabilities are rounded to bf16
    before P.V (f32 accumulation)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    qg = q.reshape(B, Sq, KVH, G, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if k_scale is not None:
        scores = scores * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    # a true division by sqrt(hd) held as an f32 tensor: a Python scalar
    # divisor may be applied on the card as a multiplication by its
    # reciprocal, which rounds differently from the kernel's division
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32, device=dev)
    if logit_softcap > 0:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    off = torch.as_tensor(q_offset, dtype=torch.int32, device=dev).broadcast_to((B,))
    qpos = off[:, None] + torch.arange(Sq, device=dev, dtype=torch.int32)  # [B, Sq]
    kpos = torch.arange(Sk, device=dev, dtype=torch.int32)
    ok = torch.ones((B, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        ok &= kpos[None, None, :] <= qpos[:, :, None]
    if local_window > 0:
        ok &= qpos[:, :, None] - kpos[None, None, :] < local_window
    if q_segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else q_segment_ids
        ok &= q_segment_ids[:, :, None] == kv_seg[:, None, :]
    mask = ok[:, None, None]  # [B, 1, 1, Sq, Sk]
    if kv_valid_len is not None:
        valid = kpos[None, :] < kv_valid_len.to(torch.int32)[:, None]  # [B, Sk]
        mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, -math.inf)
    m = torch.clamp(torch.amax(scores, dim=-1, keepdim=True), min=-1e30)
    f = torch.exp(scores - m)
    l = torch.sum(f, dim=-1, keepdim=True)
    if quant_bits > 0:
        # Eq. 18 in affine-code form: -2 log2(exp(s - m)) == -2 log2(e) (s - m)
        codes = torch.clamp(
            torch.round(-2.0 * LOG2E * (scores - m)), 0, 2**quant_bits - 1)
        f = torch.where(mask, logsqrt2_dequantize(codes.to(torch.int32)), 0.0)
    if v_scale is not None:
        f = f * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    if v.dtype not in (torch.int8, torch.float32):
        f = f.to(v.dtype)  # the reference rounds P to V's type before P.V
    out = torch.einsum("bkgqs,bskh->bqkgh", f.float(), v.float()) / torch.clamp(
        l.permute(0, 3, 1, 2, 4), min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _group_bounds(group_sizes: torch.Tensor):
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    return zip([0] + ends[:-1], ends)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Row t multiplies the weight of its group: y[t] = x[t] @ w[g(t)]
    (x: [T, Din] sorted by group; w: [G, Din, Dout])."""
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for g, (s, e) in enumerate(_group_bounds(group_sizes)):
        if e > s:
            y[s:e] = x[s:e].float() @ w[g].float()
    return y.to(x.dtype)


def grouped_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``grouped_matmul_ref``: dw[g] = x[rows of
    g]^T @ dy[rows of g] (x [T, Din], dy [T, Dout] sorted by group) ->
    [G, Din, Dout], zeros for an empty group, in f32 (f64 for f64
    operands)."""
    dt = torch.promote_types(torch.promote_types(x.dtype, dy.dtype), torch.float32)
    dw = torch.zeros((group_sizes.shape[0], x.shape[1], dy.shape[1]), dtype=dt,
                     device=x.device)
    for g, (s, e) in enumerate(_group_bounds(group_sizes)):
        if e > s:
            dw[g] = x[s:e].to(dt).T @ dy[s:e].to(dt)
    return dw


def grouped_mlp_ref(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                    group_sizes: torch.Tensor, act: str = "silu",
                    glu: bool = True) -> torch.Tensor:
    """Expert MLP over sorted rows: fc1 -> act (GLU: the first half gates
    the second) -> fc2, both through ``grouped_matmul_ref`` (x [T, D], wi
    [G, D, Dh] with Dh = 2 ff for GLU, wo [G, ff, D])."""
    from repro_torch.models.layers import act_fn  # lazy: layers imports ops

    h = grouped_matmul_ref(x, wi, group_sizes)
    if glu:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act_fn(act)(g) * u
    else:
        h = act_fn(act)(h)
    return grouped_matmul_ref(h, wo, group_sizes)


def grouped_matmul_q_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                         group_sizes: torch.Tensor, w_scale: torch.Tensor,
                         a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 grouped product: exact integer accumulate, then the Eq. 9
    product-of-scales rescale (per-expert per-channel, then per-tensor)."""
    acc = torch.zeros((x_q.shape[0], w_q.shape[2]), dtype=torch.float64,
                      device=x_q.device)
    seg = torch.zeros(x_q.shape[0], dtype=torch.long, device=x_q.device)
    for g, (s, e) in enumerate(_group_bounds(group_sizes)):
        if e > s:
            acc[s:e] = x_q[s:e].double() @ w_q[g].double()
            seg[s:e] = g
    y = acc.float() * w_scale[seg]
    if a_scale is not None:
        y = y * a_scale
    return y


def grouped_matmul_q4_ref(x_q: torch.Tensor, w_packed: torch.Tensor,
                          group_sizes: torch.Tensor, w_scale: torch.Tensor,
                          a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8: nibble-packed int4 stack ``uint8 [G, ceil(Din/2), Dout]``
    unpacked to int4 values held in int8, then the int8 product above."""
    w_q = unpack_int4(w_packed, x_q.shape[1])
    return grouped_matmul_q_ref(x_q, w_q, group_sizes, w_scale, a_scale)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8: int8 [M, K] x int8 [K, N] -> f32(acc) * (x_scale * w_scale[n])
    (+ bias[n])."""
    acc = x_q.double() @ w_q.double()
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias
    return y


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, gemma-style (1 + gamma), the sum in f32,
    y in x's dtype (``repro.models.layers.rmsnorm``)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma)).to(dt)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """Mamba-1 selective scan over x, dt [B, S, di] (dt after softplus),
    b, c [B, S, N], a [di, N] (negative) and d [di]:
    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t, y_t = h_t c_t + d x_t.

    Returns (y [B, S, di] in x's dtype, h_last [B, di, N] f32). A loop over
    time in the kernel's order and rounding (each product and sum rounded
    to f32 on its own), so the state needs [B, di, N] only; the reference's
    associative scan holds [B, S, di, N]."""
    f32 = torch.float32
    B, S, di = x.shape
    a = a.to(f32)
    h = torch.zeros((B, di, b.shape[-1]), dtype=f32, device=x.device)
    y = torch.empty((B, S, di), dtype=f32, device=x.device)
    for t in range(S):
        dt_t = dt[:, t].to(f32)
        decay = torch.exp(dt_t[:, :, None] * a)
        u = (dt_t * x[:, t].to(f32))[:, :, None] * b[:, t, None, :].to(f32)
        h = decay * h + u
        y[:, t] = (h * c[:, t, None, :].to(f32)).sum(-1)
    return (y + x.to(f32) * d.to(f32)).to(x.dtype), h


def _scan_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor, b_t: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """One step of ``selective_scan_ref``'s recurrence, in its rounding."""
    decay = torch.exp(dt_t[:, :, None] * a)
    return decay * h + (dt_t * x_t)[:, :, None] * b_t[:, None, :]


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                           dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None):
    """The backward of ``selective_scan_ref`` (f32 only): given dy [B, S, di]
    and optionally dh_last [B, di, N], returns (dx, ddt [B, S, di], db, dc
    [B, S, N], da [di, N], dd [di]).

    With g_t the gradient of h_t, a_t = exp(dt_t A):
      g_t = dy_t c_t + a_{t+1} g_{t+1}  (plus dh_last at t = S - 1),
      dx_t = dt_t sum_n g_t b_t + D dy_t,
      ddt_t = sum_n A q_t + x_t sum_n g_t b_t,  q_t = (g_t a_t) h_{t-1},
      db_t = sum_d g_t (dt_t x_t),  dc_t = sum_d h_t dy_t,
      da = sum_b (sum_t q_t dt_t),  dd = sum_{b,t} dy_t x_t.
    An explicit reverse loop, each product and sum rounded on its own in
    the forward's order. A forward pass keeps every state h_t ([S, B, di,
    N] f32 in all: 4.3 GB at [2, 4096, 8192, 16]). ``da`` sums each batch
    row over t from the last step back, then the rows in order, as the
    kernel does."""
    if not all(t.dtype == torch.float32 for t in (x, dt, b, c, a, d, dy)) or (
            dh_last is not None and dh_last.dtype != torch.float32):
        raise TypeError("selective_scan_bwd takes f32 operands, got "
                        f"{[str(t.dtype) for t in (x, dt, b, c, a, d, dy)]}")
    B, S, di = x.shape
    N = b.shape[-1]
    hs = [x.new_zeros((B, di, N))]  # hs[t + 1] = h_t
    for t in range(S):
        hs.append(_scan_step(hs[-1], x[:, t], dt[:, t], b[:, t], a))
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da_rows = x.new_zeros((B, di, N))
    carry = x.new_zeros((B, di, N)) if dh_last is None else dh_last  # a_{t+1} g_{t+1}
    for t in reversed(range(S)):
        h_prev, h_t = hs[t], hs[t + 1]
        x_t, dt_t, dy_t = x[:, t], dt[:, t], dy[:, t]
        dc[:, t] = (h_t * dy_t[:, :, None]).sum(1)
        g = dy_t[:, :, None] * c[:, t, None, :] + carry
        decay = torch.exp(dt_t[:, :, None] * a)
        q = (g * decay) * h_prev
        s1 = (g * b[:, t, None, :]).sum(-1)
        dx[:, t] = dt_t * s1 + d * dy_t
        ddt[:, t] = (a * q).sum(-1) + x_t * s1
        db[:, t] = (g * (dt_t * x_t)[:, :, None]).sum(1)
        da_rows = da_rows + q * dt_t[:, :, None]
        carry = decay * g
    da = da_rows[0]
    for i in range(1, B):
        da = da + da_rows[i]
    return dx, ddt, db, dc, da, (dy * x).sum((0, 1))
