"""Dispatch to the hand-written kernels, ported from ``repro.kernels.ops``.

The device of the tensors chooses, and nothing else: a CUDA tensor goes to
the CUDA kernel (which launches or raises), a CPU tensor to the kernel's
plain version in ``kernels/ref.py``.

Kernel annotations: with ``set_kernel_annotations(True)`` (what
``TraceConfig.annotate_kernels`` turns on through ``serving/trace.py:
make_tracer``) each wrapper below runs inside a
``torch.profiler.record_function`` range named by the wrapper and its shapes
(``int8_matmul[M=8,K=2048,N=2048]``), so a profile of an eager step names
each kernel call. With the flag off (the default) a wrapper pays one
module-global read and builds no name. A range is host-side: it is recorded
while a step is captured into a CUDA graph and is absent when the graph
replays, so the ranges name kernels in eager steps (``aot_warmup=False``)
only; under replay the hand kernels' own device names say which ran.

Gradients (``kernels/autograd.py``): under grad the f32 grouped matmul,
the selective scan, attention and RMSNorm go through
``torch.autograd.Function``s (the grouped kernel and the weight-gradient
kernel in the grouped matmul's backward, the scan's backward kernel in the
scan's; attention and RMSNorm recompute their plain version there); the
integer kernels raise on a CUDA tensor that requires grad.

Autotuning (``kernels/autotune.py``): ``attention`` and ``grouped_matmul``
resolve their call's shape-bucket key before the device branch, so a
``collecting()`` scope records it on any device and the active table's
stats count the lookup. On a CUDA tensor the table's pick goes to the
kernel as ``schedule=`` / ``variant=``; with no table, on a miss, or where
the pick cannot take the operands (counted ``untakeable``) the kernel's
rule picks. A step captured into a CUDA graph keeps the pick its capture
resolved.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core.moe.dispatch import expert_of_sorted_rows
from repro_torch.core.quant.calibrate import maybe_record
from repro_torch.core.quant.linear_quant import fake_quant_activation
from repro_torch.core.quant.qtypes import quantize_sym
from repro_torch.kernels import autograd, autotune
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.expert_linear import grouped_matmul as _gmm_kernel
from repro_torch.kernels.expert_linear import grouped_wgrad as _wgrad_kernel
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_kernel
from repro_torch.kernels.norm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.quant_attention import (
    fits_in_shared_memory,
    lm_attention,
    streaming_attention,
)
from repro_torch.kernels.selective_scan import selective_scan as _scan_kernel
from repro_torch.kernels.selective_scan import selective_scan_bwd as _scan_bwd_kernel

_ANNOTATE = False


def set_kernel_annotations(on: bool = True) -> None:
    """Turn the wrappers' ``record_function`` ranges on or off."""
    global _ANNOTATE
    _ANNOTATE = bool(on)


def kernel_annotations_enabled() -> bool:
    return _ANNOTATE


def _scope(name_fn):
    """A ``record_function`` range named by a lazy thunk: the name is built
    only when annotations are on."""
    if not _ANNOTATE:
        return contextlib.nullcontext()
    return record_function(name_fn())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset=0, quant_bits: int = 0,
              logit_softcap: float = 0.0, local_window: int = 0,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              kv_valid_len: Optional[torch.Tensor] = None,
              q_segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None,
              segments: Optional[int] = None) -> torch.Tensor:
    """Streaming attention over [B, S, H, hd] (GQA-native k/v), the
    reference's keyword contract. On the card the non-causal, cache-free,
    quantized f32 case of the vision models takes ``streaming_attention``
    (K/V of a head in shared memory) while it fits; every other case takes
    ``lm_attention`` (``segments``: its grid hint for segment ids; the
    plain version has no use for it) in the active tuning table's
    schedule, or the one its rule picks."""
    kw = dict(causal=causal, q_offset=q_offset, quant_bits=quant_bits,
              logit_softcap=logit_softcap, local_window=local_window,
              k_scale=k_scale, v_scale=v_scale, kv_valid_len=kv_valid_len,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    with _scope(lambda: (f"attention[B={q.shape[0]},Sq={q.shape[1]},H={q.shape[2]},"
                         f"Sk={k.shape[1]},q{quant_bits}]")):
        vision = (not causal and quant_bits > 0 and not logit_softcap
                  and not local_window and isinstance(q_offset, int) and q_offset == 0
                  and k_scale is None and kv_valid_len is None and q_segment_ids is None
                  and q.dtype == k.dtype == v.dtype == torch.float32
                  and fits_in_shared_memory(k.shape[1], q.shape[-1]))
        schedule = autotune.attn_schedule(q, k, v, causal=causal, quant_bits=quant_bits,
                                          local_window=local_window,
                                          scaled=k_scale is not None, vision=vision)

        def plain(q, k, v):
            return _ref.flash_attention_ref(q, k, v, **kw)

        if not q.is_cuda:
            kernel = plain
        elif vision:
            def kernel(q, k, v):
                return streaming_attention(q, k, v, quant_bits=quant_bits)
        else:
            def kernel(q, k, v):
                return lm_attention(q, k, v, segments=segments, schedule=schedule, **kw)
        if autograd.needs_grad(q, k, v):
            autograd.no_backward("attention (K/V scales)", k_scale, v_scale)
            return autograd.Recompute.apply(kernel, plain, q, k, v)
        return kernel(q, k, v)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   *, w_scale: Optional[torch.Tensor] = None,
                   a_scale: Optional[torch.Tensor] = None,
                   a_bits: int = 8) -> torch.Tensor:
    """Unified sparse/dense linear: y[t] = x[t] @ w[group(t)].

    int8 weights and nibble-packed int4 (``uint8``, W4A8) stacks execute as
    stored: an fp ``x`` is quantized here with the folded ``a_scale``, the
    contraction accumulates in int32 and the product-of-scales dequant
    lands once on the accumulator. On the card the kernel runs in the
    active tuning table's variant, or the one its rule picks. Under grad
    the f32 mode goes through ``autograd.GroupedMatmul`` (the integer modes
    raise on the card)."""
    integer_w = w.dtype in (torch.int8, torch.uint8)
    if not integer_w and autograd.needs_grad(x, w):
        return autograd.GroupedMatmul.apply(x, w, group_sizes, grouped_matmul, grouped_wgrad)
    if integer_w and x.is_cuda:
        autograd.no_backward("grouped_matmul (int8 / W4A8)", x, w_scale, a_scale)
    if integer_w and x.dtype != torch.int8:
        if a_scale is None:
            raise ValueError(
                f"{'int4' if w.dtype == torch.uint8 else 'int8'} grouped weights "
                "need the folded activation scale (a PTQ QuantizedParams tree "
                "carries it as the `wi_as` / `wo_a_scale` leaf)")
        x = quantize_sym(x.float(), a_scale, a_bits)
    with _scope(lambda: (f"grouped_matmul[T={x.shape[0]},G={w.shape[0]},"
                         f"Din={w.shape[1]},Dout={w.shape[2]},{w.dtype}]")):
        variant = autotune.gmm_variant(x, w, w_scale, a_scale)
        if x.is_cuda:
            return _gmm_kernel(x, w, group_sizes, w_scale=w_scale, a_scale=a_scale,
                               variant=variant)
        if w.dtype == torch.uint8:
            return _ref.grouped_matmul_q4_ref(x, w, group_sizes, w_scale, a_scale)
        if w.dtype == torch.int8:
            return _ref.grouped_matmul_q_ref(x, w, group_sizes, w_scale, a_scale)
        return _ref.grouped_matmul_ref(x, w, group_sizes)


def grouped_wgrad(x: torch.Tensor, dy: torch.Tensor,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    """The f32 grouped matmul's weight gradient, dw[g] = x[rows of g]^T @
    dy[rows of g] -> [G, Din, Dout]: the kernel on the card, its plain
    version on the CPU."""
    with _scope(lambda: (f"grouped_wgrad[T={x.shape[0]},G={group_sizes.shape[0]},"
                         f"Din={x.shape[1]},Dout={dy.shape[1]}]")):
        if x.is_cuda:
            return _wgrad_kernel(x, dy, group_sizes)
        return _ref.grouped_wgrad_ref(x, dy, group_sizes)


def grouped_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                group_sizes: torch.Tensor, *, act: str = "silu", glu: bool = True,
                bi: Optional[torch.Tensor] = None, bo: Optional[torch.Tensor] = None,
                taps=None, mid_a_scale: Optional[torch.Tensor] = None,
                a_bits: int = 8, wi_scale: Optional[torch.Tensor] = None,
                wo_scale: Optional[torch.Tensor] = None,
                wi_a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert MLP over sorted rows: fc1 (+bi) -> act -> fc2 (+bo), with the
    fc2 input quantized by ``mid_a_scale`` (int8 or packed-int4 fc2: the
    real quantizer; fp fc2: its fake-quant oracle)."""
    from repro_torch.models.layers import act_fn  # lazy: layers imports ops

    seg = None
    if bi is not None or bo is not None:
        seg = expert_of_sorted_rows(group_sizes, x.shape[0])
    h = grouped_matmul(x, wi, group_sizes, w_scale=wi_scale,
                       a_scale=wi_a_scale, a_bits=a_bits)
    if bi is not None:
        h = h + bi[seg]
    if glu:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act_fn(act)(g) * u
    else:
        h = act_fn(act)(h)
    maybe_record(taps, "moe_mid", h)
    if wo.dtype in (torch.int8, torch.uint8):
        y = grouped_matmul(h, wo, group_sizes, w_scale=wo_scale,
                           a_scale=mid_a_scale, a_bits=a_bits)
    else:
        if mid_a_scale is not None:
            h = fake_quant_activation(h.float(), mid_a_scale, bits=a_bits).to(h.dtype)
        y = grouped_matmul(h, wo, group_sizes)
    if bo is not None:
        y = y + bo[seg]
    return y


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 matmul with the Eq. 9 rescale at the flush."""
    with _scope(lambda: (f"int8_matmul[M={x_q.numel() // x_q.shape[-1]},"
                         f"K={w_q.shape[0]},N={w_q.shape[1]}]")):
        if x_q.is_cuda:
            autograd.no_backward("int8_matmul", x_scale, w_scale, bias)
            return _int8_kernel(x_q, w_q, x_scale, w_scale, bias)
        return _ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale, bias)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, (1 + gamma) scale; on the card one launch
    whose row sums do not depend on the number of rows."""
    with _scope(lambda: f"rmsnorm[R={x.numel() // x.shape[-1]},D={x.shape[-1]}]"):
        kernel = _rmsnorm_kernel if x.is_cuda else _ref.rmsnorm_ref
        if autograd.needs_grad(x, gamma):
            return autograd.Recompute.apply(lambda x, g: kernel(x, g, eps),
                                            lambda x, g: _ref.rmsnorm_ref(x, g, eps), x, gamma)
        return kernel(x, gamma, eps)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """Mamba-1 selective scan, the state on-chip for the whole sequence
    (O(S d) device-memory traffic). Returns (y [B, S, di], h_last
    [B, di, N] f32). Under grad through ``autograd.SelectiveScan``, whose
    backward is ``selective_scan_bwd``."""
    with _scope(lambda: (f"selective_scan[B={x.shape[0]},S={x.shape[1]},"
                         f"di={x.shape[2]},N={a.shape[-1]}]")):
        scan = _scan_kernel if x.is_cuda else _ref.selective_scan_ref
        if autograd.needs_grad(x, dt, b, c, a, d):
            if any(t.dtype != torch.float32 for t in (x, dt, b, c, a, d)):
                raise TypeError("selective_scan's backward takes f32 operands, got "
                                f"{[str(t.dtype) for t in (x, dt, b, c, a, d)]}")
            return autograd.SelectiveScan.apply(x, dt, b, c, a, d, scan, selective_scan_bwd)
        return scan(x, dt, b, c, a, d)


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None):
    """The scan's backward: (dx, ddt, db, dc, da, dd); the kernel on the
    card, its plain version on the CPU."""
    with _scope(lambda: (f"selective_scan_bwd[B={x.shape[0]},S={x.shape[1]},"
                         f"di={x.shape[2]},N={a.shape[-1]}]")):
        if x.is_cuda:
            return _scan_bwd_kernel(x, dt, b, c, a, d, dy, dh_last)
        return _ref.selective_scan_bwd_ref(x, dt, b, c, a, d, dy, dh_last)
