"""W8A8 matmul on the card (paper Eqs. 7/9): int8 x int8 -> int32 tiles,
one product-of-scales rescale at the flush, bias fused into it.

The CUDA kernels are in ``csrc/int8_matmul.cu`` (they replace the Pallas
kernel ``repro/kernels/int8_matmul.py:int8_matmul``); their plain version is
``ref.int8_matmul_ref``, which ``kernels/ops.py`` takes for CPU tensors.
Three variants compute the same function bit for bit, and ``choose_variant``
picks one from the shape and the operands' alignment:

  * 1, ``mma``: tensor-core s8 MMA tiles, for M > 16 (prefill, vision);
  * 2, ``stream``: streams the weight once at M <= 16 (decode, heads), k
    split over blocks when the columns alone would not fill the card;
  * 3, ``dp4a``: the first port's ``__dp4a`` tiles, for what neither takes
    (K % 16 != 0, N % 8 != 0, or an operand not 16-byte aligned).

``int8_matmul.launches`` counts every launch and
``int8_matmul.launches_by_mode[name]`` the launches of each variant.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

VARIANTS = {1: "mma", 2: "stream", 3: "dp4a"}
H100_SMS = 132
STREAM_MAX_M = 16  # variant 2 pads x to one m16 MMA tile
MMA_TILES = ((128, 128), (64, 64), (32, 64))  # variant 1 configs, by index
K_TILE = 64  # k bytes a pipeline stage of variants 1 and 2 holds
STREAM_N = 64  # columns of a variant-2 block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_variant(M: int, K: int, N: int, aligned: bool = True) -> int:
    """1, 2 or 3 (see the module docstring) for x [M, K] @ w [K, N]."""
    if not aligned or K % 16 or N % 8:
        return 3
    return 2 if M <= STREAM_MAX_M else 1


def takes(variant: int, M: int, K: int, N: int, aligned: bool = True) -> bool:
    """Whether ``variant`` computes x [M, K] @ w [K, N] (variant 3 takes
    every shape; variant 2 only M <= 16)."""
    if variant == 3:
        return True
    if variant not in VARIANTS or choose_variant(M, K, N, aligned) == 3:
        return False
    return variant == 1 or M <= STREAM_MAX_M


def mma_config(M: int, N: int, sms: int = H100_SMS) -> int:
    """Index into ``MMA_TILES``: the largest tile that still gives every SM
    a block, else the smallest."""
    for i, (bm, bn) in enumerate(MMA_TILES):
        if _cdiv(M, bm) * _cdiv(N, bn) >= sms:
            return i
    return len(MMA_TILES) - 1


def stream_split(K: int, N: int, sms: int = H100_SMS) -> tuple:
    """(splits, k tiles per split) of variant 2: k is split over blocks
    until the 64-column strips times the splits give about two blocks a
    SM, and no split is empty."""
    ktiles = _cdiv(K, K_TILE)
    if ktiles == 0:
        return 1, 0
    want = min(ktiles, max(1, _cdiv(2 * sms, _cdiv(N, STREAM_N))))
    per = _cdiv(ktiles, want)
    return _cdiv(ktiles, per), per


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, n_ints: int) -> torch.Tensor:
    """Variant 2's split-k scratch on ``stream``: int32, zero between
    launches (each launch leaves it as it found it), so it is zeroed only
    when it is first made or grown."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n_ints:
        ws = torch.zeros(max(n_ints, 1 << 20), dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                variant: Optional[int] = None) -> torch.Tensor:
    """x_q int8 [M, K] @ w_q int8 [K, N] -> f32 [M, N] with
    ``float(acc) * (x_scale * w_scale[n]) (+ bias[n])``; CUDA tensors only.
    ``variant`` forces one of ``VARIANTS`` (it must take the shape);
    by default ``choose_variant`` picks it."""
    _build.require_cuda("int8_matmul", x_q, w_q, x_scale, w_scale, bias)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x_q.dtype}, {w_q.dtype}")
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2 or w_scale.shape != (N,):
        raise ValueError(f"shape mismatch: x {tuple(x_q.shape)}, w "
                         f"{tuple(w_q.shape)}, w_scale {tuple(w_scale.shape)}")
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    xs = _build.scalar(x_scale, x_q)
    ws = w_scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0 or N == 0:
        return out
    aligned = _aligned(x_q, w_q, ws, b, out)
    if variant is None:
        variant = choose_variant(M, K, N, aligned)
    elif not takes(variant, M, K, N, aligned):
        raise ValueError(f"int8_matmul variant {variant} cannot take "
                         f"[{M}, {K}, {N}] (16-byte aligned: {aligned})")
    lib, stream = _build.library(), _build.stream(x_q)
    args = (x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr())
    with torch.cuda.device(x_q.device):
        if variant == 1:
            err = lib.int8_matmul_mma_launch(
                *args, M, N, K, mma_config(M, N, _sms(x_q.device.index)), stream)
        elif variant == 2:
            splits, per = stream_split(K, N, _sms(x_q.device.index))
            work = _workspace(x_q.device, stream, M * N + _cdiv(N, STREAM_N))
            err = lib.int8_matmul_stream_launch(
                *args, work.data_ptr(), work.data_ptr() + 4 * M * N, M, N, K,
                splits, per, stream)
        else:
            err = lib.int8_matmul_launch(*args, M, N, K, stream)
    _build.check(err, f"int8_matmul ({VARIANTS[variant]})")
    int8_matmul.launches += 1
    mode = VARIANTS[variant]
    int8_matmul.launches_by_mode[mode] = int8_matmul.launches_by_mode.get(mode, 0) + 1
    return out


int8_matmul.launches = 0
int8_matmul.launches_by_mode = {}
