"""Mamba-1 selective scan on the card: h = exp(dt A) h + (dt x) B,
y = h C + D x, with the state kept in registers for the whole sequence.

The CUDA kernels are in ``csrc/selective_scan.cu`` (they replace the Pallas
kernel ``repro/kernels/selective_scan.py:selective_scan``); their plain
version is ``ref.selective_scan_ref``, which ``kernels/ops.py`` takes for CPU
tensors. Two variants compute the same h_last bit for bit:

  * 1, ``states``: a thread holds several states of one channel, the count
    per shape from ``scan_layout``; any state size up to ``MAX_STATE``,
    f32 or bf16 x, dt, B and C. The wrapper always takes it;
  * 2, ``lane``: the first port's kernel, one thread a state, f32 and N in
    ``LANE_STATE_DIMS`` only; kept as the yardstick ``chip_smoke.py`` times
    the states variant against, reached only by ``variant=2``.

``selective_scan.launches`` counts every launch and
``selective_scan.launches_by_mode[name]`` the launches of each variant.

The backward, ``selective_scan_bwd``, replaces no TPU kernel: the
reference's gradient is XLA's autodiff of its chunked associative scan. Its
plain version is ``ref.selective_scan_bwd_ref``;
``kernels/autograd.py:SelectiveScan`` pairs it with the forward, which then
saves the state at the start of every chunk of ``scan_bwd_chunk`` steps
(``save_states``). Two variants compute the same dA bit for bit:

  * 1, ``saved`` (``csrc/selective_scan_bwd.cu``): walks back from the
    forward's saved states (or, called alone, runs the forward kernel for
    them), a_t kept from the rebuild; three device launches a call (the
    walk, two ordered sums) with the states given. The wrapper always takes
    it;
  * 2, ``recompute`` (``csrc/selective_scan_bwd_recompute.cu``): the first
    design, its own states pass, exp(dt A) formed twice; four launches.
    Kept as the yardstick ``chip_smoke.py`` times the saved variant
    against, reached only by ``variant=2``.

``selective_scan_bwd.launches`` counts its calls and
``selective_scan_bwd.launches_by_mode[name]`` those of each variant.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import _build

VARIANTS = {1: "states", 2: "lane"}
SCAN_THREADS = 128  # threads of a states block (csrc/selective_scan.cu)
STATES_PER_THREAD = (16, 8, 4)  # the states variant's choices, widest first
MAX_LANES = 32  # lanes sharing a channel: one warp
MAX_STATE = STATES_PER_THREAD[0] * MAX_LANES
LANE_STATE_DIMS = (8, 16)
H100_SMS = 132
# warps a busy SM needs per state a thread: 12 at 16 states, 6 at 8, 3 at 4
# (the layout sweep of chip_smoke.py: [B, 256, 8192, 16], B 1..8)
LATENCY_WARPS_PER_STATE = 0.75
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def scan_layouts(N: int) -> list[tuple[int, int]]:
    """Every (states a thread, lanes a channel) of the states variant that
    covers N padded to a power of two Np >= 4 exactly (lanes x states = Np,
    lanes within one warp), widest states a thread first."""
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {N} not in 1..{MAX_STATE}")
    padded = max(4, 1 << (N - 1).bit_length())
    return [(s, padded // s) for s in STATES_PER_THREAD
            if s <= padded and padded // s <= MAX_LANES]


def scan_layout(B: int, di: int, N: int) -> tuple[int, int]:
    """The states variant's layout for [B, *, di, N]: of ``scan_layouts(N)``
    the one with the least work an SM, ceil(blocks / ``H100_SMS``) x
    states a thread (the blocks come in whole waves), among those that
    give a busy SM at least ``LATENCY_WARPS_PER_STATE`` x states a thread
    warps (a thread's states are independent chains, but a wider thread
    issues fewer of them at once for the latency of its loads and expf to
    hide); ties go to the widest. Where none qualifies, the narrowest
    (most threads)."""
    layouts = scan_layouts(N)
    best = None
    for spt, lanes in layouts:
        blocks = B * -(-di * lanes // SCAN_THREADS)
        per_sm = -(-blocks // H100_SMS)
        if per_sm * SCAN_THREADS // 32 < LATENCY_WARPS_PER_STATE * spt:
            continue
        if best is None or per_sm * spt < best[0]:
            best = (per_sm * spt, (spt, lanes))
    return layouts[-1] if best is None else best[1]


@contextlib.contextmanager
def _written_in_full():
    """Allocations that a kernel writes in every element: deterministic
    mode's fill of uninitialized memory (``torch.utils.deterministic``)
    would only be overwritten, so it is off while they are made."""
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = fill


def _launch_save(x, dt, b, c, a, d, layout, hk, want_y=True):
    """The states variant's saving kernel on checked, contiguous f32
    operands: (y, or None without ``want_y``; h_last; the state at the start
    of every chunk of ``hk`` steps but the first, [B, ceil(S / hk) - 1, di,
    N])."""
    B, S, di = x.shape
    N = b.shape[-1]
    with _written_in_full():
        hs = x.new_empty((B, max(0, -(-S // hk) - 1), di, N))
    y = torch.empty_like(x) if want_y else None
    h_last = x.new_empty((B, di, N))
    with torch.cuda.device(x.device):
        err = _build.library().selective_scan_save_launch(
            *(t.data_ptr() for t in (x, dt, b, c, a, d)), y.data_ptr() if want_y else None,
            h_last.data_ptr(), hs.data_ptr() if hs.numel() else None, B, S, di, N, *layout,
            hk, _build.stream(x))
    _build.check(err, "selective_scan (states, saving)")
    return y, h_last, hs


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   variant: Optional[int] = None,
                   layout: Optional[tuple[int, int]] = None,
                   save_states: bool = False):
    """x, dt [B, S, di] (dt after softplus), b, c [B, S, N], all four f32
    or all bf16; a f32 [di, N] (negative decay rates), d f32 [di] -> (y
    [B, S, di] in x's dtype, h_last f32 [B, di, N]); CUDA tensors only.
    ``variant`` forces one of ``VARIANTS`` (default: 1); ``layout`` forces
    one of ``scan_layouts(N)`` on the states variant (default:
    ``scan_layout``; ``chip_smoke.py`` checks and times every layout).
    ``save_states`` (states variant, f32): also return the state at the start
    of every chunk of the backward's ``scan_bwd_chunk`` steps but the first,
    f32 [B, ceil(S / K) - 1, di, N], which ``selective_scan_bwd`` takes as
    ``states``."""
    variant = 1 if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"selective_scan variant {variant}: one of {VARIANTS}")
    if not (x.dtype == dt.dtype == b.dtype == c.dtype) or x.dtype not in _X_TYPES \
            or a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError("selective_scan takes x, dt, b, c all f32 or all bf16 and f32 "
                        f"a, d, got {[str(t.dtype) for t in (x, dt, b, c, a, d)]}")
    B, S, di = x.shape
    N = b.shape[-1]
    if (dt.shape != x.shape or b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape != (di, N) or d.shape != (di,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, d "
            f"{tuple(d.shape)}")
    if variant == 2 and (x.dtype != torch.float32 or N not in LANE_STATE_DIMS
                         or save_states):
        raise ValueError(f"the lane variant takes f32 and N in {LANE_STATE_DIMS}, and "
                         "saves no states")
    if save_states and x.dtype != torch.float32:
        raise ValueError("save_states takes f32 operands (the backward's), got "
                         f"{x.dtype}")
    if layout is None:
        layout = scan_layout(B, di, N)
    elif variant != 1 or tuple(layout) not in scan_layouts(N):
        raise ValueError(f"selective_scan layout {layout}: the states variant takes one of "
                         f"{scan_layouts(N)} at N={N}")
    _build.require_cuda("selective_scan", x, dt, b, c, a, d)
    x, dt, b, c, a, d = (t.contiguous() for t in (x, dt, b, c, a, d))
    if save_states:
        y, h_last, hs = _launch_save(x, dt, b, c, a, d, layout,
                                     scan_bwd_chunk(scan_bwd_layout(N)[0]))
    else:
        spt, lanes = layout
        y = torch.empty_like(x)
        h_last = torch.empty((B, di, N), dtype=torch.float32, device=x.device)
        lib = _build.library()
        ptrs = [t.data_ptr() for t in (x, dt, b, c, a, d, y, h_last)]
        with torch.cuda.device(x.device):
            if variant == 1:
                err = lib.selective_scan_launch(*ptrs, B, S, di, N, _X_TYPES[x.dtype], spt,
                                                lanes, _build.stream(x))
            else:
                err = lib.selective_scan_lane_launch(*ptrs, B, S, di, N, _build.stream(x))
        _build.check(err, f"selective_scan ({VARIANTS[variant]})")
    selective_scan.launches += 1
    mode = VARIANTS[variant]
    selective_scan.launches_by_mode[mode] = selective_scan.launches_by_mode.get(mode, 0) + 1
    return (y, h_last, hs) if save_states else (y, h_last)


selective_scan.launches = 0
selective_scan.launches_by_mode = {}

BWD_VARIANTS = {1: "saved", 2: "recompute"}
BWD_THREADS = {1: 128, 2: 256}  # threads of a block, by variant
BWD_STATES_PER_THREAD = 4
SMEM_PER_BLOCK = 232448  # bytes a block may take on the H100 (227 KB)


def _padded(N: int, name: str) -> int:
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"{name}: state size {N} not in 1..{MAX_STATE}")
    return max(4, 1 << (N - 1).bit_length())


def scan_bwd_layout(N: int) -> tuple[int, int]:
    """The backward's (states a thread, lanes a channel) at state size N,
    both variants: 4 states a thread while N padded to a power of two >= 4
    takes at most 32 lanes (N <= 128; the most threads for a sequential
    walk, and the a_t registers hold a chunk of 16 steps), else 32 lanes."""
    padded = _padded(N, "selective_scan_bwd")
    spt = max(BWD_STATES_PER_THREAD, padded // MAX_LANES)
    return spt, padded // spt


def scan_bwd_chunk(spt: int) -> int:
    """Time steps between two saved states of the backward, which its
    block rebuilds at once: 64 state steps a thread (the saved variant
    keeps the chunk's a_t in 64 registers)."""
    return 64 // spt


def scan_bwd_smem_bytes(spt: int, lanes: int) -> int:
    """Shared memory of a saved-variant block (``Geo`` in
    ``csrc/selective_scan_bwd.cu``): the history, K x spt / 4 rows of
    threads + 1 float4, and a ring of two chunks of x, dt, dy (rows of
    channels + 4) and B, C."""
    threads, K, NP = BWD_THREADS[1], scan_bwd_chunk(spt), spt * lanes
    hist = K * spt // 4 * (threads + 1) * 4
    slot = 3 * K * (threads // lanes + 4) + 2 * K * NP
    return 4 * (hist + 2 * slot)


def scan_bwd_recompute_smem_bytes(spt: int, lanes: int) -> int:
    """Shared memory of a recompute-variant block: the history [K][spt]
    [256] and one chunk of B, C and x, dt, dy."""
    threads, K = BWD_THREADS[2], scan_bwd_chunk(spt)
    return 4 * (K * spt * threads + 2 * K * spt * lanes + 3 * K * threads // lanes)


def scan_bwd_workspace(variant: int, B: int, S: int, di: int, N: int) -> dict:
    """Floats of each workspace a backward call allocates (``states``: the
    saved variant's when called without them): the chunk-start states, the
    per-block partials of db and dc, dA's rows."""
    spt, lanes = scan_bwd_layout(N)
    nck = -(-S // scan_bwd_chunk(spt))
    blocks = -(-di // (BWD_THREADS[variant] // lanes))
    return {"states": B * (nck - (variant == 1)) * di * N,
            "partials": 2 * blocks * B * S * N, "da_rows": B * di * N}


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None, *,
                       states: Optional[torch.Tensor] = None,
                       variant: Optional[int] = None):
    """The scan's backward on the card, ``ref.selective_scan_bwd_ref``'s
    contract: f32 x, dt, dy [B, S, di], b, c [B, S, N], a [di, N], d [di],
    dh_last [B, di, N] or None -> (dx, ddt [B, S, di], db, dc [B, S, N],
    da [di, N], dd [di]); other dtypes raise. Sums in a fixed order: two
    calls are bit-equal. ``dd`` is one torch reduction, as in the plain
    version. ``variant`` forces one of ``BWD_VARIANTS`` (default 1).

    The saved variant takes ``states``, the forward's chunk-start states
    (``selective_scan(..., save_states=True)``); without them it runs the
    forward kernel for them first (without y). Layout: ``scan_bwd_layout``.
    Workspace
    (``scan_bwd_workspace``): the states [B, ceil(S / K) - 1, di, N] where
    not given, the per-block partials of db and dc [2, ceil(di / channels a
    block), B, S, N], dA's rows [B, di, N]. Bound at falcon-mamba's
    training shape [2, 4096, 8192, 16]: the larger of the bytes (x, dt, dy
    read, dx, ddt written: 1.35 GB, 0.40 ms at 3.35 TB/s) and the
    operations (~20 f32 operations a state step over 1.07e9 state steps,
    0.32 ms at 67 TFLOP/s), so 0.40 ms, bound by bytes. The saved
    variant's compiled loop issues up to ~62 slots a state step, 31 of them
    its arithmetic, shared-memory and shuffle work (2.0 ms at 128 lanes a
    clock on 132 SMs), and allocates the states where not given
    (268 MB at that shape), the partials (268 MB) and dA's rows (1 MB):
    see ``csrc/selective_scan_bwd.cu``."""
    variant = 1 if variant is None else variant
    if variant not in BWD_VARIANTS:
        raise ValueError(f"selective_scan_bwd variant {variant}: one of {BWD_VARIANTS}")
    ins = (x, dt, b, c, a, d, dy) + (() if dh_last is None else (dh_last,))
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("selective_scan_bwd takes f32 operands, got "
                        f"{[str(t.dtype) for t in ins]}")
    B, S, di = x.shape
    N = b.shape[-1]
    if (dt.shape != x.shape or dy.shape != x.shape or b.shape != (B, S, N)
            or c.shape != (B, S, N) or a.shape != (di, N) or d.shape != (di,)
            or (dh_last is not None and dh_last.shape != (B, di, N))):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, b {tuple(b.shape)}, "
            f"c {tuple(c.shape)}, a {tuple(a.shape)}, d {tuple(d.shape)}, dy "
            f"{tuple(dy.shape)}, dh_last {None if dh_last is None else tuple(dh_last.shape)}")
    if variant == 2 and states is not None:
        raise ValueError("the recompute variant takes no states")
    spt, lanes = scan_bwd_layout(N)
    nck = -(-S // scan_bwd_chunk(spt))
    if states is not None and (states.dtype != torch.float32
                               or states.shape != (B, max(0, nck - 1), di, N)):
        raise ValueError(f"states {states.dtype} {tuple(states.shape)}: f32 "
                         f"{(B, max(0, nck - 1), di, N)}")
    _build.require_cuda("selective_scan_bwd", *ins,
                        *(() if states is None else (states,)))
    x, dt, b, c, a, d, dy = (t.contiguous() for t in (x, dt, b, c, a, d, dy))
    dh_last = None if dh_last is None else dh_last.contiguous()
    work = scan_bwd_workspace(variant, B, S, di, N)
    # for the states, without y (none to run for where S fits one chunk)
    run_forward = variant == 1 and states is None and work["states"] > 0
    with contextlib.nullcontext() if variant == 2 else _written_in_full():
        dx, ddt = torch.empty_like(x), torch.empty_like(x)
        dbc = x.new_empty((2, B, S, N))
        da = x.new_empty((di, N))
        part, da_part = x.new_empty(work["partials"]), x.new_empty(work["da_rows"])
    if x.numel() == 0:  # nothing to walk: no launch
        for t in (dx, ddt, dbc, da):
            t.zero_()
        return dx, ddt, dbc[0], dbc[1], da, (dy * x).sum((0, 1))
    lib = _build.library()
    if variant == 1:
        if run_forward:
            states = _launch_save(x, dt, b, c, a, d, scan_layout(B, di, N),
                                  scan_bwd_chunk(spt), want_y=False)[2]
        states = None if states is None or not states.numel() else states.contiguous()
        with torch.cuda.device(x.device):
            err = lib.selective_scan_bwd_launch(
                *(t.data_ptr() for t in (x, dt, b, c, a, d, dy)),
                None if dh_last is None else dh_last.data_ptr(),
                None if states is None else states.data_ptr(),
                *(t.data_ptr() for t in (part, da_part, dx, ddt, dbc, da)),
                B, S, di, N, spt, lanes, _build.stream(x))
    else:
        hs = x.new_empty(work["states"])
        with torch.cuda.device(x.device):
            err = lib.selective_scan_bwd_recompute_launch(
                *(t.data_ptr() for t in (x, dt, b, c, a, d, dy)),
                None if dh_last is None else dh_last.data_ptr(),
                *(t.data_ptr() for t in (hs, part, da_part, dx, ddt, dbc, da)),
                B, S, di, N, spt, lanes, _build.stream(x))
    mode = BWD_VARIANTS[variant]
    _build.check(err, f"selective_scan_bwd ({mode})")
    selective_scan_bwd.launches += 1
    selective_scan_bwd.launches_by_mode[mode] = (
        selective_scan_bwd.launches_by_mode.get(mode, 0) + 1)
    return dx, ddt, dbc[0], dbc[1], da, (dy * x).sum((0, 1))


selective_scan_bwd.launches = 0
selective_scan_bwd.launches_by_mode = {}
