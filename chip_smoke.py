#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase's error is
caught:

  1. device   -- require CUDA, print the card's name and power limit;
  2. build    -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  -- hold each kernel against its plain PyTorch version and time
                 it (device time per call: ``graph_ms``, CUDA-graph replays;
                 eager time beside it): ``int8_matmul`` (every variant that
                 takes a shape, bit-equal, at the main path's shapes and at
                 ``INT8_RAGGED``; beside its dp4a variant and ``torch._int_mm``,
                 cold L2 at the decode and LM-head rows); ``grouped_matmul``
                 int8 and W4A8 in every variant (mma, stream, dp4a), bit-equal
                 at the M3ViT-S and OLMoE-1B-7B decode / prefill shapes and at
                 ``GROUPED_RAGGED``, timed in the chosen variant beside dp4a
                 (cold L2 at decode), and the f32 mode at the M3ViT-S and
                 OLMoE calibration shapes, each timed call alone one device
                 kernel; ``streaming_attention`` with ``lm_attention`` on the
                 same vision inputs; every LM mode of ``lm_attention`` at the
                 OLMoE-1B-7B shapes, and at head dims 112 and 100
                 (exact-score inputs within 1e-5; with Gaussian q the
                 ``quant_bits=0`` rows within ``GAUSSIAN_QB0_TOL``, the
                 ``quant_bits=4`` rows no more rows over 1e-4 than
                 ``PARENT_GAUSSIAN_OVER``; at the decode shapes the tile
                 schedule bit-equal to the decode schedule; a call alone one
                 device kernel; ``scaled_dot_product_attention`` timed
                 beside each ``quant_bits=0`` row); ``selective_scan`` at the
                 falcon-mamba-7b prefill shapes [B, S, di, N] = [1, 256, 8192,
                 16], [8, 256, 8192, 16] and a ragged S = 200, and state 8 at
                 [2, 100, 256, 8] (y and h_last within atol = rtol = 1e-5),
                 timed beside its plain version;
  4. serving  -- full-width M3ViT-S (``configs/moe_vit.py:CONFIG``): seeded fp
                 init on the card, calibration on 2 batches of 2, PTQ to the
                 int8 tree, ``VisionEngine(buckets=(1, 4, 8))`` serving 24
                 requests; every kernel's launch count must grow by exactly
                 its per-forward count times the dispatched batches, and
                 every int8_matmul and integer grouped_matmul call go
                 through variant 1 or 2;
  5. e2e      -- one batch of 4 through ``forward`` on the card and on a CPU
                 copy of the same tree (plain versions): free-running logits
                 printed, then every block and the head teacher-forced from
                 the card's input and gated;
  6. profile  -- one int8 forward at B=8: wall and enqueue time, device time
                 of every kernel launched (torch.profiler); exactly one
                 device kernel per int8_matmul, grouped_matmul and attention
                 call (here and in phase 7's profiles);
  7. lm       -- full-width OLMoE-1B-7B (``configs/olmoe_1b_7b.py``): seeded
                 fp init on the card, calibration on 2 batches of 2 x 32
                 tokens, PTQ to the int8 tree and to the W4A8 tree (the fp
                 tree is then freed); each tree is served by
                 ``ServeEngine(batch_slots=8, max_len=512)``, 16 seeded
                 requests of 16-256 prompt tokens and 32 new tokens. Gates:
                 launches grow by exactly 81 / 32 / 16 (int8_matmul / grouped
                 / lm_attention) per packed admission and per decode tick,
                 every int8_matmul and grouped_matmul call on variant 1 (mma)
                 or 2 (stream);
                 every request completes; teacher-forced, the engine's logits
                 of every request at 9 of its 32 steps match ``prefill`` over
                 the same prefix within the stated limits; the same requests
                 served again give bit-equal tokens and logits; the expert
                 combine of 8 tokens equals theirs among 512. Printed, not
                 gated: the worst request served alone, and one RMSNorm of 8
                 rows alone against the same rows among 512. Then one decode
                 tick and one 512-token packed prefill are profiled;
  8. ssm      -- the OLMoE trees and engines freed (at most 1 GB of the
                 earlier phases may stay allocated), full-width falcon-mamba-7b
                 (``configs/falcon_mamba_7b.py``, seeded f32 init on the card,
                 28 GB) served by
                 ``ServeEngine(batch_slots=8, max_len=512)`` through the grouped
                 same-length admission path: 16 seeded requests with prompts
                 of 64, 128 or 256 tokens and 32 new tokens. Gates: the scan
                 launches exactly 64 times per grouped prefill dispatch and
                 never in a decode tick, no other kernel is launched, every
                 request completes, and the engine's logits at every step of
                 every request match ``forward`` over the same prefix within
                 ``SSM_TF_LIMIT``, and the first wave served again with TF32
                 matmuls or with a bf16 conv history fails that gate. One
                 decode tick and one grouped prefill of 8 x 256 tokens are
                 profiled.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and the line before that
holds the ``{"kernels": [...]}`` record (the int8_matmul and grouped rows
name the variant they timed, the attention rows the schedule). A row's
``ms`` is device time per call over CUDA-graph replays (``graph_ms``), warm
caches unless a ``cold_ms`` stands beside it; the selective-scan rows and
the plain versions are CUDA-event times of eager calls.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # dense tensor-core int8
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
REPLACES = {
    "int8_matmul": "src/repro/kernels/int8_matmul.py:53",
    "grouped_matmul": "src/repro/kernels/expert_linear.py:172",
    "streaming_attention": "src/repro/kernels/quant_attention.py:207",
    "lm_attention": "src/repro/kernels/quant_attention.py:207",
    "selective_scan": "src/repro/kernels/selective_scan.py:70",
}
SOURCES = {
    "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
    "streaming_attention": "src/repro_torch/kernels/csrc/quant_attention.cu",
    "lm_attention": "src/repro_torch/kernels/csrc/lm_attention.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
}
# kernel launches per int8 forward of M3ViT-S: 6 dense layers x (q, k, v, o,
# fc1, fc2) + 6 MoE layers x (q, k, v, o, gate) + head; 6 MoE layers x (fc1,
# fc2); 12 attention layers
PER_FORWARD = {"int8_matmul": 67, "grouped_matmul": 12, "streaming_attention": 12}
# per OLMoE-1B-7B forward of the int8 / W4A8 trees (a packed admission or a
# decode tick): 16 layers x (q, k, v, o, gate) + lm_head; 16 x (fc1, fc2);
# 16 attention layers
LM_PER_FORWARD = {"int8_matmul": 81, "grouped_matmul": 32, "lm_attention": 16}
# device kernel names of each wrapper's launches (profiles count them)
KERNEL_NAMES = {
    "int8_matmul": ("int8_mma_kernel", "int8_stream_kernel", "int8_matmul_kernel"),
    "grouped_matmul": ("gmm_mma_kernel", "gmm_stream_kernel", "gmm_dp4a_kernel",
                       "gmm_f32_kernel"),
    "streaming_attention": ("quant_attention_kernel",),
    "lm_attention": ("lm_decode_kernel", "lm_tile_kernel"),
    "selective_scan": ("selective_scan_kernel",),
}
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW_TOKENS = 8, 512, 16, 32
PROFILE_ATTEMPTS = 5  # traces of one profile, at most, while one is incomplete
# teacher-forced gate, per tree: every request at these steps (the first
# token from the packed prefill, then decode ticks); limits on the median
# and p90 of the per-step max |logit| error against prefill and on the
# number of steps (of 144) whose greedy token differs. The int8 tree read
# median 0.054, p90 0.144 and 5 such steps on an H100, with |logit| up to
# 4.6; the limits sit about 3x above. A fault (wrong slot, row, position
# or scale) moves nearly every step by the size of the logits.
LM_TF_STEPS = (0, 1, 2, 3, 5, 8, 13, 21, 31)
LM_TF_LIMITS = {"int8": (0.15, 0.4, 14), "int4": (0.15, 0.4, 14)}
# falcon-mamba-7b serving: 64 layers, one selective_scan launch each per
# grouped prefill dispatch; 8 slots, 16 requests of 64, 128 or 256 prompt
# tokens and 32 new tokens
SSM_LAYERS, SSM_SLOTS, SSM_MAX_LEN = 64, 8, 512
SSM_REQUESTS, SSM_NEW_TOKENS, SSM_PROMPT_LENS = 16, 32, (64, 128, 256)
# teacher-forced gate: at every step of every request, max |engine logit -
# forward logit| / max |forward logit|, limits on the median and the max
# over all steps. All f32 with no quantizer and no routing: the two differ
# only in the order of f32 sums (matmuls of other shapes, the scan against
# the one-step decode update), but 64 random-weight layers amplify a
# last-bit difference ~1e3-1e4-fold (``tests/test_torch_ssm.py::
# test_deep_decode_is_as_accurate_as_forward``: ~3e-4 on the CPU, and the
# f32 forward as far from f64). An H100 read median 5.34e-4, max 3.92e-3;
# the limits sit 3x above. Two controls of rounding size must fail it
# (``SSM_CONTROLS``), and a fault (wrong slot, state, row or position) moves
# a step's logits by their size.
SSM_TF_LIMIT = (1.6e-3, 1.2e-2)
# the controls: the first admission wave served again with TF32 matmuls
# (10-bit mantissa), and with its conv history rounded to bf16 (the
# reference engine's cache layout)
SSM_CONTROLS = ("tf32 matmuls", "bf16 conv history")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
                 "runs only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}",
          flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {_build.library_path()}",
          flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {log.stem}: {line.strip()}", flush=True)


def graph_ms(fn, n: int = 20, iters: int = 10) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA graph
    and replayed, so the host's enqueue time (tens of microseconds a call of
    a Python wrapper) is not counted. Warmed up on the capture stream first
    (build, scratch, shared-memory attributes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, iters=iters, warmup=2) / n


# ragged int8_matmul shapes that reach every variant and edge: M on both
# sides of 16 (variant 2 / 1), K % 16 != 0 and N % 8 != 0 (variant 3),
# N = 1000 (the M3ViT-S head: 8-byte weight copies, a ragged last tile),
# the widest weight at one row, and an empty x
INT8_RAGGED = ([(m, k, n) for m in (1, 8, 16, 17, 33, 197) for k in (100, 384, 2048)
                for n in (10, 16, 64, 1000, 1001)] + [(1, 2048, 50304), (0, 64, 64)])
# cold-L2 timing: weights rotated over buffers of at least this many bytes
# in all, three times the H100's 50 MB L2
COLD_BYTES = 150e6


def _check_int8_matmul(gen) -> dict:
    """Every variant of int8_matmul that takes a shape, with and without
    bias, bit-equal to ``int8_matmul_ref`` at the main path's shapes and at
    ``INT8_RAGGED``; then the timed rows (``_int8_timing``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import VARIANTS, choose_variant, int8_matmul, takes

    def operands(M, K, N):
        x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        xs = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand((N,), generator=gen, device="cuda") * 0.01 + 1e-4
        return x, w, xs, ws

    B = 8
    M = 197 * B
    # M3ViT-S at a batch of 8; then OLMoE-1B-7B at a decode tick (8 slots)
    # and a 512-token packed prefill: q/k/v/o, the router gate, the LM head
    shapes = [(M, 384, 384), (M, 384, 1536), (M, 1536, 384), (M, 384, 16),
              (B, 384, 1000)]
    shapes += [(m, 2048, n) for m in (LM_SLOTS, LM_MAX_LEN) for n in (2048, 64, 50304)]
    checked = {v: 0 for v in VARIANTS}
    for M_, K, N in shapes + INT8_RAGGED:
        x, w, xs, ws = operands(M_, K, N)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for b in (None, bias):
            want = ref.int8_matmul_ref(x, w, xs, ws, b)
            for v in VARIANTS:
                if not takes(v, M_, K, N):
                    continue
                got = int8_matmul(x, w, xs, ws, b, variant=v)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"int8_matmul[{VARIANTS[v]}] {M_}x{K}x{N} bias={b is not None}: "
                        f"not bit-equal, max err {max_err(got, want)}")
                checked[v] += 1
    # an operand off the 16-byte grid takes variant 3, and variant 1 refuses it
    x, w, xs, ws = operands(64, 384, 384)
    x_off = torch.empty(64 * 384 + 1, dtype=torch.int8, device="cuda")[1:].view(64, 384)
    x_off.copy_(x)
    if not torch.equal(int8_matmul(x_off, w, xs, ws), ref.int8_matmul_ref(x, w, xs, ws)):
        raise AssertionError("int8_matmul on a misaligned x: not bit-equal")
    try:
        int8_matmul(x_off, w, xs, ws, variant=1)
    except ValueError:
        pass
    else:
        raise AssertionError("int8_matmul variant 1 took a misaligned x")
    picked = {v: sum(choose_variant(*shape) == v for shape in shapes + INT8_RAGGED)
              for v in VARIANTS}
    print(f"[kernels] int8_matmul bit-equal at {len(shapes) + len(INT8_RAGGED)} shapes "
          f"x 2 (bias): calls by variant {({VARIANTS[v]: n for v, n in checked.items()})}; "
          f"shapes the wrapper gives each {({VARIANTS[v]: n for v, n in picked.items()})}",
          flush=True)
    if min(picked.values()) == 0:
        raise AssertionError("the checked shapes do not reach every int8_matmul variant")

    def timing(label, M_, K, N, cold=False):
        return _int8_timing(label, operands(M_, K, N), cold)

    # dense fc1, the largest int8 call of the M3ViT-S forward
    row = timing("m3vit_fc1", M, 384, 1536)
    row.update(name="int8_matmul", max_abs_err=0.0, tolerance="bit-equal")
    row["more"] = [timing("m3vit_qkvo", M, 384, 384), timing("m3vit_head", B, 384, 1000)]
    row["olmoe"] = [timing(f"{site}_{phase}", m, 2048, n, cold=phase == "decode"
                           or site == "lm_head")
                    for phase, m in (("decode", LM_SLOTS), ("prefill", LM_MAX_LEN))
                    for site, n in (("qkvo", 2048), ("gate", 64), ("lm_head", 50304))]
    return row


def _int8_timing(label, operands, cold: bool) -> dict:
    """Time one int8_matmul shape: the variant the wrapper picks and the
    dp4a variant (the kernel this replaces) as device time per call
    (``graph_ms``), the wrapper's eager time per call, the plain version,
    and ``torch._int_mm`` (the int32 product alone; it takes M > 16 only, so
    for M <= 16 it gets x zero-padded to 32 rows, the padding made outside
    the timed calls). With ``cold``, the chosen and the dp4a variants also
    with the weight rotated over ``COLD_BYTES`` of buffers, so that L2 holds
    none of it when a call starts (as on the path, where each layer's
    weights arrive after the other layers')."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import VARIANTS, choose_variant, int8_matmul

    x, w, xs, ws = operands
    (M, K), N = x.shape, w.shape[1]
    v = choose_variant(M, K, N)
    nb, bound_by = bound_ms(M * K + K * N + 4 * N + 4 + 4 * M * N, 2.0 * M * N * K,
                            INT8_OPS_PER_S)
    x_lib = x
    if M <= 16:
        x_lib = torch.zeros((32, K), dtype=torch.int8, device="cuda")
        x_lib[:M] = x
    row = {
        "label": label, "shape": [M, K, N], "variant": VARIANTS[v],
        "ms": graph_ms(lambda: int8_matmul(x, w, xs, ws)),
        "dp4a_ms": graph_ms(lambda: int8_matmul(x, w, xs, ws, variant=3)),
        "eager_ms": time_ms(lambda: int8_matmul(x, w, xs, ws)),
        "plain_ms": time_ms(lambda: ref.int8_matmul_ref(x, w, xs, ws), iters=10),
        "bound_ms": nb, "bound_by": bound_by,
        "library_ms": graph_ms(lambda: torch._int_mm(x_lib, w)),
        "library_rows": x_lib.shape[0],
    }
    if cold:
        bufs = [w] + [torch.randint(-127, 128, (K, N), generator=torch.Generator(
            device="cuda").manual_seed(i), device="cuda", dtype=torch.int8)
            for i in range(max(1, math.ceil(COLD_BYTES / (K * N))))]
        for key, var in (("cold_ms", v), ("dp4a_cold_ms", 3)):
            it = iter(range(1 << 30))
            row[key] = graph_ms(lambda: int8_matmul(x, bufs[next(it) % len(bufs)], xs, ws,
                                                    variant=var), n=len(bufs), iters=5)
        del bufs
    print(f"[kernels] int8_matmul {label} {[M, K, N]}: {VARIANTS[v]} {row['ms']:.4f} ms"
          f" (cold {row.get('cold_ms', float('nan')):.4f}), dp4a {row['dp4a_ms']:.4f} ms "
          f"(cold {row.get('dp4a_cold_ms', float('nan')):.4f}), eager {row['eager_ms']:.4f}"
          f" ms, _int_mm ({row['library_rows']} rows) {row['library_ms']:.4f} ms, bound "
          f"{nb:.5f} ms ({bound_by})", flush=True)
    return row


def _routing(gen, T: int, G: int) -> torch.Tensor:
    """Group sizes of T rows over G experts, the last expert left empty."""
    ids = torch.randint(0, max(G - 1, 1), (T,), generator=gen, device="cuda")
    return torch.bincount(ids, minlength=G).to(torch.int32)


# ragged grouped shapes (T, G, Din, Dout, sizes or None for seeded
# routing): Din % 16 != 0 and odd Din (W4A8's pad nibble; dp4a only),
# Dout % 16 == 8 (8-byte weight copies), Dout % 8 != 0 (dp4a only), one
# group holding every row, groups that span several 64-row tiles with
# empty groups between them, more than 16 rows a group at stream's
# threshold, a single group, and T = 0
GROUPED_RAGGED = [
    (40, 4, 100, 64, None), (31, 4, 65, 24, None), (33, 5, 48, 40, None),
    (70, 3, 64, 10, None), (130, 4, 128, 64, [0, 130, 0, 0]),
    (300, 6, 256, 136, [0, 90, 0, 140, 70, 0]), (48, 24, 64, 64, [40] + [0] * 22 + [8]),
    (16, 1, 32, 16, [16]), (0, 8, 64, 64, [0] * 8),
]


def _grouped_operands(gen, T, G, Din, Dout, packed, sizes=None):
    """int8 x, an int8 or nibble-packed stack, per-expert scales, a_scale
    and group sizes (seeded routing unless given)."""
    from repro_torch.core.quant.qtypes import pack_int4

    sizes = (_routing(gen, T, G) if sizes is None
             else torch.tensor(sizes, dtype=torch.int32, device="cuda"))
    x = torch.randint(-128, 128, (T, Din), generator=gen, device="cuda", dtype=torch.int8)
    if packed:
        w = pack_int4(torch.randint(-8, 8, (G, Din, Dout), generator=gen, device="cuda",
                                    dtype=torch.int8))
    else:
        w = torch.randint(-127, 128, (G, Din, Dout), generator=gen, device="cuda",
                          dtype=torch.int8)
    ws = torch.rand((G, Dout), generator=gen, device="cuda") * 0.01 + 1e-4
    a_s = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
    return x, w, sizes, ws, a_s


def _check_grouped_variants(x, w, sizes, ws, a_s, checked: dict) -> None:
    """Every variant that takes the widths, bit-equal to the plain version
    (with and without the scales); counts the calls in ``checked``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import VARIANTS, grouped_matmul, takes

    T, Din = x.shape
    packed = w.dtype == torch.uint8
    plain = ref.grouped_matmul_q4_ref if packed else ref.grouped_matmul_q_ref
    ones = torch.ones_like(ws)
    for w_scale, a_scale in ((ws, a_s), (None, None)):
        want = plain(x, w, sizes, ones if w_scale is None else w_scale, a_scale)
        for v in VARIANTS:
            if not takes(v, Din, w.shape[2]):
                continue
            got = grouped_matmul(x, w, sizes, w_scale=w_scale, a_scale=a_scale, variant=v)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"grouped {'W4A8' if packed else 'int8'}[{VARIANTS[v]}] T={T} "
                    f"G={w.shape[0]} {Din}->{w.shape[2]} scales={w_scale is not None}: not "
                    f"bit-equal, max err {max_err(got, want)}")
            checked[VARIANTS[v]] = checked.get(VARIANTS[v], 0) + 1


def _check_grouped_matmul(gen) -> list:
    """The int8 mode in every variant, bit-equal, at the M3ViT-S expert
    shapes, the OLMoE-1B-7B decode / prefill shapes and ``GROUPED_RAGGED``;
    the f32 mode at the M3ViT-S and OLMoE calibration shapes; then the
    timed rows (``_grouped_timing``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import grouped_matmul

    B, G = 8, 16
    T = 2 * 197 * B  # top-2 routed rows of a batch of 8
    checked: dict = {}
    rows = {}
    for Din, Dout in ((384, 1536), (1536, 384)):
        x, w, sizes, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, False)
        _check_grouped_variants(x, w, sizes, ws, a_s, checked)
        xf = torch.randn((T, Din), generator=gen, device="cuda")
        wf = torch.randn((G, Din, Dout), generator=gen, device="cuda") / math.sqrt(Din)
        gotf, wantf = grouped_matmul(xf, wf, sizes), ref.grouped_matmul_ref(xf, wf, sizes)
        torch.cuda.synchronize()
        torch.testing.assert_close(gotf, wantf, atol=1e-5, rtol=1e-5)
        rows[Din] = (x, w, sizes, ws, a_s, xf, wf, max_err(gotf, wantf))
    for T_, G_, Din, Dout, sz in GROUPED_RAGGED:
        _check_grouped_variants(*_grouped_operands(gen, T_, G_, Din, Dout, False, sz),
                                checked)

    x, w, sizes, ws, a_s, xf, wf, f32_err = rows[384]  # expert fc1
    int8_row = {"name": "grouped_matmul", "mode": "int8", "max_abs_err": 0.0,
                "tolerance": "bit-equal", "library_ms": None,
                **_grouped_timing("m3vit_fc1", x, w, sizes, ws, a_s), "olmoe": []}
    f32_row = {"name": "grouped_matmul_f32", "mode": "f32 (not redesigned, calibration only)",
               "max_abs_err": f32_err, "tolerance": "atol=1e-5, rtol=1e-5",
               "library_ms": None, **_grouped_timing("m3vit_fc1", xf, wf, sizes), "olmoe": []}

    # OLMoE-1B-7B, 64 experts, fc1 (2048 -> 2 x 1024) and fc2 (1024 ->
    # 2048), fc1 timed: int8 at a decode tick (8 slots x top-8 = 64 routed
    # rows) and a 512-token packed prefill (4096 rows), f32 at a calibration
    # forward (2 x 32 tokens x top-8 = 512 rows)
    G = 64
    for T, label in ((LM_SLOTS * 8, "decode"), (LM_MAX_LEN * 8, "prefill"),
                     (2 * 32 * 8, "calibration")):
        for Din, Dout in ((2048, 2048), (1024, 2048)):
            if label == "calibration":
                sizes = _routing(gen, T, G)
                xf = torch.randn((T, Din), generator=gen, device="cuda")
                wf = torch.randn((G, Din, Dout), generator=gen, device="cuda") / math.sqrt(Din)
                gotf, wantf = grouped_matmul(xf, wf, sizes), ref.grouped_matmul_ref(xf, wf, sizes)
                torch.cuda.synchronize()
                torch.testing.assert_close(gotf, wantf, atol=1e-5, rtol=1e-5)
                f32_row["max_abs_err"] = max(f32_row["max_abs_err"], max_err(gotf, wantf))
                if Din == 2048:
                    f32_row["olmoe"].append(_grouped_timing(f"{label}_fc1", xf, wf, sizes))
                continue
            x, w, sizes, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, False)
            _check_grouped_variants(x, w, sizes, ws, a_s, checked)
            if Din == 2048:
                int8_row["olmoe"].append(_grouped_timing(
                    f"{label}_fc1", x, w, sizes, ws, a_s, cold=label == "decode"))
            del x, w
    empty = grouped_matmul(torch.zeros((0, 384), dtype=torch.int8, device="cuda"),
                           rows[384][1], torch.zeros(16, dtype=torch.int32, device="cuda"),
                           w_scale=rows[384][3], a_scale=rows[384][4])
    assert empty.shape == (0, 1536)
    print(f"[kernels] grouped int8 bit-equal, calls by variant {checked} (the path's "
          f"shapes and {len(GROUPED_RAGGED)} ragged ones, with and without scales)",
          flush=True)
    int8_row["checked"] = checked
    return [int8_row, f32_row]


def _grouped_timing(label, x, w, sizes, ws=None, a_s=None, cold=False) -> dict:
    """Time one grouped matmul (int8, W4A8 or f32 by the operands) and its
    plain version, and bound it: each input read once (the weights of the
    experts that got rows only), the output written once, 2 T Din Dout
    operations at the int8 or f32 rate. Device time per call by
    ``graph_ms``; the integer modes in the variant the wrapper picks and in
    the dp4a variant (the kernel this replaces), and with ``cold`` also
    with the expert stack rotated over at least ``COLD_BYTES`` of buffers,
    so that L2 holds none of it when a call starts (as on the path, where
    each layer's experts arrive after the other layers')."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import VARIANTS, choose_variant, grouped_matmul

    T, Din = x.shape
    G, w_rows, Dout = w.shape
    g_active = int((sizes > 0).sum())
    row = {"label": label, "shape": [T, G, Din, Dout]}
    if x.dtype == torch.int8:
        plain = ref.grouped_matmul_q4_ref if w.dtype == torch.uint8 else ref.grouped_matmul_q_ref
        nb, by = bound_ms(T * Din + g_active * w_rows * Dout + 4 * G * Dout + 4
                          + 4 * T * Dout, 2.0 * T * Din * Dout, INT8_OPS_PER_S)
        v = choose_variant(T, G, Din, Dout)
        fn = lambda wt=w, var=None: grouped_matmul(  # noqa: E731
            x, wt, sizes, w_scale=ws, a_scale=a_s, variant=var)
        row.update(variant=VARIANTS[v], ms=graph_ms(fn), dp4a_ms=graph_ms(lambda: fn(var=3)),
                   eager_ms=time_ms(fn))
        for var in (v, 3):
            _one_device_kernel(f"grouped {label} {VARIANTS[var]}", lambda: fn(var=var))
        plain_fn = lambda: plain(x, w, sizes, ws, a_s)  # noqa: E731
        if cold:
            n = max(2, math.ceil(COLD_BYTES / w.numel()))
            bufs = [w] + [w.roll(i, dims=0) for i in range(1, n)]
            for key, var in (("cold_ms", v), ("dp4a_cold_ms", 3)):
                it = iter(range(1 << 30))
                row[key] = graph_ms(lambda: fn(bufs[next(it) % n], var), n=2 * n, iters=5)
            del bufs
    else:
        nb, by = bound_ms(4 * (T * Din + g_active * Din * Dout + T * Dout),
                          2.0 * T * Din * Dout, F32_OPS_PER_S)
        fn = lambda: grouped_matmul(x, w, sizes)  # noqa: E731
        plain_fn = lambda: ref.grouped_matmul_ref(x, w, sizes)  # noqa: E731
        row.update(variant="f32", ms=graph_ms(fn), eager_ms=time_ms(fn))
        _one_device_kernel(f"grouped {label} f32", fn)
    row.update(plain_ms=time_ms(plain_fn, iters=10), bound_ms=nb, bound_by=by)
    print(f"[kernels] grouped {'W4A8' if w.dtype == torch.uint8 else x.dtype} {label} "
          f"{row['shape']}: {row['variant']} {row['ms']:.4f} ms (cold "
          f"{row.get('cold_ms', float('nan')):.4f}), dp4a {row.get('dp4a_ms', float('nan')):.4f}"
          f" ms (cold {row.get('dp4a_cold_ms', float('nan')):.4f}), eager "
          f"{row['eager_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound {nb:.5f} ms ({by})",
          flush=True)
    return row


def _check_grouped_w4a8(gen) -> dict:
    """W4A8 at the OLMoE-1B-7B expert fc1 shapes (2048 -> 2 x 1024, 64
    experts): a decode tick (8 slots x top-8 = 64 routed rows) and a full
    512-token packed prefill (4096 rows); fc2 (1024 -> 2048) and
    ``GROUPED_RAGGED`` checked too, every variant bit-equal to
    ``grouped_matmul_q4_ref``."""
    G = 64
    checked: dict = {}
    row = {"name": "grouped_matmul_w4a8", "max_abs_err": 0.0, "tolerance": "bit-equal",
           "library_ms": None}
    for T_, G_, Din, Dout, sz in GROUPED_RAGGED:
        _check_grouped_variants(*_grouped_operands(gen, T_, G_, Din, Dout, True, sz), checked)
    for T, label in ((8 * 8, ""), (512 * 8, "prefill_")):
        for Din, Dout in ((2048, 2048), (1024, 2048)):
            x, w, sizes, ws, a_s = _grouped_operands(gen, T, G, Din, Dout, True)
            _check_grouped_variants(x, w, sizes, ws, a_s, checked)
            if Din == 2048:  # fc1 is timed
                t = _grouped_timing(label or "decode", x, w, sizes, ws, a_s, cold=not label)
                row.update({label + k: v for k, v in t.items() if k != "label"})
    print(f"[kernels] grouped W4A8 bit-equal, calls by variant {checked}", flush=True)
    row["checked"] = checked
    return row


def _visible_pairs(B, Sq, Sk, causal, q_offset, valid, window, qseg, kseg) -> int:
    """(query, key) pairs a head must score: the mask of the plain version."""
    dev = "cuda"
    qpos = q_offset.to(dev)[:, None] + torch.arange(Sq, device=dev)
    kpos = torch.arange(Sk, device=dev)
    ok = (kpos[None, None, :] < valid.to(dev)[:, None, None]).expand(B, Sq, Sk)
    if causal:
        ok = ok & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        ok = ok & (qpos[:, :, None] - kpos[None, None, :] < window)
    if qseg is not None:
        ok = ok & (qseg[:, :, None] == kseg[:, None, :])
    return int(ok.sum())


# the generator seed of the LM attention rows (``_check_lm_attention``)
LM_ATTENTION_SEED = 0
# rows over 1e-4 with Gaussian q that the previous design of lm_attention.cu
# (one 32-query-row block a head, f32 FMAs from shared memory) gave on an
# H100 on the same inputs: the previous commit's chip_smoke.py run as
# ``_check_lm_attention(torch.Generator(device="cuda").manual_seed(
# LM_ATTENTION_SEED))``, which draws these two rows' inputs in the order
# kept here (0 of 8192 and 0 of 128; PERF.md names the run). A
# quant_bits > 0 row may have no more; the rows it did not run are absent
PARENT_GAUSSIAN_OVER = {"packed_prefill": 0, "decode_int8": 0}
GAUSSIAN_QB0_TOL = 1e-4  # atol = rtol for the quant_bits=0 rows with Gaussian q


def _device_work(fn) -> int:
    """Device kernels, memsets and copies one call of ``fn`` enqueues: the
    nodes of a CUDA graph that captures the call (after a warm-up call),
    counted by the CUDA driver API's ``cuGraphGetNodes``."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    nodes = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return nodes.value


def _one_device_kernel(label: str, fn) -> int:
    """Gate: one call of a wrapper is exactly one device kernel (no fill,
    cast, memset or work-table launch beside it)."""
    n = _device_work(fn)
    if n != 1:
        raise AssertionError(f"{label}: {n} device kernels, memsets or copies a call, "
                             "expected 1")
    return n


def _lm_attention_row(name, mode, q, k, v, kw, tol, sdpa=None, gaussian=None) -> dict:
    """Check one LM attention mode against the plain version on inputs
    whose scores are exact in f32 (``tol``), and with Gaussian q
    (``gaussian``): a ``quant_bits=0`` row is gated at ``GAUSSIAN_QB0_TOL``
    (against the plain version on f32 copies of bf16 K/V, which computes
    what the kernel does: the plain version rounds P to bf16 for bf16 V);
    a ``quant_bits > 0`` row counts its rows over 1e-4 (a score on a .5
    code boundary may round the other way when the dot products run in
    another order), gated at the previous design's count where
    ``PARENT_GAUSSIAN_OVER`` has one. Where the decode schedule takes the
    shape, the tile schedule (``schedule=1``) is held against the plain
    version too, and must equal the decode schedule bit for bit, on both
    inputs: the two run one arithmetic, so a served decode step computes
    what a prefill computes for its row. Gate: one device kernel a call. Time the kernel (device time per call,
    ``graph_ms``, and eager), the plain version and, for ``quant_bits=0``,
    SDPA (``sdpa``, graph and eager), and bound it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_attention import SCHEDULES, choose_schedule, lm_attention

    got, want = lm_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = tol
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    err = max_err(got, want)
    qb = kw.get("quant_bits", 0)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    schedule = choose_schedule(Sq, Sk, H, KVH, hd, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v)))
    row = {}
    if schedule == 0:
        tile = lm_attention(q, k, v, schedule=1, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(tile, want, atol=atol, rtol=rtol)
        row["tile_max_abs_err"] = max_err(tile, want)
        if not torch.equal(tile, got):
            raise AssertionError(f"lm_attention[{name}]: the tile schedule is not bit-equal "
                                 f"to the decode schedule, max diff {max_err(tile, got)}")
    if gaussian is not None:
        kp, vp = (k.float(), v.float()) if k.dtype == torch.bfloat16 else (k, v)
        g_got, g_want = lm_attention(gaussian, k, v, **kw), ref.flash_attention_ref(
            gaussian, kp, vp, **kw)
        torch.cuda.synchronize()
        diff = (g_got - g_want).abs().amax(-1)
        over = int((diff > 1e-4).sum())
        parent = PARENT_GAUSSIAN_OVER.get(name)
        row.update(gaussian_max_abs_err=float(diff.max()), gaussian_rows_over=over,
                   gaussian_rows=diff.numel(), parent_rows_over=parent)
        gate = (f"; gate atol = rtol = {GAUSSIAN_QB0_TOL}" if qb == 0 else
                f", gate <= {parent}" if parent is not None else ", not gated")
        print(f"[kernels] lm_attention[{name}], Gaussian q: max err {float(diff.max()):.3g}, "
              f"rows over 1e-4: {over} of {diff.numel()} (previous design: "
              f"{'not run' if parent is None else parent}){gate}", flush=True)
        if qb == 0:
            torch.testing.assert_close(g_got, g_want, atol=GAUSSIAN_QB0_TOL,
                                       rtol=GAUSSIAN_QB0_TOL)
        elif parent is not None and over > parent:
            raise AssertionError(f"lm_attention[{name}]: {over} rows over 1e-4 with "
                                 f"Gaussian q, the previous design {parent}")
        if schedule == 0:
            g_tile = lm_attention(gaussian, k, v, schedule=1, **kw)
            torch.cuda.synchronize()
            same = torch.equal(g_tile, g_got)
            print(f"[kernels] lm_attention[{name}], Gaussian q: tile schedule bit-equal to "
                  f"the decode schedule: {same} (gate; max diff {max_err(g_tile, g_got):.3g})",
                  flush=True)
            if not same:
                raise AssertionError(f"lm_attention[{name}]: with Gaussian q the tile "
                                     "schedule is not bit-equal to the decode schedule")
    off = kw.get("q_offset", 0)
    off = off if isinstance(off, torch.Tensor) else torch.full((B,), off, device="cuda")
    valid = kw.get("kv_valid_len")
    valid = valid if valid is not None else torch.full((B,), Sk, device="cuda")
    qseg = kw.get("q_segment_ids")
    kseg = kw.get("kv_segment_ids", qseg)
    pairs = _visible_pairs(B, Sq, Sk, kw.get("causal", True), off, valid,
                           kw.get("local_window", 0), qseg, kseg)
    live_keys = int(torch.clamp(valid, max=Sk).sum())
    n_bytes = (8 * B * Sq * H * hd + 2 * live_keys * KVH * hd * k.element_size()
               + (8 * live_keys * KVH if "k_scale" in kw else 0)
               + (4 * B * (Sq + Sk) if qseg is not None else 0) + 8 * B)
    nb, by = bound_ms(n_bytes, 4.0 * pairs * (H // KVH) * KVH * hd, F32_OPS_PER_S)
    kernel = lambda: lm_attention(q, k, v, **kw)  # noqa: E731
    row.update({
        "name": f"lm_attention[{name}]", "mode": mode, "shape": [B, Sq, Sk, H, KVH, hd],
        "schedule": SCHEDULES[schedule],
        "quant_bits": qb, "kv_dtype": str(k.dtype).removeprefix("torch."),
        "max_abs_err": err, "tolerance": f"atol={atol}, rtol={rtol}",
        "device_kernels": _one_device_kernel(f"lm_attention[{name}]", kernel),
        "ms": graph_ms(kernel), "eager_ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=5),
        "bound_ms": nb, "bound_by": by,
        "library_ms": None if sdpa is None else graph_ms(sdpa),
        "library_eager_ms": None if sdpa is None else time_ms(sdpa),
    })
    if schedule == 0:
        row["tile_ms"] = graph_ms(lambda: lm_attention(q, k, v, schedule=1, **kw))
    lib = "" if sdpa is None else (f", SDPA {row['library_ms']:.4f} ms (eager "
                                   f"{row['library_eager_ms']:.4f})")
    tile = "" if schedule else f", tile schedule {row['tile_ms']:.4f} ms"
    print(f"[kernels] lm_attention[{name}] {row['shape']} {mode}: {row['schedule']} "
          f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}){lib}{tile}, plain "
          f"{row['plain_ms']:.3f} ms, bound {nb:.5f} ms ({by}), max err {err:.3g}",
          flush=True)
    return row


def _check_lm_attention(gen) -> list:
    """Every LM mode at the OLMoE-1B-7B shapes (16 heads of 128): the
    calibration forward, a 512-token packed prefill over int8 K/V with four
    segments and a pad tail, a decode tick of 8 slots over the int8 cache,
    a decode tick over a bf16 cache; the window / softcap options at a
    small shape; GQA; zamba2-7b's head dim of 112; a head dim of 100 (rows
    that are not whole 16-byte chunks, staged by plain loads, and padded
    dims). q (and fp k) lie on a 1/4 grid and int8 k is integral, so the
    scores are exact in f32 and the codes equal the plain version's.
    ``gen`` draws every input in the previous design's order (so the
    packed-prefill and decode rows meet the inputs ``PARENT_GAUSSIAN_OVER``
    was read on); the Gaussian q of the rows that run had none come from a
    second generator."""
    from repro_torch.models.layers import quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    grid = lambda *shape: torch.randint(-3, 4, shape, generator=gen,  # noqa: E731
                                        device="cuda").float() * 0.25
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    extra = torch.Generator(device="cuda").manual_seed(LM_ATTENTION_SEED + 1)
    gauss = lambda *shape: torch.randn(shape, generator=extra, device="cuda")  # noqa: E731
    H, hd, rows = 16, 128, []
    f32_tol, bf16_tol = (1e-5, 1e-5), (5e-3, 0.0)

    # calibration: causal, f32, online softmax (2 x 32 tokens)
    q, k, v = grid(2, 32, H, hd), grid(2, 32, H, hd), randn(2, 32, H, hd)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    rows.append(_lm_attention_row(
        "calibration", "causal/float32/qb0", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(2, 32, H, hd)))

    # packed prefill: 4 prompts + pad tail in one 512 row, int8 K/V, 4-bit
    P = 512
    seg = torch.full((1, P), -1, dtype=torch.int32, device="cuda")
    cursor = 0
    for i, n in enumerate((200, 150, 100, 50)):
        seg[0, cursor:cursor + n] = i
        cursor += n
    k8, ks = quantize_kv(randn(1, P, H, hd))
    v8, vs = quantize_kv(randn(1, P, H, hd))
    kw = dict(causal=True, quant_bits=4, k_scale=ks, v_scale=vs,
              kv_valid_len=torch.full((1,), P, dtype=torch.int32, device="cuda"),
              q_segment_ids=seg, kv_segment_ids=seg)
    rows.append(_lm_attention_row("packed_prefill", "causal/int8/qb4/segments",
                                  grid(1, P, H, hd), k8, v8, kw, f32_tol,
                                  gaussian=randn(1, P, H, hd)))

    # decode tick: 8 slots at their own fill levels over the int8 cache
    off = torch.tensor([511, 300, 17, 0, 128, 64, 255, 400], dtype=torch.int32,
                       device="cuda")
    k8, ks = quantize_kv(randn(8, LM_MAX_LEN, H, hd))
    v8, vs = quantize_kv(randn(8, LM_MAX_LEN, H, hd))
    kw = dict(causal=True, q_offset=off, quant_bits=4, k_scale=ks, v_scale=vs,
              kv_valid_len=off + 1)
    rows.append(_lm_attention_row("decode_int8", "causal/int8/qb4/decode",
                                  grid(8, 1, H, hd), k8, v8, kw, f32_tol,
                                  gaussian=randn(8, 1, H, hd)))

    # decode tick over a bf16 cache (the fp tree's serving cache), online
    # softmax: the plain version rounds P to bf16 before P.V, the kernel
    # keeps it f32 (as the Pallas kernel does), hence the bf16 tolerance
    q = grid(8, 1, H, hd)
    kb, vb = grid(8, LM_MAX_LEN, H, hd).bfloat16(), randn(8, LM_MAX_LEN, H, hd).bfloat16()
    mask = (torch.arange(LM_MAX_LEN, device="cuda")[None, :] < (off + 1)[:, None])
    kw = dict(causal=True, q_offset=off, quant_bits=0, kv_valid_len=off + 1)
    rows.append(_lm_attention_row(
        "decode_bf16", "causal/bfloat16/qb0/decode", q, kb, vb, kw, bf16_tol,
        sdpa=lambda: sdpa(t(q.bfloat16()), t(kb), t(vb), attn_mask=mask[:, None, None, :]),
        gaussian=gauss(8, 1, H, hd)))

    # local window and logit softcap (not on the OLMoE path), hd = 64
    S, Hs, W = 64, 4, 16
    q, k, v = grid(2, S, Hs, 64), grid(2, S, Hs, 64), randn(2, S, Hs, 64)
    pos = torch.arange(S, device="cuda")
    wmask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    rows.append(_lm_attention_row(
        "window", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, local_window=W), f32_tol,
        sdpa=lambda: sdpa(t(q), t(k), t(v), attn_mask=wmask), gaussian=gauss(2, S, Hs, 64)))
    rows.append(_lm_attention_row(
        "window_qb4", "causal/float32/qb4", q, k, v,
        dict(causal=True, quant_bits=4, local_window=W), f32_tol,
        gaussian=gauss(2, S, Hs, 64)))
    rows.append(_lm_attention_row(  # no PyTorch call applies a tanh softcap
        "softcap", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, local_window=W, logit_softcap=30.0), f32_tol,
        gaussian=gauss(2, S, Hs, 64)))

    # GQA (not on the OLMoE path): a decode tick of 4 slots with 4 heads a
    # KV head (the decode schedule's most rows a block), and a causal f32
    # prefill with 4 heads a KV head
    off4 = off[:4]
    k8, ks = quantize_kv(randn(4, LM_MAX_LEN, 8, hd))
    v8, vs = quantize_kv(randn(4, LM_MAX_LEN, 8, hd))
    rows.append(_lm_attention_row(
        "decode_gqa", "causal/int8/qb4/decode/gqa", grid(4, 1, 32, hd), k8, v8,
        dict(causal=True, q_offset=off4, quant_bits=4, k_scale=ks, v_scale=vs,
             kv_valid_len=off4 + 1), f32_tol, gaussian=gauss(4, 1, 32, hd)))
    q, k, v = grid(1, 100, 8, hd), grid(1, 100, 2, hd), randn(1, 100, 2, hd)
    kg, vg = k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2)
    rows.append(_lm_attention_row(
        "prefill_gqa", "causal/float32/qb0/gqa", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(kg), t(vg), is_causal=True),
        gaussian=gauss(1, 100, 8, hd)))

    # zamba2-7b's attention (32 heads of 112, not a configuration the port
    # serves yet): a decode tick over an int8 cache and a 256-token prefill,
    # both on the tile schedule (the decode schedule holds hd = 128)
    Hz, hz = 32, 112
    k8, ks = quantize_kv(randn(8, LM_MAX_LEN, Hz, hz))
    v8, vs = quantize_kv(randn(8, LM_MAX_LEN, Hz, hz))
    rows.append(_lm_attention_row(
        "decode_hd112", "causal/int8/qb4/decode/hd112", grid(8, 1, Hz, hz), k8, v8,
        dict(causal=True, q_offset=off, quant_bits=4, k_scale=ks, v_scale=vs,
             kv_valid_len=off + 1), f32_tol, gaussian=gauss(8, 1, Hz, hz)))
    q, k, v = grid(1, 256, Hz, hz), grid(1, 256, Hz, hz), randn(1, 256, Hz, hz)
    rows.append(_lm_attention_row(
        "prefill_hd112", "causal/float32/qb0/hd112", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(1, 256, Hz, hz)))

    # hd = 100: int8 rows of 100 bytes (plain loads, 12 padded dims) and f32
    # rows of 400 bytes (cp.async, the last three chunks zero-filled)
    k8, ks = quantize_kv(randn(2, 80, 4, 100))
    v8, vs = quantize_kv(randn(2, 80, 4, 100))
    rows.append(_lm_attention_row(
        "prefill_hd100", "causal/int8/qb4/hd100", grid(2, 80, 4, 100), k8, v8,
        dict(causal=True, quant_bits=4, k_scale=ks, v_scale=vs), f32_tol,
        gaussian=gauss(2, 80, 4, 100)))
    q, k, v = grid(2, 80, 4, 100), grid(2, 80, 4, 100), randn(2, 80, 4, 100)
    rows.append(_lm_attention_row(
        "prefill_hd100_f32", "causal/float32/qb0/hd100", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True),
        gaussian=gauss(2, 80, 4, 100)))
    return rows


def _check_attention(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_attention import lm_attention, streaming_attention

    B, S, H, hd = 8, 197, 6, 64
    # Gate on inputs whose scores are exact in f32 whatever the summation
    # order (q, k on a 1/4 grid): the kernel's and the plain version's codes
    # then agree exactly and only exp and the P.V sums differ. With Gaussian
    # q, k the two score sums differ in the last bit, which can move a code
    # across a .5 rounding boundary; those are counted, not gated.
    grid = lambda: torch.randint(-3, 4, (B, S, H, hd), generator=gen,
                                 device="cuda").float() * 0.25
    q, k = grid(), grid()
    v = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    got = streaming_attention(q, k, v, quant_bits=4)
    want = ref.flash_attention_ref(q, k, v, causal=False, quant_bits=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = max_err(got, want)
    qn, kn = (torch.randn((B, S, H, hd), generator=gen, device="cuda") for _ in "qk")
    diff = (streaming_attention(qn, kn, v, quant_bits=4)
            - ref.flash_attention_ref(qn, kn, v, causal=False, quant_bits=4)).abs().amax(-1)
    print(f"[kernels] attention, Gaussian q/k: max err {float(diff.max()):.3g}, "
          f"rows over 1e-4: {int((diff > 1e-4).sum())} of {diff.numel()}", flush=True)
    # the LM kernel computes the same case: held to the same gate and timed
    # on the same inputs, to show whether the vision kernel earns its place
    lm = lm_attention(q, k, v, causal=False, quant_bits=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(lm, want, atol=1e-5, rtol=1e-5)
    n = B * S * H * hd
    nb, by = bound_ms(4 * 4 * n, 2.0 * 2 * B * H * S * S * hd, F32_OPS_PER_S)
    vision = lambda: streaming_attention(q, k, v, quant_bits=4)  # noqa: E731
    lm_fn = lambda: lm_attention(q, k, v, causal=False, quant_bits=4)  # noqa: E731
    row = {
        "name": "streaming_attention", "shape": [B, S, H, hd], "quant_bits": 4,
        "max_abs_err": err, "tolerance": "atol=1e-5, rtol=1e-5 (exact-score inputs)",
        "ms": graph_ms(vision), "eager_ms": time_ms(vision),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False,
                                                            quant_bits=4)),
        "bound_ms": nb, "bound_by": by, "library_ms": None,
        "lm_attention_ms": graph_ms(lm_fn), "lm_attention_eager_ms": time_ms(lm_fn),
        "lm_attention_max_abs_err": max_err(lm, want),
    }
    print(f"[kernels] vision attention {[B, S, H, hd]} qb4: streaming_attention "
          f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}), lm_attention on the same "
          f"inputs {row['lm_attention_ms']:.4f} ms (eager {row['lm_attention_eager_ms']:.4f}),"
          f" bound {nb:.5f} ms ({by})", flush=True)
    return row


def _check_selective_scan(gen) -> dict:
    """The scan at the falcon-mamba-7b prefill shapes (d_inner 8192, state
    16): one prompt and a group of 8 of 256 tokens, and a ragged S = 200;
    then state 8 (the smoke config's) at [2, 100, 256, 8].
    dt as the model makes it (softplus), A as Mamba initializes it
    (-(n + 1)). Only the order of the 16-term sum in y differs from the
    plain version; h_last is reported bit-equal or not."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan

    di, N = 8192, 16
    tol = dict(atol=1e-5, rtol=1e-5)
    a = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).expand(di, N).contiguous()
    d = torch.randn((di,), generator=gen, device="cuda")
    row = {"name": "selective_scan", "max_abs_err": 0.0, "h_bit_equal": [],
           "tolerance": "atol=1e-5, rtol=1e-5", "library_ms": None, "timings": []}
    for B, S in ((1, 256), (8, 200), (8, 256)):
        x = torch.randn((B, S, di), generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(torch.randn((B, S, di), generator=gen, device="cuda"))
        b, c = (torch.randn((B, S, N), generator=gen, device="cuda") for _ in "bc")
        (y, h), (yr, hr) = selective_scan(x, dt, b, c, a, d), ref.selective_scan_ref(
            x, dt, b, c, a, d)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, yr, **tol)
        torch.testing.assert_close(h, hr, **tol)
        row["max_abs_err"] = max(row["max_abs_err"], max_err(y, yr), max_err(h, hr))
        row["h_bit_equal"].append(torch.equal(h, hr))
        if S == 200:
            continue
        nb, by = bound_ms(4 * (3 * B * S * di + 2 * B * S * N + di * N + di + B * di * N),
                          7.0 * B * S * di * N, F32_OPS_PER_S)
        t = {"label": f"prefill_{B}x{S}", "shape": [B, S, di, N],
             "ms": time_ms(lambda: selective_scan(x, dt, b, c, a, d)),
             "plain_ms": time_ms(lambda: ref.selective_scan_ref(x, dt, b, c, a, d), iters=3),
             "bound_ms": nb, "bound_by": by}
        row["timings"].append(t)
    # the other state size the kernel is built for, at the smoke config's
    # d_inner and a ragged S
    B, S, di8, N8 = 2, 100, 256, 8
    x, dt = (torch.randn((B, S, di8), generator=gen, device="cuda") for _ in "xt")
    dt = torch.nn.functional.softplus(dt)
    b, c = (torch.randn((B, S, N8), generator=gen, device="cuda") for _ in "bc")
    a8 = -torch.arange(1, N8 + 1, device="cuda", dtype=torch.float32).expand(di8, N8).contiguous()
    d8 = torch.randn((di8,), generator=gen, device="cuda")
    (y, h), (yr, hr) = (selective_scan(x, dt, b, c, a8, d8),
                        ref.selective_scan_ref(x, dt, b, c, a8, d8))
    torch.testing.assert_close(y, yr, **tol)
    torch.testing.assert_close(h, hr, **tol)
    row["max_abs_err"] = max(row["max_abs_err"], max_err(y, yr), max_err(h, hr))
    row["h_bit_equal"].append(torch.equal(h, hr))
    row.update({k: row["timings"][-1][k] for k in
                ("shape", "ms", "plain_ms", "bound_ms", "bound_by")})
    return row


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [_check_int8_matmul(gen), *_check_grouped_matmul(gen), _check_attention(gen),
            _check_grouped_w4a8(gen),
            *_check_lm_attention(torch.Generator(device="cuda").manual_seed(LM_ATTENTION_SEED)),
            _check_selective_scan(gen)]
    for row in rows:
        row["route"] = "cuda"
        base = row["name"].split("[")[0].removesuffix("_f32").removesuffix("_w4a8")
        row["source"], row["replaces"] = SOURCES[base], REPLACES[base]
        emit({"kernel": row})
    return rows


def _counters():
    from repro_torch.kernels.expert_linear import grouped_matmul
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.quant_attention import lm_attention, streaming_attention
    from repro_torch.kernels.selective_scan import selective_scan

    return {"int8_matmul": int8_matmul, "grouped_matmul": grouped_matmul,
            "streaming_attention": streaming_attention, "lm_attention": lm_attention,
            "selective_scan": selective_scan}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode = {}


def _read_counts() -> dict:
    """Launch counts per wrapper, and per mode as ``"<wrapper>:<mode>"``."""
    torch.cuda.synchronize()
    out = {}
    for name, fn in _counters().items():
        out[name] = fn.launches
        for mode, n in getattr(fn, "launches_by_mode", {}).items():
            out[f"{name}:{mode}"] = n
    return out


def _check_int8_variants(tag: str, counts: dict) -> None:
    """Every int8_matmul call of a serving run went through variant 1 (mma)
    or 2 (stream), read from the wrapper's per-variant counters."""
    fast = counts.get("int8_matmul:mma", 0) + counts.get("int8_matmul:stream", 0)
    print(f"[{tag}] int8_matmul launches by variant: mma "
          f"{counts.get('int8_matmul:mma', 0)}, stream {counts.get('int8_matmul:stream', 0)}, "
          f"dp4a {counts.get('int8_matmul:dp4a', 0)} (gate: dp4a 0)", flush=True)
    if fast != counts["int8_matmul"] or counts.get("int8_matmul:dp4a", 0):
        raise AssertionError(f"[{tag}] int8_matmul calls off variants 1 and 2: {counts}")


def _check_grouped_variants_used(tag: str, counts: dict) -> None:
    """Every integer grouped_matmul call of a serving run went through
    variant 1 (mma) or 2 (stream), read from the wrapper's counters."""
    by = {v: sum(n for k, n in counts.items() if k.startswith("grouped_matmul:")
                 and k.endswith("/" + v)) for v in ("mma", "stream", "dp4a")}
    integer = counts.get("grouped_matmul:int8", 0) + counts.get("grouped_matmul:w4a8", 0)
    print(f"[{tag}] grouped_matmul integer launches by variant: {by} (gate: dp4a 0)",
          flush=True)
    if by["dp4a"] or by["mma"] + by["stream"] != integer:
        raise AssertionError(f"[{tag}] grouped calls off variants 1 and 2: {counts}")


def phase_serving(smi: str):
    from repro_torch.configs.moe_vit import CONFIG
    from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
    from repro_torch.models import init_model_params, synth_patches, tree_bytes
    from repro_torch.serving import VisionEngine, synth_requests

    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    calib = [torch.from_numpy(synth_patches(cfg, 2, seed=s)).cuda() for s in (1, 2)]
    _reset_counts()
    taps = calibrate_model(cfg, params, calib)
    calib_counts = _read_counts()
    qcfg = quantized_config(cfg)
    p_int8 = ptq_model(qcfg, params, taps, materialize="int8")
    torch.cuda.synchronize()
    print(f"[serving] {cfg.name}: fp {tree_bytes(params) / 1e6:.1f} MB -> int8 "
          f"{tree_bytes(p_int8) / 1e6:.1f} MB, init+calibrate+PTQ "
          f"{time.perf_counter() - t0:.1f} s, calibration launches {calib_counts}",
          flush=True)
    if calib_counts["grouped_matmul"] != 2 * PER_FORWARD["grouped_matmul"] \
            or calib_counts["streaming_attention"] != 2 * PER_FORWARD["streaming_attention"]:
        raise AssertionError(f"calibration launches {calib_counts}")
    del params

    eng = VisionEngine(qcfg, p_int8, batch_buckets=(1, 4, 8), max_wait_s=2e-3,
                       device="cuda")
    eng.warmup()
    reqs = synth_requests(qcfg, 24, seed=3)
    _reset_counts()
    for r in reqs:
        eng.submit(r)
        eng.step()
    eng.flush()
    counts = _read_counts()
    batches = eng.metrics.counters["batches"]
    for r in reqs:
        assert r.done and r.classes.shape == (5,), r.uid
        assert ((r.classes >= 0) & (r.classes < cfg.num_classes)).all(), r.uid
        assert np.isfinite(r.probs).all() and (np.diff(r.probs) <= 0).all(), r.uid
    for name, per in PER_FORWARD.items():
        if counts[name] != per * batches:
            raise AssertionError(f"{name}: {counts[name]} launches for {batches} "
                                 f"batches, expected {per} per forward")
    _check_int8_variants("serving", counts)
    _check_grouped_variants_used("serving", counts)
    snap = eng.metrics.snapshot()
    lat = snap["latency_ms"]
    print(f"[serving] smoke figure, not a benchmark: {snap['counters']['completed']} "
          f"requests in {batches} batches, {snap['fps']:.1f} FPS, p50 "
          f"{lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms ({smi}); launches {counts}",
          flush=True)
    return qcfg, p_int8, counts, calib_counts


def phase_lm(smi: str) -> dict:
    """Full-width OLMoE-1B-7B served from its int8 and W4A8 trees."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
    from repro_torch.models import init_model_params, synth_batch, tree_bytes
    from repro_torch.serving import serving_config

    cfg = serving_config(get_config("olmoe-1b-7b"))
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    calib = [torch.from_numpy(synth_batch(cfg, 2, 32, seed=s)).cuda() for s in (1, 2)]
    _reset_counts()
    taps = calibrate_model(cfg, params, calib)
    calib_counts = _read_counts()
    want = {"lm_attention:causal/float32/qb0": 2 * 16, "grouped_matmul:f32": 2 * 32,
            "int8_matmul": 0}
    if any(calib_counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"calibration launches {calib_counts}, expected {want}")
    qcfg = quantized_config(cfg)
    trees = {m: ptq_model(qcfg, params, taps, materialize=m) for m in ("int8", "int4")}
    fp_bytes = tree_bytes(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name}: fp {fp_bytes / 1e9:.2f} GB -> int8 "
          f"{tree_bytes(trees['int8']) / 1e9:.2f} GB, W4A8 "
          f"{tree_bytes(trees['int4']) / 1e9:.2f} GB; init+calibrate+PTQ "
          f"{time.perf_counter() - t0:.1f} s; calibration launches {calib_counts}",
          flush=True)
    _check_combine_invariance(qcfg)
    out = {"calib_counts": calib_counts, "runs": {}}
    for mat, tree in trees.items():
        out["runs"][mat] = _serve_lm(qcfg, tree, mat, smi)
    return out


def _check_combine_invariance(qcfg) -> None:
    """The expert combine adds a token's rows in the same order whatever
    the batch: 8 tokens combined alone give bit for bit what the same 8
    give among 512 (a decode tick against a packed prefill)."""
    from repro_torch.core.moe.dispatch import grouped_combine, grouped_dispatch

    g = torch.Generator(device="cuda").manual_seed(6)
    E, k, D = qcfg.moe.num_experts, qcfg.moe.top_k, qcfg.d_model
    x = torch.randn((LM_MAX_LEN, D), generator=g, device="cuda")
    experts = torch.argsort(torch.rand((LM_MAX_LEN, E), generator=g, device="cuda"),
                            dim=1)[:, :k].to(torch.int32)
    weights = torch.rand((LM_MAX_LEN, k), generator=g, device="cuda")

    def combine(n):
        d = grouped_dispatch(x[:n], experts[:n], weights[:n], E)
        return grouped_combine(d.x_sorted, d, n)

    few, many = combine(LM_SLOTS), combine(LM_MAX_LEN)[:LM_SLOTS]
    print(f"[lm] expert combine of {LM_SLOTS} tokens alone vs among {LM_MAX_LEN}: "
          f"bit-equal {torch.equal(few, many)} (gate)", flush=True)
    if not torch.equal(few, many):
        raise AssertionError("the expert combine depends on the batch size")


def _lm_requests(vocab: int):
    from repro_torch.serving import Request

    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=LM_NEW_TOKENS)
            for i, n in enumerate(rng.integers(16, 257, LM_REQUESTS))]


def _run_engine(qcfg, params, prompts=None):
    """Serve the seeded requests (or one request per prompt given) on a
    fresh engine; returns (engine, requests, wall seconds, launch counts)."""
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(qcfg, params, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      device="cuda", keep_logits=True)
    eng.warmup()
    reqs = (_lm_requests(qcfg.vocab_size) if prompts is None else
            [Request(uid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
             for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0, _read_counts()


def _teacher_forced(params, qcfg, r, steps):
    """Max |logit| error of request ``r``'s engine logits at ``steps``
    against ``prefill`` over the same prefix, and how many of those steps
    prefill's greedy token equals the engine's."""
    from repro_torch.models import transformer

    errs, agree = [], 0
    with torch.inference_mode():
        for t in steps:
            toks = list(map(int, r.prompt)) + r.generated[:t]
            ref = transformer.prefill(params, qcfg, torch.tensor([toks], device="cuda"))[0][0, -1]
            errs.append(float((r.step_logits[t] - ref).abs().max()))
            agree += int(int(torch.argmax(ref)) == r.generated[t])
    return np.asarray(errs), agree


def _serve_lm(qcfg, params, mat: str, smi: str) -> dict:
    from repro_torch.models.layers import rmsnorm

    eng, reqs, wall, counts = _run_engine(qcfg, params)
    snap = eng.metrics.snapshot()
    c = snap["counters"]
    forwards = c["prefill_batches"] + c["decode_ticks"]
    for name, per in LM_PER_FORWARD.items():
        if counts[name] != per * forwards:
            raise AssertionError(
                f"[lm {mat}] {name}: {counts[name]} launches for {c['prefill_batches']} "
                f"admissions + {c['decode_ticks']} ticks, expected {per} per forward")
    _check_int8_variants(f"lm {mat}", counts)
    _check_grouped_variants_used(f"lm {mat}", counts)
    grouped_mode = "w4a8" if mat == "int4" else "int8"
    if counts.get(f"grouped_matmul:{grouped_mode}") != counts["grouped_matmul"]:
        raise AssertionError(f"[lm {mat}] grouped launches by mode: {counts}")
    if counts["streaming_attention"] != 0:
        raise AssertionError("the LM path must not reach the vision attention kernel")
    for r in reqs:
        if r.status != "completed" or len(r.generated) != LM_NEW_TOKENS:
            raise AssertionError(f"[lm {mat}] request {r.uid}: {r.status}, "
                                 f"{len(r.generated)} tokens")
    tokens = sum(len(r.generated) for r in reqs)
    lat = snap["latency_ms"]
    print(f"[lm {mat}] smoke figure, not a benchmark ({smi}): {len(reqs)} requests, "
          f"{tokens} tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms; {c['prefill_batches']} "
          f"admissions ({c['pack_real_tokens']} real + {c['pack_pad_tokens']} pad tokens), "
          f"{c['decode_ticks']} ticks; launches {counts}", flush=True)

    # teacher-forced: the logits behind generated tokens against prefill
    # over the same prefix, for every request (so every admission and
    # every slot) at LM_TF_STEPS. The two do the same math in tensors of
    # other shapes (a pack of prompts at offsets, 8 slots a tick, against
    # one prompt); where that rounds a value in the last bit on the other
    # side of an int8 or 4-bit code boundary, the flip moves the logits and
    # routing amplifies it.
    tf = {r.uid: _teacher_forced(params, qcfg, r, LM_TF_STEPS) for r in reqs}
    errs = np.concatenate([e for e, _ in tf.values()])
    agree = sum(a for _, a in tf.values())
    hit = sorted(uid for uid, (e, _) in tf.items() if e.max() > 0)
    median, p90, far = LM_TF_LIMITS[mat]
    print(f"[lm {mat}] teacher-forced logits vs prefill, {len(reqs)} requests x steps "
          f"{list(LM_TF_STEPS)}: max err median {np.median(errs):.3g}, p90 "
          f"{np.quantile(errs, 0.9):.3g}, max {errs.max():.3g} (|logit| max "
          f"{max(float(x.abs().max()) for r in reqs for x in r.step_logits):.3g}); "
          f"requests with a nonzero error {hit}; greedy token agreement "
          f"{agree}/{errs.size}; gate: median <= {median}, p90 <= {p90}, "
          f"disagreeing tokens <= {far}", flush=True)
    if not (np.median(errs) <= median and np.quantile(errs, 0.9) <= p90
            and errs.size - agree <= far):
        raise AssertionError(f"[lm {mat}] teacher-forced logits disagree")
    # witnesses of the cause, printed, not gated: the request that strayed
    # most served alone (offset 0 of its admission, no other slot busy),
    # and one RMSNorm of the same rows in a tensor of 8 rows (a decode
    # tick) and of 512 rows (a prefill): torch's row reduction may sum a
    # row in another order when the tensor has more rows
    worst = max(reqs, key=lambda r: tf[r.uid][0].max())
    solo = _run_engine(qcfg, params, [worst.prompt])[1][0]
    solo_errs, _ = _teacher_forced(params, qcfg, solo, range(LM_NEW_TOKENS))
    off = np.flatnonzero(solo_errs)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((LM_MAX_LEN, qcfg.d_model), generator=g, device="cuda")
    gamma = torch.zeros(qcfg.d_model, device="cuda")
    few, many = rmsnorm(x[:LM_SLOTS], gamma), rmsnorm(x, gamma)[:LM_SLOTS]
    print(f"[lm {mat}] per request (prompt tokens, max err): "
          f"{ {r.uid: (len(r.prompt), round(float(tf[r.uid][0].max()), 4)) for r in reqs} }; "
          f"request {worst.uid} served alone: step-0 logits vs packed "
          f"{max_err(solo.step_logits[0], worst.step_logits[0]):.3g}, teacher-forced "
          f"max err over all {LM_NEW_TOKENS} steps {solo_errs.max():.3g}, first "
          f"nonzero at step {int(off[0]) if off.size else None}; RMSNorm of "
          f"{LM_SLOTS} rows alone vs in {LM_MAX_LEN}: {int((few != many).sum())} of "
          f"{few.numel()} values differ, max {max_err(few, many):.3g}", flush=True)
    # the same requests again on a fresh engine: serving is deterministic
    reqs2 = _run_engine(qcfg, params)[1]
    same = all(a.generated == b.generated and all(
        torch.equal(x, y) for x, y in zip(a.step_logits, b.step_logits))
        for a, b in zip(reqs, reqs2))
    print(f"[lm {mat}] served twice: tokens and logits bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError(f"[lm {mat}] serving is not deterministic")
    del reqs2
    profile = _profile_lm(eng, mat, smi)
    del eng
    torch.cuda.empty_cache()
    return {"counts": counts, "counters": c, "tok_s": tokens / wall, "latency_ms": lat,
            "tf_median": float(np.median(errs)), "tf_max": float(errs.max()),
            "tf_hit": hit,
            "profile": profile}


def _profile_lm(eng, mat: str, smi: str) -> dict:
    """Where one decode tick (8 slots at fill level 300) and one 512-token
    packed prefill spend their time."""
    from repro_torch.models import transformer

    cfg, p = eng.cfg, eng.params
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device="cuda")
    index = torch.full((LM_SLOTS,), 300, dtype=torch.int32, device="cuda")
    P = LM_MAX_LEN
    seg = torch.arange(P, device="cuda", dtype=torch.int32) // (P // 4)
    pos = torch.arange(P, device="cuda", dtype=torch.int32) % (P // 4)
    last = torch.arange(1, 5, device="cuda", dtype=torch.int32) * (P // 4) - 1
    out = {
        "decode tick": _profile(
            f"profile lm {mat}", "decode tick", smi, 3,
            lambda: transformer.decode_step(p, cfg, tok, eng.cache, index, with_stats=True),
            expect=LM_PER_FORWARD),
        "packed prefill 512": _profile(
            f"profile lm {mat}", "packed prefill 512", smi, 3,
            lambda: transformer.prefill_packed(p, cfg, tok.new_zeros((1, P)), pos, seg,
                                               last, max_len=P), expect=LM_PER_FORWARD),
    }
    for label, prof in out.items():
        _check_kernels_per_call(f"profile lm {mat} {label}", prof, LM_PER_FORWARD)
    return out


def _profile(tag: str, label: str, smi: str, n: int, fn, expect=None) -> dict:
    """Host wall time per call of ``fn`` with a synchronize, host time to
    enqueue alone, and the device time of every kernel it launched
    (torch.profiler, summed by kernel name; the top 8 printed), over ``n``
    calls after one warm-up call. ``expect`` (family -> launches a call):
    a trace that holds fewer kernels of a family than its wrapper launched
    is incomplete (a launch that returned success ran its kernel, so the
    profiler lost events, as it did for ~1% of a 512-token prefill's
    kernels in some runs on an H100) and is taken again,
    ``PROFILE_ATTEMPTS`` times at most; ``_check_kernels_per_call`` holds
    the last trace to exactly the launches, so a second kernel a call
    still fails."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            by_name: dict = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    us, calls = by_name.get(ev.name, (0.0, 0))
                    by_name[ev.name] = (us + ev.device_time, calls + 1)
            fam = {}
            for family, names in KERNEL_NAMES.items():
                hits = [(us, c) for name, (us, c) in by_name.items()
                        if any(k in name for k in names)]
                fam[family] = (sum(us for us, _ in hits) / n / 1e3, sum(c for _, c in hits) / n)
            short = {f: fam[f][1] for f, want in (expect or {}).items() if fam[f][1] < want}
            if not short:
                break
            print(f"[{tag}] {label}: trace {attempt} is incomplete ({short} kernels a call "
                  f"against {expect} launched); tracing again", flush=True)
    device_ms = sum(us for us, _ in by_name.values()) / n / 1e3
    kernels = sum(c for _, c in by_name.values()) / n
    print(f"[{tag}] {label} ({smi}): wall {wall * 1e3:.2f} ms, host enqueue "
          f"{enqueue * 1e3:.2f} ms, device kernels {device_ms:.2f} ms (busy share "
          f"{device_ms / (wall * 1e3):.2f}), {kernels:.0f} kernels; "
          + ", ".join(f"{f} {ms:.3f} ms in {k:.0f} kernels" for f, (ms, k) in fam.items()),
          flush=True)
    for kname, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}] {us / n / 1e3:8.3f} ms {calls // n:5d} x  {kname[:80]}", flush=True)
    return {"wall_ms": wall * 1e3, "enqueue_ms": enqueue * 1e3, "device_ms": device_ms,
            "kernels": kernels, "traces": attempt,
            **{f"{f}_ms": ms for f, (ms, _) in fam.items()},
            **{f"{f}_kernels": k for f, (_, k) in fam.items()}}


def _check_kernels_per_call(tag: str, profile: dict, per: dict) -> None:
    """One device kernel per call of each wrapper in ``per`` (launches per
    forward): no memset, no work-table or offset fill, no second pass."""
    for family, want in per.items():
        if profile[f"{family}_kernels"] != want:
            raise AssertionError(f"[{tag}] {profile[f'{family}_kernels']} {family} device "
                                 f"kernels per forward, expected {want}")
    print(f"[{tag}] one device kernel per call: {per} (gate)", flush=True)


def phase_ssm(smi: str) -> dict:
    """Full-width falcon-mamba-7b served through the grouped same-length
    admission path (see the module docstring, phase 8)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import init_model_params, ssm_lm, tree_bytes
    from repro_torch.serving import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 1.0:  # the OLMoE trees and engines must be gone
        raise AssertionError(f"[ssm] {left:.2f} GB of earlier phases still allocated")
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    params = init_model_params(cfg, seed=0, device="cuda")
    eng = ServeEngine(cfg, params, batch_slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device="cuda", keep_logits=True)
    eng.warmup()
    torch.cuda.synchronize()
    print(f"[ssm] {cfg.name}: {tree_bytes(params) / 1e9:.2f} GB f32 ({left:.2f} GB "
          f"of earlier phases left on the card); init + warmup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=SSM_NEW_TOKENS)
            for i, n in enumerate(rng.choice(SSM_PROMPT_LENS, SSM_REQUESTS))]
    c = eng.metrics.counters
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.active or eng.scheduler.depth:
        before, dispatches = selective_scan.launches, c.get("prefill_batches", 0)
        eng.step()
        steps += 1
        grew = selective_scan.launches - before
        if grew != SSM_LAYERS * (c.get("prefill_batches", 0) - dispatches):
            raise AssertionError(f"[ssm] step {steps}: {grew} scan launches for "
                                 f"{c.get('prefill_batches', 0) - dispatches} prefill "
                                 f"dispatches and one decode tick")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    others = {k: n for k, n in counts.items() if n and not k.startswith("selective_scan")}
    if counts["selective_scan"] != SSM_LAYERS * c["prefill_batches"] or others:
        raise AssertionError(f"[ssm] launches {counts} for {c['prefill_batches']} dispatches")
    for r in reqs:
        if r.status != "completed" or len(r.generated) != SSM_NEW_TOKENS:
            raise AssertionError(f"[ssm] request {r.uid}: {r.status}, "
                                 f"{len(r.generated)} tokens")
    snap = eng.metrics.snapshot()
    lat = snap["latency_ms"]
    tokens = sum(len(r.generated) for r in reqs)
    print(f"[ssm] smoke figure, not a benchmark ({smi}): {len(reqs)} requests, {tokens} "
          f"tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s; latency p50 "
          f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms; {c['prefill_batches']} grouped "
          f"prefill dispatches, {c['decode_ticks']} ticks; launches {counts} (gate: "
          f"{SSM_LAYERS} per dispatch, 0 per tick, checked at every step)", flush=True)

    rel, agree = _ssm_teacher_forced(params, cfg, reqs)
    print(f"[ssm] teacher-forced logits vs forward, {len(reqs)} requests x "
          f"{SSM_NEW_TOKENS} steps: relative max err median {np.median(rel):.3g}, p90 "
          f"{np.quantile(rel, 0.9):.3g}, max {rel.max():.3g}; by step (max over "
          f"requests) {[float(f'{v:.2g}') for v in rel.max(0)]}; greedy token agreement "
          f"{agree}/{rel.size}; gate: median <= {SSM_TF_LIMIT[0]}, max <= "
          f"{SSM_TF_LIMIT[1]}", flush=True)
    if not _ssm_tf_pass(rel):
        raise AssertionError("[ssm] teacher-forced logits disagree")
    controls = {name: _ssm_control(name, params, cfg, reqs[:SSM_SLOTS])
                for name in SSM_CONTROLS}

    tok = torch.zeros((SSM_SLOTS, 1), dtype=torch.int32, device="cuda")
    group = torch.zeros((SSM_SLOTS, SSM_PROMPT_LENS[-1]), dtype=torch.int32, device="cuda")
    profile = {
        "decode tick": _profile("profile ssm", "decode tick, 8 slots", smi, 3,
                                lambda: ssm_lm.decode_step(params, cfg, tok, eng.cache)),
        "grouped prefill": _profile("profile ssm", "grouped prefill, 8 x 256", smi, 2,
                                    lambda: ssm_lm.prefill(params, cfg, group)),
    }
    del eng, params
    torch.cuda.empty_cache()
    return {"counts": counts, "counters": dict(c), "tok_s": tokens / wall,
            "latency_ms": lat, "tf_max": float(rel.max()), "controls": controls,
            "profile": profile}


def _ssm_teacher_forced(params, cfg, reqs):
    """One forward over each request's prompt and generated tokens gives
    the logits behind every step. Returns (relative max error [requests,
    steps], the number of steps whose greedy token agrees)."""
    from repro_torch.models import forward

    rel, agree = [], 0
    with torch.inference_mode():
        for r in reqs:
            toks = torch.tensor([list(map(int, r.prompt)) + r.generated[:-1]], device="cuda")
            want = forward(params, cfg, toks)[0][0, len(r.prompt) - 1:]
            got = torch.stack(r.step_logits)
            rel.append(((got - want).abs().amax(-1) / want.abs().amax(-1)).cpu().numpy())
            agree += int((want.argmax(-1).cpu() == torch.tensor(r.generated)).sum())
    return np.stack(rel), agree


def _ssm_tf_pass(rel) -> bool:
    return bool(np.median(rel) <= SSM_TF_LIMIT[0] and rel.max() <= SSM_TF_LIMIT[1])


def _ssm_control(name: str, params, cfg, first) -> dict:
    """Serve the first admission wave again with one rounding fault (see
    ``SSM_CONTROLS``) and hold it against the f32 forward: the gate must
    fail it, or it could not see a fault of that size."""
    from repro_torch.models import ssm_lm
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device="cuda", keep_logits=True)
    if name == "bf16 conv history":
        eng.cache = ssm_lm.init_cache(cfg, SSM_SLOTS, SSM_MAX_LEN, device="cuda")
    reqs = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=SSM_NEW_TOKENS)
            for r in first]
    precision = torch.get_float32_matmul_precision()
    if name == "tf32 matmuls":
        torch.set_float32_matmul_precision("high")
    try:
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    finally:
        torch.set_float32_matmul_precision(precision)
    rel, agree = _ssm_teacher_forced(params, cfg, reqs)
    print(f"[ssm] control, {name}: {len(reqs)} requests x {SSM_NEW_TOKENS} steps, "
          f"relative max err median {np.median(rel):.3g}, max {rel.max():.3g}; greedy "
          f"token agreement {agree}/{rel.size} (must fail the gate)", flush=True)
    if _ssm_tf_pass(rel):
        raise AssertionError(f"[ssm] the teacher-forced gate passes the control {name!r}")
    return {"median": float(np.median(rel)), "max": float(rel.max()), "agree": agree}


def phase_e2e(qcfg, p_int8) -> None:
    """The int8 forward on the card against the same tree on the CPU (plain
    versions). Free-running, the two drift apart: a score or activation
    that the two paths round on different sides of a code boundary (4-bit
    attention codes, int8 activations) changes a weight or an LSB, a few of
    those change a token's top-2 experts, and twelve random-weight layers
    amplify that into O(1) logit differences. So the gate is teacher-forced:
    every block, and the head, gets the card's input on both sides."""
    from repro_torch.models import forward, synth_patches, vit
    from repro_torch.models.param import tree_to

    x = torch.from_numpy(synth_patches(qcfg, 4, seed=9))
    p_cpu = tree_to(p_int8, "cpu")
    with torch.inference_mode():
        free_card = forward(p_int8, qcfg, x.cuda())[0].cpu()
        free_cpu = forward(p_cpu, qcfg, x)[0]
        top1 = float((free_card.argmax(-1) == free_cpu.argmax(-1)).float().mean())
        print(f"[e2e] free-running int8 logits, card vs CPU: max err "
              f"{max_err(free_card, free_cpu):.3g} (|logit| max "
              f"{float(free_cpu.abs().max()):.3g}), top-1 agreement {top1:.2f} "
              "(not gated)", flush=True)
        h = vit.embed(p_int8, qcfg, x.cuda())
        torch.testing.assert_close(h.cpu(), vit.embed(p_cpu, qcfg, x),
                                   atol=1e-4, rtol=1e-5)
        for (scope, lp), (_, lp_cpu) in zip(vit.layers(p_int8, qcfg),
                                            vit.layers(p_cpu, qcfg)):
            out = vit.block(h, lp, qcfg)[0]
            tok_err = (out.cpu() - vit.block(h.cpu(), lp_cpu, qcfg)[0]).abs().amax(-1)
            median, far = float(tok_err.median()), float((tok_err > 5e-2).float().mean())
            print(f"[e2e] {scope}: per-token max err median {median:.3g}, "
                  f"max {float(tok_err.max()):.3g}, tokens over 5e-2 {far:.4f}",
                  flush=True)
            # a fault moves every token; boundary flips and the expert
            # swaps they cause move a few
            assert median <= 1e-3 and far <= 0.02, scope
            h = out
        logits = vit.head(p_int8, qcfg, h).cpu()
        ref_logits = vit.head(p_cpu, qcfg, h.cpu())
    print(f"[e2e] teacher-forced logits: max err {max_err(logits, ref_logits):.3g}",
          flush=True)
    torch.testing.assert_close(logits, ref_logits, atol=1e-3, rtol=0)


def phase_profile(qcfg, p_int8, smi: str) -> None:
    """Where one int8 forward at B=8 spends its time."""
    from repro_torch.models import classify, synth_patches

    x = torch.from_numpy(synth_patches(qcfg, 8, seed=4)).cuda()
    prof = _profile("profile", f"{qcfg.name} int8 forward, B=8", smi, 5,
                    lambda: classify(p_int8, qcfg, x), expect=PER_FORWARD)
    _check_kernels_per_call("profile", prof, PER_FORWARD)


def _launches(row: dict, vision: dict, vision_calib: dict, lm: dict, ssm: dict) -> int:
    """A row's launches on the main path: the vision serving run, and for
    the modes the LM runs, the two OLMoE serving runs (the fp32 grouped and
    calibration attention rows: the calibration forwards); the scan's, the
    falcon-mamba serving run."""
    runs = [r["counts"] for r in lm["runs"].values()]
    name = row["name"]
    if name == "selective_scan":
        return ssm["counts"]["selective_scan"]
    if name == "grouped_matmul_f32":
        return vision_calib["grouped_matmul"] + lm["calib_counts"]["grouped_matmul:f32"]
    if name == "grouped_matmul":
        return vision["grouped_matmul"] + sum(c.get("grouped_matmul:int8", 0) for c in runs)
    if name == "grouped_matmul_w4a8":
        return sum(c.get("grouped_matmul:w4a8", 0) for c in runs)
    if name == "lm_attention[calibration]":
        return lm["calib_counts"]["lm_attention:causal/float32/qb0"]
    if name.startswith("lm_attention["):
        return sum(c.get("lm_attention:" + row["mode"], 0) for c in runs)
    return vision[name] + sum(c.get(name, 0) for c in runs)


def main() -> None:
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    qcfg, p_int8, counts, calib_counts = phase_serving(smi)
    phase_e2e(qcfg, p_int8)
    phase_profile(qcfg, p_int8, smi)
    del p_int8
    torch.cuda.empty_cache()
    lm = phase_lm(smi)
    ssm = phase_ssm(smi)
    for row in rows:
        row["launches"] = _launches(row, counts, calib_counts, lm, ssm)
    for name in ("int8_matmul", "grouped_matmul", "grouped_matmul_w4a8",
                 "lm_attention[packed_prefill]", "lm_attention[decode_int8]",
                 "selective_scan"):
        row = next(r for r in rows if r["name"] == name)
        if row["launches"] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} | {"shape": row["shape"]}
                      | {k: row[k] for k in ("variant", "schedule") if k in row}
                      for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
