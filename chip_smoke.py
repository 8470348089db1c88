#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase's error is
caught:

  1. device   -- require CUDA, print the card's name and power limit;
  2. build    -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  -- hold each kernel against its plain PyTorch version at the
                 M3ViT-S shapes of a batch of 8 and time kernel, plain version
                 and (int8_matmul only) ``torch._int_mm``; ``int8_matmul`` and
                 the int8 and f32 grouped modes also at the OLMoE-1B-7B shapes
                 of a decode tick, a packed prefill and a calibration forward,
                 and ``lm_attention`` beside ``streaming_attention`` at the
                 M3ViT-S shape; then every LM mode of the attention kernel and
                 the grouped W4A8 mode at the OLMoE-1B-7B shapes
                 (``scaled_dot_product_attention`` timed beside each
                 ``quant_bits=0`` row);
  4. serving  -- full-width M3ViT-S (``configs/moe_vit.py:CONFIG``): seeded fp
                 init on the card, calibration on 2 batches of 2, PTQ to the
                 int8 tree, ``VisionEngine(buckets=(1, 4, 8))`` serving 24
                 requests; every kernel's launch count must grow by exactly
                 its per-forward count times the dispatched batches;
  5. e2e      -- one batch of 4 through ``forward`` on the card and on a CPU
                 copy of the same tree (plain versions): free-running logits
                 printed, then every block and the head teacher-forced from
                 the card's input and gated;
  6. profile  -- one int8 forward at B=8: wall and enqueue time, device time
                 of every kernel launched (torch.profiler);
  7. lm       -- full-width OLMoE-1B-7B (``configs/olmoe_1b_7b.py``): seeded
                 fp init on the card, calibration on 2 batches of 2 x 32
                 tokens, PTQ to the int8 tree and to the W4A8 tree (the fp
                 tree is then freed); each tree is served by
                 ``ServeEngine(batch_slots=8, max_len=512)``, 16 seeded
                 requests of 16-256 prompt tokens and 32 new tokens. Gates:
                 launches grow by exactly 81 / 32 / 16 (int8_matmul / grouped
                 / lm_attention) per packed admission and per decode tick;
                 every request completes; teacher-forced, the engine's logits
                 of every request at 9 of its 32 steps match ``prefill`` over
                 the same prefix within the stated limits; the same requests
                 served again give bit-equal tokens and logits; the expert
                 combine of 8 tokens equals theirs among 512. Printed, not
                 gated: the worst request served alone, and one RMSNorm of 8
                 rows alone against the same rows among 512. Then one decode
                 tick and one 512-token packed prefill are profiled.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and the line before that
holds the ``{"kernels": [...]}`` record. Times are CUDA-event times over
repeated launches with warm caches.
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
}
SOURCES = {
    "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
    "streaming_attention": "src/repro_torch/kernels/csrc/quant_attention.cu",
    "lm_attention": "src/repro_torch/kernels/csrc/lm_attention.cu",
}
# kernel launches per int8 forward of M3ViT-S: 6 dense layers x (q, k, v, o,
# fc1, fc2) + 6 MoE layers x (q, k, v, o, gate) + head; 6 MoE layers x (fc1,
# fc2); 12 attention layers
PER_FORWARD = {"int8_matmul": 67, "grouped_matmul": 12, "streaming_attention": 12}
# per OLMoE-1B-7B forward of the int8 / W4A8 trees (a packed admission or a
# decode tick): 16 layers x (q, k, v, o, gate) + lm_head; 16 x (fc1, fc2);
# 16 attention layers
LM_PER_FORWARD = {"int8_matmul": 81, "grouped_matmul": 32, "lm_attention": 16}
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW_TOKENS = 8, 512, 16, 32
# teacher-forced gate, per tree: every request at these steps (the first
# token from the packed prefill, then decode ticks); limits on the median
# and p90 of the per-step max |logit| error against prefill and on the
# number of steps (of 144) whose greedy token differs. The int8 tree read
# median 0.054, p90 0.144 and 5 such steps on an H100, with |logit| up to
# 4.6; the limits sit about 3x above. A fault (wrong slot, row, position
# or scale) moves nearly every step by the size of the logits.
LM_TF_STEPS = (0, 1, 2, 3, 5, 8, 13, 21, 31)
LM_TF_LIMITS = {"int8": (0.15, 0.4, 14), "int4": (0.15, 0.4, 14)}


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


def _check_int8_matmul(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import int8_matmul

    def operands(M, K, N):
        x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        xs = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand((N,), generator=gen, device="cuda") * 0.01 + 1e-4
        return x, w, xs, ws

    def timing(label, M_, K, N) -> dict:
        x, w, xs, ws = operands(M_, K, N)
        nb, bound_by = bound_ms(M_ * K + K * N + 4 * N + 4 + 4 * M_ * N,
                                2.0 * M_ * N * K, INT8_OPS_PER_S)
        return {
            "label": label, "shape": [M_, K, N],
            "ms": time_ms(lambda: int8_matmul(x, w, xs, ws)),
            "plain_ms": time_ms(lambda: ref.int8_matmul_ref(x, w, xs, ws), iters=10),
            "bound_ms": nb, "bound_by": bound_by,
            # torch._int_mm takes M > 16 only
            "library_ms": time_ms(lambda: torch._int_mm(x, w)) if M_ > 16 else None,
        }

    B = 8
    M = 197 * B
    # M3ViT-S at a batch of 8; then OLMoE-1B-7B at a decode tick (8 slots)
    # and a 512-token packed prefill: q/k/v/o, the router gate, the LM head
    shapes = [(M, 384, 384), (M, 384, 1536), (M, 1536, 384), (M, 384, 16),
              (B, 384, 1000)]
    shapes += [(m, 2048, n) for m in (LM_SLOTS, LM_MAX_LEN) for n in (2048, 64, 50304)]
    for M_, K, N in shapes:
        x, w, xs, ws = operands(M_, K, N)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for b in (None, bias):
            got, want = int8_matmul(x, w, xs, ws, b), ref.int8_matmul_ref(x, w, xs, ws, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"int8_matmul {M_}x{K}x{N} bias={b is not None}: "
                                     f"not bit-equal, max err {max_err(got, want)}")
    # dense fc1, the largest int8 call of the M3ViT-S forward
    row = timing("m3vit_fc1", M, 384, 1536)
    row.update(name="int8_matmul", max_abs_err=0.0, tolerance="bit-equal")
    row["olmoe"] = [timing(f"{site}_{phase}", m, 2048, n)
                    for phase, m in (("decode", LM_SLOTS), ("prefill", LM_MAX_LEN))
                    for site, n in (("qkvo", 2048), ("lm_head", 50304))]
    return row


def _routing(gen, T: int, G: int) -> torch.Tensor:
    """Group sizes of T rows over G experts, the last expert left empty."""
    ids = torch.randint(0, G - 1, (T,), generator=gen, device="cuda")
    return torch.bincount(ids, minlength=G).to(torch.int32)


def _check_grouped_matmul(gen) -> list:
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import grouped_matmul

    B, G = 8, 16
    T = 2 * 197 * B  # top-2 routed rows of a batch of 8
    sizes = _routing(gen, T, G)
    rows = {}
    for Din, Dout in ((384, 1536), (1536, 384)):
        x = torch.randint(-128, 128, (T, Din), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (G, Din, Dout), generator=gen, device="cuda",
                          dtype=torch.int8)
        ws = torch.rand((G, Dout), generator=gen, device="cuda") * 0.01 + 1e-4
        a_s = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
        got = grouped_matmul(x, w, sizes, w_scale=ws, a_scale=a_s)
        want = ref.grouped_matmul_q_ref(x, w, sizes, ws, a_s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"grouped int8 {Din}->{Dout}: not bit-equal, "
                                 f"max err {max_err(got, want)}")
        xf = torch.randn((T, Din), generator=gen, device="cuda")
        wf = torch.randn((G, Din, Dout), generator=gen, device="cuda") / math.sqrt(Din)
        gotf, wantf = grouped_matmul(xf, wf, sizes), ref.grouped_matmul_ref(xf, wf, sizes)
        torch.cuda.synchronize()
        torch.testing.assert_close(gotf, wantf, atol=1e-5, rtol=1e-5)
        rows[Din] = (x, w, ws, a_s, xf, wf, max_err(gotf, wantf))
    empty = grouped_matmul(torch.zeros((0, 384), dtype=torch.int8, device="cuda"),
                           rows[384][1], torch.zeros(G, dtype=torch.int32, device="cuda"),
                           w_scale=rows[384][2], a_scale=rows[384][3])
    assert empty.shape == (0, 1536)

    Din, Dout = 384, 1536  # expert fc1
    x, w, ws, a_s, xf, wf, f32_err = rows[Din]
    int8_row = {"name": "grouped_matmul", "mode": "int8", "max_abs_err": 0.0,
                "tolerance": "bit-equal", "library_ms": None,
                **_grouped_timing("m3vit_fc1", x, w, sizes, ws, a_s), "olmoe": []}
    f32_row = {"name": "grouped_matmul_f32", "mode": "f32", "max_abs_err": f32_err,
               "tolerance": "atol=1e-5, rtol=1e-5", "library_ms": None,
               **_grouped_timing("m3vit_fc1", xf, wf, sizes), "olmoe": []}

    # OLMoE-1B-7B, 64 experts, fc1 (2048 -> 2 x 1024) and fc2 (1024 ->
    # 2048), fc1 timed: int8 at a decode tick (8 slots x top-8 = 64 routed
    # rows) and a 512-token packed prefill (4096 rows), f32 at a calibration
    # forward (2 x 32 tokens x top-8 = 512 rows)
    G = 64
    for T, label in ((LM_SLOTS * 8, "decode"), (LM_MAX_LEN * 8, "prefill"),
                     (2 * 32 * 8, "calibration")):
        sizes = _routing(gen, T, G)
        for Din, Dout in ((2048, 2048), (1024, 2048)):
            if label == "calibration":
                xf = torch.randn((T, Din), generator=gen, device="cuda")
                wf = torch.randn((G, Din, Dout), generator=gen, device="cuda") / math.sqrt(Din)
                gotf, wantf = grouped_matmul(xf, wf, sizes), ref.grouped_matmul_ref(xf, wf, sizes)
                torch.cuda.synchronize()
                torch.testing.assert_close(gotf, wantf, atol=1e-5, rtol=1e-5)
                f32_row["max_abs_err"] = max(f32_row["max_abs_err"], max_err(gotf, wantf))
                if Din == 2048:
                    f32_row["olmoe"].append(_grouped_timing(f"{label}_fc1", xf, wf, sizes))
                continue
            x = torch.randint(-128, 128, (T, Din), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (G, Din, Dout), generator=gen, device="cuda",
                              dtype=torch.int8)
            ws = torch.rand((G, Dout), generator=gen, device="cuda") * 0.01 + 1e-4
            a_s = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
            got = grouped_matmul(x, w, sizes, w_scale=ws, a_scale=a_s)
            want = ref.grouped_matmul_q_ref(x, w, sizes, ws, a_s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"grouped int8 T={T} G={G} {Din}->{Dout}: not "
                                     f"bit-equal, max err {max_err(got, want)}")
            if Din == 2048:
                int8_row["olmoe"].append(_grouped_timing(f"{label}_fc1", x, w, sizes, ws, a_s))
    return [int8_row, f32_row]


def _grouped_timing(label, x, w, sizes, ws=None, a_s=None) -> dict:
    """Time one grouped matmul (int8, W4A8 or f32 by the operands) and its
    plain version, and bound it: each input read once (the weights of the
    experts that got rows only), the output written once, 2 T Din Dout
    operations at the int8 or f32 rate."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import grouped_matmul

    T, Din = x.shape
    G, w_rows, Dout = w.shape
    g_active = int((sizes > 0).sum())
    if x.dtype == torch.int8:
        plain = ref.grouped_matmul_q4_ref if w.dtype == torch.uint8 else ref.grouped_matmul_q_ref
        nb, by = bound_ms(T * Din + g_active * w_rows * Dout + 4 * G * Dout + 4
                          + 4 * T * Dout, 2.0 * T * Din * Dout, INT8_OPS_PER_S)
        fn = lambda: grouped_matmul(x, w, sizes, w_scale=ws, a_scale=a_s)  # noqa: E731
        plain_fn = lambda: plain(x, w, sizes, ws, a_s)  # noqa: E731
    else:
        nb, by = bound_ms(4 * (T * Din + g_active * Din * Dout + T * Dout),
                          2.0 * T * Din * Dout, F32_OPS_PER_S)
        fn = lambda: grouped_matmul(x, w, sizes)  # noqa: E731
        plain_fn = lambda: ref.grouped_matmul_ref(x, w, sizes)  # noqa: E731
    return {"label": label, "shape": [T, G, Din, Dout], "ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, iters=10), "bound_ms": nb, "bound_by": by}


def _check_grouped_w4a8(gen) -> dict:
    """W4A8 at the OLMoE-1B-7B expert fc1 shapes (2048 -> 2 x 1024, 64
    experts): a decode tick (8 slots x top-8 = 64 routed rows) and a full
    512-token packed prefill (4096 rows); fc2 (1024 -> 2048) checked too.
    Bit-equal to ``grouped_matmul_q4_ref``."""
    from repro_torch.core.quant.qtypes import pack_int4
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_linear import grouped_matmul

    G = 64
    row = {"name": "grouped_matmul_w4a8", "max_abs_err": 0.0, "tolerance": "bit-equal",
           "library_ms": None}
    for T, label in ((8 * 8, ""), (512 * 8, "prefill_")):
        sizes = _routing(gen, T, G)
        for Din, Dout in ((2048, 2048), (1024, 2048)):
            x = torch.randint(-128, 128, (T, Din), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = pack_int4(torch.randint(-8, 8, (G, Din, Dout), generator=gen,
                                        device="cuda", dtype=torch.int8))
            ws = torch.rand((G, Dout), generator=gen, device="cuda") * 0.01 + 1e-4
            a_s = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
            got = grouped_matmul(x, w, sizes, w_scale=ws, a_scale=a_s)
            want = ref.grouped_matmul_q4_ref(x, w, sizes, ws, a_s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"grouped W4A8 T={T} {Din}->{Dout}: not "
                                     f"bit-equal, max err {max_err(got, want)}")
            if Din == 2048:  # fc1 is timed
                t = _grouped_timing(label or "decode", x, w, sizes, ws, a_s)
                row.update({label + k: t[k] for k in
                            ("shape", "ms", "plain_ms", "bound_ms", "bound_by")})
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


def _lm_attention_row(name, mode, q, k, v, kw, tol, sdpa=None, gaussian=None) -> dict:
    """Check one LM attention mode against the plain version (inputs whose
    scores are exact in f32), time kernel, plain version and (quant_bits=0)
    SDPA, and bound it. ``gaussian``: the same call with Gaussian q, whose
    rows over 1e-4 are reported, not gated (a score on a .5 code boundary
    may round the other way when the dot products run in another order)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_attention import lm_attention

    got, want = lm_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = tol
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    err = max_err(got, want)
    if gaussian is not None:
        diff = (lm_attention(gaussian, k, v, **kw)
                - ref.flash_attention_ref(gaussian, k, v, **kw)).abs().amax(-1)
        print(f"[kernels] lm_attention[{name}], Gaussian q: max err "
              f"{float(diff.max()):.3g}, rows over 1e-4: {int((diff > 1e-4).sum())} "
              f"of {diff.numel()}", flush=True)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
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
    return {
        "name": f"lm_attention[{name}]", "mode": mode, "shape": [B, Sq, Sk, H, KVH, hd],
        "quant_bits": kw.get("quant_bits", 0), "kv_dtype": str(k.dtype).removeprefix("torch."),
        "max_abs_err": err, "tolerance": f"atol={atol}, rtol={rtol}",
        "ms": time_ms(lambda: lm_attention(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=5),
        "bound_ms": nb, "bound_by": by,
        "library_ms": None if sdpa is None else time_ms(sdpa),
    }


def _check_lm_attention(gen) -> list:
    """Every LM mode at the OLMoE-1B-7B shapes (16 heads of 128): the
    calibration forward, a 512-token packed prefill over int8 K/V with four
    segments and a pad tail, a decode tick of 8 slots over the int8 cache,
    a decode tick over a bf16 cache, and the window / softcap options at a
    small shape. q (and fp k) lie on a 1/4 grid and int8 k is integral, so
    the scores are exact in f32 and the codes equal the plain version's."""
    from repro_torch.models.layers import quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    grid = lambda *shape: torch.randint(-3, 4, shape, generator=gen,  # noqa: E731
                                        device="cuda").float() * 0.25
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    H, hd, rows = 16, 128, []
    f32_tol, bf16_tol = (1e-5, 1e-5), (5e-3, 0.0)

    # calibration: causal, f32, online softmax (2 x 32 tokens)
    q, k, v = grid(2, 32, H, hd), grid(2, 32, H, hd), randn(2, 32, H, hd)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    rows.append(_lm_attention_row(
        "calibration", "causal/float32/qb0", q, k, v, dict(causal=True, quant_bits=0),
        f32_tol, sdpa=lambda: sdpa(t(q), t(k), t(v), is_causal=True)))

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
        sdpa=lambda: sdpa(t(q.bfloat16()), t(kb), t(vb), attn_mask=mask[:, None, None, :])))

    # local window and logit softcap (not on the OLMoE path), hd = 64
    S, Hs, W = 64, 4, 16
    q, k, v = grid(2, S, Hs, 64), grid(2, S, Hs, 64), randn(2, S, Hs, 64)
    pos = torch.arange(S, device="cuda")
    wmask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    rows.append(_lm_attention_row(
        "window", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, local_window=W), f32_tol,
        sdpa=lambda: sdpa(t(q), t(k), t(v), attn_mask=wmask)))
    rows.append(_lm_attention_row(
        "window_qb4", "causal/float32/qb4", q, k, v,
        dict(causal=True, quant_bits=4, local_window=W), f32_tol))
    rows.append(_lm_attention_row(  # no PyTorch call applies a tanh softcap
        "softcap", "causal/float32/qb0", q, k, v,
        dict(causal=True, quant_bits=0, local_window=W, logit_softcap=30.0), f32_tol))
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
    return {
        "name": "streaming_attention", "shape": [B, S, H, hd], "quant_bits": 4,
        "max_abs_err": err, "tolerance": "atol=1e-5, rtol=1e-5 (exact-score inputs)",
        "ms": time_ms(lambda: streaming_attention(q, k, v, quant_bits=4)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False,
                                                            quant_bits=4)),
        "bound_ms": nb, "bound_by": by, "library_ms": None,
        "lm_attention_ms": time_ms(lambda: lm_attention(q, k, v, causal=False,
                                                        quant_bits=4)),
        "lm_attention_max_abs_err": max_err(lm, want),
    }


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [_check_int8_matmul(gen), *_check_grouped_matmul(gen), _check_attention(gen),
            _check_grouped_w4a8(gen), *_check_lm_attention(gen)]
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

    return {"int8_matmul": int8_matmul, "grouped_matmul": grouped_matmul,
            "streaming_attention": streaming_attention, "lm_attention": lm_attention}


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
    return {
        "decode tick": _profile(
            f"profile lm {mat}", "decode tick", smi, 3,
            lambda: transformer.decode_step(p, cfg, tok, eng.cache, index, with_stats=True)),
        "packed prefill 512": _profile(
            f"profile lm {mat}", "packed prefill 512", smi, 3,
            lambda: transformer.prefill_packed(p, cfg, tok.new_zeros((1, P)), pos, seg,
                                               last, max_len=P)),
    }


def _profile(tag: str, label: str, smi: str, n: int, fn) -> dict:
    """Host wall time per call of ``fn`` with a synchronize, host time to
    enqueue alone, and the device time of every kernel it launched
    (torch.profiler, summed by kernel name; the top 8 printed), over ``n``
    calls after one warm-up call."""
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, calls = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.device_time, calls + 1)
    device_ms = sum(us for us, _ in by_name.values()) / n / 1e3
    kernels = sum(c for _, c in by_name.values()) / n
    print(f"[{tag}] {label} ({smi}): wall {wall * 1e3:.2f} ms, host enqueue "
          f"{enqueue * 1e3:.2f} ms, device kernels {device_ms:.2f} ms (busy share "
          f"{device_ms / (wall * 1e3):.2f}), {kernels:.0f} kernels", flush=True)
    for kname, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}] {us / n / 1e3:8.3f} ms {calls // n:5d} x  {kname[:80]}", flush=True)
    return {"wall_ms": wall * 1e3, "enqueue_ms": enqueue * 1e3, "device_ms": device_ms,
            "kernels": kernels}


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
    _profile("profile", f"{qcfg.name} int8 forward, B=8", smi, 5,
             lambda: classify(p_int8, qcfg, x))


def _launches(row: dict, vision: dict, vision_calib: dict, lm: dict) -> int:
    """A row's launches on the main path: the vision serving run, and for
    the modes the LM runs, the two OLMoE serving runs (the fp32 grouped and
    calibration attention rows: the calibration forwards)."""
    runs = [r["counts"] for r in lm["runs"].values()]
    name = row["name"]
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
    for row in rows:
        row["launches"] = _launches(row, counts, calib_counts, lm)
    for name in ("int8_matmul", "grouped_matmul", "grouped_matmul_w4a8",
                 "lm_attention[packed_prefill]", "lm_attention[decode_int8]"):
        row = next(r for r in rows if r["name"] == name)
        if row["launches"] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} | {"shape": row["shape"]}
                      for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
