#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase's error is
caught:

  1. device   -- require CUDA, print the card's name and power limit;
  2. build    -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  -- hold each kernel against its plain PyTorch version at the
                 M3ViT-S shapes of a batch of 8 and time kernel, plain version
                 and (int8_matmul only) ``torch._int_mm``;
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
                 of every kernel launched (torch.profiler).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the ``{"kernels": [...]}`` record. Times are CUDA-event
times over repeated launches with warm caches.
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
}
SOURCES = {
    "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
    "streaming_attention": "src/repro_torch/kernels/csrc/quant_attention.cu",
}
# kernel launches per int8 forward of M3ViT-S: 6 dense layers x (q, k, v, o,
# fc1, fc2) + 6 MoE layers x (q, k, v, o, gate) + head; 6 MoE layers x (fc1,
# fc2); 12 attention layers
PER_FORWARD = {"int8_matmul": 67, "grouped_matmul": 12, "streaming_attention": 12}


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

    B = 8
    M = 197 * B
    shapes = [(M, 384, 384), (M, 384, 1536), (M, 1536, 384), (M, 384, 16),
              (B, 384, 1000)]
    for M_, K, N in shapes:
        x, w, xs, ws = operands(M_, K, N)
        bias = torch.randn((N,), generator=gen, device="cuda")
        for b in (None, bias):
            got, want = int8_matmul(x, w, xs, ws, b), ref.int8_matmul_ref(x, w, xs, ws, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"int8_matmul {M_}x{K}x{N} bias={b is not None}: "
                                     f"not bit-equal, max err {max_err(got, want)}")
    M_, K, N = M, 384, 1536  # dense fc1, the largest int8 call of the forward
    x, w, xs, ws = operands(M_, K, N)
    nb, bound_by = bound_ms(M_ * K + K * N + 4 * N + 4 + 4 * M_ * N,
                            2.0 * M_ * N * K, INT8_OPS_PER_S)
    return {
        "name": "int8_matmul", "shape": [M_, K, N],
        "max_abs_err": 0.0, "tolerance": "bit-equal",
        "ms": time_ms(lambda: int8_matmul(x, w, xs, ws)),
        "plain_ms": time_ms(lambda: ref.int8_matmul_ref(x, w, xs, ws), iters=10),
        "bound_ms": nb, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch._int_mm(x, w)),
    }


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
    g_active = int((sizes > 0).sum())
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
    nb, by = bound_ms(T * Din + g_active * Din * Dout + 4 * G * Dout + 4 + 4 * T * Dout,
                      2.0 * T * Din * Dout, INT8_OPS_PER_S)
    nbf, byf = bound_ms(4 * (T * Din + g_active * Din * Dout + T * Dout),
                        2.0 * T * Din * Dout, F32_OPS_PER_S)
    return [
        {"name": "grouped_matmul", "mode": "int8", "shape": [T, G, Din, Dout],
         "max_abs_err": 0.0, "tolerance": "bit-equal",
         "ms": time_ms(lambda: grouped_matmul(x, w, sizes, w_scale=ws, a_scale=a_s)),
         "plain_ms": time_ms(lambda: ref.grouped_matmul_q_ref(x, w, sizes, ws, a_s),
                             iters=10),
         "bound_ms": nb, "bound_by": by, "library_ms": None},
        {"name": "grouped_matmul_f32", "mode": "f32", "shape": [T, G, Din, Dout],
         "max_abs_err": f32_err, "tolerance": "atol=1e-5, rtol=1e-5",
         "ms": time_ms(lambda: grouped_matmul(xf, wf, sizes)),
         "plain_ms": time_ms(lambda: ref.grouped_matmul_ref(xf, wf, sizes), iters=10),
         "bound_ms": nbf, "bound_by": byf, "library_ms": None},
    ]


def _check_attention(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_attention import streaming_attention

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
    want = ref.flash_attention_ref(q, k, v, quant_bits=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = max_err(got, want)
    qn, kn = (torch.randn((B, S, H, hd), generator=gen, device="cuda") for _ in "qk")
    diff = (streaming_attention(qn, kn, v, quant_bits=4)
            - ref.flash_attention_ref(qn, kn, v, quant_bits=4)).abs().amax(-1)
    print(f"[kernels] attention, Gaussian q/k: max err {float(diff.max()):.3g}, "
          f"rows over 1e-4: {int((diff > 1e-4).sum())} of {diff.numel()}", flush=True)
    n = B * S * H * hd
    nb, by = bound_ms(4 * 4 * n, 2.0 * 2 * B * H * S * S * hd, F32_OPS_PER_S)
    return {
        "name": "streaming_attention", "shape": [B, S, H, hd], "quant_bits": 4,
        "max_abs_err": err, "tolerance": "atol=1e-5, rtol=1e-5 (exact-score inputs)",
        "ms": time_ms(lambda: streaming_attention(q, k, v, quant_bits=4)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, quant_bits=4)),
        "bound_ms": nb, "bound_by": by, "library_ms": None,
    }


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [_check_int8_matmul(gen), *_check_grouped_matmul(gen), _check_attention(gen)]
    for row in rows:
        row["route"] = "cuda"
        base = row["name"].removesuffix("_f32")
        row["source"], row["replaces"] = SOURCES[base], REPLACES[base]
        emit({"kernel": row})
    return rows


def _counters():
    from repro_torch.kernels.expert_linear import grouped_matmul
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.quant_attention import streaming_attention

    return {"int8_matmul": int8_matmul, "grouped_matmul": grouped_matmul,
            "streaming_attention": streaming_attention}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in _counters().items()}


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


def phase_e2e(qcfg, p_int8) -> None:
    """The int8 forward on the card against the same tree on the CPU (plain
    versions). Free-running, the two drift apart: a score or activation
    that the two paths round on different sides of a code boundary (4-bit
    attention codes, int8 activations) changes a weight or an LSB, a few of
    those change a token's top-2 experts, and twelve random-weight layers
    amplify that into O(1) logit differences. So the gate is teacher-forced:
    every block, and the head, gets the card's input on both sides."""
    from repro_torch.models import forward, synth_patches, vit

    x = torch.from_numpy(synth_patches(qcfg, 4, seed=9))
    p_cpu = _tree_to(p_int8, "cpu")
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
    """Where one int8 forward at B=8 spends its time: host wall time with a
    synchronize, host time to enqueue alone, and the device time of every
    kernel it launched (torch.profiler), summed by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import classify, synth_patches

    x = torch.from_numpy(synth_patches(qcfg, 8, seed=4)).cuda()
    n = 5
    with torch.inference_mode():
        for _ in range(3):
            classify(p_int8, qcfg, x)["classes"].cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            classify(p_int8, qcfg, x)
        enqueue = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                classify(p_int8, qcfg, x)
            torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, calls = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.device_time, calls + 1)
    device_ms = sum(us for us, _ in by_name.values()) / n / 1e3
    launches = sum(c for _, c in by_name.values()) / n
    print(f"[profile] {qcfg.name} int8 forward, B=8 ({smi}): wall {wall * 1e3:.2f} ms, "
          f"host enqueue {enqueue * 1e3:.2f} ms, device kernels {device_ms:.2f} ms "
          f"(busy share {device_ms / (wall * 1e3):.2f}), {launches:.0f} kernels",
          flush=True)
    for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile] {us / n / 1e3:7.3f} ms {calls // n:5d} x  {name[:80]}",
              flush=True)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> None:
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    qcfg, p_int8, counts, calib_counts = phase_serving(smi)
    phase_e2e(qcfg, p_int8)
    phase_profile(qcfg, p_int8, smi)
    for row in rows:
        row["launches"] = (calib_counts["grouped_matmul"]
                           if row["name"] == "grouped_matmul_f32"
                           else counts[row["name"]])
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
