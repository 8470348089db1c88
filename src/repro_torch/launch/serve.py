"""Serving launcher of the port: continuous-batching greedy generation of one
LM replica on the card, ported from ``repro.launch.serve`` (single-engine
path).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --quantized --requests 16 --prompt-len 64 --new-tokens 32 \\
      --slots 8 --max-len 512

Weights are random, drawn on the device from ``--seed``. ``--quantized``
turns on the serving quantization of the reference launcher: the int8 K/V
cache and the 4-bit log-sqrt2 attention over the fp weights (a PTQ'd
QuantizedParams tree is served through ``ServeEngine`` directly; see
``chip_smoke.py``). ``--smoke`` takes the reduced config; ``--device cpu``
runs the plain versions on the CPU. The report is one summary of the
engine's metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import init_model_params
from repro_torch.serving.engine import Request, ServeEngine, serving_config


def _fmt_ms(d: dict) -> str:
    if d["n"] == 0:
        return "n=0"
    return (f"n={d['n']} p50={d['p50']:.2f}ms p95={d['p95']:.2f}ms "
            f"p99={d['p99']:.2f}ms max={d['max']:.2f}ms")


def print_report(snap: dict) -> None:
    """Every counter the engine tracks, latencies, padding and occupancy."""
    print(f"engine: tok/s={snap['fps']:.1f}")
    print("  latency: " + _fmt_ms(snap["latency_ms"]))
    print("  queue_wait: " + _fmt_ms(snap["queue_wait_ms"]))
    counters = snap["counters"]
    print("  counters: " + " ".join(f"{k}={v}" for k, v in sorted(counters.items())))
    real = counters.get("pack_real_tokens", 0)
    pad = counters.get("pack_pad_tokens", 0)
    if real + pad:
        print(f"  prefill padding: real={real} pad={pad} "
              f"({100.0 * real / (real + pad):.1f}% buffer utilization, "
              f"{counters.get('prefill_batches', 0)} dispatches)")
    if snap["expert_tokens"]:
        occ = ", ".join(f"{x:.3f}" for x in snap["expert_occupancy"])
        print(f"  expert occupancy: [{occ}]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--quantized", action="store_true",
                    help="int8 K/V cache + 4-bit log-sqrt2 attention")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = serving_config(cfg)
    if args.quantized:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, enable=True))
    params = init_model_params(cfg, args.seed, args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len)
                    .astype(np.int32), max_new_tokens=args.new_tokens)
            for uid in range(args.requests)]
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_len=args.max_len,
                         device=args.device)
    engine.warmup()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in reqs)
    print(f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, "
          f"quantized={cfg.quant.enable}, device={args.device})")
    print_report(engine.metrics.snapshot())


if __name__ == "__main__":
    main()
