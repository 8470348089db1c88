"""Serving launcher of the port: continuous-batching greedy generation on the
card, ported from ``repro.launch.serve``.

One engine:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --quantized --requests 16 --prompt-len 64 --new-tokens 32 \\
      --slots 8 --max-len 512

  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --requests 16 --prompt-len 64 --new-tokens 32 --slots 8 --max-len 512

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      [--quantized] --requests 16 --new-tokens 32 --slots 8 --max-len 512

A cluster of LM replicas behind one front-end (``serving/cluster.py``:
least-loaded routing, the watchdog, eviction and re-dispatch):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --quantized --replicas 2 --requests 16 --new-tokens 32 --slots 8 \\
      --max-len 512 [--chaos --chaos-kill 1:20]

The MoE LMs, the dense LMs (llama3-8b, gemma-7b, nemotron-4-340b) and the
vlm (internvl2-26b, text-only) admit through packed prefill; the hybrid
(zamba2-7b) and the encoder-decoder (seamless-m4t-medium) are refused, as
the reference's engine cannot serve them; gemma2-2b (alternating local/global layers, the local layers' K/V
in a ring of min(max_len, 4096) rows) and falcon-mamba (no packed prefill)
through the grouped same-length path, falcon-mamba's prefill through the
selective-scan kernel. Weights are random, drawn on the device from ``--seed``; the
replicas of a cluster on one card share them. ``--quantized`` turns on the
serving quantization of the reference launcher: the int8 K/V cache and the
4-bit log-sqrt2 attention over the fp weights (a PTQ'd QuantizedParams tree
is served through ``ServeEngine`` directly; see ``chip_smoke.py``).
``--smoke`` takes the reduced config; ``--device cpu`` runs the plain
versions on the CPU.

``--replicas N`` (N >= 2) serves through ``ServingCluster(engine="lm")``,
pumped with ``step()`` while requests are queued or in flight, so a
scheduled kill fires at its step, then flushed.
``--events-out`` streams the event journal (rejections, cancellations,
retirement faults, evictions, re-dispatches) as JSONL. ``--chaos`` wraps the
replicas in the seeded fault injector (``serving/faults.py``) with the
``--chaos-*`` rates and ``--chaos-kill ORDINAL:STEP`` scheduled kills; the
watchdog is on for the cluster regardless. SIGTERM/SIGINT stop admission,
and what was accepted is served to the end. Both paths report through one
``ClusterMetrics.snapshot()``.

Observability: ``--trace-out t.json`` turns tracing on and writes the run's
span timelines as Chrome-trace/Perfetto JSON (one process per replica);
``--metrics-out m.prom`` writes the final Prometheus text (counters,
latency and per-program step histograms, the programs' MFU / HBM share /
roofline rows, memory), rewritten every ``--metrics-interval`` seconds
during the run when given; ``--metrics-port N`` serves ``/metrics``,
``/healthz`` and ``/snapshot`` over HTTP on 127.0.0.1 for the duration of
the run (0 picks a free port). On the card the step histograms hold device
time.

Autotuning: ``--autotune`` tunes the grouped kernel's variant and
``lm_attention``'s schedule at every engine's warmup, before its graphs are
captured (``kernels/autotune.py``), and prints the table's summary after
warmup; the table is ``autotune_torch_<device kind>.json`` under
``--autotune-cache`` (default ``$REPRO_AUTOTUNE_CACHE``, else
``.repro_autotune``), so a relaunch on the same kind of card sweeps
nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import threading
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.fault_tolerance import PreemptionGuard
from repro_torch.kernels import autotune
from repro_torch.models import init_model_params
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.engine import Request, ServeEngine, check_servable, serving_config
from repro_torch.serving.events import EventLog
from repro_torch.serving.metrics import ClusterMetrics
from repro_torch.serving.metrics_server import MetricsServer, cluster_healthz
from repro_torch.serving.trace import write_chrome_trace


class _PeriodicMetricsWriter(threading.Thread):
    """Rewrite ``--metrics-out`` every ``interval`` seconds during the run
    (tmp file + rename), so a crashed or killed run still leaves its last
    metrics behind."""

    def __init__(self, cm, path: str, interval: float) -> None:
        super().__init__(daemon=True, name="metrics-writer")
        self._cm = cm
        self._path = path
        self._interval = interval
        self._halt = threading.Event()
        self.writes = 0

    def write_once(self) -> None:
        try:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                f.write(self._cm.export_prometheus())
            os.replace(tmp, self._path)
            self.writes += 1
        except Exception:
            pass  # a failed periodic write must not kill the run

    def run(self) -> None:
        while not self._halt.wait(self._interval):
            self.write_once()

    def stop(self) -> None:
        self._halt.set()
        self.join()


def _fmt_ms(d: dict) -> str:
    if d["n"] == 0:
        return "n=0"
    return (f"n={d['n']} p50={d['p50']:.2f}ms p95={d['p95']:.2f}ms "
            f"p99={d['p99']:.2f}ms max={d['max']:.2f}ms")


def print_report(snap: dict) -> None:
    """One summary off a ``ClusterMetrics.snapshot()``: every counter the
    engines and the cluster track, latencies, padding and occupancy."""
    agg = snap["aggregate"]
    print(f"aggregate: tok/s={agg['fps']:.1f} "
          f"replicas_active={snap['replicas_active']}")
    print("  latency: " + _fmt_ms(agg["latency_ms"]))
    print("  queue_wait: " + _fmt_ms(agg["queue_wait_ms"]))
    if agg["batch_latency_ms"]["n"]:
        print("  batch_latency: " + _fmt_ms(agg["batch_latency_ms"]))
    counters = agg["counters"]
    print("  counters: " + " ".join(f"{k}={v}" for k, v in sorted(counters.items())))
    real = counters.get("pack_real_tokens", 0)
    pad = counters.get("pack_pad_tokens", 0)
    if real + pad:
        print(f"  prefill padding: real={real} pad={pad} "
              f"({100.0 * real / (real + pad):.1f}% buffer utilization, "
              f"{counters.get('prefill_batches', 0)} dispatches)")
    print(f"  retraces after warmup: {counters.get('retraces', 0)}")
    for key, d in agg["step_latency_ms"].items():
        print(f"  step {key}: " + _fmt_ms(d))
    depth = agg["front_queue_depth"]
    if depth["max"]:
        print(f"  front_queue_depth: mean={depth['mean']:.2f} max={depth['max']}")
    if agg["expert_tokens"]:
        occ = ", ".join(f"{x:.3f}" for x in agg["expert_occupancy"])
        print(f"  expert occupancy: [{occ}]")
    for i, rep in enumerate(snap["replicas"]):
        print(f"  replica {i}: tokens={rep['counters'].get('tokens', 0)} "
              f"completed={rep['counters'].get('completed', 0)} "
              f"p50={rep['latency_ms']['p50']:.0f}ms")


def _chaos_config(cfg, args):
    kills = []
    for spec in args.chaos_kill:
        ordinal, step = spec.split(":")
        kills.append((int(ordinal), int(step), "dead"))
    return cfg.replace(faults=dataclasses.replace(
        cfg.faults, inject=True, seed=args.chaos_seed,
        step_error_rate=args.chaos_error_rate, oom_rate=args.chaos_oom_rate,
        step_stall_rate=args.chaos_stall_rate,
        submit_reject_rate=args.chaos_reject_rate, kill_schedule=tuple(kills)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--replicas", type=int, default=0,
                    help=">=2 serves through a ServingCluster of ServeEngine "
                         "replicas (one front-end, least-loaded routing)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 K/V cache + 4-bit log-sqrt2 attention")
    ap.add_argument("--autotune", action="store_true",
                    help="tune kernel variants and schedules at warmup on this kind "
                         "of device (kernels/autotune.py; a table per device kind "
                         "under --autotune-cache, a cache hit on relaunch)")
    ap.add_argument("--autotune-cache", default=None,
                    help="tuning-table directory (default $REPRO_AUTOTUNE_CACHE or "
                         ".repro_autotune)")
    ap.add_argument("--events-out", default=None,
                    help="stream structured serving events as JSONL here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run's span "
                         "timelines here (turns tracing on)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics as Prometheus text here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /healthz and /snapshot over HTTP on "
                         "this port during the run (0 picks a free port)")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    help="with --metrics-out, rewrite the file every N seconds "
                         "during the run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chaos", action="store_true",
                    help="wrap the cluster's replicas in seeded fault injectors")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-error-rate", type=float, default=0.0,
                    help="per-step probability of an injected step error")
    ap.add_argument("--chaos-oom-rate", type=float, default=0.0,
                    help="per-step probability of an injected OOM")
    ap.add_argument("--chaos-stall-rate", type=float, default=0.0,
                    help="per-step probability of an injected stall")
    ap.add_argument("--chaos-reject-rate", type=float, default=0.0,
                    help="per-submit probability of an injected rejection")
    ap.add_argument("--chaos-kill", action="append", default=[], metavar="ORDINAL:STEP",
                    help="kill replica ORDINAL for good at its local step STEP "
                         "(repeatable)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_servable(cfg)  # before the weights are built
    cfg = serving_config(cfg)
    if args.quantized:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, enable=True))
    if args.chaos:
        cfg = _chaos_config(cfg, args)
    if args.autotune:
        cfg = cfg.replace(autotune=dataclasses.replace(
            cfg.autotune, enable=True, cache_dir=args.autotune_cache))
    if args.trace_out:
        cfg = cfg.replace(trace=dataclasses.replace(cfg.trace, enable=True))
    params = init_model_params(cfg, args.seed, args.device)
    events = EventLog(path=args.events_out) if args.events_out else None
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len)
                    .astype(np.int32), max_new_tokens=args.new_tokens)
            for uid in range(args.requests)]
    cluster = engine = None
    if args.replicas >= 2:
        cluster = ServingCluster(
            cfg, params, replicas=args.replicas, engine="lm", batch_slots=args.slots,
            max_len=args.max_len, events=events,
            devices=None if args.device == "cuda" else [args.device])
        cluster.warmup()
        cm = cluster.metrics
        healthz = lambda: cluster_healthz(cluster)  # noqa: E731
    else:
        engine = ServeEngine(cfg, params, batch_slots=args.slots, max_len=args.max_len,
                             events=events, device=args.device)
        engine.warmup()
        # the single engine reports through the cluster's roll-up: one schema
        cm = ClusterMetrics([engine.metrics])
        healthz = None
    if args.autotune:
        print(autotune.summary())
    server = None
    if args.metrics_port is not None:
        server = MetricsServer(cm.export_prometheus, healthz_fn=healthz,
                               snapshot_fn=cm.snapshot, port=args.metrics_port).start()
        print(f"metrics endpoint: {server.url}/metrics")
    writer = None
    if args.metrics_interval and args.metrics_out:
        writer = _PeriodicMetricsWriter(cm, args.metrics_out, args.metrics_interval)
        writer.write_once()  # the file exists before the first period ends
        writer.start()

    # graceful preemption: SIGTERM/SIGINT stop admission; everything already
    # accepted is served to the end and reported
    guard = PreemptionGuard(signals=(signal.SIGTERM, signal.SIGINT))
    accepted = []
    try:
        t0 = time.perf_counter()
        for r in reqs:
            if guard.preempted:
                break
            (cluster or engine).submit(r)
            accepted.append(r)
            if cluster is not None:
                cluster.step()
        if cluster is not None:
            while cluster.total_load:
                cluster.step()
            cluster.flush()  # waits for the replicas' retirement threads
        else:
            engine.run_until_drained()
        dt = time.perf_counter() - t0
    finally:
        if writer is not None:
            writer.stop()
        if server is not None:
            server.close()
    if len(accepted) < len(reqs):
        print(f"preempted: served {len(accepted)} accepted requests, shed "
              f"{len(reqs) - len(accepted)} unsubmitted")
    total = sum(len(r.generated or ()) for r in accepted)
    extra = f"replicas={cluster.num_replicas}, " if cluster is not None else ""
    print(f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, {extra}"
          f"quantized={cfg.quant.enable}, device={args.device})")
    if cluster is not None:
        health = cluster.health()
        statuses = {}
        for r in accepted:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        print(f"cluster: status={health['status']} evicted={len(health['evicted'])} "
              f"requests by status {statuses}")
    print_report(cm.snapshot())
    if args.trace_out:
        if cluster is not None:
            recorders = cluster.flight_recorders()
        else:
            recorders = {engine.tracer.label: engine.tracer.recorder}
        doc = write_chrome_trace(args.trace_out, recorders)
        print(f"trace: {args.trace_out} "
              f"({sum(1 for e in doc['traceEvents'] if e['ph'] == 'X')} spans)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(cm.export_prometheus())
        print(f"metrics: {args.metrics_out}")
    if events is not None:
        events.close()
        print(f"events: {args.events_out} ({events.total} events)")


if __name__ == "__main__":
    main()
