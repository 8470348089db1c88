"""Live performance introspection of the serving stack, ported from
``repro.serving.introspect``.

  * ``ProgramCost`` rows, one per serving program, keyed by the same
    ``serve/<prog>|B=..|S=..`` / ``classify|b=..`` keys as
    ``EngineMetrics.step_latency``, so ``metrics.program_perf`` joins them
    with the measured step times into MFU, achieved HBM bandwidth and a
    compute/memory/collective roofline classification. The reference reads
    XLA's ``cost_analysis()``, ``memory_analysis()`` and HLO; a CUDA graph
    has no such surface, so the port's row is the reference's analytic
    model (``estimated=True``, ``source="analytic"``), equal to the
    reference's analytic row for the same key and config.
  * Memory watermarks: on a card the CUDA caching allocator's statistics
    (bytes allocated now and at peak, the card's total memory as the
    limit); on the CPU the analytic model (params + K/V cache + the largest
    temp arena, which no analytic row knows: 0), marked estimated.
  * ``ExpertHealthMonitor``: windowed occupancy entropy / hot-cold skew
    over the routed-token stream, emitting ``expert_drift`` events into
    the serving ``EventLog`` when a window's occupancy moves more than a
    total-variation threshold from the reference.

``install`` attaches all of it at ``warmup()`` and never fails a warmup:
it swallows errors of its own cost and memory rows only; nothing on a
kernel's path runs inside it.
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import hw

# ProgramCost rows are plain dicts with exactly these keys (the reference's
# schema). -1 marks "not known"; ``flops`` / ``hbm_bytes`` are what the MFU
# and roofline join reads.
PROGRAM_COST_FIELDS = (
    "flops", "dot_flops", "cost_flops", "hbm_bytes", "convert_bytes",
    "collective_bytes", "argument_bytes", "output_bytes", "temp_bytes",
    "generated_code_bytes", "estimated", "source",
)


def parse_program_key(key: str) -> Tuple[str, Dict[str, int]]:
    """Split an AOT program key (``serve/decode|B=4|S=512`` /
    ``classify|b=8``) into its program name and integer k=v fields."""
    parts = key.split("|")
    kv: Dict[str, int] = {}
    for p in parts[1:]:
        if "=" not in p:
            continue
        k, _, v = p.partition("=")
        try:
            kv[k] = int(v)
        except ValueError:
            pass
    return parts[0], kv


def analytic_program_cost(key: str, cfg=None, *, param_bytes: int = 0,
                          cache_bytes: int = 0) -> dict:
    """Analytic ProgramCost row (``estimated=True``) from the config's
    derived sizes and the program key's shape fields, the reference's
    formula: 2 x active params flops a token plus the attention
    contractions, and every weight byte and the K/V cache read once a
    dispatch. Deliberately rough, and always flagged."""
    prog, kv = parse_program_key(key)
    active = d = n_layers = q_dim = 0
    if cfg is not None:
        try:
            active = cfg.active_param_count()
            d = cfg.d_model
            n_layers = cfg.num_layers
            q_dim = cfg.attn.q_dim if cfg.attn is not None else d
        except Exception:
            pass
    tokens = ctx = 0
    if "decode" in prog:
        tokens = kv.get("B", 1)
        ctx = kv.get("S", 0)
    elif "packed_prefill" in prog:
        tokens = kv.get("bucket", 1)
        ctx = tokens
    elif "grouped_prefill" in prog:
        tokens = kv.get("L", 1) * max(1, kv.get("n", 1))
        ctx = kv.get("L", 1)
    elif prog == "classify":
        seq = cfg.image_tokens if cfg is not None and cfg.image_tokens else 1
        tokens = kv.get("b", 1) * seq
        ctx = seq
    else:
        tokens = kv.get("B", kv.get("b", 1))
        ctx = kv.get("S", 0)
    # 2*active matmul flops per token + attention score/value contractions
    flops = 2.0 * active * tokens + 4.0 * q_dim * ctx * tokens * n_layers
    # weights stream once per dispatch; decode re-reads the K/V cache
    hbm = float(param_bytes + cache_bytes) + 4.0 * d * tokens
    return {
        "flops": flops if flops > 0 else -1.0,
        "dot_flops": 0.0, "cost_flops": -1.0,
        "hbm_bytes": hbm if hbm > 0 else -1.0,
        "convert_bytes": 0.0, "collective_bytes": 0.0,
        "argument_bytes": int(param_bytes), "output_bytes": -1,
        "temp_bytes": -1, "generated_code_bytes": -1,
        "estimated": True, "source": "analytic",
    }


def capture_cost(key: str, cfg=None, *, param_bytes: int = 0,
                 cache_bytes: int = 0) -> dict:
    """ProgramCost of one program: the analytic row (the reference's
    fallback when an executable exposes nothing, which a CUDA graph never
    does)."""
    return analytic_program_cost(key, cfg, param_bytes=param_bytes,
                                 cache_bytes=cache_bytes)


def _walk(tree, path=()):
    """(path of keys, tensor) for every tensor of a nested dict / list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensors (0 for None)."""
    return sum(_nbytes(t) for _, t in _walk(tree))


def param_byte_breakdown(tree) -> dict:
    """Dtype- and packing-aware parameter bytes: every tensor sized from its
    storage dtype, split into ``by_dtype`` (``torch.uint8`` = the
    nibble-packed int4 stacks), ``expert_stack_bytes`` (``wi`` / ``wo``
    leaves under a ``moe`` subtree) and ``int4_packed_bytes`` (``uint8``
    tensors of 2 or more dims)."""
    out = {"by_dtype": {}, "expert_stack_bytes": 0, "int4_packed_bytes": 0}
    for path, t in _walk(tree):
        n = _nbytes(t)
        if not n:
            continue
        dt = str(t.dtype).replace("torch.", "")
        out["by_dtype"][dt] = out["by_dtype"].get(dt, 0) + n
        if path and path[-1] in ("wi", "wo") and "moe" in path[:-1]:
            out["expert_stack_bytes"] += n
        if t.dtype == torch.uint8 and t.dim() >= 2:
            out["int4_packed_bytes"] += n
    return out


def _device_stats(dev) -> Optional[dict]:
    """The allocator's statistics of a card in the reference's names, or
    None for a device without them (the CPU, or a card not yet used)."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    s = torch.cuda.memory_stats(dev)
    if not s:
        return None
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}


def memory_watermark(devices=None, *, param_bytes: int = 0,
                     cache_bytes: int = 0,
                     program_costs: Optional[Dict[str, dict]] = None,
                     param_breakdown: Optional[dict] = None) -> dict:
    """A replica's memory watermark: the caching allocator's statistics
    summed over ``devices`` (default: the current card, else the CPU) with
    ``source="device"``, else the analytic model (resident params + K/V
    cache + the largest temp arena of the programs' cost rows), marked
    estimated. ``param_bytes`` and ``param_breakdown``
    (:func:`param_byte_breakdown`) are sized from the leaves' storage
    dtypes, nibble packing included."""
    if devices is None:
        devices = [torch.device("cuda") if torch.cuda.is_available()
                   else torch.device("cpu")]
    devices = list(devices)
    rows = [s for s in map(_device_stats, devices) if s]
    peak_temp = 0
    for c in (program_costs or {}).values():
        t = c.get("temp_bytes", 0)
        if isinstance(t, (int, float)) and t > 0:
            peak_temp = max(peak_temp, int(t))
    out = {
        "param_bytes": int(param_bytes),
        "kv_cache_bytes": int(cache_bytes),
        "peak_temp_bytes": peak_temp,
        "devices": len(rows) if rows else len(devices),
    }
    if param_breakdown:
        out["param_bytes_by_dtype"] = dict(param_breakdown.get("by_dtype", {}))
        out["expert_stack_bytes"] = int(param_breakdown.get("expert_stack_bytes", 0))
        out["int4_packed_bytes"] = int(param_breakdown.get("int4_packed_bytes", 0))
    if rows:
        out["source"] = "device"
        out["estimated"] = False
        out["bytes_in_use"] = sum(r["bytes_in_use"] for r in rows)
        out["peak_bytes_in_use"] = sum(r["peak_bytes_in_use"] for r in rows)
        out["bytes_limit"] = sum(r["bytes_limit"] for r in rows)
        out["watermark_bytes"] = out["peak_bytes_in_use"]
    else:
        out["source"] = "analytic"
        out["estimated"] = True
        out["watermark_bytes"] = int(param_bytes) + int(cache_bytes) + peak_temp
    return out


def install(metrics, *, cfg, programs, params=None, cache=None,
            devices=None) -> None:
    """Attach the introspection surface to an ``EngineMetrics``: one
    ProgramCost row per program key of ``programs``, the device's roofline
    peaks and a live memory-watermark probe. Called from ``warmup()``;
    swallows its own errors (introspection never fails a warmup), and runs
    no device work."""
    try:
        param_bytes = tree_bytes(params)
        param_breakdown = param_byte_breakdown(params)
        cache_bytes = tree_bytes(cache)
        devices = list(devices) if devices else None
        use_int8 = hw.pick_int8(
            params, getattr(getattr(cfg, "quant", None), "enable", False))
        metrics.set_peaks(hw.device_peaks(devices[0] if devices else None,
                                          use_int8=use_int8))
        for key in programs:
            try:
                metrics.set_program_cost(
                    key, capture_cost(key, cfg, param_bytes=param_bytes,
                                      cache_bytes=cache_bytes))
            except Exception:
                pass
        costs = metrics.program_costs  # static after warmup; probe re-reads

        def probe() -> dict:
            return memory_watermark(devices, param_bytes=param_bytes,
                                    cache_bytes=cache_bytes,
                                    program_costs=costs,
                                    param_breakdown=param_breakdown)

        metrics.memory_probe = probe
        metrics.set_memory(probe())
    except Exception:
        pass


def drift_counter(engine) -> Callable[[dict], None]:
    """An ``ExpertHealthMonitor.on_drift`` hook that adds one to the
    ``expert_drift`` counter of the engine's current ``metrics`` (resolved
    when it fires, so it lands in a fresh ``EngineMetrics`` after a reset).
    It holds the engine weakly: a monitor keeps no engine alive."""
    ref = weakref.ref(engine)

    def on_drift(info: dict) -> None:
        eng = ref()
        if eng is not None:
            eng.metrics.inc("expert_drift")

    return on_drift


class ExpertHealthMonitor:
    """Windowed expert-routing health over the routed-token stream.

    ``update(counts)`` accumulates per-expert routed-token histograms (the
    same host arrays ``EngineMetrics.add_expert_tokens`` receives). Every
    ``window_tokens`` routings the window closes: normalized occupancy
    entropy and the hot/cold skew ratio are computed, and the window's
    occupancy is compared (total-variation distance, L1/2) against a
    slowly-tracking reference. Distance above ``drift_threshold`` fires
    one ``expert_drift`` event into the ``EventLog`` (plus the optional
    ``on_drift`` hook — engines count it as an ``expert_drift`` metrics
    counter) and re-baselines, so a regime change is reported once, not
    on every subsequent window.

    Thread-safe behind its own lock, fed *outside* the metrics lock: the
    only lock order is monitor -> (events | metrics), never the reverse.
    """

    def __init__(self, num_experts: int, *, window_tokens: int = 4096,
                 drift_threshold: float = 0.25, baseline_alpha: float = 0.1,
                 events=None, label: str = "engine",
                 on_drift: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.num_experts = int(num_experts)
        self.window_tokens = int(window_tokens)
        self.drift_threshold = float(drift_threshold)
        self.baseline_alpha = float(baseline_alpha)
        self.events = events
        self.label = label
        self.on_drift = on_drift
        self._clock = clock
        self._lock = threading.Lock()
        self._win = np.zeros(self.num_experts, np.int64)
        self._ref: Optional[np.ndarray] = None
        self._last: dict = {}
        self.windows = 0
        self.drift_events = 0

    def update(self, counts) -> None:
        a = np.asarray(counts, np.int64).reshape(-1)
        if a.size != self.num_experts or self.num_experts == 0:
            return
        fire = None
        with self._lock:
            self._win += a
            if int(self._win.sum()) >= self.window_tokens:
                fire = self._close_window_locked()
        if fire is not None:
            if self.events is not None:
                try:
                    self.events.emit("expert_drift", t=self._clock(), **fire)
                except Exception:
                    pass
            if self.on_drift is not None:
                try:
                    self.on_drift(fire)
                except Exception:
                    pass

    def _close_window_locked(self) -> Optional[dict]:
        total = float(self._win.sum())
        occ = self._win / total
        nz = occ[occ > 0]
        e = self.num_experts
        entropy = (float(-(nz * np.log(nz)).sum() / math.log(e))
                   if e > 1 else 1.0)
        hot = float(occ.max())
        cold = float(occ.min())
        skew = hot / max(cold, 1.0 / (e * 1e3))  # floor keeps it finite
        l1 = (0.5 * float(np.abs(occ - self._ref).sum())
              if self._ref is not None else 0.0)
        drifted = self._ref is not None and l1 > self.drift_threshold
        self.windows += 1
        self._last = {
            "entropy": round(entropy, 6),
            "hot_cold_skew": round(skew, 3),
            "hot_expert": int(occ.argmax()),
            "cold_expert": int(occ.argmin()),
            "l1_vs_ref": round(l1, 6),
            "window_tokens": int(total),
        }
        if self._ref is None or drifted:
            self._ref = occ
        else:
            a = self.baseline_alpha
            self._ref = (1.0 - a) * self._ref + a * occ
        self._win[:] = 0
        if not drifted:
            return None
        self.drift_events += 1
        return dict(self._last, label=self.label)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "num_experts": self.num_experts,
                "windows": self.windows,
                "drift_events": self.drift_events,
                "drift_threshold": self.drift_threshold,
            }
            out.update(self._last)
            return out
