"""Serving metrics of one engine, a framework-free copy of the engine half
of ``repro.serving.metrics``: ``hist_percentile``, ``LatencyTracker`` and
``EngineMetrics`` with the vision and LM counters, tokens/s and per-expert
occupancy (the cluster roll-up, program roofline rows, expert-health monitor
and the Prometheus export are not ported yet).

``EngineMetrics`` is host-side instrumentation only -- counters, latency
trackers, queue-depth samples and the per-expert routed-token occupancy --
fed from values already on the host. ``LatencyTracker`` keeps an exact
sample reservoir plus a fixed log-spaced histogram, so it stays correct past
the reservoir.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

# Log-spaced latency bins: 10 us .. 100 s, 8 bins per decade. Records
# outside the range clamp into the first/last bin.
_BIN_EDGES = np.logspace(-5, 2, 7 * 8 + 1)


def hist_percentile(hist: np.ndarray, p: float,
                    max_value: Optional[float] = None) -> float:
    """p-th percentile of a ``_BIN_EDGES`` histogram (geometric bin
    midpoint). An empty histogram answers 0.0; a single-sample histogram
    answers ``max_value`` when the caller supplies it."""
    total = int(hist.sum())
    if total == 0:
        return 0.0
    if total == 1 and max_value is not None:
        return float(max_value)
    target = (p / 100.0) * total
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, max(target, 1), side="left"))
    if b == 0:
        return float(_BIN_EDGES[0])
    if b >= _BIN_EDGES.size:
        hi = _BIN_EDGES[-1]
        return float(min(hi, max_value) if max_value is not None else hi)
    return float(np.sqrt(_BIN_EDGES[b - 1] * _BIN_EDGES[b]))


class LatencyTracker:
    """Latency distribution: exact-sample reservoir + log-bin histogram.

    While at most ``maxlen`` samples have been recorded the percentiles are
    exact; beyond that the log-bin histogram answers. ``lock`` lets
    ``EngineMetrics`` share one reentrant lock across its trackers.
    """

    def __init__(self, maxlen: int = 8192, lock=None) -> None:
        self._maxlen = maxlen
        self._lock = lock if lock is not None else threading.RLock()
        self._samples: deque = deque(maxlen=maxlen)
        self._hist = np.zeros(_BIN_EDGES.size + 1, np.int64)
        self._total = 0
        self._sum = 0.0
        self._max = float("-inf")

    def record(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self._samples.append(s)
            self._hist[np.searchsorted(_BIN_EDGES, s, side="right")] += 1
            self._total += 1
            self._sum += s
            self._max = max(self._max, s)

    @property
    def exact(self) -> bool:
        """Whether the reservoir still holds every recorded sample."""
        return self._total <= self._maxlen

    def percentile(self, p: float) -> float:
        """p-th percentile in seconds (0.0 when empty; a single sample
        answers itself)."""
        with self._lock:
            if self._total == 0:
                return 0.0
            if self._total == 1:
                return self._max
            if self.exact and len(self._samples) == self._total:
                return float(np.percentile(np.asarray(self._samples), p))
            return hist_percentile(self._hist, p, max_value=self._max)

    def snapshot(self) -> Dict[str, float]:
        """Milliseconds, the unit the paper's latency tables use."""
        with self._lock:
            if self._total == 0:
                return {"n": 0, "p50": float("nan"), "p95": float("nan"),
                        "p99": float("nan"), "mean": float("nan"),
                        "max": float("nan")}
            return {
                "n": int(self._total),
                "p50": self.percentile(50) * 1e3,
                "p95": self.percentile(95) * 1e3,
                "p99": self.percentile(99) * 1e3,
                "mean": (self._sum / self._total) * 1e3,
                "max": self._max * 1e3,
            }


class EngineMetrics:
    """Counters + latency + occupancy for one engine instance.

    Counters (an engine touches the subset that applies):
      submitted / completed / rejected -- request lifecycle
      cancelled        -- deadline drops, queued or mid-generation (LM)
      batches          -- device batches dispatched (vision)
      prefill_batches  -- packed-prefill dispatches (LM admission)
      decode_ticks     -- decode steps dispatched (LM)
      frames           -- images completed (vision)
      padded_frames    -- pad rows added to fill a bucket (vision)
      tokens           -- decode tokens produced (LM)
      pack_real_tokens / pack_pad_tokens -- real and padding tokens of the
                          dispatched buffers (LM pack buffer, vision patches)
      callback_errors / retire_errors    -- ``on_done`` or a retirement
                          event raised (LM)
    ``expert_tokens`` accumulates the per-expert routed-token histogram
    (MoE archs): the occupancy metric.
    """

    def __init__(self, num_experts: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.RLock()
        self.counters: Dict[str, int] = {}
        self.request_latency = LatencyTracker(lock=self._lock)
        self.batch_latency = LatencyTracker(lock=self._lock)
        # admission-queue wait, stamped when a request leaves the queue
        self.queue_wait = LatencyTracker(lock=self._lock)
        # per-program step wall times keyed like "classify|b=8"
        self.step_latency: Dict[str, LatencyTracker] = {}
        self.expert_tokens = np.zeros(max(0, num_experts), np.int64)
        self._depth_sum = 0
        self._depth_max = 0
        self._depth_last = 0
        self._depth_n = 0
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None

    # -- feeding ------------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if name == "submitted" and self._first_t is None:
                # FPS window opens at first arrival
                self._first_t = self._clock()

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._depth_sum += depth
            self._depth_max = max(self._depth_max, depth)
            self._depth_last = depth
            self._depth_n += 1

    def add_expert_tokens(self, counts) -> None:
        """Accumulate a routed-token histogram (host array, [num_experts])."""
        a = np.asarray(counts, np.int64)
        with self._lock:
            if a.size and self.expert_tokens.size == a.size:
                self.expert_tokens += a

    def record_step(self, key: str, seconds: float) -> None:
        """Record one program dispatch's wall time under its program key."""
        with self._lock:
            t = self.step_latency.get(key)
            if t is None:
                t = self.step_latency[key] = LatencyTracker(
                    maxlen=4096, lock=self._lock)
            t.record(seconds)

    def work_done(self, n: int, unit: str = "frames") -> None:
        """Mark n units complete; drives the FPS window."""
        with self._lock:
            self.inc(unit, n)
            now = self._clock()
            if self._first_t is None:
                self._first_t = now
            self._last_t = now

    # -- readout ------------------------------------------------------------

    @property
    def fps(self) -> float:
        """Completed frames (or tokens, for the LM engine) per wall second,
        from the first submission to the last completion."""
        n = self.counters.get("frames", 0) or self.counters.get("tokens", 0)
        if self._first_t is None or self._last_t is None \
                or self._last_t <= self._first_t:
            return float("nan")
        return n / (self._last_t - self._first_t)

    def snapshot(self) -> dict:
        """The metrics schema of the reference engine (without the
        introspection rows)."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "fps": self.fps,
                "latency_ms": self.request_latency.snapshot(),
                "batch_latency_ms": self.batch_latency.snapshot(),
                "queue_wait_ms": self.queue_wait.snapshot(),
                "queue_depth": {
                    "mean": (self._depth_sum / self._depth_n)
                    if self._depth_n else 0.0,
                    "max": self._depth_max,
                    "last": self._depth_last,
                },
                "step_latency_ms": {k: t.snapshot()
                                    for k, t in sorted(self.step_latency.items())},
                "expert_tokens": self.expert_tokens.tolist(),
                "expert_occupancy": _occupancy_of(self.expert_tokens),
            }


def _occupancy_of(tokens: np.ndarray) -> List[float]:
    """Normalized + rounded occupancy."""
    total = tokens.sum()
    if total == 0:
        return [0.0] * int(tokens.size)
    return [round(float(x), 6) for x in tokens / float(total)]
