"""Serving metrics shared by the engines and the cluster, a framework-free
copy of ``repro.serving.metrics``: ``hist_percentile``, ``LatencyTracker``,
``EngineMetrics`` (the vision and LM counters, tokens/s, per-expert
occupancy, per-program step times, and the introspection surface of
``serving/introspect.py``: cost rows, roofline peaks, the memory probe, the
expert-health monitor), the join ``program_perf``, the cluster roll-up
``ClusterMetrics`` and its Prometheus text export.

``EngineMetrics`` is host-side instrumentation only -- counters, latency
trackers, queue-depth samples and the per-expert routed-token occupancy --
fed from values already on the host. ``LatencyTracker`` is merge-safe:
besides the exact-sample reservoir it keeps a fixed log-spaced histogram
that every ``record`` lands in, so trackers of N replicas combine by summing
histograms (and pooling the samples while they are complete).
``ClusterMetrics`` rolls replica metrics up that way: cluster percentiles
come from the pooled distribution, never from averaging per-replica
percentiles.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

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

    def __len__(self) -> int:
        return self._total

    @property
    def exact(self) -> bool:
        """Whether the reservoir still holds every recorded sample."""
        return self._total <= self._maxlen

    def merge(self, other: "LatencyTracker") -> None:
        """Fold another tracker's distribution into this one (cluster
        roll-up). Histograms add; samples pool while both sides are
        complete, after which the histogram carries the percentiles. The
        source is copied under its own lock (a live replica keeps recording
        during a roll-up), then folded in under ours: one after the other,
        never nested, so two-way merges cannot deadlock."""
        with other._lock:
            hist = other._hist.copy()
            total, ssum, smax = other._total, other._sum, other._max
            samples = list(other._samples)
        with self._lock:
            self._hist += hist
            self._total += total
            self._sum += ssum
            self._max = max(self._max, smax)
            for s in samples:
                self._samples.append(s)

    @classmethod
    def merged(cls, trackers: Sequence["LatencyTracker"],
               maxlen: int = 65536) -> "LatencyTracker":
        out = cls(maxlen=maxlen)
        for t in trackers:
            out.merge(t)
        return out

    def hist_data(self):
        """(bin_edges, counts, total, sum, max) copied under the lock."""
        with self._lock:
            return (_BIN_EDGES, self._hist.copy(), int(self._total),
                    float(self._sum), float(self._max))

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
      retraces         -- serving programs built after construction outside
                          ``warmup()``; 0 once it has run
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
        # per-program step times keyed like "classify|b=8" (device time on
        # a card, host time on the CPU: the engines' StepTimer)
        self.step_latency: Dict[str, LatencyTracker] = {}
        # ProgramCost rows (serving/introspect.py), one per program, same
        # keys as step_latency; static after warmup
        self.program_costs: Dict[str, dict] = {}
        # roofline peaks (analysis/hw.device_peaks): the MFU denominator
        self.peaks: Optional[dict] = None
        # live memory-watermark probe (introspect.memory_watermark closure);
        # snapshot() calls it outside the lock and keeps the last answer
        self.memory_probe: Optional[Callable[[], dict]] = None
        self._memory: Optional[dict] = None
        # expert-routing health monitor (introspect.ExpertHealthMonitor),
        # fed by add_expert_tokens outside the metrics lock: the monitor has
        # its own lock and may call back into inc() on drift
        self.expert_health = None
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
            monitor = self.expert_health
        if monitor is not None:
            # outside our lock: monitor -> metrics, never the reverse
            monitor.update(a)

    def set_program_cost(self, key: str, cost: dict) -> None:
        with self._lock:
            self.program_costs[key] = cost

    def set_peaks(self, peaks: dict) -> None:
        with self._lock:
            self.peaks = peaks

    def set_memory(self, mem: dict) -> None:
        with self._lock:
            self._memory = mem

    def adopt_static(self, other: "EngineMetrics") -> None:
        """Carry another metrics object's static introspection surface (cost
        rows, peaks, memory probe, health monitor) into this one. Engines
        call it from ``reset_metrics()``: cost rows describe programs, not
        load, so a replica that rejoins keeps them without double-counting."""
        with other._lock:
            costs = dict(other.program_costs)
            peaks = other.peaks
            probe = other.memory_probe
            mem = other._memory
            monitor = other.expert_health
        with self._lock:
            self.program_costs.update(costs)
            self.peaks = peaks if peaks is not None else self.peaks
            self.memory_probe = probe
            self._memory = mem
            self.expert_health = monitor

    def record_step(self, key: str, seconds: float) -> None:
        """Record one program dispatch's time under its program key."""
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
    def window(self):
        """(first_submission_t, last_completion_t), the FPS window bounds
        (either may be None); ``ClusterMetrics`` unions replica windows."""
        return self._first_t, self._last_t

    @property
    def fps(self) -> float:
        """Completed frames (or tokens, for the LM engine) per wall second,
        from the first submission to the last completion."""
        n = self.counters.get("frames", 0) or self.counters.get("tokens", 0)
        if self._first_t is None or self._last_t is None \
                or self._last_t <= self._first_t:
            return float("nan")
        return n / (self._last_t - self._first_t)

    def occupancy(self) -> np.ndarray:
        """Per-expert fraction of all routed (token, slot) pairs."""
        total = self.expert_tokens.sum()
        if total == 0:
            return np.zeros_like(self.expert_tokens, np.float64)
        return self.expert_tokens / float(total)

    def snapshot(self) -> dict:
        """The metrics schema of the reference engine."""
        mem = None
        probe = self.memory_probe
        if probe is not None:
            try:
                mem = probe()  # the allocator's statistics, outside the lock
            except Exception:
                mem = None
        with self._lock:
            if mem is not None:
                self._memory = mem
            monitor = self.expert_health
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
                "program_perf": program_perf(self.program_costs,
                                             self.step_latency, self.peaks),
                "memory": self._memory,
                "expert_health": (monitor.snapshot()
                                  if monitor is not None else None),
                "expert_tokens": self.expert_tokens.tolist(),
                "expert_occupancy": _occupancy_of(self.expert_tokens),
            }


def _occupancy_of(tokens: np.ndarray) -> List[float]:
    """Normalized + rounded occupancy."""
    total = tokens.sum()
    if total == 0:
        return [0.0] * int(tokens.size)
    return [round(float(x), 6) for x in tokens / float(total)]


def _occupancy_stats(tokens: np.ndarray) -> Optional[dict]:
    """Entropy + hot/cold skew of a routed-token histogram (the whole run's
    expert balance)."""
    total = float(tokens.sum()) if tokens.size else 0.0
    if total == 0:
        return None
    occ = tokens / total
    nz = occ[occ > 0]
    e = int(tokens.size)
    entropy = (float(-(nz * np.log(nz)).sum() / np.log(e))
               if e > 1 else 1.0)
    hot, cold = float(occ.max()), float(occ.min())
    return {
        "entropy": round(entropy, 6),
        "hot_cold_skew": round(hot / max(cold, 1.0 / (e * 1e3)), 3),
        "hot_expert": int(occ.argmax()),
        "cold_expert": int(occ.argmin()),
    }


def program_perf(costs: Dict[str, dict],
                 steps: Dict[str, "LatencyTracker"],
                 peaks: Optional[dict]) -> Dict[str, dict]:
    """Join the ProgramCost table with measured per-program step-latency
    histograms: per program this yields

      * the roofline terms t_compute = flops/peak_flops, t_memory =
        hbm_bytes/hbm_bw, t_collective = collective_bytes/ici_bw, with
        ``bound`` naming the dominant term;
      * measured MFU = flops / (p50 step seconds * peak_flops) and
        achieved HBM bandwidth = hbm_bytes / p50 step seconds;
      * ``roofline_frac`` = roofline-predicted step time over measured
        p50 (1.0 means the program runs at the hardware limit).

    p50 (not mean) anchors the measured side: step-time distributions are
    long-tailed (host jitter, retirement interleaving) and MFU should
    describe the typical dispatch. Rows appear for any key with a cost OR
    a measurement; the join fields only when both sides exist."""
    out: Dict[str, dict] = {}
    pf = float(peaks.get("peak_flops", 0)) if peaks else 0.0
    bw = float(peaks.get("hbm_bw", 0)) if peaks else 0.0
    ici = float(peaks.get("ici_bw", 0)) if peaks else 0.0
    for key in sorted(set(costs) | set(steps)):
        c = costs.get(key)
        row: dict = {}
        flops = hbm = coll = -1.0
        if c:
            flops = float(c.get("flops", -1.0))
            hbm = float(c.get("hbm_bytes", -1.0))
            coll = float(c.get("collective_bytes", 0.0) or 0.0)
            row["flops"] = flops
            row["hbm_bytes"] = hbm
            row["collective_bytes"] = coll
            row["estimated"] = bool(c.get("estimated", False))
            row["source"] = c.get("source", "")
            t_c = flops / pf if (flops > 0 and pf) else 0.0
            t_m = hbm / bw if (hbm > 0 and bw) else 0.0
            t_x = coll / ici if (coll > 0 and ici) else 0.0
            if t_c or t_m or t_x:
                terms = {"compute": t_c, "memory": t_m, "collective": t_x}
                row["t_compute_s"] = t_c
                row["t_memory_s"] = t_m
                row["t_collective_s"] = t_x
                row["bound"] = max(terms, key=terms.get)
                row["roofline_step_s"] = max(t_c, t_m, t_x)
        t = steps.get(key)
        if t is not None and len(t):
            sec = t.percentile(50)
            row["steps"] = len(t)
            row["step_p50_ms"] = round(sec * 1e3, 4)
            if sec > 0 and c:
                if flops > 0 and pf:
                    row["mfu"] = round(flops / sec / pf, 6)
                if hbm > 0:
                    row["achieved_hbm_gbps"] = round(hbm / sec / 1e9, 3)
                    if bw:
                        row["hbm_util"] = round(hbm / sec / bw, 6)
                rf = row.get("roofline_step_s", 0.0)
                if rf > 0:
                    row["roofline_frac"] = round(rf / sec, 6)
        if row:
            out[key] = row
    return out


class ClusterMetrics:
    """Merge-safe roll-up over N replica ``EngineMetrics``.

    Aggregation rules:
      * counters -- summed;
      * FPS -- total frames (tokens) over the *union* of replica windows
        (earliest first submission to latest completion), not a sum of
        replica FPS (replica windows overlap under shared load);
      * latency percentiles -- ``LatencyTracker.merged`` over the pooled
        distribution, never an average of per-replica percentiles;
      * per-expert occupancy -- routed-token histograms summed across
        replicas, then normalized.

    Membership is dynamic: ``add_replica`` joins a replica's metrics to the
    live set; ``remove_replica`` folds the leaving replica's whole
    distribution into a *retired accumulator*, so cluster totals,
    percentiles and the FPS window never lose a drained or evicted
    replica's history. The cluster resets the engine's own ``EngineMetrics``
    after the fold, so a replica that rejoins is never counted twice.
    ``mark_replicas`` records the (t, active-count) timeline.
    """

    def __init__(self, replicas: Sequence[EngineMetrics],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._replicas = list(replicas)
        self._clock = clock
        self._first_t: Optional[float] = None
        # front-end counters (admission rejections etc.). Guarded: replica
        # retirement threads feed the at-most-once guard's duplicate
        # counter (serving/cluster.py) off the pump thread.
        self._counter_lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        # front-end queue-depth samples (the autoscaler's pressure signal)
        self._depth_sum = 0
        self._depth_max = 0
        self._depth_last = 0
        self._depth_n = 0
        # retired accumulator: drained and evicted replicas fold in here
        self._ret_request = LatencyTracker(maxlen=65536)
        self._ret_batch = LatencyTracker(maxlen=65536)
        self._ret_queue_wait = LatencyTracker(maxlen=65536)
        self._ret_steps: Dict[str, LatencyTracker] = {}
        self._ret_counters: Dict[str, int] = {}
        self._ret_tokens: Optional[np.ndarray] = None
        self._ret_first: Optional[float] = None
        self._ret_last: Optional[float] = None
        # cost rows and peaks survive replica churn here: rows are static
        # program properties, so the fold unions keys, preferring measured
        # over estimated rows
        self._ret_costs: Dict[str, dict] = {}
        self._ret_peaks: Optional[dict] = None
        # (t, active-replica-count), appended by mark_replicas on every
        # scale event (and at cluster construction)
        self._timeline: List[tuple] = []

    # -- membership ---------------------------------------------------------

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    def add_replica(self, m: EngineMetrics) -> None:
        """Join a replica's metrics to the live set (replica scale-up)."""
        if m not in self._replicas:
            self._replicas.append(m)

    def remove_replica(self, m: EngineMetrics) -> None:
        """Fold a leaving replica's distribution into the retired
        accumulator. The caller resets the engine's metrics afterwards
        (``engine.reset_metrics()``), or a rejoin would count twice."""
        if m in self._replicas:
            self._replicas.remove(m)
        self._ret_request.merge(m.request_latency)
        self._ret_batch.merge(m.batch_latency)
        self._ret_queue_wait.merge(m.queue_wait)
        # per-program step histograms fold key by key
        with m._lock:
            step_items = list(m.step_latency.items())
        for k, t in step_items:
            acc = self._ret_steps.get(k)
            if acc is None:
                acc = self._ret_steps[k] = LatencyTracker(maxlen=65536)
            acc.merge(t)
        for k, v in m.counters.items():
            self._ret_counters[k] = self._ret_counters.get(k, 0) + v
        if m.expert_tokens.size:
            if self._ret_tokens is None:
                self._ret_tokens = m.expert_tokens.astype(np.int64).copy()
            elif self._ret_tokens.size == m.expert_tokens.size:
                self._ret_tokens += m.expert_tokens
        f, l = m.window
        if f is not None:
            self._ret_first = f if self._ret_first is None \
                else min(self._ret_first, f)
        if l is not None:
            self._ret_last = l if self._ret_last is None \
                else max(self._ret_last, l)
        with m._lock:
            costs = dict(m.program_costs)
            peaks = m.peaks
        for k, c in costs.items():
            old = self._ret_costs.get(k)
            if old is None or (old.get("estimated")
                               and not c.get("estimated")):
                self._ret_costs[k] = c
        if peaks is not None:
            self._ret_peaks = peaks

    def mark_replicas(self, n: int) -> None:
        """Append (now, active-replica-count) to the scale timeline."""
        self._timeline.append((self._clock(), int(n)))

    @property
    def replica_timeline(self) -> List[tuple]:
        return list(self._timeline)

    # -- feeding ------------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if name == "cluster_submitted" and self._first_t is None:
                self._first_t = self._clock()  # window opens at admission

    def observe_queue_depth(self, depth: int) -> None:
        """Sample the *front-end* queue depth (cluster route path)."""
        with self._counter_lock:
            self._depth_sum += depth
            self._depth_max = max(self._depth_max, depth)
            self._depth_last = depth
            self._depth_n += 1

    # -- readout ------------------------------------------------------------

    @property
    def fps(self) -> float:
        frames = sum(
            m.counters.get("frames", 0) or m.counters.get("tokens", 0)
            for m in self._replicas
        )
        frames += (self._ret_counters.get("frames", 0)
                   or self._ret_counters.get("tokens", 0))
        firsts = [m.window[0] for m in self._replicas
                  if m.window[0] is not None]
        if self._first_t is not None:
            firsts.append(self._first_t)  # front-end admission opens earlier
        if self._ret_first is not None:
            firsts.append(self._ret_first)
        lasts = [m.window[1] for m in self._replicas
                 if m.window[1] is not None]
        if self._ret_last is not None:
            lasts.append(self._ret_last)
        if not firsts or not lasts or max(lasts) <= min(firsts):
            return float("nan")
        return frames / (max(lasts) - min(firsts))

    def merged_request_latency(self) -> LatencyTracker:
        t = LatencyTracker.merged(
            [m.request_latency for m in self._replicas])
        t.merge(self._ret_request)
        return t

    def pooled_request_hist(self) -> np.ndarray:
        """Pooled request-latency histogram (live replicas + retired).

        Monotone non-decreasing over time as long as the leave protocol is
        followed (fold into retired, then reset), which is what lets the
        autoscaler difference two snapshots into a *windowed* percentile."""
        h = self._ret_request._hist.copy()
        for m in self._replicas:
            with m.request_latency._lock:
                h = h + m.request_latency._hist
        return h

    def merged_step_latency(self) -> Dict[str, LatencyTracker]:
        """Per-program step-latency trackers pooled over live replicas plus
        the retired accumulator (the request latency's merge rule)."""
        out: Dict[str, LatencyTracker] = {}
        sources: List[Dict[str, LatencyTracker]] = [self._ret_steps]
        for m in self._replicas:
            with m._lock:
                sources.append(dict(m.step_latency))
        for src in sources:
            for k, t in src.items():
                acc = out.get(k)
                if acc is None:
                    acc = out[k] = LatencyTracker(maxlen=65536)
                acc.merge(t)
        return out

    def merged_program_costs(self) -> Dict[str, dict]:
        """ProgramCost union over retired + live replicas. Live rows win
        over retired ones (and measured over estimated): replicas compile
        the same program grid, so same-key rows describe the same program."""
        out = dict(self._ret_costs)
        for m in self._replicas:
            with m._lock:
                costs = dict(m.program_costs)
            for k, c in costs.items():
                old = out.get(k)
                if old is None or (old.get("estimated")
                                   and not c.get("estimated")):
                    out[k] = c
        return out

    def merged_peaks(self) -> Optional[dict]:
        """Roofline peaks for the aggregate join: replicas are homogeneous
        (one device kind per cluster), so any replica's answer serves."""
        for m in self._replicas:
            if m.peaks is not None:
                return m.peaks
        return self._ret_peaks

    def snapshot(self) -> dict:
        """The reference's cluster schema. The ``memory`` roll-up sums the
        replica rows as the reference does: replicas sharing one card each
        report the whole process's allocator, so N of them count it N
        times."""
        counters: Dict[str, int] = dict(self.counters)
        for k, v in self._ret_counters.items():
            counters[k] = counters.get(k, 0) + v
        for m in self._replicas:
            for k, v in m.counters.items():
                counters[k] = counters.get(k, 0) + v
        sizes = {m.expert_tokens.size for m in self._replicas}
        if self._ret_tokens is not None:
            sizes.add(self._ret_tokens.size)
        if len(sizes) == 1 and (self._replicas
                                or self._ret_tokens is not None):
            tokens = np.sum(
                [m.expert_tokens for m in self._replicas]
                + ([self._ret_tokens] if self._ret_tokens is not None
                   else []),
                axis=0)
        else:
            tokens = np.zeros(0, np.int64)
        batch_lat = LatencyTracker.merged(
            [m.batch_latency for m in self._replicas])
        batch_lat.merge(self._ret_batch)
        queue_wait = LatencyTracker.merged(
            [m.queue_wait for m in self._replicas])
        queue_wait.merge(self._ret_queue_wait)
        replica_snaps = [m.snapshot() for m in self._replicas]
        mem_rows = [s["memory"] for s in replica_snaps
                    if s.get("memory") is not None]
        memory = None
        if mem_rows:
            memory = {
                "replicas": len(mem_rows),
                "param_bytes": sum(r.get("param_bytes", 0) for r in mem_rows),
                "kv_cache_bytes": sum(r.get("kv_cache_bytes", 0)
                                      for r in mem_rows),
                "watermark_bytes": sum(r.get("watermark_bytes", 0)
                                       for r in mem_rows),
                "estimated": any(r.get("estimated", True) for r in mem_rows),
            }
        health = _occupancy_stats(tokens)
        if health is not None:
            # the expert_drift counter folds through retirement like any
            # other counter, so this survives replica churn
            health["drift_events"] = counters.get("expert_drift", 0)
        return {
            "replicas": replica_snaps,
            "aggregate": {
                "counters": counters,
                "fps": self.fps,
                "latency_ms": self.merged_request_latency().snapshot(),
                "batch_latency_ms": batch_lat.snapshot(),
                "queue_wait_ms": queue_wait.snapshot(),
                "step_latency_ms": {
                    k: t.snapshot()
                    for k, t in sorted(self.merged_step_latency().items())},
                "program_perf": program_perf(self.merged_program_costs(),
                                             self.merged_step_latency(),
                                             self.merged_peaks()),
                "memory": memory,
                "expert_health": health,
                "front_queue_depth": {
                    "mean": (self._depth_sum / self._depth_n)
                    if self._depth_n else 0.0,
                    "max": self._depth_max,
                    "last": self._depth_last,
                },
                "expert_tokens": tokens.tolist(),
                "expert_occupancy": _occupancy_of(tokens),
            },
            "replicas_active": (self._timeline[-1][1] if self._timeline
                                else len(self._replicas)),
            "replica_timeline": [[t, n] for t, n in self._timeline],
        }

    def export_prometheus(self) -> str:
        """Prometheus text-exposition rendering of every aggregate counter,
        gauge, and latency histogram.

        Counters land as one ``repro_serving_events_total`` family labeled
        by counter name; latency distributions render as cumulative
        histograms over the log-spaced ``_BIN_EDGES`` (``le`` in seconds,
        +Inf closing bucket, ``_sum``/``_count`` series); per-program step
        latencies carry a ``program`` label. The bucket boundaries are the
        same merge-safe bins the autoscaler windows over, so a scrape and a
        scale decision read one distribution."""
        snap = self.snapshot()
        agg = snap["aggregate"]
        lines: List[str] = []

        lines.append("# TYPE repro_serving_events_total counter")
        for k, v in sorted(agg["counters"].items()):
            lines.append(f'repro_serving_events_total{{event="{k}"}} {v}')

        fps = agg["fps"]
        lines.append("# TYPE repro_serving_fps gauge")
        lines.append("repro_serving_fps "
                     f"{0.0 if fps != fps else fps}")
        lines.append("# TYPE repro_serving_replicas_active gauge")
        lines.append(f"repro_serving_replicas_active "
                     f"{snap['replicas_active']}")
        depth = agg["front_queue_depth"]
        lines.append("# TYPE repro_serving_front_queue_depth gauge")
        for stat in ("mean", "max", "last"):
            lines.append(f'repro_serving_front_queue_depth{{stat="{stat}"}} '
                         f"{depth[stat]}")
        if agg["expert_tokens"]:
            lines.append("# TYPE repro_serving_expert_tokens_total counter")
            for i, v in enumerate(agg["expert_tokens"]):
                lines.append(
                    f'repro_serving_expert_tokens_total{{expert="{i}"}} {v}')

        batch_lat = LatencyTracker.merged(
            [m.batch_latency for m in self._replicas])
        batch_lat.merge(self._ret_batch)
        queue_wait = LatencyTracker.merged(
            [m.queue_wait for m in self._replicas])
        queue_wait.merge(self._ret_queue_wait)
        for name, tracker in (
            ("repro_request_latency_seconds", self.merged_request_latency()),
            ("repro_batch_latency_seconds", batch_lat),
            ("repro_queue_wait_seconds", queue_wait),
        ):
            lines += _prom_histogram(name, tracker)
        steps = self.merged_step_latency()
        if steps:
            lines.append("# TYPE repro_step_latency_seconds histogram")
            for key, tracker in sorted(steps.items()):
                lines += _prom_histogram(
                    "repro_step_latency_seconds", tracker,
                    labels=f'program="{key}"', typed=False)

        # -- introspection surface -------------------------------------------
        perf = agg.get("program_perf") or {}
        for metric, field in (
            ("repro_program_mfu", "mfu"),
            ("repro_program_achieved_hbm_bytes_per_second", None),
            ("repro_program_flops", "flops"),
            ("repro_program_hbm_bytes", "hbm_bytes"),
            ("repro_program_roofline_frac", "roofline_frac"),
            ("repro_program_cost_estimated", "estimated"),
        ):
            rows = []
            for key, row in sorted(perf.items()):
                if metric == "repro_program_achieved_hbm_bytes_per_second":
                    v = row.get("achieved_hbm_gbps")
                    v = v * 1e9 if v is not None else None
                elif field == "estimated":
                    v = float(bool(row["estimated"])) \
                        if "estimated" in row else None
                else:
                    v = row.get(field)
                    if v is not None and v < 0:
                        v = None
                if v is not None:
                    rows.append((key, v))
            if rows:
                lines.append(f"# TYPE {metric} gauge")
                for key, v in rows:
                    lines.append(f'{metric}{{program="{key}"}} {v:g}')
        bound_rows = [(k, r["bound"]) for k, r in sorted(perf.items())
                      if "bound" in r]
        if bound_rows:
            lines.append("# TYPE repro_program_roofline_bound gauge")
            for key, bound in bound_rows:
                lines.append('repro_program_roofline_bound'
                             f'{{program="{key}",bound="{bound}"}} 1')

        mem_lines = []
        for i, rsnap in enumerate(snap["replicas"]):
            mem = rsnap.get("memory")
            if not mem:
                continue
            for kind in ("param_bytes", "kv_cache_bytes",
                         "watermark_bytes", "bytes_in_use", "bytes_limit",
                         "expert_stack_bytes", "int4_packed_bytes"):
                if kind in mem:
                    mem_lines.append(
                        'repro_replica_memory_bytes'
                        f'{{replica="{i}",kind="{kind}"}} {mem[kind]}')
        if mem_lines:
            lines.append("# TYPE repro_replica_memory_bytes gauge")
            lines += mem_lines

        health = agg.get("expert_health")
        if health:
            lines.append("# TYPE repro_expert_occupancy_entropy gauge")
            lines.append("repro_expert_occupancy_entropy "
                         f"{health['entropy']}")
            lines.append("# TYPE repro_expert_hot_cold_skew gauge")
            lines.append("repro_expert_hot_cold_skew "
                         f"{health['hot_cold_skew']}")
        return "\n".join(lines) + "\n"


def _prom_histogram(name: str, tracker: LatencyTracker,
                    labels: str = "", typed: bool = True) -> List[str]:
    """Cumulative Prometheus histogram series from a ``LatencyTracker``'s
    log-bin histogram (le= boundaries in seconds)."""
    edges, counts, total, ssum, _ = tracker.hist_data()
    sep = "," if labels else ""
    out: List[str] = []
    if typed:
        out.append(f"# TYPE {name} histogram")
    cum = 0
    for i, edge in enumerate(edges):
        cum += int(counts[i])
        out.append(f'{name}_bucket{{{labels}{sep}le="{edge:g}"}} {cum}')
    out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {total}')
    out.append(f"{name}_sum{{{labels}}} {ssum}" if labels
               else f"{name}_sum {ssum}")
    out.append(f"{name}_count{{{labels}}} {total}" if labels
               else f"{name}_count {total}")
    return out
