"""Serving tracing, a framework-free copy of ``repro.serving.trace``:
per-request span timelines, a bounded flight recorder, and
Chrome-trace/Perfetto export.

``Tracer`` records a typed span timeline per request:

  queue   submit -> pack-planner selection (admission-queue + front-end wait)
  pack    planner selection -> program dispatch (host-side buffer build)
  prefill prefill dispatch window (the packed ``[1, bucket]`` program)
  infer   the vision engine's batched ``classify`` (dispatch -> retirement)
  decode  decode-slot residency (first token ready -> slot freed)
  retire  retirement handoff -> tokens materialized / callbacks fired

The phases share their boundary timestamps, so a completed request's
queue+pack+prefill+decode durations sum *exactly* to its recorded
end-to-end latency; ``retire`` extends past it (retirement is off the
latency path). Every span is on the engine's host clock (``clock=``); the
per-program step times that ``EngineMetrics`` files for the MFU join are
device time on a card (``serving/programs.py:StepTimer``), while the step
spans here stay on the host clock, beside the request spans.

Spans land in a ``FlightRecorder``: a bounded, thread-safe ring buffer (one
RLock; the retirement thread records while the decode loop records and an
exporter snapshots). When full, the oldest spans are evicted and counted in
``dropped``: the recorder holds the most recent window.

Overhead contract: engines hold ``NULL_TRACER`` (``enabled = False``) when
``cfg.trace.enable`` is off, and every instrumentation site is guarded by
that flag: the disabled path is one attribute read per call site, nothing
allocates, nothing locks.

Export: ``chrome_trace`` renders any window of one or more recorders as
Chrome-trace JSON (the Perfetto UI's native format): one *process* per
replica, one *thread* track per request plus thread 0 for the engine's
per-program step spans. ``validate_chrome_trace`` and
``validate_request_timelines`` are the well-formedness checks of an
exported trace.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional

# span phases, in required timeline order (a request's spans must be a
# subsequence of this — validate_request_timelines enforces it). LM requests
# use queue/pack/prefill/decode/retire; vision requests use queue/infer/retire
# (one batched classify forward is the whole service phase).
REQUEST_PHASES = ("queue", "pack", "prefill", "infer", "decode", "retire")
# kind of span: request-phase spans carry a trace id; step spans are the
# engine's per-program dispatch windows (tid 0 in the export)
KIND_REQUEST = "request"
KIND_STEP = "step"


class Span(NamedTuple):
    """One completed span. Times are engine-clock seconds (monotonic or an
    injected fake clock — the tracer never reads ``time`` itself)."""

    trace_id: Optional[int]  # request trace id; None for engine-step spans
    name: str  # phase (queue/pack/...) or program key (step spans)
    kind: str  # KIND_REQUEST | KIND_STEP
    t0: float
    t1: float
    attrs: Optional[dict] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class FlightRecorder:
    """Bounded thread-safe span ring buffer.

    ``record`` is the hot path: one lock acquisition, one deque append
    (evicting the oldest entry at capacity). ``spans`` copies under the
    lock so exporters never see a torn window. ``dropped`` counts evicted
    spans — a nonzero value means the exported window is the *recent* tail,
    not the full history.
    """

    def __init__(self, capacity: int = 65536) -> None:
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._total = 0

    def record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self._total += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total(self) -> int:
        """Spans ever recorded (including evicted ones)."""
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring bound."""
        with self._lock:
            return self._total - len(self._ring)

    def spans(self, t0: Optional[float] = None,
              t1: Optional[float] = None) -> List[Span]:
        """Snapshot of the recorded window, optionally clipped to spans
        overlapping [t0, t1]."""
        with self._lock:
            out = list(self._ring)
        if t0 is not None:
            out = [s for s in out if s.t1 >= t0]
        if t1 is not None:
            out = [s for s in out if s.t0 <= t1]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total = 0


class Tracer:
    """Per-request span timeline recorder over one ``FlightRecorder``.

    ``begin(tid, phase, t)`` opens a span; ``end(tid, phase, t)`` closes it
    into the recorder. Open spans live in a small dict keyed (tid, phase) —
    a request has at most one phase open at a time, so the dict stays the
    size of the in-flight population. ``record_span`` records a completed
    interval directly (the engine's per-program step windows).

    Thread-safe: begin/end/record_span take the tracer lock (the decode
    loop opens ``retire`` spans that the retirement thread closes).
    ``enabled`` is True on real tracers; engines test it once per call site
    so a disabled engine never reaches these methods (see ``NULL_TRACER``).
    """

    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic,
                 label: str = "engine") -> None:
        self.recorder = FlightRecorder(capacity)
        self.label = label  # replica name in the export (cluster sets it)
        self._clock = clock
        self._lock = threading.RLock()
        self._open: Dict[tuple, tuple] = {}  # (tid, name) -> (t0, attrs)

    def begin(self, trace_id: int, name: str,
              t: Optional[float] = None, **attrs: Any) -> None:
        t = self._clock() if t is None else t
        with self._lock:
            self._open[(trace_id, name)] = (t, attrs or None)

    def end(self, trace_id: int, name: str,
            t: Optional[float] = None, **attrs: Any) -> None:
        """Close an open span into the recorder. Ending a span that was
        never begun is a silent no-op — a half-instrumented path must not
        crash serving."""
        t = self._clock() if t is None else t
        with self._lock:
            ent = self._open.pop((trace_id, name), None)
            if ent is None:
                return
            t0, a0 = ent
            if attrs:
                a0 = {**(a0 or {}), **attrs}
            self.recorder.record(
                Span(trace_id, name, KIND_REQUEST, t0, max(t, t0), a0))

    def transition(self, trace_id: int, from_name: Optional[str],
                   to_name: Optional[str], t: Optional[float] = None,
                   **attrs: Any) -> None:
        """Close ``from_name`` and open ``to_name`` at the same instant —
        the one-call way to keep adjacent phases exactly contiguous (their
        shared boundary is what makes span durations sum to the recorded
        end-to-end latency)."""
        t = self._clock() if t is None else t
        if from_name is not None:
            self.end(trace_id, from_name, t=t, **attrs)
        if to_name is not None:
            self.begin(trace_id, to_name, t=t)

    def record_span(self, name: str, t0: float, t1: float,
                    kind: str = KIND_STEP,
                    trace_id: Optional[int] = None, **attrs: Any) -> None:
        """Record an already-completed interval (engine step windows)."""
        self.recorder.record(
            Span(trace_id, name, kind, t0, max(t1, t0), attrs or None))

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)


class _NullTracer:
    """The disabled path: every method is a no-op, ``enabled`` is False.
    Engines guard instrumentation with ``if self.tracer.enabled`` so the
    per-call cost with tracing off is one attribute read."""

    enabled = False
    label = "disabled"
    recorder = FlightRecorder(1)

    def begin(self, *a: Any, **k: Any) -> None:
        pass

    def end(self, *a: Any, **k: Any) -> None:
        pass

    def transition(self, *a: Any, **k: Any) -> None:
        pass

    def record_span(self, *a: Any, **k: Any) -> None:
        pass

    def open_count(self) -> int:
        return 0


NULL_TRACER = _NullTracer()


def make_tracer(trace_cfg, clock: Callable[[], float] = time.monotonic,
                label: str = "engine"):
    """Tracer for a ``TraceConfig`` (configs/base.py): a real ``Tracer``
    when enabled, the shared ``NULL_TRACER`` otherwise. Engines also flip
    the kernel-annotation flag here so device profiles carry kernel-level
    names (kernels/ops.py) without every engine repeating the wiring."""
    if trace_cfg is None or not trace_cfg.enable:
        return NULL_TRACER
    if trace_cfg.annotate_kernels:
        from repro_torch.kernels import ops

        ops.set_kernel_annotations(True)
    return Tracer(capacity=trace_cfg.capacity, clock=clock, label=label)


# -- export -----------------------------------------------------------------


def chrome_trace(recorders, t0: Optional[float] = None,
                 t1: Optional[float] = None) -> dict:
    """Render recorder windows as Chrome-trace JSON (Perfetto-loadable).

    ``recorders`` is a mapping ``{replica_label: FlightRecorder}`` (or a
    single recorder / tracer). Layout: one *process* (pid) per replica; in
    each process, thread 0 is the engine's per-program step track and every
    request gets its own thread (``tid = trace_id + 1``) so its phase spans
    read as one horizontal timeline. Timestamps are microseconds, as the
    format requires; span ``attrs`` land in ``args``.
    """
    if isinstance(recorders, (FlightRecorder, Tracer, _NullTracer)):
        rec = getattr(recorders, "recorder", recorders)
        recorders = {getattr(recorders, "label", "engine"): rec}
    events: List[dict] = []
    for pid, (label, rec) in enumerate(sorted(recorders.items())):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 0, "args": {"name": "engine steps"}})
        named_tids = set()
        for s in rec.spans(t0, t1):
            tid = 0 if s.trace_id is None else int(s.trace_id) + 1
            if tid and tid not in named_tids:
                named_tids.add(tid)
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": f"request {s.trace_id}"},
                })
            ev = {
                "ph": "X",
                "name": s.name,
                "cat": s.kind,
                "ts": s.t0 * 1e6,
                "dur": max(0.0, s.dur) * 1e6,
                "pid": pid,
                "tid": tid,
            }
            if s.attrs:
                ev["args"] = dict(s.attrs)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, recorders, t0: Optional[float] = None,
                       t1: Optional[float] = None) -> dict:
    doc = chrome_trace(recorders, t0, t1)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# -- validation --------------------------------------------------------------


def validate_chrome_trace(doc: dict) -> int:
    """Schema check for an exported trace: returns the number of duration
    events, raises ``ValueError`` on malformed structure."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("chrome trace must be an object with traceEvents")
    n = 0
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"malformed event: {ev!r}")
        if ev["ph"] == "M":
            if "name" not in ev or "args" not in ev:
                raise ValueError(f"malformed metadata event: {ev!r}")
            continue
        if ev["ph"] != "X":
            raise ValueError(f"unexpected phase {ev['ph']!r}")
        for key in ("name", "ts", "dur", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"duration event missing {key!r}: {ev!r}")
        if ev["dur"] < 0:
            raise ValueError(f"negative duration: {ev!r}")
        n += 1
    return n


def request_timelines(spans: Iterable[Span]) -> Dict[int, List[Span]]:
    """Group request-phase spans by trace id, each timeline sorted by
    start time (step spans are excluded)."""
    out: Dict[int, List[Span]] = {}
    for s in spans:
        if s.kind == KIND_REQUEST and s.trace_id is not None:
            out.setdefault(s.trace_id, []).append(s)
    for tl in out.values():
        tl.sort(key=lambda s: (s.t0, REQUEST_PHASES.index(s.name)
                               if s.name in REQUEST_PHASES else -1))
    return out


def validate_request_timelines(spans: Iterable[Span],
                               eps: float = 1e-9) -> int:
    """The acceptance invariant: every request's spans are non-overlapping,
    phase-ordered (a subsequence of ``REQUEST_PHASES``), and contiguous
    phases share boundaries. Returns the number of validated requests;
    raises ``ValueError`` with the offending trace id otherwise."""
    timelines = request_timelines(spans)
    for tid, tl in timelines.items():
        last_t1 = None
        last_rank = -1
        for s in tl:
            if s.name not in REQUEST_PHASES:
                raise ValueError(f"request {tid}: unknown phase {s.name!r}")
            rank = REQUEST_PHASES.index(s.name)
            if rank <= last_rank:
                raise ValueError(
                    f"request {tid}: phase {s.name!r} out of order")
            last_rank = rank
            if s.t1 < s.t0 - eps:
                raise ValueError(f"request {tid}: span {s.name!r} ends "
                                 "before it starts")
            if last_t1 is not None and s.t0 < last_t1 - eps:
                raise ValueError(
                    f"request {tid}: span {s.name!r} overlaps the previous "
                    f"phase ({s.t0} < {last_t1})")
            last_t1 = s.t1
    return len(timelines)
