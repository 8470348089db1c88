"""Structured serving event log, a framework-free copy of
``repro.serving.events``: ``EventLog`` and ``read_jsonl``.

``EventLog`` is the serving stack's decision journal: it answers "why did
the system do that" -- every autoscaler scale_up/scale_down with the
controller inputs that triggered it, every admission rejection, deadline
cancellation, drain completion, retirement fault and eviction, as one
append-only sequence of typed records.

Records are plain dicts ``{"t": <clock seconds>, "type": <str>, ...}``.
The log keeps a bounded in-memory ring (newest window wins, ``dropped``
counts evictions) and can *stream* to a JSONL sink as events are emitted
(``path=``), so a crashed process still leaves its decision trail on disk.
``emit`` is thread-safe: the retirement thread logs faults while the
control loop logs scale decisions.

Event types in use (producers add fields freely; ``type`` + ``t`` are the
only required keys):

  scale_up / scale_down  -- autoscaler decisions, with the controller
                            inputs (depth, windowed p95, streaks, load)
  replica_drained        -- a scale_down target finished draining and
                            returned to standby
  reject                 -- engine admission rejection (unservable prompt
                            or backpressure), with the reason
  cluster_reject         -- front-end admission rejection
  cancel                 -- deadline cancellation (queued or mid-
                            generation: ``where`` says which)
  retire_error           -- a poisoned retirement event (the thread
                            survived; the payload is lost)
  callback_error         -- a request's on_done callback raised
  replica_step_error     -- a replica step() raised (watchdog input)
  replica_evicted        -- watchdog quarantine, with the full verdict
                            (reason, error/stall streaks, EMA, last error)
  replica_replaced       -- standby promoted to backfill an eviction
  request_redispatched   -- an evicted in-flight request re-queued
  request_failed         -- retry budget exhausted: terminal failed status
  cluster_degraded       -- eviction with no standby left (admission
                            tightens); cluster_recovered on scale_up
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class EventLog:
    """Bounded, thread-safe, optionally file-backed event journal."""

    def __init__(self, capacity: int = 65536, path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._total = 0
        self._clock = clock
        self._path = path
        self._sink = open(path, "w") if path else None

    def emit(self, etype: str, t: Optional[float] = None,
             **fields: Any) -> Dict[str, Any]:
        """Append one event (and stream it to the sink when file-backed).
        ``t`` defaults to the injected clock -- pass the producer's own
        timestamp when it already read the clock this tick."""
        ev = {"t": self._clock() if t is None else float(t),
              "type": str(etype)}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self._total += 1
            if self._sink is not None:
                self._sink.write(json.dumps(ev, default=_jsonable) + "\n")
                self._sink.flush()
        return ev

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._total - len(self._ring)

    def events(self, etype: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of the retained window, optionally filtered by type."""
        with self._lock:
            out = list(self._ring)
        if etype is not None:
            out = [e for e in out if e["type"] == etype]
        return out

    def counts(self) -> Dict[str, int]:
        """Event-type histogram of the retained window."""
        out: Dict[str, int] = {}
        for e in self.events():
            out[e["type"]] = out.get(e["type"], 0) + 1
        return out

    def write_jsonl(self, path: str) -> int:
        """Dump the retained window to ``path`` (one JSON object per
        line); returns the number of events written. Independent of the
        streaming sink -- use it to snapshot an in-memory log at exit."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, default=_jsonable) + "\n")
        return len(evs)

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None


def _jsonable(x: Any):
    """Fallback serializer: numpy scalars and anything else stringify."""
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(x)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL event file (benchmark/CI artifact checks)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
