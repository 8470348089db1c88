"""Serving fault model, ported from ``repro.serving.faults``: deterministic
chaos injection + the replica watchdog.

Two halves, configured by one ``FaultConfig`` (``configs/base.py``):

**Chaos injection** -- ``FaultInjector`` is a seedable fault source attached
to one replica. ``ServingCluster`` turns it on by wrapping every replica it
builds in a ``FaultyReplica`` when ``cfg.faults.inject`` is on; the wrapper
injects at the replica *boundary* (the surface the ``EngineReplica``
protocol defines), so the engines stay fault-free and any custom replica
can be chaos-tested:

  * ``step()``  -- raise ``InjectedFault`` (transient step error), raise
    ``InjectedOOM`` (an allocation failure), stall for ``stall_s`` before
    running (through a pluggable ``stall_fn``, so fake-clock tests advance
    time instead of sleeping), or die for good (``"dead"``: every later
    step raises too, a crashed process rather than a transient fault);
  * ``submit()`` -- raise ``scheduler.Backpressure`` (a replica refusing
    admission it advertised room for);
  * ``on_done`` -- poison the callback: the user callback runs, then the
    wrapper raises (the retirement thread must survive and count it).

Faults fire from per-rate Bernoulli draws of a generator seeded with
``(seed, replica_ordinal)`` -- the whole chaos run is a function of the
config -- or from the explicit ``kill_schedule`` (replica_ordinal,
local_step, kind) triples, which override the draws at their step. With
``inject`` off, nothing is wrapped.

**Watchdog** -- ``ReplicaWatchdog`` is the per-replica health monitor the
cluster consults around every ``step()``: a consecutive-error budget (an
OOM-classified error evicts at once), plus a stall detector combining an
absolute step timeout with ``StragglerMonitor``'s EMA-relative threshold
(``distributed/fault_tolerance.py``). ``record_step`` / ``record_error``
return an eviction *verdict* dict (every watchdog input, journaled into the
``replica_evicted`` event) when a budget is exhausted; the cluster then
takes the ``quarantine()`` path (``serving/cluster.py``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FaultConfig
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.serving.scheduler import Backpressure


class InjectedFault(RuntimeError):
    """A chaos-harness fault: transient replica step/submit failure."""


class InjectedOOM(InjectedFault):
    """A chaos-harness allocation failure, shaped like a runtime's
    RESOURCE_EXHAUSTED so OOM classification paths treat it as real."""


def is_oom_error(exc: BaseException) -> bool:
    """Whether an exception is a device allocation failure: CUDA's
    ``torch.cuda.OutOfMemoryError`` by type, an injected OOM, or a message
    that says so."""
    if isinstance(exc, (InjectedOOM, torch.cuda.OutOfMemoryError)):
        return True
    msg = repr(exc).upper()
    return "RESOURCE_EXHAUSTED" in msg or "OUT OF MEMORY" in msg


class FaultInjector:
    """Seeded per-replica fault source (see module docstring).

    ``stall_fn`` implements the injected hang: ``time.sleep`` by default,
    a fake clock's ``advance`` in deterministic tests -- either way the
    watchdog sees a step that took ``stall_s`` on *its* clock.
    """

    enabled = True

    def __init__(self, cfg: FaultConfig, ordinal: int = 0,
                 stall_fn: Optional[Callable[[float], None]] = None) -> None:
        self.cfg = cfg
        self.ordinal = int(ordinal)
        self._rng = np.random.default_rng((cfg.seed, self.ordinal))
        self._stall = stall_fn if stall_fn is not None else time.sleep
        self._step = 0
        self.dead = False
        # per-kind injection counts: the proof that a chaos run exercised
        # each fault class
        self.injected: Dict[str, int] = {}
        self._schedule = {
            int(step): kind
            for (ordn, step, kind) in cfg.kill_schedule
            if int(ordn) == self.ordinal
        }

    def _count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def _draw(self, rate: float) -> bool:
        return rate > 0.0 and float(self._rng.random()) < rate

    def before_step(self) -> None:
        """Called at the top of every replica ``step()``; raises or stalls
        per the schedule/rates. A dead replica raises forever."""
        self._step += 1
        if self.dead:
            raise InjectedFault(
                f"replica ordinal {self.ordinal} is dead (scheduled kill)")
        kind = self._schedule.get(self._step)
        if kind is None:
            cfg = self.cfg
            if self._draw(cfg.step_error_rate):
                kind = "error"
            elif self._draw(cfg.oom_rate):
                kind = "oom"
            elif self._draw(cfg.step_stall_rate):
                kind = "stall"
        if kind is None:
            return
        if kind == "dead":
            self.dead = True
            self._count("dead")
            raise InjectedFault(
                f"replica ordinal {self.ordinal} killed at step {self._step}")
        if kind == "error":
            self._count("error")
            raise InjectedFault(
                f"injected step error (ordinal {self.ordinal}, "
                f"step {self._step})")
        if kind == "oom":
            self._count("oom")
            raise InjectedOOM(
                f"RESOURCE_EXHAUSTED: injected allocation failure "
                f"(ordinal {self.ordinal}, step {self._step})")
        if kind == "stall":
            self._count("stall")
            self._stall(self.cfg.stall_s)
            return
        raise ValueError(f"unknown fault kind in kill_schedule: {kind!r}")

    def on_submit(self) -> bool:
        """True = reject this submit (the wrapper raises Backpressure)."""
        if self._draw(self.cfg.submit_reject_rate):
            self._count("submit_reject")
            return True
        return False

    def wrap_callback(self, cb: Optional[Callable]) -> Optional[Callable]:
        """Maybe poison a request's ``on_done``: the original callback (if
        any) still runs -- the terminal event must be *delivered* -- then the
        wrapper raises, exercising the retirement daemon's error path."""
        if not self._draw(self.cfg.callback_poison_rate):
            return cb
        self._count("callback_poison")

        def poisoned(req, _cb=cb):
            if _cb is not None:
                _cb(req)
            raise InjectedFault("injected poisoned on_done callback")

        return poisoned


class FaultyReplica:
    """Chaos decorator around an ``EngineReplica``: delegates the whole
    protocol surface, injecting at the submit/step boundaries. Everything
    not explicitly wrapped (``events``, ``queue``, ``active``, ``evict``,
    ...) passes through to the inner engine."""

    def __init__(self, inner: Any, injector: FaultInjector) -> None:
        self.inner = inner
        self.injector = injector

    # -- injected boundaries -------------------------------------------------

    def submit(self, req) -> None:
        if self.injector.on_submit():
            raise Backpressure("injected submit rejection")
        cb = getattr(req, "on_done", None)
        poisoned = self.injector.wrap_callback(cb)
        if poisoned is not cb:
            req.on_done = poisoned
        self.inner.submit(req)

    def step(self) -> None:
        self.injector.before_step()
        self.inner.step()

    def flush(self) -> None:
        # a dead replica cannot drain -- the cluster's flush loop routes the
        # failure through the watchdog/quarantine path instead
        if self.injector.dead:
            raise InjectedFault(
                f"replica ordinal {self.injector.ordinal} is dead")
        self.inner.flush()

    run_until_drained = flush

    # -- plain delegation ----------------------------------------------------

    def warmup(self) -> None:
        self.inner.warmup()

    def reset_metrics(self) -> None:
        self.inner.reset_metrics()

    @property
    def metrics(self):
        return self.inner.metrics

    @property
    def device(self):
        return self.inner.device

    @property
    def load(self):
        return self.inner.load

    @property
    def free_room(self):
        return self.inner.free_room

    @property
    def idle(self):
        return self.inner.idle

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class ReplicaWatchdog:
    """Per-replica health monitor (cluster-side, pure host bookkeeping).

    The cluster wraps every routed ``step()`` in a clock read + one of
    ``record_step`` / ``record_error``. Both return ``None`` while the
    replica is healthy, or an eviction **verdict** -- a dict carrying the
    reason plus every watchdog input (the ``replica_evicted`` event
    payload) -- once a budget is exhausted:

      * ``record_error``: consecutive step exceptions reach
        ``error_budget`` (an OOM-classified error evicts on the first hit:
        retrying into a full allocator wedges the pump);
      * ``record_step``: consecutive stalls reach ``stall_budget``, where
        a stall is a step over the absolute ``step_timeout_s`` OR over
        ``stall_threshold`` x the healthy-step EMA (``StragglerMonitor``
        with stalls excluded from the EMA, armed after ``warmup_steps``).

    A successful step resets the error streak; a healthy-speed step resets
    the stall streak.
    """

    def __init__(self, cfg: FaultConfig, label: str = "replica?") -> None:
        self.cfg = cfg
        self.label = label
        self._straggler = StragglerMonitor(
            alpha=0.2, threshold=cfg.stall_threshold,
            warmup_steps=cfg.warmup_steps)
        self.steps = 0
        self.consecutive_errors = 0
        self.consecutive_stalls = 0
        self.last_step_s = 0.0
        self.last_error: Optional[str] = None

    def record_step(self, duration_s: float) -> Optional[dict]:
        """A step that returned; verdict when the stall budget trips.

        The relative verdict only counts above ``stall_floor_s``: a
        serving pump spins through idle no-op ticks whose microsecond
        durations seed the EMA, and without the floor any step that does
        real work reads as a many-x relative stall."""
        self.steps += 1
        self.last_step_s = float(duration_s)
        self.consecutive_errors = 0
        slow_rel = (self._straggler.record(duration_s, step=self.steps)
                    and duration_s > self.cfg.stall_floor_s)
        slow_abs = duration_s > self.cfg.step_timeout_s
        if slow_rel or slow_abs:
            self.consecutive_stalls += 1
            if self.consecutive_stalls >= self.cfg.stall_budget:
                return self._verdict("stalled")
        else:
            self.consecutive_stalls = 0
        return None

    def record_error(self, exc: BaseException) -> Optional[dict]:
        """A step that raised; verdict when the error budget trips."""
        self.consecutive_errors += 1
        self.last_error = repr(exc)
        oom = is_oom_error(exc)
        budget = 1 if oom else self.cfg.error_budget
        if self.consecutive_errors >= budget:
            return self._verdict("oom" if oom else "step_errors")
        return None

    def state(self) -> dict:
        """The watchdog inputs -- ``health()``'s per-replica detail and the
        eviction-event payload."""
        suspect = (self.consecutive_errors > 0
                   or self.consecutive_stalls > 0)
        return {
            "health": "suspect" if suspect else "healthy",
            "steps": self.steps,
            "consecutive_errors": self.consecutive_errors,
            "consecutive_stalls": self.consecutive_stalls,
            "last_step_s": self.last_step_s,
            "step_ema_s": self._straggler.ema,
            "last_error": self.last_error,
        }

    def _verdict(self, reason: str) -> dict:
        return {"reason": reason, **self.state()}
