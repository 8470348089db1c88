"""Fault-tolerance utilities, ported from
``repro.distributed.fault_tolerance``: the preemption hook, the straggler
monitor, step retry and ``elastic_mesh`` (over the port's ``Mesh``).

The failure model: (a) planned preemptions (a signal) -- stop admission,
finish what was accepted and exit clean; (b) hard loss of a replica -- the
serving cluster's watchdog evicts it (``serving/faults.py``); (c) stragglers
-- detected from a per-step wall-time EMA and surfaced, so that the caller
can replace the slow worker.
"""
from __future__ import annotations

import math
import signal
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.launch.mesh import Mesh, visible_devices


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a drain flag the serving loop polls."""

    def __init__(self, signals=(signal.SIGTERM,)) -> None:
        self._requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:  # testable without raising a real signal
        self._requested = True


class StragglerMonitor:
    """Per-step wall-time EMA; flags steps slower than ``threshold`` x EMA.
    A flagged step stays out of the EMA, so one slow step does not mask the
    next."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup_steps: int = 5) -> None:
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.count = 0
        self.events: List[dict] = []

    def record(self, duration_s: float, host_id: int = 0,
               step: int = -1) -> bool:
        """Returns True when this measurement is a straggler event."""
        self.count += 1
        if self.ema is None:
            self.ema = duration_s
            return False
        is_slow = (
            self.count > self.warmup
            and duration_s > self.threshold * self.ema
        )
        if is_slow:
            self.events.append(
                {"step": step, "host": host_id, "duration": duration_s,
                 "ema": self.ema}
            )
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * duration_s
        return is_slow


def run_step_with_retry(fn: Callable, *args, max_retries: int = 2,
                        on_retry: Optional[Callable] = None,
                        sleep: Callable[[float], None] = time.sleep):
    """Retry a step on transient runtime errors (an allocator spike, a flaky
    launch). ``RuntimeError`` covers PyTorch's runtime errors, CUDA's out of
    memory included. Backoff is 0.1 * 2**attempt seconds via ``sleep``
    (injectable, so a test asserts the schedule without waiting it out)."""
    for attempt in range(max_retries + 1):
        try:
            return fn(*args)
        except RuntimeError:
            if attempt == max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt)
            sleep(0.1 * 2**attempt)


def elastic_mesh(preferred_shape, axis_names, devices=None) -> Mesh:
    """The largest mesh of ``preferred_shape``'s aspect that fits the
    devices (every visible card by default): lose a host, keep going. The
    data (first) axis shrinks first, halving, and the model axis is kept,
    since the model-parallel degree is baked into the layout while the
    data-parallel degree is free."""
    devices = visible_devices(devices)
    n = len(devices)
    shape = list(preferred_shape)
    while math.prod(shape) > n and shape[0] > 1:
        shape[0] //= 2
    if math.prod(shape) > n:
        raise ValueError(
            f"cannot fit mesh {preferred_shape} on {n} devices even after "
            f"shrinking the data axis")
    use = math.prod(shape)
    return Mesh(np.asarray(devices[:use], dtype=object).reshape(shape), axis_names)
