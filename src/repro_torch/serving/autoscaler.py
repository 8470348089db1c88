"""Target-range autoscaling admission controller, ported from
``repro.serving.autoscaler`` (the same control law).

``Autoscaler`` is a small hysteretic controller over a ``ServingCluster``
that watches two pressure signals:

  * **front-end queue depth** per active replica (requests the router
    could not place because every replica's admission is full), sampled on
    the route path by ``ClusterMetrics.observe_queue_depth``;
  * **windowed pooled p95 request latency** vs the SLO. The window is the
    difference of two pooled latency histograms (live replicas + the
    retired accumulator, ``ClusterMetrics.pooled_request_hist``): a drained
    replica's samples fold into the retired histogram, so the pooled total
    is monotone and the delta between two evaluations is exactly that
    window's latency population, whichever replicas served it.

Control law (evaluated once per ``tick()``):

  scale **up** when ``depth > depth_high * n_active`` OR ``p95 > slo``,
  sustained for ``up_patience`` consecutive evaluations: the cluster
  promotes a pre-warmed standby replica into the router (only an empty
  pool builds one cold).

  scale **down** when total load (front + replicas) is at/below
  ``depth_low`` AND ``p95 < down_margin * slo`` (or no window yet),
  sustained for ``down_patience`` evaluations: the cluster stops routing
  to the least-loaded replica and drains it; its queued and in-flight
  requests are served to completion, then it returns to standby.

  After any action the controller holds for ``cooldown`` evaluations, and
  the replica count is clamped to ``[min_replicas, max_replicas]``.

The controller is host-side bookkeeping driven by the cluster's injectable
clock, so tests run it deterministically under a fake clock. Watchdog
evictions bypass it: ``ServingCluster.quarantine`` promotes a standby
directly, so the cooldown never delays recovery, and ``scale_down`` refuses
while the cluster is degraded.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import AutoscaleConfig
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.events import EventLog
from repro_torch.serving.metrics import hist_percentile


class Autoscaler:
    """Hysteretic target-range controller over a ``ServingCluster``.

    ``event_log`` (defaults to the cluster's ``EventLog``, when it has one)
    receives one ``scale_up`` / ``scale_down`` record per decision carrying
    the controller inputs that triggered it, answering "why did the cluster
    scale here" from the journal alone."""

    def __init__(self, cluster: ServingCluster,
                 policy: Optional[AutoscaleConfig] = None,
                 event_log: Optional[EventLog] = None) -> None:
        self.cluster = cluster
        self.policy = policy or AutoscaleConfig()
        self.event_log = (event_log if event_log is not None
                          else getattr(cluster, "events", None))
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self._window_hist: Optional[np.ndarray] = None
        self._p95_ms = float("nan")
        self._evals_since_close = 0
        # (t, action, active-count-after) -- "up" | "down"
        self.events: List[Tuple[float, str, int]] = []

    # -- signals -------------------------------------------------------------

    @property
    def window_p95_ms(self) -> float:
        """Last windowed pooled p95 estimate (nan before enough samples)."""
        return self._p95_ms

    def _update_p95(self) -> float:
        pooled = self.cluster.metrics.pooled_request_hist()
        if self._window_hist is None:
            self._window_hist = np.zeros_like(pooled)
        delta = pooled - self._window_hist
        n = int(delta.sum())
        if n >= self.policy.min_window_samples:
            # enough samples: close the window, advance its start
            self._p95_ms = hist_percentile(delta, 95.0) * 1e3
            self._window_hist = pooled
            self._evals_since_close = 0
        else:
            # no window close: the estimate ages out after p95_ttl
            # evaluations -- a p95 measured during a surge must not keep
            # reading as a live SLO breach once traffic has stopped (that
            # would scale an idle cluster up and block scale-down forever)
            self._evals_since_close += 1
            if self._evals_since_close > self.policy.p95_ttl:
                self._p95_ms = float("nan")
        return self._p95_ms

    # -- control law ---------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One control evaluation; returns "up" / "down" when the cluster
        was scaled this tick, else None. Call it from the serving pump (one
        evaluation per pump, or rate-limit it upstream)."""
        c, p = self.cluster, self.policy
        n = c.num_replicas
        depth = c.depth
        p95 = self._update_p95()
        slo_breach = not math.isnan(p95) and p95 > p.slo_p95_ms
        pressure = depth > p.depth_high * n or slo_breach
        relaxed = (c.total_load <= p.depth_low
                   and (math.isnan(p95)
                        or p95 < p.down_margin * p.slo_p95_ms))
        if pressure:
            self._up_streak += 1
            self._down_streak = 0
        elif relaxed:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if (self._up_streak >= p.up_patience and n < p.max_replicas
                and c.scale_up()):
            self._log_decision("scale_up", n, depth, p95, slo_breach)
            self._up_streak = 0
            self._cooldown = p.cooldown
            self.events.append((c.clock(), "up", c.num_replicas))
            return "up"
        if (self._down_streak >= p.down_patience and n > p.min_replicas
                and c.scale_down()):
            self._log_decision("scale_down", n, depth, p95, slo_breach)
            self._down_streak = 0
            self._cooldown = p.cooldown
            self.events.append((c.clock(), "down", c.num_replicas))
            return "down"
        return None

    def _log_decision(self, action: str, n_before: int, depth: int,
                      p95: float, slo_breach: bool) -> None:
        """Journal one scale decision with the controller inputs that
        produced it (streaks still hold their pre-reset values here)."""
        if self.event_log is None:
            return
        c, p = self.cluster, self.policy
        self.event_log.emit(
            action, t=c.clock(),
            replicas_before=n_before, replicas_after=c.num_replicas,
            depth=depth, total_load=c.total_load,
            p95_ms=None if math.isnan(p95) else p95,
            slo_p95_ms=p.slo_p95_ms, slo_breach=slo_breach,
            up_streak=self._up_streak, down_streak=self._down_streak)

    def state(self) -> dict:
        """Controller observability snapshot."""
        return {
            "replicas": self.cluster.num_replicas,
            "standby": self.cluster.standby_replicas,
            "draining": self.cluster.draining_replicas,
            "depth": self.cluster.depth,
            "total_load": self.cluster.total_load,
            "p95_ms": self._p95_ms,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "cooldown": self._cooldown,
        }
