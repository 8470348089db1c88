"""Engine-agnostic replica protocol, ported from ``repro.serving.replica``.

``ServingCluster`` fronts N engine replicas without knowing which model
family they serve: everything the cluster (and the autoscaler) touches is
the ``EngineReplica`` surface below. ``VisionEngine`` (batched MoE-ViT
classification) and ``ServeEngine`` (slot-based LM decode) both implement
it, so one front-end multiplexes either workload.

The contract, all host-side:

  =================  ======================================================
  ``submit(req)``    admit one request; raise ``scheduler.Backpressure``
                     when the replica's own bound is hit; preserve an
                     upstream ``req.submitted_at`` stamp
  ``step()``         one non-blocking pump: admit / dispatch / retire
  ``warmup()``       build every program outside the measured path
  ``flush()``        serve everything queued + in flight (blocking drain)
  ``load``           queued + in-flight requests -- the least-loaded routing
                     key. Vision: queue depth + in-flight batch rows; LM:
                     queue depth + occupied decode slots
  ``free_room``      admission headroom before ``submit`` raises (inf when
                     unbounded). LM replicas count free decode slots here --
                     decode slots are the load signal
  ``idle``           nothing queued and nothing in flight (public surface:
                     the cluster never reads private engine state)
  ``metrics``        the replica's ``EngineMetrics`` (merge-safe roll-up)
  ``reset_metrics``  fresh ``EngineMetrics`` after the cluster folds the old
                     one into its retired accumulator (replica leave)
  ``device``         the ``torch.device`` the replica is pinned to (the
                     reference's ``mesh``, its device-mesh slice)
  =================  ======================================================

``isinstance(obj, EngineReplica)`` is a runtime structural check (method /
attribute presence), used by the conformance tests and by ``ServingCluster``
to validate custom engine factories.

Observability attributes are not part of the protocol: ``tracer`` and
``events`` are optional -- the cluster reads them with
``getattr(engine, "tracer", None)``, so a minimal custom replica (or a test
fake) conforms without carrying the tracing machinery.

``evict()`` is optional too: a replica that implements it returns its
stranded queued + in-flight requests -- marked ``evicted``, without running
further device work -- when the cluster quarantines it; the cluster
re-dispatches them to healthy replicas. The cluster finds it with
``getattr(engine, "evict", None)``; a replica without it loses its in-flight
work on eviction (the at-most-once guard still keeps a duplicate
retirement from being delivered).
"""
from __future__ import annotations

from typing import Any, Optional, Protocol, runtime_checkable

import torch

from repro_torch.serving.metrics import EngineMetrics


@runtime_checkable
class EngineReplica(Protocol):
    """Structural protocol every cluster-manageable engine implements."""

    metrics: EngineMetrics
    device: Optional[torch.device]

    def submit(self, req: Any) -> None:
        """Admit one request (raises ``Backpressure`` at the bound)."""
        ...

    def step(self) -> None:
        """One non-blocking pump: admit, dispatch, retire."""
        ...

    def warmup(self) -> None:
        """Build every program outside the measured path."""
        ...

    def flush(self) -> None:
        """Blocking drain: serve everything queued and in flight."""
        ...

    def reset_metrics(self) -> None:
        """Replace ``metrics`` with a fresh instance (cluster replica
        leave: the old one was folded into the retired accumulator)."""
        ...

    @property
    def load(self) -> float:
        """Queued + in-flight requests (least-loaded routing key)."""
        ...

    @property
    def free_room(self) -> float:
        """Admission headroom before ``submit`` raises (inf = unbounded)."""
        ...

    @property
    def idle(self) -> bool:
        """True when nothing is queued and nothing is in flight."""
        ...
