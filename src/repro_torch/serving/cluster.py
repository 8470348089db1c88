"""Engine-agnostic multi-replica serving cluster, ported from
``repro.serving.cluster``.

``ServingCluster`` runs N engine replicas behind one admission front-end:

  client -> cluster ``MicroBatcher`` (FIFO + global backpressure + drain)
         -> least-loaded routing (the replica with the smallest queued +
            in-flight load that still has admission room)
         -> replica (own scheduler, own programs, K/V cache and CUDA-graph
            pool on its device, own ``EngineMetrics``)

The cluster is generic over the ``EngineReplica`` protocol
(``serving/replica.py``): the replica factory is pluggable, and the default
builds ``VisionEngine`` replicas for the vit families and ``ServeEngine``
replicas (LM decode; free decode slots are the load signal) for the rest.

Replica layout (``replica_meshes``): the device list is split into
``replicas + standby`` contiguous groups of equal size, each a
``('model',)`` mesh (``launch/mesh.py``). A data-parallel replica is pinned
to its group's first device (``replica_devices``); with more replicas than
devices, replicas share devices (host-side concurrency: several replicas
time-share one card). With ``cfg.moe.moe_exec == "expert_parallel"`` each
replica takes its whole group as its EP mesh (by default one replica over
every entry of ``devices``, which may name one card several times) and
runs the sharded-expert exchange of ``distributed/expert_parallel.py``
over it; an EP replica grown past the pool spans the whole device list.
Replicas on one device share one copy of the weights (the engines'
``tree_to`` keeps a tensor already on the device) and each keeps its own
cache, graph pool and capture stream.

Backpressure is two-level: each replica bounds its own admission
(``max_pending_per_replica``; the router only offers work to replicas with
room) and the front-end bounds total admission (``max_pending``; beyond it
``submit`` raises ``scheduler.Backpressure`` to the client).

**Elasticity** (``serving/autoscaler.py`` drives it): ``scale_up()`` moves a
pre-warmed standby replica into the router (or builds and warms a new one
when the pool is empty); ``scale_down()`` stops routing to the least-loaded
replica and moves it to the *draining* set: it is ticked until it has
served everything queued and in flight, then returns to standby, its
metrics folded into ``ClusterMetrics``' retired accumulator.
``ClusterMetrics.mark_replicas`` records the (t, active-count) timeline.

**Fault tolerance** (``serving/faults.py``): with ``FaultConfig.watchdog``
on (the default), every replica ``step()`` runs under a
``ReplicaWatchdog``: consecutive step exceptions past the error budget (an
OOM at once), or consecutive stalls past the stall budget, take the
``quarantine()`` path: the replica leaves the router without being ticked
again (it may be wedged), its metrics fold into the retired accumulator,
its stranded requests are reclaimed through the optional ``evict()`` and
re-dispatched to healthy replicas (within ``retry_budget``, then terminal
``failed``), and a standby is promoted at once, not through the
autoscaler, whose cooldown must not delay recovery. ``on_done`` delivery is
at-most-once cluster-wide: ``submit`` wraps the callback with an idempotent
guard, so a duplicate retirement is counted, not delivered. With no standby
left the cluster is *degraded*: admission tightens to what the surviving
replicas can absorb, ``health()`` reports ``degraded`` with the eviction
ledger, and ``scale_down`` refuses. ``FaultConfig.inject`` also wraps each
replica in the seeded chaos ``FaultyReplica``.

Tracing: the cluster assigns every request a cluster-wide trace id and
mirrors each replica's stable label (``replicaN``) onto its engine's
tracer; ``flight_recorders()`` collects every tracing replica's recorder
(evicted replicas' too) and ``export_trace()`` writes one Chrome-trace
process per replica.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs.base import FaultConfig, ModelConfig
from repro_torch.launch.mesh import Mesh, visible_devices
from repro_torch.serving.events import EventLog
from repro_torch.serving.faults import FaultInjector, FaultyReplica, ReplicaWatchdog
from repro_torch.serving.metrics import ClusterMetrics
from repro_torch.serving.replica import EngineReplica
from repro_torch.serving.scheduler import Backpressure, MicroBatcher
from repro_torch.serving.trace import FlightRecorder, write_chrome_trace

# a data-parallel replica's device, or an expert-parallel replica's mesh,
# -> replica
EngineFactory = Callable[[Union[torch.device, Mesh]], EngineReplica]


def replica_meshes(n_replicas: int, devices=None) -> List[Mesh]:
    """The device list (every visible card by default) split into
    ``n_replicas`` contiguous equal groups, each a 1-axis ``('model',)``
    mesh. More replicas than devices is allowed: replicas then share
    devices round-robin, one device a mesh (host-side concurrency only)."""
    devices = visible_devices(devices)
    n = max(1, int(n_replicas))
    if len(devices) >= n:
        per = len(devices) // n
        groups = [devices[i * per:(i + 1) * per] for i in range(n)]
    else:
        groups = [[devices[i % len(devices)]] for i in range(n)]
    return [Mesh(g, ("model",)) for g in groups]


def replica_devices(n_replicas: int, devices=None) -> List[torch.device]:
    """The device of each of ``n_replicas`` data-parallel replicas: the
    first device of its ``replica_meshes`` group."""
    return [m.devices.flat[0] for m in replica_meshes(n_replicas, devices)]


class ServingCluster:
    """N-replica serving cluster behind one admission queue, generic over
    the ``EngineReplica`` protocol."""

    def __init__(
        self,
        cfg: Optional[ModelConfig],
        params=None,
        *,
        replicas: int = 0,
        standby: int = 0,
        devices=None,
        engine: Union[None, str, EngineFactory] = None,
        # vision replica knobs (engine="vision")
        batch_buckets: Sequence[int] = (1, 4, 8),
        max_wait_s: float = 2e-3,
        top_k: int = 5,
        max_inflight: int = 2,
        # LM replica knobs (engine="lm")
        batch_slots: int = 4,
        max_len: int = 512,
        # shared admission bounds
        max_pending: int = 4096,
        max_pending_per_replica: int = 64,
        events: Optional[EventLog] = None,
        clock: Callable[[], float] = time.monotonic,
        # fault model (None -> cfg.faults when cfg is given, else defaults);
        # fault_stall_fn overrides the injected-stall sleep for fake-clock
        # tests (serving/faults.py)
        faults: Optional[FaultConfig] = None,
        fault_stall_fn: Optional[Callable[[float], None]] = None,
    ) -> None:
        devices = visible_devices(devices)
        self._devices = devices
        self._ep = (cfg is not None and cfg.moe is not None
                    and cfg.moe.moe_exec == "expert_parallel")
        if replicas <= 0:
            # default: one replica per device (data parallelism); expert
            # parallelism: one replica spanning every device
            replicas = 1 if self._ep else len(devices)
        self._clock = clock
        # observability: the shared event log (autoscaler decisions land
        # here too) and the cluster-global trace-id counter -- uids are
        # caller-chosen and may collide across clients, trace ids may not
        self.events = events
        self._next_trace_id = 0
        self._replica_seq = 0
        # id(engine) -> stable "replicaN" name; kept cluster-side so event
        # records name untraced replicas too (a tracer only mirrors it)
        self._labels: Dict[int, str] = {}
        # fault model: chaos injection (replica decorator) + watchdog state
        if faults is None:
            faults = (cfg.faults if cfg is not None
                      and getattr(cfg, "faults", None) is not None
                      else FaultConfig())
        self.faults = faults
        self._wd_enabled = bool(faults.watchdog)
        self._watchdogs: Dict[int, ReplicaWatchdog] = {}
        self._retire_lock = threading.Lock()  # at-most-once on_done guard
        self._degraded = False
        self._evicted: List[dict] = []  # eviction ledger (health())
        self._evicted_engines: List[EngineReplica] = []
        self._per_replica_cap = int(max_pending_per_replica)
        self._factory = self._resolve_factory(
            cfg, params, engine,
            batch_buckets=batch_buckets, max_wait_s=max_wait_s,
            top_k=top_k, max_inflight=max_inflight,
            batch_slots=batch_slots, max_len=max_len,
            max_pending_per_replica=max_pending_per_replica,
        )
        if faults.inject:
            # every replica this cluster ever builds (including autoscaler
            # cold-spawns) gets its own seeded injector; build order matches
            # label order so injector ordinals line up with "replicaN"
            base_factory = self._factory
            self._inject_seq = 0

            def chaotic(placement, _f=base_factory):
                inj = FaultInjector(self.faults, ordinal=self._inject_seq,
                                    stall_fn=fault_stall_fn)
                self._inject_seq += 1
                return FaultyReplica(_f(placement), inj)

            self._factory = chaotic
        self.meshes = self._build_meshes(replicas + standby)
        # the device each replica runs on (an EP replica: its slots' one)
        self.devices = [m.devices.flat[0] for m in self.meshes]
        self._next_device_i = replicas + standby
        built = [self._factory(m if self._ep else d)
                 for m, d in zip(self.meshes, self.devices)]
        for e in built:
            self._label_replica(e)
        self.engines: List[EngineReplica] = built[:replicas]  # routable
        self._standby: List[EngineReplica] = built[replicas:]  # warm pool
        self._tracing = any(
            getattr(e, "tracer", None) is not None
            and e.tracer.enabled for e in built)
        self._draining: List[EngineReplica] = []  # no admission, still ticked
        # admission front-end: FIFO + global backpressure + drain; routing
        # pulls single requests (batch formation happens per replica, where
        # the bucket ladder lives)
        self._front = MicroBatcher(
            batch_sizes=(1,), max_wait_s=0.0, max_pending=max_pending,
            clock=clock,
        )
        self.metrics = ClusterMetrics([e.metrics for e in self.engines],
                                      clock=clock)
        self.metrics.mark_replicas(len(self.engines))

    # -- construction internals ---------------------------------------------

    def _resolve_factory(self, cfg, params, engine, *, batch_buckets,
                         max_wait_s, top_k, max_inflight, batch_slots,
                         max_len, max_pending_per_replica) -> EngineFactory:
        if callable(engine):
            return engine
        if engine is None:
            if cfg is None:
                raise ValueError("engine factory required when cfg is None")
            engine = "vision" if cfg.family in ("vit", "vit_moe") else "lm"
        clock = self._clock
        events = self.events

        def place(p) -> dict:  # an EP replica takes its mesh
            return {"mesh": p} if isinstance(p, Mesh) else {"device": p}

        if engine == "vision":
            from repro_torch.serving.vision import VisionEngine

            return lambda p: VisionEngine(
                cfg, params,
                batch_buckets=batch_buckets, max_wait_s=max_wait_s,
                max_pending=max_pending_per_replica, top_k=top_k,
                max_inflight=max_inflight, events=events, clock=clock,
                **place(p),
            )
        if engine == "lm":
            from repro_torch.serving.engine import ServeEngine

            return lambda p: ServeEngine(
                cfg, params, batch_slots=batch_slots, max_len=max_len,
                max_pending=max_pending_per_replica, events=events,
                clock=clock, **place(p),
            )
        raise ValueError(
            f"engine must be 'vision', 'lm', or a factory: {engine!r}")

    def _label_replica(self, eng) -> None:
        """Stable replica name, mirrored onto the engine's tracer when it
        has one. Custom factories without a tracer attr are fine
        (EngineReplica does not require one); event records carry the
        cluster-side name."""
        label = f"replica{self._replica_seq}"
        self._replica_seq += 1
        self._labels[id(eng)] = label
        tr = getattr(eng, "tracer", None)
        if tr is not None and tr.enabled:
            tr.label = label

    def _build_meshes(self, n: int) -> List[Mesh]:
        meshes = replica_meshes(n, self._devices)
        if not self._ep:
            # without expert parallelism a multi-device slice would run the
            # same replicated program on each of its devices: pin each
            # replica to its first device instead
            meshes = [Mesh(list(m.devices.flat)[:1], ("model",)) for m in meshes]
        return meshes

    def _next_device(self) -> Union[torch.device, Mesh]:
        """Placement of a replica grown past the pre-built pool: an EP
        replica spans every device (the whole mesh); a data-parallel one
        takes a device no live replica is pinned to, falling back to
        round-robin only once every device is taken (blindly cycling
        indices would double up on an active replica's device while others
        sit free)."""
        if self._ep:
            return self._build_meshes(1)[0]
        used = {
            e.device for e in self.engines + self._draining + self._standby
            if e.device is not None
        }
        free = [d for d in self._devices if d not in used]
        if free:
            return free[0]
        d = self._devices[self._next_device_i % len(self._devices)]
        self._next_device_i += 1
        return d

    # -- properties ---------------------------------------------------------

    @property
    def clock(self) -> Callable[[], float]:
        return self._clock

    @property
    def num_replicas(self) -> int:
        """Routable (active) replicas."""
        return len(self.engines)

    @property
    def standby_replicas(self) -> int:
        return len(self._standby)

    @property
    def draining_replicas(self) -> int:
        return len(self._draining)

    @property
    def depth(self) -> int:
        """Requests held at the front-end (not yet routed to a replica)."""
        return self._front.depth

    @property
    def total_load(self) -> int:
        """Front-end depth + every serving replica's queued + in-flight."""
        return self._front.depth + sum(
            e.load for e in self.engines + self._draining)

    @property
    def idle(self) -> bool:
        return (self._front.depth == 0
                and all(e.idle for e in self.engines)
                and all(e.idle for e in self._draining))

    # -- elasticity (driven by serving/autoscaler.py) ------------------------

    def scale_up(self) -> bool:
        """Admit one more replica to the router. Preference order: (1)
        re-admit a *draining* replica -- it is warm, still holds devices, and
        re-admitting it keeps active + draining within the operator's cap
        instead of piling a new engine on top of one that has not left yet;
        (2) promote a pre-warmed standby; (3) cold-spawn. The cold-spawn
        branch warms (compiles) synchronously -- the pump that called it
        stalls for the compile, so size the standby pool to cover the
        expected surge (the autoscale benchmark sets
        ``standby = max_replicas - 1``) and treat cold spawns as a last
        resort, not the steady-state path."""
        if self._draining:
            eng = self._draining.pop()  # most recently drained
        elif self._standby:
            eng = self._standby.pop(0)
        else:
            eng = self._factory(self._next_device())
            self._label_replica(eng)
            eng.warmup()
        self.engines.append(eng)
        self.metrics.add_replica(eng.metrics)
        self.metrics.mark_replicas(len(self.engines))
        self.metrics.inc("cluster_scale_up")
        if self._degraded:
            # capacity restored: leave degraded mode (admission un-tightens)
            self._degraded = False
            if self.events is not None:
                self.events.emit("cluster_recovered",
                                 active=len(self.engines),
                                 standby=len(self._standby))
        return True

    def scale_down(self) -> bool:
        """Stop routing to the least-loaded replica and start draining it:
        it keeps being ticked until everything queued + in flight on it is
        served, then returns to standby (``_reap_drained``). Refuses to
        drop the last active replica, and refuses entirely while degraded --
        a cluster that just lost capacity to an eviction must not let the
        controller's scale-down streak fight the recovery."""
        if len(self.engines) <= 1 or self._degraded:
            return False
        eng = min(self.engines, key=lambda e: e.load)
        self.engines.remove(eng)
        self._draining.append(eng)
        self.metrics.mark_replicas(len(self.engines))
        self.metrics.inc("cluster_scale_down")
        return True

    def _reap_drained(self) -> None:
        """Move fully drained replicas to the standby pool, folding their
        metrics into the retired accumulator (then resetting them so a
        rejoin is never double-counted)."""
        still: List[EngineReplica] = []
        for e in self._draining:
            if e.idle:
                self.metrics.remove_replica(e.metrics)
                e.reset_metrics()
                self._standby.append(e)
                if self.events is not None:
                    self.events.emit(
                        "replica_drained",
                        replica=self._labels.get(id(e)),
                        active=len(self.engines),
                        standby=len(self._standby))
            else:
                still.append(e)
        self._draining = still

    # -- fault tolerance (serving/faults.py) ----------------------------------

    def _watchdog(self, eng) -> ReplicaWatchdog:
        wd = self._watchdogs.get(id(eng))
        if wd is None:
            wd = ReplicaWatchdog(
                self.faults, label=self._labels.get(id(eng), "replica?"))
            self._watchdogs[id(eng)] = wd
        return wd

    def _step_replica(self, eng) -> None:
        """Tick one replica under the watchdog: time the step, feed the
        outcome to the replica's monitor, quarantine on a verdict. With the
        watchdog disabled this is exactly ``eng.step()``."""
        if not self._wd_enabled:
            eng.step()
            return
        wd = self._watchdog(eng)
        t0 = self._clock()
        try:
            eng.step()
        except Exception as e:
            self.metrics.inc("replica_step_errors")
            if self.events is not None:
                self.events.emit("replica_step_error",
                                 replica=self._labels.get(id(eng)),
                                 error=repr(e))
            verdict = wd.record_error(e)
            if verdict is not None:
                self.quarantine(eng, verdict)
            return
        verdict = wd.record_step(self._clock() - t0)
        if verdict is not None:
            self.quarantine(eng, verdict)

    def quarantine(self, eng, verdict: Optional[dict] = None) -> None:
        """Evict a suspect replica NOW -- no drain, no further ticks (it may
        be wedged). Its metrics fold into the retired accumulator exactly as
        a drain would; its stranded queued/in-flight requests are reclaimed
        (optional replica ``evict()``) and re-dispatched to healthy
        replicas; capacity is backfilled from the standby pool directly --
        deliberately NOT via the autoscaler, whose cooldown must never
        delay recovery. With no standby left the cluster goes degraded."""
        if isinstance(verdict, str):
            verdict = {"reason": verdict}
        verdict = dict(verdict or {"reason": "manual"})
        was_active = eng in self.engines
        if was_active:
            self.engines.remove(eng)
        elif eng in self._draining:
            self._draining.remove(eng)
        else:
            return  # already quarantined/drained -- idempotent
        self.metrics.remove_replica(eng.metrics)
        try:
            eng.reset_metrics()
        except Exception:
            pass  # a wedged replica's reset must not abort the eviction
        stranded: List[Any] = []
        evict = getattr(eng, "evict", None)
        if callable(evict):
            try:
                stranded = list(evict())
            except Exception:
                pass  # best-effort reclaim; unreturned requests fail below
        self._watchdogs.pop(id(eng), None)
        self._evicted_engines.append(eng)  # keep its flight recorder
        label = self._labels.get(id(eng))
        self.metrics.inc("replicas_evicted")
        if self.events is not None:
            # full watchdog inputs ride along -- the eviction is replayable
            # from the journal
            self.events.emit("replica_evicted", replica=label,
                             stranded=len(stranded), **verdict)
        backfilled = None
        if was_active and self._standby:
            new = self._standby.pop(0)
            backfilled = self._labels.get(id(new))
            self.engines.append(new)
            self.metrics.add_replica(new.metrics)
            self.metrics.inc("replicas_replaced")
            if self.events is not None:
                self.events.emit("replica_replaced", evicted=label,
                                 replacement=backfilled,
                                 standby=len(self._standby))
        elif was_active:
            # serving capacity lost with no standby to promote: degrade
            if not self._degraded:
                self._degraded = True
                self.metrics.inc("cluster_degraded")
                if self.events is not None:
                    self.events.emit("cluster_degraded",
                                     active=len(self.engines),
                                     evicted=len(self._evicted) + 1)
        self._evicted.append({
            "t": self._clock(), "replica": label,
            "stranded": len(stranded), "backfilled": backfilled, **verdict,
        })
        self.metrics.mark_replicas(len(self.engines))
        for req in stranded:
            self._redispatch(req)

    def _redispatch(self, req) -> None:
        """Re-queue an evicted in-flight request at the front-end (original
        ``submitted_at`` stamp preserved -- client latency includes the
        failure), bounded by ``retry_budget`` re-dispatches, then terminal
        ``failed``."""
        req.redispatched = getattr(req, "redispatched", 0) + 1
        if req.redispatched > self.faults.retry_budget:
            self._fail(req, "retry_budget_exhausted")
            return
        req.evicted = False
        if hasattr(req, "eos_seen"):
            req.eos_seen = False
        if hasattr(req, "generated"):
            req.generated = None  # restart the stream from the prompt
        if getattr(req, "step_logits", None) is not None:
            req.step_logits = None  # the engine starts a fresh list
        self.metrics.inc("cluster_redispatched")
        if self.events is not None:
            self.events.emit("request_redispatched",
                             uid=getattr(req, "uid", None),
                             attempt=req.redispatched)
        try:
            self._front.submit(req)
        except Backpressure:
            self._fail(req, "redispatch_backpressure")

    def _fail(self, req, reason: str) -> None:
        """Terminal ``failed``: counted, journaled, and delivered through
        the (at-most-once-guarded) ``on_done`` exactly like a completion."""
        req.status = "failed"
        req.evicted = False
        self.metrics.inc("cluster_failed")
        if self.events is not None:
            self.events.emit("request_failed", uid=getattr(req, "uid", None),
                             reason=reason,
                             redispatched=getattr(req, "redispatched", 0))
        cb = getattr(req, "on_done", None)
        if cb is not None:
            try:
                cb(req)
            except Exception as e:
                self.metrics.inc("cluster_callback_errors")
                if self.events is not None:
                    self.events.emit("callback_error",
                                     uid=getattr(req, "uid", None),
                                     error=repr(e))

    def _guard_done(self, req) -> None:
        """Wrap ``on_done`` with the cluster-wide at-most-once guard: the
        first terminal delivery (any thread -- replica retirement daemons
        and the cluster's ``_fail`` race across an eviction) wins; later
        ones are counted as ``duplicate_retirements`` and dropped."""
        if getattr(req, "_ft_guarded", False):
            return
        inner = getattr(req, "on_done", None)
        lock = self._retire_lock
        metrics = self.metrics

        def once(r, _inner=inner):
            with lock:
                if getattr(r, "_done_fired", False):
                    metrics.inc("duplicate_retirements")
                    return
                r._done_fired = True
            if _inner is not None:
                _inner(r)

        req.on_done = once
        req._ft_guarded = True

    def health(self) -> dict:
        """Watchdog roll-up: overall status, per-replica watchdog state and
        the eviction ledger."""
        if not self.engines:
            status = "unhealthy"
        elif self._degraded:
            status = "degraded"
        else:
            status = "ok"
        reps = {}
        for e in self.engines + self._draining:
            label = self._labels.get(id(e), "replica?")
            wd = self._watchdogs.get(id(e))
            reps[label] = (wd.state() if wd is not None
                           else {"health": "healthy"})
        return {
            "status": status,
            "degraded": self._degraded,
            "active": len(self.engines),
            "standby": len(self._standby),
            "draining": len(self._draining),
            "replicas": reps,
            "evicted": list(self._evicted),
        }

    @property
    def degraded(self) -> bool:
        return self._degraded

    # -- request path -------------------------------------------------------

    def submit(self, req) -> None:
        """Admit one request; raises ``scheduler.Backpressure`` when the
        cluster-wide admission bound is reached. Latency is stamped HERE --
        client-observed percentiles include front-end queue wait, not just
        time on the replica that eventually served the request.

        Degraded mode tightens admission: the front-end bound shrinks from
        ``max_pending`` to what the surviving replicas can actually absorb
        (active x per-replica cap) -- load is shed with an explicit reason
        instead of queueing toward collapse."""
        if self._degraded and self._per_replica_cap:
            cap = max(1, len(self.engines)) * self._per_replica_cap
            if self._front.depth >= cap:
                self.metrics.inc("cluster_shed")
                self.metrics.inc("cluster_rejected")
                if self.events is not None:
                    self.events.emit("cluster_reject",
                                     uid=getattr(req, "uid", None),
                                     reason="degraded_shed",
                                     depth=self._front.depth, cap=cap)
                raise Backpressure(
                    f"degraded: admission tightened to {cap} "
                    f"({len(self.engines)} surviving replicas)")
        req.submitted_at = self._clock()
        if (self._tracing or self._wd_enabled) \
                and getattr(req, "trace_id", None) is None:
            req.trace_id = self._next_trace_id
            self._next_trace_id += 1
        if self._wd_enabled:
            self._guard_done(req)
        try:
            self._front.submit(req)
        except Exception:
            self.metrics.inc("cluster_rejected")
            if self.events is not None:
                self.events.emit("cluster_reject",
                                 uid=getattr(req, "uid", None),
                                 reason="backpressure",
                                 depth=self._front.depth)
            raise
        self.metrics.inc("cluster_submitted")

    def _route(self) -> None:
        """Move front-end requests to replicas, least-loaded first. Only
        pulls what the replicas can admit -- per-replica backpressure keeps
        the remainder queued at the front in FIFO order. The front-end
        depth left after routing is sampled into the cluster metrics (the
        autoscaler's pressure signal)."""
        while self._front.depth:
            open_engines = [e for e in self.engines if e.free_room > 0]
            if not open_engines:
                break
            batch = self._front.poll(limit=1)
            if batch is None:
                break
            target = min(open_engines, key=lambda e: e.load)
            try:
                target.submit(batch.items[0])
            except Backpressure:
                # a replica refusing admission it advertised room for
                # (injected rejection, or a real race): requeue at the
                # front and stop this pump -- retrying in the same loop
                # against a deterministic rejector would spin forever
                self.metrics.inc("replica_submit_rejected")
                self._front.submit(batch.items[0])
                break
            except ValueError:
                # unservable request (e.g. prompt longer than the engine's
                # cache): the replica counted it in `rejected`; drop it
                # instead of letting one bad request crash the route pump
                self.metrics.inc("cluster_rejected")
                if self.events is not None:
                    self.events.emit(
                        "cluster_reject",
                        uid=getattr(batch.items[0], "uid", None),
                        reason="unservable")
        self.metrics.observe_queue_depth(self._front.depth)

    def step(self) -> None:
        """One cluster pump: route queued requests, tick every serving
        replica (admit / dispatch / retire) under the watchdog, and reap
        drained ones. List copies because a quarantine verdict mutates the
        pools mid-iteration."""
        self._route()
        for e in list(self.engines):
            self._step_replica(e)
        for e in list(self._draining):
            self._step_replica(e)
        if self._draining:
            self._reap_drained()

    # -- trace export ------------------------------------------------------------

    def flight_recorders(self) -> Dict[str, FlightRecorder]:
        """Every tracing replica's flight recorder keyed by its stable
        label: active, draining, standby and evicted alike (a replica that
        left still holds the spans it served)."""
        out: Dict[str, FlightRecorder] = {}
        for e in self.engines + self._draining + self._standby + self._evicted_engines:
            tr = getattr(e, "tracer", None)
            if tr is not None and tr.enabled:
                out[tr.label] = tr.recorder
        return out

    def export_trace(self, path: str, t0: Optional[float] = None,
                     t1: Optional[float] = None) -> dict:
        """Write the cluster-wide Chrome-trace/Perfetto JSON (one process
        track per replica) and return the document."""
        return write_chrome_trace(path, self.flight_recorders(), t0, t1)

    def warmup(self) -> None:
        """Compile every program on every replica -- active and standby (a
        standby must be warm *before* the autoscaler routes to it) --
        outside the measured path. With ``cfg.autotune.enable`` each
        replica's warmup tunes first; the table is process-global and kept
        per device kind, so a replica whose keys an earlier one swept
        sweeps nothing, and an EP replica sweeps its per-slot keys."""
        for e in self.engines + self._standby:
            e.warmup()

    def flush(self) -> None:
        """Drain: push everything queued through the replicas and retire
        every in-flight batch on each of them (draining replicas too). A
        replica whose flush raises goes through the watchdog (quarantine
        once its error budget trips) instead of aborting the drain; if
        every replica is lost, remaining queued requests terminate as
        ``failed`` -- flush never deadlocks on a dead cluster."""
        self._front.drain(True)
        try:
            rounds = 0
            while not self.idle:
                rounds += 1
                if rounds > 100_000:
                    # pathological no-progress spin (e.g. an injector
                    # rejecting every submit): shed what is left as failed
                    for req in self._front.clear():
                        self._fail(req, "flush_no_progress")
                    break
                if not self.engines and not self._draining:
                    # nothing left to serve on: deliver terminal failures
                    # rather than spinning on an unroutable queue
                    for req in self._front.clear():
                        self._fail(req, "no_replicas")
                    break
                self._route()
                for e in list(self.engines) + list(self._draining):
                    if e.idle:
                        continue
                    if not self._wd_enabled:
                        e.flush()
                        continue
                    try:
                        e.flush()
                    except Exception as exc:
                        verdict = self._watchdog(e).record_error(exc)
                        if verdict is not None:
                            self.quarantine(e, verdict)
            self._reap_drained()
        finally:
            self._front.drain(False)

    run_until_drained = flush
