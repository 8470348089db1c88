"""The port's host-side serving control plane -- ``ServingCluster`` routing,
backpressure, watchdog eviction and re-dispatch, the at-most-once guard,
degraded mode, the ``Autoscaler``, ``FaultInjector``, ``ReplicaWatchdog``,
``ClusterMetrics`` and ``LatencyTracker.merge`` -- against the JAX
package's, on the same scripted inputs under a fake clock.

Both sides get the same fake replicas: a deterministic ``EngineReplica``
that carries both ``mesh`` and ``device`` (so it conforms to both
protocols), built with each package's ``EngineMetrics`` and
``Backpressure``. The decisions must be identical: event records (type and
payload, timestamps included), the replica timeline, each request's status
and re-dispatch count, the aggregate counters and the merged latency
percentiles.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.configs.base import AutoscaleConfig as RefAutoscaleConfig
from repro.configs.base import FaultConfig as RefFaultConfig
from repro.distributed import fault_tolerance as ref_ft
from repro.serving import autoscaler as ref_autoscaler
from repro.serving import cluster as ref_cluster
from repro.serving import events as ref_events
from repro.serving import faults as ref_faults
from repro.serving import metrics as ref_metrics
from repro.serving import scheduler as ref_scheduler

from repro_torch.configs.base import AutoscaleConfig, FaultConfig
from repro_torch.distributed import fault_tolerance as port_ft
from repro_torch.serving import autoscaler as port_autoscaler
from repro_torch.serving import cluster as port_cluster
from repro_torch.serving import events as port_events
from repro_torch.serving import faults as port_faults
from repro_torch.serving import metrics as port_metrics
from repro_torch.serving import scheduler as port_scheduler
from repro_torch.serving.replica import EngineReplica


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's classes, so a test runs the same script on both."""

    name: str
    FaultConfig: type
    AutoscaleConfig: type
    EngineMetrics: type
    ClusterMetrics: type
    LatencyTracker: type
    Backpressure: type
    ServingCluster: type
    Autoscaler: type
    EventLog: type
    faults: object
    ft: object
    devices: object  # the cluster's ``devices=`` argument


REF = Side("ref", RefFaultConfig, RefAutoscaleConfig, ref_metrics.EngineMetrics,
           ref_metrics.ClusterMetrics, ref_metrics.LatencyTracker, ref_scheduler.Backpressure,
           ref_cluster.ServingCluster, ref_autoscaler.Autoscaler, ref_events.EventLog,
           ref_faults, ref_ft, None)
PORT = Side("port", FaultConfig, AutoscaleConfig, port_metrics.EngineMetrics,
            port_metrics.ClusterMetrics, port_metrics.LatencyTracker, port_scheduler.Backpressure,
            port_cluster.ServingCluster, port_autoscaler.Autoscaler, port_events.EventLog,
            port_faults, port_ft, ["cpu"])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@dataclasses.dataclass
class FakeRequest:
    uid: int
    submitted_at: float = None
    on_done: object = None
    trace_id: int = None
    status: str = "pending"
    redispatched: int = 0
    evicted: bool = False


class FakeReplica:
    """A deterministic replica: serves ``capacity`` queued requests a step
    (a callback that raises is counted, as the engines count it), can be
    wedged by setting ``fail`` to an exception, and hands its queue back on
    ``evict()``. ``mesh`` and ``device`` both hold its placement."""

    def __init__(self, side, placement, clock, *, capacity=2, max_pending=4):
        self.side = side
        self.mesh = self.device = placement
        self._clock = clock
        self.capacity = capacity
        self.max_pending = max_pending
        self._queue = []
        self.fail = None
        self.metrics = side.EngineMetrics(num_experts=4, clock=clock)

    def submit(self, req):
        if len(self._queue) >= self.max_pending:
            self.metrics.inc("rejected")
            raise self.side.Backpressure("fake replica full")
        if req.submitted_at is None:
            req.submitted_at = self._clock()
        self._queue.append(req)
        self.metrics.inc("submitted")
        self.metrics.observe_queue_depth(len(self._queue))

    def step(self):
        if self.fail is not None:
            raise self.fail
        now = self._clock()
        served, self._queue = self._queue[:self.capacity], self._queue[self.capacity:]
        for req in served:
            self.metrics.queue_wait.record(max(0.0, now - req.submitted_at))
            req.status = "completed"
            self.metrics.inc("completed")
            self.metrics.work_done(1, "frames")
            self.metrics.request_latency.record(max(0.0, now - req.submitted_at))
            self.metrics.record_step(f"fake|b={len(served)}", 0.001 * len(served))
            self.metrics.add_expert_tokens(np.bincount([req.uid % 4, (req.uid * 7) % 4],
                                                       minlength=4))
            if req.on_done is not None:
                try:
                    req.on_done(req)
                except Exception:
                    self.metrics.inc("callback_errors")

    def warmup(self):
        pass

    def flush(self):
        while self._queue:
            self.step()

    def reset_metrics(self):
        self.metrics = self.side.EngineMetrics(num_experts=4, clock=self._clock)

    def evict(self):
        out = []
        for req in self._queue:
            if req.status == "pending":
                req.evicted = True
                out.append(req)
        self._queue = []
        return out

    @property
    def load(self):
        return len(self._queue)

    @property
    def free_room(self):
        return max(0, self.max_pending - len(self._queue))

    @property
    def idle(self):
        return not self._queue


def _cluster(side, clock, *, replicas=2, standby=1, capacity=2, replica_pending=4, faults=None,
             events=None, **kw):
    """A cluster of ``FakeReplica``s (``kw``: the cluster's own knobs)."""
    built = []

    def factory(placement):
        eng = FakeReplica(side, placement, clock, capacity=capacity,
                          max_pending=replica_pending)
        built.append(eng)
        return eng

    cluster = side.ServingCluster(None, None, replicas=replicas, standby=standby,
                                  engine=factory, clock=clock, faults=faults, events=events,
                                  devices=side.devices, **kw)
    return cluster, built


def _inner(eng):
    return getattr(eng, "inner", eng)


# -- the scripted trace ------------------------------------------------------

CHAOS = dict(inject=True, seed=3, step_error_rate=0.03, oom_rate=0.0, step_stall_rate=0.03,
             stall_s=1.0, submit_reject_rate=0.05, callback_poison_rate=0.05,
             kill_schedule=((1, 12, "dead"), (0, 40, "oom"), (2, 9, "stall"), (2, 10, "stall"),
                            (3, 5, "error")),
             step_timeout_s=0.5, error_budget=3, stall_budget=2, retry_budget=2)
POLICY = dict(min_replicas=1, max_replicas=4, standby=2, depth_high=1.0, slo_p95_ms=400.0,
              up_patience=2, depth_low=0.0, down_patience=4, cooldown=3,
              min_window_samples=4, p95_ttl=6)


def _scripted_run(side, chaos=CHAOS):
    """Submits in bursts, every step under the watchdog, the autoscaler
    ticking, injected errors, OOMs, stalls, rejections, poisoned callbacks
    and a scheduled kill, a replica wedged by hand, then a flush."""
    clock = FakeClock()
    events = side.EventLog(clock=clock)
    cluster, built = _cluster(side, clock, replicas=2, standby=3, capacity=1,
                              faults=side.FaultConfig(**chaos), events=events,
                              replica_pending=3, max_pending=24,
                              fault_stall_fn=clock.advance)
    scaler = side.Autoscaler(cluster, side.AutoscaleConfig(**POLICY))
    done, reqs, rejected, scaled = [], [], [], []
    uid = 0
    for tick in range(160):
        burst = 6 if tick < 30 else (1 if 100 <= tick < 110 and tick % 2 == 0 else 0)
        for _ in range(burst):
            req = FakeRequest(uid=uid, on_done=lambda r: done.append((r.uid, r.status)))
            uid += 1
            try:
                cluster.submit(req)
                reqs.append(req)
            except side.Backpressure:
                rejected.append(req.uid)
        if tick == 104 and cluster.engines:
            _inner(cluster.engines[-1]).fail = RuntimeError("wedged device")
        cluster.step()
        scaled.append(scaler.tick())
        clock.advance(0.01)
    cluster.flush()
    return {
        "events": events.events(),
        "timeline": cluster.metrics.replica_timeline,
        "requests": [(r.uid, r.status, r.redispatched) for r in reqs],
        "done": sorted(done),
        "rejected": rejected,
        "scaled": scaled,
        "scaler_events": scaler.events,
        "scaler_state": scaler.state(),
        "snapshot": cluster.metrics.snapshot(),
        "health": cluster.health(),
        "pooled_hist": cluster.metrics.pooled_request_hist(),
        "latency": {p: cluster.metrics.merged_request_latency().percentile(p)
                    for p in (50, 90, 95, 99)},
    }


@pytest.fixture(scope="module")
def scripted():
    return {side.name: _scripted_run(side) for side in (REF, PORT)}


def _nan_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _nan_equal(a[k], b[k])
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b


def test_scripted_trace_exercises_every_fault_path(scripted):
    port = scripted["port"]
    types = {e["type"] for e in port["events"]}
    for t in ("replica_step_error", "replica_evicted", "replica_replaced",
              "request_redispatched", "cluster_reject", "scale_up", "scale_down",
              "replica_drained", "cluster_degraded"):
        assert t in types, t
    reasons = {e["reason"] for e in port["events"] if e["type"] == "replica_evicted"}
    assert {"step_errors", "oom", "stalled"} <= reasons
    counters = port["snapshot"]["aggregate"]["counters"]
    assert counters["cluster_redispatched"] >= 1 and counters["replicas_evicted"] >= 3
    assert counters.get("callback_errors", 0) >= 1
    assert counters.get("replica_submit_rejected", 0) >= 1
    # at-most-once: every accepted request has exactly one terminal callback
    uids = [u for u, _ in port["done"]]
    assert sorted(uids) == sorted(set(uids)) == sorted(u for u, _, _ in port["requests"])


def test_scripted_trace_event_records_match_reference(scripted):
    ref, port = scripted["ref"]["events"], scripted["port"]["events"]
    assert [e["type"] for e in port] == [e["type"] for e in ref]
    for a, b in zip(port, ref):
        _nan_equal(a, b)


def test_scripted_trace_timeline_and_requests_match_reference(scripted):
    ref, port = scripted["ref"], scripted["port"]
    assert port["timeline"] == ref["timeline"]
    assert port["requests"] == ref["requests"]
    assert port["done"] == ref["done"]
    assert port["rejected"] == ref["rejected"]
    assert port["scaled"] == ref["scaled"] and port["scaler_events"] == ref["scaler_events"]
    _nan_equal(port["scaler_state"], ref["scaler_state"])
    _nan_equal(port["health"], ref["health"])


def test_scripted_trace_counters_and_latency_match_reference(scripted):
    ref, port = scripted["ref"]["snapshot"], scripted["port"]["snapshot"]
    ra, pa = ref["aggregate"], port["aggregate"]
    assert pa["counters"] == ra["counters"]
    for key in ("latency_ms", "queue_wait_ms", "batch_latency_ms", "front_queue_depth",
                "step_latency_ms", "expert_health"):
        _nan_equal(pa[key], ra[key])
    assert pa["expert_tokens"] == ra["expert_tokens"]
    assert pa["expert_occupancy"] == ra["expert_occupancy"]
    _nan_equal(pa["fps"], ra["fps"])
    assert port["replicas_active"] == ref["replicas_active"]
    assert port["replica_timeline"] == ref["replica_timeline"]
    np.testing.assert_array_equal(scripted["port"]["pooled_hist"], scripted["ref"]["pooled_hist"])
    assert scripted["port"]["latency"] == scripted["ref"]["latency"]


def test_cluster_snapshot_keys_are_the_reference_s_without_introspection(scripted):
    # the introspection rows are ported now: the key sets are equal, and the
    # fake replicas' program rows (step times, no cost rows) and memory
    # (none) equal the reference's
    ref, port = scripted["ref"]["snapshot"], scripted["port"]["snapshot"]
    assert sorted(port) == sorted(ref)
    assert set(port["aggregate"]) == set(ref["aggregate"])
    for key in ("program_perf", "memory"):
        _nan_equal(port["aggregate"][key], ref["aggregate"][key])


@pytest.mark.parametrize("kind", ["error_budget", "oom", "retry_budget", "degraded", "stall"])
def test_fault_scenarios_match_reference(kind):
    """The reference's watchdog scenarios, each run on both packages."""
    def run(side):
        clock = FakeClock()
        events = side.EventLog(clock=clock)
        fc = {"error_budget": dict(error_budget=2, retry_budget=2),
              "oom": dict(error_budget=5),
              "retry_budget": dict(error_budget=1, retry_budget=1),
              "degraded": dict(error_budget=1),
              "stall": dict(inject=True, step_stall_rate=1.0, stall_s=1.0, step_timeout_s=0.5,
                            stall_budget=2)}[kind]
        standby = {"retry_budget": 2, "degraded": 0}.get(kind, 1)
        capacity = 0 if kind == "degraded" else 1
        cluster, built = _cluster(side, clock, replicas=2, standby=standby,
                                  capacity=capacity, faults=side.FaultConfig(**fc),
                                  events=events, replica_pending=2 if kind == "degraded" else 8,
                                  max_pending_per_replica=2 if kind == "degraded" else 8,
                                  fault_stall_fn=clock.advance)
        done, reqs, shed = [], [], 0
        for i in range(8):
            req = FakeRequest(uid=i, on_done=lambda r: done.append((r.uid, r.status)))
            try:
                cluster.submit(req)
                reqs.append(req)
            except side.Backpressure:
                shed += 1
        cluster._route()
        if kind == "oom":
            _inner(built[0]).fail = side.faults.InjectedOOM("RESOURCE_EXHAUSTED: fake")
        elif kind == "retry_budget":
            for eng in built:
                _inner(eng).fail = RuntimeError("wedged")
        elif kind != "stall":
            _inner(built[0]).fail = RuntimeError("wedged device")
        for _ in range(20):
            if not cluster.engines:
                break
            cluster.step()
            clock.advance(0.01)
        scaled = []
        if kind == "degraded":
            scaled = [cluster.scale_down(), cluster.scale_up(), cluster.degraded]
        else:
            cluster.flush()
        return (events.events(), [(r.uid, r.status, r.redispatched) for r in reqs],
                sorted(done), shed, scaled, cluster.metrics.snapshot()["aggregate"]["counters"],
                cluster.health(), cluster.metrics.replica_timeline)

    ref, port = run(REF), run(PORT)
    assert port[0] and [e["type"] for e in port[0]] == [e["type"] for e in ref[0]]
    for a, b in zip(port[0], ref[0]):
        _nan_equal(a, b)
    assert port[1:] == ref[1:]


# -- components --------------------------------------------------------------

@pytest.mark.parametrize("seed,ordinal", [(0, 0), (9, 0), (9, 1), (123, 5)])
def test_injector_draws_match_reference_per_seed_and_ordinal(seed, ordinal):
    kw = dict(inject=True, seed=seed, step_error_rate=0.2, oom_rate=0.1, step_stall_rate=0.2,
              stall_s=0.0, submit_reject_rate=0.3, callback_poison_rate=0.3,
              kill_schedule=((ordinal, 37, "dead"), (ordinal + 1, 3, "error")))

    def run(side):
        inj = side.faults.FaultInjector(side.FaultConfig(**kw), ordinal,
                                        stall_fn=lambda s: None)
        seq = []
        for _ in range(50):
            try:
                inj.before_step()
                seq.append("ok")
            except side.faults.InjectedOOM:
                seq.append("oom")
            except side.faults.InjectedFault as e:
                seq.append("err " + str(e))
            seq.append(inj.on_submit())
            cb = lambda r: None  # noqa: E731
            seq.append(inj.wrap_callback(cb) is cb)
        return seq, dict(inj.injected), inj.dead

    ref, port = run(REF), run(PORT)
    assert port == ref
    assert port[1] and port[2]  # draws fired, and the scheduled kill


def test_watchdog_verdicts_match_reference():
    rng = np.random.default_rng(4)
    script = []
    for _ in range(400):
        u = rng.random()
        if u < 0.35:
            script.append(("error", "RuntimeError"))
        elif u < 0.37:
            script.append(("error", "oom"))
        else:
            script.append(("step", float(rng.choice([1e-5, 0.01, 0.06, 0.3, 0.8, 2.0]))))

    def run(side):
        cfg = side.FaultConfig(error_budget=3, stall_budget=2, step_timeout_s=0.5,
                               stall_threshold=4.0, warmup_steps=3, stall_floor_s=0.05)
        wd, out = side.faults.ReplicaWatchdog(cfg, label="r"), []
        for kind, arg in script:
            if kind == "step":
                out.append(wd.record_step(arg))
            else:
                exc = (side.faults.InjectedOOM("RESOURCE_EXHAUSTED: x") if arg == "oom"
                       else RuntimeError("boom"))
                out.append(wd.record_error(exc))
            out.append(wd.state())
        return out

    ref, port = run(REF), run(PORT)
    assert port == ref
    reasons = {v["reason"] for v in port if v and "reason" in v}
    assert reasons == {"oom", "step_errors", "stalled"}


# Step times (ms) that the EP cluster's watchdog saw in two runs of
# chip_smoke.py's phase_ep_lm on an H100 (tools/ep_drain_runs.py: one EP
# replica over 4 slots, no standby, 16 requests; every one of 10 runs
# drained). Run 0: the packed engine's step returns after its enqueue (3-4
# ms) and now and then blocks on the device (40-100 ms); run 3: one step
# over the stall rule (92.797 ms against max(8 x 11.56 ms EMA, 50 ms)), the
# next under it. The first step of each is the first admission.
EP_TRACE_RUN0 = [
    137.521, 4.009, 4.158, 4.04, 40.084, 3.94, 4.932, 13.863, 8.824, 4.211, 3.598, 84.821,
    43.306, 10.061, 21.358, 3.644, 4.27, 3.557, 61.378, 34.473, 3.361, 3.539, 2.772, 2.768,
    76.339, 28.472, 4.961, 3.743, 3.471, 3.27, 75.526, 56.79, 4.509, 3.537, 4.195, 99.119,
    19.593, 7.25, 3.729, 45.848, 3.664, 4.08, 4.063, 3.773, 3.842, 87.954, 34.161, 4.014,
    3.808, 4.133, 47.836, 3.525, 3.373, 51.368, 5.506, 33.416, 5.3, 3.176, 3.709, 63.74,
    3.419, 12.658]
EP_TRACE_RUN3 = [
    153.251, 17.683, 22.748, 28.395, 24.052, 22.825, 40.515, 6.593, 23.605, 22.938, 22.584,
    22.499, 22.668, 23.293, 21.595, 51.405, 7.169, 22.245, 22.478, 23.214, 22.561, 22.836,
    22.372, 22.304, 22.865, 22.447, 39.821, 6.374, 22.744, 22.991, 23.048, 120.184, 22.886,
    22.86, 22.735, 22.454, 23.454, 22.543, 39.813, 6.8, 23.542, 22.798, 22.953, 22.8, 22.216,
    23.211, 22.051, 3.855, 3.733, 3.353, 3.089, 92.797, 23.785, 24.009, 6.153, 24.198, 22.662,
    22.356, 22.68, 22.177, 23.677, 22.761]
EP_STALL_STEP = 51  # run 3's stall
# run 3 with the step after its stall blocked as long as the stall: two
# stalls in a row, the watchdog's eviction
EP_TRACE_EVICTING = EP_TRACE_RUN3[:EP_STALL_STEP + 1] + [92.797] + EP_TRACE_RUN3[53:]


def _watch(side, trace_ms, idle_every=0):
    """A trace of step times (ms) through one package's ``ReplicaWatchdog``
    at the default ``FaultConfig``: every step's verdict and state; with
    ``idle_every``, an idle tick of 20 us after every that many steps (the
    pump's no-op steps while a replica waits for work)."""
    wd, out = side.faults.ReplicaWatchdog(side.FaultConfig(), label="replica0"), []
    for i, ms in enumerate(trace_ms):
        out.append((wd.record_step(ms / 1e3), wd.state()))
        if idle_every and i % idle_every == idle_every - 1:
            out.append((wd.record_step(20e-6), wd.state()))
    return out


@pytest.mark.parametrize("trace,idle_every", [
    ("run0", 0), ("run3", 0), ("evicting", 0), ("run0", 3), ("run3", 5)])
def test_watchdog_verdicts_on_the_ep_cluster_traces_match_reference(trace, idle_every):
    """The EP cluster's step times from the card (and run 3 with one more
    blocked step), idle ticks interleaved or not, through the port's and
    the reference's watchdogs at the default FaultConfig: the same verdict
    and state at every step. Run 0 never stalls; run 3 stalls once at its
    step 51 and recovers; two stalls in a row evict on both sides; idle
    ticks pull the EMA down, and run 0 with one after every 3 steps evicts
    a replica whose steps were all served."""
    ms = {"run0": EP_TRACE_RUN0, "run3": EP_TRACE_RUN3, "evicting": EP_TRACE_EVICTING}[trace]
    ref, port = _watch(REF, ms, idle_every), _watch(PORT, ms, idle_every)
    assert port == ref
    verdicts = [i for i, (v, _) in enumerate(port) if v is not None]
    streaks = [st["consecutive_stalls"] for _, st in port]
    if (trace, idle_every) == ("run0", 0):
        assert not verdicts and max(streaks) == 0
    elif (trace, idle_every) == ("run3", 0):
        assert not verdicts and streaks.index(1) == EP_STALL_STEP and max(streaks) == 1
    elif trace == "evicting":
        assert verdicts == [EP_STALL_STEP + 1]
        v = port[EP_STALL_STEP + 1][0]
        assert v["reason"] == "stalled" and v["consecutive_stalls"] == 2
        assert 0.0115 < v["step_ema_s"] < 0.0116 and v["last_step_s"] == 92.797 / 1e3
    elif trace == "run0":
        assert len(verdicts) == 1 and port[verdicts[0]][0]["reason"] == "stalled"
    else:
        assert not verdicts and max(streaks) == 1


class _TracedReplica(FakeReplica):
    """A ``FakeReplica`` whose ``step()`` takes the next time of a trace on
    the fake clock (what the cluster's watchdog reads), then 4 ms a step."""

    def __init__(self, side, placement, clock, trace_ms, **kw):
        super().__init__(side, placement, clock, **kw)
        self._trace = iter(trace_ms)

    def step(self):
        self._clock.advance(next(self._trace, 4.0) / 1e3)
        super().step()


def _ep_cluster_run(side, standby):
    """One replica replaying the evicting EP trace (and, with ``standby``,
    a standby stepping 4 ms) behind the cluster at the default FaultConfig;
    64 requests served one a step, pumped until nothing is queued or in
    flight (at most 400 steps)."""
    clock = FakeClock()
    events = side.EventLog(clock=clock)
    traces = iter([EP_TRACE_EVICTING, []])

    def factory(placement):
        return _TracedReplica(side, placement, clock, next(traces), capacity=1,
                              max_pending=8)

    cluster = side.ServingCluster(None, None, replicas=1, standby=standby, engine=factory,
                                  clock=clock, events=events, devices=side.devices,
                                  max_pending_per_replica=8)
    done = []
    reqs = [FakeRequest(uid=i, on_done=lambda r: done.append((r.uid, r.status)))
            for i in range(64)]
    for r in reqs:
        cluster.submit(r)
    steps = 0
    while cluster.total_load and steps < 400:
        cluster.step()
        steps += 1
    return {"events": events.events(), "done": sorted(done), "steps": steps,
            "requests": [(r.uid, r.status, r.redispatched) for r in reqs],
            "health": cluster.health(), "drained": not cluster.total_load,
            "counters": cluster.metrics.snapshot()["aggregate"]["counters"]}


@pytest.mark.parametrize("standby", [1, 0])
def test_one_replica_cluster_evicted_by_the_stall_rule(standby):
    """The EP cluster's shape (one replica) on the evicting trace, in both
    packages with the same outcome: with a standby the eviction is
    backfilled, the stranded requests re-dispatched, and the cluster drains
    with every request completed once; with none it goes degraded (no
    active replica: ``health()`` reads unhealthy) and never drains, what
    chip_smoke.py's phase_ep_lm hit with no standby."""
    ref, port = _ep_cluster_run(REF, standby), _ep_cluster_run(PORT, standby)
    assert [e["type"] for e in port["events"]] == [e["type"] for e in ref["events"]]
    for a, b in zip(port["events"], ref["events"]):
        _nan_equal(a, b)
    for key in ("done", "steps", "requests", "drained", "counters"):
        assert port[key] == ref[key], key
    _nan_equal(port["health"], ref["health"])
    assert port["counters"]["replicas_evicted"] == 1
    (evicted,) = port["health"]["evicted"]
    assert evicted["reason"] == "stalled" and evicted["consecutive_stalls"] == 2
    if standby:
        assert port["drained"] and port["health"]["status"] == "ok"
        assert evicted["backfilled"] == "replica1"
        assert port["done"] == [(i, "completed") for i in range(64)]
        assert port["counters"].get("cluster_redispatched", 0) >= 1
    else:
        assert not port["drained"] and port["steps"] == 400
        # degraded, with no active replica left: health() reads "unhealthy"
        assert port["health"]["degraded"] and port["counters"]["cluster_degraded"] == 1
        assert port["health"]["status"] == "unhealthy" and port["health"]["active"] == 0
        assert len(port["done"]) < 64


def test_oom_classification_covers_cuda_out_of_memory_by_type():
    err = torch.cuda.OutOfMemoryError("CUDA error: allocation failed")
    assert port_faults.is_oom_error(err)
    assert port_faults.is_oom_error(port_faults.InjectedOOM("x"))
    assert port_faults.is_oom_error(RuntimeError("CUDA out of memory. Tried to allocate"))
    assert not port_faults.is_oom_error(RuntimeError("device-side assert"))
    wd = port_faults.ReplicaWatchdog(FaultConfig(error_budget=5))
    assert wd.record_error(err)["reason"] == "oom"


def test_faulty_replica_conforms_and_delegates():
    clock = FakeClock()
    inner = FakeReplica(PORT, torch.device("cpu"), clock)
    wrapped = port_faults.FaultyReplica(inner, port_faults.FaultInjector(
        FaultConfig(inject=True, submit_reject_rate=1.0), 0))
    assert isinstance(inner, EngineReplica) and isinstance(wrapped, EngineReplica)
    assert wrapped.device == torch.device("cpu") and wrapped.metrics is inner.metrics
    with pytest.raises(port_scheduler.Backpressure):
        wrapped.submit(FakeRequest(uid=0))
    fired = []
    poison = port_faults.FaultyReplica(inner, port_faults.FaultInjector(
        FaultConfig(inject=True, callback_poison_rate=1.0), 0))
    req = FakeRequest(uid=1, on_done=lambda r: fired.append(r.uid))
    poison.submit(req)
    with pytest.raises(port_faults.InjectedFault):
        req.on_done(req)
    assert fired == [1] and wrapped.load == inner.load == 1 and wrapped.evict() == [req]


def test_latency_tracker_merge_matches_reference():
    rng = np.random.default_rng(7)
    parts = [rng.lognormal(-4, 1.5, n) for n in (50, 300, 9000, 1)]

    def run(side):
        trackers = []
        for i, xs in enumerate(parts):
            t = side.LatencyTracker(maxlen=128 if i == 2 else 8192)
            for x in xs:
                t.record(x)
            trackers.append(t)
        merged = side.LatencyTracker.merged(trackers[:3])
        merged.merge(trackers[3])
        edges, counts, total, ssum, smax = merged.hist_data()
        return ([merged.percentile(p) for p in (1, 50, 90, 99, 99.9)], len(merged),
                merged.exact, counts.tolist(), total, ssum, smax, merged.snapshot(),
                [t.snapshot() for t in trackers])

    ref, port = run(REF), run(PORT)
    assert port == ref
    assert port[1] == 9351


def test_cluster_metrics_churn_matches_reference():
    """A replica joins mid-window, another drains out and rejoins fresh:
    the same snapshots, pooled percentiles and FPS window on both sides."""
    def run(side):
        t = [0.0]
        clock = lambda: t[0]  # noqa: E731
        m1 = side.EngineMetrics(num_experts=4, clock=clock)
        cm = side.ClusterMetrics([m1], clock=clock)
        cm.mark_replicas(1)
        m1.inc("submitted", 100)
        for x in [0.010] * 98 + [1.0, 1.0]:
            m1.request_latency.record(x)
        m1.inc("completed", 100)
        m1.work_done(100, "frames")
        m1.add_expert_tokens(np.array([6, 4, 0, 0]))
        m1.record_step("classify|b=8", 0.02)
        t[0] = 1.0
        m2 = side.EngineMetrics(num_experts=4, clock=clock)
        cm.add_replica(m2)
        cm.mark_replicas(2)
        cm.inc("cluster_submitted", 900)
        cm.observe_queue_depth(7)
        m2.inc("submitted", 900)
        for _ in range(900):
            m2.request_latency.record(0.010)
            m2.queue_wait.record(0.002)
        m2.inc("completed", 900)
        m2.work_done(900, "frames")
        m2.add_expert_tokens(np.array([0, 0, 7, 3]))
        m2.record_step("classify|b=8", 0.03)
        snaps = [cm.snapshot()["aggregate"]]
        t[0] = 2.0
        cm.remove_replica(m1)
        cm.mark_replicas(1)
        snaps.append(cm.snapshot()["aggregate"])
        cm.add_replica(side.EngineMetrics(num_experts=4, clock=clock))
        cm.mark_replicas(2)
        snaps.append(cm.snapshot())
        pooled = cm.merged_request_latency()
        return (snaps, cm.fps, [pooled.percentile(p) for p in (50, 99)],
                cm.replica_timeline, cm.pooled_request_hist().tolist(), cm.num_replicas)

    ref, port = run(REF), run(PORT)
    for a, b in zip(port[0][:2], ref[0][:2]):
        for key in a:
            _nan_equal(a[key], b[key])
    assert port[0][2]["replica_timeline"] == ref[0][2]["replica_timeline"]
    _nan_equal(port[0][2]["aggregate"]["latency_ms"], ref[0][2]["aggregate"]["latency_ms"])
    assert port[1:] == ref[1:]
    assert port[0][1]["latency_ms"]["n"] == 1000 and port[2][1] < 0.05
    assert [n for _, n in port[3]] == [1, 2, 1, 2]


def test_straggler_monitor_and_step_retry_match_reference():
    rng = np.random.default_rng(2)
    durations = rng.choice([0.01, 0.011, 0.05, 0.2], 200).tolist()

    def run(side):
        mon = side.ft.StragglerMonitor(alpha=0.2, threshold=3.0, warmup_steps=4)
        flags = [mon.record(d, step=i) for i, d in enumerate(durations)]
        sleeps, retries, calls = [], [], {"n": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("transient")
            return 2 * x

        out = side.ft.run_step_with_retry(flaky, 21, max_retries=2, on_retry=retries.append,
                                          sleep=sleeps.append)
        with pytest.raises(ValueError):
            side.ft.run_step_with_retry(lambda _: int("x"), 0, sleep=sleeps.append)
        guard = side.ft.PreemptionGuard(signals=())
        before = guard.preempted
        guard.request()
        return flags, mon.ema, mon.events, out, retries, sleeps, before, guard.preempted

    assert run(PORT) == run(REF)


def test_event_log_and_jsonl_match_reference(tmp_path):
    def run(side, mod, path):
        clock = FakeClock()
        log = side.EventLog(capacity=4, path=str(path), clock=clock)
        for i in range(6):
            clock.advance(0.5)
            log.emit("scale_up" if i % 2 else "reject", uid=i, score=np.float32(0.25 * i),
                     dev=torch.device("cpu"))
        log.emit("cancel", t=9.0, where="queued")
        log.close()
        snap = tmp_path / f"{side.name}-snap.jsonl"
        written = log.write_jsonl(str(snap))
        return (log.events(), log.events("reject"), log.counts(), len(log), log.total,
                log.dropped, written, mod.read_jsonl(str(path)), mod.read_jsonl(str(snap)))

    ref = run(REF, ref_events, tmp_path / "ref.jsonl")
    port = run(PORT, port_events, tmp_path / "port.jsonl")
    assert port == ref
    assert port[5] == 3 and len(port[7]) == 7


def test_autoscale_config_matches_reference():
    port, ref = AutoscaleConfig(), RefAutoscaleConfig()
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    port, ref = FaultConfig(), RefFaultConfig()
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_replica_devices_split_and_oversubscribe():
    cpu = torch.device("cpu")
    devs = [torch.device("cuda", i) for i in range(4)]  # names only: nothing is allocated
    assert port_cluster.replica_devices(1, ["cpu"]) == [cpu]
    assert port_cluster.replica_devices(3, ["cpu"]) == [cpu] * 3
    assert port_cluster.replica_devices(2, devs) == [devs[0], devs[2]]
    assert port_cluster.replica_devices(4, devs) == devs
    assert port_cluster.replica_devices(6, devs) == devs + devs[:2]
    clock = FakeClock()
    cluster, built = _cluster(PORT, clock, replicas=2, standby=0)
    assert cluster.devices == [cpu, cpu]
    assert cluster.scale_up() and built[-1].device == cpu  # a cold spawn


def test_expert_parallel_cluster_is_refused():
    """An expert-parallel cluster builds one replica over its devices, so a
    slot count that does not divide the experts is refused, and so is a
    mesh over more than one device (the engines capture on one)."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("olmoe-1b-7b")  # 8 experts
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, moe_exec="expert_parallel"))
    with pytest.raises(ValueError, match="not divisible"):
        port_cluster.ServingCluster(cfg, {}, devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="untested"):
        port_cluster.ServingCluster(cfg, {}, devices=["cpu", "cuda:1"])
