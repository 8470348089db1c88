"""The port's serving cluster over real engines, on the CPU at smoke size
(the kernels' plain versions): ``ServingCluster`` of ``ServeEngine``
replicas against the port's single engine and the reference's ``prefill``,
a vision cluster against the reference's ``classify``, the watchdog's
eviction and re-dispatch through real engines, at-most-once delivery, and
the replica surface of both engines.

Tolerances: the int8 tree's step-0 logits within atol 5e-3 of the
reference's ``prefill`` (``tests/test_torch_lm.py``'s quantized-tree
tolerance); the fp vision tree's probabilities within atol 1e-5
(``tests/test_torch_model.py``'s) and top-1 equal. Tokens served by the
cluster, re-dispatched ones included, equal the single engine's exactly:
routing and eviction change nothing a replica computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import smoke_config as jax_smoke_config
from repro.core.quant.ptq import calibrate_model as jax_calibrate
from repro.core.quant.ptq import ptq_model as jax_ptq
from repro.core.quant.ptq import quantized_config as jax_quantized_config
from repro.serving.engine import serving_config as jax_serving_config

from repro_torch import bridge
from repro_torch.configs import FaultConfig, smoke_config
from repro_torch.core.quant.ptq import quantized_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import synth_batch
from repro_torch.serving import (
    Backpressure,
    EngineReplica,
    EventLog,
    Request,
    ServeEngine,
    ServingCluster,
    VisionEngine,
    serving_config,
    synth_requests,
)

LM, VIT = "olmoe-1b-7b", "m3vit-small"
SLOTS, MAX_LEN, NEW = 2, 32, 8


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def lm():
    """The reference's smoke OLMoE (serving config), calibrated on 2
    batches of 2 x 16 tokens, its int8 tree bridged to the port."""
    jcfg = jax_serving_config(jax_smoke_config(LM)).replace(remat=False)
    tcfg = serving_config(smoke_config(LM))
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    batches = [synth_batch(tcfg, 2, 16, seed=s) for s in (1, 2)]
    taps = jax_calibrate(jcfg, params, [{"tokens": jnp.asarray(b)} for b in batches])
    int8 = _np_tree(jax_ptq(jcfg, params, taps, materialize="int8"))
    return {"jcfg": jax_quantized_config(jcfg), "qcfg": quantized_config(tcfg),
            "jp": jax.tree.map(jnp.asarray, int8),
            "tp": bridge.params_from_numpy(int8, "cpu")}


def _prompts(cfg, n=6, seed=5):
    rng = np.random.default_rng(seed)
    return [synth_batch(cfg, 1, int(k), seed=seed + i)[0]
            for i, k in enumerate(rng.integers(3, 12, n))]


def _requests(prompts, done=None):
    return [Request(uid=i, prompt=p, max_new_tokens=NEW,
                    on_done=None if done is None else done.append)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def solo(lm):
    """The port's single engine on the requests every cluster serves."""
    eng = ServeEngine(lm["qcfg"], lm["tp"], batch_slots=SLOTS, max_len=MAX_LEN,
                      device="cpu")
    reqs = _requests(_prompts(lm["qcfg"]))
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.status == "completed" and len(r.generated) == NEW for r in reqs)
    return [r.generated for r in reqs]


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pump(cluster, clock, reqs, max_steps=500):
    """Submit with one step after each, then step until no request is
    queued or decoding (a scheduled kill fires at its step; ``flush`` would
    drain a replica in one call), then ``flush`` to wait for the
    retirement threads."""
    for r in reqs:
        cluster.submit(r)
        cluster.step()
        clock.t += 0.25
    for _ in range(max_steps):
        if not cluster.total_load:
            break
        cluster.step()
        clock.t += 0.25
    assert not cluster.total_load
    cluster.flush()
    assert cluster.idle


def test_lm_cluster_serves_the_single_engine_tokens(lm, solo):
    clock = Clock()
    cluster = ServingCluster(lm["qcfg"], lm["tp"], replicas=2, engine="lm",
                             batch_slots=SLOTS, max_len=MAX_LEN, max_pending_per_replica=2,
                             clock=clock, devices=["cpu"])
    cluster.warmup()
    done = []
    reqs = _requests(_prompts(lm["qcfg"]), done)
    _pump(cluster, clock, reqs)
    assert [r.generated for r in reqs] == solo
    assert sorted(r.uid for r in done) == list(range(len(reqs)))
    snap = cluster.metrics.snapshot()
    agg = snap["aggregate"]
    assert agg["counters"]["completed"] == agg["counters"]["cluster_submitted"] == len(reqs)
    assert agg["counters"].get("replicas_evicted", 0) == 0
    assert agg["counters"].get("retraces", 0) == 0
    assert agg["latency_ms"]["n"] == agg["queue_wait_ms"]["n"] == len(reqs)
    assert np.isfinite(agg["fps"]) and agg["fps"] > 0 and sum(agg["expert_tokens"]) > 0
    assert all(r["counters"].get("tokens", 0) > 0 for r in snap["replicas"])
    # the replicas share the caller's weights and keep their own caches
    a, b = cluster.engines
    assert all(x is y is z for x, y, z in zip(_leaves(a.params), _leaves(b.params),
                                              _leaves(lm["tp"])))
    assert a.cache["k"].data_ptr() != b.cache["k"].data_ptr()


def test_lm_cluster_step0_logits_match_reference_prefill(lm, solo):
    """A pluggable factory (replicas that keep their logits): every
    request's step-0 logits, from whichever replica admitted it in whatever
    pack, against the reference's ``prefill`` of its prompt alone."""
    clock = Clock()
    built = []

    def factory(device):
        eng = ServeEngine(lm["qcfg"], lm["tp"], batch_slots=SLOTS, max_len=MAX_LEN,
                          device=device, clock=clock, keep_logits=True)
        built.append(eng)
        return eng

    cluster = ServingCluster(None, None, replicas=2, engine=factory, clock=clock,
                             devices=["cpu"])
    reqs = _requests(_prompts(lm["qcfg"]))
    _pump(cluster, clock, reqs)
    assert [r.generated for r in reqs] == solo
    assert all(e.metrics.counters.get("prefill_batches", 0) for e in built)
    jmod = M.module_for(lm["jcfg"])
    for r in reqs:
        want, _ = jmod.prefill(lm["jp"], lm["jcfg"], jnp.asarray(r.prompt)[None],
                               max_len=MAX_LEN)
        np.testing.assert_allclose(r.step_logits[0].numpy(), np.asarray(want)[0, -1],
                                   atol=5e-3, rtol=0, err_msg=str(r.uid))


@pytest.mark.parametrize("kill_step", [1, 4])
def test_lm_cluster_chaos_kill_redispatches_and_keeps_tokens(lm, solo, kill_step):
    """Replica ordinal 1 dies at its local step ``kill_step`` (at its first
    admission, or mid-decode): the watchdog evicts it after the error
    budget, the standby is promoted, its requests restart there, and every
    request is delivered once, completed, with the single engine's
    tokens."""
    clock = Clock()
    events = EventLog(clock=clock)
    faults = FaultConfig(inject=True, kill_schedule=((1, kill_step, "dead"),))
    cluster = ServingCluster(lm["qcfg"], lm["tp"], replicas=2, standby=1, engine="lm",
                             batch_slots=SLOTS, max_len=MAX_LEN, max_pending_per_replica=2,
                             clock=clock, events=events, faults=faults, devices=["cpu"])
    cluster.warmup()
    done = []
    reqs = _requests(_prompts(lm["qcfg"]), done)
    _pump(cluster, clock, reqs)
    assert [r.generated for r in reqs] == solo
    assert sorted(r.uid for r in done) == list(range(len(reqs)))
    assert all(r.status == "completed" for r in reqs)
    evicted = events.events("replica_evicted")
    assert len(evicted) == 1 and evicted[0]["replica"] == "replica1"
    assert evicted[0]["reason"] == "step_errors" and evicted[0]["stranded"] >= 1
    assert [e["replacement"] for e in events.events("replica_replaced")] == ["replica2"]
    redispatched = [r.uid for r in reqs if r.redispatched]
    assert redispatched and all(r.redispatched == 1 for r in reqs if r.redispatched)
    counters = cluster.metrics.snapshot()["aggregate"]["counters"]
    assert counters["cluster_redispatched"] == len(redispatched) == evicted[0]["stranded"]
    assert counters["completed"] == len(reqs) and counters["replica_step_errors"] == 3
    assert counters.get("duplicate_retirements", 0) == 0
    assert cluster.num_replicas == 2 and cluster.standby_replicas == 0
    assert not cluster.degraded and cluster.health()["status"] == "ok"


def test_duplicate_retirement_across_an_eviction_is_delivered_once(lm, solo):
    """Through real engines: events of a request stranded on an evicted
    replica are no-ops (a late token append after re-dispatch cleared
    ``generated`` neither crashes nor lands), the request completes once on
    the other replica, and a replayed retirement -- on either engine, or
    through the cluster's guarded callback -- is counted, not delivered."""
    clock = Clock()
    cluster = ServingCluster(lm["qcfg"], lm["tp"], replicas=2, engine="lm",
                             batch_slots=SLOTS, max_len=MAX_LEN, clock=clock,
                             devices=["cpu"])
    fired = []
    req = _requests(_prompts(lm["qcfg"])[:1], fired)[0]
    cluster.submit(req)
    cluster.step()  # admitted (first token) and one decode tick
    old = next(e for e in cluster.engines if e.inflight)
    old._rq.join()
    assert len(req.generated) == 2
    slot = next(iter(old.active))
    stale_append = {"tok": torch.full((SLOTS,), 7, dtype=torch.int32), "now": clock.t,
                    "append": [(req, slot)]}
    stale_retired = {"now": clock.t, "retired": [(req, 1.0, False)]}
    cluster.quarantine(old, "manual")
    assert req.redispatched == 1 and req.generated is None and not req.evicted
    old._consume(stale_append)  # a late append after re-dispatch: a no-op
    assert req.generated is None
    cluster.flush()
    assert fired == [req] and req.status == "completed" and req.generated == solo[0]
    new = cluster.engines[0]
    for eng in (old, new):
        eng._consume(stale_retired)
        assert eng.metrics.counters["duplicate_retirements"] == 1
    req.on_done(req)
    assert fired == [req]
    counters = cluster.metrics.snapshot()["aggregate"]["counters"]
    assert counters["duplicate_retirements"] == 2  # the new engine's + the guard's


def test_engine_evict_strands_queued_and_decoding_requests(lm):
    eng = ServeEngine(lm["qcfg"], lm["tp"], batch_slots=SLOTS, max_len=MAX_LEN,
                      device="cpu", keep_logits=True)
    reqs = _requests(_prompts(lm["qcfg"], n=3))
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.inflight == 2 and [r.uid for r in eng.queue] == [2] and eng.load == 3
    stranded = eng.evict()
    assert [r.uid for r in stranded] == [2, 0, 1]  # the queue, then slots in order
    assert all(r.evicted and r.status == "pending" for r in stranded)
    assert eng.idle and eng.load == 0 and not eng.pos.any()
    n = len(reqs[0].generated)
    eng._consume({"tok": torch.zeros(SLOTS, dtype=torch.int32), "now": 0.0,
                  "append": [(reqs[0], 0)], "retired": [(reqs[0], 1.0, False)]})
    assert len(reqs[0].generated) == n and reqs[0].status == "pending"
    assert eng.metrics.counters.get("completed", 0) == 0


def test_engines_satisfy_the_replica_protocol_and_count_decode_slots(lm):
    vcfg = smoke_config(VIT)
    from repro_torch.models import init_model_params

    vis = VisionEngine(vcfg, init_model_params(vcfg, device="cpu"), batch_buckets=(1,),
                       device="cpu")
    eng = ServeEngine(lm["qcfg"], lm["tp"], batch_slots=3, max_len=16, max_pending=2,
                      device="cpu")
    for e in (eng, vis):
        assert isinstance(e, EngineReplica)
        assert e.idle and e.load == 0 and e.free_room > 0
        assert e.device == torch.device("cpu")
    assert eng.free_slots == 3 and eng.free_room == 5  # 3 slots + 2 queue
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts(lm["qcfg"], n=4, seed=7))]
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    assert eng.inflight == 3 and eng.free_slots == 0
    assert eng.load == 3 and eng.free_room == 2
    eng.submit(reqs[3])
    assert eng.load == 4 and eng.free_room == 1 and not eng.idle
    eng.flush()
    assert eng.idle and eng.free_room == 5
    old = eng.metrics
    eng.reset_metrics()
    assert eng.metrics is not old and not eng.metrics.counters
    assert eng.metrics.expert_tokens.size == old.expert_tokens.size


def test_engine_events_journal_rejections_cancellations_and_callback_errors(lm):
    clock = Clock()
    events = EventLog(clock=clock)
    eng = ServeEngine(lm["qcfg"], lm["tp"], batch_slots=1, max_len=16, max_pending=1,
                      device="cpu", events=events, clock=clock)
    prompt = _prompts(lm["qcfg"], n=1)[0]
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.zeros(16, np.int32), max_new_tokens=1))

    def bad(r):
        raise RuntimeError("user callback bug")

    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=3, on_done=bad))
    eng.submit(Request(uid=2, prompt=prompt, max_new_tokens=3, deadline=0.5))
    with pytest.raises(Backpressure):
        eng.submit(Request(uid=3, prompt=prompt, max_new_tokens=3))
    eng.step()
    clock.t += 1.0
    eng.run_until_drained()
    got = [(e["type"], e.get("uid"), e.get("reason") or e.get("where")) for e in events.events()]
    # the callback error comes from the retirement thread: its place varies
    assert sorted(got) == [("callback_error", 1, None), ("cancel", 2, "queued"),
                           ("reject", 0, "unservable"), ("reject", 3, "backpressure")]
    assert eng.metrics.counters["callback_errors"] == 1
    assert eng.metrics.counters["cancelled"] == 1


def test_lm_cluster_drops_an_unservable_prompt(lm):
    cluster = ServingCluster(lm["qcfg"], lm["tp"], replicas=1, engine="lm", batch_slots=2,
                             max_len=16, devices=["cpu"])
    rng = np.random.default_rng(21)
    bad = Request(uid=0, prompt=rng.integers(0, 256, 16).astype(np.int32), max_new_tokens=2)
    ok = Request(uid=1, prompt=rng.integers(0, 256, 5).astype(np.int32), max_new_tokens=2)
    cluster.submit(bad)
    cluster.submit(ok)
    cluster.flush()
    assert len(ok.generated) == 2 and bad.generated is None
    counters = cluster.metrics.snapshot()["aggregate"]["counters"]
    assert counters["rejected"] == counters["cluster_rejected"] == counters["completed"] == 1


@pytest.fixture(scope="module")
def vit():
    cfg = jax_smoke_config(VIT).replace(remat=False)
    return cfg, _np_tree(M.init_model_params(cfg, jax.random.PRNGKey(0)))


def test_vision_cluster_matches_reference_classify(vit):
    jcfg, fp = vit
    tcfg = smoke_config(VIT)
    clock = Clock()
    cluster = ServingCluster(tcfg, bridge.params_from_numpy(fp, "cpu"), replicas=2,
                             batch_buckets=(1, 2, 4), max_wait_s=0.0, top_k=3, clock=clock,
                             devices=["cpu"])
    assert all(isinstance(e, VisionEngine) for e in cluster.engines)
    cluster.warmup()
    done = []
    reqs = synth_requests(tcfg, 10, seed=11)
    for r in reqs:
        r.on_done = done.append
        cluster.submit(r)
        cluster.step()
        clock.t += 0.01
    cluster.flush()
    assert sorted(r.uid for r in done) == list(range(10))
    want = M.classify(jax.tree.map(jnp.asarray, fp), jcfg,
                      jnp.asarray(np.stack([r.patches for r in reqs])), top_k=3)
    for i, r in enumerate(reqs):
        assert r.status == "completed" and r.classes[0] == np.asarray(want["classes"])[i, 0]
        np.testing.assert_allclose(r.probs, np.asarray(want["probs"])[i], atol=1e-5, rtol=0)
    snap = cluster.metrics.snapshot()
    frames = [rep["counters"].get("frames", 0) for rep in snap["replicas"]]
    assert all(n > 0 for n in frames) and sum(frames) == 10
    assert snap["aggregate"]["latency_ms"]["n"] == 10
    assert sum(snap["aggregate"]["expert_occupancy"]) == pytest.approx(1.0, abs=1e-5)


def test_vision_engine_evict_and_retirement_skip(vit):
    tcfg = smoke_config(VIT)
    eng = VisionEngine(tcfg, bridge.params_from_numpy(vit[1], "cpu"), batch_buckets=(2,),
                       max_wait_s=0.0, max_inflight=2, device="cpu")
    reqs = synth_requests(tcfg, 5, seed=3)
    for r in reqs:
        eng.submit(r)
    eng._dispatch_ready()
    assert eng.inflight == 4 and eng.load == 5 and eng.free_room == 1024 - 1
    inflight = list(eng._inflight)
    stranded = eng.evict()
    assert [r.uid for r in stranded] == [4, 0, 1, 2, 3] and eng.idle
    assert all(r.evicted for r in stranded)
    eng._inflight.extend(inflight)  # a late retirement of a dropped batch
    eng._retire_one()
    assert reqs[0].classes is None and reqs[0].status == "pending"
    reqs[2].evicted = False
    reqs[2].status = "completed"  # terminal elsewhere: a duplicate
    eng._retire_one()
    assert eng.metrics.counters["duplicate_retirements"] == 1
    assert eng.metrics.counters.get("completed", 0) == 0


def test_launch_serve_replicas_with_a_chaos_kill(capsys, tmp_path):
    out = tmp_path / "events.jsonl"
    serve_main(["--arch", LM, "--smoke", "--device", "cpu", "--quantized", "--replicas", "2",
                "--requests", "6", "--new-tokens", "12", "--slots", "2", "--max-len", "64",
                "--chaos", "--chaos-kill", "1:4", "--events-out", str(out)])
    text = capsys.readouterr().out
    assert "generated 72 tokens" in text and "replicas=1" in text
    assert "status=degraded evicted=1 requests by status {'completed': 6}" in text
    from repro_torch.serving import read_jsonl

    types = [e["type"] for e in read_jsonl(str(out))]
    assert types.count("replica_evicted") == 1 and "request_redispatched" in types
