"""The port's serving introspection (``repro_torch/serving/introspect.py``,
``analysis/hw.py``, the introspection half of ``serving/metrics.py`` and
``serving/metrics_server.py``) held against the reference on the CPU.

Exact parity, for the same inputs: ``parse_program_key``; the analytic cost
row of every program key of the port's engines and of the reference's key
shapes, for every config both registries hold (the port's row is the
reference's analytic row: a CUDA graph has no cost analysis);
``param_count`` / ``active_param_count``; ``program_perf`` and the
``export_prometheus`` text (byte for byte) from ``EngineMetrics`` and
``ClusterMetrics`` fed the same records, a retired replica included; the
``ExpertHealthMonitor``'s snapshots and drift events over the same count
streams; ``memory_watermark``'s analytic row; ``param_byte_breakdown`` of
the same int4 tree; ``cluster_healthz`` over the same fake cluster.

The reference's engine-level introspection tests
(``tests/test_introspect.py``) carried over to the port's engines at smoke
size: every program has a cost row, the snapshot joins costs with step
times into MFU, the memory row, a warmup whose cost capture raises, MFU
rows through a scale-down fold, the vision buckets, the metrics endpoint,
``reset_metrics`` keeping the static surface, ``/healthz`` degrading.
The reference's tests of XLA surfaces have no counterpart (no executable
exposes them here): ``test_normalize_cost_analysis_quirks``,
``test_program_cost_from_real_compiled``, and the provenance and
``bench_diff`` tests.
"""
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import smoke_config as ref_smoke_config
from repro.serving import events as ref_events
from repro.serving import introspect as ref_introspect
from repro.serving import metrics as ref_metrics
from repro.serving import metrics_server as ref_server

from repro_torch.analysis import hw
from repro_torch.configs import REGISTRY, smoke_config
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.models import init_model_params, synth_batch
from repro_torch.serving import (
    ClusterMetrics,
    EventLog,
    MetricsServer,
    Request,
    ServeEngine,
    ServingCluster,
    VisionEngine,
    cluster_healthz,
    serving_config,
    synth_requests,
)
from repro_torch.serving import introspect
from repro_torch.serving import metrics as port_metrics
from repro_torch.serving import metrics_server as port_server
from test_torch_faults import PORT, REF, FakeClock, FakeRequest, _cluster

BOTH = sorted(set(REGISTRY) & set(REF_REGISTRY))
KEYS = ["serve/decode|B=8|S=512", "serve/decode|B=2|S=32",
        "serve/packed_prefill|B=8|S=512|bucket=512|n=4",
        "serve/packed_prefill|B=8|S=512|bucket=32|n=1",
        "serve/grouped_prefill|B=8|S=512|L=64|n=8", "serve/grouped_prefill|B=2|S=32|L=5|n=1",
        "classify|b=1", "classify|b=8", "bare", "other|B=3|S=7|x=y"]


@pytest.mark.parametrize("key", KEYS + ["serve/packed_prefill|B=4|S=128|bucket=64|n=3"])
def test_parse_program_key_matches_reference(key):
    assert introspect.parse_program_key(key) == ref_introspect.parse_program_key(key)


@pytest.mark.parametrize("arch", BOTH)
def test_param_counts_match_reference(arch):
    for port, ref in ((REGISTRY[arch], REF_REGISTRY[arch]),
                      (smoke_config(arch), ref_smoke_config(arch))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", BOTH)
def test_analytic_cost_rows_match_reference(arch):
    for port, ref in ((REGISTRY[arch], REF_REGISTRY[arch]),
                      (smoke_config(arch), ref_smoke_config(arch))):
        for key in KEYS:
            for pb, cb in ((0, 0), (7_250_000_000, 268_435_456)):
                want = ref_introspect.analytic_program_cost(key, ref, param_bytes=pb,
                                                            cache_bytes=cb)
                assert introspect.analytic_program_cost(key, port, param_bytes=pb,
                                                        cache_bytes=cb) == want
                assert introspect.capture_cost(key, port, param_bytes=pb,
                                               cache_bytes=cb) == want
    assert introspect.capture_cost("serve/decode|B=4|S=128", None) == \
        ref_introspect.capture_cost(None, "serve/decode|B=4|S=128", None)


# -- engines at smoke size ---------------------------------------------------------


@pytest.fixture(scope="module")
def olmoe():
    cfg = serving_config(smoke_config("olmoe-1b-7b"))
    params = init_model_params(cfg, seed=0, device="cpu")
    calib = [torch.from_numpy(synth_batch(cfg, 2, 16, seed=s)) for s in (1, 2)]
    taps = calibrate_model(cfg, params, calib)
    qcfg = quantized_config(cfg)
    return {"fp": (cfg, params),
            "int8": (qcfg, ptq_model(qcfg, params, taps, materialize="int8")),
            "int4": (qcfg, ptq_model(qcfg, params, taps, materialize="int4"))}


@pytest.fixture(scope="module")
def lm_engine(olmoe):
    cfg, params = olmoe["int8"]
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    eng.warmup()
    rng = np.random.default_rng(0)
    for uid in range(2):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, 8)
                           .astype(np.int32), max_new_tokens=4))
    eng.run_until_drained()
    return eng


def test_engine_cost_rows_equal_the_reference_analytic_rows(lm_engine):
    """Every program key the port's engine built gets the reference's
    analytic row of that key, for the reference's config and the engine's
    param and cache bytes."""
    ref_cfg = dataclasses.replace(ref_smoke_config("olmoe-1b-7b"),
                                  quant=dataclasses.replace(ref_smoke_config(
                                      "olmoe-1b-7b").quant, enable=True))
    pb = introspect.tree_bytes(lm_engine.params)
    cb = introspect.tree_bytes(lm_engine.cache)
    assert pb > 0 and cb > 0
    for key, row in lm_engine.metrics.program_costs.items():
        assert row == ref_introspect.analytic_program_cost(key, ref_cfg, param_bytes=pb,
                                                           cache_bytes=cb), key
        assert row["estimated"] is True and row["source"] == "analytic"
        assert tuple(row) == introspect.PROGRAM_COST_FIELDS == ref_introspect.PROGRAM_COST_FIELDS


def test_every_lm_program_has_cost_row(lm_engine):
    assert lm_engine._programs
    missing = set(lm_engine._programs) - set(lm_engine.metrics.program_costs)
    assert not missing, f"programs without cost rows: {missing}"


def test_lm_snapshot_has_mfu_join(lm_engine):
    """MFU = flops / (p50 step s x peak). A smoke model on the CPU against
    the H100's int8 peak reads below 5e-7 (and its bytes a second below
    1e6), which the row's decimals round to 0: the row is checked against
    the join computed from its own inputs."""
    m = lm_engine.metrics
    perf = m.snapshot()["program_perf"]
    measured = {k: v for k, v in perf.items() if v.get("mfu") is not None}
    assert measured, "served programs must join cost x step time into MFU"
    for key, row in measured.items():
        sec = m.step_latency[key].percentile(50)
        assert row["flops"] > 0 and row["hbm_bytes"] > 0 and sec > 0
        assert row["mfu"] == round(row["flops"] / sec / m.peaks["peak_flops"], 6) < 1.5
        assert row["achieved_hbm_gbps"] == round(row["hbm_bytes"] / sec / 1e9, 3)
        assert row["bound"] in ("compute", "memory", "collective")


def test_lm_snapshot_has_memory_block(lm_engine):
    mem = lm_engine.metrics.snapshot()["memory"]
    assert mem is not None and mem["source"] == "analytic" and mem["estimated"]
    assert mem["watermark_bytes"] == mem["param_bytes"] + mem["kv_cache_bytes"] > 0
    assert mem["expert_stack_bytes"] > 0


def test_lm_peaks_are_the_int8_row_assumed_on_the_cpu(lm_engine, olmoe):
    peaks = lm_engine.metrics.peaks
    assert peaks["assumed"] is True and peaks["device_kind"] == "cpu"
    assert peaks["peak_kind"] == "int8" and peaks["peak_flops"] == 1979e12
    assert peaks["hbm_bw"] == 3.35e12 and peaks["ici_bw"] == 450e9
    assert peaks == hw.device_peaks(torch.device("cpu"), use_int8=True)
    fp_cfg, fp = olmoe["fp"]
    assert not hw.pick_int8(fp, fp_cfg.quant.enable)
    assert hw.pick_int8(fp, True)
    assert hw.pick_int8(olmoe["int8"][1]) and hw.pick_int8(olmoe["int4"][1])


def test_warmup_survives_cost_capture_failure(olmoe, monkeypatch):
    """A cost capture that raises on every program leaves the programs
    without rows, and the warmup, the peaks and the memory row intact."""
    def broken(*a, **k):
        raise RuntimeError("cost capture unavailable")

    monkeypatch.setattr(introspect, "capture_cost", broken)
    cfg, params = olmoe["int8"]
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    eng.warmup()  # must not raise
    assert eng._programs and eng.metrics.program_costs == {}
    assert eng.metrics.peaks is not None
    assert eng.metrics.snapshot()["memory"] is not None


def test_mfu_survives_scale_down_fold(lm_engine):
    cm = ClusterMetrics([lm_engine.metrics])
    live = cm.snapshot()["aggregate"]["program_perf"]
    assert any(v.get("mfu") is not None for v in live.values())
    cm.remove_replica(lm_engine.metrics)
    folded = cm.snapshot()["aggregate"]["program_perf"]
    assert any(v.get("mfu") is not None for v in folded.values())


@pytest.fixture(scope="module")
def vision_engine():
    cfg = smoke_config("m3vit-small")
    params = init_model_params(cfg, seed=0, device="cpu")
    eng = VisionEngine(cfg, params, batch_buckets=(1, 2), max_wait_s=0.0, max_pending=0,
                       device="cpu")
    eng.warmup()
    for r in synth_requests(cfg, 4, seed=0):
        eng.submit(r)
    eng.flush()
    return eng


def test_every_vision_bucket_has_cost_row(vision_engine):
    assert {"classify|b=1", "classify|b=2"} <= set(vision_engine.metrics.program_costs)


def test_vision_snapshot_has_mfu_join(vision_engine):
    snap = vision_engine.metrics.snapshot()
    assert any(v.get("mfu") is not None for v in snap["program_perf"].values())
    assert snap["expert_health"] is not None


def _get(url):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # local only
    with opener.open(url, timeout=5) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_metrics_server_routes(lm_engine):
    cm = ClusterMetrics([lm_engine.metrics])
    with MetricsServer(cm.export_prometheus, snapshot_fn=cm.snapshot,
                       healthz_fn=lambda: {"status": "ok"}) as srv:
        status, ctype, body = _get(srv.url + "/metrics")
        assert status == 200 and "text/plain" in ctype
        text = body.decode()
        assert "repro_program_mfu" in text and "repro_replica_memory_bytes" in text
        for key in lm_engine.metrics.snapshot()["step_latency_ms"]:
            assert f'repro_step_latency_seconds_count{{program="{key}"}}' in text
        for line in text.splitlines():
            if line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])  # every sample value parses
        status, _, body = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, _, body = _get(srv.url + "/snapshot")
        assert status == 200 and isinstance(json.loads(body), dict)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404


def test_reset_metrics_keeps_static_cost_surface(lm_engine):
    # after the endpoint test: a fresh EngineMetrics, the static surface kept
    lm_engine.reset_metrics()
    assert lm_engine.metrics.program_costs and lm_engine.metrics.peaks is not None
    assert lm_engine.metrics.memory_probe is not None
    assert lm_engine.metrics.expert_health is lm_engine.expert_health is not None


def test_healthz_degrades_on_errors():
    class _C:
        class metrics:
            @staticmethod
            def snapshot():
                return {"replicas_active": 1,
                        "aggregate": {"counters": {"retire_errors": 1, "completed": 3}}}

    hz = cluster_healthz(_C())
    assert hz == ref_server.cluster_healthz(_C())
    assert hz["status"] == "degraded" and hz["retire_errors"] == 1 and hz["completed"] == 3


@pytest.mark.parametrize("wedge", [False, True])
def test_cluster_healthz_matches_reference(wedge):
    """The same fake cluster on both packages (one replica wedged: evicted,
    the standby promoted) answers the same ``/healthz`` body."""
    out = []
    for side in (REF, PORT):
        clock = FakeClock()
        cluster, built = _cluster(side, clock, replicas=2, standby=1, capacity=1)
        for i in range(6):
            cluster.submit(FakeRequest(uid=i))
        if wedge:
            built[1].fail = RuntimeError("wedged")
        for _ in range(8):
            cluster.step()
            clock.advance(0.01)
        out.append((ref_server if side is REF else port_server).cluster_healthz(cluster))
    assert out[0] == out[1]
    if wedge:
        assert [e["reason"] for e in out[1]["evicted"]] == ["step_errors"]
    else:
        assert out[1]["status"] == "ok" and not out[1]["evicted"]


def test_cluster_healthz_over_a_port_cluster(olmoe):
    cfg, params = olmoe["fp"]
    cluster = ServingCluster(cfg, params, replicas=2, engine="lm", batch_slots=2, max_len=32,
                             devices=["cpu"])
    hz = cluster_healthz(cluster)
    assert hz["status"] == "ok" and hz["replicas_active"] == 2
    assert sorted(hz["replicas"]) == ["replica0", "replica1"]


# -- the metrics join and the Prometheus text, record for record -------------------


def _feed(mod, clock):
    """Two replicas' metrics fed one script (counters, latencies, steps,
    cost rows, peaks, memory, expert tokens); the second replica leaves."""
    ms = [mod.EngineMetrics(num_experts=4, clock=clock) for _ in range(2)]
    peaks = {"device_kind": "nvidia h100 80gb hbm3", "assumed": False, "peak_kind": "int8",
             "peak_flops": 1979e12, "peak_flops_bf16": 989e12, "peak_flops_int8": 1979e12,
             "hbm_bw": 3.35e12, "ici_bw": 450e9}
    rng = np.random.default_rng(7)
    for r, m in enumerate(ms):
        m.set_peaks(peaks)
        for key in KEYS[:5]:
            m.set_program_cost(key, ref_introspect.analytic_program_cost(
                key, ref_smoke_config("olmoe-1b-7b"), param_bytes=10_000 * (r + 1),
                cache_bytes=512))
        m.set_program_cost("serve/decode|B=8|S=512", dict(
            m.program_costs["serve/decode|B=8|S=512"], estimated=bool(r), flops=-1.0))
        m.set_memory({"param_bytes": 1000 + r, "kv_cache_bytes": 500, "watermark_bytes": 2000,
                      "bytes_in_use": 1800, "bytes_limit": 80 * 2 ** 30, "estimated": False,
                      "source": "device", "expert_stack_bytes": 700})
        m.inc("submitted", 5)
        clock.advance(0.5)
        for i in range(40):
            m.record_step(KEYS[i % 3], float(rng.lognormal(-6, 0.5)))
            m.request_latency.record(float(rng.lognormal(-3, 0.7)))
            m.queue_wait.record(float(rng.lognormal(-7, 1.0)))
            m.batch_latency.record(float(rng.lognormal(-5, 0.3)))
            m.add_expert_tokens(rng.integers(0, 9, 4))
        m.inc("completed", 5)
        m.work_done(40, "tokens")
        clock.advance(0.25)
    cm = mod.ClusterMetrics(ms, clock=clock)
    cm.inc("cluster_submitted", 10)
    cm.observe_queue_depth(3)
    cm.mark_replicas(2)
    cm.remove_replica(ms[1])
    cm.mark_replicas(1)
    return ms, cm


def test_program_perf_and_prometheus_text_match_reference():
    cr, cp = FakeClock(), FakeClock()
    (r0, _), rcm = _feed(ref_metrics, cr)
    (p0, _), pcm = _feed(port_metrics, cp)
    assert port_metrics.program_perf(p0.program_costs, p0.step_latency, p0.peaks) == \
        ref_metrics.program_perf(r0.program_costs, r0.step_latency, r0.peaks)
    ps, rs = p0.snapshot(), r0.snapshot()
    assert ps["program_perf"] == rs["program_perf"] and ps["memory"] == rs["memory"]
    pa, ra = pcm.snapshot(), rcm.snapshot()
    for key in ("program_perf", "memory", "counters", "step_latency_ms", "expert_health"):
        assert pa["aggregate"][key] == ra["aggregate"][key], key
    assert pcm.merged_program_costs() == rcm.merged_program_costs()
    assert pcm.merged_peaks() == rcm.merged_peaks()
    text = pcm.export_prometheus()
    assert text == rcm.export_prometheus()
    assert 'repro_program_roofline_bound{program="serve/decode|B=2|S=32",bound=' in text


def test_program_perf_rows_without_costs_or_steps_match_reference():
    steps_p, steps_r = {}, {}
    for mod, steps in ((port_metrics, steps_p), (ref_metrics, steps_r)):
        t = steps["classify|b=8"] = mod.LatencyTracker()
        t.record(0.004)
    costs = {"classify|b=1": {"flops": 2e9, "hbm_bytes": -1.0, "estimated": True,
                              "source": "analytic"}}
    for peaks in (None, {"peak_flops": 1e15, "hbm_bw": 0, "ici_bw": 0}):
        assert port_metrics.program_perf(costs, steps_p, peaks) == \
            ref_metrics.program_perf(costs, steps_r, peaks)


# -- expert health -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_expert_health_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    E = 8
    logs = (EventLog(clock=lambda: 1.0), ref_events.EventLog(clock=lambda: 1.0))
    fired = ([], [])
    mons = [mod.ExpertHealthMonitor(E, window_tokens=64, drift_threshold=0.2,
                                    baseline_alpha=0.2, events=log, label="lm",
                                    on_drift=f.append, clock=lambda: 1.0)
            for mod, log, f in zip((introspect, ref_introspect), logs, fired)]
    for step in range(60):
        hot = (step // 20) % E  # the routing regime moves every 20 steps
        p = np.full(E, 1.0)
        p[hot] = 1.0 + 10.0 * rng.random()
        counts = rng.multinomial(24, p / p.sum())
        for m in mons:
            m.update(counts)
        assert mons[0].snapshot() == mons[1].snapshot()
    assert mons[0].windows > 10 and mons[0].drift_events >= 1
    assert fired[0] == fired[1]
    assert logs[0].events() == logs[1].events()


def test_expert_drift_feeds_the_engine_counter(olmoe):
    cfg, params = olmoe["fp"]
    tight = cfg.replace(introspect=dataclasses.replace(
        cfg.introspect, drift_window_tokens=8, drift_threshold=0.05))
    events = EventLog()
    eng = ServeEngine(tight, params, batch_slots=2, max_len=32, device="cpu", events=events)
    assert eng.metrics.expert_health is eng.expert_health
    for counts in ([8, 0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0, 8]):
        eng.metrics.add_expert_tokens(counts)
    assert eng.metrics.counters.get("expert_drift") == 1
    (ev,) = events.events("expert_drift")
    assert ev["label"] == "lm" and ev["hot_expert"] == 7


# -- memory and parameter bytes ------------------------------------------------------


def test_memory_watermark_analytic_row_matches_reference():
    kw = dict(param_bytes=1000, cache_bytes=500, program_costs={"k": {"temp_bytes": 200.0}},
              param_breakdown={"by_dtype": {"int8": 900, "float32": 100},
                               "expert_stack_bytes": 600, "int4_packed_bytes": 0})
    mem = introspect.memory_watermark([torch.device("cpu")], **kw)
    assert mem == ref_introspect.memory_watermark(jax.devices(), **kw)
    assert mem["estimated"] and mem["source"] == "analytic"
    assert mem["watermark_bytes"] == 1700


@pytest.mark.parametrize("tree", ["fp", "int8", "int4"])
def test_param_byte_breakdown_matches_reference(olmoe, tree):
    params = olmoe[tree][1]

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        return jnp.asarray(t.numpy())

    jtree = to_jax(params)
    assert introspect.param_byte_breakdown(params) == ref_introspect.param_byte_breakdown(jtree)
    assert introspect.tree_bytes(params) == ref_introspect.tree_bytes(jtree)
    b = introspect.param_byte_breakdown(params)
    assert (b["int4_packed_bytes"] > 0) == (tree == "int4")
    assert b["expert_stack_bytes"] > 0
