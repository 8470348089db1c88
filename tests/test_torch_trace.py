"""The port's serving tracing (``repro_torch/serving/trace.py`` and the
engines' and cluster's trace sites) held against the reference on the CPU.

The same spans give equal Chrome-trace documents in both packages, and both
validators accept and reject the same documents and span lists with the
same messages. The flight recorder keeps its bound, counts its drops and
takes concurrent appends; the disabled tracer records nothing. Traced port
engines at smoke size (seeded random weights, a fake clock that advances a
fixed step a read) satisfy the reference's timeline invariants
(``tests/test_trace.py``): every request's phases are ordered and
contiguous and queue..decode (vision: queue + infer) sum to its recorded
latency within 1e-9 s (float sums of the fake clock's stamps); the untraced
engine holds ``NULL_TRACER`` and still files step times for the MFU join;
a traced two-replica ``ServingCluster`` gives unique trace ids and one
Chrome-trace process per replica. Tracing changes nothing an engine
computes: traced and untraced engines serve the same tokens and classes.
The kernel annotations (``kernels/ops.py``) open one ``record_function``
range per wrapper call, as many as the plain versions are called.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro.serving import trace as jtrace

from repro_torch.configs import TraceConfig, smoke_config
from repro_torch.core.quant.ptq import calibrate_model, ptq_model, quantized_config
from repro_torch.kernels import ops
from repro_torch.models import init_model_params, synth_batch, transformer
from repro_torch.serving import (
    Request,
    ServeEngine,
    ServingCluster,
    VisionEngine,
    serving_config,
    synth_requests,
)
from repro_torch.serving import trace as ttrace

TOL = 1e-9  # float sums of the fake clock's stamps


class FakeClock:
    """Advances ``step`` seconds every read: deterministic, strictly
    increasing stamps."""

    def __init__(self, step: float = 1e-3) -> None:
        self.t = 0.0
        self.step = step
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.t += self.step
            return self.t


def _traced(cfg, **kw):
    return cfg.replace(trace=dataclasses.replace(cfg.trace, enable=True, **kw))


# -- the same spans, the same documents ----------------------------------------


def _scripted_recorders(mod, seed: int, capacity: int):
    """Two replicas' tracers driven by one seeded script of request phases
    and step spans (some requests cut short, a step with attrs)."""
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(2):
        tr = mod.Tracer(capacity=capacity, label=f"replica{r}")
        t = 0.0
        for tid in range(r * 10, r * 10 + int(rng.integers(1, 8))):
            phases = (["queue", "pack", "prefill", "decode", "retire"]
                      if rng.random() < 0.7 else ["queue", "infer", "retire"])
            cut = int(rng.integers(2, len(phases) + 1))
            tr.begin(tid, phases[0], t=t)
            for a, b in zip(phases[:cut - 1], phases[1:cut]):
                t += float(rng.exponential(1e-3))
                tr.transition(tid, a, b, t=t, step=int(rng.integers(9)))
            t += float(rng.exponential(1e-3))
            tr.end(tid, phases[cut - 1], t=t, latency_s=t)
            tr.record_span(f"serve/decode|B=4|S={32 * (r + 1)}", t, t + 1e-3,
                           n=int(rng.integers(1, 5)))
        out[tr.label] = tr.recorder
    return out


@pytest.mark.parametrize("seed,capacity", [(0, 65536), (1, 65536), (2, 7), (3, 3)])
def test_chrome_trace_documents_equal_the_reference(seed, capacity):
    ours = _scripted_recorders(ttrace, seed, capacity)
    ref = _scripted_recorders(jtrace, seed, capacity)
    assert [r.dropped for r in ours.values()] == [r.dropped for r in ref.values()]
    for window in ((None, None), (0.002, None), (None, 0.004), (0.001, 0.003)):
        doc = ttrace.chrome_trace(ours, *window)
        assert doc == jtrace.chrome_trace(ref, *window)
        assert ttrace.validate_chrome_trace(doc) == jtrace.validate_chrome_trace(doc)
    # a bare tracer renders as one process under its label
    tr, jtr = ttrace.Tracer(label="solo"), jtrace.Tracer(label="solo")
    for t in (tr, jtr):
        t.record_span("classify|b=4", 0.0, 0.5, n=4)
    assert ttrace.chrome_trace(tr) == jtrace.chrome_trace(jtr)


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("ValueError", str(e))


_GOOD_EVENT = {"ph": "X", "name": "x", "ts": 0.0, "dur": 1.0, "pid": 0, "tid": 0}
CHROME_DOCS = {
    "good": {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
                              "args": {"name": "r"}}, _GOOD_EVENT]},
    "empty": {"traceEvents": []},
    "no_trace_events": {"events": []},
    "not_a_dict": [],
    "event_not_a_dict": {"traceEvents": [3]},
    "event_without_phase": {"traceEvents": [{"name": "x"}]},
    "metadata_without_args": {"traceEvents": [{"ph": "M", "name": "thread_name"}]},
    "begin_phase": {"traceEvents": [dict(_GOOD_EVENT, ph="B")]},
    "missing_dur": {"traceEvents": [{k: v for k, v in _GOOD_EVENT.items() if k != "dur"}]},
    "missing_tid": {"traceEvents": [{k: v for k, v in _GOOD_EVENT.items() if k != "tid"}]},
    "negative_dur": {"traceEvents": [dict(_GOOD_EVENT, dur=-1.0)]},
}


@pytest.mark.parametrize("case", sorted(CHROME_DOCS))
def test_validate_chrome_trace_agrees_with_the_reference(case):
    doc = CHROME_DOCS[case]
    assert _outcome(ttrace.validate_chrome_trace, doc) == \
        _outcome(jtrace.validate_chrome_trace, doc)


SPAN_LISTS = {
    "good": [(0, "queue", 0.0, 1.0), (0, "pack", 1.0, 2.0), (0, "decode", 2.0, 3.0),
             (1, "queue", 0.0, 1.0), (1, "infer", 1.0, 1.5), (1, "retire", 1.5, 2.0)],
    "out_of_order": [(0, "decode", 0.0, 1.0), (0, "queue", 1.0, 2.0)],
    "overlap": [(1, "queue", 0.0, 2.0), (1, "decode", 1.0, 3.0)],
    "unknown_phase": [(2, "mystery", 0.0, 1.0)],
    "ends_before_start": [(3, "queue", 2.0, 1.0)],
    "repeated_phase": [(4, "queue", 0.0, 1.0), (4, "queue", 1.0, 2.0)],
    "within_eps": [(5, "queue", 0.0, 1.0), (5, "decode", 1.0 - 1e-10, 2.0)],
}


@pytest.mark.parametrize("case", sorted(SPAN_LISTS))
def test_validate_request_timelines_agrees_with_the_reference(case):
    rows = SPAN_LISTS[case]
    ours = [ttrace.Span(tid, name, ttrace.KIND_REQUEST, t0, t1) for tid, name, t0, t1 in rows]
    ref = [jtrace.Span(tid, name, jtrace.KIND_REQUEST, t0, t1) for tid, name, t0, t1 in rows]
    ours.append(ttrace.Span(None, "serve/decode", ttrace.KIND_STEP, 0.0, 1.0))
    ref.append(jtrace.Span(None, "serve/decode", jtrace.KIND_STEP, 0.0, 1.0))
    assert _outcome(ttrace.validate_request_timelines, ours) == \
        _outcome(jtrace.validate_request_timelines, ref)


# -- the flight recorder and the disabled tracer ---------------------------------


def test_flight_recorder_bounded_ring_counts_drops():
    rec = ttrace.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record(ttrace.Span(None, f"s{i}", "step", float(i), float(i) + 0.5))
    assert len(rec) == 4 and rec.total == 10 and rec.dropped == 6
    assert [s.name for s in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert [s.name for s in rec.spans(t0=8.2)] == ["s8", "s9"]
    assert [s.name for s in rec.spans(t1=6.9)] == ["s6"]
    rec.clear()
    assert len(rec) == 0 and rec.total == 0


def test_flight_recorder_concurrent_appends_all_land():
    rec = ttrace.FlightRecorder(capacity=100_000)
    errs = []

    def hammer(k):
        try:
            for i in range(1000):
                rec.record(ttrace.Span(k, "decode", "request", float(i), float(i) + 1))
                if i % 100 == 0:
                    rec.spans()  # a concurrent snapshot must not tear
        except Exception as e:  # pragma: no cover - the failure path
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and rec.total == 8000 and rec.dropped == 0


def test_disabled_tracer_records_nothing():
    assert ttrace.make_tracer(None) is ttrace.NULL_TRACER
    nt = ttrace.make_tracer(TraceConfig(enable=False))
    assert nt is ttrace.NULL_TRACER and not nt.enabled
    nt.begin(0, "queue")
    nt.transition(0, "queue", "decode")
    nt.record_span("serve/decode", 0.0, 1.0)
    nt.end(0, "decode")
    assert nt.recorder.total == 0 and nt.open_count() == 0
    tr = ttrace.make_tracer(TraceConfig(enable=True, capacity=16), label="r0")
    assert tr.enabled and tr.label == "r0" and tr.recorder.capacity == 16


def test_end_without_begin_is_a_silent_noop():
    tr = ttrace.Tracer()
    tr.end(3, "decode", t=1.0)
    assert tr.recorder.total == 0 and tr.open_count() == 0


# -- kernel annotations ------------------------------------------------------------


@pytest.fixture(scope="module")
def olmoe():
    """Smoke OLMoE (serving config): its fp tree and its int8 tree."""
    cfg = serving_config(smoke_config("olmoe-1b-7b"))
    params = init_model_params(cfg, seed=0, device="cpu")
    calib = [torch.from_numpy(synth_batch(cfg, 2, 16, seed=s)) for s in (1, 2)]
    taps = calibrate_model(cfg, params, calib)
    qcfg = quantized_config(cfg)
    return {"fp": (cfg, params),
            "int8": (qcfg, ptq_model(qcfg, params, taps, materialize="int8"))}


def _ranges(fn) -> dict:
    """record_function ranges opened while ``fn`` runs, by wrapper name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for ev in prof.events():
        if "[" in ev.name:
            name = ev.name.split("[", 1)[0]
            out[name] = out.get(name, 0) + 1
    return out


def test_kernel_annotations_open_one_range_per_wrapper_call(olmoe):
    """An int8 forward of L layers calls int8_matmul 5 L + 1 times (q, k, v,
    o, gate; the head), grouped_matmul 2 L, attention L and rmsnorm 4 L + 1;
    annotated, each call is one range; off (the default), none."""
    cfg, params = olmoe["int8"]
    L = cfg.num_layers
    tokens = torch.from_numpy(synth_batch(cfg, 2, 8, seed=4))

    def forward():
        with torch.inference_mode():
            transformer.prefill(params, cfg, tokens, max_len=16)

    assert not ops.kernel_annotations_enabled()
    assert _ranges(forward) == {}
    ttrace.make_tracer(_traced(cfg, annotate_kernels=True).trace)
    try:
        assert ops.kernel_annotations_enabled()
        got = _ranges(forward)
    finally:
        ops.set_kernel_annotations(False)
    assert got == {"int8_matmul": 5 * L + 1, "grouped_matmul": 2 * L, "attention": L,
                   "rmsnorm": 4 * L + 1}


# -- traced engines ----------------------------------------------------------------


def _lm_reqs(cfg, n=5, new=3, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 4 + 3 * i)
                    .astype(np.int32), max_new_tokens=new) for i in range(n)]


def _lm_engine(cfg, params, **kw):
    return ServeEngine(cfg, params, batch_slots=2, max_len=32, device="cpu",
                       clock=FakeClock(), **kw)


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return reqs


def _check_timelines(eng, n, service_phases):
    assert eng.tracer.open_count() == 0
    spans = eng.tracer.recorder.spans()
    assert eng.tracer.recorder.dropped == 0
    assert ttrace.validate_request_timelines(spans) == n
    for tl in ttrace.request_timelines(spans).values():
        names = [s.name for s in tl]
        assert names[0] == "queue" and names[-1] == "retire"
        assert set(names[:-1]) <= set(service_phases)
        service = sum(s.dur for s in tl if s.name != "retire")
        assert abs(service - tl[-1].attrs["latency_s"]) <= TOL
        assert tl[-1].t1 >= tl[-1].t0
    assert ttrace.validate_chrome_trace(ttrace.chrome_trace(eng.tracer)) == len(spans)
    return spans


@pytest.fixture(scope="module")
def ssm():
    cfg = serving_config(smoke_config("falcon-mamba-7b"))
    return cfg, init_model_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("tree", ["fp", "int8"])
def test_traced_packed_engine_timelines_partition_the_latency(olmoe, tree):
    cfg, params = olmoe[tree]
    eng = _lm_engine(_traced(cfg), params)
    assert eng._packed and eng.tracer.enabled
    eng.warmup()
    _serve(eng, _lm_reqs(cfg))
    spans = _check_timelines(eng, 5, ("queue", "pack", "prefill", "decode"))
    steps = {s.name for s in spans if s.kind == ttrace.KIND_STEP}
    assert any(k.startswith("serve/decode|") for k in steps)
    assert any(k.startswith("serve/packed_prefill|") for k in steps)
    assert steps == set(eng.metrics.snapshot()["step_latency_ms"])


def test_traced_grouped_engine_timelines_partition_the_latency(ssm):
    cfg, params = ssm
    eng = _lm_engine(_traced(cfg), params)
    assert not eng._packed
    eng.warmup()
    _serve(eng, _lm_reqs(cfg, n=4))
    spans = _check_timelines(eng, 4, ("queue", "prefill", "decode"))
    steps = {s.name for s in spans if s.kind == ttrace.KIND_STEP}
    assert any(k.startswith("serve/grouped_prefill|") for k in steps)
    assert "serve/decode|B=2|S=32" in steps


@pytest.fixture(scope="module")
def vit():
    cfg = smoke_config("m3vit-small")
    return cfg, init_model_params(cfg, seed=0, device="cpu")


def _vision(cfg, params, **kw):
    return VisionEngine(cfg, params, batch_buckets=(1, 2), max_wait_s=0.0, device="cpu",
                        clock=FakeClock(), **kw)


def test_traced_vision_engine_timelines_partition_the_latency(vit):
    cfg, params = vit
    eng = _vision(_traced(cfg), params)
    eng.warmup()
    reqs = synth_requests(cfg, 4, seed=2)
    for r in reqs:
        eng.submit(r)
        eng.step()
    eng.flush()
    spans = _check_timelines(eng, 4, ("queue", "infer"))
    for tl in ttrace.request_timelines(spans).values():
        assert [s.name for s in tl] == ["queue", "infer", "retire"]
    assert any(k.startswith("classify|b=") for k in eng.metrics.snapshot()["step_latency_ms"])


def test_untraced_engine_holds_null_tracer_and_still_times_steps(olmoe):
    """Tracing off, introspection on (the defaults): no spans, but the
    per-program step histograms the MFU join reads accumulate."""
    cfg, params = olmoe["fp"]
    eng = _lm_engine(cfg, params)
    assert eng.tracer is ttrace.NULL_TRACER and eng._step_times
    _serve(eng, _lm_reqs(cfg, n=2))
    assert eng.metrics.snapshot()["step_latency_ms"] != {}
    assert eng.tracer.recorder.total == 0


def test_engine_without_tracing_or_introspection_times_nothing(olmoe, vit):
    cfg, params = olmoe["fp"]
    off = cfg.replace(introspect=dataclasses.replace(cfg.introspect, enable=False))
    eng = _lm_engine(off, params)
    assert eng.tracer is ttrace.NULL_TRACER and not eng._step_times
    _serve(eng, _lm_reqs(cfg, n=2))
    assert eng.metrics.snapshot()["step_latency_ms"] == {}
    vcfg, vparams = vit
    veng = _vision(vcfg.replace(introspect=off.introspect), vparams)
    assert not veng._step_times
    for r in synth_requests(vcfg, 2, seed=1):
        veng.submit(r)
    veng.flush()
    assert veng.metrics.snapshot()["step_latency_ms"] == {}


@pytest.mark.parametrize("kind", ["packed", "grouped"])
def test_traced_and_untraced_engines_serve_the_same_tokens(olmoe, ssm, kind):
    cfg, params = olmoe["int8"] if kind == "packed" else ssm
    served = []
    for c in (cfg, _traced(cfg, capacity=64)):
        eng = _lm_engine(c, params)
        eng.warmup()
        served.append([r.generated for r in _serve(eng, _lm_reqs(cfg))])
    assert served[0] == served[1]


def test_traced_and_untraced_vision_engines_classify_alike(vit):
    cfg, params = vit
    out = []
    for c in (cfg, _traced(cfg)):
        eng = _vision(c, params)
        reqs = synth_requests(cfg, 3, seed=5)
        for r in reqs:
            eng.submit(r)
        eng.flush()
        out.append(reqs)
    for a, b in zip(*out):
        assert np.array_equal(a.classes, b.classes) and np.array_equal(a.probs, b.probs)


# -- a traced cluster --------------------------------------------------------------


def test_traced_cluster_unique_trace_ids_and_one_process_per_replica(olmoe, tmp_path):
    cfg, params = olmoe["fp"]
    clk = FakeClock()
    cluster = ServingCluster(_traced(cfg), params, replicas=2, engine="lm", batch_slots=2,
                             max_len=32, devices=["cpu"], clock=clk)
    cluster.warmup()
    reqs = _lm_reqs(cfg, n=6)
    for r in reqs:
        r.uid = 0  # colliding uids: trace ids stay unique
        cluster.submit(r)
        cluster.step()
    while cluster.total_load:
        cluster.step()
    cluster.flush()
    recs = cluster.flight_recorders()
    assert sorted(recs) == ["replica0", "replica1"]
    assert all(len(r) for r in recs.values()), "both replicas served"
    spans = [s for r in recs.values() for s in r.spans()]
    assert {s.trace_id for s in spans if s.kind == ttrace.KIND_REQUEST} == set(range(6))
    assert ttrace.validate_request_timelines(spans) == 6
    doc = cluster.export_trace(str(tmp_path / "cluster.json"))
    assert ttrace.validate_chrome_trace(json.loads((tmp_path / "cluster.json").read_text())) \
        == ttrace.validate_chrome_trace(doc) == len(spans)
    names = sorted(e["args"]["name"] for e in doc["traceEvents"]
                   if e["ph"] == "M" and e["name"] == "process_name")
    assert names == ["replica0", "replica1"]
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
