"""Serving stack of the port: micro-batcher, metrics, event log, tracing and
introspection, the vision engine, the continuous-batching LM engine (both
single-device or expert-parallel over an EP mesh), the multi-replica
cluster with its fault model and autoscaler, and the live metrics
endpoint."""
from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.cluster import ServingCluster, replica_devices, replica_meshes
from repro_torch.serving.engine import Request, ServeEngine, serving_config
from repro_torch.serving.events import EventLog, read_jsonl
from repro_torch.serving.faults import (
    FaultInjector,
    FaultyReplica,
    InjectedFault,
    InjectedOOM,
    ReplicaWatchdog,
    is_oom_error,
)
from repro_torch.serving.introspect import (
    ExpertHealthMonitor,
    capture_cost,
    memory_watermark,
    parse_program_key,
)
from repro_torch.serving.metrics import (
    ClusterMetrics,
    EngineMetrics,
    LatencyTracker,
    hist_percentile,
    program_perf,
)
from repro_torch.serving.metrics_server import (
    MetricsServer,
    cluster_healthz,
    serve_cluster_metrics,
)
from repro_torch.serving.replica import EngineReplica
from repro_torch.serving.scheduler import Backpressure, MicroBatcher, PackPlan
from repro_torch.serving.trace import (
    FlightRecorder,
    Span,
    Tracer,
    chrome_trace,
    make_tracer,
    validate_chrome_trace,
    validate_request_timelines,
    write_chrome_trace,
)
from repro_torch.serving.vision import VisionEngine, VisionRequest, synth_requests

__all__ = [
    "Autoscaler",
    "Backpressure",
    "ClusterMetrics",
    "EngineMetrics",
    "EngineReplica",
    "EventLog",
    "ExpertHealthMonitor",
    "FaultInjector",
    "FaultyReplica",
    "FlightRecorder",
    "InjectedFault",
    "InjectedOOM",
    "LatencyTracker",
    "MetricsServer",
    "MicroBatcher",
    "PackPlan",
    "ReplicaWatchdog",
    "Request",
    "ServeEngine",
    "ServingCluster",
    "Span",
    "Tracer",
    "VisionEngine",
    "VisionRequest",
    "capture_cost",
    "chrome_trace",
    "cluster_healthz",
    "hist_percentile",
    "is_oom_error",
    "make_tracer",
    "memory_watermark",
    "parse_program_key",
    "program_perf",
    "read_jsonl",
    "replica_devices",
    "replica_meshes",
    "serve_cluster_metrics",
    "serving_config",
    "synth_requests",
    "validate_chrome_trace",
    "validate_request_timelines",
    "write_chrome_trace",
]
