"""Serving stack of the port: micro-batcher, metrics, event log, the vision
engine, the continuous-batching LM engine, and the multi-replica cluster
with its fault model and autoscaler."""
from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.cluster import ServingCluster, replica_devices
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
from repro_torch.serving.metrics import (
    ClusterMetrics,
    EngineMetrics,
    LatencyTracker,
    hist_percentile,
)
from repro_torch.serving.replica import EngineReplica
from repro_torch.serving.scheduler import Backpressure, MicroBatcher, PackPlan
from repro_torch.serving.vision import VisionEngine, VisionRequest, synth_requests

__all__ = [
    "Autoscaler",
    "Backpressure",
    "ClusterMetrics",
    "EngineMetrics",
    "EngineReplica",
    "EventLog",
    "FaultInjector",
    "FaultyReplica",
    "InjectedFault",
    "InjectedOOM",
    "LatencyTracker",
    "MicroBatcher",
    "PackPlan",
    "ReplicaWatchdog",
    "Request",
    "ServeEngine",
    "ServingCluster",
    "VisionEngine",
    "VisionRequest",
    "hist_percentile",
    "is_oom_error",
    "read_jsonl",
    "replica_devices",
    "serving_config",
    "synth_requests",
]
