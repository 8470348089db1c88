"""Serving stack of the port: micro-batcher, metrics, the vision engine and
the continuous-batching LM engine."""
from repro_torch.serving.engine import Request, ServeEngine, serving_config
from repro_torch.serving.metrics import EngineMetrics, LatencyTracker, hist_percentile
from repro_torch.serving.scheduler import Backpressure, MicroBatcher, PackPlan
from repro_torch.serving.vision import VisionEngine, VisionRequest, synth_requests

__all__ = [
    "Backpressure",
    "EngineMetrics",
    "LatencyTracker",
    "MicroBatcher",
    "PackPlan",
    "Request",
    "ServeEngine",
    "VisionEngine",
    "VisionRequest",
    "hist_percentile",
    "serving_config",
    "synth_requests",
]
