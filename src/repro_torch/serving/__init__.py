"""Serving stack of the port: micro-batcher, metrics and the vision engine."""
from repro_torch.serving.metrics import EngineMetrics, LatencyTracker, hist_percentile
from repro_torch.serving.scheduler import Backpressure, MicroBatcher
from repro_torch.serving.vision import (
    VisionEngine,
    VisionRequest,
    serving_config,
    synth_requests,
)

__all__ = [
    "Backpressure",
    "EngineMetrics",
    "LatencyTracker",
    "MicroBatcher",
    "VisionEngine",
    "VisionRequest",
    "hist_percentile",
    "serving_config",
    "synth_requests",
]
