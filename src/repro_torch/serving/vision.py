"""Vision serving engine: dynamic-batching MoE-ViT inference, ported from
``repro.serving.vision``.

Request path: submit(VisionRequest) -> MicroBatcher (bucketed admission,
max-wait deadline, backpressure) -> padded bucket batch -> ``classify`` on
the engine's device (fp, fake-quant and materialized-int8 trees all flow
through the same ``quant_linear`` seam) -> top-k class responses +
per-expert routed-token occupancy.

Dispatch is double-buffered: up to ``max_inflight`` batches are outstanding
at once. On a card, ``classify`` only enqueues kernels on the current CUDA
stream and returns; a CUDA event recorded after each batch says when its
work has finished, and retirement synchronizes by copying the results to
the host. Batch shapes are quantized to the ``batch_buckets`` ladder (zero
pad rows). The reference's mesh/expert-parallel placement, tracer, event
log, introspection and autotuning are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import require_device, tree_to
from repro_torch.models.vit import PATCH_DIM, classify
from repro_torch.serving.engine import serving_config
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.scheduler import MicroBatcher


@dataclasses.dataclass
class VisionRequest:
    """One image to classify. ``patches`` is the flattened patch sequence
    [image_tokens - 1, PATCH_DIM]; results are filled in at retirement."""

    uid: int
    patches: np.ndarray
    classes: Optional[np.ndarray] = None  # [k] int32, most-probable first
    probs: Optional[np.ndarray] = None  # [k] f32, descending
    latency_s: Optional[float] = None
    submitted_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.classes is not None


class _InFlight(NamedTuple):
    reqs: tuple  # the real requests in this device batch
    pad_to: int  # padded batch size actually dispatched
    out: dict  # device tensors from classify (not yet synchronized)
    finished: Optional[torch.cuda.Event]  # recorded after the batch (card)
    dispatched_at: float


class VisionEngine:
    """Dynamic-batching MoE-ViT classifier engine on one device (the card
    unless ``device="cpu"``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch_buckets: Sequence[int] = (1, 4, 8),
        max_wait_s: float = 2e-3,
        max_pending: int = 1024,
        top_k: int = 5,
        max_inflight: int = 2,
        device="cuda",
    ) -> None:
        if cfg.family not in ("vit", "vit_moe"):
            raise ValueError(f"vision families only, got {cfg.family!r}")
        self.device = require_device(device)
        self.cfg = serving_config(cfg)
        self.params = tree_to(params, self.device)
        self.top_k = min(top_k, cfg.num_classes)
        self.n_patches = cfg.image_tokens - 1
        self.scheduler = MicroBatcher(
            batch_sizes=batch_buckets, max_wait_s=max_wait_s,
            max_pending=max_pending,
        )
        self.metrics = EngineMetrics(
            num_experts=cfg.moe.num_experts if cfg.moe is not None else 0)
        self.max_inflight = max(1, int(max_inflight))
        self._inflight: deque = deque()

    # -- lifecycle ----------------------------------------------------------

    def _classify(self, x: torch.Tensor) -> dict:
        with torch.inference_mode():
            return classify(self.params, self.cfg, x, top_k=self.top_k)

    def warmup(self) -> None:
        """Run every bucket size once (builds the kernels and warms the
        allocator outside the measured serving path)."""
        for b in self.scheduler.batch_sizes:
            x = torch.zeros((b, self.n_patches, PATCH_DIM), device=self.device)
            self._classify(x)["classes"].cpu()

    @property
    def inflight(self) -> int:
        """Requests inside dispatched (not yet retired) device batches."""
        return sum(len(f.reqs) for f in self._inflight)

    @property
    def idle(self) -> bool:
        return self.scheduler.depth == 0 and not self._inflight

    def submit(self, req: VisionRequest) -> None:
        """Enqueue one image; raises ``scheduler.Backpressure`` when the
        pending queue is at ``max_pending``."""
        if req.submitted_at is None:
            req.submitted_at = time.monotonic()
        try:
            self.scheduler.submit(req)
        except Exception:
            self.metrics.inc("rejected")
            raise
        self.metrics.inc("submitted")
        self.metrics.observe_queue_depth(self.scheduler.depth)

    def step(self) -> None:
        """One pump: retire finished batches, force-retire the oldest if the
        in-flight window is still full, then dispatch every ready batch the
        window has room for."""
        while self._inflight and self._head_ready():
            self._retire_one()
        if len(self._inflight) >= self.max_inflight:
            self._retire_one()
        self._dispatch_ready()

    def flush(self) -> None:
        """Drain: release partial batches immediately, dispatch everything
        queued, and retire every in-flight batch."""
        self.scheduler.drain(True)
        try:
            while self.scheduler.depth or self._inflight:
                self._dispatch_ready()
                if self._inflight:
                    self._retire_one()
        finally:
            self.scheduler.drain(False)

    # -- internals ----------------------------------------------------------

    def _head_ready(self) -> bool:
        """Whether the oldest in-flight batch's device work has finished
        (on the CPU the forward ran synchronously)."""
        finished = self._inflight[0].finished
        return finished is None or finished.query()

    def _dispatch_ready(self) -> None:
        while len(self._inflight) < self.max_inflight:
            batch = self.scheduler.poll()
            if batch is None:
                return
            reqs = batch.items
            x = np.zeros((batch.pad_to, self.n_patches, PATCH_DIM), np.float32)
            for i, r in enumerate(reqs):
                x[i] = r.patches
            t0 = time.monotonic()
            for r in reqs:
                self.metrics.queue_wait.record(max(0.0, t0 - r.submitted_at))
            xt = torch.from_numpy(x)
            finished = None
            if self.device.type == "cuda":
                # pinned + non_blocking: the copy queues behind the batch in
                # flight instead of blocking the host until it finishes
                xt = xt.pin_memory().to(self.device, non_blocking=True)
                out = self._classify(xt)
                finished = torch.cuda.Event()
                finished.record()
            else:
                out = self._classify(xt)
            self._inflight.append(_InFlight(reqs, batch.pad_to, out, finished, t0))
            self.metrics.inc("batches")
            self.metrics.inc("padded_frames", batch.pad_to - len(reqs))
            self.metrics.inc("pack_real_tokens", len(reqs) * self.n_patches)
            self.metrics.inc("pack_pad_tokens",
                             (batch.pad_to - len(reqs)) * self.n_patches)
            self.metrics.observe_queue_depth(self.scheduler.depth)

    def _retire_one(self) -> None:
        ent = self._inflight.popleft()
        classes = ent.out["classes"].cpu().numpy()  # synchronizes the batch
        probs = ent.out["probs"].cpu().numpy()
        expert_tokens = ent.out["expert_tokens"].cpu().numpy()
        now = time.monotonic()
        self.metrics.batch_latency.record(now - ent.dispatched_at)
        self.metrics.record_step(f"classify|b={ent.pad_to}",
                                 now - ent.dispatched_at)
        if expert_tokens.size:
            # includes the pad rows' routed tokens (see padded_frames)
            self.metrics.add_expert_tokens(expert_tokens)
        for i, req in enumerate(ent.reqs):
            req.classes = classes[i]
            req.probs = probs[i]
            req.latency_s = now - req.submitted_at
            self.metrics.request_latency.record(req.latency_s)
            self.metrics.inc("completed")
        self.metrics.work_done(len(ent.reqs), "frames")


def synth_requests(cfg: ModelConfig, n: int, seed: int = 0,
                   scale: float = 1.0) -> List[VisionRequest]:
    """n synthetic image-patch requests (the reference's generator: same
    seed, same patches)."""
    rng = np.random.default_rng(seed)
    T = cfg.image_tokens - 1
    return [
        VisionRequest(
            uid=i,
            patches=(scale * rng.standard_normal((T, PATCH_DIM)))
            .astype(np.float32),
        )
        for i in range(n)
    ]
