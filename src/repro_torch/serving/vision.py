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
pad rows), and each bucket has its program (``classify|b=<bucket>``, the
reference's one jitted program a bucket): on the card with
``serve.aot_warmup`` a CUDA graph that ``warmup()`` captures
(``serving/programs.py``), whose outputs each dispatch clones, so a replay
never overwrites a batch still in flight; with ``aot_warmup=False``, and on
the CPU, ``classify`` run eagerly.

The engine is an ``EngineReplica`` (``serving/replica.py``): ``load``,
``free_room``, ``reset_metrics`` and ``evict``, which hands back every queued
and dispatched request for the cluster to re-dispatch; retirement skips an
evicted or already-terminal request and fires ``on_done`` once. ``clock=``
injects a fake clock and ``events=`` an ``EventLog``.

Observability, as in the reference: a request's timeline is queue -> infer
-> retire (one batched forward is the service), each batch a
``classify|b=..`` step span, on the host clock (``tracer``,
``serving/trace.py``); with tracing's ``step_times`` or
``cfg.introspect.enable`` (the default) each batch's time is filed under its
program key: on the card its device time, from CUDA events the captured
graph records at its first and last node, read at retirement
(``programs.StepTimer``), on the CPU the host time from dispatch to
retirement. ``warmup()`` installs the introspection rows,
and an MoE config feeds the ``ExpertHealthMonitor`` ``expert_health``.

Autotuning, as in the reference: with ``cfg.autotune.enable``, ``warmup()``
first runs ``kernels/autotune.py:ensure_tuned`` over ``_tune_trace`` (each
bucket's ``classify`` once, eagerly); the graphs are captured after, and
each keeps the grouped kernel's variant that the table picked at its
capture.

Expert parallelism, as in the reference: an expert-parallel config
(``cfg.moe.moe_exec == "expert_parallel"``) takes ``mesh=``, and each
bucket's program, eager or captured, runs inside ``use_ep_mesh(mesh)``
(``distributed/expert_parallel.py``); the engine runs on the slots' one
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.expert_parallel import engine_placement, in_ep_mesh, use_ep_mesh
from repro_torch.kernels import autotune
from repro_torch.models.param import tree_to
from repro_torch.models.vit import PATCH_DIM, classify
from repro_torch.serving import introspect
from repro_torch.serving.engine import serving_config
from repro_torch.serving.events import EventLog
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.programs import (
    EagerProgram,
    GraphProgram,
    PinnedRing,
    StepTimer,
    own,
)
from repro_torch.serving.scheduler import MicroBatcher
from repro_torch.serving.trace import make_tracer


@dataclasses.dataclass
class VisionRequest:
    """One image to classify. ``patches`` is the flattened patch sequence
    [image_tokens - 1, PATCH_DIM]; results are filled in at retirement."""

    uid: int
    patches: np.ndarray
    classes: Optional[np.ndarray] = None  # [k] int32, most-probable first
    probs: Optional[np.ndarray] = None  # [k] f32, descending
    latency_s: Optional[float] = None
    # None = not yet admitted; a 0.0 stamp from a fake clock is a real stamp
    submitted_at: Optional[float] = None
    # cluster-wide identity, assigned by the cluster front-end at submit
    trace_id: Optional[int] = None
    # terminal-delivery callback (``Request.on_done``'s contract): fired
    # once at retirement
    on_done: Optional[Callable[["VisionRequest"], None]] = None
    # lifecycle and eviction bookkeeping, as on ``engine.Request``
    status: str = dataclasses.field(default="pending", repr=False)
    redispatched: int = dataclasses.field(default=0, repr=False)
    evicted: bool = dataclasses.field(default=False, repr=False)

    @property
    def done(self) -> bool:
        return self.classes is not None


class _InFlight(NamedTuple):
    reqs: tuple  # the real requests in this device batch
    pad_to: int  # padded batch size actually dispatched
    out: dict  # device tensors from classify (not yet synchronized)
    finished: Optional[torch.cuda.Event]  # recorded after the batch (card)
    dispatched_at: float
    step: Optional[tuple]  # StepTimer mark of the replay (card), else None


class VisionEngine:
    """Dynamic-batching MoE-ViT classifier engine on one device (the card
    unless ``device="cpu"``; ``mesh=``, which an expert-parallel config
    requires, pins it to its slots' device instead)."""

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
        events: Optional[EventLog] = None,
        clock: Callable[[], float] = time.monotonic,
        mesh=None,
    ) -> None:
        if cfg.family not in ("vit", "vit_moe"):
            raise ValueError(f"vision families only, got {cfg.family!r}")
        self.cfg = serving_config(cfg)
        self.mesh = mesh
        self._ep, self.device = engine_placement(self.cfg, mesh, device)
        # the same tensors when the tree is on this device already: replicas
        # on one card share one copy of the weights
        self.params = tree_to(params, self.device)
        self.events = events
        # vision timelines are queue -> infer -> retire
        self.tracer = make_tracer(self.cfg.trace, clock=clock)
        self._step_times = ((self.tracer.enabled and self.cfg.trace.step_times)
                            or self.cfg.introspect.enable)
        self._timer = StepTimer(self.device)
        self._clock = clock
        self.top_k = min(top_k, cfg.num_classes)
        self.n_patches = cfg.image_tokens - 1
        self.scheduler = MicroBatcher(
            batch_sizes=batch_buckets, max_wait_s=max_wait_s,
            max_pending=max_pending, clock=clock,
        )
        self.metrics = EngineMetrics(
            num_experts=cfg.moe.num_experts if cfg.moe is not None else 0,
            clock=clock)
        self.expert_health = None
        if self.cfg.introspect.enable and cfg.moe is not None:
            self.expert_health = introspect.ExpertHealthMonitor(
                cfg.moe.num_experts,
                window_tokens=self.cfg.introspect.drift_window_tokens,
                drift_threshold=self.cfg.introspect.drift_threshold,
                baseline_alpha=self.cfg.introspect.baseline_alpha,
                events=events, label="vision", clock=clock,
                on_drift=introspect.drift_counter(self))
            self.metrics.expert_health = self.expert_health
        self.max_inflight = max(1, int(max_inflight))
        self._inflight: deque = deque()
        # one program a bucket; on the card with aot_warmup each is a CUDA
        # graph (one side stream, one memory pool, pinned input staging)
        self._programs: dict = {}
        self._graphs = self.device.type == "cuda" and self.cfg.serve.aot_warmup
        if self._graphs:
            # the replica's own pool and capture stream, made on its card
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            self._ring = PinnedRing(4 * max(self.scheduler.batch_sizes) * self.n_patches
                                    * PATCH_DIM, depth=self.max_inflight + 2)

    # -- lifecycle ----------------------------------------------------------

    def _compiled(self, b: int, count_miss: bool = True):
        """The program of bucket ``b``, built on a miss (which adds to
        ``retraces`` when it happens while serving)."""
        key = f"classify|b={b}"
        prog = self._programs.get(key)
        if prog is None:
            if count_miss:
                self.metrics.inc("retraces")
            params, cfg, k = self.params, self.cfg, self.top_k

            def fn(x):
                return classify(params, cfg, x, top_k=k)

            if self._ep:
                fn = in_ep_mesh(fn, self.mesh)
            with torch.inference_mode():
                prog = self._programs[key] = (
                    GraphProgram(fn, [np.zeros((b, self.n_patches, PATCH_DIM), np.float32)],
                                 device=self.device, pool=self._pool, stream=self._stream,
                                 ring=self._ring)
                    if self._graphs else EagerProgram(fn, self.device))
        return prog

    def _tune_trace(self) -> None:
        """Every bucket's ``classify`` run once, eagerly, on zero patches,
        so that the autotuner's ``collecting()`` scope records the kernel
        keys this replica's programs hit (the reference traces them with
        ``jax.eval_shape``); inside the EP mesh's scope, so an
        expert-parallel replica records its per-slot shapes."""
        for b in self.scheduler.batch_sizes:
            x = torch.zeros((b, self.n_patches, PATCH_DIM), device=self.device)
            with torch.inference_mode(), self._ep_scope():
                classify(self.params, self.cfg, x, top_k=self.top_k)

    def _ep_scope(self):
        return use_ep_mesh(self.mesh) if self._ep else contextlib.nullcontext()

    def warmup(self) -> None:
        """Build every bucket's program outside the measured serving path
        (on the card with ``aot_warmup``: capture its graph; eagerly: run
        it once, which builds the kernels and warms the allocator), then
        install the introspection rows: a cost row per bucket. With
        ``cfg.autotune.enable`` the kernels are tuned first
        (``autotune.ensure_tuned`` over ``_tune_trace``), before any graph
        is captured, so each graph keeps the tuned picks."""
        if self.cfg.autotune.enable:
            autotune.ensure_tuned(self.cfg.autotune, self._tune_trace, device=self.device)
        for b in self.scheduler.batch_sizes:
            prog = self._compiled(b, count_miss=False)
            if prog.graph is None:
                with torch.inference_mode():
                    prog(np.zeros((b, self.n_patches, PATCH_DIM), np.float32))["classes"].cpu()
        if self.cfg.introspect.enable:
            introspect.install(self.metrics, cfg=self.cfg, programs=dict(self._programs),
                               params=self.params, devices=[self.device])

    @property
    def inflight(self) -> int:
        """Requests inside dispatched (not yet retired) device batches."""
        return sum(len(f.reqs) for f in self._inflight)

    @property
    def load(self) -> int:
        """Queued + in-flight requests (least-loaded routing key)."""
        return self.scheduler.depth + self.inflight

    @property
    def idle(self) -> bool:
        return self.scheduler.depth == 0 and not self._inflight

    @property
    def free_room(self) -> float:
        """Admission slots left before ``submit`` raises ``Backpressure``
        (inf when unbounded)."""
        return self.scheduler.room

    def reset_metrics(self) -> None:
        """Fresh ``EngineMetrics`` (cluster replica leave: the old one was
        folded into the cluster's retired accumulator); the static
        introspection surface carries over."""
        old = self.metrics
        self.metrics = EngineMetrics(num_experts=old.expert_tokens.size, clock=self._clock)
        self.metrics.adopt_static(old)

    def evict(self) -> List[VisionRequest]:
        """Quarantine support (``serving/cluster.py``): strand and return
        every request this replica holds -- queued and in dispatched
        batches -- without waiting on (possibly wedged) device work. The
        batches are dropped unsynchronized; their requests are marked
        ``evicted``, so a late retirement of one is a no-op."""
        stranded = list(self.scheduler.clear())
        for ent in self._inflight:
            stranded.extend(ent.reqs)
        self._inflight.clear()
        out = []
        for req in stranded:
            if req.status != "pending":
                continue  # terminal before the eviction: nothing to redo
            req.evicted = True
            out.append(req)
        return out

    def submit(self, req: VisionRequest) -> None:
        """Enqueue one image; raises ``scheduler.Backpressure`` when the
        pending queue is at ``max_pending``. A ``submitted_at`` stamped
        upstream (the cluster front-end) is kept, so request latency
        includes the front-end's queue."""
        if req.submitted_at is None:
            req.submitted_at = self._clock()
        try:
            self.scheduler.submit(req)
        except Exception:
            self.metrics.inc("rejected")
            if self.events is not None:
                self.events.emit("reject", uid=req.uid, reason="backpressure",
                                 depth=self.scheduler.depth)
            raise
        self.metrics.inc("submitted")
        if self.tracer.enabled:
            if req.trace_id is None:
                req.trace_id = req.uid
            self.tracer.begin(req.trace_id, "queue", t=req.submitted_at)
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

    run_until_drained = flush

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
            t0 = self._clock()
            for r in reqs:
                self.metrics.queue_wait.record(max(0.0, t0 - r.submitted_at))
                if self.tracer.enabled:
                    self.tracer.transition(r.trace_id, "queue", "infer", t=t0,
                                           pad_to=batch.pad_to)
            # the program copies x from pinned memory without waiting: the
            # copy queues behind the batch in flight
            prog = self._compiled(batch.pad_to)
            mark = self._timer.take() if self._step_times else None
            with torch.inference_mode():
                out = own(prog, prog(x, mark=mark))
            finished = None
            if self.device.type == "cuda":
                finished = torch.cuda.Event()
                finished.record()
            self._inflight.append(_InFlight(reqs, batch.pad_to, out, finished, t0, mark))
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
        now = self._clock()
        self.metrics.batch_latency.record(now - ent.dispatched_at)
        key = f"classify|b={ent.pad_to}"
        trace = self.tracer.enabled
        if self._step_times:
            self.metrics.record_step(
                key, self._timer.seconds(ent.step, now - ent.dispatched_at))
        if trace:
            self.tracer.record_span(key, ent.dispatched_at, now, n=len(ent.reqs),
                                    pad_to=ent.pad_to)
        if expert_tokens.size:
            # includes the pad rows' routed tokens (see padded_frames)
            self.metrics.add_expert_tokens(expert_tokens)
        for i, req in enumerate(ent.reqs):
            if req.evicted or req.status != "pending":
                # evicted (the cluster owns it) or a duplicate retirement of
                # an already-terminal request: delivered once only
                if not req.evicted:
                    self.metrics.inc("duplicate_retirements")
                continue
            req.classes = classes[i]
            req.probs = probs[i]
            req.latency_s = now - req.submitted_at
            req.status = "completed"
            self.metrics.request_latency.record(req.latency_s)
            self.metrics.inc("completed")
            if req.on_done is not None:
                try:
                    req.on_done(req)
                except Exception as e:
                    self.metrics.inc("callback_errors")
                    if self.events is not None:
                        self.events.emit("callback_error", uid=req.uid,
                                         error=repr(e))
            if trace:
                # infer ends at the `now` the latency record uses, so
                # queue+infer sums to latency_s; retire is the result fill-in
                self.tracer.transition(req.trace_id, "infer", "retire", t=now)
                self.tracer.end(req.trace_id, "retire", latency_s=req.latency_s)
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
