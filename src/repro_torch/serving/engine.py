"""Continuous-batching LM serving engine on one device, ported from
``repro.serving.engine``: ``Request`` and ``ServeEngine`` with packed
prefill, the per-slot decode tick and asynchronous retirement, and the
grouped same-length admission path of the families without a packed
prefill (ssm).

A fixed batch of ``batch_slots`` decode slots shares one K/V cache
[layers, slots, max_len, ...] (int8 with per-position scales under
``cfg.quant``, else bf16; for alternating local/global archs a nested
``{"local": ring, "global": ...}`` tree, which the engine walks as a tree). Queued prompts are admitted greedily from the
shared ``MicroBatcher``: the pack planner takes the longest FIFO prefix
that fits the ``max_prefill`` token budget and the free slots, concatenates
it into one ``[1, bucket]`` buffer (bucket on a power-of-two ladder, prompt
count padded up its own ladder with ``len == 0`` dummy entries) and runs
one segment-masked ``prefill_packed``; each segment's K/V rows are then
copied into its slot and its first token (argmax on the device) into the
device-resident next-token feed. Every decode tick reads that feed, decodes
one position per slot at the slot's own fill level (``index`` [B]) and
writes the next feed, with no host sync: the tick's token tensor goes to
the retirement thread, which alone copies it to the host, appends to each
request, checks ``eos_id`` and fires ``on_done``. Slot lifetimes are
host-deterministic (emission counts), so slots free without reading tokens.

Each step is a program of the engine's cache (``_program_key`` /
``_compiled``, the reference's schema and ``retraces`` counter): the decode
tick (``_build_tick``) and one packed admission per (bucket, prompt count)
(``_build_admit``), whose merge into the slots has a fixed shape
(``merge_pack``). On the card with ``serve.aot_warmup`` (the default) each
program is a CUDA graph that ``warmup()`` captures (``serving/programs.py``),
so serving replays graphs and builds nothing; with ``aot_warmup=False``,
and on the CPU, each runs eagerly through the same code.

The vlm family is served text-only on the packed path, as the reference
serves it; the hybrid and encoder-decoder families are refused at
construction (``check_servable``), as the reference's engine cannot serve
them.

A family without ``prefill_packed``, an alternating local/global arch (its
ring cache cannot take a packed prefill) or ``serve.packed_prefill=False``
takes the grouped path instead, as the reference decides it: the polled
prompts of one length prefill as one ``[n, S]`` batch, each row of the
prefilled state (SSM: ``h`` and the conv history, kept in f32, the dtype
``prefill`` and ``decode_step`` produce; a ring keeps slot p % rows for
position p, as ``prefill`` lays it out) is copied into its slot, and the
decode tick (a program too, the ring's ``index % rows`` inside it) reads its
tokens from the host, its argmax goes to the host, and it checks ``eos_id``
and retires inline; its per-length prefill runs eagerly.

The engine is an ``EngineReplica`` (``serving/replica.py``): ``load``,
``free_room`` (free decode slots plus queue room), ``reset_metrics`` and
``evict``, which hands back every queued and decoding request for the
cluster to re-dispatch. ``events=`` journals rejections, cancellations,
retirement faults and expert drift into an ``EventLog``.

Observability, as in the reference: ``tracer`` (``serving/trace.py``;
``NULL_TRACER`` unless ``cfg.trace.enable``) records each request's
queue / pack / prefill / decode / retire spans and each step's span on the
host clock; with tracing's ``step_times`` or ``cfg.introspect.enable`` (the
default) every step's time is filed under its program key in
``metrics.step_latency``: on the card the step's device time, from a pair
of CUDA events that the captured graph records at its first and last node
(an eager step: on the stream around it), read where the step is
synchronised anyway (the retirement thread on the packed path, the inline
retirement on the grouped path; ``programs.StepTimer``), on the CPU the
host clock. ``warmup()``
installs the introspection rows (``serving/introspect.py``: a cost row per
program, the roofline peaks, the memory probe), and MoE configs feed the
``ExpertHealthMonitor`` ``expert_health``.

Autotuning, as in the reference: with ``cfg.autotune.enable``, ``warmup()``
first runs ``kernels/autotune.py:ensure_tuned`` over ``_tune_trace`` (every
step the engine serves, run once eagerly), which sweeps the kernel keys the
device kind's table lacks; the graphs are captured after, and each keeps
the grouped kernel's variant and ``lm_attention``'s schedule that the table
picked at its capture.

Expert parallelism, as in the reference: with ``cfg.moe.moe_exec ==
"expert_parallel"`` the engine takes ``mesh=`` (``launch/mesh.py``; the
cluster's ``replica_meshes`` hand one to an EP replica), whose ``'model'``
axis splits the expert stacks over its slots, and every program, eager or
captured into a CUDA graph, runs inside ``use_ep_mesh(mesh)``
(``distributed/expert_parallel.py``), so a graph holds every slot's work.
The engine's device is the slots' one device; a mesh over several cards
raises. The expert counters read the same [E] histogram as on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.expert_parallel import engine_placement, in_ep_mesh, use_ep_mesh
from repro_torch.kernels import autotune
from repro_torch.models import module_for
from repro_torch.models.param import tree_to
from repro_torch.serving import introspect
from repro_torch.serving.events import EventLog
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.programs import (
    EagerProgram,
    GraphProgram,
    PinnedRing,
    StepTimer,
    own,
    record,
)
from repro_torch.serving.scheduler import MicroBatcher
from repro_torch.serving.trace import make_tracer


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """Serving always uses the dropless grouped (unified-kernel) MoE path:
    capacity-based GShard dispatch may drop tokens."""
    if cfg.moe is not None and cfg.moe.impl != "grouped":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="grouped"))
    return cfg


# The families the reference's ServeEngine cannot serve (it drives them
# through the model API alone), with the failure it meets. The port refuses
# them at construction: serving them would be a feature the reference lacks.
UNSERVED_FAMILIES = {
    "hybrid": ("the reference's hybrid.decode_step at the engine's per-slot [B] index "
               "builds positions = index + arange(1) with no S axis, and its RoPE "
               "fails ('cannot reshape array ...')"),
    "encdec": ("the reference engine's grouped prefill passes no encoder frames, and "
               "encdec.encode fails on frontend_embeds=None ('NoneType' object has no "
               "attribute 'astype')"),
}


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family ``ServeEngine`` does not serve
    (``UNSERVED_FAMILIES``); drive those through their model API
    (``forward``, ``prefill``, ``decode_step``)."""
    why = UNSERVED_FAMILIES.get(cfg.family)
    if why is not None:
        raise ValueError(f"ServeEngine does not serve the {cfg.family!r} family "
                         f"({cfg.name}), as the reference's does not: {why}. Drive it "
                         "through the model API (prefill, decode_step)")


def _pow2_ladder(lo: int, hi: int) -> Tuple[int, ...]:
    """Doubling ladder from lo up to (and always including) hi."""
    lo, hi = max(1, int(lo)), max(1, int(hi))
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (a cache: flat, or ``{"local": ...,
    "global": ...}``), in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [layers, slots, rows, ...] (contiguous) as [layers, slots, rows,
    n] of the widest integer type whose size divides a row's bytes: the same
    memory, so a copy through it moves the same bits in fewer elements."""
    rows = t.reshape(t.shape[:3] + (-1,))
    nbytes = rows.shape[-1] * rows.element_size()
    wide = next(d for d in (torch.int64, torch.int32, torch.int16, torch.uint8)
                if nbytes % d.itemsize == 0)
    return rows.view(wide)


def merge_pack(cache: dict, part: dict, starts: torch.Tensor, lens: torch.Tensor,
               slots: torch.Tensor, chunk: int) -> None:
    """Write each pack entry's cache rows into its slot, in place: the
    reference's fixed-shape masked merge. For entry i, the ``chunk`` rows
    of the packed prefill's cache ``part`` from ``starts[i]`` go to rows
    0 .. chunk - 1 of slot ``slots[i]`` wherever the row is below
    ``lens[i]``; the slot keeps its own rows elsewhere. Every index is a
    device tensor, entries merge one after another, and a dummy entry
    (``len == 0``) writes back the rows it read: an exact no-op. Rows move
    as wide integers (``_as_rows``), after ``part`` takes the cache's
    dtype."""
    ar = torch.arange(chunk, device=starts.device)
    src = {name: _as_rows(part[name].to(buf.dtype))[:, 0] for name, buf in cache.items()}
    dst = {name: _as_rows(buf) for name, buf in cache.items()}
    for i in range(starts.shape[0]):
        slot = slots[i:i + 1].long()
        keep = (ar < lens[i])[None, None, :, None]
        for name, rows in src.items():
            picked = rows.index_select(1, torch.clamp(starts[i] + ar, max=rows.shape[1] - 1))
            out = dst[name]
            out[:, slot, :chunk] = torch.where(keep, picked[:, None], out[:, slot, :chunk])


def _retire_loop(engine_ref, rq: "queue.Queue") -> None:
    """The retirement thread: consume events in order until the ``None``
    sentinel that follows its engine's collection."""
    while True:
        ev = rq.get()
        engine = None if ev is None else engine_ref()
        try:
            if engine is None:
                return
            try:
                engine._consume(ev)
            except Exception as e:
                # a poisoned event must not kill the thread: later events
                # would strand; the counter makes the loss visible
                engine.metrics.inc("retire_errors")
                if engine.events is not None:
                    engine.events.emit("retire_error", error=repr(e))
        finally:
            del engine  # hold no reference while blocked on the queue
            rq.task_done()


def _stop_retire(rq: "queue.Queue", thread: threading.Thread) -> None:
    """End a retirement thread: the sentinel, then wait for it to return
    (at interpreter exit too, where a thread still waking from the queue
    while the interpreter tears down aborts the process)."""
    rq.put(None)
    if thread is not threading.current_thread():
        thread.join(timeout=10.0)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    generated: Optional[List[int]] = None
    # stamped by submit(); drives the latency metrics
    submitted_at: Optional[float] = None
    # QoS deadline in seconds after submit (None = unbounded): an expired
    # request is dropped before prefill or cancelled mid-generation
    deadline: Optional[float] = None
    # called by the retirement path once the request finishes or is cancelled
    on_done: Optional[Callable[["Request"], None]] = None
    # set by the retirement path when eos_id is produced; the decode loop
    # frees the slot on its next tick
    eos_seen: bool = dataclasses.field(default=False, repr=False)
    # cluster-wide identity, assigned by the cluster front-end at submit
    trace_id: Optional[int] = None
    # "pending" until the first terminal retirement makes it "completed" or
    # "cancelled" ("failed" is cluster-assigned when the retry budget runs
    # out); terminal is sticky, and duplicate retirements key on it
    status: str = dataclasses.field(default="pending", repr=False)
    # times the cluster re-dispatched this request after an eviction
    redispatched: int = dataclasses.field(default=0, repr=False)
    # set by ``evict()`` while the request is stranded on a quarantined
    # replica: retirement events still in flight for it are ignored (the
    # cluster owns it until re-dispatch clears the flag)
    evicted: bool = dataclasses.field(default=False, repr=False)
    # with ServeEngine(keep_logits=True): the device logits [V] behind each
    # generated token, in order (for teacher-forced checks)
    step_logits: Optional[list] = dataclasses.field(default=None, repr=False)


class ServeEngine:
    """Slot-based greedy generation on one device (the card unless
    ``device="cpu"``). ``params`` may be an fp tree, a fake-quant PTQ tree
    or a QuantizedParams tree (``ptq_model(..., materialize="int8"|"int4")``),
    executed in its stored format through the ``quant_linear`` and
    ``grouped_mlp`` seams (the ssm family: an fp or fake-quant tree).
    ``max_pending > 0`` bounds the queue (``submit`` then raises
    ``scheduler.Backpressure``); ``metrics`` exposes tokens/s,
    request latency percentiles, queue depth, the pack counters and (MoE)
    per-expert routed-token occupancy, and ``retraces`` the programs built
    after ``warmup()`` (0 once it has run). ``keep_logits=True`` keeps the
    logits behind every generated token on the request (device tensors,
    no sync). ``events=`` is the ``EventLog`` that rejections,
    cancellations and retirement faults are journaled into; ``clock=``
    injects a fake clock for deterministic tests. ``mesh=`` (required by an
    expert-parallel config) pins the engine to its slots' device, in place
    of ``device``."""

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 512, max_pending: int = 0,
                 eos_id: Optional[int] = None,
                 events: Optional[EventLog] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda", keep_logits: bool = False, mesh=None) -> None:
        check_servable(cfg)
        self.cfg = cfg = serving_config(cfg)
        self.mod = module_for(cfg)
        if not hasattr(self.mod, "decode_step"):
            raise ValueError(f"decoder families only, got {cfg.family!r}")
        # packed prefill needs the transformer's prefill_packed and a cache
        # without a ring; every other family, and the alternating
        # local/global archs, keep the grouped same-length admission path
        self._packed = bool(cfg.serve.packed_prefill
                            and cfg.attn is not None
                            and not cfg.attn.alternate_local_global
                            and hasattr(self.mod, "prefill_packed"))
        self.mesh = mesh
        self._ep, self.device = engine_placement(cfg, mesh, device)
        # the same tensors when the tree is on this device already: replicas
        # on one card share one copy of the weights
        self.params = tree_to(params, self.device)
        self.events = events
        # NULL_TRACER unless cfg.trace.enable: every site below guards on
        # ``self.tracer.enabled``, so the disabled path is one attribute read
        self.tracer = make_tracer(cfg.trace, clock=clock)
        # step times feed the trace and the introspection's MFU join
        self._step_times = ((self.tracer.enabled and cfg.trace.step_times)
                            or cfg.introspect.enable)
        self._timer = StepTimer(self.device)
        self.B = batch_slots
        self.max_len = max_len
        self._clock = clock
        self._eos_id = eos_id
        self._keep_logits = keep_logits
        # K/V caches keep init_cache's default dtype, as in the reference; a
        # recurrent state keeps the f32 that prefill and decode_step build
        # (the reference rounds a first admission wave's conv history to
        # bf16), so merging a prefilled row into its slot rounds nothing
        self.cache = self.mod.init_cache(
            cfg, batch_slots, max_len, device=self.device,
            **({"dtype": torch.float32} if cfg.ssm is not None else {}))
        self.pos = np.zeros(batch_slots, np.int32)  # cache fill per slot
        self._emitted = np.zeros(batch_slots, np.int64)  # tokens per slot
        self.active: Dict[int, Request] = {}  # slot -> request
        self.scheduler = MicroBatcher(batch_sizes=(batch_slots,),
                                      max_wait_s=0.0, max_pending=max_pending,
                                      clock=clock)
        self._with_stats = cfg.moe is not None
        self.metrics = EngineMetrics(
            num_experts=cfg.moe.num_experts if self._with_stats else 0,
            clock=clock)
        self.expert_health = None
        if cfg.introspect.enable and self._with_stats:
            # fed by add_expert_tokens outside the metrics lock
            self.expert_health = introspect.ExpertHealthMonitor(
                cfg.moe.num_experts,
                window_tokens=cfg.introspect.drift_window_tokens,
                drift_threshold=cfg.introspect.drift_threshold,
                baseline_alpha=cfg.introspect.baseline_alpha,
                events=events, label="lm", clock=clock,
                on_drift=introspect.drift_counter(self))
            self.metrics.expert_health = self.expert_health
        self.max_prefill = int(cfg.serve.max_prefill or max_len)
        if self.max_prefill > max_len:
            raise ValueError(
                f"serve.max_prefill={self.max_prefill} exceeds the K/V cache "
                f"length (max_len={max_len})")
        # a prompt must fit one pack and leave a cache row for its first
        # decode tick
        self._prompt_limit = (min(self.max_prefill, max_len - 1)
                              if self._packed else max_len - 1)
        self._buckets = _pow2_ladder(min(cfg.serve.min_bucket, self.max_prefill),
                                     self.max_prefill)
        self._nb_ladder = _pow2_ladder(1, batch_slots)
        # next-token feed on the device, written in place by admission and
        # ticks: slots 0..B-1, and entry B, which takes the dummy pack
        # entries' writes
        self._feed = torch.zeros(batch_slots + 1, dtype=torch.int32, device=self.device)
        self._tok = self._feed[:batch_slots]
        # the program cache; on the card with aot_warmup every program is a
        # CUDA graph, captured on one side stream into one memory pool, its
        # host inputs staged in pinned buffers (a pack is the largest)
        self._aot = bool(cfg.serve.aot_warmup)
        self._programs: Dict[str, Callable] = {}
        self._graphs = self.device.type == "cuda" and self._aot
        if self._graphs:
            # the replica's own pool and capture stream, made on its card
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            self._ring = PinnedRing(4 * (3 * self.max_prefill + 4 * batch_slots))
        self._async = bool(cfg.serve.async_retire) and self._packed
        self._rq: "queue.Queue" = queue.Queue()
        self._rthread: Optional[threading.Thread] = None
        self._mlock = threading.Lock()

    # -- replica surface (serving/replica.py) ----------------------------------

    @property
    def queue(self) -> List[Request]:
        """Pending (not yet admitted) requests in FIFO order."""
        return self.scheduler.pending_items()

    @property
    def free_slots(self) -> int:
        return self.B - len(self.active)

    @property
    def inflight(self) -> int:
        """Requests occupying decode slots."""
        return len(self.active)

    @property
    def load(self) -> int:
        """Queued + in-flight requests (least-loaded routing key)."""
        return self.scheduler.depth + len(self.active)

    @property
    def free_room(self) -> float:
        """Admission headroom: free decode slots plus queue room (inf when
        the queue is unbounded). A replica with open slots admits even at
        queue bound 0."""
        room = self.scheduler.room
        if room == float("inf"):
            return float("inf")
        return self.free_slots + room

    @property
    def idle(self) -> bool:
        """Nothing queued, in flight, or pending retirement."""
        return (not self.active and self.scheduler.depth == 0
                and self._pending_retire() == 0)

    def reset_metrics(self) -> None:
        """Fresh ``EngineMetrics`` (cluster replica leave: the old one was
        folded into the cluster's retired accumulator). The static
        introspection surface (cost rows, peaks, memory probe, health
        monitor) carries over: it describes the programs, not load."""
        old = self.metrics
        self.metrics = EngineMetrics(num_experts=old.expert_tokens.size, clock=self._clock)
        self.metrics.adopt_static(old)

    def evict(self) -> List[Request]:
        """Quarantine support (``serving/cluster.py``): strand and return
        every request this replica holds -- queued and mid-decode, in FIFO
        order -- without running any more device work.

        The retirement thread is drained first, so a request whose terminal
        event beat the eviction keeps its terminal status; everything
        returned is marked ``evicted`` (events that still name it become
        no-ops), and its slot, fill level and emission count are reset."""
        if self._async:
            self._rq.join()
        stranded = list(self.scheduler.clear())
        for slot in sorted(self.active):
            stranded.append(self.active[slot])
        self.active.clear()
        self.pos[:] = 0
        self._emitted[:] = 0
        out = []
        for req in stranded:
            if req.status != "pending":
                continue  # terminal before the eviction: nothing to redo
            req.evicted = True
            out.append(req)
        return out

    def warmup(self) -> None:
        """Build the serving programs outside the measured path: the decode
        tick and, with ``aot_warmup`` on the packed path, the admission of
        every (bucket x prompt count), so that serving builds nothing
        (``retraces`` stays 0). On the card with ``aot_warmup`` each is a
        captured CUDA graph; eagerly, one tick and one smallest prefill run
        (builds the kernels, warms the allocator), and so does the grouped
        path's prefill, which stays eager. A tick writes cache rows or
        states of the empty slots; admission overwrites a slot's, so
        nothing leaks. Then the introspection rows are installed: a cost
        row per program built.

        With ``cfg.autotune.enable`` the kernels are tuned first
        (``autotune.ensure_tuned`` over ``_tune_trace``: a sweep the first
        time on a device kind, a cache hit after), before any graph is
        captured, so each graph keeps the tuned variants and schedules."""
        if self.cfg.autotune.enable:
            autotune.ensure_tuned(self.cfg.autotune, self._tune_trace, device=self.device)
        self._warm_programs()
        if self.cfg.introspect.enable:
            introspect.install(self.metrics, cfg=self.cfg, programs=dict(self._programs),
                               params=self.params, cache=self.cache, devices=[self.device])

    def _warm_programs(self) -> None:
        b = self._buckets[0]
        zeros = torch.zeros(b, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            tick = self._compiled(self._program_key("decode"), self._build_tick,
                                  count_miss=False)
            if self._packed and self._aot:
                for bucket in self._buckets:
                    for nb in self._nb_ladder:
                        self._compiled(
                            self._program_key("packed_prefill", bucket=bucket, n=nb),
                            lambda b_=bucket, n=nb: self._build_admit(b_, n),
                            count_miss=False)
            if self._graphs and self._packed:
                return
            if not self._graphs:
                tick(*self._tick_inputs(np.zeros(self.B, np.int32)))
            with self._scope():
                if self._packed:
                    logits, _ = self.mod.prefill_packed(
                        self.params, self.cfg, zeros[None], zeros, zeros, zeros[:1],
                        max_len=b)
                else:
                    logits, _ = self.mod.prefill(self.params, self.cfg, zeros[None],
                                                 max_len=self.max_len)
            logits.cpu()

    def _tune_trace(self) -> None:
        """Run every step this replica serves once, eagerly, so that the
        autotuner's ``collecting()`` scope records the kernel keys they hit
        (the reference traces them with ``jax.eval_shape``; the port has no
        abstract trace): the decode tick, every (bucket x prompt count)
        packed admission on the packed path (as the reference, whether
        built at warmup or on first use), and on the grouped path the
        prefill, which serving runs eagerly, at every (prompt count x
        length) bucket of the power-of-two ladders up to ``batch_slots``
        and the prompt limit (the reference traces one length), so a served
        prefill finds its key. Inside the engine's EP scope, so an
        expert-parallel replica records its per-slot shapes. The cache and
        the feed are put back after. A family without attention or experts
        reaches no tuned kernel and runs nothing."""
        if self.cfg.attn is None and self.cfg.moe is None:
            return
        dev = self.device
        with self._state_kept(), torch.inference_mode(), self._scope():
            EagerProgram(self._tick_step(), dev)(*self._tick_inputs(np.zeros(self.B, np.int32)))
            if self._packed:
                for bucket in self._buckets:
                    for nb in self._nb_ladder:
                        self._admit_step(bucket, nb)(
                            torch.zeros(3 * bucket + 4 * nb, dtype=torch.int32, device=dev))
                return
            for n in self._nb_ladder:
                for length in _pow2_ladder(1, self._prompt_limit):
                    self.mod.prefill(self.params, self.cfg,
                                     torch.zeros((n, length), dtype=torch.int32, device=dev),
                                     max_len=self.max_len)

    # -- programs (the reference's AOT program cache) ----------------------------

    def _scope(self):
        """The EP mesh's scope for an eager model call (a null context
        without expert parallelism)."""
        return use_ep_mesh(self.mesh) if self._ep else contextlib.nullcontext()

    def _program_key(self, prog: str, **kv) -> str:
        """Program-cache key in the reference's schema:
        ``serve/<prog>|B=..|S=..|k=v`` (keys sorted)."""
        parts = [f"serve/{prog}", f"B={self.B}", f"S={self.max_len}"]
        parts += [f"{k}={v}" for k, v in sorted(kv.items())]
        return "|".join(parts)

    def _compiled(self, key: str, build: Callable[[], Callable], count_miss: bool = True):
        """The program for ``key``, built on a miss. A miss on the serving
        path adds to ``retraces``, which must stay 0 after ``warmup()``."""
        prog = self._programs.get(key)
        if prog is None:
            if count_miss:
                self.metrics.inc("retraces")
            with torch.inference_mode():
                prog = self._programs[key] = build()
        return prog

    def _program(self, fn: Callable, *example):
        """Step ``fn`` as a program: on the card with ``aot_warmup`` a CUDA
        graph captured from ``example`` inputs (``GraphProgram``; a failed
        capture raises), else ``fn`` run eagerly; under expert parallelism
        inside the engine's EP mesh."""
        if self._ep:
            fn = in_ep_mesh(fn, self.mesh)
        if not self._graphs:
            return EagerProgram(fn, self.device)
        if self._async:
            self._rq.join()  # no retirement copy runs while a graph is captured
        return GraphProgram(fn, example, device=self.device, pool=self._pool,
                            stream=self._stream, ring=self._ring)

    def _tick_inputs(self, host_tokens: np.ndarray):
        """The tick's inputs: the device feed (packed path) or the host
        tokens [B], and the fill levels [B] from the host."""
        return (self._tok if self._packed else host_tokens), self.pos

    def _build_tick(self):
        """The decode tick's program (``_tick_step``); a capture's warm-up
        call decodes one step, so the state is put back after it."""
        tick = self._tick_step()
        if not self._graphs:
            return self._program(tick)
        with self._state_kept():
            return self._program(tick, *self._tick_inputs(np.zeros(self.B, np.int32)))

    @contextlib.contextmanager
    def _state_kept(self):
        """Run a block that writes the cache (cache rows, the SSM state) or
        the token feed, and put both back after it."""
        state = _leaves(self.cache) + [self._feed]
        saved = [t.clone() for t in state]
        try:
            yield
        finally:
            for t, v in zip(state, saved):
                t.copy_(v)

    def _tick_step(self):
        """The decode tick: one position for every slot at its own fill
        level, from tokens [B] (the feed, or host tokens); the cache is
        updated in place (the SSM's new state is written over the old),
        the argmax taken on the device and, on the packed path, written to
        the feed. Returns (next tokens [B] int32, logits [B, V], the
        routed-token histogram (MoE) or None)."""
        cfg, mod, params, cache = self.cfg, self.mod, self.params, self.cache
        with_stats = self._with_stats
        kw = {"with_stats": True} if with_stats else {}
        if cfg.ssm is not None:
            kw["out"] = cache
        feed = self._tok if self._packed else None

        def tick(tokens, index):
            out = mod.decode_step(params, cfg, tokens[:, None], cache, index, **kw)
            logits = out[0][:, -1, :]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if feed is not None:
                feed.copy_(nxt)
            return nxt, logits, (out[2]["expert_tokens"] if with_stats else None)

        return tick

    def _build_admit(self, bucket: int, nb: int):
        """The program of one packed admission (``_admit_step``)."""
        return self._program(self._admit_step(bucket, nb),
                             np.zeros(3 * bucket + 4 * nb, np.int32))

    def _admit_step(self, bucket: int, nb: int):
        """One packed admission (the reference's ``_build_admit``): one
        segment-masked prefill over ``[1, bucket]`` tokens holding up to
        ``nb`` prompts, each prompt's first token (argmax on the device),
        its K/V rows merged into its slot (``merge_pack``) and its first
        token into the feed, dummy entries (``len == 0``) dropped. The host
        input is one int32 array: tokens, positions and segment ids
        [bucket] each, then last_idx, starts, lens and slots [nb] each.
        Returns (first tokens [nb], logits [nb, V])."""
        cfg, mod, params, cache, B = self.cfg, self.mod, self.params, self.cache, self.B
        feed, chunk = self._feed, min(self.max_len, bucket)

        def admit(packed):
            tokens, positions, seg = packed[:3 * bucket].view(3, bucket)
            last_idx, starts, lens, slots = packed[3 * bucket:].view(4, nb)
            logits, part = mod.prefill_packed(params, cfg, tokens[None], positions, seg,
                                              last_idx, max_len=bucket)
            first = torch.argmax(logits, dim=-1).to(torch.int32)  # [nb]
            merge_pack(cache, part, starts, lens, slots, chunk)
            feed.index_copy_(0, torch.where(lens > 0, slots, B).long(), first)
            return first, logits

        return admit

    # -- retirement --------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._rthread is None or not self._rthread.is_alive():
            # the thread holds the engine weakly, so a dropped engine (and
            # its weights and cache) is freed; the sentinel then ends it
            self._rthread = threading.Thread(
                target=_retire_loop, args=(weakref.ref(self), self._rq),
                daemon=True, name=f"retire-{id(self):x}")
            self._rthread.start()
            weakref.finalize(self, _stop_retire, self._rq, self._rthread)

    def _emit(self, ev: dict) -> None:
        """Hand a retirement event to the thread (async) or consume it
        inline: same code path, same order."""
        if self._async:
            self._ensure_thread()
            self._rq.put(ev)
        else:
            self._consume(ev)

    def _consume(self, ev: dict) -> None:
        """Retire one event: copy the token tensor to the host (the only
        device-to-host sync of serving, off the decode loop when async),
        append to each request, check EOS, record completion metrics, fire
        ``on_done``. ``ev["now"]`` was stamped by the decode loop. A step's
        time (``ev["step"]``) is read here, once the token copy has
        synchronised the step."""
        tok = ev["tok"].cpu().numpy() if ev.get("tok") is not None else None
        if ev.get("step") is not None:
            key, mark, host_s = ev["step"]
            self.metrics.record_step(key, self._timer.seconds(mark, host_s))
        with self._mlock:
            for req, i in ev.get("append", ()):
                if req.eos_seen or req.evicted or req.generated is None:
                    # the stream ended early, or the request was evicted and
                    # restarts elsewhere (re-dispatch clears ``generated``)
                    continue
                t = int(tok[i])
                req.generated.append(t)
                if self._eos_id is not None and t == self._eos_id:
                    req.eos_seen = True
            if ev.get("stats") is not None:
                self.metrics.add_expert_tokens(ev["stats"].cpu().numpy())
            for req, latency, cancelled in ev.get("retired", ()):
                if req.evicted:
                    continue  # the cluster owns it until re-dispatch
                if req.status != "pending":
                    # already terminal: a duplicate retirement is counted
                    # and delivers nothing
                    self.metrics.inc("duplicate_retirements")
                    continue
                req.status = "cancelled" if cancelled else "completed"
                if cancelled:
                    self.metrics.inc("cancelled")
                else:
                    self.metrics.inc("completed")
                    self.metrics.request_latency.record(latency)
                if req.on_done is not None:
                    try:
                        req.on_done(req)
                    except Exception as e:
                        self.metrics.inc("callback_errors")
                        if self.events is not None:
                            self.events.emit("callback_error", uid=req.uid,
                                             error=repr(e))
                if self.tracer.enabled:
                    # close the retire span the decode loop opened; it
                    # extends past the recorded latency by design
                    self.tracer.end(req.trace_id, "retire", latency_s=latency,
                                    cancelled=cancelled)

    def _pending_retire(self) -> int:
        return self._rq.unfinished_tasks if self._async else 0

    # -- admission ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self._prompt_limit:
            # an unservable prompt at the queue head would wedge the planner
            self.metrics.inc("rejected")
            if self.events is not None:
                self.events.emit("reject", uid=req.uid, reason="unservable",
                                 prompt_len=len(req.prompt),
                                 limit=self._prompt_limit)
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds this engine's limit "
                f"of {self._prompt_limit} (max_prefill={self.max_prefill}, "
                f"max_len={self.max_len})")
        req.generated = []
        if self._keep_logits:
            req.step_logits = []
        if req.submitted_at is None:
            req.submitted_at = self._clock()
        if self.scheduler.room == 0 and self.free_slots > 0:
            self._admit()  # queue full but slots free: admit first
        try:
            self.scheduler.submit(req)  # raises Backpressure when full
        except Exception:
            self.metrics.inc("rejected")
            if self.events is not None:
                self.events.emit("reject", uid=req.uid, reason="backpressure",
                                 depth=self.scheduler.depth)
            raise
        self.metrics.inc("submitted")
        if self.tracer.enabled:
            if req.trace_id is None:  # the cluster assigns; standalone: uid
                req.trace_id = req.uid
            self.tracer.begin(req.trace_id, "queue", t=req.submitted_at)
        self.metrics.observe_queue_depth(self.scheduler.depth)

    def _expired(self, req: Request, now: float) -> bool:
        return req.deadline is not None and now - req.submitted_at > req.deadline

    def _cancel_expired(self) -> None:
        """Free slots whose request passed its deadline or produced EOS (seen
        by the retirement thread, one tick behind the token)."""
        if not self.active:
            return
        now = self._clock()
        for slot in list(self.active):
            req = self.active[slot]
            expired = self._expired(req, now)
            if expired or req.eos_seen:
                self.active.pop(slot)
                cancelled = bool(expired and not req.eos_seen)
                if self.tracer.enabled:
                    self.tracer.transition(req.trace_id, "decode", "retire", t=now)
                if self.events is not None and cancelled:
                    self.events.emit("cancel", t=now, uid=req.uid,
                                     where="mid_generation",
                                     waited_s=now - req.submitted_at,
                                     deadline_s=req.deadline)
                self._emit({"now": now, "retired": [
                    (req, now - req.submitted_at, cancelled)]})

    def _drop_expired(self, items, now: float) -> List[Request]:
        """The live requests of a poll; the expired ones retire as
        cancelled without reaching the device."""
        live = []
        for req in items:
            if self._expired(req, now):
                if self.tracer.enabled:
                    # never dispatched: the timeline is queue -> retire
                    self.tracer.transition(req.trace_id, "queue", "retire", t=now)
                if self.events is not None:
                    self.events.emit("cancel", t=now, uid=req.uid, where="queued",
                                     waited_s=now - req.submitted_at,
                                     deadline_s=req.deadline)
                self._emit({"now": now,
                            "retired": [(req, now - req.submitted_at, True)]})
            else:
                live.append(req)
        return live

    def _admit(self) -> None:
        if self._packed:
            self._admit_packed()
        else:
            self._admit_grouped()

    def _admit_packed(self) -> None:
        """Packed admission: one segment-masked prefill over the pack plan's
        prompts, their K/V rows merged into their slots, first tokens into
        the device-side feed. Mixed lengths share one dispatch."""
        while True:
            free = [s for s in range(self.B) if s not in self.active]
            if not free:
                return
            plan = self.scheduler.poll_pack(
                self.max_prefill, lambda r: len(r.prompt), limit=len(free))
            if plan is None:
                return
            now = plan.formed_at
            reqs = self._drop_expired(plan.items, now)
            if not reqs:
                continue
            total = sum(len(r.prompt) for r in reqs)
            bucket = next(b for b in self._buckets if b >= total)
            nb = next(n for n in self._nb_ladder if n >= len(reqs))
            tokens = np.zeros((1, bucket), np.int32)
            positions = np.zeros(bucket, np.int32)
            seg = np.full(bucket, -1, np.int32)
            starts = np.zeros(nb, np.int32)
            lens = np.zeros(nb, np.int32)  # 0 = dummy entry: a no-op
            last_idx = np.zeros(nb, np.int32)
            slots = []
            cursor = 0
            for i, req in enumerate(reqs):
                n = len(req.prompt)
                tokens[0, cursor:cursor + n] = req.prompt
                positions[cursor:cursor + n] = np.arange(n)
                seg[cursor:cursor + n] = i
                starts[i], lens[i], last_idx[i] = cursor, n, cursor + n - 1
                slots.append(free.pop(0))
                cursor += n
                self.metrics.queue_wait.record(max(0.0, now - req.submitted_at))
                if self.tracer.enabled:
                    # the planner selected the request at `now`: queue ends
                    # and the host-side pack phase begins
                    self.tracer.transition(req.trace_id, "queue", "pack", t=now,
                                           waited_s=now - req.submitted_at)
            self.metrics.inc("prefill_batches")
            self.metrics.inc("pack_real_tokens", total)
            self.metrics.inc("pack_pad_tokens", bucket - total)
            slot_ids = np.zeros(nb, np.int32)
            slot_ids[:len(slots)] = slots
            key = self._program_key("packed_prefill", bucket=bucket, n=nb)
            prog = self._compiled(key, lambda: self._build_admit(bucket, nb))
            trace = self.tracer.enabled
            if trace or self._step_times:
                t_d = self._clock()  # pack ends, prefill dispatch begins
                if trace:
                    for req in reqs:
                        self.tracer.transition(req.trace_id, "pack", "prefill", t=t_d,
                                               bucket=bucket, n=len(reqs))
            mark = self._timer.take() if self._step_times else None
            with torch.inference_mode():
                first, logits = prog(np.concatenate(
                    [tokens[0], positions, seg, last_idx, starts, lens, slot_ids]), mark=mark)
                first = own(prog, first)
                if self._keep_logits:
                    logits = own(prog, logits)
            step = None
            if trace or self._step_times:
                t_e = self._clock()
                if self._step_times:
                    step = (key, mark, t_e - t_d)
                if trace:
                    self.tracer.record_span(key, t_d, t_e, n=len(reqs), real_tokens=total)
                    for req in reqs:
                        self.tracer.transition(req.trace_id, "prefill", "decode", t=t_e)
            append = []
            for i, (slot, req) in enumerate(zip(slots, reqs)):
                self.pos[slot] = lens[i]
                self._emitted[slot] = 1
                self.active[slot] = req
                append.append((req, i))
                if self._keep_logits:
                    req.step_logits.append(logits[i])
            self._emit({"tok": first, "now": now, "append": append, "step": step})

    def _admit_grouped(self) -> None:
        """Batch-parallel admission: up to ``free_slots`` polled prompts a
        tick; prompts of one length prefill as ONE ``[n, S]`` forward, then
        each row of the prefilled state is copied into its slot. Grouping by
        exact length keeps the batch unpadded, so every row's last position
        is its true last token. First tokens go to the host here."""
        free = [s for s in range(self.B) if s not in self.active]
        while free:
            batch = self.scheduler.poll(limit=len(free))
            if batch is None:
                return
            now = batch.formed_at
            groups: Dict[int, List[Request]] = {}
            for req in self._drop_expired(batch.items, now):
                groups.setdefault(len(req.prompt), []).append(req)
            for n, reqs in sorted(groups.items()):
                slots = [free.pop(0) for _ in reqs]
                for req in reqs:
                    self.metrics.queue_wait.record(max(0.0, now - req.submitted_at))
                    if self.tracer.enabled:
                        # no pack phase on this path: queue -> prefill
                        self.tracer.transition(req.trace_id, "queue", "prefill", t=now)
                tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(
                    self.device)
                trace = self.tracer.enabled
                if trace or self._step_times:
                    t_d = self._clock()
                mark = self._timer.take() if self._step_times else None
                with torch.inference_mode(), self._scope():
                    record(mark, 0, self.device)
                    logits, part = self.mod.prefill(self.params, self.cfg, tokens,
                                                    max_len=self.max_len)
                    logits = logits[:, -1, :]
                    first = torch.argmax(logits, dim=-1)
                    record(mark, 1, self.device)
                    for i, slot in enumerate(slots):
                        for buf, rows in zip(_leaves(self.cache), _leaves(part)):
                            buf[:, slot] = rows[:, i]
                self.metrics.inc("prefill_batches")
                first = first.cpu().numpy()
                if trace or self._step_times:
                    t_e = self._clock()
                    key = self._program_key("grouped_prefill", L=n, n=len(reqs))
                    if self._step_times:
                        self.metrics.record_step(key, self._timer.seconds(mark, t_e - t_d))
                    if trace:
                        self.tracer.record_span(key, t_d, t_e, n=len(reqs))
                        for req in reqs:
                            self.tracer.transition(req.trace_id, "prefill", "decode", t=t_e)
                for i, (slot, req) in enumerate(zip(slots, reqs)):
                    self.pos[slot] = n
                    req.generated.append(int(first[i]))
                    if self._keep_logits:
                        req.step_logits.append(logits[i])
                    self.active[slot] = req

    # -- decode ------------------------------------------------------------------

    def _step_grouped(self) -> None:
        """The grouped path's tick: tokens from the host, argmax to the
        host, EOS checked and finished requests retired inline."""
        tokens = np.zeros(self.B, np.int32)
        for slot, req in self.active.items():
            tokens[slot] = req.generated[-1]
        key = self._program_key("decode")
        tick = self._compiled(key, self._build_tick)
        trace = self.tracer.enabled
        if trace or self._step_times:
            t_d = self._clock()
        mark = self._timer.take() if self._step_times else None
        with torch.inference_mode():
            nxt, logits, stats = tick(*self._tick_inputs(tokens), mark=mark)
            if self._keep_logits:
                logits = own(tick, logits)
        if stats is not None:
            self.metrics.add_expert_tokens(stats.cpu().numpy())
        nxt = nxt.cpu().numpy()
        now = self._clock()
        if self._step_times:
            self.metrics.record_step(key, self._timer.seconds(mark, now - t_d))
        if trace:
            self.tracer.record_span(key, t_d, now, n=len(self.active))
        self.metrics.inc("decode_ticks")
        self.metrics.work_done(len(self.active), "tokens")
        self.metrics.observe_queue_depth(self.scheduler.depth)
        done = []
        for slot, req in self.active.items():
            tok = int(nxt[slot])
            req.generated.append(tok)
            if self._keep_logits:
                req.step_logits.append(logits[slot])
            self.pos[slot] += 1
            req.eos_seen = self._eos_id is not None and tok == self._eos_id
            if len(req.generated) >= req.max_new_tokens or req.eos_seen or \
                    self.pos[slot] >= self.max_len - 1:
                done.append(slot)
        for slot in done:
            req = self.active.pop(slot)
            if trace:
                self.tracer.transition(req.trace_id, "decode", "retire", t=now)
            self._emit({"now": now, "retired": [(req, now - req.submitted_at, False)]})

    def step(self) -> None:
        """One engine tick: cancel expired requests, admit queued prompts,
        decode one token for every active slot, retire finished ones."""
        self._cancel_expired()
        self._admit()
        if not self.active:
            return
        if not self._packed:
            self._step_grouped()
            return
        key = self._program_key("decode")
        tick = self._compiled(key, self._build_tick)
        trace = self.tracer.enabled
        if trace or self._step_times:
            t_d = self._clock()
        mark = self._timer.take() if self._step_times else None
        with torch.inference_mode():
            nxt, logits, stats = tick(*self._tick_inputs(None), mark=mark)
            nxt, stats = own(tick, (nxt, stats))
            if self._keep_logits:
                logits = own(tick, logits)
        now = self._clock()
        step = (key, mark, now - t_d) if self._step_times else None
        if trace:
            self.tracer.record_span(key, t_d, now, n=len(self.active))
        self.metrics.inc("decode_ticks")
        self.metrics.work_done(len(self.active), "tokens")
        self.metrics.observe_queue_depth(self.scheduler.depth)
        append, retired = [], []
        for slot in list(self.active):
            req = self.active[slot]
            append.append((req, slot))
            if self._keep_logits:
                req.step_logits.append(logits[slot])
            self._emitted[slot] += 1
            self.pos[slot] += 1
            if self._emitted[slot] >= req.max_new_tokens or \
                    self.pos[slot] >= self.max_len - 1:
                self.active.pop(slot)
                retired.append((req, now - req.submitted_at, False))
                if trace:
                    # decode ends at the timestamp the latency record uses,
                    # so queue+pack+prefill+decode sums exactly to it
                    self.tracer.transition(req.trace_id, "decode", "retire", t=now)
        self._emit({"tok": nxt, "now": now, "append": append,
                    "retired": retired, "stats": stats, "step": step})

    def flush(self, max_ticks: int = 10_000) -> None:
        """Blocking drain: serve everything queued and in flight, then wait
        for the retirement thread to finish."""
        for _ in range(max_ticks):
            if not self.active and self.scheduler.depth == 0:
                break
            self.step()
        if self._async:
            self._rq.join()

    run_until_drained = flush
