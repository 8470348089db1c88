"""Continuous-batching LM serving engine on one device, ported from
``repro.serving.engine``: ``Request`` and ``ServeEngine`` with packed
prefill, the per-slot decode tick and asynchronous retirement.

A fixed batch of ``batch_slots`` decode slots shares one K/V cache
[layers, slots, max_len, ...] (int8 with per-position scales under
``cfg.quant``, else bf16). Queued prompts are admitted greedily from the
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

The reference's tracer, event log, introspection, expert-health monitor,
mesh / expert-parallel placement, autotune warmup, eviction and the grouped
(ring-cache) admission path are not ported.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.param import require_device, tree_to
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.scheduler import MicroBatcher


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """Serving always uses the dropless grouped (unified-kernel) MoE path:
    capacity-based GShard dispatch may drop tokens."""
    if cfg.moe is not None and cfg.moe.impl != "grouped":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="grouped"))
    return cfg


def _pow2_ladder(lo: int, hi: int) -> Tuple[int, ...]:
    """Doubling ladder from lo up to (and always including) hi."""
    lo, hi = max(1, int(lo)), max(1, int(hi))
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


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
    # "pending" until retirement makes it "completed" or "cancelled"
    status: str = dataclasses.field(default="pending", repr=False)
    # with ServeEngine(keep_logits=True): the device logits [V] behind each
    # generated token, in order (for teacher-forced checks)
    step_logits: Optional[list] = dataclasses.field(default=None, repr=False)


class ServeEngine:
    """Slot-based greedy generation on one device (the card unless
    ``device="cpu"``). ``params`` may be an fp tree, a fake-quant PTQ tree
    or a QuantizedParams tree (``ptq_model(..., materialize="int8"|"int4")``),
    executed in its stored format through the ``quant_linear`` and
    ``grouped_mlp`` seams. ``max_pending > 0`` bounds the queue (``submit``
    then raises ``scheduler.Backpressure``); ``metrics`` exposes tokens/s,
    request latency percentiles, queue depth, the pack counters and (MoE)
    per-expert routed-token occupancy. ``keep_logits=True`` keeps the
    logits behind every generated token on the request (device tensors,
    no sync)."""

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_len: int = 512, max_pending: int = 0,
                 eos_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda", keep_logits: bool = False) -> None:
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"decoder families only, got {cfg.family!r}")
        self.cfg = cfg = serving_config(cfg)
        if not cfg.serve.packed_prefill:
            raise NotImplementedError(
                "only packed-prefill admission is ported (serve.packed_prefill)")
        self.device = require_device(device)
        self.params = tree_to(params, self.device)
        self.B = batch_slots
        self.max_len = max_len
        self._clock = clock
        self._eos_id = eos_id
        self._keep_logits = keep_logits
        self.cache = transformer.init_cache(cfg, batch_slots, max_len,
                                            device=self.device)
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
        self.max_prefill = int(cfg.serve.max_prefill or max_len)
        if self.max_prefill > max_len:
            raise ValueError(
                f"serve.max_prefill={self.max_prefill} exceeds the K/V cache "
                f"length (max_len={max_len})")
        # a prompt must fit one pack and leave a cache row for its first
        # decode tick
        self._prompt_limit = min(self.max_prefill, max_len - 1)
        self._buckets = _pow2_ladder(min(cfg.serve.min_bucket, self.max_prefill),
                                     self.max_prefill)
        self._nb_ladder = _pow2_ladder(1, batch_slots)
        # next-token feed: device-resident, written by admission and ticks
        self._tok = torch.zeros(batch_slots, dtype=torch.int32, device=self.device)
        self._async = bool(cfg.serve.async_retire)
        self._rq: "queue.Queue" = queue.Queue()
        self._rthread: Optional[threading.Thread] = None
        self._mlock = threading.Lock()

    # -- surface ---------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return self.B - len(self.active)

    @property
    def idle(self) -> bool:
        """Nothing queued, in flight, or pending retirement."""
        return (not self.active and self.scheduler.depth == 0
                and self._pending_retire() == 0)

    def warmup(self) -> None:
        """Run one decode tick and one smallest packed prefill outside the
        measured path (builds the kernels, warms the allocator). The tick
        writes K/V rows at the empty slots' positions; admission overwrites
        a slot's rows, so nothing leaks."""
        with torch.inference_mode():
            self._tick()
            b = self._buckets[0]
            zeros = torch.zeros(b, dtype=torch.int32, device=self.device)
            logits, _ = transformer.prefill_packed(
                self.params, self.cfg, zeros[None], zeros, zeros, zeros[:1],
                max_len=b)
            logits.cpu()

    # -- retirement --------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._rthread is None or not self._rthread.is_alive():
            self._rthread = threading.Thread(
                target=self._retire_loop, daemon=True, name=f"retire-{id(self):x}")
            self._rthread.start()

    def _retire_loop(self) -> None:
        while True:
            ev = self._rq.get()
            try:
                self._consume(ev)
            except Exception:
                # a poisoned event must not kill the thread: later events
                # would strand; the counter makes the loss visible
                self.metrics.inc("retire_errors")
            finally:
                self._rq.task_done()

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
        ``on_done``. ``ev["now"]`` was stamped by the decode loop."""
        tok = ev["tok"].cpu().numpy() if ev.get("tok") is not None else None
        with self._mlock:
            for req, i in ev.get("append", ()):
                if req.eos_seen:
                    continue
                t = int(tok[i])
                req.generated.append(t)
                if self._eos_id is not None and t == self._eos_id:
                    req.eos_seen = True
            if ev.get("stats") is not None:
                self.metrics.add_expert_tokens(ev["stats"].cpu().numpy())
            for req, latency, cancelled in ev.get("retired", ()):
                if req.status != "pending":
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
                    except Exception:
                        self.metrics.inc("callback_errors")

    def _pending_retire(self) -> int:
        return self._rq.unfinished_tasks if self._async else 0

    # -- admission ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self._prompt_limit:
            # an unservable prompt at the queue head would wedge the planner
            self.metrics.inc("rejected")
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
            raise
        self.metrics.inc("submitted")
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
                self._emit({"now": now, "retired": [
                    (req, now - req.submitted_at, bool(expired and not req.eos_seen))]})

    def _admit(self) -> None:
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
            reqs = []
            for req in plan.items:
                if self._expired(req, now):
                    self._emit({"now": now,
                                "retired": [(req, now - req.submitted_at, True)]})
                else:
                    reqs.append(req)
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
            self.metrics.inc("prefill_batches")
            self.metrics.inc("pack_real_tokens", total)
            self.metrics.inc("pack_pad_tokens", bucket - total)
            put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            with torch.inference_mode():
                logits, part = transformer.prefill_packed(
                    self.params, self.cfg, put(tokens), put(positions), put(seg),
                    put(last_idx), max_len=bucket)
                first = torch.argmax(logits, dim=-1).to(torch.int32)  # [nb]
                for i, slot in enumerate(slots):
                    s, n = int(starts[i]), int(lens[i])
                    for name, buf in self.cache.items():
                        buf[:, slot, :n] = part[name][:, 0, s:s + n]
                # out of place: the last tick's event still holds the old
                # feed until the retirement thread copies it home
                self._tok = self._tok.index_put(
                    (torch.tensor(slots, device=self.device),), first[:len(slots)])
            append = []
            for i, (slot, req) in enumerate(zip(slots, reqs)):
                self.pos[slot] = lens[i]
                self._emitted[slot] = 1
                self.active[slot] = req
                append.append((req, i))
                if self._keep_logits:
                    req.step_logits.append(logits[i])
            self._emit({"tok": first, "now": now, "append": append})

    # -- decode ------------------------------------------------------------------

    def _tick(self):
        """One decode position for every slot at its own fill level; the
        next-token feed is replaced on the device. Returns (logits [B, V],
        the routed-token histogram (MoE) or None)."""
        index = torch.from_numpy(self.pos).to(self.device)
        out = transformer.decode_step(self.params, self.cfg, self._tok[:, None],
                                      self.cache, index, with_stats=self._with_stats)
        logits = out[0][:, -1, :]
        self._tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, (out[2]["expert_tokens"] if self._with_stats else None)

    def step(self) -> None:
        """One engine tick: cancel expired requests, admit queued prompts,
        decode one token for every active slot, retire finished ones."""
        self._cancel_expired()
        self._admit()
        if not self.active:
            return
        with torch.inference_mode():
            logits, stats = self._tick()
        nxt = self._tok
        now = self._clock()
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
        self._emit({"tok": nxt, "now": now, "append": append,
                    "retired": retired, "stats": stats})

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
