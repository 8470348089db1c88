"""Model-agnostic dynamic micro-batcher, a framework-free copy of
``repro.serving.scheduler``: ``MicroBatcher`` with the packed-prefill
planner (``poll_pack``), ``Backpressure``, ``MicroBatch`` and ``PackPlan``.

``ServeEngine`` polls it with the number of free decode slots as the limit
(greedy admission, ``max_wait_s=0``) and packs prompts by token budget;
``VisionEngine`` lets requests coalesce up to a batch-size bucket or a
max-wait deadline.

Semantics:

  * **shape-bucketed admission** -- ``bucket_of(item)`` maps each request to a
    hashable bucket key; only same-bucket requests batch together.
  * **FIFO** -- strict submission order within a bucket; across buckets the
    bucket whose head request is oldest releases first.
  * **deadline flush** -- a partial batch is released once its oldest request
    has waited ``max_wait_s`` (0 means release immediately).
  * **backpressure** -- ``submit`` raises ``Backpressure`` once ``max_pending``
    requests are queued (0 = unbounded).
  * **drain** -- ``drain()`` releases partial batches immediately regardless
    of deadline, for end-of-stream flush; ``clear()`` hands every queued
    request back (eviction).

Pure host-side bookkeeping; a ``clock`` can be injected for tests.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence


class Backpressure(RuntimeError):
    """``submit`` refused: the scheduler's pending bound has been reached."""


class MicroBatch(NamedTuple):
    key: Any  # bucket key the batch was formed from
    items: tuple  # requests in FIFO order (len <= pad_to)
    pad_to: int  # ladder size the engine should pad the batch up to
    waited_s: float  # queue wait of the oldest item at formation time
    # formation timestamp (scheduler clock) — the queue-phase end boundary
    # the span timelines use (serving/trace.py); 0.0 only from legacy
    # construction sites that predate the field
    formed_at: float = 0.0


class PackPlan(NamedTuple):
    """A packed-prefill plan: the maximal FIFO prefix of the queue whose
    token lengths fit a budget (DESIGN.md section 10)."""

    items: tuple  # requests in global FIFO order
    lengths: tuple  # token length per item (same order)
    total: int  # sum(lengths) — real tokens in the pack buffer
    budget: int  # token budget the plan was formed against
    waited_s: float  # queue wait of the oldest item at formation time
    # planner-selection timestamp — where each packed request's queue span
    # ends and its pack span begins (serving/trace.py)
    formed_at: float = 0.0


class MicroBatcher:
    """Request queue with bucketed batch formation (see module docstring)."""

    def __init__(
        self,
        *,
        bucket_of: Optional[Callable[[Any], Any]] = None,
        batch_sizes: Sequence[int] = (1,),
        max_wait_s: float = 0.0,
        max_pending: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        sizes = tuple(sorted(set(int(s) for s in batch_sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive: {batch_sizes!r}")
        self.batch_sizes = sizes
        self.max_batch = sizes[-1]
        self.max_wait_s = float(max_wait_s)
        self.max_pending = int(max_pending)
        self._bucket_of = bucket_of or (lambda item: None)
        self._clock = clock
        # bucket key -> deque of (seq, enqueue_t, item); seq is a global
        # submission counter so cross-bucket age order is total and
        # deterministic even under a frozen test clock.
        self._buckets: Dict[Any, deque] = {}
        self._seq = 0
        self._depth = 0
        self._draining = False

    # -- admission ----------------------------------------------------------

    def submit(self, item: Any, now: Optional[float] = None) -> None:
        if self.max_pending and self._depth >= self.max_pending:
            raise Backpressure(
                f"scheduler full: {self._depth} pending "
                f"(max_pending={self.max_pending})"
            )
        now = self._clock() if now is None else now
        key = self._bucket_of(item)
        self._buckets.setdefault(key, deque()).append((self._seq, now, item))
        self._seq += 1
        self._depth += 1

    # -- inspection ---------------------------------------------------------

    @property
    def depth(self) -> int:
        """Total queued (not yet formed into a batch) requests."""
        return self._depth

    @property
    def room(self) -> float:
        """Admission headroom: how many more ``submit`` calls succeed before
        ``Backpressure`` (inf when ``max_pending`` is 0 = unbounded). Both
        engines derive their ``free_room`` routing signal from this."""
        if self.max_pending == 0:
            return float("inf")
        return max(0, self.max_pending - self._depth)

    def pending_items(self) -> List[Any]:
        """Queued requests in global FIFO (submission) order."""
        entries = [e for q in self._buckets.values() for e in q]
        entries.sort(key=lambda e: e[0])
        return [e[2] for e in entries]

    def clear(self) -> List[Any]:
        """Remove and return every queued request in global FIFO order: the
        eviction path (``ServingCluster.quarantine``) reclaims an evicted
        replica's queued requests for re-dispatch."""
        items = self.pending_items()
        self._buckets.clear()
        self._depth = 0
        return items

    # -- batch formation ----------------------------------------------------

    def drain(self, on: bool = True) -> None:
        """Enter (or leave) drain mode: partial batches release immediately."""
        self._draining = on

    def poll(self, now: Optional[float] = None,
             limit: Optional[int] = None) -> Optional[MicroBatch]:
        """Form and return the next ready batch, or None.

        ``limit`` caps the batch size below ``max_batch`` for callers whose
        downstream capacity varies per tick (ServeEngine's free decode
        slots). A bucket is *ready* when it holds a full batch, its head has
        exceeded the deadline, or the scheduler is draining; among ready
        buckets the one with the oldest head wins.
        """
        if self._depth == 0:
            return None
        cap = self.max_batch if limit is None else min(int(limit), self.max_batch)
        if cap <= 0:
            return None
        now = self._clock() if now is None else now
        best = None  # (head_seq, key)
        for key, q in self._buckets.items():
            if not q:
                continue
            ready = (
                len(q) >= cap
                or self._draining
                or (now - q[0][1]) >= self.max_wait_s
            )
            if ready and (best is None or q[0][0] < best[0]):
                best = (q[0][0], key)
        if best is None:
            return None
        q = self._buckets[best[1]]
        n = min(len(q), cap)
        waited = max(0.0, now - q[0][1])
        items = tuple(q.popleft()[2] for _ in range(n))
        self._depth -= n
        if not q:
            # drop emptied buckets: an unbounded bucket_of key space must
            # not grow the dict (or poll's scan) without bound
            del self._buckets[best[1]]
        return MicroBatch(key=best[1], items=items, pad_to=self._pad_to(n),
                          waited_s=waited, formed_at=now)

    def poll_pack(
        self,
        budget: int,
        length_of: Callable[[Any], int],
        now: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> Optional[PackPlan]:
        """Form a packed-prefill plan: the maximal *strict FIFO prefix* of
        the queue (across buckets, in submission order) whose lengths sum to
        at most ``budget`` tokens, capped at ``limit`` items.

        Strict-prefix semantics are the starvation guarantee: formation
        stops at the first request that does not fit, rather than skipping
        it for smaller later ones — so a long prompt at the head is next no
        matter what arrives behind it. A plan is *ready* when it cannot grow
        (the next request does not fit, or ``limit`` is reached, or the
        whole queue is in it and the deadline/drain says go); otherwise the
        pack keeps coalescing until ``max_wait_s``.
        """
        if self._depth == 0:
            return None
        cap = self._depth if limit is None else int(limit)
        if cap <= 0 or budget <= 0:
            return None
        now = self._clock() if now is None else now
        entries = [e for q in self._buckets.values() for e in q]
        entries.sort(key=lambda e: e[0])
        head_len = length_of(entries[0][2])
        if head_len > budget:
            raise ValueError(
                f"prompt of {head_len} tokens exceeds the pack budget "
                f"({budget}) — raise max_prefill or reject at submit"
            )
        take, used = [], 0
        for e in entries:
            if len(take) >= cap:
                break
            n = length_of(e[2])
            if used + n > budget:
                break
            take.append(e)
            used += n
        blocked = len(take) < len(entries)  # pack is full: cannot grow
        ready = (
            blocked
            or self._draining
            or (now - take[0][1]) >= self.max_wait_s
        )
        if not ready:
            return None
        taken = {e[0] for e in take}
        for key in list(self._buckets):
            q = self._buckets[key]
            kept = deque(e for e in q if e[0] not in taken)
            if kept:
                self._buckets[key] = kept
            else:
                del self._buckets[key]
        self._depth -= len(take)
        return PackPlan(
            items=tuple(e[2] for e in take),
            lengths=tuple(length_of(e[2]) for e in take),
            total=used,
            budget=int(budget),
            waited_s=max(0.0, now - take[0][1]),
            formed_at=now,
        )

    def _pad_to(self, n: int) -> int:
        """Smallest ladder size that fits n (n never exceeds max_batch)."""
        for s in self.batch_sizes:
            if s >= n:
                return s
        return self.max_batch
