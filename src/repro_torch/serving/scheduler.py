"""Model-agnostic dynamic micro-batcher, a framework-free copy of
``repro.serving.scheduler`` (``MicroBatcher`` and ``Backpressure``; the
packed-prefill planner waits for the LM engine).

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
    of deadline, for end-of-stream flush.

Pure host-side bookkeeping; a ``clock`` can be injected for tests.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence


class Backpressure(RuntimeError):
    """``submit`` refused: the scheduler's pending bound has been reached."""


class MicroBatch(NamedTuple):
    key: Any  # bucket key the batch was formed from
    items: tuple  # requests in FIFO order (len <= pad_to)
    pad_to: int  # ladder size the engine should pad the batch up to
    waited_s: float  # queue wait of the oldest item at formation time


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
        # submission counter so cross-bucket age order is total
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

    # -- batch formation ----------------------------------------------------

    def drain(self, on: bool = True) -> None:
        """Enter (or leave) drain mode: partial batches release immediately."""
        self._draining = on

    def poll(self, now: Optional[float] = None) -> Optional[MicroBatch]:
        """Form and return the next ready batch, or None.

        A bucket is *ready* when it holds a full batch, its head has
        exceeded the deadline, or the scheduler is draining; among ready
        buckets the one with the oldest head wins.
        """
        if self._depth == 0:
            return None
        cap = self.max_batch
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
                          waited_s=waited)

    def _pad_to(self, n: int) -> int:
        """Smallest ladder size that fits n (n never exceeds max_batch)."""
        for s in self.batch_sizes:
            if s >= n:
                return s
        return self.max_batch
