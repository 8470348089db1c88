"""Serving programs: the port's counterpart of the reference engines'
ahead-of-time compiled steps (``repro.serving.engine._compiled``).

On the card a program is one CUDA graph of a step (``GraphProgram``): the
step is run once on a side stream (builds the kernels, their workspaces
and shared-memory attributes), then captured on that stream into a graph
whose memory comes from one pool the engine's graphs share. A call copies
the host inputs into the graph's static input buffers (from pinned
staging, ``non_blocking``) and replays it: one launch in place of the
thousands of kernel launches of the eager step. The outputs are the
graph's static buffers, overwritten by the next replay; a caller that keeps
one past that clones it. A failed capture raises: nothing falls back to
eager execution. With ``aot_warmup=False``, and on the CPU, a program is
the step run eagerly (``EagerProgram``), through the same code.

The kernel wrappers count their launches as they enqueue them; during a
capture nothing is launched, so a ``GraphProgram`` takes the launches its
capture counted (by wrapper and by mode) off the counters again and adds
them back at every replay: the counts stay exact per forward.

``StepTimer`` times a program's steps for the MFU join, as device time:
a pair of CUDA timing events read by whoever synchronises that step
anyway. A captured graph records the pair itself: its first and last nodes
are event-record nodes (captured from ``external`` events), and each replay
first points them at the caller's pair (``cuGraphExecEventRecordNodeSetEvent``,
which leaves launches already enqueued as they were), so the pair spans the
graph's execution on the device: from its first node to its last, the gaps
between its kernels included, and neither the host's enqueue nor the
graph's launch latency. A pair recorded on the stream around the replay
would start when the stream reaches it, which on an idle card (a serving
loop that the host paces) is before the replay is even launched. An eager
step records the pair on the stream around its call. On the CPU the host
clock stamps the caller already took stand in.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def _counted():
    """The kernel wrappers that count their launches."""
    from repro_torch.kernels.expert_linear import grouped_matmul
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.norm import rmsnorm
    from repro_torch.kernels.quant_attention import lm_attention, streaming_attention
    from repro_torch.kernels.selective_scan import selective_scan

    return (int8_matmul, grouped_matmul, streaming_attention, lm_attention,
            selective_scan, rmsnorm)


def launch_counts() -> dict:
    """Each counting wrapper's launches, and per mode as ``"<name>:<mode>"``."""
    out = {}
    for fn in _counted():
        out[fn.__name__] = fn.launches
        for mode, n in getattr(fn, "launches_by_mode", {}).items():
            out[f"{fn.__name__}:{mode}"] = n
    return out


def _add_counts(diff: dict, sign: int = 1) -> None:
    by_name = {fn.__name__: fn for fn in _counted()}
    for key, n in diff.items():
        name, _, mode = key.partition(":")
        fn = by_name[name]
        if mode:
            by_mode = fn.launches_by_mode
            by_mode[mode] = by_mode.get(mode, 0) + sign * n
            if not by_mode[mode]:
                del by_mode[mode]
        else:
            fn.launches += sign * n


_EVENT_RECORD_NODE = 7  # CU_GRAPH_NODE_TYPE_EVENT_RECORD


@functools.lru_cache(maxsize=None)
def _libcuda():
    import ctypes

    return ctypes, ctypes.CDLL("libcuda.so.1")


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def _event_record_nodes(graph: "torch.cuda.CUDAGraph", events) -> list:
    """The event-record nodes of a captured graph that record ``events``,
    in their order, read through ``libcuda`` (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``, ``cuGraphEventRecordNodeGetEvent``)."""
    ctypes, cu = _libcuda()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    found = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == _EVENT_RECORD_NODE:
            ev = ctypes.c_void_p()
            _check(cu.cuGraphEventRecordNodeGetEvent(ctypes.c_void_p(node), ctypes.byref(ev)),
                   "cuGraphEventRecordNodeGetEvent")
            found[ev.value] = node
    handles = [e.cuda_event for e in events]
    if not all(h in found for h in handles):
        raise RuntimeError("a captured graph lacks its timing event-record nodes")
    return [found[h] for h in handles]


def record(mark, i: int, device: torch.device) -> None:
    """Record event ``i`` (0: start, 1: end) of a ``StepTimer`` mark on the
    device's current stream; nothing for no mark."""
    if mark is not None:
        mark[i].record(torch.cuda.current_stream(device))


class StepTimer:
    """Device time of program steps. ``take()`` hands out a pair of timing
    events (on the CPU: None), which the step records around its device
    work (a program does it when called with ``mark=``; other steps call
    ``record``), and
    ``seconds(mark, host_seconds)`` reads the pair once the step has been
    synchronised (waiting for its end event otherwise), or hands back
    ``host_seconds`` on the CPU. Pairs come from a small free list and go
    back to it once read, so a tick allocates none."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.device_time = device.type == "cuda"
        self._free: deque = deque()

    def take(self):
        if not self.device_time:
            return None
        try:
            return self._free.popleft()
        except IndexError:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            for e in pair:  # the CUDA event is made at its first record
                e.record(torch.cuda.current_stream(self.device))
            return pair

    def seconds(self, mark, host_seconds: Optional[float] = None) -> float:
        if mark is None:
            return host_seconds
        start, end = mark
        end.synchronize()
        ms = start.elapsed_time(end)
        self._free.append(mark)
        return ms / 1e3


class PinnedRing:
    """Pinned host buffers that host inputs are staged in on their way to a
    graph's static inputs, used in turn; a buffer is written again only
    after the copy that read it has run (its event)."""

    def __init__(self, nbytes: int, depth: int = 4) -> None:
        self._bufs = [torch.empty(max(nbytes, 16), dtype=torch.uint8, pin_memory=True)
                      for _ in range(depth)]
        self._events = [None] * depth
        self._i = 0

    def copy_in(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """dst (a contiguous device tensor) <- arr, enqueued on the current
        stream without waiting for it."""
        src = torch.from_numpy(np.ascontiguousarray(arr)).to(dst.dtype).reshape(-1)
        nbytes = src.numel() * src.element_size()
        i = self._i
        self._i = (i + 1) % len(self._bufs)
        if nbytes > self._bufs[i].numel():
            raise ValueError(f"{nbytes} bytes of input, staging holds {self._bufs[i].numel()}")
        if self._events[i] is not None:
            self._events[i].synchronize()
        host = self._bufs[i][:nbytes].view(dst.dtype)
        host.copy_(src)
        dst.view(-1).copy_(host, non_blocking=True)
        ev = self._events[i] = self._events[i] or torch.cuda.Event()
        ev.record()


class EagerProgram:
    """A step run eagerly: host inputs (numpy) are copied to the device
    (pinned, without waiting, on a card), device inputs pass as they are."""

    graph = None

    def __init__(self, fn: Callable, device: torch.device) -> None:
        self.fn, self.device = fn, device

    def _put(self, x):
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.array(x, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def __call__(self, *inputs, mark=None):
        args = list(map(self._put, inputs))
        record(mark, 0, self.device)
        out = self.fn(*args)
        record(mark, 1, self.device)
        return out


class GraphProgram:
    """One step captured as a CUDA graph. ``example`` holds the step's
    inputs: a numpy array for each host input (its shape and dtype make
    the static input buffer), and for a device input the very tensor every
    call passes (it is read in place). ``launches``: the wrapper launches
    (by name and ``name:mode``) one replay makes; ``graph`` keeps its
    ``cudaGraph_t`` for inspection (``raw_cuda_graph``). The graph's first
    and last nodes record a pair of timing events: the program's own pair,
    or the ``mark=`` of a call (``StepTimer``)."""

    def __init__(self, fn: Callable, example: Sequence, *, device: torch.device,
                 pool, stream: torch.cuda.Stream, ring: PinnedRing) -> None:
        self._ring = ring
        self.device = device
        self.inputs = [x if isinstance(x, torch.Tensor) else
                       torch.from_numpy(np.array(x, copy=True)).to(device) for x in example]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(*self.inputs)  # builds kernels, workspaces and handles on the capture stream
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        # external events: captured as event-record nodes, not as a
        # dependency between streams
        self._own_mark = (torch.cuda.Event(enable_timing=True, external=True),
                          torch.cuda.Event(enable_timing=True, external=True))
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self._own_mark[0].record(stream)
            self.outputs = fn(*self.inputs)
            self._own_mark[1].record(stream)
        after = launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        _add_counts(self.launches, -1)  # a capture enqueues nothing
        self.graph.instantiate()
        self._mark_nodes = _event_record_nodes(self.graph, self._own_mark)
        self._mark = self._own_mark  # the pair the nodes record now

    def _point_marks(self, mark) -> None:
        """Make the graph's timing nodes record ``mark`` from the next
        launch on."""
        if mark is self._mark:
            return
        ctypes, cu = _libcuda()
        exe = ctypes.c_void_p(self.graph.raw_cuda_graph_exec())
        for node, ev in zip(self._mark_nodes, mark):
            _check(cu.cuGraphExecEventRecordNodeSetEvent(exe, ctypes.c_void_p(node),
                                                         ctypes.c_void_p(ev.cuda_event)),
                   "cuGraphExecEventRecordNodeSetEvent")
        self._mark = mark

    def __call__(self, *inputs, mark=None):
        for static, x in zip(self.inputs, inputs):
            if isinstance(x, torch.Tensor):
                if x is not static:
                    raise ValueError("a device input of a captured program must be the "
                                     "tensor it was captured with")
            else:
                self._ring.copy_in(static, x)
        self._point_marks(self._own_mark if mark is None else mark)
        self.graph.replay()
        _add_counts(self.launches)
        return self.outputs


def own(program, tree):
    """``tree`` (a tensor, a tuple or dict of them, or None) as the caller's
    own: a graph program's outputs are cloned, since its next replay
    overwrites them; an eager program's are fresh already."""
    if program.graph is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: own(program, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(own(program, v) for v in tree)
    return tree.clone()

