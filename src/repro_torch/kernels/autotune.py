"""Kernel autotuner: per-device tables that pick the grouped kernel's
variant and ``lm_attention``'s schedule, ported from
``repro.kernels.autotune``.

The reference searches Pallas tile pairs shaped around the TPU's sublane x
lane grid. The port's kernels have no such grid; what they choose by rule
is tuned instead, on the card that will run them:

  * ``grouped_matmul``: the variant (``expert_linear.choose_variant``):
    ``mma``, ``stream`` and ``dp4a`` in the integer modes, ``mma``,
    ``stream`` and ``fma`` in the f32 mode;
  * ``streaming_attention`` (the reference's name for the attention key):
    ``lm_attention``'s schedule (``quant_attention.choose_schedule``),
    ``decode`` or ``tile``; a key of the vision case has one design,
    ``vision``.

Every candidate gives the rule's bits: the integer variants accumulate
exactly, f32 ``mma`` and ``stream`` are bit-equal (``fma``, which sums in
another order, is a candidate only where it is the rule's pick), and the
decode schedule is bit-equal to the tile schedule. A table changes speed,
never a result, and the sweep holds every candidate to it.

Pipeline (engine ``warmup()`` drives it, before any graph is captured):

  1. **collect**: inside ``collecting()`` the replica runs every program it
     will build once, eagerly; every ``kernels.ops`` dispatch records the
     shape-bucket key it would look up (rows and sequence lengths bucket to
     the next power of two, so one entry covers a range of shapes) and
     takes the rule's pick;
  2. **sweep**: each key missing from the table gets its candidates timed
     on the card (the rule's pick first): seeded random operands, copies
     rotated past the L2 so weights come from memory as in serving, each
     candidate a CUDA graph of a few calls replayed ``reps`` times, the
     median of its device time (events at the graph's first and last
     node). Each output is compared bit for bit with the rule's; a
     mismatch or a failed launch raises (the candidates come from the
     kernels' own ``takes`` / ``choose_schedule``). Without a card the key
     gets the rule's pick, ``ms`` None, ``source`` ``default``;
  3. **persist**: a versioned JSON table per device kind,
     ``<cache_dir>/autotune_torch_<kind>.json``; a later ``ensure_tuned``
     on the same kind sweeps nothing. A corrupt file, another table
     version, another device kind or an entry of an older kernel version
     is dropped at load: the worst case is an empty table.

Table entries map the key string to ``{"choice": name, "ms": float|None,
"source": "swept"|"default"|"override", "candidates": {name: ms}}``:
the chosen variant or schedule, its device ms a call, where it came from,
and (swept entries) every candidate's device ms.

At dispatch ``kernels.ops`` resolves the key of every call, on any device;
on a CUDA tensor it passes the tuned variant or schedule to the kernel, and
with no active table or on a miss nothing, so the kernel's rule picks. A
call whose operands the tuned pick cannot take (16-byte alignment) takes
the rule's pick and counts in ``stats["untakeable"]``. A captured CUDA
graph keeps the pick its capture resolved.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import AutotuneConfig
from repro_torch.kernels import expert_linear, quant_attention

# Bumped when a kernel's variants or schedules, or the rule that chooses
# among them, change: entries swept against an older kernel are dropped at
# load, so a table never pins a choice the kernel no longer makes.
KERNEL_VERSIONS: Dict[str, int] = {
    "grouped_matmul": 1,
    "streaming_attention": 1,
}
TABLE_VERSION = 1
VISION = "vision"  # the one design of the vision attention key
# operand copies of a sweep are rotated over at least this many bytes,
# three times the H100's 50 MB L2
COLD_BYTES = 150e6
MAX_COPIES = 64
MIN_CALLS = 4  # kernel calls a timed graph holds, at least
SWEEP_SEED = 0

_CHOICES = {
    "grouped_matmul": set(expert_linear.VARIANTS.values())
    | set(expert_linear.F32_VARIANTS.values()),
    "streaming_attention": set(quant_attention.SCHEDULES.values()) | {VISION},
}


# ---------------------------------------------------------------------------
# Shape-bucket keys (the reference's strings, letter for letter)
# ---------------------------------------------------------------------------

def bucket_pow2(n: int, lo: int = 8, hi: int = 1 << 20) -> int:
    """Next power of two >= n, clamped to [lo, hi]: one entry covers every
    shape that rounds to the same bucket."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b <<= 1
    return max(lo, min(b, hi))


class TuneRequest(NamedTuple):
    """One (kernel, shape-bucket) tuning unit. ``params`` is a tuple of
    (name, value) pairs: everything needed to make sweep operands and to
    rebuild the key."""

    kernel: str
    params: Tuple[Tuple[str, object], ...]

    @property
    def key(self) -> str:
        parts = [f"{k}={v}" for k, v in self.params]
        return "|".join([self.kernel] + parts)

    def get(self, name: str):
        return dict(self.params)[name]


def _dt(dtype) -> str:
    """A dtype's name as the reference writes it (``jnp.dtype(...).name``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def gmm_request(T: int, G: int, Din: int, Dout: int, *, x_dtype, w_dtype,
                scaled: bool, ascaled: bool) -> TuneRequest:
    # ``din`` is the logical input width (x.shape[1]); ``pk`` marks a
    # nibble-packed int4 stack (uint8, ceil(din/2) rows)
    return TuneRequest("grouped_matmul", (
        ("T", bucket_pow2(T)),
        ("G", int(G)),
        ("din", int(Din)),
        ("dout", int(Dout)),
        ("xdt", _dt(x_dtype)),
        ("wdt", _dt(w_dtype)),
        ("ws", int(bool(scaled))),
        ("as", int(bool(ascaled))),
        ("pk", int(_dt(w_dtype) == "uint8")),
    ))


def attn_request(B: int, H: int, KVH: int, hd: int, Sq: int, Sk: int, *,
                 causal: bool, quant_bits: int, scaled: bool,
                 q_dtype, k_dtype, local_window: int = 0) -> TuneRequest:
    return TuneRequest("streaming_attention", (
        ("B", bucket_pow2(B, lo=1)),
        ("H", int(H)),
        ("kvh", int(KVH)),
        ("hd", int(hd)),
        ("sq", bucket_pow2(Sq, lo=1)),
        ("sk", bucket_pow2(Sk, lo=8)),
        ("causal", int(bool(causal))),
        ("lw", int(local_window)),  # a config constant: not bucketed
        ("qb", int(quant_bits)),
        ("ks", int(bool(scaled))),
        ("qdt", _dt(q_dtype)),
        ("kdt", _dt(k_dtype)),
    ))


def request_from_key(key: str) -> TuneRequest:
    """The request whose ``key`` is ``key`` (an override names a key)."""
    kernel, *parts = key.split("|")
    if kernel not in KERNEL_VERSIONS:
        raise KeyError(f"unknown kernel {kernel!r} in key {key!r}")
    params = []
    for part in parts:
        name, _, value = part.partition("=")
        params.append((name, int(value) if re.fullmatch(r"-?\d+", value) else value))
    return TuneRequest(kernel, tuple(params))


# ---------------------------------------------------------------------------
# Candidates: the kernels' own legality rules, the rule's pick first
# ---------------------------------------------------------------------------

def _integer(req: TuneRequest) -> bool:
    return req.get("wdt") in ("int8", "uint8")


def _is_vision(req: TuneRequest) -> bool:
    """Whether ``ops.attention`` sends a call of this key to the vision
    kernel (``streaming_attention``) on the card."""
    return (not req.get("causal") and req.get("qb") > 0 and not req.get("lw")
            and not req.get("ks") and req.get("qdt") == req.get("kdt") == "float32"
            and quant_attention.fits_in_shared_memory(req.get("sk"), req.get("hd")))


def gmm_candidates(req: TuneRequest) -> List[str]:
    """The grouped kernel's variants for one key: the rule's pick, then
    every other variant that takes the widths (f32: ``fma`` only as the
    rule's pick, since it sums in another order)."""
    T, G, Din, Dout = req.get("T"), req.get("G"), req.get("din"), req.get("dout")
    f32 = not _integer(req)
    names = expert_linear.F32_VARIANTS if f32 else expert_linear.VARIANTS
    pick = expert_linear.choose_variant(T, G, Din, Dout, f32=f32)
    rest = [v for v in sorted(names) if v != pick and expert_linear.takes(v, Din, Dout, f32=f32)
            and not (f32 and v == 3)]
    return [names[v] for v in [pick] + rest]


def attn_candidates(req: TuneRequest) -> List[str]:
    """``lm_attention``'s schedules for one key: ``decode`` and then
    ``tile`` where ``choose_schedule`` picks decode, else ``tile`` alone;
    a vision key has its one design."""
    if _is_vision(req):
        return [VISION]
    pick = quant_attention.choose_schedule(req.get("sq"), req.get("sk"), req.get("H"),
                                           req.get("kvh"), req.get("hd"))
    names = quant_attention.SCHEDULES
    return [names[0], names[1]] if pick == 0 else [names[1]]


def candidates_for(req: TuneRequest) -> List[str]:
    if req.kernel == "grouped_matmul":
        return gmm_candidates(req)
    if req.kernel == "streaming_attention":
        return attn_candidates(req)
    raise KeyError(f"unknown kernel {req.kernel!r}")


def default_for(req: TuneRequest) -> str:
    """The rule's pick at the key's shapes."""
    return candidates_for(req)[0]


# ---------------------------------------------------------------------------
# Tuning table (persistent, versioned, per device kind)
# ---------------------------------------------------------------------------

def _sanitize(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", kind).strip("-") or "unknown"


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """The card's name, sanitised for a file name (``NVIDIA-H100-80GB-HBM3``),
    or ``cpu``."""
    device = _device(device)
    if device.type == "cuda":
        return _sanitize(torch.cuda.get_device_name(device))
    return device.type


def table_path(cfg: AutotuneConfig, kind: Optional[str] = None) -> str:
    """The table file of a device kind. The reference's own tables are
    ``autotune_<kind>.json``: the port never reads them."""
    base = cfg.cache_dir or os.environ.get("REPRO_AUTOTUNE_CACHE", ".repro_autotune")
    return os.path.join(base, f"autotune_torch_{_sanitize(kind or device_kind())}.json")


def _entry(choice: str, ms: Optional[float], source: str,
           candidates: Optional[Dict[str, Optional[float]]] = None) -> dict:
    return {"choice": str(choice), "ms": None if ms is None else float(ms),
            "source": str(source),
            "candidates": {str(k): None if v is None else float(v)
                           for k, v in (candidates or {}).items()}}


class TuningTable:
    """In-memory tuning table bound to one device kind and cache file.

    ``entries``: key -> entry (module docstring). ``stats``: lookup
    ``hits`` / ``misses``, ``swept`` (entries made by a sweep) and
    ``untakeable`` (calls whose operands the tuned pick could not take);
    ``sweep_s``: host seconds spent sweeping."""

    def __init__(self, kind: str, path: Optional[str] = None) -> None:
        self.device_kind = kind
        self.path = path
        self.entries: Dict[str, dict] = {}
        self.stats = {"hits": 0, "misses": 0, "swept": 0, "untakeable": 0}
        self.sweep_s = 0.0
        self.dirty = False

    def lookup(self, key: str) -> Optional[str]:
        e = self.entries.get(key)
        if e is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return e["choice"]

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, choice: str, ms: Optional[float], source: str,
            candidates: Optional[Dict[str, Optional[float]]] = None) -> None:
        entry = _entry(choice, ms, source, candidates)
        if self.entries.get(key) != entry:
            self.entries[key] = entry
            self.dirty = True

    def to_json(self) -> dict:
        return {
            "table_version": TABLE_VERSION,
            "device_kind": self.device_kind,
            "kernel_versions": dict(KERNEL_VERSIONS),
            "entries": self.entries,
        }

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("tuning table has no cache path")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.dirty = False
        return path

    @classmethod
    def load(cls, path: Optional[str], kind: str) -> "TuningTable":
        """Load a table, dropping what it cannot use: a corrupt file,
        another table version or device kind, entries of an older kernel
        version, malformed entries. Never raises."""
        table = cls(kind, path)
        if not path or not os.path.exists(path):
            return table
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return table
        if not isinstance(raw, dict) or raw.get("table_version") != TABLE_VERSION \
                or raw.get("device_kind") != kind:
            return table
        file_kv = raw.get("kernel_versions")
        entries = raw.get("entries")
        if not isinstance(file_kv, dict) or not isinstance(entries, dict):
            return table
        for key, e in entries.items():
            kernel = str(key).split("|", 1)[0]
            if kernel not in KERNEL_VERSIONS or file_kv.get(kernel) != KERNEL_VERSIONS[kernel]:
                continue  # swept against another kernel version: stale
            try:
                if e["choice"] not in _CHOICES[kernel]:
                    continue
                entry = _entry(e["choice"], e.get("ms"), e.get("source", "swept"),
                               dict(e.get("candidates") or {}))
            except (TypeError, KeyError, ValueError, AttributeError):
                continue
            table.entries[str(key)] = entry
        return table


# ---------------------------------------------------------------------------
# Ambient state: the active table and the collection scope
# ---------------------------------------------------------------------------

_ACTIVE: Optional[TuningTable] = None
_COLLECT: Optional[Dict[str, TuneRequest]] = None


def active_table() -> Optional[TuningTable]:
    return _ACTIVE


def activate(table: Optional[TuningTable]) -> None:
    """Install (or clear, with None) the process-wide active table, which
    every ``kernels.ops`` dispatch consults."""
    global _ACTIVE
    _ACTIVE = table


def deactivate() -> None:
    activate(None)


@contextlib.contextmanager
def collecting():
    """Scope in which ops dispatches record the keys they would look up,
    and look nothing up (the collection run takes the rule's picks).
    Yields the key -> TuneRequest dict being filled; nested scopes fold
    outward."""
    global _COLLECT
    prev, _COLLECT = _COLLECT, {}
    try:
        yield _COLLECT
    finally:
        keys, _COLLECT = _COLLECT, prev
        if prev is not None:
            prev.update(keys)


def _resolve(req: TuneRequest) -> Optional[str]:
    if _COLLECT is not None:
        _COLLECT.setdefault(req.key, req)
        return None
    if _ACTIVE is None:
        return None
    return _ACTIVE.lookup(req.key)


def _untakeable() -> None:
    if _ACTIVE is not None:
        _ACTIVE.stats["untakeable"] += 1


def gmm_variant(x: torch.Tensor, w: torch.Tensor, w_scale: Optional[torch.Tensor],
                a_scale) -> Optional[int]:
    """The tuned variant for one ``grouped_matmul`` call (x already int8 in
    the integer modes): its key recorded and looked up on any device; on a
    CUDA tensor the active table's pick where the kernel takes these
    operands, else None (the kernel's rule picks)."""
    if _COLLECT is None and _ACTIVE is None:
        return None
    req = gmm_request(x.shape[0], w.shape[0], x.shape[1], w.shape[2], x_dtype=x.dtype,
                      w_dtype=w.dtype, scaled=w_scale is not None,
                      ascaled=a_scale is not None)
    choice = _resolve(req)
    if choice is None or not x.is_cuda:
        return None
    names = (expert_linear.VARIANTS if expert_linear.integer_mode(x, w)
             else expert_linear.F32_VARIANTS)
    variant = next((v for v, name in names.items() if name == choice), None)
    if variant is None or not expert_linear.variant_takes(variant, x, w, w_scale):
        _untakeable()
        return None
    return variant


def attn_schedule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  quant_bits: int, local_window: int, scaled: bool,
                  vision: bool) -> Optional[int]:
    """The tuned ``lm_attention`` schedule for one ``ops.attention`` call
    (``vision``: the call takes the vision kernel, which has one design):
    its key recorded and looked up on any device; on a CUDA tensor the
    active table's schedule where ``lm_attention`` takes these operands,
    else None (the kernel's rule picks)."""
    if _COLLECT is None and _ACTIVE is None:
        return None
    req = attn_request(q.shape[0], q.shape[2], k.shape[2], q.shape[3], q.shape[1],
                       k.shape[1], causal=causal, quant_bits=quant_bits, scaled=scaled,
                       q_dtype=q.dtype, k_dtype=k.dtype, local_window=local_window)
    choice = _resolve(req)
    if choice is None or not q.is_cuda:
        return None
    if vision or choice == VISION:
        if vision != (choice == VISION):
            _untakeable()
        return None
    schedule = next(s for s, name in quant_attention.SCHEDULES.items() if name == choice)
    if not quant_attention.schedule_takes(schedule, q, k, v):
        _untakeable()
        return None
    return schedule


# ---------------------------------------------------------------------------
# Sweeping
# ---------------------------------------------------------------------------

def _balanced_sizes(T: int, G: int, device) -> torch.Tensor:
    base = T // G
    sizes = [base] * G
    sizes[0] += T - base * G
    return torch.tensor(sizes, dtype=torch.int32, device=device)


def _gmm_operands(req: TuneRequest, gen: torch.Generator, device) -> dict:
    T, G, Din, Dout = req.get("T"), req.get("G"), req.get("din"), req.get("dout")
    ops = {"sizes": _balanced_sizes(T, G, device)}
    if _integer(req):
        ops["x"] = torch.randint(-127, 128, (T, Din), generator=gen, device=device,
                                 dtype=torch.int8)
        if req.get("pk"):
            ops["w"] = torch.randint(0, 256, (G, -(-Din // 2), Dout), generator=gen,
                                     device=device, dtype=torch.uint8)
        else:
            ops["w"] = torch.randint(-127, 128, (G, Din, Dout), generator=gen,
                                     device=device, dtype=torch.int8)
        if req.get("ws"):
            ops["w_scale"] = 0.01 + 0.09 * torch.rand((G, Dout), generator=gen, device=device)
        if req.get("as"):
            ops["a_scale"] = torch.full((1,), 0.037, device=device)
    else:
        ops["x"] = torch.randn((T, Din), generator=gen, device=device)
        ops["w"] = torch.randn((G, Din, Dout), generator=gen, device=device)
    return ops


def _attn_operands(req: TuneRequest, gen: torch.Generator, device) -> dict:
    B, H, KVH, hd = req.get("B"), req.get("H"), req.get("kvh"), req.get("hd")
    Sq, Sk = req.get("sq"), req.get("sk")
    kdt = getattr(torch, req.get("kdt"))
    ops = {"q": torch.randn((B, Sq, H, hd), generator=gen, device=device)
           .to(getattr(torch, req.get("qdt")))}
    for name in ("k", "v"):
        if kdt == torch.int8:
            ops[name] = torch.randint(-127, 128, (B, Sk, KVH, hd), generator=gen,
                                      device=device, dtype=torch.int8)
        else:
            ops[name] = torch.randn((B, Sk, KVH, hd), generator=gen, device=device).to(kdt)
    if req.get("ks"):
        for name in ("k_scale", "v_scale"):
            ops[name] = 0.01 + 0.04 * torch.rand((B, Sk, KVH), generator=gen, device=device)
    return ops


def make_operands(req: TuneRequest, device) -> List[dict]:
    """Seeded random operand sets for one key (int8, packed int4, f32 or
    bf16 as its dtypes say; the grouped rows balanced over the groups), as
    many copies as rotate past the L2 (``COLD_BYTES``)."""
    gen = torch.Generator(device=device).manual_seed(SWEEP_SEED)
    make = _gmm_operands if req.kernel == "grouped_matmul" else _attn_operands
    first = make(req, gen, device)
    nbytes = sum(t.numel() * t.element_size() for t in first.values())
    copies = max(1, min(MAX_COPIES, math.ceil(COLD_BYTES / max(nbytes, 1))))
    return [first] + [make(req, gen, device) for _ in range(copies - 1)]


def build_candidate(req: TuneRequest, choice: str, operands: List[dict]) -> Callable:
    """A zero-argument call of the kernel for ``req`` at ``choice``; each
    call takes the next operand copy, the first call copy 0. Causal keys
    put their queries at the last positions of the keys (a decode at full
    fill; a prefill from position 0)."""
    from repro_torch.kernels.expert_linear import grouped_matmul
    from repro_torch.kernels.quant_attention import lm_attention, streaming_attention

    turn = itertools.count()

    def pick() -> dict:
        return operands[next(turn) % len(operands)]

    if req.kernel == "grouped_matmul":
        names = expert_linear.VARIANTS if _integer(req) else expert_linear.F32_VARIANTS
        variant = next(v for v, name in names.items() if name == choice)

        def fn():
            o = pick()
            return grouped_matmul(o["x"], o["w"], o["sizes"], w_scale=o.get("w_scale"),
                                  a_scale=o.get("a_scale"), variant=variant)
    elif choice == VISION:
        def fn():
            o = pick()
            return streaming_attention(o["q"], o["k"], o["v"], quant_bits=req.get("qb"))
    else:
        schedule = next(s for s, name in quant_attention.SCHEDULES.items() if name == choice)
        causal = bool(req.get("causal"))
        offset = req.get("sk") - req.get("sq") if causal else 0

        def fn():
            o = pick()
            return lm_attention(o["q"], o["k"], o["v"], causal=causal, q_offset=offset,
                                quant_bits=req.get("qb"), local_window=req.get("lw"),
                                k_scale=o.get("k_scale"), v_scale=o.get("v_scale"),
                                schedule=schedule)
    fn.copies = len(operands)
    return fn


def device_timer(fn: Callable, choice: str, *, reps: int = 5) -> float:
    """Median device ms a call of ``fn`` (``build_candidate``): a CUDA
    graph of ``max(MIN_CALLS, copies)`` calls, so every operand copy is
    read in turn, replayed ``reps`` times, each replay timed by the events
    the graph records at its first and last node. ``choice`` names the
    candidate (the ``timer(fn, choice, reps=)`` contract: an injected
    timer may rank candidates without running them)."""
    from repro_torch.serving.programs import GraphProgram, StepTimer

    calls = max(MIN_CALLS, getattr(fn, "copies", 1))
    device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.device(device):
        prog = GraphProgram(lambda: [fn() for _ in range(calls)], [], device=device,
                            pool=torch.cuda.graph_pool_handle(),
                            stream=torch.cuda.Stream(device), ring=None)
    timer = StepTimer(device)
    times = []
    for _ in range(max(1, int(reps))):
        mark = timer.take()
        prog(mark=mark)
        times.append(timer.seconds(mark) * 1e3 / calls)
    times.sort()
    return times[len(times) // 2]


def sweep_request(req: TuneRequest, cfg: AutotuneConfig, *, timer=None, device=None) -> dict:
    """The entry for one key: its candidates (``cfg.budget`` at most, the
    rule's pick first) timed on the card and the fastest kept. Every
    candidate's output must equal the rule's bit for bit, and a candidate
    that fails to launch raises: either is a kernel fault. ``timer(fn,
    choice, reps=)`` may be injected; without one and without a card the
    entry is the rule's pick, ``ms`` None, ``source`` ``default``."""
    cands = candidates_for(req)[:max(1, int(cfg.budget))]
    device = _device(device)
    if timer is None and device.type != "cuda":
        return _entry(cands[0], None, "default")
    timer = timer or device_timer
    with torch.inference_mode():
        operands = make_operands(req, device)
        fns = {c: build_candidate(req, c, operands) for c in cands}
        base = fns[cands[0]]()
        for c in cands[1:]:
            out = fns[c]()
            if not torch.equal(out, base):
                raise RuntimeError(
                    f"autotune: {req.kernel} candidate {c!r} differs from the rule's pick "
                    f"{cands[0]!r} at {req.key}: a kernel fault")
        results = {c: float(timer(fns[c], c, reps=cfg.reps)) for c in cands}
    best = min(cands, key=lambda c: results[c])  # ties keep the rule's pick
    return _entry(best, results[best], "swept", results)


# ---------------------------------------------------------------------------
# ensure_tuned: the warmup entry point
# ---------------------------------------------------------------------------

def _apply_overrides(table: TuningTable, cfg: AutotuneConfig) -> None:
    for key, choice in cfg.overrides:
        kernel = request_from_key(str(key)).kernel
        if choice not in _CHOICES[kernel]:
            raise ValueError(f"autotune override {key!r}: {choice!r} is not one of "
                             f"{sorted(_CHOICES[kernel])}")
        table.put(str(key), str(choice), None, "override")


def ensure_tuned(cfg: AutotuneConfig, trace_fn: Optional[Callable[[], None]] = None, *,
                 timer=None, device=None) -> Optional[TuningTable]:
    """Load (or reuse) the table of ``device``'s kind (the card unless
    given), collect the keys ``trace_fn`` touches, sweep the missing ones,
    save, and leave the table active for every later kernel dispatch.
    Engine ``warmup()`` calls it before capturing any graph; it raises
    inside a capture. The table is process-global and kept per device
    kind, so a second replica (or a relaunch) sweeps nothing."""
    global _ACTIVE
    if not cfg.enable:
        return _ACTIVE
    device = _device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune: no sweep while a CUDA graph is being captured")
    kind = device_kind(device)
    path = table_path(cfg, kind)
    if _ACTIVE is None or _ACTIVE.device_kind != kind or _ACTIVE.path != path:
        _ACTIVE = TuningTable.load(path, kind)
    table = _ACTIVE
    _apply_overrides(table, cfg)
    if trace_fn is not None:
        with collecting() as reqs:
            trace_fn()
        t0 = time.perf_counter()
        for req in reqs.values():
            if table.get(req.key) is not None:
                table.stats["hits"] += 1
                continue
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                entry = sweep_request(req, cfg, timer=timer, device=device)
            table.put(req.key, entry["choice"], entry["ms"], entry["source"],
                      entry["candidates"])
            table.stats["swept"] += 1
        table.sweep_s += time.perf_counter() - t0
    if table.dirty and table.path:
        table.save()
    return table


def summary(table: Optional[TuningTable] = None) -> str:
    """One line for launchers."""
    t = table or _ACTIVE
    if t is None:
        return "autotune: inactive"
    swept = sum(1 for e in t.entries.values() if e["source"] == "swept")
    s = t.stats
    return (f"autotune[{t.device_kind}]: {len(t.entries)} entries ({swept} swept) "
            f"hits={s['hits']} misses={s['misses']} swept_now={s['swept']} "
            f"untakeable={s['untakeable']} sweep_s={t.sweep_s:.2f} table={t.path}")
