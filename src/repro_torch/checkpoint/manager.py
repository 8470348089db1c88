"""Atomic checkpointing with async save, ported from
``repro.checkpoint.manager``, in the reference's on-disk format: a
checkpoint written by either package restores in the other.

  * **Atomic**: each checkpoint is written to ``step_<N>.tmp/`` and renamed
    to ``step_<N>/`` only after every array and the manifest are fsynced,
    so a crash mid-save never corrupts the latest checkpoint.
  * **Async**: ``save()`` copies the tensors to host memory (blocking only
    for that copy), then writes on a background thread; ``wait()`` joins
    it (and raises what it raised) before the next save or a restore.
  * **Layout**: one ``.npy`` per leaf, keyed by its tree path (``_flatten``:
    dict keys sorted, list and tuple entries -- a ``TrainState``'s fields --
    by index), and ``manifest.json`` with the step and each leaf's file,
    shape and dtype. Types numpy lacks (bf16, fp8) are stored as their raw
    bits (``uint16`` / ``uint8``) beside the logical name; the port reads
    and writes those bits through ``torch`` views, so it needs no
    ``ml_dtypes``. int8 and nibble-packed int4 (``uint8``) leaves keep their
    type.
  * **Restore**: into a structure's tree shape, each leaf on the device of
    the structure's leaf; or, with ``structure=None``, the nested tree
    rebuilt from the manifest alone (a PTQ tree no template describes).
  * **keep_last_k** garbage collection.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.param import require_device

# torch types numpy has no type for -> (the reference's name, the numpy type
# of the stored raw bits, the torch integer type of the same width that
# views them; numpy views the stored bits as that type's numpy twin)
_RAW_BITS = {
    torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8),
}
_BY_NAME = {name: (torch_dt, bits) for torch_dt, (name, _, bits) in _RAW_BITS.items()}
_NUMPY_TWIN = {torch.int16: np.int16, torch.uint8: np.uint8}


def _flatten(tree, prefix=""):
    out: Dict[str, Any] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _nest(flat: Dict[str, Any]):
    """Rebuild a nested tree from manifest keys alone. Dict levels whose
    keys are exactly 0..n-1 were lists or tuples at save time and come back
    as lists."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            order = sorted(out, key=int)
            if order == [str(i) for i in range(len(order))]:
                return [out[k] for k in order]
        return out

    return fix(root)


def _unflatten_into(structure, flat, place, prefix=""):
    if structure is None:
        return None
    if isinstance(structure, dict):
        return {k: _unflatten_into(v, flat, place, f"{prefix}{k}/")
                for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        vals = [_unflatten_into(v, flat, place, f"{prefix}{i}/")
                for i, v in enumerate(structure)]
        if hasattr(structure, "_fields"):  # NamedTuple
            return type(structure)(*vals)
        return type(structure)(vals)
    return place(flat[prefix[:-1]], structure)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a copy: later in-place updates of the
    tensor do not reach the snapshot), in the stored form: raw bits for the
    types numpy lacks."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _RAW_BITS:
        _, np_bits, torch_bits = _RAW_BITS[t.dtype]
        return t.view(torch_bits).numpy().view(np_bits)
    return t.numpy()


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _BY_NAME:
        torch_dt, torch_bits = _BY_NAME[logical]
        bits = arr.view(_NUMPY_TWIN[torch_bits])
        return torch.from_numpy(bits).view(torch_dt)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last_k: int = 3) -> None:
        self.dir = directory
        self.keep = keep_last_k
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot to host, then write asynchronously (atomic rename)."""
        self.wait()
        host = {k: (_to_host(v), _logical(v)) for k, v in _flatten(tree).items()}

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                manifest = {"step": step, "leaves": {}}
                for key, (arr, logical) in host.items():
                    fname = key.replace("/", "__") + ".npy"
                    with open(os.path.join(tmp, fname), "wb") as f:
                        np.save(f, arr)
                        f.flush()
                        os.fsync(f.fileno())
                    manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                               "dtype": logical}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.removeprefix("step_")))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, structure=None, step: Optional[int] = None, device=None):
        """Restore the latest checkpoint (or ``step``) into ``structure``'s
        tree shape, each leaf on the device of the structure's tensor leaf
        (``device``, where given, overrides); or, with ``structure=None``,
        the nested tree rebuilt from the manifest on ``device`` (default
        ``cuda``; a CUDA device without a card raises)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {key: _from_host(np.load(os.path.join(path, info["file"])), info["dtype"])
                for key, info in manifest["leaves"].items()}
        if structure is None:
            dev = require_device(device or "cuda")
            return _nest({k: v.to(dev) for k, v in flat.items()})
        fixed = None if device is None else require_device(device)

        def place(t: torch.Tensor, like):
            dev = fixed or (like.device if isinstance(like, torch.Tensor) else "cpu")
            return t.to(dev)

        return _unflatten_into(structure, flat, place)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)


def _logical(leaf) -> str:
    """The dtype name the manifest records (numpy's names; bf16 and fp8 by
    the names the reference gives them)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in _RAW_BITS:
            return _RAW_BITS[leaf.dtype][0]
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)
