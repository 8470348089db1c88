"""Device meshes of the port, ported from ``repro.launch.mesh``.

A ``Mesh`` is an array of *shard slots* with axis names, the port's
counterpart of ``jax.sharding.Mesh``: each slot names the ``torch.device``
its shard runs on. One process drives every slot (a single controller, as
in the reference, where one process runs ``shard_map`` over its devices),
so nothing here uses ``torch.distributed``. A device may fill more than one
slot: several shards then run on one card (or on the CPU), the counterpart
of the reference tests' fake host devices
(``--xla_force_host_platform_device_count``).

A ``("pod", "data", "model")`` mesh (``Mesh(devices, axis_names)``, its
slots on one card) runs ``train/train_step.py``'s cross-pod INT8
reduction. ``make_production_mesh`` (the TPU pods' 256- and 512-chip
layouts) is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def visible_devices(devices=None) -> List[torch.device]:
    """``devices`` as ``torch.device``s; by default every visible card, and
    without one a ``RuntimeError`` (never a silent fall back to the CPU)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] (replicas "
            "with device='cpu') to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Slots (an object ndarray of ``torch.device``) and their axis names.
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does; ``devices`` is the slot array."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.flat]
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh of "
                             f"shape {self.devices.shape}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _make(axis_shape: Sequence[int], axis_names: Sequence[str], devices) -> Mesh:
    """A mesh over the first prod(axis_shape) of ``devices`` (the reference's
    ``jax.make_mesh``: more devices than slots keeps the first ones, fewer
    raises)."""
    size = math.prod(axis_shape)
    if size > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {tuple(axis_shape)}")
    return Mesh(np.asarray(devices[:size], dtype=object).reshape(tuple(axis_shape)),
                axis_names)


def make_host_mesh(model_axis: int = 1, devices=None) -> Mesh:
    """A ``('data', 'model')`` mesh over every visible card (or
    ``devices``), ``model_axis`` wide."""
    devs = visible_devices(devices)
    n = len(devs)
    model_axis = min(model_axis, n)
    return _make((n // model_axis, model_axis), ("data", "model"), devs)


def make_ep_mesh(n: int = 0, devices=None) -> Mesh:
    """A 1-axis ``('model',)`` mesh for expert-parallel serving over the
    first ``n`` (default: all) visible cards or entries of ``devices``,
    which may name one device several times (several shards on one
    card)."""
    devs = visible_devices(devices)
    n = n or len(devs)
    return _make((n,), ("model",), devs)


def single_device(mesh: Mesh) -> torch.device:
    """The device of ``mesh``'s slots, which must all name one device: an
    engine captures each program into one CUDA graph on one device, and a
    mesh over several cards raises ``NotImplementedError`` (the port has
    been run on one card only, so capture across cards is untested)."""
    devs = {str(d) for d in mesh.devices.flat}
    if len(devs) > 1:
        raise NotImplementedError(
            f"a mesh over {len(devs)} devices ({', '.join(sorted(devs))}): the "
            "engines run a mesh whose slots share one device; the port has been "
            "run on one card only, so graph capture across cards is untested "
            "(several slots may name one card: make_ep_mesh(n, devices=['cuda:0'] * n))")
    return mesh.devices.flat[0]
