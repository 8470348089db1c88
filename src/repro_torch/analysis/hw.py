"""Roofline peaks of the port's device, in the schema of
``repro.analysis.hw``.

One row: the NVIDIA H100 SXM5, NVIDIA's dense datasheet figures (bf16 989
TFLOP/s, int8 1979 TOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s a direction in
the ``ici_bw`` slot). ``torch.cuda.get_device_name`` is matched by prefix,
case-insensitively; any other device (the CPU) gets the same row flagged
``assumed=True``, so a CPU run's MFU join has a denominator and says it is
not the device's own.
"""
from __future__ import annotations

from typing import Optional

import torch

PEAK_FLOPS_BF16 = 989e12  # dense tensor-core bf16, per card
PEAK_FLOPS_INT8 = 1979e12  # dense tensor-core int8
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction

# device-name prefix -> (bf16 peak, int8 peak, HBM bandwidth, link bandwidth)
_KNOWN_PEAKS = {
    "nvidia h100": (PEAK_FLOPS_BF16, PEAK_FLOPS_INT8, HBM_BW, NVLINK_BW),
}


def device_kind(device=None) -> str:
    """The lower-cased name of ``device`` (a ``torch.device``, or None for
    the current card when there is one): ``torch.cuda.get_device_name`` for
    a card, else the device type (``"cpu"``)."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device).lower()


def device_peaks(device=None, *, use_int8: bool = False) -> dict:
    """Roofline peaks of ``device`` (default: the current card, or the CPU):
    ``peak_flops`` already selected for the bf16 or int8 datapath
    (``use_int8``), the raw per-precision peaks, the bandwidths, the device
    kind, and ``assumed`` when the device is not in the table."""
    kind = device_kind(device)
    match = next((peaks for prefix, peaks in _KNOWN_PEAKS.items()
                  if kind.startswith(prefix)), None)
    assumed = match is None
    bf16, int8, hbm, ici = _KNOWN_PEAKS["nvidia h100"] if assumed else match
    return {
        "device_kind": kind,
        "assumed": assumed,
        "peak_kind": "int8" if use_int8 else "bf16",
        "peak_flops": int8 if use_int8 else bf16,
        "peak_flops_bf16": bf16,
        "peak_flops_int8": int8,
        "hbm_bw": hbm,
        "ici_bw": ici,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def pick_int8(params=None, quant_enabled: Optional[bool] = None) -> bool:
    """Whether the MFU denominator is the int8 peak: quantization enabled in
    the config, or any int8 leaf or nibble-packed int4 stack (``uint8``,
    2-D or more) in the tree, as the reference decides. Int4 stacks take the
    int8 peak: they unpack to int8 and contract on the int8 path. An fp tree
    with quantization off takes the bf16 peak, although it runs in f32."""
    if quant_enabled:
        return True
    for leaf in _leaves(params):
        dt = getattr(leaf, "dtype", None)
        if dt == torch.int8:
            return True
        if dt == torch.uint8 and getattr(leaf, "ndim", 0) >= 2:
            return True
    return False
