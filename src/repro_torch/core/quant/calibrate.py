"""Activation-statistics collection for PTQ calibration, ported from
``repro.core.quant.calibrate``.

The fp model runs over a small calibration set while ``TapCollector``
records per-site statistics on the host (numpy), whatever device the model
runs on.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class TapCollector:
    """Records running min/max/absmax per named site (host-side)."""

    def __init__(self) -> None:
        self.stats: Dict[str, Dict[str, np.ndarray]] = {}

    def record(self, site: str, x: torch.Tensor) -> None:
        d = x.shape[-1]
        flat = x.detach().float().cpu().numpy().reshape(-1, d)
        st = self.stats.get(site)
        if st is None:
            self.stats[site] = {
                "min": flat.min(axis=0),
                "max": flat.max(axis=0),
                "absmax": np.abs(flat).max(),
            }
        else:
            st["min"] = np.minimum(st["min"], flat.min(axis=0))
            st["max"] = np.maximum(st["max"], flat.max(axis=0))
            st["absmax"] = max(st["absmax"], float(np.abs(flat).max()))

    def absmax(self, site: str) -> float:
        return float(self.stats[site]["absmax"])

    def scoped(self, prefix: str) -> "ScopedTaps":
        return ScopedTaps(self, prefix)


class ScopedTaps:
    """Per-layer view of a TapCollector: prepends ``prefix.`` to site names."""

    def __init__(self, base: TapCollector, prefix: str) -> None:
        self.base = base
        self.prefix = prefix

    def record(self, site: str, x: torch.Tensor) -> None:
        self.base.record(f"{self.prefix}.{site}", x)

    def scoped(self, prefix: str) -> "ScopedTaps":
        return ScopedTaps(self.base, f"{self.prefix}.{prefix}")


def maybe_record(taps: Optional[TapCollector], site: str, x: torch.Tensor) -> None:
    if taps is not None:
        taps.record(site, x)
