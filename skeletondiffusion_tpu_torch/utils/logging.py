"""``AverageTimer``: per-batch wall-clock statistics of the eval loop.

A copy of ``skeletondiffusion_tpu/utils/logging.py::AverageTimer`` (`:116`;
reference `src/utils/time.py:5-20`).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class AverageTimer:
    """Per-batch wall-clock stats behind ``if_measure_time``; reference
    `src/utils/time.py:5-20`."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("AverageTimer.stop() without start()")
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.times)
        if arr.size == 0:
            return {}
        return {
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "n": int(arr.size),
        }
