"""Streaming per-timestep metric accumulators (the training-validation
MPJPE/FDE tables); reference `src/metrics/{ignite_mpjpe,ignite_fde}.py`.

Streaming means over batches of per-frame errors — unlike the reference,
which concatenates every batch on CPU and reduces at the end
(`ignite_mpjpe.py:32-38`), these keep only running sums.

A copy of ``skeletondiffusion_tpu/metrics/tables.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def format_metric_time_table(metric: np.ndarray, interval: int = 30) -> np.ndarray:
    """Sample the per-frame curve every FPS/2 frames; reference
    `src/metrics/utils.py:5-10`."""
    steps = [i * interval for i in range(16) if i * interval < len(metric)]
    return np.stack([metric[t] for t in steps], axis=0)


class MeanPerJointPositionErrorTable:
    """Per-timestep (optionally per-joint) MPJPE over a stream of
    (pred [B,T,J,3], target [B,T,J,3]) batches; reference
    `ignite_mpjpe.py:9-49`."""

    def __init__(self, keep_time_dim: bool = True, keep_joint_dim: bool = False):
        self.keep_time_dim = keep_time_dim
        self.keep_joint_dim = keep_joint_dim
        self.reset()

    def reset(self):
        self._sum: Optional[np.ndarray] = None
        self._count = 0

    def update(self, y_pred: np.ndarray, y: np.ndarray):
        err = np.linalg.norm(np.asarray(y) - np.asarray(y_pred), axis=-1)  # [B,T,J]
        s = err.sum(axis=0)
        self._sum = s if self._sum is None else self._sum + s
        self._count += err.shape[0]

    def compute(self) -> np.ndarray:
        assert self._count > 0, "no examples accumulated"
        ret = self._sum / self._count  # [T,J]
        if not self.keep_joint_dim:
            ret = ret.mean(axis=-1)
        if not self.keep_time_dim:
            ret = ret.mean(axis=0)
        else:
            ret = format_metric_time_table(ret)
        return ret


class FinalDisplacementErrorMeter:
    """Streaming FDE (last-frame joint error mean); reference
    `ignite_fde.py:8-40`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def update(self, y_pred: np.ndarray, y: np.ndarray):
        err = np.linalg.norm(
            np.asarray(y)[..., -1, :, :] - np.asarray(y_pred)[..., -1, :, :], axis=-1
        )
        self._sum += float(err.sum())
        self._count += err.size

    def compute(self) -> float:
        assert self._count > 0
        return self._sum / self._count
