"""Host-side streaming accumulators over per-batch device results.

A copy of ``skeletondiffusion_tpu/metrics/accumulators.py`` (reference
`src/metrics/{metric_storer,cmd,apde,fid}.py`) whose APDE file is read with
the standard ``csv`` module: the per-item metric values come from the
device once per batch; these classes only accumulate host scalars and
arrays between batches.
"""
from __future__ import annotations

import csv
from typing import List, Sequence

import numpy as np


class MetricStorer:
    """Streaming mean/max/min; reference `metric_storer.py:7-43`."""

    def __init__(self, return_op: str = "avg"):
        assert return_op in ("mean", "avg", "max", "min")
        self.return_op = return_op
        self.reset()

    def reset(self):
        # ±inf for extrema (the reference initializes 0.0/1e6,
        # `metric_storer.py:16`, returning a never-observed 0.0 for
        # all-negative max streams — a bug not worth reproducing; mean/avg
        # metrics, the whole headline table, are unaffected)
        if self.return_op == "min":
            self.cumulator = np.inf
        elif self.return_op == "max":
            self.cumulator = -np.inf
        else:
            self.cumulator = 0.0
        self.count = 0

    def update(self, values: np.ndarray):
        values = np.asarray(values)
        if self.return_op in ("mean", "avg"):
            self.cumulator += values.sum(0)
            self.count += values.shape[0]
        elif self.return_op == "max":
            self.cumulator = max(self.cumulator, values.max(0))
        else:
            self.cumulator = min(self.cumulator, values.min(0))

    def compute(self) -> float:
        if self.return_op in ("mean", "avg"):
            return float(self.cumulator / max(self.count, 1))
        return float(self.cumulator)


class CMDAccumulator:
    """Accumulates per-segment motion curves + class ids; final class-weighted
    resolve; reference `cmd.py:34-57`."""

    def __init__(self, mean_motion_per_class: Sequence[float]):
        self.mean_motion_per_class = list(mean_motion_per_class)
        self.reset()

    def reset(self):
        self.curves: List[np.ndarray] = []
        self.classes: List[np.ndarray] = []

    def update(self, motion_curves: np.ndarray, class_idxs: np.ndarray):
        self.curves.append(np.asarray(motion_curves))
        self.classes.append(np.asarray(class_idxs))

    def compute(self) -> float:
        from .multimodal import resolve_cmd

        return resolve_cmd(
            np.concatenate(self.curves, 0),
            np.concatenate(self.classes, 0),
            self.mean_motion_per_class,
        )


class APDEAccumulator:
    """|APD − precomputed mm-GT APD| streamed in dataset order; reference
    `apde.py:9-48` (zeros in the reference CSV are NaN-masked)."""

    def __init__(self, mmapd_gt: np.ndarray):
        gt = np.asarray(mmapd_gt, dtype=np.float64).copy()
        gt[gt == 0] = np.nan
        self.mmapd_gt = gt
        self.reset()

    @classmethod
    def from_csv(cls, path: str) -> "APDEAccumulator":
        """The ``gt_APD`` column of the reference's ``mmapd_GT.csv``."""
        with open(path, newline="") as fh:
            return cls(np.asarray([float(row["gt_APD"]) for row in csv.DictReader(fh)]))

    def reset(self):
        self.index = 0
        self.cumulator = 0.0
        self.count = 0

    def update(self, apd_values: np.ndarray):
        apd_values = np.asarray(apd_values, dtype=np.float64)
        b = apd_values.shape[0]
        gt = self.mmapd_gt[self.index : self.index + b]
        if len(gt) < b:
            raise ValueError(
                f"mmapd_GT.csv has only {len(self.mmapd_gt)} rows but the "
                f"eval stream has reached item {self.index + b} — wrong GT "
                "file for this split"
            )
        self.index += b
        diff = np.abs(apd_values - gt)
        self.cumulator += np.nansum(diff)
        self.count += int((~np.isnan(diff)).sum())

    def compute(self) -> float:
        return float(self.cumulator / max(self.count, 1))


class FIDAccumulator:
    """Collects classifier activations for pred/GT, final Fréchet distance;
    reference `fid.py:91-129`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.gt: List[np.ndarray] = []
        self.pred: List[np.ndarray] = []

    def update(self, pred_activations: np.ndarray, gt_activations: np.ndarray):
        self.pred.append(np.asarray(pred_activations))
        self.gt.append(np.asarray(gt_activations))

    def compute(self) -> float:
        from .fid import fid_from_activations

        return fid_from_activations(np.concatenate(self.gt, 0), np.concatenate(self.pred, 0))
