"""Metric-suite wiring: one per-batch function on the device + host
accumulators.

Port of ``skeletondiffusion_tpu/metrics/suite.py`` (reference
`src/config_metrics.py`): ``MetricSuite.compute_batch`` computes every
per-item statistic of a batch on the predictions' device (they never go to
the host), and ``MetricSuite.update`` streams the host values.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .accumulators import APDEAccumulator, CMDAccumulator, MetricStorer
from .body_realism import (
    limb_jitter_normed_mean,
    limb_jitter_normed_rmse,
    limb_stretching_normed_mean,
    limb_stretching_normed_rmse,
)
from .multimodal import ade, apd, fde, mae, mmade, mmfde, motion_for_cmd

Array = torch.Tensor


def get_stats_funcs(stats_mode: str, skeleton, **kwargs) -> Dict[str, Callable]:
    """Reference `config_metrics.py:18-53` — same names, same spaces (limb
    metrics ×100 → cm)."""
    limbseq = skeleton.get_limbseq()
    limb_angles_idx = [list(k) for k in skeleton.limb_angles_idx]
    scale100 = lambda fn: (lambda *a, **k: fn(*a, **k) * 100)

    base = {
        "ADE": ade,
        "FDE": fde,
        "MAE": partial(mae, limbseq=limbseq, limb_angles_idx=limb_angles_idx),
        "APD": apd,
        "StretchMean": partial(scale100(limb_stretching_normed_mean), limbseq=limbseq),
        "JitterMean": partial(scale100(limb_jitter_normed_mean), limbseq=limbseq),
        "StretchRMSE": partial(scale100(limb_stretching_normed_rmse), limbseq=limbseq),
        "JitterRMSE": partial(scale100(limb_jitter_normed_rmse), limbseq=limbseq),
    }
    mode = stats_mode.lower()
    if "deterministic" in mode:
        return base
    if mode == "probabilistic_orig":
        return {"APD": apd, "ADE": ade, "FDE": fde, "MMADE": mmade, "MMFDE": mmfde}
    if mode == "probabilistic":
        return {**{k: base[k] for k in ("ADE", "FDE", "MAE")}, "MMADE": mmade, "MMFDE": mmfde,
                **{k: base[k] for k in ("APD", "StretchMean", "JitterMean", "StretchRMSE", "JitterRMSE")}}
    raise NotImplementedError(stats_mode)


class MetricSuite:
    """The per-batch metric function + streaming accumulators.

    Usage per batch (all tensors on the device):
        vals = suite.compute_batch(pred, target, mm_gt=..., mm_mask=...)
        suite.update(vals, class_idxs=...)
    then ``suite.compute()`` → {name: scalar}.
    """

    def __init__(
        self,
        stats_mode: str,
        skeleton,
        if_compute_cmd: bool = False,
        mean_motion_per_class=None,
        if_compute_apde: bool = False,
        mmapd_gt_path: Optional[str] = None,
        **kwargs,
    ):
        self.stats_funcs = get_stats_funcs(stats_mode, skeleton, **kwargs)
        self.needs_mmgt = any(k in self.stats_funcs for k in ("MMADE", "MMFDE"))
        self.storers = {k: MetricStorer("avg") for k in self.stats_funcs}
        self.if_compute_cmd = if_compute_cmd
        self.cmd = CMDAccumulator(mean_motion_per_class) if if_compute_cmd else None
        self.if_compute_apde = if_compute_apde
        self.apde = APDEAccumulator.from_csv(mmapd_gt_path) if if_compute_apde else None

    @torch.no_grad()
    def metric(self, name: str, pred, target, mm_gt=None, mm_mask=None):
        """One metric's per-item values of a batch."""
        fn = self.stats_funcs[name]
        if name in ("MMADE", "MMFDE"):
            return fn(target, pred, mm_gt=mm_gt, mm_mask=mm_mask)
        if name == "APD":
            return fn(pred)
        if name in ("StretchMean", "JitterMean", "StretchRMSE", "JitterRMSE"):
            return fn(pred, target)
        return fn(target, pred)

    @torch.no_grad()
    def _batch(self, pred, target, mm_gt=None, mm_mask=None):
        out = {name: self.metric(name, pred, target, mm_gt, mm_mask) for name in self.stats_funcs}
        if self.if_compute_cmd:
            out["_cmd_curve"] = motion_for_cmd(pred)
        return out

    def compute_batch(self, pred, target, mm_gt=None, mm_mask=None):
        if self.needs_mmgt:
            if mm_gt is None or mm_mask is None:
                raise ValueError("MMADE/MMFDE need mm_gt and mm_mask")
        else:
            mm_gt = mm_mask = None
        return self._batch(pred, target, mm_gt=mm_gt, mm_mask=mm_mask)

    def update(self, batch_values: Dict[str, Array], class_idxs: Optional[np.ndarray] = None,
               count: Optional[int] = None):
        """``batch_values``: numpy arrays or host tensors.  ``count``: number
        of REAL items in the batch — trailing pad rows (the padded final
        batch) are dropped from every accumulator."""
        vals = {k: np.asarray(v) for k, v in batch_values.items()}
        if count is not None:
            vals = {k: v[:count] for k, v in vals.items()}
        for name, storer in self.storers.items():
            storer.update(vals[name])
        if self.cmd is not None:
            if class_idxs is None:
                raise ValueError("CMD needs the batch's class ids")
            self.cmd.update(vals["_cmd_curve"], class_idxs)
        if self.apde is not None:
            # every stats mode computes APD (`get_stats_funcs`), so APDE can
            # always difference against it
            self.apde.update(vals["APD"])

    def compute(self) -> Dict[str, float]:
        results = {k: s.compute() for k, s in self.storers.items()}
        if self.cmd is not None:
            results["CMD"] = self.cmd.compute()
        if self.apde is not None:
            results["APDE"] = self.apde.compute()
        return results

    def reset(self):
        for s in self.storers.values():
            s.reset()
        if self.cmd is not None:
            self.cmd.reset()
        if self.apde is not None:
            self.apde.reset()


def draw_table(results: Dict[str, float]) -> str:
    """Console results table; reference `src/metrics/utils.py:33-53`."""
    keys = list(results)
    w = max(len(k) for k in keys) if keys else 1
    lines = ["| " + " | ".join(f"{k:>{w}}" for k in keys) + " |",
             "| " + " | ".join("-" * w for _ in keys) + " |",
             "| " + " | ".join(f"{results[k]:>{w}.4f}" for k in keys) + " |"]
    return "\n".join(lines)
