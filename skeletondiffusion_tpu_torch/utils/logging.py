"""Training observability and eval timing: ``MetricsLogger``, a JSONL
metrics log (always) with an optional TensorBoard writer, and
``AverageTimer``, the eval loop's per-batch wall clock.

Port of ``skeletondiffusion_tpu/utils/logging.py`` (`:38-141`; reference
`src/utils/tensorboard.py:8-122`, `src/utils/time.py:5-20`): the same
records (per-iteration loss and lr, parameter and gradient norms, per-epoch
per-parameter norms).  The norms are computed on the device and only their
scalars cross to the host.  Parameter names are the modules' ``state_dict``
names with ``/`` for ``.``, which are the flax paths the JAX logger writes.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def _global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, on their device."""
    norms = [torch.linalg.vector_norm(t.detach().float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


# the steps between two norm records (the reference logs per-weight scalars
# every 100 iterations, `src/utils/tensorboard.py:58-96`)
NORMS_EVERY = 100


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:  # optional: used where the tensorboard package is installed
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def log(self, step: int, values: Dict[str, Any], prefix: str = "train"):
        rec = {"step": step, "time": time.time(), "prefix": prefix}
        rec.update({k: float(v) for k, v in values.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def log_param_norms(self, step: int, module: nn.Module, grad_norm=None):
        """The global norms of ``module``'s parameters and, as the trainer
        computed it before clipping, of their gradients (``grad_norm``, a
        device scalar), every ``NORMS_EVERY`` steps."""
        if step % NORMS_EVERY != 0:
            return
        vals = {"param_global_norm": float(_global_norm(module.parameters()))}
        if grad_norm is not None:
            vals["grad_global_norm"] = float(grad_norm)
        self.log(step, vals, prefix="norms")

    def log_param_histograms(self, step: int, module: nn.Module):
        """Per-epoch per-parameter norms (reference
        `src/utils/tensorboard.py:98-122`, ignite's WeightsHistHandler at
        EPOCH_COMPLETED); the full histograms go to TensorBoard when it is
        there."""
        named = [(name.replace(".", "/"), p.detach()) for name, p in module.named_parameters()]
        norms = torch.stack([torch.linalg.vector_norm(p.float()) for _, p in named]).cpu()
        vals = {f"weights_norm/{name}": float(n) for (name, _), n in zip(named, norms)}
        if self._tb is not None:
            for name, p in named:
                self._tb.add_histogram(f"weights_norm/{name}", p.float().cpu().numpy(), step)
        self.log(step, vals, prefix="hist")

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


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
