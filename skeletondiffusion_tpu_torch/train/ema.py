"""Exponential moving average of a module's parameters with the
``ema_pytorch.EMA`` schedule the reference trains with
(`src/core/trainer.py:157-160`).

Port of ``skeletondiffusion_tpu/train/ema.py``: the EMA is a second module of
the same class (``EMAState.module``, a deep copy), so the sampler runs on it
as on the live one.  Its parameters are updated in place, which bumps their
version counters: the kernels' packed-weight caches
(``ops/kernels/node_mix_sm90.cached_pack``) key on them.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class EMAState:
    module: nn.Module   # the EMA weights, a module of the live one's class
    step: int = 0       # update() calls so far

    def state_dict(self) -> dict:
        return {"module": self.module.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.module.load_state_dict(state["module"])
        self.step = int(state["step"])


def ema_init(module: nn.Module) -> EMAState:
    """A frozen copy of ``module`` (no gradients), at step 0."""
    ema = copy.deepcopy(module)
    ema.requires_grad_(False)
    return EMAState(module=ema)


def ema_decay(step: int, *, beta: float = 0.995, update_every: int = 10,
              update_after_step: int = 100, inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
              min_value: float = 0.0) -> float:
    """The EMA weight of update call ``step`` (float32, as the JAX package
    computes it): 1 (no-op) off the ``update_every`` steps, 0 (a hard copy)
    up to ``update_after_step``, then clamp(1 − (1 + e/inv_gamma)^−power,
    min_value, beta) with e = step − update_after_step − 1 (a copy while
    e ≤ 0)."""
    f32 = np.float32
    epoch = max(f32(step) - f32(update_after_step) - f32(1), f32(0))
    value = f32(1) - (f32(1) + epoch / f32(inv_gamma)) ** f32(-power)
    decay = f32(0) if epoch <= 0 else np.clip(value, f32(min_value), f32(beta))
    if step % update_every != 0:
        return 1.0
    return 0.0 if step <= update_after_step else float(decay)


@torch.no_grad()
def ema_update(state: EMAState, module: nn.Module, **schedule) -> EMAState:
    """One ``EMA.update()`` call: every EMA parameter ← d·ema + (1 − d)·live
    with d = ``ema_decay(state.step, **schedule)`` (in place; nothing moves
    when d = 1, a copy when d = 0)."""
    decay = ema_decay(state.step, **schedule)
    if decay != 1.0:
        for e, p in zip(state.module.parameters(), module.parameters()):
            if decay == 0.0:
                e.copy_(p)
            else:
                e.mul_(decay).add_(p * (1.0 - decay))
    state.step += 1
    return state
