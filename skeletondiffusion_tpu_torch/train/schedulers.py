"""LR + curriculum schedules (host-side pure functions of the epoch /
iteration counters; the trainers set the resulting scalars per step).

A copy of ``skeletondiffusion_tpu/train/schedulers.py`` (numpy only).
Mirrors reference `src/core/utils/scheduler.py:5-50`
(``ExponentialLRSchedulerWarmup``, stepped at EPOCH_STARTED) and the ignite
``CosineAnnealingScheduler`` driving the autoencoder's prediction-horizon
curriculum (`src/core/trainer.py:37-76`).
"""
from __future__ import annotations

import math

import numpy as np


class ExponentialLRSchedulerWarmup:
    """Flat warmup for ``warmup_duration`` epochs, then ×``gamma_decay``
    every ``update_every`` epochs, floored (sticky) at ``min_lr``."""

    def __init__(
        self,
        lr: float,
        warmup_duration: int = 200,
        update_every: int = 1,
        min_lr: float = 0.0,
        gamma_decay: float = 0.98,
        **kwargs,
    ):
        assert min_lr is None or min_lr <= lr
        self.lr = lr
        self.warmup_duration = warmup_duration
        self.update_every = update_every
        self.min_lr = min_lr
        self.gamma_decay = gamma_decay
        self._current = lr
        self._min_reached = False

    def step(self, epoch: int) -> float:
        """Advance at epoch start (1-indexed epochs as in ignite) and return
        the lr for this epoch."""
        if epoch < self.warmup_duration:
            return self._current
        if not self._min_reached and self.min_lr is not None and self._current <= self.min_lr:
            self._current = self.min_lr
            self._min_reached = True
        if epoch % self.update_every == 0 and not self._min_reached:
            self._current *= self.gamma_decay
        return self._current

    def state_dict(self):
        return {"current": self._current, "min_reached": self._min_reached}

    def load_state_dict(self, state):
        self._current = float(state["current"])
        self._min_reached = bool(state["min_reached"])


def make_lr_scheduler(lr_scheduler_type: str, lr: float, **kwargs) -> ExponentialLRSchedulerWarmup:
    """Reference `scheduler.py:42-43` name-based factory."""
    assert lr_scheduler_type == "ExponentialLRSchedulerWarmup", lr_scheduler_type
    return ExponentialLRSchedulerWarmup(lr=lr, **kwargs)


def cosine_annealing_factor(iteration: int, cycle_size: int) -> float:
    """ignite CosineAnnealingScheduler value for start=1, end=0,
    start_value_mult=0: first cycle ½(1+cos(π·t/c)), 0 afterwards
    (`trainer.py:44-53`)."""
    if iteration >= cycle_size:
        return 0.0
    return 0.5 * (1.0 + math.cos(math.pi * iteration / cycle_size))


class CurriculumPH:
    """Prediction-horizon curriculum for autoencoder training; reference
    `src/core/trainer.py:37-76` (``get_random_ph``)."""

    def __init__(
        self,
        prediction_horizon_train: int,
        prediction_horizon_train_min: int = 10,
        prediction_horizon_train_min_from_epoch: int = 200,
        curriculum_it: int = 10,
        random_prediction_horizon: bool = True,
        iter_per_epoch: int = 1,
        seed: int = 0,
    ):
        self.ph_train = prediction_horizon_train
        self.ph_min_final = prediction_horizon_train_min
        self.ph_min_from_epoch = prediction_horizon_train_min_from_epoch
        self.curriculum_it = curriculum_it or 0
        self.random_ph = random_prediction_horizon
        self.iter_per_epoch = iter_per_epoch
        self._rng = np.random.RandomState(seed)
        if self.ph_min_from_epoch > 0:
            self._ph_min_ramp = np.linspace(
                1, self.ph_min_final, self.ph_min_from_epoch * iter_per_epoch
            ).astype(int)
        else:
            self._ph_min_ramp = None

    def __call__(self, epoch: int, iteration: int) -> int:
        if epoch >= self.ph_min_from_epoch or self._ph_min_ramp is None:
            ph_min = self.ph_min_final
        else:
            ph_min = int(self._ph_min_ramp[min(iteration, len(self._ph_min_ramp) - 1)])
        factor = (
            cosine_annealing_factor(iteration, self.curriculum_it * self.iter_per_epoch)
            if self.curriculum_it > 0
            else 0.0
        )
        ph = max(int(np.rint((1.0 - factor) * self.ph_train)), ph_min)
        if ph > ph_min and self.random_ph:
            ph = int(self._rng.randint(ph_min, ph))
        return ph

    def state_dict(self):
        """Checkpointable curriculum RNG (MT19937 state as JSON-safe lists)."""
        name, keys, pos, has_gauss, cached = self._rng.get_state()
        return {"state": [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]}

    def load_state_dict(self, state):
        name, keys, pos, has_gauss, cached = state["state"]
        self._rng.set_state((name, np.asarray(keys, dtype=np.uint32), int(pos),
                             int(has_gauss), float(cached)))
