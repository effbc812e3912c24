"""Determinism: the seed, and generators derived from (seed, epoch,
iteration).

Port of ``skeletondiffusion_tpu/utils/reproducibility.py``, whose
``epoch_key`` and ``iteration_key`` fold the epoch and the iteration into
the root key.  Here each (seed, epoch, iteration, stream) tuple seeds its own
``torch.Generator`` through numpy's ``SeedSequence``: a step's draws depend
on nothing but its position, so a resumed run repeats the uninterrupted one
without carrying generator state, and two streams of one step (the
augmentation's and the train step's) are independent.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def set_seed(seed: int) -> int:
    """Seed numpy's and torch's global generators (host-side helpers that
    draw from them); returns ``seed``, the root of every derived
    generator."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed that is a fixed function of ``(seed, *path)``."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def epoch_generator(seed: int, epoch: int, device: DeviceLike = "cuda") -> torch.Generator:
    """The generator of one epoch (the reference reseeds with seed + epoch
    at every EPOCH_STARTED, `train_diffusion.py:70-72`)."""
    gen = torch.Generator(device=resolve_device(device))
    return gen.manual_seed(derived_seed(seed, epoch))


def iteration_generator(seed: int, epoch: int, iteration: int, stream: int = 0,
                        device: DeviceLike = "cuda") -> torch.Generator:
    """The generator of stream ``stream`` of one training step; the loops
    take stream 0 for the augmentations and 1 for the train step."""
    gen = torch.Generator(device=resolve_device(device))
    return gen.manual_seed(derived_seed(seed, epoch, iteration, stream))
