"""The sampler's noise drawn from a ``torch.Generator`` in the order the
live sampler draws it, as tensors to inject.

``GaussianDiffusion.p_sample_loop`` draws its start latent, node-major
``[N, rows, D]``, then one ``[N, rows, D]`` noise a step for steps T−1 … 1
(DDIM with η > 0: one a step pair but the last).  ``draw`` makes the same
draws in the same order and returns them in the layout the sampler takes
injected (``start_noise`` [rows, N, D], ``step_noise`` [rows, draws, N, D]):
the values it then reads are the ones it would have drawn.  The serving
artifact (``serving.py``), which captures no generator, and the data axis
(each rank draws the global batch's noise and keeps its rows) draw this
way.  Imports torch only.
"""
from __future__ import annotations

from typing import Dict

import torch


def draw(generator: torch.Generator, nodes: int, rows: int, latent: int, draws: int,
         device) -> Dict[str, torch.Tensor]:
    """{"start_noise": [rows, N, D], "step_noise": [rows, draws, N, D]}."""
    start = torch.randn((nodes, rows, latent), generator=generator, device=device)
    steps = [torch.randn((nodes, rows, latent), generator=generator, device=device)
             for _ in range(draws)]
    step_noise = (torch.stack([s.transpose(0, 1) for s in steps], dim=1) if steps
                  else torch.zeros((rows, 0, nodes, latent), device=device))
    return {"start_noise": start.transpose(0, 1).contiguous(), "step_noise": step_noise}


def rows_of(noise: Dict[str, torch.Tensor], lo: int, hi: int) -> Dict[str, torch.Tensor]:
    """Rows [lo, hi) of each injected noise tensor."""
    return {k: v[lo:hi].contiguous() for k, v in noise.items()}
