"""Ancestral sampling engine: couples the nonisotropic process with the
denoiser.

Port of the plain branch of ``GaussianDiffusion.p_sample_loop`` in
``skeletondiffusion_tpu/diffusion/engine.py`` (`:250-287`; reference
`src/core/diffusion/base.py:324-390`) for the configuration every shipped
config uses: conditioned, pred_x0 objective, x̂₀ clipped to [−1, 1], identity
output activation.  The latent is carried node-major ``[N, B, D]``, the
denoiser's layout, and each reverse step after the denoiser is one call of
the posterior-step kernel wrapper (``ops/kernels/posterior_step.py``) with
the step's ``[N, 3N]`` table.  Randomness comes only from an explicit
``torch.Generator`` or from injected noise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.denoiser import Denoiser
from ..ops.kernels import posterior_step as posterior_kernel
from .process import NonisotropicProcess


class GaussianDiffusion:
    """``channels`` is the number of nodes N and ``seq_length`` the latent
    size (the reference's naming, `base.py:94-99`)."""

    def __init__(
        self,
        process: NonisotropicProcess,
        denoiser: Denoiser,
        *,
        channels: int,
        latent_size: int = 96,
    ):
        if process.objective != "pred_x0":
            raise NotImplementedError(f"objective={process.objective}: the port samples pred_x0")
        self.process = process
        self.denoiser = denoiser
        self.channels = channels
        self.seq_length = latent_size
        self.num_timesteps = process.num_timesteps
        self.step_tables = process.posterior_step_tables()  # [T, N, 3N]

    @property
    def device(self) -> torch.device:
        return self.step_tables.device

    def to(self, device: DeviceLike) -> "GaussianDiffusion":
        device = resolve_device(device)
        self.process = self.process.to(device)
        self.denoiser.to(device)
        self.step_tables = self.step_tables.to(device)
        return self

    @torch.no_grad()
    def sample(
        self,
        x_cond: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ancestral sampling t = T-1 … 0 of one latent per row of ``x_cond``
        [B,N,D] → (x_0 samples [B,N,D], start noise [B,N,D]); reference
        `base.py:324-390,439-443`.

        ``start_noise`` [B,N,D] and ``step_noise`` [B,T-1,N,D] are optional
        injected noise; step t>0 uses ``step_noise[:, (T-1)-t]`` and t=0 no
        noise (`engine.py:268-281`).  Noise that is not injected is drawn
        from ``generator``.
        """
        B, N, D = x_cond.shape[0], self.channels, self.seq_length
        T = self.num_timesteps
        if (start_noise is None or (step_noise is None and T > 1)) and generator is None:
            raise ValueError("pass a torch.Generator or inject start_noise and step_noise")
        device = self.device

        def draw():
            return torch.randn((N, B, D), generator=generator, device=device)

        u_cond = self.denoiser.cond_embedding(x_cond)
        img = draw() if start_noise is None else start_noise.transpose(0, 1).contiguous()
        start = img.transpose(0, 1)
        no_noise = torch.zeros_like(img)
        for t in range(T - 1, -1, -1):
            x0 = self.denoiser(img, t, u_cond)
            if t == 0:
                noise = no_noise  # the table's noise block is zero at t=0 as well
            elif step_noise is not None:
                noise = step_noise[:, T - 1 - t].transpose(0, 1).contiguous()
            else:
                noise = draw()
            img = posterior_kernel.posterior_step(x0.contiguous(), img, noise,
                                                  self.step_tables[t])
        return img.transpose(0, 1), start
