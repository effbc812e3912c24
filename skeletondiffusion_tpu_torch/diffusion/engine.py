"""Ancestral sampling engine: couples the nonisotropic process with the
denoiser.

Port of the plain branch of ``GaussianDiffusion.p_sample_loop`` in
``skeletondiffusion_tpu/diffusion/engine.py`` (`:250-287`; reference
`src/core/diffusion/base.py:324-390`) and of its training losses
(``feed_model``, ``p_losses``, ``loss``; `:80-186`, reference
`base.py:243-307`) for the configuration every shipped config uses:
conditioned, pred_x0 objective, x̂₀ clipped to [−1, 1] when sampling,
identity output activation.  The latent is carried node-major ``[N, B, D]``, the
denoiser's layout, and each reverse step after the denoiser is one call of
the posterior-step kernel wrapper (``ops/kernels/posterior_step.py``) with
the step's ``[N, 3N]`` table.  Randomness comes only from an explicit
``torch.Generator`` or from injected noise.

The fused branch (`engine.py:218-248`): with ``fused`` set to the operands of
``ops.kernels.denoiser_fused.prep_fused_denoiser``, each step runs the
denoiser as its kernel chain and hands its x̂₀ to the posterior-step kernel
in the compute dtype (bf16); the latent stays float32.  The port takes that
branch with injected noise too (the JAX package falls back to its plain scan
there): the two branches differ only in the functions they call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models.denoiser import Denoiser
from ..ops.kernels import posterior_step as posterior_kernel
from ..ops.kernels.denoiser_fused import fused_denoiser_core_nm, prep_fused_denoiser
from .process import NonisotropicProcess, Timestep


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
        remat: bool = False,
    ):
        if process.objective != "pred_x0":
            raise NotImplementedError(f"objective={process.objective}: the port samples pred_x0")
        self.process = process
        self.denoiser = denoiser
        self.channels = channels
        self.seq_length = latent_size
        self.num_timesteps = process.num_timesteps
        self.step_tables = process.posterior_step_tables()  # [T, N, 3N]
        self.fused: Optional[dict] = None  # prep_fused_denoiser operands, on the device
        self.remat = remat  # recompute the training forward in the backward

    @property
    def device(self) -> torch.device:
        return self.step_tables.device

    def to(self, device: DeviceLike) -> "GaussianDiffusion":
        device = resolve_device(device)
        self.process = self.process.to(device)
        self.denoiser.to(device)
        self.step_tables = self.step_tables.to(device)
        if self.fused is not None:
            self.fused = prep_fused_denoiser(self.denoiser)
        return self

    # ---- training ------------------------------------------------------------
    def feed_model(self, x: torch.Tensor, t: Timestep, x_cond: torch.Tensor) -> torch.Tensor:
        """The denoiser on latents x [B,N,D] at step ``t`` (an int or [B])
        conditioned on x_cond [B,N,D] → [B,N,D] float32; reference
        `base.py:243-255`.  With ``remat`` and gradients enabled the
        denoiser's activations are recomputed in the backward instead of kept
        (``torch.utils.checkpoint``; JAX: ``jax.checkpoint``)."""
        u_cond = self.denoiser.cond_embedding(x_cond)
        if self.remat and torch.is_grad_enabled():
            out = checkpoint(self.denoiser, x.transpose(0, 1), t, u_cond, use_reentrant=False)
        else:
            out = self.denoiser(x.transpose(0, 1), t, u_cond)
        return out.transpose(0, 1)

    def p_losses(
        self,
        x_start: torch.Tensor,
        t: torch.Tensor,
        x_cond: torch.Tensor,
        n_train_samples: int = 1,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sample losses ``(loss [b·k], loss_weight [b], model_out
        [b·k,N,D])``; reference `base.py:262-300`.  With ``n_train_samples``
        k > 1 the batch is fanned out k-fold in the repeat_interleave layout
        (sample j of item i is row i·k + j).  ``noise`` [b·k,N,D] is injected
        white noise, else drawn from ``generator``."""
        loss_weight = self.process.loss_weight[t]
        if n_train_samples > 1:
            x_start, t, x_cond = (v.repeat_interleave(n_train_samples, dim=0)
                                  for v in (x_start, t, x_cond))
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x = self.process.q_sample(x_start, t, noise)
        model_out = self.feed_model(x, t, x_cond)
        loss = self.process.loss_terms(model_out, x_start, t)  # pred_x0: the target is x₀
        return loss.reshape(loss.shape[0], -1).mean(dim=-1), loss_weight, model_out

    def loss(
        self,
        x: torch.Tensor,
        x_cond: torch.Tensor,
        n_train_samples: int = 1,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``p_losses`` at t ~ U[0, T) per item (reference `base.py:302-307`);
        ``t`` [b] and ``noise`` are injected, or drawn from ``generator`` in
        that order."""
        if x.shape[-1] != self.seq_length:
            raise ValueError(f"latents of width {x.shape[-1]}, expected {self.seq_length}")
        if t is None:
            t = torch.randint(0, self.num_timesteps, (x.shape[0],), generator=generator,
                              device=x.device)
        return self.p_losses(x, t, x_cond, n_train_samples=n_train_samples, noise=noise,
                             generator=generator)

    # ---- sampling ----------------------------------------------------------------
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
            if self.fused is not None:
                x0 = fused_denoiser_core_nm(self.denoiser, img, t, u_cond, self.fused)
            else:
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
