"""Diffusion engine: couples a process (isotropic or nonisotropic) with the
denoiser, for training losses and for ancestral, DDIM and interpolating
sampling.

Port of ``GaussianDiffusion`` in ``skeletondiffusion_tpu/diffusion/engine.py``
(reference `src/core/diffusion/base.py:219-443`): ``feed_model``,
``model_predictions``, ``p_losses`` and ``loss`` (`:80-186`), the ancestral
``p_sample_loop`` (`:188-287`), ``ddim_sample`` (`:289-382`), the ``sample``
dispatch (`:384-402`) and ``p_sample_loop_interpolating`` (`:404-456`), for
the objectives pred_x0, pred_noise and pred_v, with or without conditioning
and with identity or tanh output activation.  Sampling clips x̂₀ to [−1, 1].

The latent is carried node-major ``[N, B, D]``, the denoiser's layout.  Each
ancestral step after the denoiser is one call of the posterior-step kernel
wrapper (``ops/kernels/posterior_step.py``) with the step's ``[N, 3N]`` table
(the isotropic process's tables are diagonal): x̂₀ goes in unclipped and the
kernel clips it.  DDIM's update is plain element-wise PyTorch, as it is plain
XLA in the JAX package.  Randomness comes only from an explicit
``torch.Generator`` or from injected noise.

The fused branch (`engine.py:218-248`, `eval_pipeline.py:94-108`): with
``fused`` set to the operands of
``ops.kernels.denoiser_fused.prep_fused_denoiser`` (the predictor sets it for
a bf16, conditioned, self-conditioning-free denoiser with attention), every
sampler but the interpolating one runs the denoiser as its kernel chain.  For
pred_x0 with identity activation its bf16 x̂₀ goes to the posterior-step
kernel as it is; otherwise the output is widened to float32 first, as the JAX
package's ``fused_denoiser_apply`` returns it.  The latent stays float32.
The port takes the fused branch with injected noise too (the JAX package falls
back to its plain scan there): the two branches differ only in the functions
they call.
"""
from __future__ import annotations

import copy
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import sampler_noise
from ..device import DeviceLike, resolve_device
from ..models.denoiser import Denoiser
from ..ops.kernels import posterior_step as posterior_kernel
from ..ops.kernels.build import without_grad
from ..ops.kernels.denoiser_fused import (fused_denoiser_core_nm, pad_condition,
                                         prep_fused_denoiser)
from .process import IsotropicProcess, NonisotropicProcess, Timestep

Process = Union[IsotropicProcess, NonisotropicProcess]
OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


def _swap(x: torch.Tensor) -> torch.Tensor:
    """[N, B, D] ⇄ [B, N, D] (a view)."""
    return x.transpose(0, 1)


def posterior_update_plain(process: Process, x0: torch.Tensor, xt: torch.Tensor,
                           noise: torch.Tensor, t: int) -> torch.Tensor:
    """The step the posterior-step kernel takes, as the JAX engine writes it
    (`engine.py:268-282`): clip x̂₀, ``q_posterior``, then
    ``combine_mean_var_noise`` with the noise zeroed at t=0; node-major
    latents [N, B, D] in and out."""
    x0 = torch.clamp(x0.float(), -1.0, 1.0)
    mean, _, log_var = process.q_posterior(_swap(x0), _swap(xt), t)
    noise = _swap(noise) if t > 0 else torch.zeros_like(mean)
    return _swap(process.combine_mean_var_noise(mean, log_var, noise))


class GaussianDiffusion:
    """``channels`` is the number of nodes N and ``seq_length`` the latent
    size (the reference's naming, `base.py:94-99`).  Whether the model is
    conditioned is the denoiser's (``cond_dim > 0``)."""

    def __init__(
        self,
        process: Process,
        denoiser: Denoiser,
        *,
        channels: int,
        latent_size: int = 96,
        diffusion_activation: str = "identity",
        sampling_timesteps: Optional[int] = None,
        ddim_sampling_eta: float = 0.0,
        remat: bool = False,
    ):
        if process.objective not in OBJECTIVES:
            raise ValueError(f"objective={process.objective!r}")
        if diffusion_activation not in ("identity", "tanh"):
            raise ValueError(f"diffusion_activation={diffusion_activation!r}")
        self.process = process
        self.denoiser = denoiser
        self.channels = channels
        self.seq_length = latent_size
        self.activation = diffusion_activation
        self.num_timesteps = process.num_timesteps
        self.objective = process.objective
        self.sampling_timesteps = sampling_timesteps or process.num_timesteps
        if self.sampling_timesteps > self.num_timesteps:
            raise ValueError(f"sampling_timesteps={self.sampling_timesteps} exceeds "
                             f"diffusion_timesteps={self.num_timesteps}")
        self.is_ddim_sampling = self.sampling_timesteps < self.num_timesteps
        if self.is_ddim_sampling and not isinstance(process, IsotropicProcess):
            raise NotImplementedError("DDIM sampling (sampling_timesteps below the step count) "
                                      "requires the isotropic process, as in the JAX package")
        self.ddim_sampling_eta = ddim_sampling_eta
        self.step_tables = process.posterior_step_tables()  # [T, N, 3N]
        self.fused: Optional[dict] = None  # prep_fused_denoiser operands, on the device
        self.remat = remat  # recompute the training forward in the backward

    @property
    def condition(self) -> bool:
        return self.denoiser.cond_dim > 0

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

    def with_denoiser(self, denoiser: Denoiser) -> "GaussianDiffusion":
        """The same engine (process, activation, sampler) around another
        denoiser of the same configuration, e.g. the EMA copy; without fused
        operands."""
        out = copy.copy(self)
        out.denoiser, out.fused = denoiser, None
        return out

    # ---- the network ---------------------------------------------------------
    def embed_condition(self, x_cond: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The denoiser's hoisted conditioning product of x_cond [B,N,D]
        (``Denoiser.cond_embedding``), or None for an unconditioned model."""
        if not self.condition:
            if x_cond is not None:
                raise ValueError("x_cond given to an unconditioned model")
            return None
        if x_cond is None:
            raise ValueError("the conditioned model needs x_cond")
        return self.denoiser.cond_embedding(x_cond)

    def chain_condition(self, x_cond: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``embed_condition`` for a sampling call: where the kernel chain is
        prepared, padded to its width once (``denoiser_fused.pad_condition``),
        not at every step."""
        u_cond = self.embed_condition(x_cond)
        if self.fused is None or u_cond is None:
            return u_cond
        return pad_condition(self.fused, u_cond)

    def _activate(self, out: torch.Tensor) -> torch.Tensor:
        return torch.tanh(out) if self.activation == "tanh" else out

    def feed_model(self, x: torch.Tensor, t: Timestep,
                   x_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoiser on latents x [B,N,D] at step ``t`` (an int or [B]),
        conditioned on x_cond [B,N,D] when the model is, then the output
        activation → [B,N,D] float32; reference `base.py:243-255`.  With
        ``remat`` and gradients enabled the denoiser's activations are
        recomputed in the backward instead of kept
        (``torch.utils.checkpoint``; JAX: ``jax.checkpoint``)."""
        u_cond = self.embed_condition(x_cond)
        if self.remat and torch.is_grad_enabled():
            out = checkpoint(self.denoiser, _swap(x), t, u_cond, use_reentrant=False)
        else:
            out = self.denoiser(_swap(x), t, u_cond)
        return self._activate(_swap(out))

    def model_output(self, img: torch.Tensor, t: int, u_cond: Optional[torch.Tensor],
                     fused: bool = True) -> torch.Tensor:
        """The activated denoiser output at one step for node-major latents
        [N,B,D], on the kernel chain where it is prepared (``fused``), else
        the plain module (float32).  The chain's pred_x0 identity output
        stays in its compute dtype."""
        if fused and self.fused is not None:
            out = fused_denoiser_core_nm(self.denoiser, img, t, u_cond, self.fused)
            if self.objective == "pred_x0" and self.activation == "identity":
                return out  # the bf16 x̂₀ goes to the posterior-step kernel as it is
            return self._activate(out.float())
        return self._activate(self.denoiser(img, t, u_cond))

    def start_from_output(self, img: torch.Tensor, t: int, out: torch.Tensor) -> torch.Tensor:
        """x̂₀ (unclipped) from the model output of one step; node-major."""
        if self.objective == "pred_x0":
            return out
        convert = (self.process.predict_start_from_noise if self.objective == "pred_noise"
                   else self.process.predict_start_from_v)
        return _swap(convert(_swap(img), t, _swap(out)))

    def model_predictions(self, img: torch.Tensor, t: int, u_cond: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(noise, x̂₀ clipped) at one step, node-major; the noise is
        re-derived from the clipped x̂₀ (`engine.py:90-114`)."""
        x0 = torch.clamp(self.start_from_output(img, t, self.model_output(img, t, u_cond))
                         .float(), -1.0, 1.0)
        noise = _swap(self.process.predict_noise_from_start(_swap(img), t, _swap(x0)))
        return noise, x0

    def posterior_step(self, x0: torch.Tensor, img: torch.Tensor, noise: torch.Tensor,
                       t: int) -> torch.Tensor:
        """x_{t-1} from x̂₀ (clipped here), x_t and the step's noise, all
        node-major, on the posterior-step kernel.  A bf16 x̂₀ whose B·D is
        not a multiple of 8 (the bf16 entry's rows are whole 16 bytes; a
        latent off the 8-granule at an odd row count) is widened, exactly,
        for the fp32 entry."""
        if x0.dtype == torch.bfloat16 and x0[0].numel() % 8:
            x0 = x0.float()
        return posterior_kernel.posterior_step(x0.contiguous(), img, noise, self.step_tables[t])

    # ---- training ------------------------------------------------------------
    def p_losses(
        self,
        x_start: torch.Tensor,
        t: torch.Tensor,
        x_cond: Optional[torch.Tensor] = None,
        n_train_samples: int = 1,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sample losses ``(loss [b·k], loss_weight [b], model_out
        [b·k,N,D])``; reference `base.py:262-300`.  With ``n_train_samples``
        k > 1 the batch is fanned out k-fold in the repeat_interleave layout
        (sample j of item i is row i·k + j).  ``noise`` [b·k,N,D] is injected
        white noise, else drawn from ``generator``.  The target is the noise
        (pred_noise), x₀ (pred_x0) or v (pred_v)."""
        loss_weight = self.process.loss_weight[t]
        if n_train_samples > 1:
            x_start, t = (v.repeat_interleave(n_train_samples, dim=0) for v in (x_start, t))
            if x_cond is not None:
                x_cond = x_cond.repeat_interleave(n_train_samples, dim=0)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x = self.process.q_sample(x_start, t, noise)
        model_out = self.feed_model(x, t, x_cond)
        target = {"pred_noise": lambda: noise, "pred_x0": lambda: x_start,
                  "pred_v": lambda: self.process.predict_v(x_start, t, noise)}[self.objective]()
        loss = self.process.loss_terms(model_out, target, t)
        return loss.reshape(loss.shape[0], -1).mean(dim=-1), loss_weight, model_out

    def loss(
        self,
        x: torch.Tensor,
        x_cond: Optional[torch.Tensor] = None,
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
    @property
    def noise_draws(self) -> int:
        """Step-noise draws of one ``sample`` call after its start latent:
        T−1 ancestral steps; DDIM's step pairs but the last with η > 0, none
        with η = 0."""
        if self.is_ddim_sampling:
            return self.sampling_timesteps - 1 if self.ddim_sampling_eta else 0
        return self.num_timesteps - 1

    def draw_noise(self, generator: torch.Generator, rows: int) -> dict:
        """``sample``'s noise for ``rows`` rows drawn from ``generator`` in the
        sampler's own order (``sampler_noise.draw``), as ``start_noise`` and
        ``step_noise`` to inject."""
        return sampler_noise.draw(generator, self.channels, rows, self.seq_length,
                                  self.noise_draws, self.device)

    def _start(self, batch: int, generator, start_noise) -> torch.Tensor:
        """The node-major start latent: ``start_noise`` [B,N,D] or drawn."""
        if start_noise is not None:
            return _swap(start_noise).contiguous()
        if generator is None:
            raise ValueError("pass a torch.Generator or inject start_noise")
        return torch.randn((self.channels, batch, self.seq_length), generator=generator,
                           device=self.device)

    def _step_noise(self, img: torch.Tensor, generator, step_noise, i: int) -> torch.Tensor:
        """Node-major noise of step row ``i``: ``step_noise[:, i]`` or drawn."""
        if step_noise is not None:
            return _swap(step_noise[:, i]).contiguous()
        if generator is None:
            raise ValueError("pass a torch.Generator or inject step_noise")
        return torch.randn(img.shape, generator=generator, device=img.device)

    @without_grad
    def sample(
        self,
        x_cond: Optional[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        batch_size: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One latent per row of ``x_cond`` [B,N,D] (``batch_size`` rows
        without conditioning) → (x_0 samples [B,N,D], start noise [B,N,D]);
        DDIM when ``sampling_timesteps`` is below the step count, else
        ancestral (reference `base.py:439-443`)."""
        sampler = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return sampler(x_cond, generator, start_noise, step_noise, batch_size)

    def _batch(self, x_cond, start_noise, batch_size) -> int:
        for v in (x_cond, start_noise):
            if v is not None:
                return v.shape[0]
        if batch_size is None:
            raise ValueError("an unconditioned model samples batch_size rows")
        return batch_size

    @without_grad
    def p_sample_loop(
        self,
        x_cond: Optional[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        batch_size: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ancestral sampling t = T-1 … 0; reference `base.py:324-390`.

        ``start_noise`` [B,N,D] and ``step_noise`` [B,T-1,N,D] are optional
        injected noise; step t>0 uses ``step_noise[:, (T-1)-t]`` and t=0 no
        noise (`engine.py:268-281`).  Noise that is not injected is drawn
        from ``generator``.
        """
        T = self.num_timesteps
        u_cond = self.chain_condition(x_cond)
        img = self._start(self._batch(x_cond, start_noise, batch_size), generator, start_noise)
        start = _swap(img)
        no_noise = torch.zeros_like(img)
        for t in range(T - 1, -1, -1):
            x0 = self.start_from_output(img, t, self.model_output(img, t, u_cond))
            # the table's noise block is zero at t=0 as well
            noise = no_noise if t == 0 else self._step_noise(img, generator, step_noise,
                                                             T - 1 - t)
            img = self.posterior_step(x0, img, noise, t)
        return _swap(img), start

    def ddim_time_pairs(self) -> List[Tuple[int, int]]:
        """(time, next time) of each DDIM step, the last pair's next time −1
        (`engine.py:318-320`)."""
        times = np.linspace(-1, self.num_timesteps - 1, self.sampling_timesteps + 1)
        times = list(reversed(times.astype(int).tolist()))
        return list(zip(times[:-1], times[1:]))

    @without_grad
    def ddim_sample(
        self,
        x_cond: Optional[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        batch_size: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """DDIM over ``sampling_timesteps`` steps, isotropic process only
        (`engine.py:289-382`).  ``step_noise`` [B, ≥S-1, N, D]: row i is the
        noise of step pair i; the final pair returns x̂₀ and takes no noise.
        With η = 0 no noise is drawn."""
        if not isinstance(self.process, IsotropicProcess):
            raise NotImplementedError("DDIM requires the isotropic process")
        u_cond = self.chain_condition(x_cond)
        img = self._start(self._batch(x_cond, start_noise, batch_size), generator, start_noise)
        start = _swap(img)
        acp, eta = self.process.alphas_cumprod, self.ddim_sampling_eta
        pairs = self.ddim_time_pairs()
        for i, (time, time_next) in enumerate(pairs[:-1]):
            pred_noise, x0 = self.model_predictions(img, time, u_cond)
            alpha, alpha_next = acp[time], acp[time_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt(1 - alpha_next - sigma ** 2)
            img = x0 * torch.sqrt(alpha_next) + c * pred_noise
            if eta:
                img = img + sigma * self._step_noise(img, generator, step_noise, i)
        _, x0 = self.model_predictions(img, pairs[-1][0], u_cond)
        return _swap(x0), start

    @torch.no_grad()
    def p_sample_loop_interpolating(
        self,
        x_cond: Optional[torch.Tensor],
        noise2interpolate: torch.Tensor,
        interpolate_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        generator: Optional[torch.Generator] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        batch_size: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ancestral sampling whose step noise is ``interpolate_fn`` of the
        step's own noise and of ``noise2interpolate`` [B,T-1,N,D], each scaled
        by the posterior σ (`engine.py:404-456`; the reference's latent-space
        interpolation, `base.py:335-338`); both indexed [:, T-1-t].  The step's
        own noise is ``step_noise`` [B,T-1,N,D] or drawn from ``generator``.
        The plain denoiser and the plain posterior, as in the JAX package;
        ``interpolate_fn`` takes and returns [B,N,D]."""
        T = self.num_timesteps
        u_cond = self.embed_condition(x_cond)
        img = self._start(self._batch(x_cond, start_noise, batch_size), generator, start_noise)
        start = _swap(img)
        for t in range(T - 1, -1, -1):
            out = self.model_output(img, t, u_cond, fused=False)
            x0 = torch.clamp(self.start_from_output(img, t, out), -1.0, 1.0)
            mean, _, log_var = self.process.q_posterior(_swap(x0), _swap(img), t)
            if t > 0:
                noise = _swap(self._step_noise(img, generator, step_noise, T - 1 - t))
                zero = torch.zeros_like(mean)
                scaled = [self.process.combine_mean_var_noise(zero, log_var, n)
                          for n in (noise, noise2interpolate[:, T - 1 - t])]
                mean = mean + interpolate_fn(*scaled)
            img = _swap(mean).contiguous()
        return _swap(img), start
