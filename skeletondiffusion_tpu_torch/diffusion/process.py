"""The nonisotropic latent diffusion process as a dataclass of float32 tables.

Port of ``NonisotropicProcess`` from ``skeletondiffusion_tpu/diffusion/process.py``
(reference `src/core/diffusion/nonisotropic.py:72-210`): every per-timestep
coefficient is precomputed host-side in float64 numpy and stored as a float32
tensor on the target device.  The reverse process (the posterior
mean/variance, the noise combination and the ``[T, N, 3N]`` step tables that
the posterior-step kernel consumes) and the training half (``q_sample``, the
x₀/noise conversions and the Mahalanobis loss terms) take a timestep shared
by the batch (an int) or one per item (a ``[B]`` tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .schedules import compute_covariance_schedules, make_beta_schedule

Timestep = Union[int, torch.Tensor]  # one step for the batch, or [B] per item


@dataclasses.dataclass
class NonisotropicProcess:
    """Correlated-noise DDPM over the skeleton graph.  Field meanings and
    shapes are those of the JAX ``NonisotropicProcess``."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    Lambda_N: torch.Tensor                                  # [N]
    Sigma_N: torch.Tensor                                   # [N,N]
    U: torch.Tensor                                         # [N,N]
    Lambda_t: torch.Tensor                                  # [T,N]
    Umm_sqrt_Lambda_bar_t: torch.Tensor                     # [T,N,N]
    Umm_sqrt_Lambda_bar_t_sqrt_recip_alphas_cumprod: torch.Tensor
    inv_sqrt_Lambda_bar_mmUt: torch.Tensor
    inv_sqrt_Lambda_bar_sqrt_alphas_cumprod_mmUt: torch.Tensor
    posterior_mean_coef1_x0: torch.Tensor                   # [T,N,N]
    posterior_mean_coef2_xt: torch.Tensor                   # [T,N,N]
    Lambda_posterior: torch.Tensor                          # [T,N]
    Lambda_posterior_log_variance_clipped: torch.Tensor     # [T,N]
    mahalanobis_S_sqrt_recip: torch.Tensor                  # [T,N,N]
    loss_weight: torch.Tensor                               # [T]
    num_timesteps: int
    objective: str
    loss_reduction_type: str = "l1"

    def to(self, device: DeviceLike) -> "NonisotropicProcess":
        device = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def _matmul(self, table: torch.Tensor, t: Timestep, x: torch.Tensor) -> torch.Tensor:
        """table[t] @ x: one [N,N] matrix for a timestep shared by the batch,
        or the gathered [B,N,N] matrices for per-item ``t`` [B]."""
        if isinstance(t, int) or t.ndim == 0:
            return torch.einsum("ij,bjd->bid", table[t], x)
        return torch.einsum("bij,bjd->bid", table[t], x)

    @staticmethod
    def _extract(values: torch.Tensor, t: Timestep, ndim: int) -> torch.Tensor:
        """values[t], broadcast over an ``ndim`` tensor for per-item ``t``."""
        out = values[t]
        if isinstance(t, int) or t.ndim == 0:
            return out
        return out.reshape(out.shape[0], *([1] * (ndim - 1)))

    # ---- forward process and training loss ------------------------------------
    def q_sample(self, x_start: torch.Tensor, t: Timestep, noise: torch.Tensor) -> torch.Tensor:
        """x_t = √ᾱ_t·x_0 + U√Λ̄_t·ε (white ε); reference `nonisotropic.py:152-159`."""
        return (self._extract(self.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + self._matmul(self.Umm_sqrt_Lambda_bar_t, t, noise))

    def predict_start_from_noise(self, x_t: torch.Tensor, t: Timestep,
                                 noise: torch.Tensor) -> torch.Tensor:
        """Reference `nonisotropic.py:161-165`, with the buffer it misses."""
        return (self._extract(self.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - self._matmul(self.Umm_sqrt_Lambda_bar_t_sqrt_recip_alphas_cumprod, t, noise))

    def predict_noise_from_start(self, x_t: torch.Tensor, t: Timestep,
                                 x0: torch.Tensor) -> torch.Tensor:
        """Reference `nonisotropic.py:167-171`."""
        return (self._matmul(self.inv_sqrt_Lambda_bar_mmUt, t, x_t)
                - self._matmul(self.inv_sqrt_Lambda_bar_sqrt_alphas_cumprod_mmUt, t, x0))

    def loss_terms(self, model_out: torch.Tensor, target: torch.Tensor,
                   t: Timestep) -> torch.Tensor:
        """Elementwise Mahalanobis distance |Λ̄_t^{-1/2}Uᵀ(x̂ − x)| (``l1``)
        or its square (``mse``); reference `nonisotropic.py:177-190`."""
        loss = torch.abs(self._matmul(self.mahalanobis_S_sqrt_recip, t, model_out - target))
        if self.loss_reduction_type == "l1":
            return loss
        if self.loss_reduction_type == "mse":
            return loss ** 2
        raise NotImplementedError(self.loss_reduction_type)

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t: int):
        """Reference `nonisotropic.py:196-206`: the mean in ambient
        coordinates, the (log-)variance diagonal in the eigenbasis."""
        mean = self._matmul(self.posterior_mean_coef1_x0, t, x_start) + self._matmul(
            self.posterior_mean_coef2_xt, t, x_t
        )
        var = self.Lambda_posterior[t][..., None]
        log_var = self.Lambda_posterior_log_variance_clipped[t][..., None]
        return mean, var, log_var

    def combine_mean_var_noise(self, mean, log_var, noise):
        """x_{t-1} = μ + U(e^{½logΛ_post}·ε); reference `nonisotropic.py:208-210`."""
        return mean + torch.einsum("ij,bjd->bid", self.U, torch.exp(0.5 * log_var) * noise)

    def posterior_step_tables(self) -> torch.Tensor:
        """[T, N, 3N] per-step matrices [P1_t | P2_t | U·diag(e^{½logΛ_t})] so
        that x_{t-1} = P1_t·clip(x̂₀) + P2_t·x_t + Uσ_t·ε; the noise block is
        zeroed at t=0 (the reference's ``t > 0`` mask, `base.py:353`)."""
        sigma = torch.exp(0.5 * self.Lambda_posterior_log_variance_clipped)  # [T,N]
        u_sigma = self.U[None, :, :] * sigma[:, None, :]
        u_sigma[0] = 0.0
        return torch.cat(
            [self.posterior_mean_coef1_x0, self.posterior_mean_coef2_xt, u_sigma], dim=-1
        ).contiguous()


def build_nonisotropic_process(
    Sigma_N: np.ndarray,
    Lambda_N: np.ndarray,
    U: np.ndarray,
    timesteps: int = 10,
    objective: str = "pred_x0",
    beta_schedule: str = "cosine",
    beta_schedule_factor: float = 3.0,
    diffusion_covariance_type: str = "skeleton-diffusion",
    gamma_scheduler: str = "cosine",
    loss_reduction_type: str = "l1",
    device: DeviceLike = "cuda",
) -> NonisotropicProcess:
    """Float64 host precompute of every [T,N]/[T,N,N] buffer; reference
    `nonisotropic.py:72-127`."""
    device = resolve_device(device)
    Sigma_N = np.asarray(Sigma_N, dtype=np.float64)
    Lambda_N = np.asarray(Lambda_N, dtype=np.float64)
    U = np.asarray(U, dtype=np.float64)

    betas = make_beta_schedule(beta_schedule, timesteps, beta_schedule_factor)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    sqrt_alphas_cumprod = np.sqrt(alphas_cumprod)

    Lambda_t, Lambda_bar_t, Lambda_bar_t_prev = compute_covariance_schedules(
        betas, Lambda_N, diffusion_covariance_type, gamma_scheduler
    )
    N = Sigma_N.shape[0]
    Lambda_t = np.broadcast_to(Lambda_t, (timesteps, N)).copy()
    Lambda_bar_t = np.broadcast_to(Lambda_bar_t, (timesteps, N)).copy()
    Lambda_bar_t_prev = np.broadcast_to(Lambda_bar_t_prev, (timesteps, N)).copy()

    Ut = U.T[None]
    inv_sqrt_Lambda_bar = 1.0 / np.sqrt(Lambda_bar_t)
    inv_sqrt_Lb_mmUt = inv_sqrt_Lambda_bar[..., None] * Ut
    inv_sqrt_Lb_sqrt_ac_mmUt = (inv_sqrt_Lambda_bar * sqrt_alphas_cumprod[:, None])[..., None] * Ut
    Umm_sqrt_Lb = U[None] * np.sqrt(Lambda_bar_t)[:, None, :]
    Umm_sqrt_Lb_sqrt_recip_ac = U[None] * np.sqrt(Lambda_bar_t / alphas_cumprod[:, None])[:, None, :]

    Lambda_posterior_t = Lambda_t * Lambda_bar_t_prev / Lambda_bar_t

    def u_diag_ut(diag):  # U diag(v) Uᵀ per timestep
        return np.einsum("ij,tj,kj->tik", U, diag, U)

    coef1 = np.sqrt(alphas_cumprod_prev)[:, None, None] * u_diag_ut(Lambda_t / Lambda_bar_t)
    coef2 = np.sqrt(alphas)[:, None, None] * u_diag_ut(Lambda_bar_t_prev / Lambda_bar_t)
    mahalanobis = np.sqrt(1.0 / Lambda_bar_t)[..., None] * Ut
    if objective == "pred_noise":
        loss_weight = np.ones_like(alphas)
    elif objective == "pred_x0":
        loss_weight = alphas_cumprod
    else:
        raise NotImplementedError(f"objective={objective} for nonisotropic diffusion")

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return NonisotropicProcess(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(sqrt_alphas_cumprod),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        Lambda_N=f32(Lambda_N),
        Sigma_N=f32(Sigma_N),
        U=f32(U),
        Lambda_t=f32(Lambda_t),
        Umm_sqrt_Lambda_bar_t=f32(Umm_sqrt_Lb),
        Umm_sqrt_Lambda_bar_t_sqrt_recip_alphas_cumprod=f32(Umm_sqrt_Lb_sqrt_recip_ac),
        inv_sqrt_Lambda_bar_mmUt=f32(inv_sqrt_Lb_mmUt),
        inv_sqrt_Lambda_bar_sqrt_alphas_cumprod_mmUt=f32(inv_sqrt_Lb_sqrt_ac_mmUt),
        posterior_mean_coef1_x0=f32(coef1),
        posterior_mean_coef2_xt=f32(coef2),
        Lambda_posterior=f32(Lambda_posterior_t),
        Lambda_posterior_log_variance_clipped=f32(np.log(np.clip(Lambda_posterior_t, 1e-20, None))),
        mahalanobis_S_sqrt_recip=f32(mahalanobis),
        loss_weight=f32(loss_weight),
        num_timesteps=timesteps,
        objective=objective,
        loss_reduction_type=loss_reduction_type,
    )
