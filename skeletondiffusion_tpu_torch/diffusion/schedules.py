"""Diffusion noise schedules, computed host-side in float64 numpy and cast to
float32 device tables (matching the reference's float64→float32 buffer
registration, `src/core/diffusion/base.py:39-61,127-134`).  A copy of
``skeletondiffusion_tpu/diffusion/schedules.py``: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Reference `base.py:39-43`."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule; reference `base.py:45-55`."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def exp_beta_schedule(timesteps: int, factor: float = 3.0) -> np.ndarray:
    """Reference `base.py:57-61`.  NOTE: the reference evaluates exp on
    ``timesteps+1`` points and the extra first point is kept, yielding a
    length-``timesteps+1`` array that is then silently truncated by downstream
    cumprod use; we keep the first ``timesteps`` entries explicitly."""
    steps = timesteps + 1
    x = np.linspace(-factor, 0, steps, dtype=np.float64)
    betas = np.exp(x)
    return np.clip(betas, 0, 0.999)[:timesteps]


def make_beta_schedule(name: str, timesteps: int, factor: float = 3.0) -> np.ndarray:
    if name == "linear":
        return linear_beta_schedule(timesteps)
    if name == "cosine":
        return cosine_beta_schedule(timesteps)
    if name == "exp":
        return exp_beta_schedule(timesteps, factor)
    raise ValueError(f"unknown beta schedule {name}")


def compute_covariance_schedules(
    betas: np.ndarray,
    Lambda_N: np.ndarray,
    diffusion_covariance_type: str = "skeleton-diffusion",
    gamma_scheduler: str = "cosine",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-timestep eigenvalue schedules Λ_t, Λ̄_t, Λ̄_{t-1} of the correlated
    noise covariance, each ``[T, N]`` (``[T, 1]`` for the isotropic ablation).

    Reference `src/core/diffusion/nonisotropic.py:36-68`
    (``compute_covariance_matrices``).  All float64.
    """
    num_timesteps = len(betas)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)

    if diffusion_covariance_type == "isotropic":
        assert (Lambda_N == 0).all()
        Lambda_t = (1 - alphas)[:, None]
        Lambda_bar_t = (1 - alphas_cumprod)[:, None]
        Lambda_bar_t_prev = np.concatenate([np.zeros((1, 1)), Lambda_bar_t[:-1]], axis=0)
    elif diffusion_covariance_type == "anisotropic":
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        Lambda_t = (1 - alphas)[:, None] * Lambda_N[None]
        Lambda_bar_t = (1 - alphas_cumprod)[:, None] * Lambda_N[None]
        Lambda_bar_t_prev = (1 - alphas_cumprod_prev)[:, None] * Lambda_N[None]
    elif diffusion_covariance_type == "skeleton-diffusion":
        if gamma_scheduler == "cosine":
            gammas = 1 - alphas
        elif gamma_scheduler == "mono_decrease":
            gammas = 1 - np.arange(0, num_timesteps, dtype=np.float64) / num_timesteps
        else:
            raise NotImplementedError(f"gamma_scheduler={gamma_scheduler}")
        N = Lambda_N.shape[0]
        Lambda_I = Lambda_N - 1.0
        gammas_bar = (1 - alphas) * gammas
        gammas_tilde = alphas_cumprod * np.cumsum(gammas_bar / alphas_cumprod)
        Lambda_t = Lambda_I[None] * gammas_bar[:, None] + (1 - alphas)[:, None]
        Lambda_bar_t = Lambda_I[None] * gammas_tilde[:, None] + (1 - alphas_cumprod)[:, None]
        Lambda_bar_t_prev = np.concatenate([np.zeros((1, N)), Lambda_bar_t[:-1]], axis=0)
    else:
        raise NotImplementedError(f"diffusion_covariance_type={diffusion_covariance_type}")

    return Lambda_t, Lambda_bar_t, Lambda_bar_t_prev
