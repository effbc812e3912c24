"""Diffusion factory: skeleton graph → covariance → process + Denoiser +
engine; port of ``skeletondiffusion_tpu/diffusion/manager.py`` (reference
`src/core/diffusion_manager.py:8-45`) for the nonisotropic pred_x0 sampler."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.denoiser import Denoiser
from .covariance import get_cov_from_corr
from .engine import GaussianDiffusion
from .process import build_nonisotropic_process


def build_denoiser(
    num_nodes: int,
    generator: torch.Generator,
    latent_size: int = 96,
    node_types=None,
    diffusion_arch: Optional[Dict[str, Any]] = None,
) -> Denoiser:
    """Reference `diffusion_manager.py:36-45` (``get_network``)."""
    arch = dict(diffusion_arch or {})
    arch.pop("arch", None)
    if arch.pop("norm_type", "none") != "none":
        raise NotImplementedError("only norm_type='none' is shipped in reference configs")
    if arch.pop("self_condition", False):
        raise NotImplementedError("self-conditioning is not ported")
    if not arch.pop("use_attention", True):
        raise NotImplementedError("the attention-free denoiser is not ported")
    return Denoiser(
        dim=latent_size,
        out_dim=latent_size,
        channels=num_nodes,
        generator=generator,
        cond_dim=latent_size,
        node_types=node_types,
        **arch,
    )


def create_diffusion(
    skeleton,
    generator: torch.Generator,
    diffusion_type: str = "NonisotropicGaussianDiffusion",
    covariance_matrix_type: str = "adjacency",
    reachability_matrix_degree_factor: float = 0.5,
    reachability_matrix_stop_at=0,
    if_sigma_n_scale: bool = True,
    sigma_n_scale: str = "spectral",
    if_run_as_isotropic: bool = False,
    latent_size: int = 96,
    diffusion_conditioning: bool = True,
    diffusion_timesteps: int = 10,
    diffusion_objective: str = "pred_x0",
    beta_schedule: str = "cosine",
    beta_schedule_factor: float = 3.0,
    diffusion_covariance_type: str = "skeleton-diffusion",
    gamma_scheduler: str = "cosine",
    diffusion_activation: str = "identity",
    diffusion_arch: Optional[Dict[str, Any]] = None,
    device: DeviceLike = "cuda",
    **kwargs,
) -> Tuple[GaussianDiffusion, Denoiser]:
    """Build (engine, denoiser) on ``device``; the denoiser's weights are
    drawn from ``generator``.  Reference `diffusion_manager.py:8-31`.  The
    port samples what every shipped config trains: the conditioned
    nonisotropic process with identity output activation."""
    device = resolve_device(device)
    if diffusion_type != "NonisotropicGaussianDiffusion":
        raise NotImplementedError(f"{diffusion_type}: the port has the nonisotropic process")
    if not diffusion_conditioning or diffusion_activation != "identity":
        raise NotImplementedError("the port samples the conditioned model with identity "
                                  "output activation")
    model = build_denoiser(
        skeleton.num_nodes, generator, latent_size=latent_size, node_types=skeleton.nodes_type_id,
        diffusion_arch=diffusion_arch,
    )
    if covariance_matrix_type == "adjacency":
        corr = skeleton.adj_matrix
    elif covariance_matrix_type == "reachability":
        corr = skeleton.reachability_matrix(
            factor=reachability_matrix_degree_factor, stop_at=reachability_matrix_stop_at
        )
    else:
        raise NotImplementedError(covariance_matrix_type)
    Sigma_N, Lambda_N, U = get_cov_from_corr(
        correlation_matrix=corr,
        if_sigma_n_scale=if_sigma_n_scale,
        sigma_n_scale=sigma_n_scale,
        if_run_as_isotropic=if_run_as_isotropic,
        diffusion_covariance_type=diffusion_covariance_type,
    )
    process = build_nonisotropic_process(
        Sigma_N, Lambda_N, U,
        timesteps=diffusion_timesteps,
        objective=diffusion_objective,
        beta_schedule=beta_schedule,
        beta_schedule_factor=beta_schedule_factor,
        diffusion_covariance_type=diffusion_covariance_type,
        gamma_scheduler=gamma_scheduler,
        device=device,
    )
    engine = GaussianDiffusion(
        process,
        model.to(device),
        channels=skeleton.num_nodes,
        latent_size=latent_size,
    )
    return engine, model
