"""Diffusion factory: skeleton graph → covariance → process + Denoiser +
engine; port of ``skeletondiffusion_tpu/diffusion/manager.py`` (reference
`src/core/diffusion_manager.py:8-45`), both processes."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..models.denoiser import Denoiser
from .covariance import get_cov_from_corr
from .engine import GaussianDiffusion
from .process import build_isotropic_process, build_nonisotropic_process


def build_denoiser(
    num_nodes: int,
    generator: torch.Generator,
    latent_size: int = 96,
    node_types=None,
    diffusion_arch: Optional[Dict[str, Any]] = None,
    compute_dtype: Optional[torch.dtype] = None,
    diffusion_conditioning: bool = True,
) -> Denoiser:
    """Reference `diffusion_manager.py:36-45` (``get_network``): the
    conditioning width is the latent's, or 0 without conditioning."""
    arch = dict(diffusion_arch or {})
    arch.pop("arch", None)
    if arch.pop("norm_type", "none") != "none":
        raise NotImplementedError("only norm_type='none' is shipped in reference configs")
    return Denoiser(
        dim=latent_size,
        out_dim=latent_size,
        channels=num_nodes,
        generator=generator,
        cond_dim=latent_size if diffusion_conditioning else 0,
        node_types=node_types,
        compute_dtype=compute_dtype,
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
    loss_reduction_type: str = "l1",
    diffusion_loss_type: str = "mse",
    diffusion_activation: str = "identity",
    diffusion_arch: Optional[Dict[str, Any]] = None,
    sampling_timesteps: Optional[int] = None,
    ddim_sampling_eta: float = 0.0,
    compute_dtype: Optional[Union[str, torch.dtype]] = None,
    remat_denoiser: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[GaussianDiffusion, Denoiser]:
    """Build (engine, denoiser) on ``device``; the denoiser's weights are
    drawn from ``generator``.  Reference `diffusion_manager.py:8-31`.

    Every key of the CLIs' ``DIFFUSION_CFG_KEYS`` is a parameter here, as in
    the JAX factory (`skeletondiffusion_tpu/diffusion/manager.py:44-69`), with
    the JAX meaning; what the JAX package refuses raises here too: an unknown
    enum, ``norm_type`` other than ``'none'``, pred_v on the nonisotropic
    process, and DDIM (``sampling_timesteps`` below ``diffusion_timesteps``)
    on it, which the JAX engine asserts against when it samples
    (`engine.py:308`) and the port refuses at once.  ``diffusion_loss_type``
    is read by the isotropic process only, ``loss_reduction_type``,
    ``covariance_matrix_type`` and the covariance keys by the nonisotropic
    one, ``ddim_sampling_eta`` by the DDIM sampler only (`manager.py:92-130`).
    ``compute_dtype`` (``"bfloat16"`` or a torch dtype; None = float32) is
    the denoiser's.  ``remat_denoiser`` recomputes the denoiser's forward in
    the backward (``torch.utils.checkpoint``, the counterpart of
    ``jax.checkpoint`` at `manager.py:140`): the same gradients for less
    memory.  The port's default is the conditioned model (JAX's is
    unconditioned; every shipped config conditions)."""
    device = resolve_device(device)
    if isinstance(compute_dtype, str):
        compute_dtype = {"bfloat16": torch.bfloat16, "float32": None}[compute_dtype]
    if diffusion_type == "IsotropicGaussianDiffusion":
        if diffusion_loss_type not in ("mse", "l1"):
            raise NotImplementedError(
                f"isotropic diffusion_loss_type={diffusion_loss_type!r} (use 'mse' or 'l1')")
        process = build_isotropic_process(
            skeleton.num_nodes,
            timesteps=diffusion_timesteps,
            objective=diffusion_objective,
            beta_schedule=beta_schedule,
            beta_schedule_factor=beta_schedule_factor,
            loss_type=diffusion_loss_type,
            device=device,
        )
    elif diffusion_type == "NonisotropicGaussianDiffusion":
        if loss_reduction_type not in ("l1", "mse"):  # JAX refuses it at the first loss
            raise NotImplementedError(f"loss_reduction_type={loss_reduction_type!r} (l1 or mse)")
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
            loss_reduction_type=loss_reduction_type,
            device=device,
        )
    else:
        raise NotImplementedError(diffusion_type)
    model = build_denoiser(
        skeleton.num_nodes, generator, latent_size=latent_size, node_types=skeleton.nodes_type_id,
        diffusion_arch=diffusion_arch, compute_dtype=compute_dtype,
        diffusion_conditioning=diffusion_conditioning,
    )
    engine = GaussianDiffusion(
        process,
        model.to(device),
        channels=skeleton.num_nodes,
        latent_size=latent_size,
        diffusion_activation=diffusion_activation,
        sampling_timesteps=sampling_timesteps,
        ddim_sampling_eta=ddim_sampling_eta,
        remat=remat_denoiser,
    )
    return engine, model
