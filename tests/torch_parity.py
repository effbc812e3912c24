"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py):
the same small AMASS model in the JAX package and in the port, with the
same weights, and inputs made with numpy from a seed.

Small size: the real 21-node AMASS skeleton, latent and hidden 16, denoiser
depth 1 with 2 heads × 4, 4 diffusion steps.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.weights import load_autoencoder_params, load_denoiser_params

LATENT = HIDDEN = 16
TIMESTEPS = 4
OBS_LEN, PRED_LEN = 6, 10
ARCH = {"depth": 1, "attn_heads": 2, "attn_dim_head": 4, "use_attention": True,
        "learn_influence": True, "self_condition": False, "norm_type": "none"}
SKELETON_KW = dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
                   pose_box_size=1.5, obs_length=OBS_LEN, pred_length=PRED_LEN,
                   if_consider_hip=False)


def skeletons():
    """(JAX skeleton, port skeleton) of the same configuration."""
    return jax_create_skeleton(**SKELETON_KW), create_skeleton(**SKELETON_KW)


def perturb_influence(tree, rng: np.random.Generator):
    """Move every influence matrix off its identity/zero init (as training
    does), so that the node mixes are exercised."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = perturb_influence(value, rng)
        elif key in ("G", "G0"):
            out[key] = np.asarray(value) + 0.2 * rng.random(value.shape, dtype=np.float32)
        elif key == "G_add":
            out[key] = 0.05 * (rng.random(value.shape, dtype=np.float32) - 0.5)
        else:
            out[key] = np.asarray(value)
    return out


def jax_models(jax_skeleton, seed: int = 0):
    """(flax AutoEncoder, its params, engine, denoiser, its params) with
    perturbed influence matrices, params as numpy trees."""
    rng = np.random.default_rng(seed)
    N = jax_skeleton.num_nodes
    ae = JaxAutoEncoder(num_nodes=N, encoder_hidden_size=HIDDEN, decoder_hidden_size=HIDDEN,
                        latent_size=LATENT, node_types=jax_skeleton.nodes_type_id)
    ae_params = ae.init(jax.random.key(seed), jnp.zeros((1, PRED_LEN, N, 3)),
                        jnp.zeros((1, OBS_LEN, N, 3)), ph=PRED_LEN,
                        method=JaxAutoEncoder.autoencode)
    engine, den = jax_create_diffusion(
        jax_skeleton, diffusion_type="NonisotropicGaussianDiffusion",
        covariance_matrix_type="adjacency", latent_size=LATENT, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=dict(ARCH),
    )
    den_params = den.init(jax.random.key(seed + 1), jnp.zeros((1, N, LATENT)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, N, LATENT)))
    ae_params = perturb_influence(jax.device_get(ae_params), rng)
    den_params = perturb_influence(jax.device_get(den_params), rng)
    return ae, ae_params, engine, den, den_params


def port_models(port_skeleton, ae_params, den_params):
    """The port's AutoEncoder and engine on the CPU, loaded with the flax
    weights through the bridge."""
    gen = torch.Generator().manual_seed(123)
    ae = AutoEncoder(port_skeleton.num_nodes, HIDDEN, HIDDEN, LATENT, gen,
                     node_types=port_skeleton.nodes_type_id)
    load_autoencoder_params(ae, ae_params)
    engine, den = create_diffusion(
        port_skeleton, gen, latent_size=LATENT, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=dict(ARCH), device="cpu",
    )
    load_denoiser_params(den, den_params)
    return ae, engine, den


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)
