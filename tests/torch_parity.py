"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py):
the same small AMASS model in the JAX package and in the port, with the
same weights, and inputs made with numpy from a seed.

Small size: the real 21-node AMASS skeleton, latent and hidden 16, denoiser
depth 1 with 2 heads × 4, 4 diffusion steps.  The fused-denoiser tests use
the flagship's widths at a small depth instead (``WIDE``: latent 96, so
F = 192, denoiser depth 2 with 8 heads × 32).
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
WIDE = dict(latent=96, hidden=16,
            arch={**ARCH, "depth": 2, "attn_heads": 8, "attn_dim_head": 32})
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


def spread_weights(tree, rng: np.random.Generator):
    """Add N(0, 1/fan_in) to every weight bank and Dense kernel, so that the
    denoiser's activations and its x̂₀ are O(1) as a trained model's are (the
    init's are ~1e-2: bf16 effects would sit at the last rounding of the
    output)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = spread_weights(value, rng)
        elif key in ("weight", "kernel"):
            fan_in = value.shape[-2]
            out[key] = (np.asarray(value) + rng.standard_normal(value.shape).astype(np.float32)
                        / np.sqrt(fan_in))
        else:
            out[key] = np.asarray(value)
    return out


def jax_models(jax_skeleton, seed: int = 0, latent: int = LATENT, hidden: int = HIDDEN,
               arch=ARCH, compute_dtype=None, spread: bool = False):
    """(flax AutoEncoder, its params, engine, denoiser, its params) with
    perturbed influence matrices, params as numpy trees; ``compute_dtype``
    (e.g. ``"bfloat16"``) is the AutoEncoder's and the denoiser's;
    ``spread`` spreads the denoiser's weights (``spread_weights``)."""
    rng = np.random.default_rng(seed)
    N = jax_skeleton.num_nodes
    ae = JaxAutoEncoder(num_nodes=N, encoder_hidden_size=hidden, decoder_hidden_size=hidden,
                        latent_size=latent, node_types=jax_skeleton.nodes_type_id,
                        compute_dtype=compute_dtype)
    ae_params = ae.init(jax.random.key(seed), jnp.zeros((1, PRED_LEN, N, 3)),
                        jnp.zeros((1, OBS_LEN, N, 3)), ph=PRED_LEN,
                        method=JaxAutoEncoder.autoencode)
    engine, den = jax_create_diffusion(
        jax_skeleton, diffusion_type="NonisotropicGaussianDiffusion",
        covariance_matrix_type="adjacency", latent_size=latent, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=dict(arch), compute_dtype=compute_dtype,
    )
    den_params = den.init(jax.random.key(seed + 1), jnp.zeros((1, N, latent)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, N, latent)))
    ae_params = perturb_influence(jax.device_get(ae_params), rng)
    den_params = perturb_influence(jax.device_get(den_params), rng)
    if spread:
        den_params = spread_weights(den_params, rng)
    return ae, ae_params, engine, den, den_params


def port_models(port_skeleton, ae_params, den_params, latent: int = LATENT,
                hidden: int = HIDDEN, arch=ARCH, compute_dtype=None):
    """The port's AutoEncoder and engine on the CPU, loaded with the flax
    weights through the bridge; ``compute_dtype`` as ``jax_models`` takes it."""
    compute_dtype = {None: None, "bfloat16": torch.bfloat16}[compute_dtype]
    gen = torch.Generator().manual_seed(123)
    ae = AutoEncoder(port_skeleton.num_nodes, hidden, hidden, latent, gen,
                     node_types=port_skeleton.nodes_type_id, compute_dtype=compute_dtype)
    load_autoencoder_params(ae, ae_params)
    engine, den = create_diffusion(
        port_skeleton, gen, latent_size=latent, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=dict(arch), device="cpu",
        compute_dtype=compute_dtype,
    )
    load_denoiser_params(den, den_params)
    return ae, engine, den


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_bf16_close(got, want, what: str = ""):
    """The bf16 criteria, compared in float32: max |Δ| ≤ 3e-2·max|ref| and
    mean |Δ| ≤ 2e-3·max|ref| (bf16 keeps 8 significant bits, unit roundoff
    2^-8, and each kernel rounds 2–4 times)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert np.isfinite(got).all(), what
    assert diff.max() <= 3e-2 * scale, (what, float(diff.max()), scale)
    assert diff.mean() <= 2e-3 * scale, (what, float(diff.mean()), scale)
