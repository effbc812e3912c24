"""The PyTorch port's host tables against the JAX package: skeleton graph,
covariance, β schedules, the nonisotropic process tables and the motion
transforms.  The numpy parts are copies and agree exactly; the float32
tables built from them agree to the last bit or, where a float32 exp sits in
between, to 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.diffusion import covariance as jax_cov
from skeletondiffusion_tpu.diffusion import schedules as jax_sched
from skeletondiffusion_tpu.diffusion.process import (
    build_nonisotropic_process as jax_build_process,
)
from skeletondiffusion_tpu_torch.diffusion import covariance, schedules
from skeletondiffusion_tpu_torch.diffusion.process import build_nonisotropic_process

from torch_parity import SKELETON_KW, skeletons


def test_skeleton_graph_tables():
    jsk, sk = skeletons()
    assert sk.num_nodes == jsk.num_nodes == 21
    np.testing.assert_array_equal(sk.nodes_type_id, jsk.nodes_type_id)
    np.testing.assert_array_equal(sk.adj_matrix, jsk.adj_matrix)
    assert sk.node_limbseq == jsk.node_limbseq
    assert sk.node_dict == jsk.node_dict
    np.testing.assert_array_equal(sk.reachability_matrix(0.5, 0), jsk.reachability_matrix(0.5, 0))


@pytest.mark.parametrize("with_hip", [False, True])
def test_transform_to_metric_space_matches(with_hip):
    from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
    from skeletondiffusion_tpu_torch.skeleton import create_skeleton

    kw = dict(SKELETON_KW, if_consider_hip=with_hip)
    jsk, sk = jax_create_skeleton(**kw), create_skeleton(**kw)
    assert sk.num_nodes == jsk.num_nodes == (22 if with_hip else 21)
    pred = np.random.default_rng(0).standard_normal((2, 3, 5, sk.num_nodes, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        sk.transform_to_metric_space(torch.from_numpy(pred)).numpy(),
        np.asarray(jsk.transform_to_metric_space(jnp.asarray(pred))))


@pytest.mark.parametrize("kind", ["adjacency", "reachability"])
@pytest.mark.parametrize("scale", ["spectral", "frob"])
def test_covariance_matches(kind, scale):
    jsk, sk = skeletons()
    corr = sk.adj_matrix if kind == "adjacency" else sk.reachability_matrix(0.5, 0)
    got = covariance.get_cov_from_corr(corr, sigma_n_scale=scale)
    want = jax_cov.get_cov_from_corr(corr, sigma_n_scale=scale)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["linear", "cosine", "exp"])
def test_beta_schedules_match(name):
    betas = schedules.make_beta_schedule(name, 10, 3.0)
    np.testing.assert_array_equal(betas, jax_sched.make_beta_schedule(name, 10, 3.0))
    for cov_type in ("skeleton-diffusion", "anisotropic"):
        lam = np.linspace(0.2, 1.0, 21)
        for g, w in zip(schedules.compute_covariance_schedules(betas, lam, cov_type),
                        jax_sched.compute_covariance_schedules(betas, lam, cov_type)):
            np.testing.assert_array_equal(g, w)


def _processes(timesteps=10):
    _, sk = skeletons()
    sigma, lam, u = covariance.get_cov_from_corr(sk.adj_matrix)
    return (build_nonisotropic_process(sigma, lam, u, timesteps=timesteps, device="cpu"),
            jax_build_process(sigma, lam, u, timesteps=timesteps))


def test_process_tables_match():
    port, ref = _processes()
    assert port.num_timesteps == ref.num_timesteps and port.objective == ref.objective
    for field in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod", "Lambda_N", "Sigma_N", "U",
                  "Lambda_t", "Umm_sqrt_Lambda_bar_t", "inv_sqrt_Lambda_bar_mmUt",
                  "posterior_mean_coef1_x0", "posterior_mean_coef2_xt", "Lambda_posterior",
                  "Lambda_posterior_log_variance_clipped", "mahalanobis_S_sqrt_recip",
                  "loss_weight"):
        np.testing.assert_array_equal(getattr(port, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)


def test_posterior_step_tables_match():
    port, ref = _processes()
    got = port.posterior_step_tables().numpy()
    want = np.asarray(ref.posterior_step_tables())
    assert got.shape == want.shape == (10, 21, 63)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # one float32 exp between
    assert not got[0, :, 42:].any()  # no noise at t=0
