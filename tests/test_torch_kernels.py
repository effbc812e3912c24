"""The port's two kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (run with ``interpret=True`` on the CPU, as the
repo's own Pallas tests do), the port's decode against the flax decoder, and
the wrappers' refusal to fall back when a CUDA launch is asked for.

Tolerances: float32 on both sides, differing only in the order of sums —
1e-5 absolute for one posterior step (O(1) values, 63-term sums) and for a
10-step rollout or decode (tanh-bounded outputs; the error does not grow
over the steps)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.ops.pallas.gru_rollout import gru_rollout_pallas
from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import build
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as posterior_mod

from torch_parity import (LATENT, PRED_LEN, TIMESTEPS, as_jax, jax_models, port_models,
                          skeletons)

N = 21


def _posterior_inputs(rng, b=8, d=128):
    x0 = 1.5 * rng.standard_normal((N, b, d), dtype=np.float32)  # some |x̂₀| > 1
    xt = rng.standard_normal((N, b, d), dtype=np.float32)
    eps = rng.standard_normal((N, b, d), dtype=np.float32)
    return x0, xt, eps


@pytest.fixture(scope="module")
def process_pair():
    from skeletondiffusion_tpu.diffusion.process import build_nonisotropic_process as jax_build
    from skeletondiffusion_tpu_torch.diffusion.covariance import get_cov_from_corr
    from skeletondiffusion_tpu_torch.diffusion.process import build_nonisotropic_process

    _, sk = skeletons()
    sigma, lam, u = get_cov_from_corr(sk.adj_matrix)
    return (build_nonisotropic_process(sigma, lam, u, timesteps=TIMESTEPS, device="cpu"),
            jax_build(sigma, lam, u, timesteps=TIMESTEPS))


@pytest.mark.parametrize("t", range(TIMESTEPS))
def test_posterior_step_plain_matches_pallas(process_pair, t):
    port, ref = process_pair
    x0, xt, eps = _posterior_inputs(np.random.default_rng(t))
    m_t = port.posterior_step_tables()[t]
    got = posterior_mod.posterior_step(*map(torch.from_numpy, (x0, xt, eps)), m_t)
    want = posterior_step_pallas(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(eps),
                                 ref.posterior_step_tables()[t], batch_tile=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", range(TIMESTEPS))
def test_posterior_step_equals_q_posterior_and_noise(process_pair, t):
    """The fused form ≡ clip → q_posterior → combine_mean_var_noise with the
    t>0 noise mask, in batch-major [B,N,D] as the plain sampler runs it."""
    port, _ = process_pair
    x0, xt, eps = map(torch.from_numpy, _posterior_inputs(np.random.default_rng(10 + t), d=16))
    bm = lambda a: a.transpose(0, 1)  # noqa: E731
    mean, _, log_var = port.q_posterior(bm(x0).clamp(-1, 1), bm(xt), t)
    noise = bm(eps) if t > 0 else torch.zeros_like(bm(eps))
    want = port.combine_mean_var_noise(mean, log_var, noise)
    got = posterior_mod.posterior_step(x0, xt, eps, port.posterior_step_tables()[t])
    np.testing.assert_allclose(bm(got).numpy(), want.numpy(), rtol=0, atol=1e-5)


def _rollout_inputs(rng, node_types, b=8, h=16, f=3):
    types = np.zeros(N, np.int64) if node_types is None else np.asarray(node_types)
    n_types = int(types.max()) + 1
    bank = lambda *s: (0.3 * rng.standard_normal((n_types, *s), dtype=np.float32))[types]  # noqa
    norm = lambda g: l1_normalize_rows(torch.from_numpy(g)).numpy()  # noqa: E731
    return dict(
        cx=rng.standard_normal((N, b, 3 * h), dtype=np.float32),
        h0=0.5 * rng.standard_normal((N, b, h), dtype=np.float32),
        w_hh=bank(h, 3 * h), b_hh=bank(3 * h),
        g0=norm(np.eye(N, dtype=np.float32) + 0.2 * rng.random((N, N), dtype=np.float32)),
        g_add=0.05 * (rng.random((N, N), dtype=np.float32) - 0.5),
        w_fc=bank(h, f), b_fc=bank(f),
        g_fc=norm(np.eye(N, dtype=np.float32) + 0.2 * rng.random((N, N), dtype=np.float32)),
    )


@pytest.mark.parametrize("with_types", [True, False])
def test_gru_rollout_plain_matches_pallas(with_types):
    _, sk = skeletons()
    inp = _rollout_inputs(np.random.default_rng(1), sk.nodes_type_id if with_types else None)
    got = rollout_mod.gru_rollout(**{k: torch.from_numpy(v) for k, v in inp.items()}, ph=PRED_LEN)
    want = gru_rollout_pallas(**{k: jnp.asarray(v) for k, v in inp.items()}, ph=PRED_LEN,
                              batch_tile=8, interpret=True)
    assert got.shape == want.shape == (PRED_LEN, N, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def model_pair():
    jsk, sk = skeletons()
    jae, ae_params, _, _, den_params = jax_models(jsk)
    ae, _, _ = port_models(sk, ae_params, den_params)
    return jae, ae_params, ae


def test_decode_matches_flax_decoder(model_pair):
    jae, ae_params, ae = model_pair
    rng = np.random.default_rng(2)
    x = 0.3 * rng.standard_normal((4, 3, N, 3), dtype=np.float32)
    z = np.tanh(rng.standard_normal((4, N, LATENT), dtype=np.float32))
    want = jae.apply(as_jax(ae_params), jnp.asarray(x), jnp.asarray(z), None, ph=PRED_LEN,
                     method=JaxAutoEncoder.decode)
    with torch.no_grad():
        got = ae.decode(torch.from_numpy(x), torch.from_numpy(z), PRED_LEN)
    assert got.shape == want.shape == (4, PRED_LEN, N, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _as_cuda_request(monkeypatch):
    """Make the wrappers take their CUDA branch for CPU tensors, as a machine
    whose tensors live on a GPU would."""
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build.c_entry.cache_clear()


def _c_entry_refusing_shapes(monkeypatch):
    """Stand in for a kernel's C entry at shapes its source does not
    instantiate: it returns cudaErrorInvalidValue (1) and launches nothing."""
    monkeypatch.setattr(build, "c_entry", lambda *a: (lambda *args: 1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def test_posterior_step_raises_instead_of_falling_back(monkeypatch):
    x0, xt, eps = map(torch.from_numpy, _posterior_inputs(np.random.default_rng(3), d=96))
    m_t = torch.zeros(N, 3 * N)
    _as_cuda_request(monkeypatch)
    before = posterior_mod.launches
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        posterior_mod.posterior_step(x0, xt, eps, m_t)
    with pytest.raises(TypeError, match="float32"):
        posterior_mod.posterior_step(x0.double(), xt, eps, m_t)
    _c_entry_refusing_shapes(monkeypatch)
    with pytest.raises(RuntimeError, match="at 5 nodes: .*cudaError 1"):  # not instantiated
        posterior_mod.posterior_step(x0[:5], xt[:5], eps[:5], torch.zeros(5, 15))
    assert posterior_mod.launches == before


def test_gru_rollout_raises_instead_of_falling_back(monkeypatch):
    inp = {k: torch.from_numpy(v)
           for k, v in _rollout_inputs(np.random.default_rng(4), None, b=4, h=96).items()}
    _as_cuda_request(monkeypatch)
    before = rollout_mod.launches
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        rollout_mod.gru_rollout(**inp, ph=3)
    with pytest.raises(ValueError, match="contiguous"):
        rollout_mod.gru_rollout(**{**inp, "cx": inp["cx"].transpose(0, 1).contiguous()
                                   .transpose(0, 1)}, ph=3)
    small = {k: torch.from_numpy(v)
             for k, v in _rollout_inputs(np.random.default_rng(4), None, b=4, h=16).items()}
    _c_entry_refusing_shapes(monkeypatch)
    with pytest.raises(RuntimeError, match=r"=\(21, 16, 3\): .*cudaError 1"):
        rollout_mod.gru_rollout(**small, ph=3)
    assert rollout_mod.launches == before


def test_kernel_inputs_on_two_devices_raise():
    x = torch.zeros(N, 4, 8)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        posterior_mod.posterior_step(x, x, x.to("meta"), torch.zeros(N, 3 * N))
