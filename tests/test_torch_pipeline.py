"""The port's prediction path end to end: ``SkeletonDiffusionPredictor`` on the CPU
against the JAX predictor, same weights and injected sampler noise, through
``transform_to_metric_space``; plus the port's own contract on randomness
and devices.

Tolerance 1e-4 absolute in metric space (|pred| ≤ 1.5): float32 on both
sides; sum-order differences of ~1e-7 pass through 4 denoiser steps, the
posterior mixes and a 10-step decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.eval_pipeline import (
    SkeletonDiffusionPredictor as JaxPredictor,
)
from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor

from torch_parity import (LATENT, OBS_LEN, PRED_LEN, TIMESTEPS, as_jax, jax_models,
                          port_models, skeletons)

B, S = 2, 3


@pytest.fixture(scope="module")
def predictors():
    jsk, sk = skeletons()
    jae, ae_params, jengine, _, den_params = jax_models(jsk, seed=5)
    ae, engine, _ = port_models(sk, ae_params, den_params)
    jpred = JaxPredictor(jsk, jae, as_jax(ae_params), jengine, as_jax(den_params),
                         num_samples=S, pred_length=PRED_LEN)
    pred = SkeletonDiffusionPredictor(sk, ae, engine, num_samples=S, pred_length=PRED_LEN,
                                      device="cpu")
    return jsk, sk, jpred, pred


def test_predictor_matches_jax_with_injected_noise(predictors):
    jsk, sk, jpred, pred = predictors
    rng = np.random.default_rng(0)
    obs = 0.3 * rng.standard_normal((B, OBS_LEN, 21, 3), dtype=np.float32)
    start = rng.standard_normal((B * S, 21, LATENT), dtype=np.float32)
    steps = rng.standard_normal((B * S, TIMESTEPS - 1, 21, LATENT), dtype=np.float32)
    want, want_lat = jpred(jax.random.key(0), jnp.asarray(obs), start_noise=jnp.asarray(start),
                           step_noise=jnp.asarray(steps))
    want = np.asarray(jsk.transform_to_metric_space(want))
    got, got_lat = pred(None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                        step_noise=torch.from_numpy(steps))
    got = sk.transform_to_metric_space(got).numpy()
    assert got.shape == want.shape == (B, S, PRED_LEN, 21, 3)
    assert got_lat.shape == want_lat.shape == (B, S, 21, LATENT)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_predictor_noise_comes_from_the_generator(predictors):
    _, _, _, pred = predictors
    obs = 0.3 * torch.randn(B, OBS_LEN, 21, 3, generator=torch.Generator().manual_seed(0))
    run = lambda seed: pred(torch.Generator().manual_seed(seed), obs)  # noqa: E731
    (a, lat_a), (b, lat_b), (_, lat_c) = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(lat_a, lat_b, rtol=0, atol=0)
    assert (lat_a - lat_c).abs().max() > 1e-5  # the drawn noise reaches the samples
    with pytest.raises(ValueError, match="Generator"):
        pred(None, obs)


def test_cuda_request_without_gpu_raises(predictors, monkeypatch):
    from skeletondiffusion_tpu_torch.device import resolve_device

    jsk, sk, _, pred = predictors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        SkeletonDiffusionPredictor(sk, pred.autoencoder, pred.diffusion, device="cuda")
