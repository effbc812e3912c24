"""The AMASS-MANO predictor on the CPU (52 joints → 51 nodes) against the
JAX package with injected noise at small widths (latent 32, hidden 16,
depth 1 with 4 heads × 32, 1 diffusion step, observe 6, predict 10, 2
observations × 4 samples): the port's fp32 predictor (the plain denoiser,
the posterior step's and the rollout's plain versions) within 1e-4 of the
JAX fused chain in fp32 (its Pallas kernels in interpret mode, the core
jitted).  The bf16 chain at 51 nodes is held on the card (chip_smoke's
mano phase: each bf16 kernel against its plain version, the bf16 paths
against their plain paths); its CPU interpret run takes minutes here."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import ARCH, jax_fused_chain, model_pair, skeletons_of

SMALL = dict(latent=32, hidden=16, arch={**ARCH, "attn_heads": 4, "attn_dim_head": 32})
E2E_TOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor

    with mock.patch.object(torch_parity, "TIMESTEPS", 1):
        jsk, sk = skeletons_of("amass-mano", 52)
        m = model_pair(jsk, sk, SMALL)[None]
        n, s, b = sk.num_nodes, torch_parity.SAMPLES_E2E, torch_parity.BATCH_E2E
        rng = np.random.default_rng(51)
        obs = 0.3 * rng.standard_normal((b, torch_parity.OBS_LEN, n, 3), dtype=np.float32)
        start = rng.standard_normal((b * s, n, m["latent"]), dtype=np.float32)
        steps = np.zeros((b * s, 0, n, m["latent"]), dtype=np.float32)
        want = jax_fused_chain(jsk, m, *map(jnp.asarray, (obs, start, steps)), compiled=True)
        pred = SkeletonDiffusionPredictor(sk, m["ae"], m["engine"], num_samples=s,
                                          pred_length=torch_parity.PRED_LEN, device="cpu")
        got, got_lat = pred(None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                            step_noise=torch.from_numpy(steps))
        return sk, want, (got_lat.numpy(), sk.transform_to_metric_space(got).numpy())


def test_fp32_predictor_matches_jax(runs):
    sk, want, got = runs
    assert sk.num_nodes == 51
    for i, what in enumerate(("latents", "predictions")):
        assert got[i].shape == want[i].shape and got[i].shape[-2] == 51
        assert np.isfinite(got[i]).all()
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=E2E_TOL, err_msg=what)
