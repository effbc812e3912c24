"""The AMASS-MANO predictor on the CPU (52 joints → 51 nodes) against the
JAX package with injected noise at small widths (latent 32, hidden 16,
depth 1 with 4 heads × 32, 1 diffusion step, observe 6, predict 10, 2
observations × 4 samples): the port's fp32 predictor (the plain denoiser,
the posterior step's and the rollout's plain versions) within 1e-4 of the
JAX fused chain in fp32 (its Pallas kernels in interpret mode, the core
jitted).  The port's bf16 predictor (the plain versions, K2's on a bf16
x̂₀) against the JAX fused chain's bf16 and fp32 runs of
``tests/goldens/mano_bf16.npz`` (2 diffusion steps), within
``BF16_SPREAD`` of the JAX chain's own bf16-vs-fp32 deviation; the JAX
bf16 chain takes minutes in interpret mode, so the file keeps its runs.
On the card chip_smoke's mano phase holds each bf16 kernel against its
plain version and the bf16 paths against their plain paths."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import (MANO_GOLDEN, MANO_SMALL, hold_bf16_predictor, jax_fused_chain,
                          model_pair, port_predictor_run, predictor_inputs, skeletons_of)

E2E_TOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor

    with mock.patch.object(torch_parity, "TIMESTEPS", 1):
        jsk, sk = skeletons_of("amass-mano", 52)
        m = model_pair(jsk, sk, MANO_SMALL)[None]
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


def test_bf16_predictor_holds_the_jax_golden():
    """The port's bf16 predictor at 51 nodes against the JAX fused chain's
    bf16 and fp32 runs kept in ``tests/goldens/mano_bf16.npz`` (its seeds
    and step count; the same weights and injected noise here), within
    ``BF16_SPREAD`` of the JAX chain's own bf16-vs-fp32 deviation
    (``hold_bf16_predictor``).  Regenerate the file with
    ``JAX_PLATFORMS=cpu python3 scripts/mano_bf16_golden.py`` (~2 min:
    the JAX bf16 chain in interpret mode) after a change to the JAX
    package's chain or to ``torch_parity``'s models or inputs."""
    golden = np.load(MANO_GOLDEN)
    with mock.patch.object(torch_parity, "TIMESTEPS", int(golden["timesteps"])):
        jsk, sk = skeletons_of("amass-mano", 52)
        m = model_pair(jsk, sk, MANO_SMALL, seed=int(golden["weight_seed"]))
        inputs = predictor_inputs(sk.num_nodes, m[None]["latent"], int(golden["input_seed"]))
        runs = {"jax": {None: (golden["fp32_latents"], golden["fp32_predictions"]),
                        "bfloat16": (golden["bf16_latents"], golden["bf16_predictions"])},
                "port": {"bfloat16": port_predictor_run(sk, m["bfloat16"], inputs, fused=True)}}
    assert sk.num_nodes == 51 and runs["port"]["bfloat16"][0].shape == golden["bf16_latents"].shape
    hold_bf16_predictor(jsk, sk, m, int(golden["input_seed"]), runs=runs)
