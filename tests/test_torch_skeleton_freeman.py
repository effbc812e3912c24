"""The FreeMan slice on the CPU (18 joints → 17 nodes) and the 3DPW
zero-shot evaluation against the JAX package: the predictor with injected
noise (fp32 within 1e-4 of the JAX fused chain, bf16 within
``BF16_SPREAD``) at the small widths of
``tests/test_torch_skeleton_paths.py``, and the eval CLI with
``dataset=freeman`` (the shipped lists and labels) and ``dataset=3dpw``
(24-joint clips, the AMASS body) against the JAX CLI, each on a small tree
of the shipped annotations."""
import os
import pathlib
from unittest import mock

import numpy as np
import pytest

from skeletondiffusion_tpu_torch.cli import eval as eval_cli
from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_skeleton_tree

import torch_parity
from torch_parity import ARCH, hold_bf16_predictor, model_pair, predictor_runs, skeletons_of

REPO = pathlib.Path(__file__).resolve().parents[1]
ANNOTATIONS = REPO / "datasets" / "annotations"
SMALL = dict(latent=32, hidden=16, arch={**ARCH, "attn_heads": 4, "attn_dim_head": 32})
E2E_TOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    """The models and runs with 2 diffusion steps (the JAX bf16 chain runs
    its Pallas kernels in interpret mode, ~7 s a step)."""
    with mock.patch.object(torch_parity, "TIMESTEPS", 2):
        jsk, sk = skeletons_of("freeman", 18)
        m = model_pair(jsk, sk, SMALL)
        return jsk, sk, m, predictor_runs(jsk, sk, m, seed=9, dtypes=(None, "bfloat16"))


def test_fp32_predictor_matches_jax(runs):
    jsk, sk, _, r = runs
    assert sk.num_nodes == jsk.num_nodes == 17
    for i, what in enumerate(("latents", "predictions")):
        np.testing.assert_allclose(r["port"][None][i], r["jax"][None][i], rtol=0, atol=E2E_TOL,
                                   err_msg=what)


def test_bf16_predictor_matches_jax(runs):
    jsk, sk, m, r = runs
    hold_bf16_predictor(jsk, sk, m, seed=9, runs=r)


@pytest.mark.parametrize("dataset, folder, obs, pred", [
    ("freeman", "FreeMan", 15, 60),   # 30 fps
    ("3dpw", "3DPW", 30, 120),        # 60 fps
])
def test_eval_cli_equals_jax(tmp_path, dataset, folder, obs, pred):
    """ZeroVelocity through both eval CLIs on a tree of the shipped
    annotations (each CSV cut to 10 segments, the FreeMan lists to 4
    sequences; 3DPW's zero-shot segments), probabilistic, with the config's
    CMD (and its APDE: off for both, as the config sets it)."""
    from skeletondiffusion_tpu.cli.eval import main as jax_eval

    root = make_synthetic_skeleton_tree(str(tmp_path), dataset, str(ANNOTATIONS / folder / "hmp"),
                                        obs_length=obs, pred_length=pred, max_segments=10,
                                        max_sequences=4, train_frames=100, seed=2)
    args = [f"dataset={dataset}", "method_specs=zerovelocity_alg_baseline",
            "stats_mode=probabilistic", "batch_size=4", "num_samples=3",
            "device_mesh.n_devices=1", f"dataset_main_path={root}"]
    if dataset == "3dpw":  # the zero-shot segments, all splits' sequences
        csv = os.path.join(root, "annotations", folder, "hmp", "segments_test_zero_shot.csv")
        args.append(f"dataset.data_loader_test.segments_path={csv}")
    env = {"SKELDIFF_CONFIG_DIR": str(REPO / "configs" / "config_eval")}
    with mock.patch.dict(os.environ, env):
        want = jax_eval(args + [f"results_path={tmp_path / 'jax.yaml'}"])
        got = eval_cli.main(args + ["device=cpu", f"results_path={tmp_path / 'port.yaml'}"])
    assert list(got) == list(want) and "CMD" in got and "APDE" not in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
