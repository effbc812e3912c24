"""The Human3.6M slice on the CPU (17 joints → 16 nodes) against the JAX
package: the predictor with injected noise (fp32 within 1e-4 of the JAX
fused chain, bf16 within ``BF16_SPREAD`` of its bf16-vs-fp32 deviation) at
small widths (latent 32, hidden 16, depth 1 with 4 heads × 32, 2 steps),
``compute_metrics`` on a small H36M split of the shipped annotations with
CMD, APDE and FID (the classifier of ``fid_classifier.npz``, 48 inputs)
against the JAX loop at rtol 1e-5, atol 1e-6, and the eval CLI with
``dataset=h36m`` against the JAX CLI.  The FreeMan counterparts are in
``tests/test_torch_skeleton_freeman.py``."""
import os
import pathlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.data.loaders import H36MDataset as JaxH36MDataset
from skeletondiffusion_tpu.eval_pipeline import ZeroVelocityPredictor as JaxZeroVelocity
from skeletondiffusion_tpu.eval_pipeline import compute_metrics as jax_compute_metrics
from skeletondiffusion_tpu.metrics.fid import port_classifier as jax_port_classifier
from skeletondiffusion_tpu_torch.cli import eval as eval_cli
from skeletondiffusion_tpu_torch.data import H36MDataset
from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_skeleton_tree
from skeletondiffusion_tpu_torch.eval_pipeline import ZeroVelocityPredictor, compute_metrics
from skeletondiffusion_tpu_torch.metrics.fid import ClassifierForFID, port_classifier

import torch_parity
from torch_parity import ARCH, hold_bf16_predictor, model_pair, predictor_runs, skeletons_of

REPO = pathlib.Path(__file__).resolve().parents[1]
ANNOTATIONS = REPO / "datasets" / "annotations"
SMALL = dict(latent=32, hidden=16, arch={**ARCH, "attn_heads": 4, "attn_dim_head": 32})
OBS, PRED = 25, 100  # 0.5 s and 2 s at 50 fps
E2E_TOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    """The models and runs with 2 diffusion steps (the JAX bf16 chain runs
    its Pallas kernels in interpret mode, ~7 s a step)."""
    with mock.patch.object(torch_parity, "TIMESTEPS", 2):
        jsk, sk = skeletons_of("h36m", 17)
        m = model_pair(jsk, sk, SMALL)
        return jsk, sk, m, predictor_runs(jsk, sk, m, seed=8, dtypes=(None, "bfloat16"))


def test_fp32_predictor_matches_jax(runs):
    jsk, sk, _, r = runs
    assert sk.num_nodes == jsk.num_nodes == 16
    for i, what in enumerate(("latents", "predictions")):
        got, want = r["port"][None][i], r["jax"][None][i]
        np.testing.assert_allclose(got, want, rtol=0, atol=E2E_TOL, err_msg=what)


def test_bf16_predictor_matches_jax(runs):
    jsk, sk, m, r = runs
    hold_bf16_predictor(jsk, sk, m, seed=8, runs=r)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Human3.6M tree on the shipped annotations, each CSV cut to 9
    segments (observe 25, predict 100)."""
    root = make_synthetic_skeleton_tree(
        str(tmp_path_factory.mktemp("h36m")), "h36m", str(ANNOTATIONS / "Human36M" / "hmp"),
        obs_length=OBS, pred_length=PRED, max_segments=9, train_frames=160, seed=1)
    return {"root": root, "pre": os.path.join(root, "processed", "Human36M", "hmp") + "/",
            "ann": os.path.join(root, "annotations", "Human36M", "hmp")}


def _golden_classifier():
    g = np.load(REPO / "tests" / "goldens" / "fid_classifier.npz")
    return {k: g[k] for k in g.files if k not in ("motion", "feats", "logits")}


def test_compute_metrics_with_fid_matches_jax(tree):
    """ZeroVelocity over the split in batches of 4 (the last padded), CMD,
    APDE (the shipped mmapd_GT.csv, cut alike) and FID; both loops' random
    GRU h0 of FID set to zeros, so that they draw the same."""
    jsk, sk = skeletons_of("h36m", 17, OBS, PRED)
    kw = dict(subjects=None, split="test", precomputed_folder=tree["pre"],
              segments_path=os.path.join(tree["ann"], "segments_test.csv"), obs_length=OBS,
              pred_length=PRED, if_consider_hip=False, if_load_mmgt=True, if_compute_cmd=True,
              silent=True)
    jds, ds = JaxH36MDataset(skeleton=jsk, **kw), H36MDataset(skeleton=sk, **kw)
    assert len(ds) == 9
    sd = _golden_classifier()
    clf = ClassifierForFID(input_size=sk.num_nodes * 3)
    clf.load_state_dict(port_classifier(sd))
    common = dict(batch_size=4, num_samples=3, if_compute_cmd=True, if_compute_apde=True,
                  mmapd_gt_path=os.path.join(tree["ann"], "mmapd_GT.csv"), silent=True)
    zeros = lambda key, shape, *a, **k: jax.numpy.zeros(shape)  # noqa: E731
    with mock.patch.object(jax.random, "normal", zeros):
        want = jax_compute_metrics(JaxZeroVelocity(jsk, 3, PRED), jds, jsk,
                                   fid_classifier_params={"params": jax_port_classifier(sd)},
                                   **common)
    with mock.patch.object(torch, "randn", lambda *s, **k: torch.zeros(*s, dtype=k.get("dtype"),
                                                                        device=k.get("device"))):
        got = compute_metrics(ZeroVelocityPredictor(sk, 3, PRED, device="cpu"), ds, sk,
                              fid_classifier=clf, **common)
    assert list(got) == list(want) and "FID" in got and "CMD" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_cli_with_h36m_equals_jax(tree, tmp_path):
    """ZeroVelocity through both eval CLIs with dataset=h36m (probabilistic,
    CMD and APDE as the config sets them)."""
    from skeletondiffusion_tpu.cli.eval import main as jax_eval

    args = ["dataset=h36m", "method_specs=zerovelocity_alg_baseline", "stats_mode=probabilistic",
            "batch_size=4", "num_samples=3", "device_mesh.n_devices=1",
            f"dataset_main_path={tree['root']}"]
    env = {"SKELDIFF_CONFIG_DIR": str(REPO / "configs" / "config_eval")}
    with mock.patch.dict(os.environ, env):
        want = jax_eval(args + [f"results_path={tmp_path / 'jax.yaml'}"])
        got = eval_cli.main(args + ["device=cpu", f"results_path={tmp_path / 'port.yaml'}"])
    assert list(got) == list(want) and "CMD" in got and "APDE" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
