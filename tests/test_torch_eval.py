"""The port's eval loop (``skeletondiffusion_tpu_torch/eval_pipeline.py``) on
the CPU: the long-term helpers against the reference's ``longterm.npz`` (as
``tests/test_long_term.py`` holds the JAX ones), ``compute_metrics`` with
``ZeroVelocityPredictor`` against the JAX ``compute_metrics`` on the same
synthetic tree, and the capstone: the port rebuilds ``capstone.npz``'s
on-disk files, carries its weights across (the JAX package's
``utils/torch_port.py``, then the port's weight bridge), rebuilds the process
from its eigensystem, injects its recorded noise, and matches its per-batch
metric-space predictions and its 12-metric table at
``tests/test_capstone_parity.py``'s tolerances (rtol 1e-5, atol 1e-6)."""
import csv
import json
import os

import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.data.loaders import AMASSDataset as JaxAMASSDataset
from skeletondiffusion_tpu.data.synthetic import make_synthetic_amass as jax_make_synthetic
from skeletondiffusion_tpu.eval_pipeline import ZeroVelocityPredictor as JaxZeroVelocity
from skeletondiffusion_tpu.eval_pipeline import compute_metrics as jax_compute_metrics
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch.data import AMASSDataset, preprocess_batch
from skeletondiffusion_tpu_torch.data.batch import DataLoader
from skeletondiffusion_tpu_torch.eval_pipeline import (
    SkeletonDiffusionPredictor,
    ZeroVelocityPredictor,
    compute_metrics,
    long_term_prediction_best_every50,
    long_term_prediction_best_first50,
    process_evaluation_pair,
)
from skeletondiffusion_tpu_torch.skeleton import create_skeleton

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
STRATEGIES = {"best_every50": long_term_prediction_best_every50,
              "best_first50": long_term_prediction_best_first50}


# ---------------------------------------------------------------------------
# Long-term helpers against the reference's golden
# ---------------------------------------------------------------------------

def make_fake_predictor(offsets, vel_scale_step, default_samples):
    """Torch twin of ``make_longterm_golden.py::fake_get_prediction``."""
    offsets = torch.as_tensor(offsets)

    def predictor(generator, obs, num_samples=None, pred_length=None):
        S = num_samples or default_samples
        vel = obs[:, -1] - obs[:, -2]
        last = obs[:, -1]
        t = torch.arange(1, pred_length + 1, dtype=obs.dtype)
        scale = 1.0 + vel_scale_step * torch.arange(S, dtype=obs.dtype)
        pred = (last[:, None, None] + vel[:, None, None] * t[None, None, :, None, None]
                * scale[None, :, None, None, None] + offsets[None, :S, None])
        return pred, None

    return predictor


@pytest.fixture(scope="module")
def longterm():
    return np.load(os.path.join(GOLDENS, "longterm.npz"))


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("refeed", ["input", "metric"])
def test_long_term_matches_reference(longterm, strategy, refeed):
    """``input`` under CenterPose (where it equals the reference's re-feed),
    ``metric`` under RescalePose (the reference's exact semantics, where the
    box bites), at factor 2.5."""
    g = longterm
    pred_length, factor = int(g["pred_length"]), float(g["factor"])
    obs, target, offsets = (g[k][..., 1:, :] for k in ("obs", "target", "offsets"))
    suffix = {"best_every50": "every", "best_first50": "first"}[strategy]
    suffix += "" if refeed == "input" else "_rescale"
    kw = dict(dataset_name="amass", num_joints=22, obs_length=obs.shape[1],
              pred_length=pred_length, if_consider_hip=False)
    if refeed == "input":
        sk = create_skeleton(motion_repr_type="SkeletonCenterPose", **kw)
    else:
        sk = create_skeleton(motion_repr_type="SkeletonRescalePose", pose_box_size=float(g["box"]),
                             **kw)
    S = g[f"pred_{suffix}"].shape[1]
    predictor = make_fake_predictor(offsets, float(g["vel_scale_step"]), S)
    target_m, pred_m = STRATEGIES[strategy](
        predictor, sk, None, torch.from_numpy(obs), torch.from_numpy(target), num_samples=S,
        pred_length=pred_length, long_term_factor=factor, refeed_space=refeed)
    np.testing.assert_allclose(target_m.numpy(), g[f"target_{suffix}"], atol=1e-6)
    np.testing.assert_allclose(pred_m.numpy(), g[f"pred_{suffix}"], atol=1e-5)
    if refeed == "metric":
        # the default input-space re-feed must NOT reproduce the reference's
        # inflated RescalePose chain
        _, pred_in = STRATEGIES[strategy](
            predictor, sk, None, torch.from_numpy(obs), torch.from_numpy(target),
            num_samples=S, pred_length=pred_length, long_term_factor=factor)
        assert not np.allclose(pred_in.numpy(), g[f"pred_{suffix}"], atol=1e-4)


# ---------------------------------------------------------------------------
# compute_metrics against the JAX loop
# ---------------------------------------------------------------------------

OBS, PRED = 6, 15
SK_KW = dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
             pose_box_size=1.1, obs_length=OBS, pred_length=PRED, if_consider_hip=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = jax_make_synthetic(str(tmp_path_factory.mktemp("eval_tree")), seed=2,
                              files_per_dataset=3, clip_len=75)
    return {"pre": os.path.join(root, "processed/AMASS/hmp/"),
            "ann": os.path.join(root, "annotations/AMASS/hmp/")}


def _datasets(tree, **extra):
    kw = dict(datasets=["DFaust"], split="test", precomputed_folder=tree["pre"],
              segments_path=tree["ann"] + "segments_test.csv", obs_length=OBS,
              pred_length=PRED, if_consider_hip=False, if_load_mmgt=True, if_compute_cmd=True,
              silent=True, **extra)
    jsk, sk = jax_create_skeleton(**SK_KW), create_skeleton(**SK_KW)
    return JaxAMASSDataset(skeleton=jsk, **kw), AMASSDataset(skeleton=sk, **kw), jsk, sk


CASES = {
    "probabilistic": dict(stats_mode="probabilistic"),
    "deterministic": dict(stats_mode="deterministic"),
    "long_term_every50": dict(if_long_term_test=True, long_term_factor=2.0, pred_length=PRED),
    "long_term_first50_metric": dict(if_long_term_test=True, long_term_factor=2.0,
                                     pred_length=PRED, long_term_strategy="best_first50",
                                     long_term_refeed_space="metric"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_zero_velocity_compute_metrics_matches_jax(case, tree):
    """Batches of 4, the last one padded, CMD and APDE on; the long-term
    cases read twice the horizon (the mm-GT futures are that long too)."""
    extra = {"extended_pred_length": 2 * PRED} if case.startswith("long_term") else {}
    jds, ds, jsk, sk = _datasets(tree, **extra)
    assert len(ds) % 4 != 0
    kw = dict(batch_size=4, num_samples=3, if_compute_cmd=True, if_compute_apde=True,
              mmapd_gt_path=tree["ann"] + "mmapd_GT.csv", silent=True, **CASES[case])
    want = jax_compute_metrics(JaxZeroVelocity(jsk, 3, PRED), jds, jsk, **kw)
    got = compute_metrics(ZeroVelocityPredictor(sk, 3, PRED, device="cpu"), ds, sk, **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_pipelined_and_synchronous_drains_agree_and_noise_is_seeded(tree, monkeypatch):
    _, ds, _, sk = _datasets(tree)
    kw = dict(batch_size=4, num_samples=3, silent=True, if_noisy_obs=True, noise_level=0.5)
    zv = ZeroVelocityPredictor(sk, 3, PRED, device="cpu")
    from skeletondiffusion_tpu_torch.utils.logging import AverageTimer

    timer = AverageTimer()
    pipelined = compute_metrics(zv, ds, sk, seed=1, timer=timer, **kw)
    assert timer.summary()["n"] == -(-len(ds) // 4) + 1  # the batches and the trailing drain
    monkeypatch.setenv("SKELDIFF_EVAL_PIPELINE", "0")
    assert compute_metrics(zv, ds, sk, seed=1, **kw) == pipelined
    assert compute_metrics(zv, ds, sk, seed=2, **kw) != pipelined
    assert compute_metrics(zv, ds, sk, seed=1, **{**kw, "if_noisy_obs": False}) != pipelined


def test_store_receives_the_real_rows_in_metric_space(tree):
    """``store`` gets each batch's metric-space predictions, observations
    and targets, the padded last batch cut to its real rows."""
    _, ds, _, sk = _datasets(tree)

    class Store:
        def __init__(self):
            self.rows = []

        def append(self, pred, obs, target):
            self.rows.append((pred, obs, target))

    store = Store()
    compute_metrics(ZeroVelocityPredictor(sk, 3, PRED, device="cpu"), ds, sk, batch_size=4,
                    num_samples=3, silent=True, store=store)
    pred, obs, target = (np.concatenate(parts) for parts in zip(*store.rows))
    assert pred.shape == (len(ds), 3, PRED, 21, 3) and obs.shape == (len(ds), OBS, 21, 3)
    assert target.shape == (len(ds), PRED, 21, 3)
    # ZeroVelocity repeats the last observed frame; metric space = input × box
    np.testing.assert_allclose(pred[:, 1, 4], obs[:, -1], rtol=0, atol=1e-6)
    raw = np.stack([ds[i][1] for i in range(len(ds))])
    np.testing.assert_allclose(target, raw[:, :, 1:] - raw[:, :, :1], rtol=0, atol=1e-5)


def test_fid_hook_and_refusals(tree):
    from skeletondiffusion_tpu_torch.metrics import ClassifierForFID

    _, ds, _, sk = _datasets(tree)
    torch.manual_seed(0)
    clf = ClassifierForFID(input_size=sk.num_nodes * 3)
    zv = ZeroVelocityPredictor(sk, 3, PRED, device="cpu")
    kw = dict(batch_size=4, num_samples=3, silent=True, fid_classifier=clf)
    first = compute_metrics(zv, ds, sk, **kw)
    assert np.isfinite(first["FID"]) and compute_metrics(zv, ds, sk, **kw) == first
    with pytest.raises(NotImplementedError, match="mesh"):
        compute_metrics(zv, ds, sk, batch_size=4, mesh=object())
    with pytest.raises(ValueError, match="pred_length"):
        compute_metrics(zv, ds, sk, batch_size=4, pred_length=PRED + 1)


# ---------------------------------------------------------------------------
# The capstone golden
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "capstone.npz"), allow_pickle=False)


@pytest.fixture(scope="module")
def cfg(golden):
    return json.loads(str(golden["config_json"]))


@pytest.fixture(scope="module")
def capstone_root(golden, cfg, tmp_path_factory):
    """The reference's on-disk dataset files, rebuilt with the port's means."""
    from skeletondiffusion_tpu_torch.data.mmgt import save_mmgt

    root = tmp_path_factory.mktemp("capstone_root")
    data = {}
    for cls in cfg["classes"]:
        data[cls] = {}
        while f"raw_{cls}_{len(data[cls])}" in golden.files:
            data[cls][len(data[cls])] = golden[f"raw_{cls}_{len(data[cls])}"]
    np.savez(root / "data_3d_amass.npz", positions_3d=data)
    with open(root / "segments_test.csv", "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["dataset", "file", "file_idx", "pred_init", "pred_end"])
        writer.writerows(json.loads(str(golden["segments_csv"])))
    with open(root / "mean_motion_test.txt", "w") as fh:
        fh.write("\n".join(f"{c},{m},{f}" for c, m, f in zip(
            cfg["classes"], golden["mean_motions"], golden["mean_motion_freqs"])))
    save_mmgt({int(k): v for k, v in json.loads(str(golden["mmgt_json"])).items()},
              str(root / "mmgt_test.txt"))
    with open(root / "mmapd_GT.csv", "w") as fh:
        fh.write(",gt_APD\n" + "".join(f"{i},{v!r}\n" for i, v in enumerate(
            golden["mmapd_gt"].tolist())))
    return root


@pytest.fixture(scope="module")
def capstone(golden, cfg, capstone_root):
    """(skeleton, dataset, predictor) of the golden: weights from its
    reference state_dicts, the process from its eigensystem."""
    from skeletondiffusion_tpu.utils.torch_port import port_autoencoder, port_denoiser
    from skeletondiffusion_tpu_torch.diffusion.engine import GaussianDiffusion
    from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
    from skeletondiffusion_tpu_torch.diffusion.process import build_nonisotropic_process
    from skeletondiffusion_tpu_torch.models import AutoEncoder
    from skeletondiffusion_tpu_torch.weights import load_autoencoder_params, load_denoiser_params

    sk = create_skeleton(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                         num_joints=cfg["num_joints"], pose_box_size=cfg["pose_box"],
                         obs_length=cfg["obs"], pred_length=cfg["pred"], if_consider_hip=False)
    ds = AMASSDataset(datasets=cfg["classes"], split="test",
                      segments_path=str(capstone_root / "segments_test.csv"),
                      precomputed_folder=str(capstone_root), skeleton=sk,
                      obs_length=cfg["obs"], pred_length=cfg["pred"], if_consider_hip=False,
                      if_load_mmgt=True, if_compute_cmd=True, silent=True)
    gen = torch.Generator().manual_seed(0)
    ae = AutoEncoder(sk.num_nodes, cfg["hidden"], cfg["hidden"], cfg["latent"], gen,
                     node_types=sk.nodes_type_id)
    load_autoencoder_params(ae, port_autoencoder(
        {k[3:]: golden[k] for k in golden.files if k.startswith("ae.")}))
    _, den = create_diffusion(
        sk, gen, latent_size=cfg["latent"], diffusion_timesteps=cfg["t_diff"], device="cpu",
        diffusion_arch={"use_attention": True, "self_condition": False, "norm_type": "none",
                        "depth": 2, "attn_dim_head": 8, "attn_heads": 2,
                        "learn_influence": True})
    load_denoiser_params(den, port_denoiser(
        {k[4:]: golden[k] for k in golden.files if k.startswith("den.")}, depth=2))
    # the reference's eigenvectors: U is unique only up to column signs, and
    # the injected noise is expressed in U's basis
    process = build_nonisotropic_process(
        golden["cov_Sigma_N"], golden["cov_Lambda_N"], golden["cov_U"],
        timesteps=cfg["t_diff"], device="cpu")
    engine = GaussianDiffusion(process, den, channels=sk.num_nodes, latent_size=cfg["latent"])
    predictor = SkeletonDiffusionPredictor(sk, ae, engine, num_samples=cfg["samples"],
                                           pred_length=cfg["pred"], device="cpu")
    return sk, ds, predictor


class NoiseInjecting:
    """The golden's recorded start and step noise, batch by batch; pad rows
    of the padded last batch get repeated noise rows (their outputs are
    masked out of every accumulator)."""

    def __init__(self, predictor, golden):
        self.predictor, self.golden = predictor, golden
        self.device, self.pred_length = predictor.device, predictor.pred_length
        self.calls = 0

    def __call__(self, generator, obs, num_samples=None, pred_length=None):
        rows = obs.shape[0] * num_samples
        noise = []
        for key in ("start_noise", "samp_noise"):
            a = self.golden[f"{key}_{self.calls}"]
            noise.append(torch.from_numpy(np.resize(a, (rows, *a.shape[1:]))))
        self.calls += 1
        return self.predictor(None, obs, num_samples=num_samples, pred_length=pred_length,
                              start_noise=noise[0], step_noise=noise[1])


def test_capstone_segments_and_batches(capstone, golden, cfg):
    sk, ds, _ = capstone
    assert len(ds) == len(json.loads(str(golden["segments_csv"])))
    assert ds.mm_indces == {int(k): list(v)
                            for k, v in json.loads(str(golden["mmgt_json"])).items()}
    batches = list(DataLoader(ds, batch_size=cfg["batch"]))
    assert len(batches) == int(golden["n_batches"])
    for b_i, batch in enumerate(batches):
        obs, target, _ = preprocess_batch(sk, None, torch.from_numpy(batch["obs"]),
                                          torch.from_numpy(batch["pred"]), train=False)
        np.testing.assert_allclose(obs.numpy(), golden[f"obs_{b_i}"], atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(target.numpy(), golden[f"target_{b_i}"], atol=1e-6,
                                   rtol=1e-5)


def test_capstone_predictions_per_batch(capstone, golden, cfg):
    sk, ds, predictor = capstone
    inj = NoiseInjecting(predictor, golden)
    for b_i, batch in enumerate(DataLoader(ds, batch_size=cfg["batch"])):
        obs, target, _ = preprocess_batch(sk, None, torch.from_numpy(batch["obs"]),
                                          torch.from_numpy(batch["pred"]), train=False)
        pred, _ = inj(None, obs, num_samples=cfg["samples"])
        target_m, pred_m, _, _ = process_evaluation_pair(sk, target, pred, obs)
        np.testing.assert_allclose(target_m.numpy(), golden[f"target_m_{b_i}"], atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(pred_m.numpy(), golden[f"pred_m_{b_i}"], atol=1e-6,
                                   rtol=1e-5)


def test_capstone_metric_table(capstone, golden, cfg, capstone_root):
    sk, ds, predictor = capstone
    results = compute_metrics(
        NoiseInjecting(predictor, golden), ds, sk, batch_size=cfg["batch"],
        num_samples=cfg["samples"], stats_mode="probabilistic", seed=0, if_compute_cmd=True,
        if_compute_apde=True, mmapd_gt_path=str(capstone_root / "mmapd_GT.csv"), silent=True)
    ref = json.loads(str(golden["results_json"]))
    assert set(ref) <= set(results)
    for name, want in ref.items():
        np.testing.assert_allclose(results[name], want, rtol=1e-5, atol=1e-6, err_msg=name)
