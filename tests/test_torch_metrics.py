"""The port's metric suite (``skeletondiffusion_tpu_torch/metrics``) against the
JAX package's on the same numpy inputs from a seed, against the reference's
goldens (``metrics.npz`` as ``tests/test_metrics.py`` reads it,
``fid_classifier.npz`` as ``tests/test_fid.py`` does), and the suite's
wiring (stats modes, accumulators, padded batches).

Tolerance 1e-5 absolute plus 1e-6 relative (the values are O(1), MAE
O(10) degrees, the latent APD's L1 sums O(100)): float32 on both sides, sums
in another order.  The goldens keep their own tests'
tolerances."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu import metrics as jm
from skeletondiffusion_tpu.metrics import suite as jsuite
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch import metrics as tm
from skeletondiffusion_tpu_torch.metrics import suite as tsuite
from skeletondiffusion_tpu_torch.skeleton import create_skeleton

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
SKELETON_KW = dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
                   pose_box_size=1.5, obs_length=30, pred_length=120, if_consider_hip=False)
B, S, T, N = 4, 6, 10, 21
COUNTS = [3, 1, 5, 2]  # valid mm-GT futures per item; M = 5, so three items are padded


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    target = (0.3 * rng.standard_normal((B, T, N, 3))).astype(np.float32)
    pred = (target[:, None] + 0.1 * rng.standard_normal((B, S, T, N, 3))).astype(np.float32)
    M = max(COUNTS)
    mm = np.zeros((B, M, T, N, 3), np.float32)
    mask = np.zeros((B, M), bool)
    for i, c in enumerate(COUNTS):
        mm[i, :c] = target[i] + 0.1 * rng.standard_normal((c, T, N, 3))
        mask[i, :c] = True
    lat = rng.standard_normal((B, S, N, 8)).astype(np.float32)
    return {"pred": pred, "target": target, "mm": mm, "mask": mask, "lat": lat}


@pytest.fixture(scope="module")
def skeletons():
    return jax_create_skeleton(**SKELETON_KW), create_skeleton(**SKELETON_KW)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cases(sk):
    """name → a call of a metrics module (the JAX package's or the port's)
    on the data dict."""
    ls, la = sk.get_limbseq(), sk.limb_angles_idx
    return {
        "ade": (lambda f, d: f.ade(d["target"], d["pred"])),
        "ade_none": (lambda f, d: f.ade(d["target"], d["pred"], reduction="none")),
        "ade_window": (lambda f, d: f.ade(d["target"], d["pred"], t0=2, t=7)),
        "fde": (lambda f, d: f.fde(d["target"], d["pred"])),
        "fde_none": (lambda f, d: f.fde(d["target"], d["pred"], reduction="none")),
        "mpjpe": (lambda f, d: f.mpjpe(d["target"], d["pred"])),
        "mae": (lambda f, d: f.mae(d["target"], d["pred"], ls, la)),
        "apd": (lambda f, d: f.apd(d["pred"])),
        "apd_window": (lambda f, d: f.apd(d["pred"], t0=3, t=-1)),
        "apd_one_sample": (lambda f, d: f.apd(d["pred"][:, :1])),
        "mmade": (lambda f, d: f.mmade(d["target"], d["pred"], d["mm"], d["mask"])),
        "mmfde": (lambda f, d: f.mmfde(d["target"], d["pred"], d["mm"], d["mask"])),
        "lat_apd": (lambda f, d: f.lat_apd(d["lat"])),
        "motion_for_cmd": (lambda f, d: f.motion_for_cmd(d["pred"])),
        "best_sample_index": (lambda f, d: f.best_sample_index(d["pred"], d["target"])),
        "choose_best_sample": (lambda f, d: f.choose_best_sample(d["pred"], d["target"])),
        "limb_length_error": (lambda f, d: f.limb_length_error(d["target"], d["pred"], ls)),
        "limb_length_variance": (lambda f, d: f.limb_length_variance(d["pred"], ls)),
        "limb_length_jitter_max": (lambda f, d: f.limb_length_jitter(d["pred"], ls, mode="max")),
        "limb_length_variation_difference_wrtGT": (
            lambda f, d: f.limb_length_variation_difference_wrtGT(d["target"], d["pred"], ls)),
        "limb_stretching_normed_rmse": (
            lambda f, d: f.limb_stretching_normed_rmse(d["pred"], d["target"], ls)),
        "limb_stretching_normed_mean": (
            lambda f, d: f.limb_stretching_normed_mean(d["pred"], d["target"], ls)),
        "limb_jitter_normed_rmse": (
            lambda f, d: f.limb_jitter_normed_rmse(d["pred"], d["target"], ls)),
        "limb_jitter_normed_mean": (
            lambda f, d: f.limb_jitter_normed_mean(d["pred"], d["target"], ls)),
    }


CASES = list(_cases(jax_create_skeleton(**SKELETON_KW)))


@pytest.mark.parametrize("name", CASES)
def test_metric_matches_jax(name, data, skeletons):
    jsk, sk = skeletons
    call = _cases(sk)[name]
    want = np.asarray(call(jm, {k: jnp.asarray(v) for k, v in data.items()}))
    got = call(tm, {k: _t(v) for k, v in data.items()}).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    if name == "best_sample_index":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_apd_at_fifty_samples_matches_jax():
    """APD over 50 samples of offset poses: the JAX Gram expansion centres
    per item first, the port takes exact differences; both ≈ the float64
    distances."""
    rng = np.random.default_rng(1)
    pred = (1.5 + 0.2 * rng.standard_normal((3, 50, 12, N, 3))).astype(np.float32)
    want = np.asarray(jm.apd(jnp.asarray(pred)))
    got = tm.apd(_t(pred)).numpy()
    flat = pred.reshape(3, 50, -1).astype(np.float64)
    d = np.linalg.norm(flat[:, :, None] - flat[:, None], axis=-1)
    iu = np.triu_indices(50, k=1)
    exact = d[:, iu[0], iu[1]].mean(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, exact, rtol=1e-6)


def test_mm_metrics_chunk_over_items(data, monkeypatch):
    """MMADE's cdist runs in chunks of items when the [B·T, S, M] output
    exceeds its budget: the same values as one chunk."""
    from skeletondiffusion_tpu_torch.metrics import multimodal

    args = [_t(data[k]) for k in ("target", "pred", "mm", "mask")]
    whole = multimodal.mmade(*args)
    monkeypatch.setattr(multimodal, "_CDIST_CHUNK", 1)
    torch.testing.assert_close(multimodal.mmade(*args), whole, rtol=0, atol=0)


def test_metrics_golden(skeletons):
    """The port against the reference's values, at ``tests/test_metrics.py``'s
    tolerances."""
    _, sk = skeletons
    g = np.load(os.path.join(GOLDENS, "metrics.npz"))
    pred, targ = _t(g["pred"]), _t(g["target"])
    ls = sk.get_limbseq()
    counts, flat = g["mm_counts"], g["mm_flat"]
    mm = np.zeros((len(counts), counts.max(), *flat.shape[1:]), np.float32)
    mask = np.zeros((len(counts), counts.max()), bool)
    off = 0
    for i, c in enumerate(counts):
        mm[i, :c], mask[i, :c] = flat[off:off + c], True
        off += c
    Bg, Sg = g["pred"].shape[:2]
    checks = [
        (tm.ade(targ, pred), "ade", 1e-5), (tm.fde(targ, pred), "fde", 1e-5),
        (tm.apd(pred), "apd", 1e-4), (tm.mpjpe(targ, pred), "mpjpe", 1e-5),
        (tm.mae(targ, pred, ls, sk.limb_angles_idx), "mae", 1e-3),
        (tm.mmade(targ, pred, _t(mm), _t(mask)), "mmade", 1e-5),
        (tm.mmfde(targ, pred, _t(mm), _t(mask)), "mmfde", 1e-5),
        (tm.limb_stretching_normed_mean(pred, targ, ls), "stretch_mean", 1e-5),
        (tm.limb_stretching_normed_rmse(pred, targ, ls), "stretch_rmse", 1e-5),
        (tm.limb_jitter_normed_mean(pred, targ, ls), "jitter_mean", 1e-5),
        (tm.limb_jitter_normed_rmse(pred, targ, ls), "jitter_rmse", 1e-5),
        (tm.limb_length_error(targ, pred, ls), "limb_err", 1e-5),
        (tm.limb_length_variance(pred, ls), "limb_var", 1e-5),
    ]
    for got, key, atol in checks:
        np.testing.assert_allclose(got.numpy(), g[key], atol=atol, err_msg=key)
    np.testing.assert_allclose(tm.lat_apd(pred.reshape(Bg, Sg, -1)).numpy(), g["lat_apd"],
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["deterministic", "probabilistic", "probabilistic_orig"])
def test_stats_modes_names_and_order(mode, skeletons):
    jsk, sk = skeletons
    assert list(tsuite.get_stats_funcs(mode, sk)) == list(jsuite.get_stats_funcs(mode, jsk))


def _apde_csv(path, values, index_column: bool):
    with open(path, "w") as fh:
        fh.write(",gt_APD\n" if index_column else "id,gt_APD\n")
        fh.writelines(f"{i},{v!r}\n" for i, v in enumerate(values))


@pytest.mark.parametrize("mode", ["deterministic", "probabilistic", "probabilistic_orig"])
def test_suite_matches_jax_over_padded_batches(mode, data, skeletons, tmp_path):
    """Two batches through ``MetricSuite`` (the second padded: its last item
    masked out by ``count``), with CMD and APDE: the same table."""
    jsk, sk = skeletons
    apde_path = tmp_path / "mmapd_GT.csv"
    _apde_csv(apde_path, [0.5, 0.0, 0.7, 0.2, 0.9, 1.1, 0.3], index_column=(mode == "deterministic"))
    kw = dict(stats_mode=mode, if_compute_cmd=True, mean_motion_per_class=[0.01, 0.02, 0.03],
              if_compute_apde=True, mmapd_gt_path=str(apde_path))
    suites = {"jax": jsuite.MetricSuite(skeleton=jsk, **kw),
              "port": tsuite.MetricSuite(skeleton=sk, **kw)}
    classes = np.array([0, 2, 1, 2])
    for count in (B, B - 1):
        for name, suite in suites.items():
            conv = jnp.asarray if name == "jax" else _t
            vals = suite.compute_batch(conv(data["pred"]), conv(data["target"]),
                                       mm_gt=conv(data["mm"]), mm_mask=conv(data["mask"]))
            suite.update(vals, class_idxs=classes[:count], count=count)
    want, got = suites["jax"].compute(), suites["port"].compute()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert tsuite.draw_table(got).splitlines()[0] == jsuite.draw_table(want).splitlines()[0]


def test_accumulators_and_tables_match_jax(tmp_path):
    from skeletondiffusion_tpu.metrics import accumulators as ja
    from skeletondiffusion_tpu.metrics import ranking as jr
    from skeletondiffusion_tpu.metrics import tables as jt
    from skeletondiffusion_tpu_torch.metrics import accumulators as ta
    from skeletondiffusion_tpu_torch.metrics import ranking as tr
    from skeletondiffusion_tpu_torch.metrics import tables as tt

    rng = np.random.default_rng(2)
    path = tmp_path / "apd.csv"
    _apde_csv(path, [0.3, 0.0, 1.25], index_column=True)
    for cls in (ja.APDEAccumulator, ta.APDEAccumulator):
        np.testing.assert_array_equal(cls.from_csv(str(path)).mmapd_gt,
                                      ja.APDEAccumulator.from_csv(str(path)).mmapd_gt)
    y, p = rng.standard_normal((2, 5, 40, 4, 3))
    tabs = [(mod.MeanPerJointPositionErrorTable(), mod.FinalDisplacementErrorMeter())
            for mod in (jt, tt)]
    for tab, fde in tabs:
        tab.update(p, y)
        fde.update(p, y)
    np.testing.assert_array_equal(tabs[0][0].compute(), tabs[1][0].compute())
    assert tabs[0][1].compute() == tabs[1][1].compute()
    pred, target = rng.standard_normal((6, 5, 4, 3)), rng.standard_normal((5, 4, 3))
    for a, b in zip(jr.get_closest_and_nfurthest_maxapd(pred, target, 3),
                    tr.get_closest_and_nfurthest_maxapd(pred, target, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def fid_golden():
    return np.load(os.path.join(GOLDENS, "fid_classifier.npz"))


def test_fid_classifier_matches_reference(fid_golden):
    """``port_classifier`` of the reference weights, zero h0: the reference's
    features and logits (``tests/test_fid.py``'s tolerance)."""
    g = fid_golden
    clf = tm.ClassifierForFID()
    clf.load_state_dict(tm.port_classifier({k: g[k] for k in g.files}), strict=True)
    motion = _t(g["motion"])
    h0 = torch.zeros(2, motion.shape[0], 128)
    with torch.no_grad():
        np.testing.assert_allclose(clf.get_fid_features(motion, h0).numpy(), g["feats"],
                                   atol=1e-4)
        np.testing.assert_allclose(clf(motion, h0).numpy(), g["logits"], atol=1e-4)


def test_fid_classifier_matches_jax_with_random_h0(fid_golden):
    from skeletondiffusion_tpu.metrics.fid import ClassifierForFID, port_classifier

    g = fid_golden
    sd = {k: g[k] for k in g.files if k not in ("motion", "feats", "logits")}
    rng = np.random.default_rng(3)
    motion = rng.standard_normal((5, 48, 20)).astype(np.float32)
    h0 = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = ClassifierForFID().apply({"params": port_classifier(sd)}, jnp.asarray(motion),
                                    jnp.asarray(h0), method=ClassifierForFID.get_fid_features)
    clf = tm.ClassifierForFID()
    clf.load_state_dict(tm.port_classifier(sd))
    with torch.no_grad():
        got = clf.get_fid_features(_t(motion), _t(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((300, 8))
    b = rng.standard_normal((300, 8)) + 0.5
    assert tm.fid_from_activations(a, b) == jm.fid_from_activations(a, b)
    assert tm.fid_from_activations(a, a) == pytest.approx(0.0, abs=1e-6)
