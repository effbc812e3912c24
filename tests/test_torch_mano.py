"""AMASS-MANO (52 joints, 51 nodes without the hip) on the CPU against the
JAX package and ``tests/goldens/skeleton_tables.npz`` (``amass52_*``): every
kinematic table exact, the node graph, limb lengths, the input- and
metric-space transforms (atol 2e-5), the 51-node adjacency and reachability
covariances (exact), the synthetic trees both generators write at 52 joints
from one seed (same arrays and files), ``AMASSDataset`` on the shipped
``AMASS-MANO/hmp`` annotations (cut, random-walk clips) against the JAX
loader, and the metric suite at 52 joints (1e-5 abs + 1e-6 rel)."""
import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu import metrics as jm
from skeletondiffusion_tpu.data.loaders import AMASSDataset as JaxAMASSDataset
from skeletondiffusion_tpu.data.synthetic import make_synthetic_amass as jax_make_synthetic
from skeletondiffusion_tpu.diffusion import covariance as jax_cov
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch import metrics as tm
from skeletondiffusion_tpu_torch.data.loaders import AMASSDataset
from skeletondiffusion_tpu_torch.data.synthetic import (
    make_synthetic_amass,
    make_synthetic_skeleton_tree,
)
from skeletondiffusion_tpu_torch.diffusion import covariance
from skeletondiffusion_tpu_torch.skeleton import create_skeleton

from test_torch_skeletons import TABLES, _table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = np.load(os.path.join(REPO, "tests", "goldens", "skeleton_tables.npz"))
ANN = os.path.join(REPO, "datasets", "annotations", "AMASS-MANO", "hmp")
OBS, PRED = 30, 120  # the hmp task at 60 fps: 0.5 s observed, 2 s predicted


def _kw(obs=OBS, pred=PRED, dataset="amass-mano"):
    return dict(dataset_name=dataset, motion_repr_type="SkeletonRescalePose", num_joints=52,
                pose_box_size=1.5, obs_length=obs, pred_length=pred, if_consider_hip=False)


@pytest.fixture(scope="module")
def skeletons():
    return create_skeleton(**_kw()), jax_create_skeleton(**_kw())


@pytest.mark.parametrize("table", TABLES)
def test_kinematic_tables_match_the_goldens_and_jax(skeletons, table):
    sk, jsk = skeletons
    got, jax_got = _table(sk, table), _table(jsk, table)
    if table == "limb_angles_idx":
        assert got == jax_got == json.loads(str(GOLD["amass52_limb_angles_idx"]))
    else:
        np.testing.assert_array_equal(got, GOLD[f"amass52_{table}"])
        np.testing.assert_array_equal(got, jax_got)


def test_node_graph_parents_and_hands_match_jax(skeletons):
    sk, jsk = skeletons
    assert sk.num_nodes == 51 and sk.num_joints == 52
    assert sk.joint_dict_orig == jsk.joint_dict_orig
    assert sk.node_dict == jsk.node_dict
    assert sk.node_limbseq == jsk.node_limbseq
    assert sk.parents() == jsk.parents()
    assert sk.parents("nodes") == jsk.parents("nodes")
    assert sk.left_right_limb_nodes == jsk.left_right_limb_nodes
    # "amass" with 52 joints is the same body, as in JAX
    np.testing.assert_array_equal(create_skeleton(**_kw(dataset="amass")).adj_matrix,
                                  sk.adj_matrix)


def test_limb_lengths_and_transforms_match_jax(skeletons):
    sk, jsk = skeletons
    rng = np.random.default_rng(52)
    kpts = rng.standard_normal((2, 4, 52, 3)).astype(np.float32)
    for mode in ("metric", "nodes"):
        np.testing.assert_allclose(
            sk.extract_limb_length(torch.from_numpy(kpts), mode).numpy(),
            np.asarray(jsk.extract_limb_length(jnp.asarray(kpts), mode)), rtol=1e-6, atol=0)
    seg = rng.standard_normal((2, OBS + PRED, 52, 3)).astype(np.float32)
    np.testing.assert_allclose(sk.tranform_to_input_space(torch.from_numpy(seg)).numpy(),
                               np.asarray(jsk.tranform_to_input_space(jnp.asarray(seg))),
                               rtol=0, atol=2e-5)
    for frames in (OBS, PRED):
        x = rng.standard_normal((2, frames, 51, 3)).astype(np.float32)
        np.testing.assert_allclose(
            sk.transform_to_metric_space(torch.from_numpy(x)).numpy(),
            np.asarray(jsk.transform_to_metric_space(jnp.asarray(x))), rtol=0, atol=2e-5)


@pytest.mark.parametrize("kind", ["adjacency", "reachability"])
def test_covariance_at_51_nodes_matches_jax(skeletons, kind):
    """Σ_N, Λ_N and U of the 51-node covariances equal the JAX package's, on
    the golden tables as the diffusion builds them."""
    sk, _ = skeletons
    corr = GOLD["amass52_adj"] if kind == "adjacency" else sk.reachability_matrix(0.5, 0)
    got = covariance.get_cov_from_corr(corr)
    want = jax_cov.get_cov_from_corr(corr)
    assert got[0].shape == (51, 51)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_trees_at_52_joints_equal(tmp_path):
    kw = dict(num_joints=52, dataset_name="amass-mano", dataset_dir="AMASS-MANO",
              train_datasets=("ACCAD",), test_datasets=("DFaust",), segment_stride=12, seed=5)
    roots = [fn(str(tmp_path / name), **kw)
             for name, fn in (("jax", jax_make_synthetic), ("port", make_synthetic_amass))]
    npz = "processed/AMASS-MANO/hmp/data_3d_amass.npz"
    arrays = [np.load(os.path.join(r, npz), allow_pickle=True)["positions_3d"].item()
              for r in roots]
    for ds in arrays[0]:
        for fi in arrays[0][ds]:
            assert arrays[0][ds][fi].shape[1] == 52
            np.testing.assert_array_equal(arrays[1][ds][fi], arrays[0][ds][fi])
    for rel in ("processed/AMASS-MANO/hmp/mmgt_test.txt",
                "annotations/AMASS-MANO/hmp/segments_test.csv",
                "annotations/AMASS-MANO/hmp/mmapd_GT.csv"):
        jax_path, port_path = (os.path.join(r, rel) for r in roots)
        if rel.endswith(".txt"):
            parse = lambda p: ast.literal_eval(json.load(open(p)))  # noqa: E731
            assert parse(port_path) == parse(jax_path)
        else:
            assert open(port_path).read() == open(jax_path).read()


@pytest.fixture(scope="module")
def shipped_tree(tmp_path_factory):
    """The port's tree on the shipped AMASS-MANO annotations, each CSV cut
    to its first 24 segments."""
    return make_synthetic_skeleton_tree(str(tmp_path_factory.mktemp("mano")), "amass-mano", ANN,
                                        obs_length=OBS, pred_length=PRED, max_segments=24)


def test_amass_dataset_on_the_shipped_annotations_matches_jax(shipped_tree):
    pre = os.path.join(shipped_tree, "processed", "AMASS-MANO", "hmp") + "/"
    csv_path = os.path.join(shipped_tree, "annotations", "AMASS-MANO", "hmp", "segments_test.csv")
    kw = dict(datasets=["Transitions"], split="test", precomputed_folder=pre,
              segments_path=csv_path, obs_length=OBS, pred_length=PRED, if_consider_hip=False,
              if_load_mmgt=True, if_compute_cmd=True, silent=True)
    ds = AMASSDataset(skeleton=create_skeleton(**_kw()), **kw)
    jds = JaxAMASSDataset(skeleton=jax_create_skeleton(**_kw()), **kw)
    assert len(ds) == len(jds) == 24
    assert ds.segments == jds.segments
    assert ds.segment_idx_to_metadata == jds.segment_idx_to_metadata
    assert ds.mm_indces == jds.mm_indces
    np.testing.assert_allclose(ds.mean_motion_per_class, jds.mean_motion_per_class,
                               rtol=0, atol=1e-6)
    for i in (0, len(ds) - 1):
        (o, p, e), (jo, jp, je) = ds[i], jds[i]
        assert o.shape == (OBS, 52, 3) and p.shape == (PRED, 52, 3)
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(p, jp)
        assert e["metadata"] == je["metadata"]
    # the tree's mm-GT APDs, one a segment (AMASS-MANO ships no mmapd_GT.csv)
    mmapd = os.path.join(shipped_tree, "annotations", "AMASS-MANO", "hmp", "mmapd_GT.csv")
    assert len(open(mmapd).read().splitlines()) == 1 + 24


def test_metric_suite_at_52_joints_matches_jax(skeletons):
    """The metrics on metric-space poses of the 51 nodes: displacement,
    diversity, multimodal, limb-length and limb-angle (the body's groups)."""
    sk, jsk = skeletons
    rng = np.random.default_rng(7)
    b, s, t, n = 3, 5, 10, 51
    target = (0.3 * rng.standard_normal((b, t, n, 3))).astype(np.float32)
    pred = (target[:, None] + 0.1 * rng.standard_normal((b, s, t, n, 3))).astype(np.float32)
    mm = (target[:, None] + 0.1 * rng.standard_normal((b, 4, t, n, 3))).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]], bool)
    ls, la = sk.get_limbseq(), sk.limb_angles_idx
    np.testing.assert_array_equal(ls, jsk.get_limbseq())
    assert la == jsk.limb_angles_idx
    calls = {
        "ade": lambda f, d: f.ade(d[1], d[0]),
        "fde": lambda f, d: f.fde(d[1], d[0]),
        "mae": lambda f, d: f.mae(d[1], d[0], ls, la),
        "apd": lambda f, d: f.apd(d[0]),
        "mmade": lambda f, d: f.mmade(d[1], d[0], d[2], d[3]),
        "mmfde": lambda f, d: f.mmfde(d[1], d[0], d[2], d[3]),
        "stretch_mean": lambda f, d: f.limb_stretching_normed_mean(d[0], d[1], ls),
        "jitter_rmse": lambda f, d: f.limb_jitter_normed_rmse(d[0], d[1], ls),
        "cmd_motion": lambda f, d: f.motion_for_cmd(d[0]),
    }
    data = (pred, target, mm, mask)
    for name, call in calls.items():
        want = np.asarray(call(jm, tuple(jnp.asarray(x) for x in data)))
        got = call(tm, tuple(torch.from_numpy(x) for x in data)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=name)
