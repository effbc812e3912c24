"""The port's Human3.6M (17 joints → 16 nodes, and the 25-joint hip-kept
variant), FreeMan (18 → 17) and 3DPW zero-shot (the AMASS body, 22 → 21)
skeletons against the JAX package and ``tests/goldens/skeleton_tables.npz``:
every kinematic table exact, the 16- and 17-node covariances (and
``cov_toy16.npz``), the DCT representation; AMASS-MANO's 51 nodes build (its
tables are held in tests/test_torch_mano.py), and the kernels refuse counts
past 51."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.diffusion import covariance as jax_cov
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu.skeleton import motion as jax_motion
from skeletondiffusion_tpu.skeleton.kinematic import H36MKinematic as JaxH36M
from skeletondiffusion_tpu_torch.diffusion import covariance
from skeletondiffusion_tpu_torch.skeleton import (
    H36MKinematic,
    create_skeleton,
    get_dct_matrix,
)

GOLD = np.load(os.path.join(os.path.dirname(__file__), "goldens", "skeleton_tables.npz"))

# (golden name, dataset, joints, hip kept)
CASES = [
    ("h36m17", "h36m", 17, False),
    ("h36m25", "h36m", 25, True),
    ("freeman18", "freeman", 18, False),
    ("amass22", "3dpw", 22, False),  # 3DPW zero-shot is the AMASS body
]
TABLES = ["num_nodes", "adj", "reach", "node_types", "limbseq", "metric_limbseq",
          "left_right", "limb_angles_idx"]


def _kw(dataset, joints, hip, obs=25, pred=100, repr_type="SkeletonRescalePose"):
    return dict(dataset_name=dataset, motion_repr_type=repr_type, num_joints=joints,
                pose_box_size=1.5, obs_length=obs, pred_length=pred, if_consider_hip=hip)


def _table(sk, table):
    """One table of a skeleton, as the goldens store it."""
    if table == "num_nodes":
        return np.asarray(sk.num_nodes)
    if table == "adj":
        return np.asarray(sk.adj_matrix)
    if table == "reach":
        return np.asarray(sk.reachability_matrix(factor=0.5, stop_at="hips"), dtype=np.float64)
    if table == "node_types":
        return np.asarray(sk.nodes_type_id, dtype=np.int64)
    if table == "limbseq":
        return np.asarray(sk.get_limbseq(), dtype=np.int64)
    if table == "metric_limbseq":
        return np.asarray(sk.limbseq, dtype=np.int64)
    if table == "left_right":
        return np.asarray(sk.left_right_limb, dtype=bool)
    return [list(r) for r in getattr(sk, "limb_angles_idx", [])]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, dataset, joints, hip = request.param
    return name, create_skeleton(**_kw(dataset, joints, hip)), jax_create_skeleton(
        **_kw(dataset, joints, hip))


@pytest.mark.parametrize("table", TABLES)
def test_kinematic_tables_match_the_goldens_and_jax(case, table):
    name, sk, jsk = case
    got, jax_got = _table(sk, table), _table(jsk, table)
    if table == "limb_angles_idx":
        assert got == jax_got == json.loads(str(GOLD[f"{name}_limb_angles_idx"]))
    else:
        np.testing.assert_array_equal(got, GOLD[f"{name}_{table}"])
        np.testing.assert_array_equal(got, jax_got)


def test_node_graph_and_parents_match_jax(case):
    _, sk, jsk = case
    assert sk.node_dict == jsk.node_dict
    assert sk.node_limbseq == jsk.node_limbseq
    assert sk.parents() == jsk.parents()
    assert sk.parents("nodes") == jsk.parents("nodes")
    assert sk.left_right_limb_nodes == jsk.left_right_limb_nodes


def test_node_counts_of_the_slice():
    counts = {d: create_skeleton(**_kw(d, j, False)).num_nodes
              for d, j in (("h36m", 17), ("freeman", 18), ("3dpw", 22))}
    assert counts == {"h36m": 16, "freeman": 17, "3dpw": 21}


def test_h36m_conversion_tables():
    for n in (17, 25):
        got = getattr(H36MKinematic, f"CONVERSION_IDX_32TO{n}")
        assert got == getattr(JaxH36M, f"CONVERSION_IDX_32TO{n}")
        np.testing.assert_array_equal(np.asarray(got, dtype=np.int64), GOLD[f"h36m_conv_32to{n}"])


@pytest.mark.parametrize("dataset, joints", [("h36m", 17), ("freeman", 18)])
def test_limb_lengths_match_jax(dataset, joints):
    sk, jsk = create_skeleton(**_kw(dataset, joints, False)), jax_create_skeleton(
        **_kw(dataset, joints, False))
    kpts = np.random.default_rng(3).standard_normal((2, 4, joints, 3)).astype(np.float32)
    for mode in ("metric", "nodes"):
        np.testing.assert_allclose(
            sk.extract_limb_length(torch.from_numpy(kpts), mode).numpy(),
            np.asarray(jsk.extract_limb_length(jnp.asarray(kpts), mode)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dataset, joints", [("h36m", 17), ("freeman", 18)])
@pytest.mark.parametrize("kind", ["adjacency", "reachability"])
def test_covariance_at_16_and_17_nodes_matches_jax(dataset, joints, kind):
    """The covariance code has no fixed node count: the 16- and 17-node
    skeletons' Σ_N, Λ_N and U equal the JAX package's."""
    sk = create_skeleton(**_kw(dataset, joints, False))
    corr = sk.adj_matrix if kind == "adjacency" else sk.reachability_matrix(0.5, 0)
    got = covariance.get_cov_from_corr(corr)
    want = jax_cov.get_cov_from_corr(corr)
    assert got[0].shape == (joints - 1, joints - 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_covariance_of_the_16_node_toy_matches_the_golden():
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "cov_toy16.npz"))
    sigma, lam, _ = covariance.get_cov_from_corr(g["corr"].astype(np.float32))
    np.testing.assert_allclose(sigma, g["Sigma_N"], atol=1e-4)
    np.testing.assert_allclose(lam, g["Lambda_N"], atol=1e-4)
    for got, want in zip(covariance.get_cov_from_corr(g["corr"]),
                         jax_cov.get_cov_from_corr(g["corr"])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 15, 25, 60, 100])
def test_dct_matrix_matches_jax(n):
    for got, want in zip(get_dct_matrix(n), jax_motion.get_dct_matrix(n)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_dct_representation_matches_jax():
    """SkeletonDiscreteCosineTransform on the H36M task lengths: a whole
    segment and a future into input space, and both segment lengths back."""
    kw = _kw("h36m", 17, False, obs=25, pred=100, repr_type="SkeletonDiscreteCosineTransform")
    sk, jsk = create_skeleton(**kw), jax_create_skeleton(**kw)
    rng = np.random.default_rng(5)
    seg = rng.standard_normal((2, 125, 17, 3)).astype(np.float32)
    fut = rng.standard_normal((2, 100, 17, 3)).astype(np.float32)
    for x in (seg, fut):
        np.testing.assert_allclose(sk.tranform_to_input_space(torch.from_numpy(x)).numpy(),
                                   np.asarray(jsk.tranform_to_input_space(jnp.asarray(x))),
                                   rtol=0, atol=2e-5)
    for frames in (25, 100):
        x = rng.standard_normal((2, frames, 16, 3)).astype(np.float32)
        got = sk.transform_to_metric_space(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jsk.transform_to_metric_space(jnp.asarray(x))),
                                   rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="neither"):
        sk.transform_to_metric_space(torch.zeros(2, 7, 16, 3))


def test_amass_mano_is_refused_naming_the_roadmap_item():
    """AMASS-MANO was refused until its slice: now 52 joints build 51 nodes
    under both dataset names, as in JAX, other joint counts raise, and the
    kernels refuse node counts past 51, naming the ROADMAP item of other
    shapes."""
    from skeletondiffusion_tpu_torch.ops.kernels import build

    for name in ("amass-mano", "amass"):
        assert create_skeleton(**_kw(name, 52, False)).num_nodes == 51
    with pytest.raises(ValueError, match="22 joints, or 52"):
        create_skeleton(**_kw("amass-mano", 51, False))
    build.check_nodes("attention_core", 51)
    for name in ("joint_attention", "gru_rollout", "posterior_step", "resnet_block"):
        with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*Queue B item 9"):
            build.check_nodes(name, 52)
