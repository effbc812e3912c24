"""The port's host-side modules on the CPU against the JAX package's: the
dataset preprocessing (``data/preprocess``: H36M at 17 and 25 joints and
FreeMan bit for bit against ``tests/goldens/preprocess.npz`` on
``tests/preprocess_raw_fixtures.py``'s raw trees; the SMPL-H forward
kinematics of AMASS and 3DPW on toy body models and mocap made with numpy
from a seed; ``finalize_dataset``'s files), the FLOP counts
(``utils/flops``), the keypoint helpers (``utils/keypoints``), the noise
scale diagnostic (``diffusion/covariance.verify_noise_scale``) and the plots
(``utils/plot``, skipped without matplotlib)."""
import os
import pickle

import numpy as np
import pytest
import torch

from preprocess_raw_fixtures import h36m_raw, write_freeman_tree, write_h36m_tree
from skeletondiffusion_tpu.data.preprocess import amass as jax_amass
from skeletondiffusion_tpu.data.preprocess import d3pw as jax_d3pw
from skeletondiffusion_tpu.utils import flops as jax_flops
from skeletondiffusion_tpu.utils import keypoints as jax_keypoints
from skeletondiffusion_tpu_torch.data.preprocess import amass, d3pw, freeman, h36m
from skeletondiffusion_tpu_torch.utils import flops, keypoints

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "preprocess.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLD)


@pytest.mark.parametrize("num_joints", [17, 25])
def test_h36m_preprocess_matches_the_reference(tmp_path, golden, num_joints):
    raw_tree = tmp_path / "h36m_raw"
    write_h36m_tree(str(raw_tree), h36m_raw(), ext="npy")
    out = h36m.create_h36m_npz(str(raw_tree), str(tmp_path / f"h36m_{num_joints}.npz"),
                               num_joints=num_joints)
    ours = {f"{s}|{a}": arr for s, acts in out.items() for a, arr in acts.items()}
    prefix = f"h36m{num_joints}|"
    ref = {k[len(prefix):]: golden[k] for k in golden.files if k.startswith(prefix)}
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_h36m_entry_point_writes_the_reference_npz(tmp_path, golden, monkeypatch):
    """``python -m skeletondiffusion_tpu_torch.data.preprocess.h36m`` as the
    JAX package's ``main()`` takes it."""
    raw_tree = tmp_path / "h36m_raw"
    write_h36m_tree(str(raw_tree), h36m_raw(), ext="npy")
    monkeypatch.setattr("sys.argv", ["h36m", "--input", str(raw_tree), "--output",
                                     str(tmp_path / "out"), "--num-joints", "25"])
    h36m.main()
    npz = np.load(tmp_path / "out" / "data_3d_h36m.npz", allow_pickle=True)
    data = npz["positions_3d"].item()
    ref = {k[len("h36m25|"):]: golden[k] for k in golden.files if k.startswith("h36m25|")}
    assert {f"{s}|{a}" for s, acts in data.items() for a in acts} == set(ref)
    for k, v in ref.items():
        subject, action = k.split("|")
        np.testing.assert_array_equal(data[subject][action], v, err_msg=k)


def test_freeman_preprocess_matches_the_reference(tmp_path, golden):
    write_freeman_tree(str(tmp_path / "raw"), str(tmp_path / "ann"))
    out = freeman.create_freeman_npz(str(tmp_path / "raw"), str(tmp_path / "ann"),
                                     str(tmp_path / "data_3d_freeman.npz"))
    ref = {k[len("freeman|"):]: golden[k] for k in golden.files if k.startswith("freeman|")}
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def _body_models(root, rng, joints=52, verts=80, betas=16):
    """Toy SMPL-H models (a random kinematic tree, template, shape blend and
    joint regressor) for each gender, as ``amass.load_body_models`` reads
    them."""
    for gender in ("male", "female", "neutral"):
        kintree = np.zeros((2, joints), dtype=np.int64)
        kintree[0, 1:] = [rng.integers(0, j) for j in range(1, joints)]
        os.makedirs(root / gender)
        np.savez(root / gender / "model.npz", v_template=rng.standard_normal((verts, 3)),
                 shapedirs=0.01 * rng.standard_normal((verts, 3, betas)),
                 J_regressor=np.abs(rng.standard_normal((joints, verts))) / verts,
                 kintree_table=kintree)


def test_smplh_forward_kinematics_match_the_jax_package(tmp_path):
    """AMASS (22 and 52 joints, 120 fps mocap taken to 60) and 3DPW (24
    joints, permuted and mirrored) through both packages' FK: equal arrays."""
    rng = np.random.default_rng(7)
    _body_models(tmp_path / "models", rng)
    for ds in ("ACCAD", "CMU"):
        os.makedirs(tmp_path / "amass" / ds)
        for i in range(2):
            np.savez(tmp_path / "amass" / ds / f"seq{i}.npz",
                     poses=0.3 * rng.standard_normal((9, 156)), betas=rng.standard_normal(16),
                     trans=rng.standard_normal((9, 3)), gender=["male", "female"][i],
                     mocap_framerate=120.0)
    for hands in (False, True):
        kw = dict(include_hands=hands)
        want = jax_amass.create_amass_npz(str(tmp_path / "amass"), str(tmp_path / "models"),
                                          str(tmp_path / f"jax_{hands}.npz"), **kw)
        got = amass.create_amass_npz(str(tmp_path / "amass"), str(tmp_path / "models"),
                                     str(tmp_path / f"port_{hands}.npz"), **kw)
        assert got.keys() == want.keys() == {"ACCAD", "CMU"}
        for ds in want:
            for i in want[ds]:
                assert got[ds][i].shape == (5, 52 if hands else 22, 3)
                np.testing.assert_array_equal(got[ds][i], want[ds][i])
    os.makedirs(tmp_path / "3dpw" / "test")
    ann = {"genders": ["m", "f"], "poses_60Hz": 0.3 * rng.standard_normal((2, 6, 72)),
           "trans_60Hz": rng.standard_normal((2, 6, 3)), "betas": rng.standard_normal((2, 10))}
    with open(tmp_path / "3dpw" / "test" / "walk.pkl", "wb") as f:
        pickle.dump(ann, f)
    want = jax_d3pw.create_3dpw_npz(str(tmp_path / "3dpw"), str(tmp_path / "models"),
                                    str(tmp_path / "jax_3dpw.npz"))
    got = d3pw.create_3dpw_npz(str(tmp_path / "3dpw"), str(tmp_path / "models"),
                               str(tmp_path / "port_3dpw.npz"))
    assert set(got["test"]) == set(want["test"]) == {"walk_actor0", "walk_actor1"}
    for k, v in want["test"].items():
        np.testing.assert_array_equal(got["test"][k], v)


def test_finalize_dataset_writes_the_jax_packages_files(tmp_path):
    """Mean motions and the multimodal ground truth of one synthetic tree,
    finished by each package in a copy of its own."""
    import shutil

    from skeletondiffusion_tpu.data.loaders import AMASSDataset as JaxAMASSDataset
    from skeletondiffusion_tpu.data.preprocess.common import finalize_dataset as jax_finalize
    from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
    from skeletondiffusion_tpu_torch.data import AMASSDataset, make_synthetic_amass
    from skeletondiffusion_tpu_torch.data.preprocess.common import finalize_dataset
    from skeletondiffusion_tpu_torch.skeleton import create_skeleton

    root = make_synthetic_amass(str(tmp_path / "tree"), seed=5, files_per_dataset=2,
                                clip_len=60)
    pre = os.path.join(root, "processed/AMASS/hmp")
    ann = os.path.join(root, "annotations/AMASS/hmp")
    sk_kw = dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
                 pose_box_size=1.1, obs_length=6, pred_length=15, if_consider_hip=False)
    files = ("mean_motion_test.txt", "mmgt_test.txt")
    outs = {}
    for name, fin, cls, sk in (("jax", jax_finalize, JaxAMASSDataset, jax_create_skeleton),
                               ("port", finalize_dataset, AMASSDataset, create_skeleton)):
        folder = tmp_path / name
        shutil.copytree(pre, folder)
        for f in files:
            (folder / f).unlink(missing_ok=True)
        fin(cls, sk(**sk_kw), str(folder) + "/", segments_path=f"{ann}/segments_test.csv",
            multimodal_threshold=0.4, datasets=["DFaust"], obs_length=6, pred_length=15)
        outs[name] = [(folder / f).read_text() for f in files]
    assert outs["port"] == outs["jax"]
    assert all(text for text in outs["port"])


FLOP_GRID = [dict(n=21, obs_len=30, pred_len=120), dict(n=16, obs_len=25, pred_len=100),
             dict(n=51, obs_len=30, pred_len=120, latent=32, hidden=16, depth=2, heads=4)]


@pytest.mark.parametrize("kw", FLOP_GRID, ids=["amass", "h36m", "mano_small"])
def test_flop_counts_equal_the_jax_packages(kw):
    assert flops.prediction_flops(**kw) == jax_flops.prediction_flops(**kw)
    n, rest = kw["n"], {k: v for k, v in kw.items() if k != "n"}
    for batch in (8, 64):
        assert (flops.train_step_flops_stage2(n, batch, k=5, **rest)
                == jax_flops.train_step_flops_stage2(n, batch, k=5, **rest))
        keys = {k: v for k, v in rest.items() if k in ("obs_len", "pred_len", "hidden", "latent")}
        assert (flops.train_step_flops_stage1(n, batch, **keys)
                == jax_flops.train_step_flops_stage1(n, batch, **keys))
    assert flops.mfu(989e12) == 1.0 and flops.H100_BF16_PEAK_FLOPS == 989e12


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(5, 22, 3), (2, 7, 17, 3)])
def test_keypoint_helpers_equal_the_jax_packages(seed, shape):
    kpts = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    for hip in (0, 3):
        for got, want in zip(keypoints.center_kpts_around_hip(kpts, hip),
                             jax_keypoints.center_kpts_around_hip(kpts, hip)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            keypoints.center_kpts_around_hip_and_drop_root(kpts, hip),
            jax_keypoints.center_kpts_around_hip_and_drop_root(kpts, hip))
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(keypoints.rotate_y_axis(kpts, 33.0, axis),
                                      jax_keypoints.rotate_y_axis(kpts, 33.0, axis))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dataset, joints, steps", [("amass", 22, 10), ("h36m", 17, 20)])
def test_verify_noise_scale_equals_the_jax_packages(dataset, joints, steps, seed):
    from skeletondiffusion_tpu.diffusion.covariance import verify_noise_scale as jax_verify
    from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
    from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
    from skeletondiffusion_tpu_torch.diffusion.covariance import verify_noise_scale
    from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
    from skeletondiffusion_tpu_torch.skeleton import create_skeleton

    kw = dict(dataset_name=dataset, motion_repr_type="SkeletonRescalePose", num_joints=joints,
              pose_box_size=1.5, obs_length=6, pred_length=10, if_consider_hip=False)
    keys = dict(diffusion_type="NonisotropicGaussianDiffusion", latent_size=8,
                diffusion_timesteps=steps, diffusion_conditioning=True,
                diffusion_arch={"depth": 1, "attn_heads": 1, "attn_dim_head": 8})
    engine, _ = create_diffusion(create_skeleton(**kw), torch.Generator().manual_seed(0),
                                 device="cpu", **keys)
    jengine, _ = jax_create_diffusion(jax_create_skeleton(**kw), covariance_matrix_type="adjacency",
                                      **keys)
    got = verify_noise_scale(engine.process, n_samples=300, seed=seed)
    want = jax_verify(jengine.process, n_samples=300, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_plots_render(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    from skeletondiffusion_tpu_torch.skeleton import create_skeleton
    from skeletondiffusion_tpu_torch.utils import plot

    sk = create_skeleton(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                         num_joints=22, pose_box_size=1.5, obs_length=6, pred_length=10,
                         if_consider_hip=False)
    motion = np.random.default_rng(0).standard_normal((3, 21, 3)).astype(np.float32)
    frames = plot.render_motion_frames(motion, sk.get_limbseq(), overlay=motion + 0.1,
                                       figsize=1.5)
    assert frames.shape[0] == 3 and frames.shape[-1] == 3 and frames.dtype == np.uint8
    gif = plot.save_gif(frames, fps=10, name=str(tmp_path / "m.gif"))
    assert os.path.getsize(gif) > 0
    png = plot.save_img(frames[0], str(tmp_path / "f.png"))
    assert plot.load_image(png).shape[:2] == frames.shape[1:3]
