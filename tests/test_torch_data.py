"""The port's data path (``skeletondiffusion_tpu_torch/data``, the skeleton's
transforms and tables) against the JAX package's on the same synthetic
trees: the generators' files from the same seed, segments, mm-GT neighbour
lists, mean motions (≤ 1e-6), batches with their pad rows and dedup gather
tables (equal), ``preprocess_batch(train=False)`` (≤ 1e-6), and the
statistics of the noisy-observation branch, the training augmentations on
JAX's draws (≤ 1e-6) and on the port's own (their statistics), and
``bounded_batches`` / ``cycled_batches`` (the same batches)."""
import ast
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.data import batch as jbatch
from skeletondiffusion_tpu.data import mmgt as jmmgt
from skeletondiffusion_tpu.data.loaders import AMASSDataset as JaxAMASSDataset
from skeletondiffusion_tpu.data.synthetic import make_synthetic_amass as jax_make_synthetic
from skeletondiffusion_tpu.data.synthetic import (
    make_synthetic_amass_motion as jax_make_synthetic_motion,
)
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch.data import batch as tbatch
from skeletondiffusion_tpu_torch.data import mmgt as tmmgt
from skeletondiffusion_tpu_torch.data.loaders import AMASSDataset
from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_amass, make_synthetic_amass_motion
from skeletondiffusion_tpu_torch.skeleton import create_skeleton

OBS, PRED = 6, 15
MOTION_KW = dict(obs_length=OBS, pred_length=PRED, files_per_dataset=2, clip_len=120, seed=3)
FILES = ("processed/AMASS/hmp/mmgt_test.txt", "processed/AMASS/hmp/mean_motion_test.txt",
         "annotations/AMASS/hmp/segments_test.csv", "annotations/AMASS/hmp/mmapd_GT.csv")


def skeleton_kw(repr_type="SkeletonRescalePose", hip=False, box=1.1):
    kw = dict(dataset_name="amass", motion_repr_type=repr_type, num_joints=22,
              obs_length=OBS, pred_length=PRED, if_consider_hip=hip)
    if repr_type == "SkeletonRescalePose":
        kw["pose_box_size"] = box
    return kw


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{generator: {package: dataset root}}: the random-clip tree (the
    verify task's) and the procedural-motion tree, each written by both
    packages from the same seed."""
    out = {}
    for name, jax_fn, port_fn, kw in (
            ("random", jax_make_synthetic, make_synthetic_amass, {"seed": 1}),
            ("motion", jax_make_synthetic_motion, make_synthetic_amass_motion, MOTION_KW)):
        out[name] = {pkg: fn(str(tmp_path_factory.mktemp(f"{name}_{pkg}")), **kw)
                     for pkg, fn in (("jax", jax_fn), ("port", port_fn))}
    return out


def _csv_rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


@pytest.mark.parametrize("tree", ["random", "motion"])
def test_synthetic_trees_equal(tree, trees):
    roots = trees[tree]
    arrays = [np.load(os.path.join(r, "processed/AMASS/hmp/data_3d_amass.npz"),
                      allow_pickle=True)["positions_3d"].item() for r in roots.values()]
    assert list(arrays[0]) == list(arrays[1])
    for ds in arrays[0]:
        assert list(arrays[0][ds]) == list(arrays[1][ds])
        for fi in arrays[0][ds]:
            np.testing.assert_array_equal(arrays[1][ds][fi], arrays[0][ds][fi])
    for rel in FILES:
        jax_path, port_path = (os.path.join(r, rel) for r in roots.values())
        if rel.endswith("mmgt_test.txt"):
            parse = lambda p: ast.literal_eval(json.load(open(p)))  # noqa: E731
            assert parse(port_path) == parse(jax_path)
        elif rel.endswith("mean_motion_test.txt"):
            rows = [[line.split(",") for line in open(p).read().splitlines()]
                    for p in (jax_path, port_path)]
            assert [r[0] for r in rows[1]] == [r[0] for r in rows[0]]
            np.testing.assert_allclose(np.asarray([r[1:] for r in rows[1]], float),
                                       np.asarray([r[1:] for r in rows[0]], float),
                                       rtol=0, atol=1e-6)
        else:
            assert _csv_rows(port_path) == _csv_rows(jax_path)


@pytest.fixture(scope="module")
def datasets(trees):
    """(JAX dataset, port dataset, their skeletons) on the JAX package's
    random-clip tree, mm-GT and mean motions loaded."""
    root = trees["random"]["jax"]
    kw = dict(datasets=["DFaust"], split="test",
              precomputed_folder=os.path.join(root, "processed/AMASS/hmp/"),
              segments_path=os.path.join(root, "annotations/AMASS/hmp/segments_test.csv"),
              obs_length=OBS, pred_length=PRED, if_consider_hip=False, if_load_mmgt=True,
              if_compute_cmd=True, silent=True)
    jsk, sk = jax_create_skeleton(**skeleton_kw()), create_skeleton(**skeleton_kw())
    return JaxAMASSDataset(skeleton=jsk, **kw), AMASSDataset(skeleton=sk, **kw), jsk, sk


def test_dataset_segments_mmgt_and_mean_motion(datasets):
    jds, ds, _, _ = datasets
    assert len(ds) == len(jds) > 0
    assert ds.segments == jds.segments
    assert ds.segment_idx_to_metadata == jds.segment_idx_to_metadata
    assert ds.mm_indces == jds.mm_indces
    assert ds.max_mmgt_count == jds.max_mmgt_count
    np.testing.assert_allclose(ds.mean_motion_per_class, jds.mean_motion_per_class,
                               rtol=0, atol=1e-6)
    for i in (0, len(ds) - 1):
        for a, b in zip(ds[i][:2], jds[i][:2]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ds.future_of_segment(i), jds.future_of_segment(i))


def test_statistics_builders_match_jax(datasets, tmp_path):
    jds, ds, jsk, sk = datasets
    want = jmmgt.compute_multimodal_gt_for_dataset(jds, jsk, 0.4, str(tmp_path / "j.txt"))
    got = tmmgt.compute_multimodal_gt_for_dataset(ds, sk, 0.4, str(tmp_path / "t.txt"))
    assert got == want
    assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()
    (jc, jmo, jf), (tc, tmo, tf) = jmmgt.compute_mean_motions(jds), tmmgt.compute_mean_motions(ds)
    assert list(tc) == list(jc)
    np.testing.assert_allclose(tmo, jmo, rtol=0, atol=1e-6)
    assert tf == jf


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("mode", ["dedup_lazy", "dedup", "dense", "shuffled"])
def test_loader_batches_equal(mode, datasets):
    """Every batch of an epoch, the padded last one's pad rows drawn from
    (seed, epoch) and the dedup gather table included; ``shuffled`` runs
    two epochs."""
    jds, ds, _, _ = datasets
    dedup = mode.startswith("dedup")
    for d in (jds, ds):
        d.mm_lazy = mode == "dedup_lazy"
    kw = dict(batch_size=4, shuffle=mode == "shuffled", pad_last=True, seed=7, dedup_mm=dedup)
    loaders = jbatch.DataLoader(jds, **kw), tbatch.DataLoader(ds, **kw)
    assert len(ds) % 4 != 0  # the last batch is padded
    for _ in range(2 if mode == "shuffled" else 1):
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == len(loaders[0])
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        assert int(got[-1]["_count"]) == len(ds) % 4
        if dedup:
            assert "mm_idx" in got[-1]
    for d in (jds, ds):
        d.mm_lazy = False


def test_preprocess_eval_matches_jax(datasets):
    jds, ds, jsk, sk = datasets
    jds.mm_lazy = ds.mm_lazy = True
    batch = next(iter(tbatch.DataLoader(ds, batch_size=5, pad_last=True, dedup_mm=True)))
    jds.mm_lazy = ds.mm_lazy = False
    mm = batch["mm_gt"][batch["mm_idx"]]
    want = jbatch.preprocess_batch(jsk, jax.random.key(0), jnp.asarray(batch["obs"]),
                                   jnp.asarray(batch["pred"]), jnp.asarray(mm), train=False)
    got = tbatch.preprocess_batch(sk, None, torch.from_numpy(batch["obs"]),
                                  torch.from_numpy(batch["pred"]), torch.from_numpy(mm),
                                  train=False)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_noisy_observation_statistics():
    """A share ``noise_level`` of the non-root joints moves, by N(0, σ²);
    the root and the future do not; the draws come from the generator."""
    sk = create_skeleton(**skeleton_kw())
    obs = torch.zeros(64, OBS, 22, 3)
    pred = torch.zeros(64, PRED, 22, 3)
    level, std = 0.3, 0.05
    run = lambda seed: tbatch.preprocess_batch(  # noqa: E731
        sk, torch.Generator().manual_seed(seed), obs, pred, train=False, if_noisy_obs=True,
        noise_level=level, noise_std=std)
    (o1, p1, _), (o2, _, _), (o3, _, _) = run(0), run(0), run(1)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    assert not torch.equal(o1, o3)
    assert torch.equal(p1, torch.zeros_like(p1))
    # input space drops the root; every joint is hip-centred and ÷ box, and
    # the root (joint 0) is unperturbed, so node j moved by noise_j / box
    moved = (o1 != 0).any(dim=-1)
    share = moved.float().mean().item()
    assert abs(share - level) < 0.01, share
    spread = (o1[moved] * sk.pose_box_size).std().item()
    assert abs(spread - std) < 0.02 * std, spread
    with pytest.raises(ValueError, match="Generator"):
        tbatch.preprocess_batch(sk, None, obs, pred, train=False, if_noisy_obs=True)


def test_prefetch_ships_device_keys_and_raises_producer_errors(datasets):
    _, ds, _, _ = datasets
    # two loaders: a loader's pad rows depend on its epoch count
    wants = list(tbatch.DataLoader(ds, batch_size=4, pad_last=True))
    shipped = list(tbatch.prefetch_iterator(tbatch.DataLoader(ds, batch_size=4, pad_last=True),
                                            device="cpu"))
    assert len(shipped) == len(wants)
    for got, want in zip(shipped, wants):
        for k, v in want.items():
            if k in tbatch.DEVICE_KEYS:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), v)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v)

    def failing():
        yield {"obs": np.zeros(1)}
        raise KeyError("producer")

    with pytest.raises(KeyError, match="producer"):
        list(tbatch.prefetch_iterator(failing(), device="cpu"))


def jax_augmentation_draws(rng, batch: int) -> dict:
    """The draws JAX ``preprocess_batch`` makes from ``rng`` for its
    augmentations (`data/batch.py:44-72`), as ``draw_augmentation`` returns
    its own."""
    k_mx, k_my, k_rotp, k_deg, _, _ = jax.random.split(rng, 6)
    draws = {"mirror_x": jax.random.uniform(k_mx, (batch,)),
             "mirror_y": jax.random.uniform(k_my, (batch,)),
             "rotate": jax.random.uniform(k_rotp, (batch,)),
             "degrees": jax.random.randint(k_deg, (batch,), 0, 360)}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("mirroring,rotations", [(0.5, 0.0), (0.0, 1.0), (0.5, 0.7)],
                         ids=["mirroring", "rotation", "mirroring_and_rotation"])
def test_train_augmentations_match_jax(datasets, mirroring, rotations):
    """``preprocess_batch(train=True)`` on JAX's draws (injected) equals the
    JAX one on the key they come from, obs, pred and the mm-GT futures
    (≤ 1e-6), for mirroring, rotation and both, with the noisy observation
    on top."""
    jds, ds, jsk, sk = datasets
    jds.mm_lazy = ds.mm_lazy = True
    batch = next(iter(tbatch.DataLoader(ds, batch_size=16, pad_last=True, dedup_mm=True)))
    jds.mm_lazy = ds.mm_lazy = False
    mm = batch["mm_gt"][batch["mm_idx"]]
    for seed in range(3):
        rng = jax.random.key(seed)
        kw = dict(train=True, da_mirroring=mirroring, da_rotations=rotations)
        want = jbatch.preprocess_batch(jsk, rng, jnp.asarray(batch["obs"]),
                                       jnp.asarray(batch["pred"]), jnp.asarray(mm), **kw)
        draws = jax_augmentation_draws(rng, 16)
        got = tbatch.preprocess_batch(sk, None, torch.from_numpy(batch["obs"]),
                                      torch.from_numpy(batch["pred"]), torch.from_numpy(mm),
                                      draws=draws, **kw)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        # the draws did something, and the items they left alone are as the
        # untrained preprocess gives them
        flips = (draws["mirror_x"] < mirroring) | (draws["mirror_y"] < mirroring)
        turns = (draws["rotate"] < rotations) & (draws["degrees"] % 360 != 0)
        moved = flips | turns
        assert int(moved.sum()) > 0
        plain = tbatch.preprocess_batch(sk, None, torch.from_numpy(batch["obs"]),
                                        torch.from_numpy(batch["pred"]), train=False)[0]
        assert torch.equal(got[0][~moved], plain[~moved])


def test_train_augmentation_draws_from_the_generator():
    """The port's own draws (it cannot repeat JAX's): the same generator seed
    repeats them, another does not; each item is mirrored in x and in y with
    probability ``da_mirroring`` and turned with ``da_rotations`` by a whole
    degree in [0, 360) about z, which keeps every pose's z and its distances;
    the noisy observation draws after the augmentations."""
    sk = create_skeleton(**skeleton_kw("SkeletonVanilla"))
    b = 4000
    draws = tbatch.draw_augmentation(torch.Generator().manual_seed(0), b)
    again = tbatch.draw_augmentation(torch.Generator().manual_seed(0), b)
    other = tbatch.draw_augmentation(torch.Generator().manual_seed(1), b)
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    assert not torch.equal(draws["degrees"], other["degrees"])
    for key in ("mirror_x", "mirror_y", "rotate"):
        assert abs((draws[key] < 0.3).float().mean().item() - 0.3) < 0.03, key
    deg = draws["degrees"]
    assert int(deg.min()) == 0 and int(deg.max()) == 359 and deg.dtype == torch.int64
    pose = torch.randn(b, 1, 22, 3, generator=torch.Generator().manual_seed(2))
    mirrored, = tbatch.augment(draws, [pose], da_mirroring=0.3)
    sign = mirrored / pose
    assert torch.equal(sign[:, 0, 0, 0] < 0, draws["mirror_x"] < 0.3)
    assert torch.equal(sign[:, 0, 0, 1] < 0, draws["mirror_y"] < 0.3)
    assert torch.equal(mirrored[..., 2], pose[..., 2])
    turned, = tbatch.augment(draws, [pose], da_rotations=0.5)
    assert torch.equal(turned[..., 2], pose[..., 2])
    torch.testing.assert_close(torch.cdist(turned[:, 0], turned[:, 0]),
                               torch.cdist(pose[:, 0], pose[:, 0]), rtol=0, atol=2e-5)
    still = draws["rotate"] >= 0.5
    assert torch.equal(turned[still], pose[still])
    obs, pred = torch.zeros(2, OBS, 22, 3), torch.zeros(2, PRED, 22, 3)
    noisy = [tbatch.preprocess_batch(sk, torch.Generator().manual_seed(3), obs, pred,
                                     da_mirroring=m, if_noisy_obs=True)[0] for m in (0.0, 0.5)]
    assert not torch.equal(noisy[0], noisy[1])  # the noise comes after four draws


def _numbered_loader(n_items: int, batch: int):
    class Items:
        def __len__(self):
            return n_items

        def __getitem__(self, i):
            return (np.full((1,), i), np.zeros(1), {"segment_idx": i, "metadata": ()})

    return Items


@pytest.mark.parametrize("n", [None, 2, 3, 7], ids=["none", "below", "equal", "above"])
def test_bounded_and_cycled_batches_match_jax(n):
    """Both packages' ``bounded_batches`` and ``cycled_batches`` over their
    shuffled loaders of 11 items in batches of 4 (3 a pass, the last one
    short): the same batches and the same number, n below, equal to and
    above the loader's length; one pass for None."""
    items = _numbered_loader(11, 4)()
    for fn in ("bounded_batches", "cycled_batches"):
        loaders = [mod.DataLoader(items, batch_size=4, shuffle=True, seed=5)
                   for mod in (jbatch, tbatch)]
        want = [b["obs"][:, 0].tolist() for b in getattr(jbatch, fn)(loaders[0], n)]
        got = [b["obs"][:, 0].tolist() for b in getattr(tbatch, fn)(loaders[1], n)]
        assert got == want, fn
        full = len(loaders[1])
        expect = full if n is None else (min(n, full) if fn == "bounded_batches" else n)
        assert len(got) == expect, fn
        assert loaders[1].state_dict()["epoch"] == loaders[0].state_dict()["epoch"]


def test_cycled_batches_refuses_an_empty_loader():
    empty = tbatch.DataLoader(_numbered_loader(0, 4)(), batch_size=4)
    with pytest.raises(ValueError, match="empty loader"):
        list(tbatch.cycled_batches(empty, 3))
    assert list(tbatch.bounded_batches(empty, 3)) == []
    assert list(tbatch.cycled_batches(empty, 0)) == []


@pytest.mark.parametrize("repr_type,hip", [("SkeletonVanilla", False), ("SkeletonVanilla", True),
                                           ("SkeletonCenterPose", False),
                                           ("SkeletonCenterPose", True),
                                           ("SkeletonRescalePose", False),
                                           ("SkeletonRescalePose", True)])
def test_motion_transforms_match_jax(repr_type, hip):
    kw = skeleton_kw(repr_type, hip, box=1.5)
    jsk, sk = jax_create_skeleton(**kw), create_skeleton(**kw)
    x = np.random.default_rng(5).standard_normal((2, 3, OBS + PRED, 22, 3)).astype(np.float32)
    want = jsk.tranform_to_input_space(jnp.asarray(x))
    got = sk.tranform_to_input_space(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sk.transform_to_metric_space(got).numpy(),
                               np.asarray(jsk.transform_to_metric_space(want)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sk.if_add_zero_pad_center_hip(got[..., 1:, :]).numpy(),
                                  np.asarray(jsk.if_add_zero_pad_center_hip(want[..., 1:, :])))


@pytest.mark.parametrize("hip", [False, True])
def test_kinematic_tables_match_jax(hip):
    kw = skeleton_kw(hip=hip)
    jsk, sk = jax_create_skeleton(**kw), create_skeleton(**kw)
    for mode in ("original", "nodes"):
        assert sk.parents(mode) == jsk.parents(mode)
    np.testing.assert_array_equal(sk.get_limbseq(), jsk.get_limbseq())
    assert sk.left_right_limb == jsk.left_right_limb
    assert sk.left_right_limb_nodes == jsk.left_right_limb_nodes
    if not hip:
        assert sk.limb_angles_idx == jsk.limb_angles_idx
    x = np.random.default_rng(6).standard_normal((2, 4, 22, 3)).astype(np.float32)
    for mode in ("metric", "nodes"):
        n = 22 if mode == "metric" or hip else 21
        np.testing.assert_allclose(sk.extract_limb_length(torch.from_numpy(x[..., :n, :]), mode),
                                   np.asarray(jsk.extract_limb_length(x[..., :n, :], mode)),
                                   rtol=0, atol=1e-6)
