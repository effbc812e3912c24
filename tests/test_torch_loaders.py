"""The port's Human3.6M, FreeMan and zero-shot 3DPW loaders against the JAX
package's on the same fixtures (those of ``tests/test_loaders_nonamass.py``):
the FreeMan test split from the shipped annotations and its valid split from
the shipped lists, H36M's no-S8 mm-GT file and the renaming of the actions a
segment CSV names, and 3DPW's merge of all splits with its 24 joints cut to
the AMASS body's 22.  Segments, clips, metadata, classes and mm-GT indices
are equal; the port reads the CSVs with ``csv``."""
import csv
import json
import os

import numpy as np
import pytest

from skeletondiffusion_tpu.data import loaders as jax_loaders
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch.data import DataLoader, loaders
from skeletondiffusion_tpu_torch.data.mmgt import finalize_dataset
from skeletondiffusion_tpu_torch.skeleton import create_skeleton

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREEMAN_ANN = os.path.join(REPO, "datasets", "annotations", "FreeMan", "hmp")
F_OBS, F_PRED = 15, 60  # FreeMan at 30 fps: 0.5 s observed, 2 s predicted
OBS, PRED = 5, 8


def _skeletons(dataset, joints, obs, pred):
    kw = dict(dataset_name=dataset, motion_repr_type="SkeletonRescalePose", num_joints=joints,
              pose_box_size=1.5, obs_length=obs, pred_length=pred, if_consider_hip=False)
    return create_skeleton(**kw), jax_create_skeleton(**kw)


def _both(name, dataset, joints, obs, pred, **kw):
    """(port dataset, JAX dataset) of class ``name`` on the same arguments."""
    sk, jsk = _skeletons(dataset, joints, obs, pred)
    common = dict(obs_length=obs, pred_length=pred, if_consider_hip=False, silent=True, **kw)
    return (getattr(loaders, name)(skeleton=sk, **common),
            getattr(jax_loaders, name)(skeleton=jsk, **common))


def _assert_same(ds, jds, items=4):
    assert ds.segments == jds.segments
    assert ds.segment_idx_to_metadata == jds.segment_idx_to_metadata
    assert ds.clip_idx_to_metadata == jds.clip_idx_to_metadata
    assert ds.dict_indices == jds.dict_indices
    assert ds.idx_to_class == jds.idx_to_class and ds.class_to_idx == jds.class_to_idx
    assert len(ds.annotations) == len(jds.annotations)
    for a, b in zip(ds.annotations, jds.annotations):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(ds) == len(jds)
    for i in list(range(min(items, len(ds)))) + [len(ds) - 1]:
        (o, p, e), (jo, jp, je) = ds[i], jds[i]
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(p, jp)
        assert e["metadata"] == je["metadata"]
        assert ds.extract_action_label(e) == jds.extract_action_label(je)


def _write_csv(path, rows):
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


@pytest.fixture(scope="module")
def freeman_npz_dir(tmp_path_factory):
    """data_3d_freeman.npz with every sequence of the shipped test segments
    and valid list."""
    root = tmp_path_factory.mktemp("freeman")
    rng = np.random.default_rng(0)
    need = {}
    for row in loaders.read_segments_csv(os.path.join(FREEMAN_ANN, "segments_test.csv")):
        need[row["name"]] = max(need.get(row["name"], 0), row["pred_end"] + 1)
    with open(os.path.join(FREEMAN_ANN, "valid.txt")) as fh:
        for line in fh:
            need.setdefault(line.strip(), 160)
    positions = {k: (0.2 * rng.standard_normal((t, 18, 3))).astype(np.float32)
                 for k, t in need.items()}
    np.savez(os.path.join(root, "data_3d_freeman.npz"), positions_3d=positions)
    return str(root)


def test_freeman_test_split_from_the_shipped_annotations(freeman_npz_dir):
    seg = os.path.join(FREEMAN_ANN, "segments_test.csv")
    ds, jds = _both("FreeManDataset", "freeman", 18, F_OBS, F_PRED, split="test",
                    precomputed_folder=freeman_npz_dir, segments_path=seg,
                    annotations_folder=FREEMAN_ANN)
    assert len(ds.segments) == 11015  # every row of the shipped CSV
    assert ds.seq2action == jds.seq2action
    _assert_same(ds, jds)


def test_freeman_valid_split_from_the_shipped_lists(freeman_npz_dir):
    ds, jds = _both("FreeManDataset", "freeman", 18, F_OBS, F_PRED, split="valid",
                    precomputed_folder=freeman_npz_dir, annotations_folder=FREEMAN_ANN,
                    stride=30)
    _assert_same(ds, jds)
    batch = next(iter(DataLoader(ds, batch_size=4, shuffle=False)))
    assert batch["obs"].shape == (4, F_OBS, 18, 3)


def test_freeman_actions_filter(freeman_npz_dir):
    action = next(iter(loaders.FreeManDataset._file2action(
        type("A", (), {"annotations_folder": FREEMAN_ANN})()).values()))
    ds, jds = _both("FreeManDataset", "freeman", 18, F_OBS, F_PRED, split="valid",
                    precomputed_folder=freeman_npz_dir, annotations_folder=FREEMAN_ANN,
                    actions=[action], stride=30)
    assert set(ds.idx_to_class) <= {action}
    _assert_same(ds, jds)


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("h36m")
    rng = np.random.default_rng(1)
    positions = {s: {a: (0.2 * rng.standard_normal((60, 17, 3))).astype(np.float32)
                     for a in ("Walking_1", "Photo_1", "WalkDog_1")}
                 for s in ("S1", "S8")}
    np.savez(os.path.join(root, "data_3d_h36m.npz"), positions_3d=positions)
    return str(root)


def test_h36m_train_mmgt_without_s8(h36m_dir):
    """The training mm-GT of a subject list without S8 is mmgt_train_noS8.txt,
    with S8 mmgt_train.txt."""
    common = dict(split="train", precomputed_folder=h36m_dir, stride=4)
    probe, _ = _both("H36MDataset", "h36m", 17, OBS, PRED, subjects=["S1"], **common)
    probe8, _ = _both("H36MDataset", "h36m", 17, OBS, PRED, subjects=["S1", "S8"], **common)
    with open(os.path.join(h36m_dir, "mmgt_train_noS8.txt"), "w") as fh:
        json.dump(str({i: [0] for i in range(len(probe.segments))}), fh)
    with open(os.path.join(h36m_dir, "mmgt_train.txt"), "w") as fh:
        json.dump(str({i: [i] for i in range(len(probe8.segments))}), fh)
    for subjects, want in ((["S1"], lambda k: [0]), (["S1", "S8"], lambda k: [k])):
        ds, jds = _both("H36MDataset", "h36m", 17, OBS, PRED, subjects=subjects,
                        if_load_mmgt=True, **common)
        _assert_same(ds, jds)
        assert ds.mm_indces == jds.mm_indces
        assert all(v == want(k) for k, v in ds.mm_indces.items())


def test_h36m_segment_csv_renames_the_actions(h36m_dir, tmp_path):
    rows = [{"subject": "S1", "action": "TakingPhoto 1", "init": 0, "pred_init": OBS,
             "pred_end": OBS + PRED - 1},
            {"subject": "S8", "action": "WalkingDog 1", "init": 3, "pred_init": 3 + OBS,
             "pred_end": 3 + OBS + PRED - 1},
            {"subject": "S8", "action": "Walking 1", "init": 0, "pred_init": OBS,
             "pred_end": OBS + PRED - 1}]
    seg = str(tmp_path / "segments_test.csv")
    _write_csv(seg, rows)
    ds, jds = _both("H36MDataset", "h36m", 17, OBS, PRED, subjects=None, split="test",
                    precomputed_folder=h36m_dir, segments_path=seg)
    _assert_same(ds, jds)
    assert [m for m in ds.segment_idx_to_metadata] == [("S1", "Photo"), ("S8", "WalkDog"),
                                                        ("S8", "Walking")]
    assert ds.segments[0][0] == ds.dict_indices["S1"]["Photo_1"]


def test_h36m_test_split_mmgt_and_mean_motions_from_finalize(h36m_dir, tmp_path):
    """finalize_dataset on the H36M loader: mmgt_test.txt and
    mean_motion_test.txt by the port, read back by both loaders alike."""
    folder = tmp_path / "pre"
    folder.mkdir()
    os.link(os.path.join(h36m_dir, "data_3d_h36m.npz"), folder / "data_3d_h36m.npz")
    rows = [{"subject": s, "action": a, "init": i, "pred_init": i + OBS,
             "pred_end": i + OBS + PRED - 1}
            for s in ("S1", "S8") for a in ("Walking 1", "TakingPhoto 1") for i in (0, 7, 30)]
    seg = str(tmp_path / "segments_test.csv")
    _write_csv(seg, rows)
    sk, _ = _skeletons("h36m", 17, OBS, PRED)
    finalize_dataset(loaders.H36MDataset, sk, precomputed_folder=str(folder) + "/",
                     segments_path=seg, multimodal_threshold=0.5, subjects=None,
                     obs_length=OBS, pred_length=PRED)
    ds, jds = _both("H36MDataset", "h36m", 17, OBS, PRED, subjects=None, split="test",
                    precomputed_folder=str(folder) + "/", segments_path=seg,
                    if_load_mmgt=True, if_compute_cmd=True)
    _assert_same(ds, jds)
    assert ds.mm_indces == jds.mm_indces and len(ds.mm_indces) == len(rows)
    assert ds.mean_motion_per_class == jds.mean_motion_per_class
    assert len(ds.mean_motion_per_class) == 15  # one per H36M action class


@pytest.mark.parametrize("name", ["ZeroShotAMASSDataset", "D3PWZeroShotDataset"])
def test_3dpw_zero_shot_merges_the_splits_and_cuts_to_22_joints(tmp_path, name):
    rng = np.random.default_rng(2)
    positions = {s: {f"seq{s}{i}": (0.2 * rng.standard_normal((40, 24, 3))).astype(np.float32)
                     for i in range(2)} for s in ("train", "validation", "test")}
    np.savez(tmp_path / "data_3d_3dpw.npz", positions_3d=positions)
    rows = [{"name": k, "init": i, "pred_init": i + OBS, "pred_end": i + OBS + PRED - 1}
            for s in positions for k in positions[s] for i in (0, 11)]
    seg = str(tmp_path / "segments_test.csv")
    _write_csv(seg, rows)
    ds, jds = _both(name, "3dpw", 22, OBS, PRED, split="test", precomputed_folder=str(tmp_path),
                    segments_path=seg, if_zero_shot=True)
    _assert_same(ds, jds)
    assert len(ds.dict_indices) == 6
    assert all(a.shape[1:] == (22, 3) for a in ds.annotations)
    # outside the zero-shot test split, one split of the npz
    ds, jds = _both(name, "3dpw", 22, OBS, PRED, split="train", precomputed_folder=str(tmp_path),
                    stride=3)
    _assert_same(ds, jds)
    assert set(ds.dict_indices) == set(positions["train"])
