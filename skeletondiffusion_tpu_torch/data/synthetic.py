"""Synthetic AMASS-format dataset generator for smoke tests and the eval
path — the full on-disk layout the loaders expect (reference `README.md`
data-creation flow, `create_amass_dataset.py:262-302` finishing steps) from
random clips, no AMASS download.

A copy of ``skeletondiffusion_tpu/data/synthetic.py`` (`:155`, `:273`)
whose CSV files are written with the standard ``csv`` module: the same seed
writes the same arrays and the same CSV rows as the JAX package.

Produces under ``<root>/datasets``:
    processed/AMASS/hmp/data_3d_amass.npz     train+test clips
    processed/AMASS/hmp/mmgt_<split>.txt      precomputed mm-GT neighbors
    processed/AMASS/hmp/mean_motion_test.txt  CMD class statistics
    annotations/AMASS/hmp/segments_test.csv   eval segment windows
    annotations/AMASS/hmp/mmapd_GT.csv        APDE ground-truth stub
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def write_csv(path: str, rows: List[dict]) -> None:
    """Rows of dicts as ``pandas.DataFrame(rows).to_csv(path, index=False)``
    writes them: a header of the first row's keys, ``\\n`` line ends, floats
    in their shortest round-trip form."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        if rows:
            writer.writerow(list(rows[0]))
        writer.writerows([list(row.values()) for row in rows])


# ---------------------------------------------------------------------------
# Procedural rigid-skeleton motion (the convergence-capstone dataset)
# ---------------------------------------------------------------------------

# SMPL-H 22-joint rest offsets (metres, z-up, person facing +y): child joint =
# parent + R_chain @ offset.  Parent topology is the AMASS limbseq
# (reference `src/data/skeleton/kinematic/amass.py:54-58`); the offsets are
# hand-set at human scale so limb lengths are rigid and plausible — they do
# NOT need to match any real SMPL body, only to be constant per clip so
# limb-realism metrics are meaningful.
_AMASS22_OFFSETS = {
    1: (+0.095, 0.0, -0.055), 2: (-0.095, 0.0, -0.055), 3: (0.0, 0.0, +0.12),
    4: (0.0, 0.0, -0.38), 5: (0.0, 0.0, -0.38), 6: (0.0, 0.0, +0.13),
    7: (0.0, 0.0, -0.40), 8: (0.0, 0.0, -0.40), 9: (0.0, 0.0, +0.18),
    10: (0.0, +0.13, -0.06), 11: (0.0, +0.13, -0.06),
    12: (0.0, 0.0, +0.07), 13: (+0.07, 0.0, +0.02), 14: (-0.07, 0.0, +0.02),
    15: (0.0, 0.0, +0.12),
    16: (+0.105, 0.0, -0.01), 17: (-0.105, 0.0, -0.01),
    18: (+0.015, 0.0, -0.27), 19: (-0.015, 0.0, -0.27),
    20: (0.0, 0.0, -0.25), 21: (0.0, 0.0, -0.25),
}
_AMASS22_PARENTS = {
    1: 0, 2: 0, 3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7, 11: 8,
    12: 9, 13: 9, 14: 9, 15: 12, 16: 13, 17: 14, 18: 16, 19: 17, 20: 18, 21: 19,
}

# articulation spec: joint -> (axis, amplitude rad, gait-phase offset, bias)
# — the rotation applies to the joint's whole subtree (proper FK), so hips
# swing legs, shoulders swing arms, spine twists the torso.
_GAIT_SPEC = {
    1: (0, 0.50, 0.0, 0.0),        # LHip swing (x axis)
    2: (0, 0.50, np.pi, 0.0),      # RHip antiphase
    4: (0, 0.40, -1.2, 0.45),      # LKnee flex
    5: (0, 0.40, np.pi - 1.2, 0.45),
    7: (0, 0.20, 0.6, 0.10),       # heels
    8: (0, 0.20, np.pi + 0.6, 0.10),
    3: (2, 0.10, 0.0, 0.0),        # Spine1 twist (z axis)
    6: (2, 0.07, np.pi, 0.0),      # Spine3 counter-twist
    9: (2, 0.05, 0.0, 0.0),        # Neck
    16: (0, 0.30, np.pi, 0.0),     # LShoulder antiphase with LHip
    17: (0, 0.30, 0.0, 0.0),       # RShoulder
    18: (0, 0.18, np.pi, 0.40),    # elbows: flexion bias + swing
    19: (0, 0.18, 0.0, 0.40),
}

# action classes (per sub-dataset name): gait frequency [Hz], walking speed
# [m/s], articulation amplitude scale.  Distinct classes give the CMD metric
# genuinely different per-class mean motions.
_ACTION_CLASSES = [
    (0.9, 0.55, 0.85),   # stroll
    (1.4, 1.00, 1.00),   # walk
    (1.9, 1.50, 1.15),   # brisk walk
    (1.1, 0.15, 1.30),   # sway in place, big arm motion
]


def _axis_rots(axis: int, theta: np.ndarray) -> np.ndarray:
    """[T] angles -> [T, 3, 3] rotations about the x/y/z axis."""
    c, s = np.cos(theta), np.sin(theta)
    T = theta.shape[0]
    R = np.zeros((T, 3, 3), dtype=np.float64)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R[:, axis, axis] = 1.0
    R[:, i, i] = c
    R[:, j, j] = c
    R[:, i, j] = -s
    R[:, j, i] = s
    return R


def _piecewise_constant(rng: np.random.Generator, n_frames: int, fps: float,
                        values: np.ndarray, seg_sec: Tuple[float, float],
                        blend_frames: int = 12) -> np.ndarray:
    """Random piecewise-constant signal with linear blends at the (random)
    segment boundaries — the source of genuine multimodality: an observation
    window near a boundary has several plausible continuations."""
    out = np.empty(n_frames)
    t = 0
    while t < n_frames:
        dur = int(rng.uniform(*seg_sec) * fps)
        out[t:t + dur] = rng.choice(values)
        t += dur
    if blend_frames > 1:
        kernel = np.ones(blend_frames) / blend_frames
        pad = np.concatenate([out[:1].repeat(blend_frames), out,
                              out[-1:].repeat(blend_frames)])
        out = np.convolve(pad, kernel, mode="same")[blend_frames:blend_frames + n_frames]
    return out


def _generate_motion_clip(rng: np.random.Generator, n_frames: int, fps: float,
                          action_class: int) -> np.ndarray:
    """One [T, 22, 3] float32 clip of procedural walking-like motion:
    rigid limbs (FK with fixed offsets), class-dependent gait, and
    piecewise-random turn-rate/speed so futures are multimodal."""
    f_hz, speed, amp_scale = _ACTION_CLASSES[action_class % len(_ACTION_CLASSES)]
    f_hz *= rng.uniform(0.9, 1.1)
    body_scale = rng.uniform(0.92, 1.08)
    amp_scale *= rng.uniform(0.85, 1.15)
    phase0 = rng.uniform(0, 2 * np.pi)

    dt = 1.0 / fps
    # turn-rate: piecewise segments of 0.75-1.5 s, values in rad/s
    turn = _piecewise_constant(rng, n_frames, fps,
                               np.array([-1.5, -0.6, 0.0, 0.0, 0.6, 1.5]),
                               seg_sec=(0.75, 1.5))
    speed_t = speed * _piecewise_constant(rng, n_frames, fps,
                                          np.array([0.7, 1.0, 1.0, 1.3]),
                                          seg_sec=(1.0, 2.0))
    heading = rng.uniform(0, 2 * np.pi) + np.cumsum(turn) * dt
    phase = phase0 + 2 * np.pi * f_hz * np.arange(n_frames) * dt

    # root trajectory: integrate heading, vertical gait bob
    vel = np.stack([-np.sin(heading), np.cos(heading), np.zeros(n_frames)], -1)
    root = np.cumsum(vel * speed_t[:, None] * dt, axis=0)
    root[:, 2] = 0.91 * body_scale + 0.025 * np.sin(2 * phase)

    # per-clip articulation jitter
    jitter = {j: rng.uniform(0.8, 1.2) for j in _GAIT_SPEC}

    R = {0: _axis_rots(2, heading)}
    p = {0: root}
    for child in range(1, 22):
        parent = _AMASS22_PARENTS[child]
        off = np.asarray(_AMASS22_OFFSETS[child]) * body_scale
        p[child] = p[parent] + np.einsum("tij,j->ti", R[parent], off)
        if child in _GAIT_SPEC:
            axis, amp, ph_off, bias = _GAIT_SPEC[child]
            theta = bias + amp * amp_scale * jitter[child] * np.sin(phase + ph_off)
            R[child] = np.einsum("tij,tjk->tik", R[parent], _axis_rots(axis, theta))
        else:
            R[child] = R[parent]
    return np.stack([p[j] for j in range(22)], axis=1).astype(np.float32)


def make_synthetic_amass_motion(
    root: str,
    *,
    obs_length: int = 30,
    pred_length: int = 120,
    fps: float = 60.0,
    train_datasets: Sequence[str] = ("ACCAD", "CMU", "BMLmovi", "KIT"),
    valid_datasets: Sequence[str] = ("HumanEva",),
    test_datasets: Sequence[str] = ("DFaust", "GRAB"),
    files_per_dataset: int = 25,
    clip_len: int = 480,
    test_segment_stride: int = 30,
    multimodal_threshold: float = 0.4,
    pose_box_size: float = 1.2,
    seed: int = 0,
) -> str:
    """Learnable synthetic AMASS tree for the convergence capstone: smooth,
    rigid-limb, class-structured walking motion where the future is largely
    predictable from the observation (a trained model must beat
    ZeroVelocity by a wide margin) yet genuinely multimodal (random
    turn/speed switches inside the prediction window).  Same on-disk layout
    as :func:`make_synthetic_amass`; returns ``<root>/datasets``."""
    assert clip_len >= obs_length + pred_length + test_segment_stride

    ds_root = os.path.join(root, "datasets")
    pre = os.path.join(ds_root, "processed", "AMASS", "hmp")
    ann = os.path.join(ds_root, "annotations", "AMASS", "hmp")
    os.makedirs(pre, exist_ok=True)
    os.makedirs(ann, exist_ok=True)

    rng = np.random.default_rng(seed)
    all_ds = (*train_datasets, *valid_datasets, *test_datasets)
    positions: Dict[str, Dict[int, np.ndarray]] = {}
    for di, ds in enumerate(all_ds):
        positions[ds] = {
            fi: _generate_motion_clip(rng, clip_len, fps, action_class=di)
            for fi in range(files_per_dataset)
        }
    np.savez(os.path.join(pre, "data_3d_amass.npz"), positions_3d=positions)

    rows = [
        {"dataset": ds, "file": f"f{fi}", "file_idx": fi,
         "pred_init": init, "pred_end": init + pred_length - 1}
        for ds in test_datasets
        for fi in range(files_per_dataset)
        for init in range(obs_length, clip_len - pred_length, test_segment_stride)
    ]
    segments_path = os.path.join(ann, "segments_test.csv")
    write_csv(segments_path, rows)

    from ..skeleton import create_skeleton
    from .loaders import AMASSDataset
    from .mmgt import finalize_dataset

    skeleton = create_skeleton(
        dataset_name="amass", motion_repr_type="SkeletonRescalePose",
        num_joints=22, pose_box_size=pose_box_size, obs_length=obs_length,
        pred_length=pred_length, if_consider_hip=False,
    )
    finalize_dataset(
        AMASSDataset, skeleton,
        precomputed_folder=pre + "/",
        segments_path=segments_path,
        multimodal_threshold=multimodal_threshold,
        datasets=list(test_datasets),
        obs_length=obs_length, pred_length=pred_length, dtype="float32",
    )

    # real mmapd_GT.csv (not the smoke stub): per-segment APD of the mm-GT
    # future set in metric space, so the APDE metric measures a true
    # diversity gap (reference ships this file precomputed per dataset)
    mm_ds = AMASSDataset(
        datasets=list(test_datasets), split="test", precomputed_folder=pre + "/",
        skeleton=skeleton, obs_length=obs_length, pred_length=pred_length,
        segments_path=segments_path, if_consider_hip=False, if_load_mmgt=True,
        silent=True,
    )
    # every segment's mm-GT futures through the input and metric transforms
    # at once (elementwise, so the same values as one segment at a time)
    mm_sets = [mm_ds[i][2]["mm_gt"] for i in range(len(mm_ds))]
    counts = [m.shape[0] for m in mm_sets]
    if mm_sets:
        flat_in = torch.from_numpy(np.concatenate(mm_sets, axis=0))
        all_fut = skeleton.transform_to_metric_space(
            skeleton.tranform_to_input_space(flat_in)).numpy()
    else:  # test split produced zero segments: write an empty mmapd_GT.csv
        all_fut = np.zeros((0,), dtype=np.float64)
    gt_apds = []
    off = 0
    for c in counts:
        flat = all_fut[off:off + c].reshape(c, -1).astype(np.float64)
        off += c
        if c < 2:
            gt_apds.append(0.0)
            continue
        d = np.linalg.norm(flat[:, None] - flat[None], axis=-1)
        iu = np.triu_indices(c, k=1)
        gt_apds.append(float(d[iu].mean()))
    write_csv(os.path.join(ann, "mmapd_GT.csv"),
              [{"id": i, "gt_APD": v} for i, v in enumerate(gt_apds)])
    return ds_root


def make_synthetic_amass(
    root: str,
    *,
    obs_length: int = 6,
    pred_length: int = 15,
    train_datasets: Sequence[str] = ("ACCAD", "CMU"),
    test_datasets: Sequence[str] = ("DFaust",),
    files_per_dataset: int = 2,
    clip_len: int = 60,
    segment_stride: int = 9,
    multimodal_threshold: float = 0.4,
    amplitude: float = 0.3,
    num_joints: int = 22,
    pose_box_size: float = 1.1,
    seed: int = 0,
    dataset_name: str = "amass",
    dataset_dir: str = "AMASS",
) -> str:
    """Build the dataset tree of random clips; returns ``<root>/datasets``.
    Defaults match the 0.1 s/0.25 s @60 fps smoke task (observe 6, predict
    15).  ``num_joints``, ``dataset_name`` and ``dataset_dir`` are the JAX
    generator's; the port's skeleton has the 22-joint AMASS body only."""
    assert clip_len >= obs_length + pred_length + segment_stride, (
        clip_len, obs_length, pred_length)

    ds_root = os.path.join(root, "datasets")
    pre = os.path.join(ds_root, "processed", dataset_dir, "hmp")
    ann = os.path.join(ds_root, "annotations", dataset_dir, "hmp")
    os.makedirs(pre, exist_ok=True)
    os.makedirs(ann, exist_ok=True)

    rng = np.random.default_rng(seed)
    positions = {
        ds: {
            fi: (rng.standard_normal((clip_len, num_joints, 3)) * amplitude
                 ).astype(np.float32)
            for fi in range(files_per_dataset)
        }
        for ds in (*train_datasets, *test_datasets)
    }
    np.savez(os.path.join(pre, "data_3d_amass.npz"), positions_3d=positions)

    rows = [
        {"dataset": ds, "file": f"f{fi}", "file_idx": fi,
         "pred_init": init, "pred_end": init + pred_length - 1}
        for ds in test_datasets
        for fi in range(files_per_dataset)
        for init in range(obs_length, clip_len - pred_length, segment_stride)
    ]
    segments_path = os.path.join(ann, "segments_test.csv")
    write_csv(segments_path, rows)
    write_csv(os.path.join(ann, "mmapd_GT.csv"),
              [{"id": i, "gt_APD": 1.0} for i in range(len(rows))])

    # finishing steps as the preprocessing does them: mm-GT neighbor
    # file + CMD mean-motion statistics
    from ..skeleton import create_skeleton
    from .loaders import AMASSDataset
    from .mmgt import finalize_dataset

    skeleton = create_skeleton(
        dataset_name=dataset_name, motion_repr_type="SkeletonRescalePose",
        num_joints=num_joints, pose_box_size=pose_box_size, obs_length=obs_length,
        pred_length=pred_length, if_consider_hip=False,
    )
    finalize_dataset(
        AMASSDataset, skeleton,
        precomputed_folder=pre + "/",
        segments_path=segments_path,
        multimodal_threshold=multimodal_threshold,
        datasets=list(test_datasets),
        obs_length=obs_length, pred_length=pred_length, dtype="float32",
    )
    return ds_root
