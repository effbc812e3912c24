"""FreeMan dataset creation: smoothnet 3D keypoints → 18-joint skeleton
(COCO order → hip-rooted, synthetic pelvis, meters, axis flip) →
``data_3d_freeman.npz``; reference `src/data/create_freeman_dataset.py`.

A copy of ``skeletondiffusion_tpu/data/preprocess/freeman.py``, numpy on the host;
its imports are the port's.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
from typing import Dict

import numpy as np


def preprocess_kpts(positions: np.ndarray) -> np.ndarray:
    """COCO-ish 17-joint → 18-joint hip-rooted layout; reference
    `create_freeman_dataset.py:32-46`."""
    assert not np.isnan(positions).any(), "Sequence has nan!"
    # move hips/legs (11:) before the head/arm block (:11)
    positions = np.concatenate([positions[..., 11:, :], positions[..., :11, :]], axis=-2)
    # synthesize the pelvis root as the LHip/RHip midpoint
    root = positions[..., 0:1, :] + (positions[..., 1:2, :] - positions[..., 0:1, :]) / 2
    positions = np.concatenate([root, positions], axis=-2)
    positions = positions / 100.0  # cm → m
    positions[..., 2] *= -1  # invert vertical axis
    return positions


def remove_illposed_frames(seq_name: str, kpts: np.ndarray, illposed: Dict):
    """Slice out curated ill-posed frame ranges; reference
    `create_freeman_dataset.py:16-30`."""
    if seq_name not in illposed:
        return [kpts], [0]
    slices = illposed[seq_name]
    out, starts = [], []
    for s in slices:
        sl = kpts[s[0] : s[1]]
        assert not np.isnan(sl).any()
        out.append(sl)
        starts.append(s[0])
    return out, starts


def create_freeman_npz(dataset_folder: str, annotation_folder: str, output_path: str) -> Dict:
    with open(os.path.join(dataset_folder, "ignore_list.txt")) as f:
        ignore = {line.strip() for line in f}
    bad_path = os.path.join(annotation_folder, "bad_sequences.json")
    if os.path.exists(bad_path):
        with open(bad_path) as f:
            ignore |= set(json.load(f))
    illposed = {}
    ill_path = os.path.join(annotation_folder, "illlposed_slices_idxs.json")
    if os.path.exists(ill_path):
        with open(ill_path) as f:
            illposed = ast.literal_eval(json.load(f))

    # label map, used to drop too-short discarded multi-slice sequences the
    # way the reference does (`create_freeman_dataset.py:66-73,93-97`)
    file2action: Dict[str, str] = {}
    labels_path = os.path.join(annotation_folder, "seq_actions_labels.txt")
    if os.path.exists(labels_path):
        with open(labels_path) as f:
            for line in f:
                name, label = line.strip().split(",")
                file2action[name] = label
                file2action.setdefault(name.split("_slice")[0], label)

    kpts_dir = os.path.join(dataset_folder, "keypoints3d")
    sequences = [
        f[: -len(".npy")] for f in sorted(os.listdir(kpts_dir))
        if f.endswith(".npy") and f[: -len(".npy")] not in ignore
    ]
    output: Dict[str, np.ndarray] = {}
    for seq in sequences:
        raw = np.load(os.path.join(kpts_dir, seq + ".npy"), allow_pickle=True)
        if raw.dtype == object:
            # upstream raw format: object array whose first element is a dict
            # of keypoint variants; smoothnet32 > smoothnet > optim priority
            # (reference `create_freeman_dataset.py:83-88`)
            d = raw[0]
            for key in ("keypoints3d_smoothnet32", "keypoints3d_smoothnet",
                        "keypoints3d_optim"):
                if key in d:
                    raw = np.asarray(d[key])
                    break
            else:
                raise KeyError(f"{seq}: no keypoints3d variant in {sorted(d)}")
        if raw.ndim == 4:  # [1,T,17,3]
            raw = raw[0]
        slices, _ = remove_illposed_frames(seq, raw, illposed)
        # npz key naming MUST match the shipped annotation/split files:
        # a single slice keeps the plain sequence name even when trimmed
        # (reference `create_freeman_dataset.py:26-28,100-102`); multiple
        # slices get a 1-BASED _slice{i} suffix (`:93`), and slices of
        # unlabeled (too-short discarded) sequences are dropped (`:95-97`)
        if len(slices) == 1:
            output[seq] = preprocess_kpts(slices[0]).astype(np.float32)
        else:
            for i, sl in enumerate(slices):
                if not file2action or seq in file2action:
                    output[f"{seq}_slice{i + 1}"] = preprocess_kpts(sl).astype(np.float32)
    from .common import save_positions_npz

    save_positions_npz(output_path, output)
    return output


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="FreeMan root (keypoints3d/, ignore_list.txt)")
    p.add_argument("--annotations", required=True, help="annotations folder (split lists, labels)")
    p.add_argument("--output", required=True, help="precomputed folder (…/FreeMan/hmp)")
    p.add_argument("--multimodal-threshold", type=float, default=0.5)
    args = p.parse_args()

    os.makedirs(args.output, exist_ok=True)
    out_npz = os.path.join(args.output, "data_3d_freeman.npz")
    if not os.path.exists(out_npz):
        create_freeman_npz(args.input, args.annotations, out_npz)

    from ...skeleton import create_skeleton
    from ..loaders import FreeManDataset
    from .common import finalize_dataset

    skeleton = create_skeleton(
        dataset_name="freeman", motion_repr_type="SkeletonRescalePose", num_joints=18,
        pose_box_size=1.5, obs_length=15, pred_length=60, if_consider_hip=False,
    )
    finalize_dataset(
        FreeManDataset, skeleton, args.output,
        segments_path=os.path.join(args.annotations, "segments_test.csv"),
        multimodal_threshold=args.multimodal_threshold,
        annotations_folder=args.annotations, obs_length=15, pred_length=60,
    )


if __name__ == "__main__":
    main()
