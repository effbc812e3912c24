"""AMASS (and AMASS-MANO) dataset creation: mocap archives → SMPL-H joint
positions at 60 fps → ``data_3d_amass.npz``.

Reference `src/data/create_amass_dataset.py` (tar.bz2 → BodyModel FK on GPU
→ zarr → npz).  Here: tar.bz2 OR pre-extracted directories → numpy SMPL-H
FK (joints only) → npz directly; the FK is embarrassingly parallel over
sequences but runs offline, so plain numpy on host suffices
(README.md:189: ~1 h CPU upstream).

Usage:
    python -m skeletondiffusion_tpu.data.preprocess.amass \
        --input datasets/raw/AMASS --models datasets/body_models/smplh \
        --output datasets/processed/AMASS/hmp [--include-hands]

A copy of ``skeletondiffusion_tpu/data/preprocess/amass.py``, numpy on the host;
its imports are the port's.
"""
from __future__ import annotations

import argparse
import os
import tarfile
from io import BytesIO
from typing import Dict, Optional

import numpy as np

from .smplh import SMPLHJoints

TARGET_FPS = 60
# reference train/valid/test dataset-name splits (`create_amass_dataset.py:224-226`)
AMASS_SPLITS = {
    "train": ["ACCAD", "BMLhandball", "BMLmovi", "BMLrub", "EKUT", "CMU",
              "EyesJapanDataset", "KIT", "PosePrior", "TCDHands", "TotalCapture"],
    "valid": ["HumanEva", "HDM05", "SFU", "MoSh"],
    "test": ["DFaust", "DanceDB", "GRAB", "HUMAN4D", "SOMA", "SSM", "Transitions"],
}


def load_body_models(models_dir: str, num_betas: int = 16) -> Dict[str, SMPLHJoints]:
    """Gendered SMPL-H models: ``<models_dir>/{male,female,neutral}/model.npz``."""
    models = {}
    for gender in ("male", "female", "neutral"):
        path = os.path.join(models_dir, gender, "model.npz")
        if os.path.exists(path):
            models[gender] = SMPLHJoints.from_file(path, num_betas=num_betas)
    assert models, f"no SMPL-H model npz found under {models_dir}"
    return models


def _iter_sequences(path: str):
    """Yield (name, npz dict) from a tar.bz2 archive or an extracted dir."""
    if os.path.isdir(path):
        for root, _, files in os.walk(path):
            for fn in sorted(files):
                if fn.endswith(".npz") and not fn.startswith("."):
                    yield os.path.join(root, fn), np.load(os.path.join(root, fn))
    else:
        tar = tarfile.open(path, "r")
        for member in tar:
            fn = os.path.basename(member.name)
            if fn.endswith(".npz") and not fn.startswith("."):
                with tar.extractfile(member) as f:
                    buf = BytesIO(f.read())
                    buf.seek(0)
                    yield member.name, np.load(buf)


def process_sequence(bdata, models: Dict[str, SMPLHJoints], num_joints: int) -> Optional[np.ndarray]:
    """One mocap npz → [T', num_joints, 3] at 60 fps; reference
    `create_amass_dataset.py:48-86`."""
    if "mocap_framerate" in bdata:
        frame_rate = float(bdata["mocap_framerate"])
    elif "mocap_frame_rate" in bdata:
        frame_rate = float(bdata["mocap_frame_rate"])
    else:
        return None
    gender = str(bdata["gender"]).replace("b'", "").replace("'", "")
    model = models.get(gender) or models.get("neutral") or next(iter(models.values()))
    frame_multiplier = max(int(np.round(frame_rate / TARGET_FPS)), 1)
    joints = model.forward(
        poses=np.asarray(bdata["poses"], dtype=np.float64),
        betas=np.asarray(bdata["betas"], dtype=np.float64),
        trans=np.asarray(bdata["trans"], dtype=np.float64),
        num_joints_out=num_joints,
    )
    return joints[::frame_multiplier].astype(np.float32)


def create_amass_npz(
    input_dir: str, models_dir: str, output_path: str,
    include_hands: bool = False, num_betas: int = 16,
) -> Dict:
    num_joints = 52 if include_hands else 22
    models = load_body_models(models_dir, num_betas=num_betas)
    positions: Dict[str, Dict[int, np.ndarray]] = {}
    datasets = sorted(os.listdir(input_dir))
    for ds_entry in datasets:
        ds_path = os.path.join(input_dir, ds_entry)
        # skip stray non-archive files (README, .DS_Store, …): a
        # tarfile.ReadError hours into a multi-dataset run is not acceptable
        if not os.path.isdir(ds_path) and not tarfile.is_tarfile(ds_path):
            print(f"skipping non-archive entry {ds_entry}")
            continue
        ds_name = ds_entry.replace(".tar.bz2", "")
        file_idx = 0
        out: Dict[int, np.ndarray] = {}
        for name, bdata in _iter_sequences(ds_path):
            try:
                joints = process_sequence(bdata, models, num_joints)
            except Exception as e:  # skip corrupted members like the reference
                print(f"WARNING: skipping {name}: {e}")
                continue
            if joints is None or len(joints) == 0:
                continue
            out[file_idx] = joints
            file_idx += 1
        if out:
            positions[ds_name] = out
            print(f"{ds_name}: {file_idx} sequences")
    from .common import save_positions_npz

    save_positions_npz(output_path, positions)
    return positions


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="dir of AMASS sub-dataset archives/dirs")
    p.add_argument("--models", required=True, help="SMPL-H body model dir")
    p.add_argument("--output", required=True, help="precomputed folder (…/AMASS/hmp)")
    p.add_argument("--include-hands", action="store_true", help="52-joint AMASS-MANO")
    p.add_argument("--annotations", default=None, help="annotations folder with segments_test.csv")
    p.add_argument("--multimodal-threshold", type=float, default=0.4)
    args = p.parse_args()

    os.makedirs(args.output, exist_ok=True)
    out_npz = os.path.join(args.output, "data_3d_amass.npz")
    if not os.path.exists(out_npz):
        create_amass_npz(args.input, args.models, out_npz, include_hands=args.include_hands)

    if args.annotations:
        from ...skeleton import create_skeleton
        from ..loaders import AMASSDataset
        from .common import finalize_dataset

        skeleton = create_skeleton(
            dataset_name="amass", motion_repr_type="SkeletonRescalePose",
            num_joints=52 if args.include_hands else 22, pose_box_size=1.5,
            obs_length=30, pred_length=120, if_consider_hip=False,
        )
        finalize_dataset(
            AMASSDataset, skeleton, args.output,
            segments_path=os.path.join(args.annotations, "segments_test.csv"),
            multimodal_threshold=args.multimodal_threshold,
            datasets=AMASS_SPLITS["test"], obs_length=30, pred_length=120,
        )


if __name__ == "__main__":
    main()
