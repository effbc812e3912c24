"""3DPW dataset creation for zero-shot evaluation: sequence pkls → SMPL-H
joints at 60 Hz, permuted/mirrored into the AMASS convention →
``data_3d_3dpw.npz``; reference `src/data/create_3dpw_dataset.py`.

A copy of ``skeletondiffusion_tpu/data/preprocess/d3pw.py``, numpy on the host;
its imports are the port's.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict

import numpy as np

# 3DPW's left/right limb order is inverted vs AMASS (`create_3dpw_dataset.py:84-87`)
LR_SWAP_24 = [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18, 21, 20, 22, 23]


def create_3dpw_npz(dataset_path: str, models_dir: str, output_path: str, num_betas: int = 10) -> Dict:
    from .amass import load_body_models

    models = load_body_models(models_dir, num_betas=num_betas)
    output: Dict[str, Dict[str, np.ndarray]] = {}
    for split in sorted(os.listdir(dataset_path)):
        split_path = os.path.join(dataset_path, split)
        if not os.path.isdir(split_path):
            continue
        split_name = "valid" if split == "validation" else split
        output[split_name] = {}
        for pkl in sorted(os.listdir(split_path)):
            with open(os.path.join(split_path, pkl), "rb") as reader:
                ann = pickle.load(reader, encoding="latin1")
            seq_name = os.path.splitext(pkl)[0]
            for actor in range(len(ann["genders"])):
                gender = "male" if ann["genders"][actor] == "m" else "female"
                model = models.get(gender) or next(iter(models.values()))
                poses = np.asarray(ann["poses_60Hz"][actor], dtype=np.float64)
                trans = np.asarray(ann["trans_60Hz"][actor], dtype=np.float64)
                betas = np.asarray(ann["betas"][actor], dtype=np.float64)
                joints = model.forward(
                    poses=poses[:, :66], betas=betas, trans=trans, num_joints_out=24
                )
                # axis permute (x,z,y) + L/R swap to the AMASS convention
                joints = np.stack([joints[..., 0], joints[..., 2], joints[..., 1]], axis=-1)
                joints = joints[:, LR_SWAP_24, :]
                key = seq_name if len(ann["genders"]) == 1 else f"{seq_name}_actor{actor}"
                output[split_name][key] = joints.astype(np.float32)
    from .common import save_positions_npz

    save_positions_npz(output_path, output)
    return output


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="3DPW sequenceFiles root (train/validation/test)")
    p.add_argument("--models", required=True, help="SMPL-H body model dir")
    p.add_argument("--output", required=True, help="precomputed folder (…/3DPW/hmp)")
    args = p.parse_args()

    os.makedirs(args.output, exist_ok=True)
    out_npz = os.path.join(args.output, "data_3d_3dpw.npz")
    if not os.path.exists(out_npz):
        create_3dpw_npz(args.input, args.models, out_npz)


if __name__ == "__main__":
    main()
