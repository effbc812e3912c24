"""Human3.6M dataset creation: CDF pose files → 17/25-joint positions in
meters → ``data_3d_h36m.npz``; reference `src/data/create_h36m_dataset.py`.

CDF reading requires the optional ``cdflib`` package (as upstream); when it
is unavailable, pre-extracted ``.npy`` [T,32,3] files laid out the same way
are accepted.

A copy of ``skeletondiffusion_tpu/data/preprocess/h36m.py``, numpy on the host;
its imports are the port's.
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Dict

import numpy as np

from ...skeleton.kinematic import H36MKinematic

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]


def _canonical(action: str) -> str:
    return action.replace("TakingPhoto", "Photo").replace("WalkingDog", "WalkDog").replace(" ", "_")


def create_h36m_npz(dataset_folder: str, output_path: str, num_joints: int = 17) -> Dict:
    conv = (
        H36MKinematic.CONVERSION_IDX_32TO17 if num_joints == 17
        else H36MKinematic.CONVERSION_IDX_32TO25
    )
    try:
        import cdflib  # optional, as upstream
    except ImportError:
        cdflib = None

    output: Dict[str, Dict[str, np.ndarray]] = {}
    for subject in SUBJECTS:
        base = os.path.join(dataset_folder, subject, "MyPoseFeatures", "D3_Positions")
        files = sorted(glob(os.path.join(base, "*.cdf")) + glob(os.path.join(base, "*.npy")))
        if not files:
            continue
        output[subject] = {}
        for f in files:
            action = os.path.splitext(os.path.basename(f))[0]
            if subject == "S11" and action == "Directions":
                continue  # corrupted video (reference `create_h36m_dataset.py:39-40`)
            if f.endswith(".cdf"):
                assert cdflib is not None, "cdflib required to read .cdf files"
                positions = cdflib.CDF(f)["Pose"].reshape(-1, 32, 3)
            else:
                positions = np.load(f).reshape(-1, 32, 3)
            positions = positions[:, conv, :] / 1000.0  # mm → m
            output[subject][_canonical(action)] = positions.astype(np.float32)
    from .common import save_positions_npz

    save_positions_npz(output_path, output)
    return output


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="extracted Human3.6M root")
    p.add_argument("--output", required=True, help="precomputed folder (…/Human36M/hmp)")
    p.add_argument("--num-joints", type=int, default=17, choices=(17, 25))
    p.add_argument("--annotations", default=None)
    p.add_argument("--multimodal-threshold", type=float, default=0.5)
    args = p.parse_args()

    os.makedirs(args.output, exist_ok=True)
    out_npz = os.path.join(args.output, "data_3d_h36m.npz")
    if not os.path.exists(out_npz):
        create_h36m_npz(args.input, out_npz, num_joints=args.num_joints)

    if args.annotations:
        from ...skeleton import create_skeleton
        from ..loaders import H36MDataset
        from .common import finalize_dataset

        skeleton = create_skeleton(
            dataset_name="h36m", motion_repr_type="SkeletonRescalePose",
            num_joints=args.num_joints, pose_box_size=1.5,
            obs_length=25, pred_length=100, if_consider_hip=False,
        )
        finalize_dataset(
            H36MDataset, skeleton, args.output,
            segments_path=os.path.join(args.annotations, "segments_test.csv"),
            multimodal_threshold=args.multimodal_threshold,
            subjects=["S9", "S11"], obs_length=25, pred_length=100,
        )


if __name__ == "__main__":
    main()
