"""Keypoint helpers for visualization and notebook workflows; port of
``skeletondiffusion_tpu/utils/keypoints.py`` (reference
`src/utils/keypoints.py:5-33`): numpy in, numpy out."""
from __future__ import annotations

import numpy as np
import torch


def center_kpts_around_hip(kpts: np.ndarray, hip_idx: int = 0):
    """Subtract the hip trajectory; returns (centered [..., J, 3],
    hip [..., 1, 3]); reference `keypoints.py:5-10`.  A numpy wrapper over
    the one implementation in ``skeleton.motion``, so that the centring
    cannot diverge."""
    from ..skeleton.motion import center_kpts_around_hip as _impl

    centered, hip = _impl(torch.from_numpy(np.asarray(kpts)), hip_idx)
    return centered.numpy(), hip.numpy()


def center_kpts_around_hip_and_drop_root(kpts: np.ndarray, hip_idx: int = 0):
    """Centered body keypoints without the (now-zero) root; reference
    `keypoints.py:12-15`."""
    centered, _ = center_kpts_around_hip(kpts, hip_idx)
    return np.delete(centered, hip_idx, axis=-2)


def rotate_y_axis(kpts: np.ndarray, angle_degrees: float, axis: int = 1) -> np.ndarray:
    """Rotate keypoints around one coordinate axis (default y); reference
    `keypoints.py:17-33`."""
    theta = np.deg2rad(angle_degrees)
    c, s = np.cos(theta), np.sin(theta)
    if axis == 0:
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axis == 1:
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    else:
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return np.asarray(kpts) @ rot.T
