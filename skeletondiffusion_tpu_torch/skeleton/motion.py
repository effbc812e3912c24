"""Motion representations: the input-space ↔ metric-space transforms as torch
functions of a statically configured object.

Port of ``MotionRepresentation``, ``SkeletonCenterPose`` and
``SkeletonRescalePose`` from ``skeletondiffusion_tpu/skeleton/motion.py``
(`:20-145`; reference `src/data/skeleton/motion/{base,centerpose,rescalepose}.py`).
Layout ``[..., T, J, 3]`` with the global root (hip) at joint 0 in metric
space, any leading shape.  With ``if_consider_hip=False`` (the hmp task) the
input space drops the root and works on ``J-1`` nodes.
"""
from __future__ import annotations

import torch

from .kinematic import NODE_HIP


def center_kpts_around_hip(kpts: torch.Tensor, hip_idx: int = 0):
    """(keypoints centred on the hip joint, the hip); reference
    `motion/utils.py:1-7`."""
    center = kpts[..., hip_idx : hip_idx + 1, :]
    return kpts - center, center


class MotionRepresentation:
    """Base ("Vanilla") representation; reference `motion/base.py:4-96`."""

    node_hip = NODE_HIP

    def __init__(self, if_consider_hip: bool = False, obs_length: int = 30,
                 pred_length: int = 120, seq_centering: int = 0, **kwargs):
        self.if_consider_hip = if_consider_hip
        self.obs_length = obs_length
        self.pred_length = pred_length
        self.seq_centering = seq_centering
        if not -obs_length <= seq_centering < obs_length + pred_length:
            raise ValueError(f"seq_centering={seq_centering} outside the segment")

    # ---- input space -----------------------------------------------------
    def _get_where_is_seq_centered(self) -> int:
        if self.seq_centering < 0:
            return self.obs_length + self.seq_centering
        return self.seq_centering

    def transform_hip_to_input_space(self, data: torch.Tensor) -> torch.Tensor:
        """The hip trajectory relative to frame ``seq_centering``; reference
        `motion/base.py:21-33`."""
        centered, hips = data[..., 1:, :], data[..., 0:1, :]
        t0 = self._get_where_is_seq_centered()
        hips = hips - hips[..., t0 : t0 + 1, :, :]
        return torch.cat([hips, centered], dim=-2)

    def tranform_to_input_space(self, data: torch.Tensor) -> torch.Tensor:
        """Metric space → model input space (reference `motion/base.py:35-42`,
        whose spelling is kept); drops the root unless ``if_consider_hip``."""
        data = self.tranform_to_input_space_pose_only(data)
        if not self.if_consider_hip:
            return data[..., 1:, :]
        return self.transform_hip_to_input_space(data)

    def tranform_to_input_space_pose_only(self, data: torch.Tensor) -> torch.Tensor:
        return data

    # ---- zero-pad helpers --------------------------------------------------
    def add_zero_pad_center_hip(self, kpts: torch.Tensor) -> torch.Tensor:
        """A zero root joint re-inserted at index 0; reference
        `motion/base.py:48-52`."""
        return torch.cat([torch.zeros_like(kpts[..., :1, :]), kpts], dim=-2)

    def if_add_zero_pad_center_hip(self, kpts: torch.Tensor) -> torch.Tensor:
        if not self.if_consider_hip and kpts.shape[-2] == self.num_joints - 1:
            kpts = self.add_zero_pad_center_hip(kpts)
        return kpts

    # ---- metric space ------------------------------------------------------
    def transform_hip_to_metric_space(self, kpts: torch.Tensor) -> torch.Tensor:
        return kpts

    def _merge_hip_and_poseinmetricspace(self, hip_coords, kpts):
        return torch.cat([hip_coords, kpts], dim=-2)

    def transform_to_metric_space(self, kpts: torch.Tensor) -> torch.Tensor:
        """Model space → 3-D metric coordinates; reference
        `motion/base.py:69-86`."""
        if self.if_consider_hip:
            kpts = self.transform_hip_to_metric_space(kpts)
            hip_coords = kpts[..., :1, :]
            pose = self.transform_to_metric_space_pose_only(kpts[..., 1:, :])
            return self._merge_hip_and_poseinmetricspace(hip_coords, pose)
        return self.transform_to_metric_space_pose_only(kpts)

    def transform_to_metric_space_pose_only(self, kpts: torch.Tensor) -> torch.Tensor:
        return kpts


class SkeletonCenterPose(MotionRepresentation):
    """The pose centred on the hip, the hip trajectory kept; reference
    `motion/centerpose.py:6-23`."""

    def tranform_to_input_space_pose_only(self, data: torch.Tensor) -> torch.Tensor:
        centered, hips = center_kpts_around_hip(data, hip_idx=0)
        return torch.cat([hips, centered[..., len(self.node_hip):, :]], dim=-2)

    def _merge_hip_and_poseinmetricspace(self, hip_coords, kpts):
        return super()._merge_hip_and_poseinmetricspace(hip_coords, kpts + hip_coords)


class SkeletonRescalePose(SkeletonCenterPose):
    """CenterPose rescaled into a box of half-side ``pose_box_size``;
    reference `motion/rescalepose.py:6-39`.  The representation of every
    published checkpoint."""

    def __init__(self, pose_box_size: float = 1.1, **kwargs):
        super().__init__(**kwargs)
        self.pose_box_size = float(pose_box_size)

    def tranform_to_input_space_pose_only(self, data: torch.Tensor) -> torch.Tensor:
        centered, hips = center_kpts_around_hip(data, hip_idx=0)
        centered = centered / self.pose_box_size
        return torch.cat([hips, centered[..., 1:, :]], dim=-2)

    def transform_to_metric_space_pose_only(self, kpts: torch.Tensor) -> torch.Tensor:
        return kpts * self.pose_box_size


def get_motion_representation_class(motion_repr_type: str):
    """Reference `motion/__init__.py:8-9`; the DCT representation is not
    ported."""
    return {
        "SkeletonVanilla": MotionRepresentation,
        "SkeletonCenterPose": SkeletonCenterPose,
        "SkeletonRescalePose": SkeletonRescalePose,
    }[motion_repr_type]
