"""Motion representations: the input-space ↔ metric-space transforms as torch
functions of a statically configured object.

Port of ``MotionRepresentation``, ``SkeletonCenterPose``,
``SkeletonRescalePose``, ``get_dct_matrix`` and
``SkeletonDiscreteCosineTransform`` from
``skeletondiffusion_tpu/skeleton/motion.py`` (`:20-205`; reference
`src/data/skeleton/motion/{base,centerpose,rescalepose,dct}.py`).
Layout ``[..., T, J, 3]`` with the global root (hip) at joint 0 in metric
space, any leading shape.  With ``if_consider_hip=False`` (the hmp task) the
input space drops the root and works on ``J-1`` nodes.
"""
from __future__ import annotations

import math

import numpy as np
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


def get_dct_matrix(N: int) -> tuple[np.ndarray, np.ndarray]:
    """The orthonormal DCT-II matrix of N points and its inverse, float64;
    reference `motion/dct.py`."""
    k = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    w = np.where(k == 0, math.sqrt(1.0 / N), math.sqrt(2.0 / N))
    dct_m = w * np.cos(np.pi * (i + 0.5) * k / N)
    return dct_m, np.linalg.inv(dct_m)


class SkeletonDiscreteCosineTransform(SkeletonCenterPose):
    """CenterPose, then a DCT-II over the time axis of the observed and the
    future segments, each with its own length; the inverse DCT back to metric
    space.  No shipped config uses it.  Reference `motion/dct.py:39-80`."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        as_f32 = lambda m: torch.from_numpy(m.astype(np.float32))  # noqa: E731
        dct_fut, idct_fut = get_dct_matrix(self.pred_length)
        dct_past, idct_past = get_dct_matrix(self.obs_length)
        self.dct_m_fut, self.idct_m_fut = as_f32(dct_fut), as_f32(idct_fut)
        self.dct_m_past, self.idct_m_past = as_f32(dct_past), as_f32(idct_past)

    @staticmethod
    def _apply(m: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        return torch.einsum("dn,...ncf->...dcf", m.to(data.device, data.dtype), data)

    def tranform_to_input_space_pose_only(self, data: torch.Tensor) -> torch.Tensor:
        """Reference `dct.py:50-59`: each segment's DCT after centring."""
        data = super().tranform_to_input_space_pose_only(data)
        if data.shape[-3] == self.pred_length:
            return self._apply(self.dct_m_fut, data)
        obs, fut = data[..., : self.obs_length, :, :], data[..., self.obs_length :, :, :]
        return torch.cat([self._apply(self.dct_m_past, obs), self._apply(self.dct_m_fut, fut)],
                         dim=-3)

    def transform_to_metric_space_pose_only(self, kpts: torch.Tensor) -> torch.Tensor:
        """Reference `dct.py:75-80`: the inverse DCT of a future or an
        observed segment."""
        if kpts.shape[-3] not in (self.pred_length, self.obs_length):
            raise ValueError(f"a segment of {kpts.shape[-3]} frames is neither the observed "
                             f"({self.obs_length}) nor the future ({self.pred_length})")
        idct = self.idct_m_fut if kpts.shape[-3] == self.pred_length else self.idct_m_past
        return self._apply(idct, kpts)


def get_motion_representation_class(motion_repr_type: str):
    """Reference `motion/__init__.py:8-9`."""
    return {
        "SkeletonVanilla": MotionRepresentation,
        "SkeletonCenterPose": SkeletonCenterPose,
        "SkeletonRescalePose": SkeletonRescalePose,
        "SkeletonDiscreteCosineTransform": SkeletonDiscreteCosineTransform,
    }[motion_repr_type]
