"""Motion representation: the model-space → metric-space transform as a torch
function of a statically configured object.

Port of ``transform_to_metric_space`` (``skeletondiffusion_tpu/skeleton/motion.py:69-86``;
reference `src/data/skeleton/motion/{base,centerpose,rescalepose}.py`) for
``SkeletonRescalePose``, the representation of every published checkpoint.
Layout ``[..., T, J, 3]`` as there.
"""
from __future__ import annotations

import torch


class SkeletonRescalePose:
    """Hip-centred pose rescaled into a box of half-side ``pose_box_size``;
    with ``if_consider_hip=False`` (the hmp task) the model works on the
    J−1 nodes without the root."""

    def __init__(self, pose_box_size: float = 1.1, if_consider_hip: bool = False,
                 obs_length: int = 30, pred_length: int = 120, **kwargs):
        self.pose_box_size = float(pose_box_size)
        self.if_consider_hip = if_consider_hip
        self.obs_length = obs_length
        self.pred_length = pred_length

    def transform_to_metric_space(self, kpts: torch.Tensor) -> torch.Tensor:
        """Model space → 3-D metric coordinates; reference `motion/base.py:69-86`
        with `centerpose.py:20-23` and `rescalepose.py:36-39`."""
        if self.if_consider_hip:
            hip = kpts[..., :1, :]
            return torch.cat([hip, kpts[..., 1:, :] * self.pose_box_size + hip], dim=-2)
        return kpts * self.pose_box_size


def get_motion_representation_class(motion_repr_type: str):
    return {"SkeletonRescalePose": SkeletonRescalePose}[motion_repr_type]
