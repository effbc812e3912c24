"""Skeleton domain model: kinematics × motion representation.

``create_skeleton(**cfg)`` composes a kinematic class with a
motion-representation class as ``skeletondiffusion_tpu.skeleton`` does, e.g.
``create_skeleton(dataset_name='amass', motion_repr_type='SkeletonRescalePose',
num_joints=22, pose_box_size=1.5, obs_length=30, pred_length=120)``.
"""
from .kinematic import (
    AMASSKinematic,
    FreeManKinematic,
    H36MKinematic,
    Kinematic,
    get_kinematic_class,
)
from .motion import (
    MotionRepresentation,
    SkeletonCenterPose,
    SkeletonDiscreteCosineTransform,
    SkeletonRescalePose,
    center_kpts_around_hip,
    get_dct_matrix,
    get_motion_representation_class,
)

__all__ = ["AMASSKinematic", "FreeManKinematic", "H36MKinematic", "Kinematic",
           "MotionRepresentation", "SkeletonCenterPose", "SkeletonDiscreteCosineTransform",
           "SkeletonRescalePose", "center_kpts_around_hip", "create_skeleton", "get_dct_matrix"]


def create_skeleton(**kwargs):
    """Reference `src/data/skeleton/__init__.py:5-37`."""
    motion_cls = get_motion_representation_class(kwargs["motion_repr_type"])
    kin_cls, dataset_type = get_kinematic_class(kwargs["dataset_name"])

    def _init(self, *args, **kw):
        kin_cls.__init__(self, *args, **kw)
        motion_cls.__init__(self, *args, **kw)

    cls = type(dataset_type + kwargs["motion_repr_type"], (kin_cls, motion_cls), {"__init__": _init})
    return cls(**kwargs)
