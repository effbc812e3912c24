"""Offline dataset-creation pipelines (reference `src/data/create_*.py`):
raw mocap archives → ``data_3d_<name>.npz`` + CMD mean motions + mm-GT.

A copy of ``skeletondiffusion_tpu/data/preprocess/__init__.py``, numpy on the host;
its imports are the port's.
"""
from .smplh import SMPLHJoints, rodrigues

__all__ = ["SMPLHJoints", "rodrigues"]
