"""Minimal SMPL-H forward kinematics (joint positions only), numpy.

The reference preprocesses AMASS/3DPW through the external
``human_body_prior`` BodyModel on GPU (`src/data/create_amass_dataset.py:
11-12,68-81`).  Motion prediction needs only the JOINT positions, so this is
a dependency-free re-implementation of exactly that path: shape-blended rest
joints → axis-angle pose → rigid transforms down the kinematic tree →
global joint locations (+ root translation).  Offline, host-side.

A copy of ``skeletondiffusion_tpu/data/preprocess/smplh.py``, numpy on the host;
its imports are the port's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def rodrigues(aa: np.ndarray) -> np.ndarray:
    """Axis-angle [..., 3] → rotation matrices [..., 3, 3]."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    theta = np.clip(theta, 1e-12, None)
    axis = aa / theta
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = np.zeros_like(x)
    K = np.stack(
        [zeros, -z, y, z, zeros, -x, -y, x, zeros], axis=-1
    ).reshape(*aa.shape[:-1], 3, 3)
    theta = theta[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class SMPLHJoints:
    """Joint-only SMPL-H model.

    Args:
        model: dict-like with 'v_template' [V,3], 'shapedirs' [V,3,B],
            'J_regressor' [J,V], 'kintree_table' [2,J] (standard SMPL-H npz).
        num_betas: shape coefficients to use (reference uses 16,
            `create_amass_dataset.py:60-66`).
    """

    def __init__(self, model, num_betas: int = 16):
        self.v_template = np.asarray(model["v_template"], dtype=np.float64)
        shapedirs = np.asarray(model["shapedirs"], dtype=np.float64)
        self.shapedirs = shapedirs[..., :num_betas]
        J_reg = model["J_regressor"]
        if hasattr(J_reg, "toarray"):
            J_reg = J_reg.toarray()
        self.J_regressor = np.asarray(J_reg, dtype=np.float64)
        kintree = np.asarray(model["kintree_table"])
        self.parents = kintree[0].astype(np.int64)
        self.parents[0] = -1
        self.num_joints = self.J_regressor.shape[0]
        self.num_betas = num_betas

    @classmethod
    def from_file(cls, path: str, num_betas: int = 16) -> "SMPLHJoints":
        model = np.load(path, allow_pickle=True)
        return cls(model, num_betas=num_betas)

    def rest_joints(self, betas: np.ndarray) -> np.ndarray:
        """betas [B_shape] → rest joints [J,3]."""
        v_shaped = self.v_template + np.einsum("vdb,b->vd", self.shapedirs, betas[: self.num_betas])
        return self.J_regressor @ v_shaped

    def forward(
        self,
        poses: np.ndarray,
        betas: np.ndarray,
        trans: Optional[np.ndarray] = None,
        num_joints_out: Optional[int] = None,
    ) -> np.ndarray:
        """poses [T, J*3] axis-angle (root first), betas [B_shape],
        trans [T,3] → joint positions [T, J_out, 3]."""
        T = poses.shape[0]
        J = self.num_joints
        aa = poses.reshape(T, -1, 3)[:, :J]
        n_given = aa.shape[1]
        if n_given < J:  # body-only poses: identity for the missing hands
            pad = np.zeros((T, J - n_given, 3))
            aa = np.concatenate([aa, pad], axis=1)
        R = rodrigues(aa)  # [T,J,3,3]

        j_rest = self.rest_joints(betas)  # [J,3]
        # rigid FK down the tree (SMPL convention: per-joint rotation about
        # its rest position, relative to parent)
        G_rot = np.zeros((T, J, 3, 3))
        G_pos = np.zeros((T, J, 3))
        G_rot[:, 0] = R[:, 0]
        G_pos[:, 0] = j_rest[0]
        for j in range(1, J):
            p = self.parents[j]
            offset = j_rest[j] - j_rest[p]
            G_rot[:, j] = G_rot[:, p] @ R[:, j]
            G_pos[:, j] = G_pos[:, p] + np.einsum("tij,j->ti", G_rot[:, p], offset)
        joints = G_pos
        if trans is not None:
            joints = joints + trans[:, None, :]
        if num_joints_out is not None:
            joints = joints[:, :num_joints_out]
        return joints
