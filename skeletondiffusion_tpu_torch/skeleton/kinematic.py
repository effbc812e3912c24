"""AMASS kinematic skeleton: joint dictionary, limb sequence, node graph (with
the hip-triangle reconnection applied when the root is dropped), mirror
node types, parents, left/right flags, limb-angle groups, the
adjacency/reachability matrices (host-side numpy) and limb-length
extraction (torch).

Port of ``skeletondiffusion_tpu/skeleton/kinematic.py`` (reference
`src/data/skeleton/kinematic/{base,amass}.py`) restricted to the 22-joint
AMASS skeleton.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .graph import get_adj_matrix, parents_from_limbseq, reachability_matrix

NODE_HIP = {0: "GlobalRoot"}  # reference `motion/base.py:5`


class Kinematic:
    """Abstract kinematic skeleton; subclasses populate ``joint_dict_orig``,
    ``limbseq``, ``node_dict`` and ``node_limbseq``."""

    joint_dict_orig: Dict[int, str]
    limbseq: np.ndarray
    node_dict: Dict[int, str]
    node_limbseq: List[List[int]]
    left_right_limb_list: List[bool]
    limb_angles_idx: List[List[int]]

    def __init__(self, if_consider_hip: bool = False, **kwargs):
        self.if_consider_hip = if_consider_hip

    @property
    def num_joints(self) -> int:
        return len(self.joint_dict_orig)

    @property
    def num_nodes(self) -> int:
        return len(self.node_dict)

    @property
    def left_right_limb(self) -> List[bool]:
        return list(self.left_right_limb_list)

    @property
    def left_right_limb_nodes(self) -> List[bool]:
        """``left_right_limb`` in node order (with the hip dropped, node i is
        not joint i)."""
        by_name = dict(zip(self.joint_dict_orig.values(), self.left_right_limb_list))
        return [by_name[self.node_dict[i]] for i in range(self.num_nodes)]

    def parents(self, mode: str = "original") -> List[Optional[int]]:
        """Parent per joint (``"original"``) or per node; reference
        `kinematic/base.py:29-37`.  Node pairs are read as (min, max)."""
        if mode == "original":
            return parents_from_limbseq(self.limbseq, self.num_joints)
        return parents_from_limbseq([sorted(pair) for pair in self.node_limbseq],
                                    self.num_nodes)

    @property
    def nodes_type_id(self) -> np.ndarray:
        """Left/right mirror joints share a type (a leading 'L'/'R' followed by
        an uppercase letter is stripped before dedup); reference
        `kinematic/base.py:59-70`."""
        stripped = []
        for name in self.node_dict.values():
            if len(name) > 1 and name[0] in ("L", "R") and name[1].isupper():
                stripped.append(name[1:])
            else:
                stripped.append(name)
        unique = list(dict.fromkeys(stripped))
        return np.asarray([unique.index(s) for s in stripped], dtype=np.int32)

    @property
    def adj_matrix(self) -> np.ndarray:
        return get_adj_matrix(self.node_limbseq, self.num_nodes)

    def reachability_matrix(self, factor: float = 0.5, stop_at=0) -> np.ndarray:
        return reachability_matrix(
            self.adj_matrix, list(self.node_dict.values()), factor=factor, stop_at=stop_at
        )

    def get_limbseq(self) -> np.ndarray:
        """Reference `kinematic/base.py:81-83`."""
        return np.asarray(self.limbseq if self.if_consider_hip else self.node_limbseq)

    def extract_limb_length(self, kpts: torch.Tensor, mode: str = "metric") -> torch.Tensor:
        """Per-limb bone lengths ``[..., n_limbs]``; reference
        `kinematic/base.py:130-135`.  ``mode='metric'`` uses the joint limbs
        (hip included), otherwise the node-graph limbs."""
        limbseq = torch.as_tensor(np.asarray(self.limbseq if mode == "metric"
                                             else self.node_limbseq), device=kpts.device)
        return torch.linalg.vector_norm(kpts[..., limbseq[:, 0], :] - kpts[..., limbseq[:, 1], :],
                                        dim=-1)

    def _build_node_graph(self, hip_triangle: List[List[str]]):
        """Drop the root joint and reconnect the hip triangle."""
        if not self.if_consider_hip:
            names = [v for k, v in self.joint_dict_orig.items() if k != 0]
            self.node_dict = dict(enumerate(names))
            rev = {v: i for i, v in self.node_dict.items()}
            self.node_limbseq = [[rev[a], rev[b]] for a, b in hip_triangle] + [
                [a - 1, b - 1] for a, b in self.limbseq if a != 0 and b != 0
            ]
        else:
            self.node_dict = dict(
                enumerate(list(NODE_HIP.values()) + list(self.joint_dict_orig.values())[1:])
            )
            self.node_limbseq = [list(l) for l in self.limbseq]


class AMASSKinematic(Kinematic):
    """SMPL-H body skeleton, 22 joints; reference
    `src/data/skeleton/kinematic/amass.py:7-86`."""

    def __init__(self, num_joints: int = 22, **kwargs):
        super().__init__(**kwargs)
        if num_joints != 22:
            raise NotImplementedError(f"num_joints={num_joints}: the port has the 22-joint body")
        self.joint_dict_orig = {
            0: "GlobalRoot", 1: "LHip", 2: "RHip", 3: "Spine1",
            4: "LKnee", 5: "RKnee", 6: "Spine3",
            7: "LHeel", 8: "RHeel", 9: "Neck",
            10: "LFoot", 11: "RFoot",
            12: "BMN", 13: "LSI", 14: "RSI", 15: "Head",
            16: "LShoulder", 17: "RShoulder",
            18: "LElbow", 19: "RElbow", 20: "LWrist", 21: "RWrist",
        }
        self.limbseq = np.asarray([
            [0, 3], [3, 6], [6, 9], [9, 12], [12, 15],          # spine/head
            [9, 14], [14, 17], [17, 19], [19, 21],              # right arm
            [9, 13], [13, 16], [16, 18], [18, 20],              # left arm
            [0, 2], [2, 5], [5, 8], [8, 11],                    # right leg
            [0, 1], [1, 4], [4, 7], [7, 10],                    # left leg
        ])
        self.left_right_limb_list = [
            not (name[0] == "L" and name[1].isupper()) for name in self.joint_dict_orig.values()
        ]
        self._build_node_graph([["LHip", "RHip"], ["LHip", "Spine1"], ["RHip", "Spine1"]])
        if not self.if_consider_hip:
            # limb-angle groups of the MAE metric (reference
            # `kinematic/amass.py:73-80`)
            self.limb_angles_idx = [
                [0, 2, 3, 4, 5, 6], [0, 3], [4, 7, 8, 9, 10],
                [4, 11, 12, 13, 14], [0, 15, 16, 17], [18, 19, 20],
            ]


def get_kinematic_class(dataset_name: str):
    """Dataset → (kinematic class, its name)."""
    if dataset_name.lower() != "amass":
        raise NotImplementedError(
            f"dataset {dataset_name!r}: the port has the AMASS skeleton only (ROADMAP Queue A "
            "item 5, the other skeletons)")
    return AMASSKinematic, "AMASS"
