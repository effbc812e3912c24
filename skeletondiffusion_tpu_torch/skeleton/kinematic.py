"""Kinematic skeletons of AMASS (22 joints, or 52 with the MANO hands of
AMASS-MANO; 3DPW zero-shot reuses the 22), Human3.6M (17 or 25) and FreeMan
(18): joint dictionary, limb sequence, node
graph (with the hip-triangle reconnection applied when the root is dropped),
mirror node types, parents, left/right flags, limb-angle groups, the
adjacency/reachability matrices (host-side numpy) and limb-length
extraction (torch).

Port of ``skeletondiffusion_tpu/skeleton/kinematic.py`` (reference
`src/data/skeleton/kinematic/{base,amass,h36m,freeman}.py`).
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
    """SMPL-H body skeleton: 22 joints, or 52 with the MANO hands (AMASS-MANO,
    51 nodes without the hip); reference
    `src/data/skeleton/kinematic/amass.py:7-86`.  Also the 3DPW zero-shot
    skeleton (`kinematic/__init__.py:7-8`)."""

    def __init__(self, num_joints: int = 22, **kwargs):
        super().__init__(**kwargs)
        if num_joints not in (22, 52):
            raise ValueError(f"num_joints={num_joints}: the SMPL-H body has 22 joints, or 52 "
                             "with the MANO hands")
        self.joint_dict_orig = {
            0: "GlobalRoot", 1: "LHip", 2: "RHip", 3: "Spine1",
            4: "LKnee", 5: "RKnee", 6: "Spine3",
            7: "LHeel", 8: "RHeel", 9: "Neck",
            10: "LFoot", 11: "RFoot",
            12: "BMN", 13: "LSI", 14: "RSI", 15: "Head",
            16: "LShoulder", 17: "RShoulder",
            18: "LElbow", 19: "RElbow", 20: "LWrist", 21: "RWrist",
        }
        limbseq = [
            [0, 3], [3, 6], [6, 9], [9, 12], [12, 15],          # spine/head
            [9, 14], [14, 17], [17, 19], [19, 21],              # right arm
            [9, 13], [13, 16], [16, 18], [18, 20],              # left arm
            [0, 2], [2, 5], [5, 8], [8, 11],                    # right leg
            [0, 1], [1, 4], [4, 7], [7, 10],                    # left leg
        ]
        if num_joints == 52:
            # the MANO hands: 5 fingers × 3 segments a side, named as the
            # reference names them (`kinematic/amass.py:30-52`)
            base = 22
            for side in ("left", "right"):
                for finger in ("index", "middle", "pinky", "ring", "thumb"):
                    for seg in (1, 2, 3):
                        self.joint_dict_orig[base] = f"{side}_{finger}{seg}"
                        base += 1
            # finger bones wrist → {finger}1 → {finger}2 → {finger}3, in the
            # reference's limb order (`kinematic/amass.py:54-58`)
            for wrist, start in ((20, 22), (21, 37)):
                roots = [start + 3 * f for f in range(5)]
                limbseq += [[wrist, r] for r in roots]
                for r in roots:
                    limbseq += [[r, r + 1], [r + 1, r + 2]]
        self.limbseq = np.asarray(limbseq)
        self.left_right_limb_list = [
            not ((name[0] == "L" and name[1].isupper()) or "left" in name)
            for name in self.joint_dict_orig.values()
        ]
        self._build_node_graph([["LHip", "RHip"], ["LHip", "Spine1"], ["RHip", "Spine1"]])
        if not self.if_consider_hip:
            # limb-angle groups of the MAE metric (reference
            # `kinematic/amass.py:73-80`)
            self.limb_angles_idx = [
                [0, 2, 3, 4, 5, 6], [0, 3], [4, 7, 8, 9, 10],
                [4, 11, 12, 13, 14], [0, 15, 16, 17], [18, 19, 20],
            ]


class H36MKinematic(Kinematic):
    """Human3.6M skeleton, 17-joint (default) or 25-joint variant; reference
    `src/data/skeleton/kinematic/h36m.py:68-111`."""

    # 32-joint raw capture → deduplicated conversions (`h36m.py:23,44`)
    CONVERSION_IDX_32TO17 = [0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]
    CONVERSION_IDX_32TO25 = [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13, 14, 15, 17, 18, 19, 21, 22, 25, 26, 27, 29, 30,
    ]

    def __init__(self, num_joints: int = 17, **kwargs):
        super().__init__(**kwargs)
        if num_joints not in (17, 25):
            raise ValueError(f"num_joints={num_joints}: Human3.6M has 17 or 25 joints")
        if num_joints == 17:
            self.joint_dict_orig = {
                0: "GlobalRoot", 1: "RHip", 2: "RKnee", 3: "RAnkle",
                4: "LHip", 5: "LKnee", 6: "LAnkle",
                7: "Torso", 8: "Neck", 9: "Nose", 10: "Head",
                11: "LShoulder", 12: "LElbow", 13: "LWrist",
                14: "RShoulder", 15: "RElbow", 16: "RWrist",
            }
            limbseq = [
                [0, 1], [0, 4], [1, 2], [2, 3], [4, 5], [5, 6],
                [0, 7], [7, 8], [8, 9], [9, 10], [8, 11], [8, 14],
                [11, 12], [12, 13], [14, 15], [15, 16],
            ]
        else:
            self.joint_dict_orig = {
                0: "GlobalRoot",
                1: "RHip", 2: "RKnee", 3: "RAnkle", 4: "RFoot", 5: "RToes",
                6: "LHip", 7: "LKnee", 8: "LAnkle", 9: "LFoot", 10: "LToes",
                11: "Torso", 12: "Neck", 13: "Nose", 14: "Head",
                15: "LShoulder", 16: "LElbow", 17: "LWrist",
                18: "LSmallFinger", 19: "LThumb",
                20: "RShoulder", 21: "RElbow", 22: "RWrist",
                23: "RSmallFinger", 24: "RThumb",
            }
            limbseq = [
                [0, 1], [0, 6], [1, 2], [2, 3], [3, 4], [4, 5],
                [6, 7], [7, 8], [8, 9], [9, 10], [0, 11], [11, 12], [12, 13], [13, 14],
                [12, 15], [12, 20], [15, 16], [16, 17], [17, 18], [17, 19],
                [20, 21], [21, 22], [22, 23], [22, 24],
            ]
        self.limbseq = np.asarray(limbseq)
        self.left_right_limb_list = [
            not (name[0] == "L" and name[1].isupper()) for name in self.joint_dict_orig.values()
        ]
        self._build_node_graph([["RHip", "LHip"], ["RHip", "Torso"], ["LHip", "Torso"]])
        if not self.if_consider_hip:
            if num_joints != 17:
                raise ValueError("the 25-joint Human3.6M skeleton keeps its hip "
                                 "(if_consider_hip=True)")
            self.limb_angles_idx = [[3, 4], [0, 2, 7, 8, 9], [1, 7, 10, 12, 13], [7, 11, 14, 15]]


class FreeManKinematic(Kinematic):
    """FreeMan's 18 joints (COCO-style and a synthesized hip root); reference
    `src/data/skeleton/kinematic/freeman.py:5-43`."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.joint_dict_orig = {
            0: "GlobalRoot", 1: "LHip", 2: "RHip",
            3: "LKnee", 4: "RKnee", 5: "LAnkle", 6: "RAnkle",
            7: "Nose", 8: "LEye", 9: "REye", 10: "LEar", 11: "REar",
            12: "LShoulder", 13: "RShoulder", 14: "LElbow", 15: "RElbow",
            16: "LWrist", 17: "RWrist",
        }
        self.limbseq = np.asarray([
            [0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6],
            [0, 7], [7, 8], [7, 9], [8, 10], [9, 11],
            [7, 12], [7, 13], [12, 14], [13, 15], [14, 16], [15, 17],
        ])
        self.left_right_limb_list = [
            not (name[0] == "L" and name[1].isupper()) for name in self.joint_dict_orig.values()
        ]
        self._build_node_graph([["RHip", "LHip"], ["RHip", "Nose"], ["LHip", "Nose"]])
        if not self.if_consider_hip:
            self.limb_angles_idx = [[0, 1, 7, 9], [0, 4, 6], [1, 8, 10], [3, 5],
                                    [2, 11, 13, 15], [1, 12, 14, 16]]


KINEMATICS = {
    "amass": (AMASSKinematic, "AMASS"),
    "amass-mano": (AMASSKinematic, "AMASS"),
    "3dpw": (AMASSKinematic, "AMASS"),
    "h36m": (H36MKinematic, "H36M"),
    "freeman": (FreeManKinematic, "FreeMan"),
}


def get_kinematic_class(dataset_name: str):
    """Dataset → (kinematic class, its name); 3DPW zero-shot reuses AMASS
    (reference `src/data/skeleton/kinematic/__init__.py:6-9`)."""
    name = dataset_name.lower()
    if name not in KINEMATICS:
        raise NotImplementedError(f"dataset {dataset_name!r} is not a dataset of the "
                                  f"reference; the port has {sorted(KINEMATICS)}")
    return KINEMATICS[name]
