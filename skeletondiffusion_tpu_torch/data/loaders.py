"""Per-dataset loaders: AMASS, Human3.6M, FreeMan and the zero-shot 3DPW
variant.  Each reads one ``data_3d_<name>.npz`` with a ``positions_3d`` dict
of clips [T, J, 3], plus the ``segments_*.csv`` split definitions.

Port of ``skeletondiffusion_tpu/data/loaders.py`` (`:18-333`; reference
`src/data/loaders/{amass,h36m,freeman,amass_zeroshot}.py`), with the segment
CSVs read through the standard ``csv`` module.  AMASS-MANO (52 joints, 51
nodes) reads through ``AMASSDataset`` once its skeleton is ported (ROADMAP
Queue A item 5).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from .dataset import MotionDataset


def read_segments_csv(path: str) -> List[dict]:
    """Rows of a segment CSV (AMASS: dataset, file, file_idx, pred_init,
    pred_end; H36M: subject, action, init, pred_init, pred_end; FreeMan and
    3DPW: name, init, pred_init, pred_end), the integer columns as ints."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    for row in rows:
        for key in ("file_idx", "init", "pred_init", "pred_end"):
            if key in row:
                row[key] = int(row[key])
    return rows


def _load_positions(precomputed_folder: str, name: str) -> dict:
    path = os.path.join(precomputed_folder, f"data_3d_{name}.npz")
    return np.load(path, allow_pickle=True)["positions_3d"].item()


class _SegmentsFromCsv:
    """``_prepare_data`` of the loaders whose test split is a segment CSV:
    the CSV's segments (no stride, no augmentation), else the split's clips
    cut into segments."""

    def _prepare_data(self):
        if self.segments_path:
            self.segments, self.segment_idx_to_metadata = self._load_annotations_and_segments(
                self.segments_path
            )
            self.stride = 1
            self.augmentation = 0
        else:
            self.annotations = self._read_split()
            self.segments, self.segment_idx_to_metadata = self._generate_segments()


class AMASSDataset(_SegmentsFromCsv, MotionDataset):
    """Reference `amass.py:13-104` (the 22-joint body)."""

    def __init__(self, datasets, *args, file_idces="all", if_long_term_test=False,
                 long_term_factor=4, **kwargs):
        self.datasets, self.file_idces = datasets, file_idces
        if file_idces != "all":
            raise NotImplementedError("file_idces: only 'all' is supported")
        self.FPS = 60
        self.dict_indices = {}
        self.metadata_class_idx = 0  # dataset name is the CMD class
        self.idx_to_class = ["DFaust", "DanceDB", "GRAB", "HUMAN4D", "SOMA", "SSM", "Transitions"]
        self.class_to_idx = {v: k for k, v in enumerate(self.idx_to_class)}
        self.if_long_term_test = if_long_term_test
        self.long_term_factor = long_term_factor
        if if_long_term_test:
            kwargs["pred_length"] = int(kwargs["pred_length"] * long_term_factor)
        super().__init__(*args, datasets=datasets, **kwargs)

    def _read_split(self):
        return self._read_all_annotations(self.datasets, self.file_idces)

    def _read_all_annotations(self, datasets, file_idces) -> List[np.ndarray]:
        data_o = _load_positions(self.precomputed_folder, "amass")
        anns_all = []
        self.dict_indices = {}
        self.clip_idx_to_metadata = []
        counter = 0
        for dataset in datasets:
            self.dict_indices[dataset] = {}
            for file_idx in list(data_o[dataset].keys()):
                seq = data_o[dataset][file_idx]
                self.dict_indices[dataset][file_idx] = counter
                self.clip_idx_to_metadata.append((dataset, str(file_idx)))
                counter += 1
                anns_all.append(seq.astype(self.dtype))
        return anns_all

    def _load_annotations_and_segments(self, segments_path):
        """Test split from csv: (dataset,file,file_idx,pred_init,pred_end);
        reference `amass.py:88-104`."""
        if not os.path.exists(segments_path):
            raise FileNotFoundError(segments_path)
        rows = read_segments_csv(segments_path)
        datasets = list(dict.fromkeys(row["dataset"] for row in rows))
        self.annotations = self._read_all_annotations(datasets, "all")
        segments = [
            (self.dict_indices[row["dataset"]][row["file_idx"]],
             row["pred_init"] - self.obs_length,
             row["pred_init"] + self.pred_length - 1)
            for row in rows
        ]
        seg2meta = [(row["dataset"], str(row["file_idx"])) for row in rows]
        return segments, seg2meta


class H36MDataset(_SegmentsFromCsv, MotionDataset):
    """Reference `h36m.py:8-120` (17-joint default): clips by subject and
    action, the action (its name before a space or an underscore) the CMD
    class."""

    def __init__(self, subjects, *args, actions="all", **kwargs):
        self.subjects, self.actions = subjects, actions
        self.FPS = 50
        self.dict_indices = {}
        self.metadata_class_idx = 1  # action is the CMD class
        self.idx_to_class = [
            "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Posing",
            "Purchases", "Sitting", "SittingDown", "Smoking", "Photo", "Waiting",
            "Walking", "WalkDog", "WalkTogether",
        ]
        self.class_to_idx = {v: k for k, v in enumerate(self.idx_to_class)}
        super().__init__(*args, actions=actions, **kwargs)

    def load_mmgt(self, path: Optional[str] = None):
        """The training mm-GT of a subject list without S8 is its own file;
        reference `h36m.py:25-33`."""
        if not self.if_load_mmgt:
            return
        if self.split == "train":
            name = "mmgt_train.txt" if "S8" in self.subjects else "mmgt_train_noS8.txt"
            super().load_mmgt(os.path.join(self.precomputed_folder, name))
        else:
            super().load_mmgt(path)

    def _read_split(self):
        return self._read_all_annotations(self.subjects, self.actions)

    def _read_all_annotations(self, subjects, actions):
        data_o = _load_positions(self.precomputed_folder, "h36m")
        data_f = {s: v for s, v in data_o.items() if s in subjects}
        if actions != "all":
            for subject in list(data_f.keys()):
                data_f[subject] = {
                    k: v for k, v in data_f[subject].items() if any(a in k for a in actions)
                }
                if not data_f[subject]:
                    data_f.pop(subject)
        anns_all = []
        self.dict_indices = {}
        self.clip_idx_to_metadata = []
        counter = 0
        for subject in data_f:
            self.dict_indices[subject] = {}
            for action in data_f[subject]:
                self.dict_indices[subject][action] = counter
                self.clip_idx_to_metadata.append((subject, action.split(" ")[0].split("_")[0]))
                counter += 1
                anns_all.append(data_f[subject][action].astype(self.dtype))
        return anns_all

    @staticmethod
    def rename_action(action: str) -> str:
        """A segment CSV's action as the clips are named (reference
        `h36m.py:94`)."""
        return action.replace("TakingPhoto", "Photo").replace("WalkingDog", "WalkDog").replace(
            " ", "_")

    def _load_annotations_and_segments(self, segments_path):
        rows = read_segments_csv(segments_path)
        for row in rows:
            row["action"] = self.rename_action(row["action"])
        subjects = list(dict.fromkeys(row["subject"] for row in rows))
        actions = list(dict.fromkeys(row["action"] for row in rows))
        self.annotations = self._read_all_annotations(subjects, actions)
        segments = [(self.dict_indices[row["subject"]][row["action"]], row["init"],
                     row["pred_end"]) for row in rows]
        seg2meta = [(row["subject"], row["action"].split(" ")[0].split("_")[0]) for row in rows]
        return segments, seg2meta


class FreeManDataset(_SegmentsFromCsv, MotionDataset):
    """Reference `freeman.py:9-120` (18 joints, 30 fps): the split's
    sequences from the shipped lists (``<split>.txt``), their action labels
    from ``seq_actions_labels.txt`` (the CMD classes, in the order the loaded
    sequences first name them)."""

    def __init__(self, *args, actions="all", annotations_folder=None, **kwargs):
        self.annotations_folder = annotations_folder
        self.FPS = 30
        self.actions = actions
        self.dict_indices = {}
        self.metadata_class_idx = 0
        super().__init__(*args, actions=actions, **kwargs)

    def extract_action_label(self, extra):
        return extra["metadata"][0]

    def _file2action(self) -> Dict[str, str]:
        file2action = {}
        with open(os.path.join(self.annotations_folder, "seq_actions_labels.txt")) as f:
            for line in f:
                name, action = line.strip().split(",")
                file2action[name] = action
        return file2action

    def _read_split(self):
        with open(os.path.join(self.annotations_folder, f"{self.split}.txt")) as f:
            split_seqs = [line.strip() for line in f]
        return self._read_all_annotations(self.actions, split_seqs)

    def _read_all_annotations(self, actions, seqs):
        data_o = _load_positions(self.precomputed_folder, "freeman")
        missing = [key for key in seqs if key not in data_o]
        if missing:
            raise KeyError(f"{len(missing)} sequences of the {self.split} split are missing from "
                           f"data_3d_freeman.npz (first: {missing[:5]})")
        data_f = {key: data_o[key] for key in seqs}
        # the labels of the loaded sequences only, classes in the order they
        # first appear (reference `freeman.py:58-79`)
        file2action = {k: v for k, v in self._file2action().items() if k in data_f}
        if actions != "all":
            file2action = {k: v for k, v in file2action.items() if v in actions}
            data_f = {k: v for k, v in data_f.items() if k in file2action}
        else:
            unlabeled = [k for k in data_f if k not in file2action]
            if unlabeled:
                raise ValueError(f"{len(unlabeled)} FreeMan sequence(s) of the split have no row "
                                 f"in seq_actions_labels.txt: {unlabeled[:5]}")
        self.seq2action = file2action
        self.idx_to_class = list(dict.fromkeys(file2action.values()))
        self.class_to_idx = {v: k for k, v in enumerate(self.idx_to_class)}
        anns_all = []
        self.dict_indices = {}
        self.clip_idx_to_metadata = []
        for counter, (seq_name, seq) in enumerate(data_f.items()):
            self.dict_indices[seq_name] = counter
            self.clip_idx_to_metadata.append((file2action[seq_name], seq_name))
            anns_all.append(seq.astype(self.dtype))
        return anns_all

    def _load_annotations_and_segments(self, segments_path):
        rows = read_segments_csv(segments_path)
        seqs = list(dict.fromkeys(row["name"] for row in rows))
        self.annotations = self._read_all_annotations(self.actions, seqs)
        segments = [(self.dict_indices[row["name"]], row["init"], row["pred_end"]) for row in rows]
        seg2meta = [(self.seq2action[row["name"]], row["name"]) for row in rows]
        return segments, seg2meta


class ZeroShotAMASSDataset(_SegmentsFromCsv, MotionDataset):
    """Zero-shot evaluation of an AMASS model on another capture setup: the
    test split merges every split of the npz, and each clip is cut to the
    skeleton's joints (3DPW's 24 SMPL joints → 22); reference
    `amass_zeroshot.py:9-104`."""

    dataset_name = "3dpw"

    def __init__(self, *args, annotations_folder=None, if_zero_shot=True, **kwargs):
        self.annotations_folder = annotations_folder
        self.FPS = 60
        self.if_zero_shot = if_zero_shot
        self.dict_indices = {}
        self.metadata_class_idx = 0
        super().__init__(*args, **kwargs)

    def _read_split(self):
        return self._read_all_annotations(self.split)

    def _read_all_annotations(self, split):
        data_o = _load_positions(self.precomputed_folder, self.dataset_name)
        if self.if_zero_shot and split == "test":
            data_f = {name: seq for s in data_o for name, seq in data_o[s].items()}
        else:
            data_f = data_o[split]
        self.idx_to_class = list(data_f.keys())
        self.class_to_idx = {v: k for k, v in enumerate(self.idx_to_class)}
        anns_all = []
        self.dict_indices = {}
        self.clip_idx_to_metadata = []
        for counter, (seq_name, seq) in enumerate(data_f.items()):
            self.dict_indices[seq_name] = counter
            self.clip_idx_to_metadata.append((seq_name, seq_name))
            anns_all.append(seq[..., : self.skeleton.num_joints, :].astype(self.dtype))
        return anns_all

    def _load_annotations_and_segments(self, segments_path):
        rows = read_segments_csv(segments_path)
        self.annotations = self._read_all_annotations(self.split)
        segments = [(self.dict_indices[row["name"]], row["init"], row["pred_end"]) for row in rows]
        seg2meta = [(row["name"], row["name"]) for row in rows]
        return segments, seg2meta


class D3PWZeroShotDataset(ZeroShotAMASSDataset):
    """Reference `loaders/__init__.py:7-8` alias."""

    dataset_name = "3dpw"


DATASET_CLASSES = {
    "AMASSDataset": AMASSDataset,
    "H36MDataset": H36MDataset,
    "FreeManDataset": FreeManDataset,
    "ZeroShotAMASSDataset": ZeroShotAMASSDataset,
    "D3PWZeroShotDataset": D3PWZeroShotDataset,
}
