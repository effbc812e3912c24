"""The AMASS loader: one ``data_3d_amass.npz`` with a ``positions_3d`` dict of
clips [T, J, 3], plus the ``segments_test.csv`` test-split definition.

Port of ``AMASSDataset`` from ``skeletondiffusion_tpu/data/loaders.py``
(`:18-82`; reference `src/data/loaders/amass.py:13-104`), with the segment
CSV read through the standard ``csv`` module.  The H36M, FreeMan,
AMASS-MANO and 3DPW loaders are not ported.
"""
from __future__ import annotations

import csv
import os
from typing import List

import numpy as np

from .dataset import MotionDataset


def read_segments_csv(path: str) -> List[dict]:
    """Rows of a segment CSV (dataset, file, file_idx, pred_init, pred_end),
    the integer columns as ints."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    for row in rows:
        for key in ("file_idx", "pred_init", "pred_end"):
            row[key] = int(row[key])
    return rows


class AMASSDataset(MotionDataset):
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

    def _prepare_data(self):
        if self.segments_path:
            self.segments, self.segment_idx_to_metadata = self._load_annotations_and_segments(
                self.segments_path
            )
            self.stride = 1
            self.augmentation = 0
        else:
            self.annotations = self._read_all_annotations(self.datasets, self.file_idces)
            self.segments, self.segment_idx_to_metadata = self._generate_segments()

    def _read_all_annotations(self, datasets, file_idces) -> List[np.ndarray]:
        path = os.path.join(self.precomputed_folder, "data_3d_amass.npz")
        data_o = np.load(path, allow_pickle=True)["positions_3d"].item()
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
