"""Shared finishing steps for dataset creation: the positions file, then
stats + multimodal GT; port of ``skeletondiffusion_tpu/data/preprocess/common.py``
(reference `src/data/loaders/base/create_dataset_utils.py:12-66`).
``finalize_dataset`` is the port's ``data/mmgt.py`` one (the eval path's
synthetic trees finish with it too)."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..mmgt import finalize_dataset

__all__ = ["finalize_dataset", "save_positions_npz"]


def save_positions_npz(output_path: str, positions: Dict, compressed: bool = True):
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    save = np.savez_compressed if compressed else np.savez
    save(output_path, positions_3d=positions)
