"""Prediction storer: an append-only dump of the sampled predictions, the
ground truth and the observations, with their metadata.

Port of ``skeletondiffusion_tpu/utils/store.py`` (reference
`src/utils/store.py:7-57`, zarr there): ``.npz`` shards, and the metadata
and the config written by ``yaml_lite``.  The two packages read each other's
dumps.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from . import yaml_lite


class ResultStorer:
    def __init__(self, out_dir: str, store_gt: bool = False):
        self.out_dir = out_dir
        self.store_gt = store_gt
        os.makedirs(out_dir, exist_ok=True)
        # a re-run into the same directory must not leave a longer earlier
        # run's last shards behind: load() reads every shard_* file
        for name in os.listdir(out_dir):
            if name.startswith("shard_") and name.endswith((".npz", ".yaml")):
                os.remove(os.path.join(out_dir, name))
        self._shard = 0

    def append(self, pred: np.ndarray, obs: Optional[np.ndarray] = None,
               target: Optional[np.ndarray] = None, metadata=None):
        arrays = {"pred": np.asarray(pred)}
        if obs is not None:
            arrays["obs"] = np.asarray(obs)
        if self.store_gt and target is not None:
            arrays["target"] = np.asarray(target)
        np.savez_compressed(os.path.join(self.out_dir, f"shard_{self._shard:05d}.npz"), **arrays)
        if metadata is not None:
            yaml_lite.write(metadata, os.path.join(self.out_dir, f"shard_{self._shard:05d}.yaml"))
        self._shard += 1

    def finalize(self, config: Dict):
        yaml_lite.write(config, os.path.join(self.out_dir, "config.yaml"))

    @staticmethod
    def load(out_dir: str):
        """``(arrays, config)``: every stored key concatenated over the shards
        in write order.  Raises when a key is in only some of the shards (its
        rows would not line up with the other keys')."""
        paths = sorted(glob.glob(os.path.join(out_dir, "shard_*.npz")))
        arrays: Dict[str, list] = {}
        present: Dict[str, list] = {}
        for i, path in enumerate(paths):
            with np.load(path) as shard:
                for k in shard.files:
                    arrays.setdefault(k, []).append(shard[k])
                    present.setdefault(k, []).append(i)
        ragged = {k: v for k, v in present.items() if len(v) != len(paths)}
        if ragged:
            raise ValueError(
                f"keys {sorted(ragged)} are present in only some of the {len(paths)} shards "
                f"(shard indices {ragged}); rows would misalign across keys — load those "
                "shards individually")
        out = {k: np.concatenate(v, axis=0) for k, v in arrays.items()}
        cfg_path = os.path.join(out_dir, "config.yaml")
        config = yaml_lite.read(cfg_path) if os.path.exists(cfg_path) else None
        return out, config
