"""Checkpoints on ``torch.save``: parameters, optimizer state, EMA, step
counters, scheduler and curriculum state, whatever the trainer's
``state_dict`` holds.

Port of ``skeletondiffusion_tpu/train/checkpoint.py`` (orbax there) with its
retention: the top ``n_saved`` checkpoints by score (higher is better) plus
a rolling latest, listed in ``index.json`` (reference
`train_diffusion.py:100-104`).  A checkpoint is one file, written to a
temporary name and renamed, and read back with ``torch.load(weights_only=True)``:
tensors, numbers, strings and containers of them.  Small host-side state
(the data loader's and the dataset's RNGs, the epoch) goes to
``host_state.json`` beside it.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_device


class CheckpointManager:
    def __init__(self, directory: str, n_saved: int = 10):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.n_saved = n_saved
        self._index_path = os.path.join(self.directory, "index.json")
        self._index: List[Dict] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    # ---- save ---------------------------------------------------------------
    def _write_index(self):
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)

    def _write(self, state: Any, name: str) -> None:
        tmp = self.path(name) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(name))

    def save(self, state: Any, step: int, score: Optional[float] = None, tag: str = "ckpt"):
        """Save; keep the best ``n_saved`` by score (higher is better: pass
        −ADE etc.) plus the rolling latest.  A re-save of a step replaces its
        entry (a resumed run re-running an epoch)."""
        name = f"{tag}_{step}"
        self._write(state, name)
        self._index = [e for e in self._index if e["name"] != name]
        self._index.append({"name": name, "step": step, "score": score})
        if score is not None:
            scored = [e for e in self._index if e["score"] is not None]
            scored.sort(key=lambda e: e["score"], reverse=True)
            for e in scored[self.n_saved:]:
                if e["step"] != step:
                    self._remove(e)
        self._write_index()

    def save_latest(self, state: Any, step: int):
        prev = [e for e in self._index if e["name"].startswith("latest")]
        name = f"latest_{step}"
        self._write(state, name)
        self._index = [e for e in self._index if e["name"] != name]
        self._index.append({"name": name, "step": step, "score": None})
        for e in prev:
            if e["name"] != name:
                self._remove(e)
        self._write_index()

    def _remove(self, entry: Dict):
        path = self.path(entry["name"])
        if os.path.exists(path):
            os.remove(path)
        self._index = [e for e in self._index if e["name"] != entry["name"]]

    # ---- load -------------------------------------------------------------
    def latest_path(self) -> Optional[str]:
        if not self._index:
            return None
        return self.path(max(self._index, key=lambda e: e["step"])["name"])

    def best_path(self) -> Optional[str]:
        scored = [e for e in self._index if e["score"] is not None]
        if not scored:
            return self.latest_path()
        return self.path(max(scored, key=lambda e: e["score"])["name"])

    def restore(self, path: Optional[str] = None, map_location: DeviceLike = "cpu") -> Any:
        """The saved state (the latest by default), its tensors on
        ``map_location``."""
        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        return torch.load(path, map_location=resolve_device(map_location), weights_only=True)

    def restore_partial(self, target: Mapping, path: Optional[str] = None,
                        map_location: DeviceLike = "cpu") -> Dict:
        """Only the part of the saved state that ``target`` names: each key
        of ``target``, recursively where its value is a mapping (e.g.
        ``{"model": ae.state_dict()}`` for the frozen AE of stage 2, without
        the stored optimizer state).  A key missing from the checkpoint
        raises ``KeyError``."""
        def pick(saved: Mapping, want: Mapping) -> Dict:
            return {k: pick(saved[k], v) if isinstance(v, Mapping) else saved[k]
                    for k, v in want.items()}

        return pick(self.restore(path, map_location), target)


def save_host_state(directory: str, state: Dict):
    """Small host-side state (loader and dataset RNGs, epoch) as JSON."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "host_state.json"), "w") as f:
        json.dump(state, f)


def load_host_state(directory: str) -> Optional[Dict]:
    path = os.path.join(directory, "host_state.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
