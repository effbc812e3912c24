"""Notebook and plug-and-play inference API.

Port of ``skeletondiffusion_tpu/inference.py`` (`:22-110`; the reference's
`Inference Example.ipynb` and `src/inference_utils.py:23-51`): load a
trained experiment folder, take raw 3D poses to input space, predict 50
futures, rank them.  It runs on the card unless ``device='cpu'``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .cli.common import build_skeleton, setup_device
from .cli.eval import prepare_model
from .metrics.ranking import get_closest_and_nfurthest_maxapd
from .utils import yaml_lite
from .utils.config import flatten_config, load_config


def load_model_config_exp(checkpoint_path: str) -> Tuple[Dict, str]:
    """(the experiment's config, its folder) from a checkpoint path;
    reference `inference_utils.py:15-21`.  Walks up to the nearest
    ``config.yaml``: the experiment folder (0 steps), ``<exp>/checkpoints``
    (1), a checkpoint file inside it (2)."""
    probe = checkpoint_path if os.path.isdir(checkpoint_path) else os.path.dirname(checkpoint_path)
    for _ in range(4):
        if os.path.exists(os.path.join(probe, "config.yaml")):
            return yaml_lite.read(os.path.join(probe, "config.yaml")), probe
        parent = os.path.dirname(probe.rstrip(os.sep))
        if parent == probe:
            break
        probe = parent
    raise FileNotFoundError(f"no experiment config.yaml found at or above {checkpoint_path!r}")


def quick_cfg_for_inference(
    checkpoint_path: str, dataset_name: str, num_samples: int = 50,
    config_dir: str = "configs/config_eval", overrides=None,
) -> Dict:
    """Reference `inference_utils.py:23-51` without Hydra.  ``overrides``:
    extra dotted CLI-style overrides (e.g. ``["task.history_sec=0.1"]``)."""
    cfg = flatten_config(
        load_config(config_dir, [
            f"dataset={dataset_name}", "dataset_split=valid", "stats_mode=deterministic",
            f"num_samples={num_samples}", "batch_size=1",
            f"checkpoint_path={checkpoint_path}",
            *(overrides or []),
        ])
    )
    cfg_orig, exp_folder = load_model_config_exp(checkpoint_path)
    # the stored experiment config fills what the eval tree does not set;
    # the train-owned keys (pose_box_size, seq_centering, the architecture)
    # are not in the eval tree, so the checkpoint's values win (reference
    # `eval.py:161-166`)
    merged = dict(cfg_orig)
    merged.update(cfg)
    # prepare_model restores the best checkpoint of the experiment folder
    merged["checkpoint_path"] = exp_folder
    return merged


class InferenceSession:
    """obs [T,J,3] or [B,T,J,3] raw metric poses → predicted futures and
    their ranking."""

    def __init__(self, checkpoint_path: str, dataset_name: str = "amass",
                 num_samples: int = 50, config_dir: str = "configs/config_eval",
                 overrides=None, device: str = "cuda"):
        self.cfg = quick_cfg_for_inference(checkpoint_path, dataset_name, num_samples,
                                           config_dir,
                                           overrides=[f"device={device}", *(overrides or [])])
        self.device = setup_device(self.cfg)
        self.skeleton = build_skeleton(self.cfg)
        self.predictor = prepare_model(self.cfg, self.skeleton, self.device)
        self.num_samples = num_samples

    def predict(self, obs_raw: np.ndarray,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Raw metric-space observation → metric-space predictions
        [(B,) S, T, N, 3]; the sampler's noise is drawn from ``generator``
        (on the session's device; default: seeded with 0)."""
        single = obs_raw.ndim == 3
        obs = torch.as_tensor(np.asarray(obs_raw, dtype=np.float32), device=self.device)
        if single:
            obs = obs[None]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        pred, _ = self.predictor(generator, self.skeleton.tranform_to_input_space(obs))
        pred_m = self.skeleton.transform_to_metric_space(pred).cpu().numpy()
        return pred_m[0] if single else pred_m

    def rank(self, pred: np.ndarray, target_raw: np.ndarray, n_diverse: int = 5):
        """The sample closest to the ground truth and the ``n_diverse`` most
        diverse ones; reference `src/metrics/ranking.py:17-63`."""
        target = torch.as_tensor(np.asarray(target_raw, dtype=np.float32))
        target_m = self.skeleton.transform_to_metric_space(
            self.skeleton.tranform_to_input_space(target)).numpy()
        return get_closest_and_nfurthest_maxapd(pred, target_m, n_diverse)
