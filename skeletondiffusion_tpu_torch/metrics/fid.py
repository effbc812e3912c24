"""FID over a pretrained H36M action classifier's GRU features.

Port of ``skeletondiffusion_tpu/metrics/fid.py`` (`:22-117`; reference
`src/metrics/{fid,fid_classifier}.py`): a 2-layer GRU classifier on 48-dim
(16 joints × 3) pose features; FID = Fréchet distance between the activation
statistics of predictions and ground truth.  The module carries the
reference's parameter names, so ``port_classifier`` turns the reference's
``h36m_classifier.pth`` state_dict into its ``state_dict``.  On the GPU its
GRU runs through cuDNN: keep ``torch.backends.cudnn.allow_tf32 = False``.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn


class ClassifierForFID(nn.Module):
    """2-layer GRU + 2 linear heads; reference `fid_classifier.py:5-57`."""

    def __init__(self, input_size: int = 48, hidden_size: int = 128, hidden_layer: int = 2,
                 output_size: int = 15):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.hidden_layer = hidden_layer
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layer)
        self.linear1 = nn.Linear(hidden_size, 30)
        self.linear2 = nn.Linear(30, output_size)

    def get_fid_features(self, motion: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        """motion [B, F, T] (the reference's layout), h0 [layers, B, H] →
        tanh(linear1(last GRU output)) [B, 30]; reference
        `fid_classifier.py:41-52`."""
        out, _ = self.recurrent(motion.permute(2, 0, 1), h0)
        return torch.tanh(self.linear1(out[-1]))

    def forward(self, motion: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.get_fid_features(motion, h0))


def port_classifier(sd: Dict[str, np.ndarray], hidden_layer: int = 2) -> Dict[str, torch.Tensor]:
    """The reference's ``h36m_classifier.pth`` state_dict (arrays) →
    ``ClassifierForFID.state_dict()``."""
    keys = [f"recurrent.{kind}_{part}_l{layer}" for layer in range(hidden_layer)
            for kind in ("weight", "bias") for part in ("ih", "hh")]
    keys += [f"{name}.{kind}" for name in ("linear1", "linear2") for kind in ("weight", "bias")]
    return {k: torch.as_tensor(np.asarray(sd[k], dtype=np.float32)) for k in keys}


def fid_from_activations(act1: np.ndarray, act2: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between activation statistics; reference
    `fid.py:16-73` (Dougal Sutherland's stable formulation)."""
    from scipy import linalg

    mu1, mu2 = act1.mean(0), act2.mean(0)
    s1 = np.cov(act1, rowvar=False)
    s2 = np.cov(act2, rowvar=False)
    diff = mu1 - mu2

    def _sqrtm_quiet(a):
        # SciPy < 1.18: `disp=True` default prints an error estimate on
        # near-singular products, so pass disp=False (returns a (root,
        # errest) tuple); SciPy >= 1.18 removed the kwarg and is silent
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                root, _ = linalg.sqrtm(a, disp=False)
            return root
        except TypeError:
            return linalg.sqrtm(a)

    covmean = _sqrtm_quiet(s1.dot(s2))
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = _sqrtm_quiet((s1 + offset).dot(s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))
