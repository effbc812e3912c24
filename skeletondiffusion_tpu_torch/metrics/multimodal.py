"""Probabilistic sample-set metrics over predictions [B, S, T, J, 3], in torch.

Port of ``skeletondiffusion_tpu/metrics/multimodal.py`` (reference
`src/metrics/multimodal.py`).  The ragged multimodal ground truth is a padded
tensor [B, M, T, J, 3] with a validity mask [B, M], so MMADE/MMFDE are
masked minima.

Every pairwise distance is taken with ``torch.cdist`` in its difference mode
(``donot_use_mm_for_euclid_dist``): no matrix product, so no TF32 and none
of the x² + y² − 2xy cancellation, and no [B, M, S, T, J·3] difference
tensor (387 MB per mm-GT neighbour at batch 256 × 50 samples × 120 frames).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

EXACT = "donot_use_mm_for_euclid_dist"
# elements of one cdist output chunk in mmade (256 MB of float32)
_CDIST_CHUNK = 1 << 26


def _time_slice(x: torch.Tensor, t0: int, t: int, axis: int) -> torch.Tensor:
    """Reference `multimodal.py:4-8`."""
    if t0 == 0 and t == -1:
        return x
    end = x.shape[axis] if t == -1 else t
    return x.narrow(axis, t0, end - t0)


def _triu_mean(d: torch.Tensor) -> torch.Tensor:
    """Mean of the strict upper triangle of [B, S, S]."""
    S = d.shape[-1]
    iu = torch.triu_indices(S, S, offset=1, device=d.device)
    return d[:, iu[0], iu[1]].mean(dim=-1)


def apd(pred: torch.Tensor, t0: int = 0, t: int = -1, **kw) -> torch.Tensor:
    """Average pairwise distance over samples (upper triangle mean);
    reference `multimodal.py:15-35`."""
    pred = _time_slice(pred, t0, t, 2)
    B, S = pred.shape[:2]
    if S == 1:
        return torch.zeros((B,), dtype=pred.dtype, device=pred.device)
    arr = pred.reshape(B, S, -1)
    return _triu_mean(torch.cdist(arr, arr, compute_mode=EXACT))


def mpjpe(target: torch.Tensor, pred: torch.Tensor, **kw) -> torch.Tensor:
    """Min-over-samples of time-mean joint-mean position error; reference
    `multimodal.py:37-42`."""
    dist = torch.linalg.vector_norm(target[:, None] - pred, dim=-1).mean(dim=-1)  # [B,S,T]
    return dist.mean(dim=-1).amin(dim=-1)


def _frame_dist(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """[B, S, T] whole-pose distances of each sample's frames to the target's."""
    B, S, T = pred.shape[:3]
    if target.shape[1] != T:
        raise ValueError(f"target {tuple(target.shape)} and pred {tuple(pred.shape)} differ in "
                         "length")
    diff = pred.reshape(B, S, T, -1) - target.reshape(B, 1, T, -1)
    return torch.linalg.vector_norm(diff, dim=-1)


def ade(target: torch.Tensor, pred: torch.Tensor, t0: int = 0, t: int = -1,
        reduction: str = "mean", **kw) -> torch.Tensor:
    """Min-over-samples average displacement (whole-pose norm per frame);
    reference `multimodal.py:44-57`."""
    pred, target = _time_slice(pred, t0, t, 2), _time_slice(target, t0, t, 1)
    dist = _frame_dist(target, pred).mean(dim=-1)
    return dist.amin(dim=-1) if reduction == "mean" else dist


def fde(target: torch.Tensor, pred: torch.Tensor, t0: int = 0, t: int = -1,
        reduction: str = "mean", **kw) -> torch.Tensor:
    """Min-over-samples final displacement; reference `multimodal.py:60-73`."""
    pred, target = _time_slice(pred, t0, t, 2), _time_slice(target, t0, t, 1)
    dist = _frame_dist(target[:, -1:], pred[:, :, -1:])[..., 0]
    return dist.amin(dim=-1) if reduction == "mean" else dist


def mae(target: torch.Tensor, pred: torch.Tensor, limbseq,
        limb_angles_idx: Sequence[Sequence[int]], t0: int = 0, t: int = -1,
        **kw) -> torch.Tensor:
    """Min-over-samples mean limb-angle error in degrees; reference
    `multimodal.py:76-102`."""
    pred, target = _time_slice(pred, t0, t, 2), _time_slice(target, t0, t, 1)
    dev = pred.device
    limbseq = torch.as_tensor(np.sort(np.asarray(limbseq), axis=-1), device=dev)
    pairs = torch.as_tensor(np.asarray(
        [[kin[i], kin[i + 1]] for kin in limb_angles_idx for i in range(len(kin) - 1)]
    ), device=dev)

    def cos_sim(vecs):
        a = vecs[..., pairs[:, 0], :]
        b = vecs[..., pairs[:, 1], :]
        num = (a * b).sum(dim=-1)
        den = torch.sqrt((a**2).sum(-1)) * torch.sqrt((b**2).sum(-1))
        return num / den.clamp_min(1e-7)

    vec_t = target[..., limbseq[:, 1], :] - target[..., limbseq[:, 0], :]
    vec_p = pred[..., limbseq[:, 1], :] - pred[..., limbseq[:, 0], :]
    cs_t = cos_sim(vec_t[:, None])
    cs_p = cos_sim(vec_p)
    diff = torch.arccos(cs_p.clamp(-1, 1)) - torch.arccos(cs_t.clamp(-1, 1))
    dist = diff.abs().mean(-1).mean(dim=-1)
    return (dist * (180.0 / np.pi)).amin(dim=-1)


def _masked_gt_mean(per_gt: torch.Tensor, mm_mask: torch.Tensor) -> torch.Tensor:
    w = mm_mask.to(per_gt.dtype)
    return (per_gt * w).sum(-1) / w.sum(-1).clamp_min(1)


def mmade(target: torch.Tensor, pred: torch.Tensor, mm_gt: torch.Tensor,
          mm_mask: torch.Tensor, t0: int = 0, t: int = -1, **kw) -> torch.Tensor:
    """Multimodal ADE: for each valid mm-GT neighbor the min-over-samples ADE,
    averaged over neighbors; reference `multimodal.py:105-119`.  Each frame's
    [S] × [M] distances come from one batched cdist over (item, frame),
    chunked over items to bound the [B·T, S, M] output."""
    pred = _time_slice(pred, t0, t, 2)
    mm_gt = _time_slice(mm_gt, t0, t, 2)
    B, S, T = pred.shape[:3]
    M = mm_gt.shape[1]
    if mm_gt.shape[2] != T:
        raise ValueError(f"mm_gt {tuple(mm_gt.shape)} and pred {tuple(pred.shape)} differ in "
                         "length")
    p = pred.reshape(B, S, T, -1).transpose(1, 2)        # [B,T,S,D]
    g = mm_gt.reshape(B, M, T, -1).transpose(1, 2)       # [B,T,M,D]
    step = max(1, _CDIST_CHUNK // max(1, T * S * M))
    dist = torch.cat([
        torch.cdist(p[i:i + step].flatten(0, 1), g[i:i + step].flatten(0, 1),
                    compute_mode=EXACT).view(-1, T, S, M).mean(dim=1)
        for i in range(0, B, step)
    ])                                                   # [B,S,M]
    return _masked_gt_mean(dist.amin(dim=1), mm_mask)


def mmfde(target: torch.Tensor, pred: torch.Tensor, mm_gt: torch.Tensor,
          mm_mask: torch.Tensor, t0: int = 0, t: int = -1, **kw) -> torch.Tensor:
    """Multimodal FDE; reference `multimodal.py:121-135`."""
    pred = _time_slice(pred, t0, t, 2)
    mm_gt = _time_slice(mm_gt, t0, t, 2)
    B, S, T = pred.shape[:3]
    M = mm_gt.shape[1]
    if mm_gt.shape[2] != T:
        raise ValueError(f"mm_gt {tuple(mm_gt.shape)} and pred {tuple(pred.shape)} differ in "
                         "length")
    p = pred[:, :, -1].reshape(B, S, -1)
    g = mm_gt[:, :, -1].reshape(B, M, -1)
    dist = torch.cdist(p, g, compute_mode=EXACT)         # [B,S,M]
    return _masked_gt_mean(dist.amin(dim=1), mm_mask)


def lat_apd(lat_pred: torch.Tensor, **kw) -> torch.Tensor:
    """APD in latent space with L1 distances; reference
    `multimodal.py:137-151`."""
    B, S = lat_pred.shape[:2]
    flat = lat_pred.reshape(B, S, -1)
    return _triu_mean(torch.cdist(flat, flat, p=1.0))


def motion_for_cmd(pred: torch.Tensor) -> torch.Tensor:
    """Per-frame mean joint displacement averaged over samples: input
    [B,S,T,J,3] → [B,T-1]; reference `src/metrics/cmd.py:10-12`."""
    vel = torch.linalg.vector_norm(pred[..., 1:, :, :] - pred[..., :-1, :, :], dim=-1)
    return vel.mean(dim=1).mean(dim=-1)


def cmd_from_curve(val_per_frame: np.ndarray, val_ref: float) -> float:
    """Σ_t (T−t)·|M_t − M̄|; reference `multimodal.py:10-13`."""
    T = len(val_per_frame) + 1
    return float(np.sum([(T - t) * np.abs(val_per_frame[t - 1] - val_ref) for t in range(1, T)]))


def resolve_cmd(motion_curves: np.ndarray, obs_classes: np.ndarray,
                mean_motion_per_class: Sequence[float]) -> float:
    """Class-weighted CMD over the accumulated per-segment motion curves;
    reference `src/metrics/cmd.py:15-31`."""
    results = 0.0
    for i in range(len(mean_motion_per_class)):
        mask = obs_classes == i
        if mask.sum() == 0:
            continue
        mean_curve = motion_curves[mask].mean(axis=0)
        results += cmd_from_curve(mean_curve, mean_motion_per_class[i]) * (
            mask.sum() / obs_classes.shape[0]
        )
    return results


def best_sample_index(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-item index of the sample closest to GT under the reference's
    selection norm — per-JOINT L2, mean over joints and time
    (`src/metrics/utils.py:12-30`), not the ADE norm."""
    dist = torch.linalg.vector_norm(pred - target[:, None], dim=-1)  # [B,S,T,N]
    return torch.argmin(dist.mean(dim=(-1, -2)), dim=-1)


def choose_best_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Closest-to-GT sample per item; reference `src/metrics/utils.py:12-30`."""
    idx = best_sample_index(pred, target)
    return pred[torch.arange(pred.shape[0], device=pred.device), idx]
