"""Limb-realism metrics (stretching/jitter, normed by GT limb length), in
torch, over predictions [B,S,T,J,3] and targets [B,T,J,3].

Port of ``skeletondiffusion_tpu/metrics/body_realism.py`` (reference
`src/metrics/body_realism.py`).
"""
from __future__ import annotations

import numpy as np
import torch

Array = torch.Tensor


def _extract_limb_length(kpts: Array, limbseq) -> Array:
    """[..., J, 3] → [..., n_limbs]; reference `body_realism.py:4-13`
    (zero-root re-insertion when limb indices reference the dropped hip)."""
    limbseq = np.asarray(limbseq)
    if limbseq.max() == kpts.shape[-2]:
        kpts = torch.cat([torch.zeros_like(kpts[..., :1, :]), kpts], dim=-2)
    idx = torch.as_tensor(limbseq, device=kpts.device)
    return torch.linalg.vector_norm(kpts[..., idx[:, 0], :] - kpts[..., idx[:, 1], :], dim=-1)


def limb_length_error(target: Array, pred: Array, limbseq, mode: str = "mean", **kw) -> Array:
    """|GT limb length − pred limb length| mean over limbs+time; reference
    `body_realism.py:32-48`."""
    t_ll = _extract_limb_length(target, limbseq)
    p_ll = _extract_limb_length(pred, limbseq)
    llerr = torch.abs(t_ll[:, None] - p_ll).mean(dim=-1).mean(dim=-1)  # [B,S]
    return _reduce_samples(llerr, mode)


def limb_length_variance(pred: Array, limbseq, mode: str = "mean", if_per_sample: bool = False, **kw) -> Array:
    """Temporal variance of limb lengths; reference `body_realism.py:50-77`."""
    p_ll = _extract_limb_length(pred, limbseq)  # [B,S,T,J]
    llvar = p_ll.var(dim=-2, correction=1)  # unbiased, as the reference's
    if mode == "none":
        return llvar
    llvar = _reduce_limbs(llvar, mode)
    if if_per_sample:
        return llvar
    return _reduce_samples(llvar, mode)


def limb_length_jitter(pred: Array, limbseq, mode: str = "mean", if_per_sample: bool = False, **kw) -> Array:
    """Frame-to-frame limb-length delta; reference `body_realism.py:79-108`."""
    p_ll = _extract_limb_length(pred, limbseq)
    jit = torch.abs(p_ll[..., 1:, :] - p_ll[..., :-1, :])  # [B,S,T-1,J]
    if mode == "none":
        return jit
    if mode == "mean":
        out = jit.mean(dim=-1).mean(dim=-1)
    elif mode == "max":
        out = jit.amax(dim=-1).amax(dim=-1)
    else:
        out = jit.amin(dim=-1).amin(dim=-1)
    if if_per_sample:
        return out
    return _reduce_samples(out, mode)


def limb_length_variation_difference_wrtGT(target: Array, pred: Array, limbseq, mode: str = "mean", **kw) -> Array:
    """Reference `body_realism.py:15-29`."""
    pred_llerr = limb_length_jitter(pred=pred, limbseq=limbseq, mode=mode)
    target_llerr = limb_length_jitter(pred=target[:, None], limbseq=limbseq, mode=mode)
    return pred_llerr - target_llerr


def limb_stretching_normed_rmse(
    pred: Array, target: Array, limbseq, mode: str = "std", reduction: str = "mean", **kw
) -> Array:
    """RMSE of limb length around the GT mean, normed by GT mean length;
    reference `body_realism.py:110-131`."""
    ll = _extract_limb_length(pred, limbseq)            # [B,S,T,J]
    ll_gt = _extract_limb_length(target, limbseq)       # [B,T,J]
    mean = ll_gt.mean(dim=-2)[:, None, None, :]             # [B,1,1,J]
    var = ((ll - mean) ** 2).mean(dim=-2)                   # [B,S,J]
    if mode == "std":
        var = torch.sqrt(var)
    var = var / mean[:, :, 0, :]
    return _reduce_final(var, reduction)


def limb_stretching_normed_mean(
    pred: Array, target: Array, limbseq, reduction: str = "mean", **kw
) -> Array:
    """|mean pred limb length − mean GT| / mean GT; reference
    `body_realism.py:133-151`."""
    ll = _extract_limb_length(pred, limbseq)
    ll_gt = _extract_limb_length(target, limbseq)
    mean_gt = ll_gt.mean(dim=-2)[:, None, :]                # [B,1,J]
    mean = ll.mean(dim=-2)                                  # [B,S,J]
    normed = torch.abs(mean - mean_gt) / mean_gt
    return _reduce_final(normed, reduction)


def limb_jitter_normed_rmse(
    pred: Array, target: Array, limbseq, mode: str = "std", reduction: str = "mean", **kw
) -> Array:
    """Reference `body_realism.py:154-179` (GT jitter assumed 0)."""
    jit = limb_length_jitter(pred, limbseq, mode="none")  # [B,S,T-1,J]
    ll_gt = _extract_limb_length(target, limbseq)
    mean = ll_gt.mean(dim=-2)[:, None, :]                    # [B,1,J]
    var = (jit**2).mean(dim=-2)                              # [B,S,J]
    if mode == "std":
        var = torch.sqrt(var)
    var = var / mean
    return _reduce_final(var, reduction)


def limb_jitter_normed_mean(pred: Array, target: Array, limbseq, reduction: str = "mean", **kw) -> Array:
    """Reference `body_realism.py:181-199`."""
    jit = limb_length_jitter(pred, limbseq, mode="none")
    ll_gt = _extract_limb_length(target, limbseq)
    mean_gt = ll_gt.mean(dim=-2)[:, None, :]
    normed = jit.mean(dim=-2) / mean_gt
    return _reduce_final(normed, reduction)


def _reduce_samples(x: Array, mode: str) -> Array:
    if mode == "mean":
        return x.mean(dim=-1)
    if mode == "max":
        return x.amax(dim=-1)
    if mode == "min":
        return x.amin(dim=-1)
    raise ValueError(mode)


def _reduce_limbs(x: Array, mode: str) -> Array:
    if mode == "mean":
        return x.mean(dim=-1)
    if mode == "max":
        return x.amax(dim=-1)
    return x.amin(dim=-1)


def _reduce_final(x: Array, reduction: str) -> Array:
    B = x.shape[0]
    if reduction == "mean":
        return x.reshape(B, -1).mean(-1)
    if reduction == "persample":
        return x.mean(-1)
    return x
