"""Offline dataset statistics: per-class mean motion (CMD reference), the
multimodal ground-truth neighbor index, and the finishing step that writes
both next to a freshly created dataset.

A copy of ``skeletondiffusion_tpu/data/mmgt.py`` (`:31-109`) and of
``data/preprocess/common.py::finalize_dataset`` (`:17`); reference
`src/data/loaders/base/{math_utils,create_dataset_utils}.py`.  The O(N²)
pairwise-distance sweep over all last-observed frames runs as chunked numpy
matmuls instead of the reference's nested Python loop over dataloader pairs.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Set

import numpy as np
import torch


def _to_metric_space(skeleton, x: np.ndarray) -> np.ndarray:
    """RAW world-frame segments → the skeleton's METRIC space (hip-centered,
    root handled per config).  The reference computes both statistics on
    metric-space poses — its dataloader emits input-space tensors and
    `math_utils.py:23,89` applies ``transform_to_metric_space``; our
    ``__getitem__`` returns raw segments (the input transform runs batched
    on device), so compose both transforms here.  Raw world coordinates
    would inflate every displacement by the global locomotion and make
    far-apart identical poses never match.  The transforms run in torch on
    the CPU, in the array's dtype."""
    x = torch.from_numpy(np.ascontiguousarray(x))
    return skeleton.transform_to_metric_space(skeleton.tranform_to_input_space(x)).numpy()


def compute_mean_motions(dataset, batch_size: int = 128):
    """Per-class mean frame displacement over the test split, in METRIC
    space; reference `math_utils.py:8-48`."""
    skeleton = dataset.skeleton
    class_to_idx = dataset.class_to_idx
    class_average = {k: 0.0 for k in class_to_idx}
    class_counter = {k: 0 for k in class_to_idx}
    n = len(dataset)
    for start in range(0, n, batch_size):
        targets, classes = [], []
        for i in range(start, min(start + batch_size, n)):
            _, pred, extra = dataset[i]
            targets.append(pred)
            classes.append(dataset.extract_action_label(extra))
        target = _to_metric_space(skeleton, np.stack(targets))
        vel = np.linalg.norm(target[:, 1:] - target[:, :-1], axis=-1)  # [b,T-1,J]
        per_item = vel.mean(axis=-1).mean(axis=-1)  # [b]
        for label, v in zip(classes, per_item):
            class_average[label] += float(v)
            class_counter[label] += 1
    motions = [class_average[c] / max(class_counter[c], 1) for c in class_average]
    total = sum(class_counter.values())
    freqs = [class_counter[c] / total for c in class_average]
    return class_average, motions, freqs


def get_multimodal_gt(
    last_obs_frames: np.ndarray, multimodal_threshold: float, chunk: int = 2048
) -> Dict[int, List[int]]:
    """Pairs (i,j) with ‖lastframe_i − lastframe_j‖ < threshold (symmetric,
    self included); reference `math_utils.py:59-110`.

    ``last_obs_frames``: [N, J, 3] metric-space last observed frame of every
    segment, in dataset order.
    """
    N = last_obs_frames.shape[0]
    flat = last_obs_frames.reshape(N, -1).astype(np.float64)
    sq = (flat * flat).sum(axis=1)
    thr2 = float(multimodal_threshold) ** 2
    neighbors: Dict[int, Set[int]] = {}
    for i0 in range(0, N, chunk):
        a = flat[i0 : i0 + chunk]
        for j0 in range(i0, N, chunk):
            b = flat[j0 : j0 + chunk]
            # Gram expansion ‖a−b‖² = ‖a‖²+‖b‖²−2abᵀ: only the [chunk,chunk]
            # distance matrix materializes (the broadcast difference would be
            # a ~2 GB [chunk,chunk,J·3] block per pair)
            d2 = (
                sq[i0 : i0 + a.shape[0], None]
                + sq[None, j0 : j0 + b.shape[0]]
                - 2.0 * (a @ b.T)
            )
            ii, jj = np.nonzero(d2 < thr2)
            for x, y in zip(ii + i0, jj + j0):
                neighbors.setdefault(int(x), set()).add(int(y))
                neighbors.setdefault(int(y), set()).add(int(x))
    return {k: sorted(neighbors[k]) for k in sorted(neighbors)}


def save_mmgt(mmgt: Dict[int, List[int]], path: str):
    """Same on-disk format as the reference (json-encoded dict repr with
    sets, `create_dataset_utils.py:63-65`)."""
    as_sets = {k: set(v) for k, v in mmgt.items()}
    with open(path, "w") as fh:
        json.dump(str(as_sets), fh)


def compute_multimodal_gt_for_dataset(
    dataset, skeleton, multimodal_threshold: float, dest_path: str, chunk: int = 2048
):
    """End-to-end: gather last obs frames, map to METRIC space (the space
    the reference thresholds in — see ``_to_metric_space``) → neighbor dict
    → file; reference `create_dataset_utils.py:34-66`."""
    n = len(dataset)
    last_frames = np.stack([dataset[i][0][-1] for i in range(n)])
    last_frames = _to_metric_space(skeleton, last_frames)
    mmgt = get_multimodal_gt(last_frames, multimodal_threshold, chunk=chunk)
    save_mmgt(mmgt, dest_path)
    return mmgt


def finalize_dataset(
    dataset_cls,
    skeleton,
    precomputed_folder: str,
    segments_path: str,
    multimodal_threshold: float,
    split: str = "test",
    **dataset_kwargs,
):
    """Compute mean_motion_test.txt + mmgt_<split>.txt for a freshly created
    dataset; reference `create_amass_dataset.py:262-302`."""
    dataset = dataset_cls(
        split=split, precomputed_folder=precomputed_folder, skeleton=skeleton,
        segments_path=segments_path, if_consider_hip=False, silent=True, **dataset_kwargs,
    )
    dest_mm = os.path.join(precomputed_folder, "mean_motion_test.txt")
    if not os.path.exists(dest_mm):
        class_average, motions, freqs = compute_mean_motions(dataset)
        with open(dest_mm, "w") as fh:
            fh.write("\n".join(
                f"{c},{m},{f}" for c, m, f in zip(class_average.keys(), motions, freqs)
            ))
    dest_mmgt = os.path.join(precomputed_folder, f"mmgt_{split}.txt")
    if not os.path.exists(dest_mmgt):
        compute_multimodal_gt_for_dataset(
            dataset, skeleton, multimodal_threshold=multimodal_threshold, dest_path=dest_mmgt
        )
    return dataset
