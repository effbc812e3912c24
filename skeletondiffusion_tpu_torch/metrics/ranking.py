"""Diversity ranking for visualization: closest-to-GT sample + n most
diverse samples (greedy max–min pairwise distance); reference
`src/metrics/ranking.py:17-63`.

A copy of ``skeletondiffusion_tpu/metrics/ranking.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def get_closest_and_nfurthest_maxapd(pred: np.ndarray, target: np.ndarray, nsamples: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pred [S,T,J,3], target [T,J,3] → (closest sample, n diverse samples,
    their indices).  Host-side numpy (visualization path)."""
    S = pred.shape[0]
    flat = pred.reshape(S, -1)
    dist_to_gt = np.linalg.norm(flat - target.reshape(1, -1), axis=-1)
    closest_idx = int(np.argmin(dist_to_gt))

    pair = np.linalg.norm(flat[:, None] - flat[None], axis=-1)  # [S,S]
    chosen = [closest_idx]
    # nsamples == S is legal (the reference seeds its greedy with a pseudo-GT
    # row, so all S samples stay pickable): once every sample but the seed is
    # chosen, the closest sample itself completes the set
    for _ in range(min(nsamples, S - 1)):
        remaining = [i for i in range(S) if i not in chosen]
        # greedy: pick the sample maximizing its min distance to chosen set
        scores = [pair[i, chosen].min() for i in remaining]
        chosen.append(remaining[int(np.argmax(scores))])
    diverse = chosen[1:]
    if nsamples >= S:
        diverse = diverse + [closest_idx]
    diverse = diverse[:nsamples]
    return pred[closest_idx], pred[diverse], np.asarray(diverse)
