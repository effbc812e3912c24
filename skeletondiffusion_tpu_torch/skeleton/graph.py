"""Skeleton graph construction (host-side numpy).

Semantics match the reference's kinematic graph utilities
(`src/data/skeleton/kinematic/utils.py:4-13` for the adjacency matrix and
`src/data/skeleton/kinematic/base.py:85-127` for the weighted reachability
matrix) — these run once at model-construction time, so plain numpy on host is
the right tool; only the resulting tables ever reach the device.  A copy of
``skeletondiffusion_tpu/skeleton/graph.py``: the port imports nothing of the
JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def get_adj_matrix(limbseq: Sequence[Tuple[int, int]], num_nodes: int) -> np.ndarray:
    """Symmetric 0/1 adjacency from a limb (edge) list.

    Mirrors reference `src/data/skeleton/kinematic/utils.py:4-13`.
    """
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    for i, j in limbseq:
        adj[i, j] = 1.0
        adj[j, i] = 1.0
    return adj


def reachability_matrix(
    adj: np.ndarray,
    node_names: List[str],
    factor: float = 0.5,
    stop_at: Union[None, int, str, List[int]] = "hips",
) -> np.ndarray:
    """Weighted reachability: entry (i,j) = factor**(d-1) where d is the path
    length found by the reference's depth-first search, 0 if unreachable.

    Replicates the reference's exact search semantics
    (`src/data/skeleton/kinematic/base.py:85-127`) including its quirk: while
    expanding node i's neighbors in index order, encountering a neighbor in
    ``stop_at`` aborts the whole sub-search (returns unreachable) rather than
    just skipping that branch.
    """
    num_nodes = adj.shape[0]
    reach = np.zeros_like(adj)

    if stop_at is not None:
        if stop_at == "hips":
            stop_at = [k for k, v in enumerate(node_names) if "hip" in v.lower()]
        elif stop_at == "bmn":
            stop_at = [k for k, v in enumerate(node_names) if "bmn" in v.lower()]
        elif isinstance(stop_at, (int, np.integer)):
            stop_at = [int(stop_at)]
        elif not isinstance(stop_at, list):
            raise NotImplementedError(f"stop_at={stop_at!r}")

    def last_node_reached(k: int) -> bool:
        return stop_at is not None and k in stop_at

    def is_reachable(i: int, j: int, visited: Tuple[int, ...]) -> int:
        if adj[i, j] == 1:
            return 1
        reachable_paths = [0]
        for k in range(num_nodes):
            if adj[i, k] == 1:
                if last_node_reached(k):
                    return 0
                if k not in visited:
                    reached = is_reachable(k, j, visited + (k,))
                    if reached > 0:
                        if 0 in reachable_paths:
                            reachable_paths.remove(0)
                        reachable_paths.append(reached + 1)
        return min(reachable_paths)

    for i in range(num_nodes):
        for j in range(i + 1, num_nodes):
            d = is_reachable(i, j, ())
            reach[i, j] = factor ** (d - 1) if d > 0 else 0.0
            reach[j, i] = reach[i, j]
    return reach


def parents_from_limbseq(limbseq: Sequence[Tuple[int, int]], num_joints: int) -> List[Optional[int]]:
    """Parent index per joint (root = -1); mirrors `kinematic/base.py:29-37`."""
    parents: List[Optional[int]] = [None] * num_joints
    parents[0] = -1
    for a, b in limbseq:
        if not a < b:
            raise ValueError("limbseq tuples must be (parent_idx < child_idx)")
        parents[b] = a
    return parents
