"""Non-IID Dirichlet partitioning (paper §IV-A1) — a bit-for-bit numpy
copy of ``repro.data.partition.dirichlet_partition``."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_nodes: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_node: int = 2) -> List[np.ndarray]:
    """Split sample indices across nodes with Dirichlet(alpha) class skew.

    Resamples (up to 100 tries) until every node holds at least
    ``min_per_node`` samples.  Per class, node boundaries are the rounded
    cumulative proportions, which conserve the class count.
    """
    labels = np.asarray(labels)
    classes = np.unique(labels)
    for _ in range(100):
        parts: List[List[int]] = [[] for _ in range(n_nodes)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(n_nodes, alpha))
            cuts = np.round(np.cumsum(props)[:-1] * len(idx)).astype(int)
            for node, chunk in enumerate(np.split(idx, cuts)):
                parts[node].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_per_node:
            return [np.asarray(sorted(p), np.int64) for p in parts]
    raise RuntimeError("dirichlet_partition failed to satisfy min_per_node")
