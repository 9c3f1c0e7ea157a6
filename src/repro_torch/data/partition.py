"""Non-IID data partitioning (paper §IV-A1) — a bit-for-bit numpy copy of
``repro.data.partition``.

* :func:`dirichlet_partition` — per class, proportions over nodes drawn
  from Dirichlet(alpha); alpha = 0.1 is the paper's CIFAR-10 split.
* :func:`by_writer_partition` — FEMNIST-style: each node receives whole
  writers.
* :func:`heterogeneity` — mean total-variation distance of the per-node
  label distributions (:func:`label_distributions`) from the global one.
"""
from __future__ import annotations

from typing import List, Sequence

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


def by_writer_partition(writer_ids: np.ndarray, n_nodes: int,
                        rng: np.random.Generator) -> List[np.ndarray]:
    """FEMNIST-style: assign whole writers to nodes round-robin after a
    random shuffle; every node gets >= 1 writer."""
    writers = np.unique(writer_ids)
    if len(writers) < n_nodes:
        raise ValueError("need at least one writer per node")
    rng.shuffle(writers)
    parts = [[] for _ in range(n_nodes)]
    for i, w in enumerate(writers):
        parts[i % n_nodes].extend(np.flatnonzero(writer_ids == w).tolist())
    return [np.asarray(sorted(p), np.int64) for p in parts]


def label_distributions(labels: np.ndarray, parts: Sequence[np.ndarray],
                        num_classes: int) -> np.ndarray:
    """``[n_nodes, num_classes]`` empirical label distribution per node."""
    out = np.zeros((len(parts), num_classes))
    for i, p in enumerate(parts):
        cnt = np.bincount(labels[p], minlength=num_classes)
        out[i] = cnt / max(cnt.sum(), 1)
    return out


def heterogeneity(labels: np.ndarray, parts: Sequence[np.ndarray],
                  num_classes: int) -> float:
    """Mean total-variation distance between node and global label
    distributions: 0 = IID, toward 1 = every node sees a single class."""
    dists = label_distributions(labels, parts, num_classes)
    glob = np.bincount(labels, minlength=num_classes) / len(labels)
    return float(np.mean(np.abs(dists - glob).sum(axis=1) / 2))
