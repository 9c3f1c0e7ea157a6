"""The kernels applied to whole parameter dicts — the port of
``repro.kernels.ops``.

Eq. 3 is the per-leaf cosine averaged over leaves in leaf order; the
cosine is the Gram matrix divided by ``max(sqrt(diag), 1e-12)`` on both
sides, so a zero leaf (biases at initialization) gives 0, not NaN.  The
kernels mask their ragged tails themselves, so nothing is padded here.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from .graph_mix import graph_mix, graph_mix_masked
from .pairwise_cosine import gram_matrix

_EPS = 1e-12


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between all rows of ``X [n, D]`` -> ``[n, n]``."""
    g = gram_matrix(x)
    norms = torch.sqrt(torch.diagonal(g)).clamp_min(_EPS)
    return g / (norms[:, None] * norms[None, :])


def model_pairwise_cosine(stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eq. 3 on node-stacked parameters: per-leaf cosine, averaged."""
    leaves = list(stacked.values())
    n = leaves[0].shape[0]
    acc = torch.zeros((n, n), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        acc += pairwise_cosine(leaf.reshape(n, -1))
    return acc / len(leaves)


def mix_pytree(w: torch.Tensor, stacked: Dict[str, torch.Tensor]
               ) -> "OrderedDict[str, torch.Tensor]":
    """Apply ``W [m, n]`` to every leaf (``[n, ...]`` -> ``[m, ...]``)."""
    w = w.float().contiguous()
    m = w.shape[0]
    return OrderedDict(
        (k, graph_mix(w, v.reshape(v.shape[0], -1)).reshape(
            (m,) + v.shape[1:]))
        for k, v in stacked.items())


def mix_masked_pytree(edges: torch.Tensor, stacked: Dict[str, torch.Tensor]
                      ) -> "OrderedDict[str, torch.Tensor]":
    """Uniform-average mixing from the raw in-edge matrix, every leaf."""
    edges = edges.contiguous()
    return OrderedDict(
        (k, graph_mix_masked(edges, v.reshape(v.shape[0], -1)).reshape(
            v.shape))
        for k, v in stacked.items())
