"""Model similarity (paper Eq. 3): per-layer cosine similarity averaged
over layers — the plain PyTorch port of ``repro.core.similarity``.

These run on any device and are the oracles for the Gram kernel path
(:func:`repro_torch.kernels.ops.model_pairwise_cosine`).  Every leaf of a
parameter dict is one "layer"; leaves are averaged in dict order, which
:mod:`repro_torch.tree` keeps equal to the reference's leaf order.
"""
from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-12


def layer_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between two same-shaped parameter tensors."""
    af = a.reshape(-1).float()
    bf = b.reshape(-1).float()
    return torch.dot(af, bf) / (af.norm() * bf.norm()).clamp_min(_EPS)


def model_similarity(params_a: Dict[str, torch.Tensor],
                     params_b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eq. 3 between two models: mean over leaves of the leaf cosine."""
    if len(params_a) != len(params_b):
        raise ValueError(
            f"parameter dicts disagree: {len(params_a)} vs {len(params_b)} "
            "leaves")
    sims = [layer_cosine(a, b)
            for a, b in zip(params_a.values(), params_b.values())]
    return torch.stack(sims).mean()


def pairwise_model_similarity(stacked: Dict[str, torch.Tensor]
                              ) -> torch.Tensor:
    """Eq. 3 for all node pairs of node-stacked parameters ``[n, ...]``
    -> ``[n, n]``."""
    leaves = list(stacked.values())
    if not leaves:
        raise ValueError("empty parameter dict")
    n = leaves[0].shape[0]
    acc = torch.zeros((n, n), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        flat = leaf.reshape(n, -1).float()
        norms = torch.sqrt((flat * flat).sum(dim=1)).clamp_min(_EPS)
        acc = acc + (flat @ flat.T) / (norms[:, None] * norms[None, :])
    return acc / len(leaves)
