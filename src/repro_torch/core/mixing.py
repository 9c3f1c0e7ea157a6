"""Mixing matrices and their plain application to node-stacked parameters
— the port of ``repro.core.mixing``.

``x_i <- sum_j W[i, j] x_j``: Morph and Epidemic Learning average self +
received models uniformly (Alg. 2 line 12), Static uses Metropolis-Hastings
weights on its fixed undirected graph, fully connected uses ``W = 1/n``.
The W constructors for fixed graphs are host numpy, as in the reference;
:func:`apply_mixing` is the plain path the mixing kernels are held to.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch


def uniform_weights(edges: np.ndarray) -> np.ndarray:
    """Alg. 2 l.12 on the host: ``W = (E + I) / rowsum`` (f64); a node
    with no in-edges keeps its own model."""
    n = edges.shape[0]
    w = edges.astype(np.float64) + np.eye(n)
    return w / w.sum(axis=1, keepdims=True)


def uniform_weights_torch(edges: torch.Tensor) -> torch.Tensor:
    """:func:`uniform_weights` on a bool tensor, in f32 (the reference's
    ``uniform_weights_jax``)."""
    n = edges.shape[0]
    w = edges.float() + torch.eye(n, dtype=torch.float32,
                                  device=edges.device)
    return w / w.sum(dim=1, keepdim=True)


def metropolis_hastings_weights(adj: np.ndarray) -> np.ndarray:
    """MH weights on an undirected graph: ``W[i,j] = 1/(1+max(d_i,d_j))``,
    the diagonal takes the remainder.  Symmetric and doubly stochastic."""
    adj = np.asarray(adj, bool)
    if not (adj == adj.T).all():
        raise ValueError("Metropolis-Hastings weights need an undirected "
                         "(symmetric) adjacency matrix")
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    w = np.zeros((n, n), np.float64)
    ii, jj = np.nonzero(adj)
    w[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def fully_connected_weights(n: int) -> np.ndarray:
    """W = 1/n everywhere — the fully-connected upper bound's mixing."""
    return np.full((n, n), 1.0 / n)


def apply_mixing(w: torch.Tensor, stacked: Dict[str, torch.Tensor]
                 ) -> "OrderedDict[str, torch.Tensor]":
    """``W [m, n]`` applied over the node axis of every leaf, in f32 and
    cast back to the leaf dtype."""
    w32 = w.float()
    return OrderedDict(
        (k, torch.tensordot(w32, v.float(), dims=([1], [0])).to(v.dtype))
        for k, v in stacked.items())
