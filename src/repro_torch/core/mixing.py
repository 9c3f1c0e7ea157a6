"""Mixing matrices and their plain application to node-stacked parameters
— the port of ``repro.core.mixing``.

``x_i <- sum_j W[i, j] x_j``: Morph and Epidemic Learning average self +
received models uniformly (Alg. 2 line 12), Static uses Metropolis-Hastings
weights on its fixed undirected graph, fully connected uses ``W = 1/n``.
The W constructors for fixed graphs are host numpy, as in the reference;
:func:`apply_mixing` is the plain path the mixing kernels are held to, and
:func:`apply_mixing_compressed` its compressed-gossip form.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import ref


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


def tensordot_mix_leaf(w: torch.Tensor, leaf: torch.Tensor,
                       chunk_d: Optional[int] = None) -> torch.Tensor:
    """``W [m, n] @ leaf [n, ...]`` over the node axis -> ``[m, ...]`` in
    the leaf dtype, in f32 (the reference's name).  ``chunk_d`` takes the
    flattened feature axis that many columns at a time, bounding the f32
    buffers at ``O(m chunk_d)``; the node axis is never split and each
    column is summed over the nodes in node order
    (:func:`repro_torch.kernels.ref.graph_mix`), so the result has the
    same bits whatever ``chunk_d``."""
    flat = leaf.reshape(leaf.shape[0], -1)
    out = ref.graph_mix(w, flat, chunk_d)
    return out.reshape((w.shape[0],) + leaf.shape[1:])


def apply_mixing(w: torch.Tensor, stacked: Dict[str, torch.Tensor],
                 chunk_d: Optional[int] = None
                 ) -> "OrderedDict[str, torch.Tensor]":
    """``W [m, n]`` applied over the node axis of every leaf, in f32 and
    cast back to the leaf dtype (:func:`tensordot_mix_leaf`)."""
    return OrderedDict((k, tensordot_mix_leaf(w, v, chunk_d))
                       for k, v in stacked.items())


def apply_consensus_correction(mixed: Dict[str, torch.Tensor],
                               params: Dict[str, torch.Tensor],
                               decoded: Dict[str, torch.Tensor],
                               gamma: float = 1.0
                               ) -> "OrderedDict[str, torch.Tensor]":
    """Consensus-difference form of compressed mixing: given ``mixed_i =
    sum_j W[i, j] decoded_j``, ``x_i <- params_i + gamma (mixed_i -
    decoded_i)``, in f32 and cast to the parameter dtype.  Only replica
    differences move the local model, so a coordinate no node has sent
    yet is left alone.  At ``gamma == 1`` the sum is taken as ``mixed +
    (params - decoded)``, the reference's association, so the step-size
    knob cannot move a full-step run by a rounding."""
    g = float(gamma)

    def one(m, p, dc):
        m32, p32 = m.float(), p.float()
        if g == 1.0:
            return (m32 + (p32 - dc)).to(p.dtype)
        return (p32 + g * (m32 - dc)).to(p.dtype)
    return OrderedDict((k, one(mixed[k], p, decoded[k]))
                       for k, p in params.items())


def apply_mixing_compressed(w: torch.Tensor, params: Dict[str, torch.Tensor],
                            decoded: Dict[str, torch.Tensor],
                            chunk_d: Optional[int] = None,
                            gamma: float = 1.0
                            ) -> "OrderedDict[str, torch.Tensor]":
    """Compressed-gossip mixing: ``W`` over the decoded replicas
    (:func:`apply_mixing`), then :func:`apply_consensus_correction`."""
    return apply_consensus_correction(apply_mixing(w, decoded, chunk_d),
                                      params, decoded, gamma)
