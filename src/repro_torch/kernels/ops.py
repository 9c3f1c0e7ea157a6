"""The kernels applied to whole parameter dicts — the port of
``repro.kernels.ops``.

Eq. 3 is the per-leaf cosine averaged over leaves in leaf order; the
cosine is the Gram matrix divided by ``max(sqrt(diag), 1e-12)`` on both
sides, so a zero leaf (biases at initialization) gives 0, not NaN.  The
kernels mask their ragged tails themselves, so nothing is padded here.
On the card one launch takes the Gram matrix of every leaf, and one mixes
every leaf (dense or CSR); on the CPU each leaf goes through the plain
versions in turn.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch

from .graph_mix import graph_mix_leaves, graph_mix_masked_leaves
from .graph_mix_sparse import graph_mix_sparse, graph_mix_sparse_leaves
from .pairwise_cosine import gram_matrices, gram_matrix

_EPS = 1e-12


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between all rows of ``X [n, D]`` -> ``[n, n]``."""
    g = gram_matrix(x)
    norms = torch.sqrt(torch.diagonal(g)).clamp_min(_EPS)
    return g / (norms[:, None] * norms[None, :])


def model_pairwise_cosine(stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eq. 3 on node-stacked parameters: per-leaf cosine, averaged in leaf
    order.  On the card the Gram matrices of all leaves come from one
    launch and the epilogue runs on their stack, with the same operations
    per element as :func:`pairwise_cosine`, so the result is the bits of
    the leaf-by-leaf loop the CPU runs."""
    leaves = list(stacked.values())
    n = leaves[0].shape[0]
    if leaves[0].device.type == "cpu":
        acc = torch.zeros((n, n), dtype=torch.float32)
        for leaf in leaves:
            acc += pairwise_cosine(leaf.reshape(n, -1))
        return acc / len(leaves)
    g = gram_matrices([leaf.reshape(n, -1) for leaf in leaves])
    norms = torch.sqrt(torch.diagonal(g, dim1=1, dim2=2)).clamp_min(_EPS)
    cos = g / (norms[:, :, None] * norms[:, None, :])
    # A running sum along the leaves adds them one after another from 0,
    # as the loop does, in one launch.
    return torch.cumsum(cos, dim=0)[-1] / len(leaves)


def mix_pytree(w: torch.Tensor, stacked: Dict[str, torch.Tensor]
               ) -> "OrderedDict[str, torch.Tensor]":
    """Apply ``W [m, n]`` to every leaf (``[n, ...]`` -> ``[m, ...]``)."""
    w = w.float().contiguous()
    m = w.shape[0]
    ys = graph_mix_leaves(w, [v.reshape(v.shape[0], -1)
                              for v in stacked.values()])
    return OrderedDict((k, y.reshape((m,) + v.shape[1:]))
                       for (k, v), y in zip(stacked.items(), ys))


def mix_masked_pytree(edges: torch.Tensor, stacked: Dict[str, torch.Tensor]
                      ) -> "OrderedDict[str, torch.Tensor]":
    """Uniform-average mixing from the raw in-edge matrix, every leaf."""
    edges = edges.contiguous()
    ys = graph_mix_masked_leaves(edges, [v.reshape(v.shape[0], -1)
                                         for v in stacked.values()])
    return OrderedDict((k, y.reshape(v.shape))
                       for (k, v), y in zip(stacked.items(), ys))


def _csr_operands(idx: torch.Tensor, w: torch.Tensor, w_self: torch.Tensor,
                  mask: Optional[torch.Tensor]):
    """The kernel's operands: invalid slots parked on the receiver's own
    row with weight 0, idx int32, weights f32, all contiguous."""
    if mask is not None:
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        idx = torch.where(mask, idx, rows)
        w = torch.where(mask, w, 0.0)
    return (idx.to(torch.int32).contiguous(), w.float().contiguous(),
            w_self.float().contiguous())


def mix_sparse(idx: torch.Tensor, w: torch.Tensor, w_self: torch.Tensor,
               x: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """CSR k-sparse mix ``out[i] = w_self[i] x[i] + sum_s w[i, s]
    x[idx[i, s]]`` of ``X [n, D]``, O(n k D).  ``mask=None`` trusts
    ``idx`` / ``w`` to carry invalid slots as own-row / zero-weight
    already (the :class:`repro_torch.sparse.SparseAdjacency` invariant)."""
    return graph_mix_sparse(*_csr_operands(idx, w, w_self, mask),
                            x.contiguous())


def mix_sparse_pytree(idx: torch.Tensor, w: torch.Tensor,
                      w_self: torch.Tensor, stacked: Dict[str, torch.Tensor],
                      mask: Optional[torch.Tensor] = None
                      ) -> "OrderedDict[str, torch.Tensor]":
    """:func:`mix_sparse` over every leaf of node-stacked parameters: the
    operands are prepared once, and on the card one launch mixes every
    leaf."""
    ys = graph_mix_sparse_leaves(*_csr_operands(idx, w, w_self, mask),
                                 [v.reshape(v.shape[0], -1).contiguous()
                                  for v in stacked.values()])
    return OrderedDict((k, y.reshape(v.shape))
                       for (k, v), y in zip(stacked.items(), ys))
