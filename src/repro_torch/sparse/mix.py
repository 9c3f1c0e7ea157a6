"""k-sparse mixing and candidate-set similarity — the port of the
single-device part of ``repro.sparse.mix`` (DESIGN.md §11).

:func:`sparse_mix_pytree` mixes every leaf in O(n k D) through the CSR
kernel (:func:`repro_torch.kernels.ops.mix_sparse_pytree`; its plain
version for CPU tensors).  :func:`candidate_similarity` is Eq. 3 against
a ``[n, c]`` candidate set only, in plain PyTorch as the reference leaves
it to XLA's gather and einsum.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import ops
from .adjacency import SparseAdjacency

_EPS = 1e-12


def sparse_mix_rows(adj: SparseAdjacency, x: torch.Tensor) -> torch.Tensor:
    """Mix one flat ``[n, D]`` leaf: ``out[i] = w_self[i] x[i] + sum_s
    w[i, s] x[idx[i, s]]`` (receiver i is source row i)."""
    return ops.mix_sparse(adj.idx, adj.w, adj.w_self, x, mask=adj.mask)


def sparse_mix_pytree(adj: SparseAdjacency, tree: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """:func:`sparse_mix_rows` over every leaf of node-stacked parameters,
    keeping leaf shapes and dtypes."""
    return ops.mix_sparse_pytree(adj.idx, adj.w, adj.w_self, tree,
                                 mask=adj.mask)


def candidate_similarity(tree: Dict[str, torch.Tensor], cand: torch.Tensor,
                         row_chunk: Optional[int] = None) -> torch.Tensor:
    """Eq.-3 cosine of every node against its ``[n, c]`` candidates only:
    per-leaf cosines averaged over leaves -> ``[n, c]`` f32, entry ``(i,
    a)`` comparing node i with node ``cand[i, a]``.

    The cosine is ``dots / (own * peer + 1e-12)``, the reference's
    placement of the epsilon (the Gram path clamps the norms instead).
    ``row_chunk`` takes that many receivers at a time, bounding the
    gathered ``[rows, c, D]`` buffer; rows are independent, so the result
    does not depend on it."""
    leaves = list(tree.values())
    if not leaves:
        raise ValueError("empty parameter pytree")
    n = cand.shape[0]
    rc = n if row_chunk is None else min(row_chunk, n)
    cand = cand.long()

    def block(s: int) -> torch.Tensor:
        total = None
        for leaf in leaves:
            flat = leaf.reshape(leaf.shape[0], -1).float()
            fa = flat[s:s + rc]                               # [m, D]
            cv = flat[cand[s:s + rc]]                         # [m, c, D]
            dots = torch.einsum("nd,ncd->nc", fa, cv)
            own = torch.sqrt((fa * fa).sum(dim=1))            # [m]
            peer = torch.sqrt(torch.einsum("ncd,ncd->nc", cv, cv))
            cos = dots / (own[:, None] * peer + _EPS)
            total = cos if total is None else total + cos
        return total / len(leaves)

    if rc >= n:
        return block(0)
    return torch.cat([block(s) for s in range(0, n, rc)], dim=0)
