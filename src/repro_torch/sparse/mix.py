"""k-sparse mixing and candidate-set similarity — the port of
``repro.sparse.mix`` (DESIGN.md §11).

:func:`sparse_mix_pytree` mixes every leaf in O(n k D) through the CSR
kernel (:func:`repro_torch.kernels.ops.mix_sparse_pytree`; its plain
version for CPU tensors).  Given ``rows`` (a sharded engine's receiver
block over the gathered population) and :func:`sparse_push_leaves` (a
sharded engine's push partials) take the CSR kernel on the card too, with
the block's own rows (or no self term); on the CPU they sum as the
reference's ``jnp`` code does (:func:`slot_sum`), as the reference runs
those cases outside its kernel.  :func:`candidate_similarity` is Eq. 3
against a ``[n, c]`` candidate set only, in plain PyTorch as the reference
leaves it to XLA's gather and einsum.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..kernels import ops
from .adjacency import SparseAdjacency

_EPS = 1e-12


def slot_sum(w: torch.Tensor, x: torch.Tensor, idx: torch.Tensor
             ) -> torch.Tensor:
    """``sum_s w[:, s] x[idx[:, s]]`` in f32 as XLA's CPU einsum takes it
    in the reference: the slots in slot order, each step one fused
    multiply-add (the exact product added, one rounding).  The product
    of two f32 values is exact in f64, so each step adds it there and
    rounds the sum to f32 once, on any device; that differs from a fused
    multiply-add only where the f64 sum lands on an f32 rounding tie."""
    acc = torch.zeros((idx.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    w64 = w.double()
    for j in range(idx.shape[1]):
        acc = (acc.double() + w64[:, j:j + 1] * x[idx[:, j]].double()) \
            .float()
    return acc


def _block_leaves(idx: torch.Tensor, w: torch.Tensor,
                  w_self: Optional[torch.Tensor], xs: List[torch.Tensor],
                  self0: Optional[int], chunk_d: Optional[int]
                  ) -> List[torch.Tensor]:
    """``out[i] = sum_s w[i, s] x[idx[i, s]] + w_self[i] x[self0 + i]``
    (no self term for ``self0=None``) of every flat ``[m, D]`` leaf, for
    the ``n`` receivers of ``idx``; ``w`` is zero on invalid slots.  CUDA
    tensors: one grouped CSR launch.  CPU tensors: the reference's bits,
    the slots by :func:`slot_sum` and then the self term's rounded
    product, ``chunk_d`` columns at a time (the same bits)."""
    if not xs or xs[0].device.type != "cpu":
        return ops.mix_sparse_leaves(idx, w, w_self, xs, self0=self0)
    idx, n = idx.long(), idx.shape[0]
    out = []
    for x in xs:
        d = x.shape[1]
        step = d if chunk_d is None else chunk_d
        pieces = []
        for s in range(0, max(d, 1), step):
            xf = x[:, s:s + step].float()
            piece = slot_sum(w, xf, idx)
            if self0 is not None:
                piece = piece + w_self.float()[:, None] \
                    * xf[self0:self0 + n]
            pieces.append(piece)
        y = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
        out.append(y.to(x.dtype))
    return out


def sparse_mix_rows(adj: SparseAdjacency, x: torch.Tensor,
                    rows: Optional[int] = None,
                    chunk_d: Optional[int] = None) -> torch.Tensor:
    """Mix one flat ``[n_src, D]`` leaf for the ``m`` receivers named by
    ``adj``'s rows: ``out[i] = w_self[i] x[rows + i] + sum_s w[i, s]
    x[idx[i, s]]``.

    ``rows=None``: receiver i is source row i (the single-device layout),
    through the CSR kernel.  Given ``rows``, ``adj`` holds the receiver
    block whose own rows are ``rows .. rows + m - 1`` of ``x``, the
    gathered population: the CSR kernel on the card, and on the CPU the
    reference's bits (the valid slots' products summed by
    :func:`slot_sum`, then the self term's rounded product added);
    ``chunk_d`` takes the feature axis that many columns at a time there
    (the same bits; the kernel blocks D itself and does not read it)."""
    if rows is None:
        return ops.mix_sparse(adj.idx, adj.w, adj.w_self, x, mask=adj.mask)
    return sparse_mix_pytree(adj, {"x": x}, rows, chunk_d)["x"]


def sparse_mix_pytree(adj: SparseAdjacency, tree: Dict[str, torch.Tensor],
                      rows: Optional[int] = None,
                      chunk_d: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """:func:`sparse_mix_rows` over every leaf of node-stacked parameters
    (``[n_src, ...]``), giving ``[m, ...]`` leaves in their dtypes: one
    grouped CSR launch for every leaf on the card."""
    if rows is None:
        return ops.mix_sparse_pytree(adj.idx, adj.w, adj.w_self, tree,
                                     mask=adj.mask)
    m = adj.idx.shape[0]
    flat = [v.reshape(v.shape[0], -1) for v in tree.values()]
    wm = torch.where(adj.mask, adj.w, 0.0).float()
    ys = _block_leaves(adj.idx, wm, adj.w_self, flat, rows, chunk_d)
    return OrderedDict((k, y.reshape((m,) + v.shape[1:]))
                       for (k, v), y in zip(tree.items(), ys))


def sparse_push_leaves(idx: torch.Tensor, w: torch.Tensor,
                       xs: List[torch.Tensor],
                       chunk_d: Optional[int] = None) -> List[torch.Tensor]:
    """A sharded rank's push partials: ``out[i] = sum_s w[i, s] x[idx[i,
    s]]`` over its senders' flat ``[m, D]`` leaves for every receiver of
    ``idx`` (``w`` zero on the slots of other ranks' senders, ``idx`` in
    ``[0, m)``), with no self term; the CSR kernel on the card,
    :func:`slot_sum` on the CPU."""
    return _block_leaves(idx, w, None, xs, None, chunk_d)


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
