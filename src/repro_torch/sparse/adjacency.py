"""CSR-style k-sparse adjacency state — the port of the single-device part
of ``repro.sparse.adjacency`` (DESIGN.md §11).

:class:`SparseAdjacency` is the compact twin of the dense engine's
``[n, n]`` edges and weights:

  ``idx    [n, k] int64`` — sender index per slot; invalid slots point at
                            the receiver's own row, so every gather stays
                            in bounds (int64 is torch's index type; the
                            kernel wrapper narrows it to int32);
  ``w      [n, k] f32``   — per-slot mixing weight (0 when invalid);
  ``w_self [n]    f32``   — the diagonal weight;
  ``mask   [n, k] bool``  — slot validity (in-degree = ``mask.sum(1)``).

Slot ``(i, s)`` is the edge ``idx[i, s] -> i``, matching ``edges[i, j]``
= "j sends to i".  :func:`dense_to_csr` and :func:`to_dense` round-trip
losslessly whenever the in-degree fits the slots, and
:func:`uniform_csr_weights` is entry for entry the f32 division
:func:`repro_torch.core.mixing.uniform_weights_torch` performs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.selection import stable_topk


class SparseAdjacency(NamedTuple):
    """One round's k-sparse topology and row-stochastic weights."""
    idx: torch.Tensor       # [n, k] int64, sender index per slot
    w: torch.Tensor         # [n, k] f32, slot weight (0 when invalid)
    w_self: torch.Tensor    # [n] f32, diagonal weight
    mask: torch.Tensor      # [n, k] bool, slot validity

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    def in_degree(self) -> torch.Tensor:
        """Per-receiver in-degree, ``[n]``."""
        return self.mask.sum(dim=1)


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None]


def uniform_csr_weights(idx: torch.Tensor, mask: torch.Tensor
                        ) -> SparseAdjacency:
    """Uniform Alg.-2 weights ``1 / (deg + 1)`` over the valid slots, the
    same f32 division the dense uniform weights make."""
    mask = mask.bool()
    inv = 1.0 / (mask.sum(dim=1) + 1).float()
    w = torch.where(mask, inv[:, None], 0.0)
    idx = torch.where(mask, idx.long(), _rows(idx.shape[0], idx.device))
    return SparseAdjacency(idx=idx, w=w, w_self=inv, mask=mask)


def dense_to_csr(edges: torch.Tensor, w: Optional[torch.Tensor],
                 k: int) -> SparseAdjacency:
    """Compress a dense ``[n, n]`` topology into ``k`` slots per row.

    Slots fill with the row's in-edges in ascending sender order; rows
    with fewer than ``k`` in-edges leave trailing slots invalid, rows
    with more drop their highest senders (:func:`validate_against_dense`
    catches that).  ``w=None`` derives uniform ``1 / (deg + 1)`` weights
    from the kept slots; otherwise ``w``'s entries and diagonal are
    gathered."""
    edges = edges.bool()
    n = edges.shape[0]
    k = min(k, n)
    # In-edges score above every other entry, each group by ascending
    # sender: the scores are distinct, so the top k fill the slots in
    # that order.
    j = torch.arange(n, device=edges.device)
    _, idx = stable_topk(torch.where(edges, 2 * n - j, n - j), k)
    rows = _rows(n, edges.device)
    mask = edges.gather(1, idx)
    idx = torch.where(mask, idx, rows)
    if w is None:
        return uniform_csr_weights(idx, mask)
    w = w.float()
    wk = torch.where(mask, w.gather(1, idx), 0.0)
    return SparseAdjacency(idx=idx, w=wk, w_self=torch.diagonal(w).clone(),
                           mask=mask)


def to_dense(adj: SparseAdjacency):
    """Expand to the dense pair ``(edges [n, n] bool, w [n, n] f32)``; the
    exact inverse of :func:`dense_to_csr` when no row overflowed."""
    n, dev = adj.n, adj.idx.device
    rows = _rows(n, dev).expand(-1, adj.k)
    edges = torch.zeros((n, n), dtype=torch.bool, device=dev)
    edges[rows[adj.mask], adj.idx[adj.mask]] = True
    w = torch.zeros((n, n), dtype=torch.float32, device=dev)
    w.index_put_((rows, adj.idx), torch.where(adj.mask, adj.w, 0.0),
                 accumulate=True)
    diag = torch.arange(n, device=dev)
    w[diag, diag] += adj.w_self
    return edges, w


def pad_adjacency(adj: SparseAdjacency, n_pad: int) -> SparseAdjacency:
    """Grow the receiver axis to ``n_pad`` (the sharded engine's padded
    node axis): padded rows have no in-edges (their slots name themselves,
    weight 0, invalid) and keep their own model (``w_self = 1``), as the
    dense engine's identity-tail ``embed_w`` does."""
    pad = n_pad - adj.n
    if pad <= 0:
        return adj
    k, dev = adj.k, adj.idx.device
    tail = torch.arange(adj.n, n_pad, dtype=adj.idx.dtype, device=dev)
    return SparseAdjacency(
        idx=torch.cat([adj.idx, tail[:, None].expand(pad, k)]),
        w=torch.cat([adj.w, torch.zeros((pad, k), dtype=torch.float32,
                                        device=dev)]),
        w_self=torch.cat([adj.w_self, torch.ones((pad,),
                                                 dtype=torch.float32,
                                                 device=dev)]),
        mask=torch.cat([adj.mask, torch.zeros((pad, k), dtype=torch.bool,
                                              device=dev)]))


def renormalize_drops(adj: SparseAdjacency, drop: torch.Tensor
                      ) -> SparseAdjacency:
    """Loss renormalization (Alg. 2 l. 12): the slots whose transfer the
    network dropped (``drop [n, k]``) fold their weight into the
    receiver's self-weight, so every row keeps its total mass, and are
    parked on the receiver's own row with weight 0 (the dense network
    path's rule, slot by slot)."""
    drop = drop.bool() & adj.mask
    zero = torch.zeros((), dtype=adj.w.dtype, device=adj.w.device)
    lost = torch.where(drop, adj.w, zero).sum(dim=1)
    mask = adj.mask & ~drop
    return SparseAdjacency(
        idx=torch.where(mask, adj.idx, _rows(adj.n, adj.idx.device)),
        w=torch.where(mask, adj.w, zero), w_self=adj.w_self + lost,
        mask=mask)


def _host(adj: SparseAdjacency):
    return (adj.idx.cpu().numpy(), adj.w.cpu().numpy().astype(np.float64),
            adj.w_self.cpu().numpy().astype(np.float64),
            adj.mask.cpu().numpy().astype(bool))


def validate(adj: SparseAdjacency, atol: float = 1e-6) -> None:
    """Host-side structural checks; raises ``ValueError`` on the first
    violation: index bounds, invalid slots parked on their own row with
    zero weight, no valid slot naming the receiver, no sender twice in a
    row, row-stochastic total mass."""
    idx, w, w_self, mask = _host(adj)
    n, k = idx.shape
    if idx.min(initial=0) < 0 or idx.max(initial=0) >= n:
        raise ValueError(f"sender index out of range [0, {n})")
    rows = np.broadcast_to(np.arange(n)[:, None], idx.shape)
    if (idx[~mask] != rows[~mask]).any():
        raise ValueError("invalid slots must point at their own row")
    if (w[~mask] != 0.0).any():
        raise ValueError("invalid slots must carry zero weight")
    if ((idx == rows) & mask).any():
        raise ValueError("valid slots must not name the receiver itself")
    for i in range(n):
        senders = idx[i][mask[i]]
        if len(np.unique(senders)) != len(senders):
            raise ValueError(f"row {i} names a sender twice")
    total = w.sum(axis=1) + w_self
    if not np.allclose(total, 1.0, atol=atol):
        bad = int(np.argmax(np.abs(total - 1.0)))
        raise ValueError(f"row {bad} weight mass {total[bad]:.8f} != 1")


def validate_against_dense(adj: SparseAdjacency, edges, w=None,
                           atol: float = 1e-6) -> None:
    """Host-side check that the CSR reproduces a dense ``(edges, w)``
    pair exactly — in particular that no row's in-degree overflowed the
    slots."""
    validate(adj, atol=atol)
    edges = np.asarray(edges, bool)
    deg = edges.sum(axis=1)
    if deg.max(initial=0) > adj.k:
        bad = int(np.argmax(deg))
        raise ValueError(
            f"row {bad} has in-degree {int(deg[bad])} > {adj.k} slots; "
            "the CSR conversion dropped edges")
    got_e, got_w = to_dense(adj)
    if not np.array_equal(got_e.cpu().numpy(), edges):
        raise ValueError("CSR edges do not reproduce the dense topology")
    if w is not None and not np.allclose(
            got_w.cpu().numpy(), np.asarray(w, np.float32), atol=atol):
        raise ValueError("CSR weights do not reproduce the dense W")
