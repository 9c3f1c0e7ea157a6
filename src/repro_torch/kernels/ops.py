"""The kernels applied to whole parameter dicts — the port of
``repro.kernels.ops``.

Eq. 3 is the per-leaf cosine averaged over leaves in leaf order; the
cosine is the Gram matrix divided by ``max(sqrt(diag), 1e-12)`` on both
sides, so a zero leaf (biases at initialization) gives 0, not NaN.  The
kernels mask their ragged tails themselves, so nothing is padded here.
On the card one launch takes the Gram matrix of every leaf, and one mixes
every leaf (dense or CSR); on the CPU each leaf goes through the plain
versions in turn.

The dense forms also take a sweep's ``[E, n, ...]`` stack of E
experiments' parameters: :func:`model_pairwise_cosine` with
``experiments=True`` gives each experiment's Eq.-3 matrix, and
:func:`mix_pytree` / :func:`mix_masked_pytree` given ``[E, m, n]``
weights (or ``[E, n, n]`` edges) mix each experiment with its own, every
leaf of every experiment in one grouped launch per
:data:`~repro_torch.kernels.graph_mix.MAX_LEAVES` leaves.  Each
experiment gets the bits of its own solo call.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

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


def model_pairwise_cosine(stacked: Dict[str, torch.Tensor],
                          experiments: bool = False) -> torch.Tensor:
    """Eq. 3 on node-stacked parameters: per-leaf cosine, averaged in leaf
    order: :func:`cosine_from_grams` of :func:`leaf_grams`.  On the card
    the Gram matrices of all leaves come from one launch and the epilogue
    runs on their stack, with the same operations per element as
    :func:`pairwise_cosine`, so the result is the bits of the
    leaf-by-leaf loop the CPU runs.

    ``experiments=True``: the leaves are ``[E, n, ...]``, and the result
    is each experiment's ``[E, n, n]`` matrix; on the card one launch
    takes the Gram matrices of every leaf of every experiment (up to
    :data:`~repro_torch.kernels.pairwise_cosine.MAX_LEAVES` a launch), and
    each experiment's mean still adds its leaves one after another from
    leaf 0.  Leaves of several dtypes take one launch per dtype."""
    if not experiments:
        return cosine_from_grams(leaf_grams(stacked))
    leaves = list(stacked.values())
    E, n = leaves[0].shape[:2]
    if leaves[0].device.type == "cpu":
        return torch.stack([model_pairwise_cosine(
            {k: v[e] for k, v in stacked.items()}) for e in range(E)])
    grams = [leaf[e].reshape(n, -1) for e in range(E) for leaf in leaves]
    return cosine_from_grams(_gram_by_dtype(grams).view(
        E, len(leaves), n, n))


def leaf_grams(stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The Gram matrix of every node-stacked leaf ``[n, ...]``, in leaf
    order, as ``[L, n, n]`` f32: Eq. 3's first stage.  On the card one
    grouped launch per dtype and :data:`~repro_torch.kernels.
    pairwise_cosine.MAX_LEAVES` leaves; on the CPU the plain Gram leaf by
    leaf.  A leaf whose columns are split over ranks gives its partial
    Gram, which the ranks sum before :func:`cosine_from_grams`."""
    leaves = list(stacked.values())
    n = leaves[0].shape[0]
    xs = [leaf.reshape(n, -1) for leaf in leaves]
    if leaves[0].device.type == "cpu":
        return torch.stack([gram_matrix(x) for x in xs])
    return _gram_by_dtype(xs)


def cosine_from_grams(grams: torch.Tensor) -> torch.Tensor:
    """Eq. 3's epilogue on ``[..., L, n, n]`` Gram matrices: each leaf's
    cosine (the Gram over ``max(sqrt(diag), 1e-12)`` on both sides, as
    :func:`pairwise_cosine`), averaged over the leaves -> ``[..., n, n]``.
    The leaves are added one after another from 0: on the card by a
    running sum along them, in one launch; on the CPU, whose ``cumsum``
    adds in f64, by a loop."""
    norms = torch.sqrt(torch.diagonal(grams, dim1=-2, dim2=-1)
                       ).clamp_min(_EPS)
    cos = grams / (norms[..., :, None] * norms[..., None, :])
    leaves = grams.shape[-3]
    if grams.device.type != "cpu":
        return torch.cumsum(cos, dim=-3).select(-3, -1) / leaves
    acc = torch.zeros_like(cos.select(-3, 0))
    for i in range(leaves):
        acc += cos.select(-3, i)
    return acc / leaves


def _gram_by_dtype(xs: List[torch.Tensor]) -> torch.Tensor:
    """:func:`gram_matrices` of leaves of one or more dtypes (a bf16
    model's f32 Mamba leaves): one grouped call per dtype, stacked in leaf
    order."""
    dtypes = {x.dtype for x in xs}
    n = xs[0].shape[0]
    out = torch.empty((len(xs), n, n), dtype=torch.float32,
                      device=xs[0].device)
    for dtype in sorted(dtypes, key=str):
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        out[idx] = gram_matrices([xs[i] for i in idx])
    return out


def mix_groups(stacked: Dict[str, torch.Tensor], group_bytes: int
               ) -> List[List[str]]:
    """The leaves of :func:`mix_masked_in_place`'s groups, in leaf order:
    consecutive leaves of one dtype, a group closed before it would pass
    ``group_bytes`` (a larger leaf is a group of its own)."""
    groups: List[List[str]] = []
    size, dtype = 0, None
    for k, v in stacked.items():
        nbytes = v.numel() * v.element_size()
        if not groups or v.dtype != dtype or size + nbytes > group_bytes:
            groups.append([])
            size, dtype = 0, v.dtype
        groups[-1].append(k)
        size += nbytes
    return groups


def mix_masked_in_place(edges: torch.Tensor,
                        stacked: Dict[str, torch.Tensor],
                        group_bytes: int) -> int:
    """:func:`mix_masked_pytree` of node-stacked leaves written over them,
    so that the mix never holds a second population: the leaves go in
    groups (:func:`mix_groups`), each group one grouped call into fresh
    outputs that are copied over its inputs before the next group starts,
    so the extra memory is one group.  Returns the number of groups (on
    the card, of launches for up to
    :data:`~repro_torch.kernels.graph_mix.MAX_LEAVES` leaves a group)."""
    edges = edges.contiguous()
    groups = mix_groups(stacked, group_bytes)
    for keys in groups:
        xs = [stacked[k].reshape(stacked[k].shape[0], -1) for k in keys]
        ys = graph_mix_masked_leaves(edges, xs)
        for x, y in zip(xs, ys):
            x.copy_(y)
        del ys
    return len(groups)


def _mix_experiments(mix_leaves, mats: torch.Tensor,
                     stacked: Dict[str, torch.Tensor], m: int,
                     chunk_d: Optional[int]
                     ) -> "OrderedDict[str, torch.Tensor]":
    """Every leaf of every experiment of an ``[E, n, ...]`` stack through
    one grouped call, experiment ``e``'s leaves with ``mats[e]``, written
    into ``[E, m, ...]`` outputs."""
    E, n = next(iter(stacked.values())).shape[:2]
    outs = OrderedDict((k, torch.empty((E, m) + v.shape[2:], dtype=v.dtype,
                                       device=v.device))
                       for k, v in stacked.items())
    ws, xs, ys = [], [], []
    for e in range(E):
        for k, v in stacked.items():
            ws.append(mats[e])
            xs.append(v[e].reshape(n, -1))
            ys.append(outs[k][e].reshape(m, -1))
    mix_leaves(ws, xs, chunk_d, out=ys)
    return outs


def mix_pytree(w: torch.Tensor, stacked: Dict[str, torch.Tensor],
               chunk_d: Optional[int] = None
               ) -> "OrderedDict[str, torch.Tensor]":
    """Apply ``W [m, n]`` to every leaf (``[n, ...]`` -> ``[m, ...]``), or
    ``W [E, m, n]`` to a sweep's ``[E, n, ...]`` leaves, each experiment
    its own; ``chunk_d`` bounds the plain version's buffers on the CPU,
    with the same bits (:func:`repro_torch.kernels.ref.graph_mix`)."""
    w = w.float().contiguous()
    if w.dim() == 3:
        return _mix_experiments(graph_mix_leaves, w, stacked, w.shape[1],
                                chunk_d)
    m = w.shape[0]
    ys = graph_mix_leaves(w, [v.reshape(v.shape[0], -1)
                              for v in stacked.values()], chunk_d)
    return OrderedDict((k, y.reshape((m,) + v.shape[1:]))
                       for (k, v), y in zip(stacked.items(), ys))


def mix_masked_pytree(edges: torch.Tensor, stacked: Dict[str, torch.Tensor],
                      chunk_d: Optional[int] = None
                      ) -> "OrderedDict[str, torch.Tensor]":
    """Uniform-average mixing from the raw in-edge matrix, every leaf
    (``[E, n, n]`` edges: a sweep's experiments, each its own); ``chunk_d``
    as in :func:`mix_pytree`."""
    edges = edges.contiguous()
    if edges.dim() == 3:
        return _mix_experiments(graph_mix_masked_leaves, edges, stacked,
                                edges.shape[1], chunk_d)
    ys = graph_mix_masked_leaves(edges, [v.reshape(v.shape[0], -1)
                                         for v in stacked.values()], chunk_d)
    return OrderedDict((k, y.reshape(v.shape))
                       for (k, v), y in zip(stacked.items(), ys))


def _csr_operands(idx: torch.Tensor, w: torch.Tensor,
                  w_self: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor], self0: Optional[int] = 0):
    """The kernel's operands: invalid slots parked on the receiver's own
    row (``self0 + i``; row 0 without a self term) with weight 0, idx
    int32, weights f32, all contiguous."""
    if mask is not None:
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        idx = torch.where(mask, idx, rows + self0 if self0 is not None
                          else torch.zeros_like(rows))
        w = torch.where(mask, w, 0.0)
    return (idx.to(torch.int32).contiguous(), w.float().contiguous(),
            None if w_self is None else w_self.float().contiguous())


def mix_sparse(idx: torch.Tensor, w: torch.Tensor, w_self: torch.Tensor,
               x: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """CSR k-sparse mix ``out[i] = w_self[i] x[i] + sum_s w[i, s]
    x[idx[i, s]]`` of ``X [n, D]``, O(n k D).  ``mask=None`` trusts
    ``idx`` / ``w`` to carry invalid slots as own-row / zero-weight
    already (the :class:`repro_torch.sparse.SparseAdjacency` invariant)."""
    return graph_mix_sparse(*_csr_operands(idx, w, w_self, mask),
                            x.contiguous())


def mix_sparse_leaves(idx: torch.Tensor, w: torch.Tensor,
                      w_self: Optional[torch.Tensor],
                      xs: List[torch.Tensor],
                      mask: Optional[torch.Tensor] = None,
                      self0: Optional[int] = 0) -> List[torch.Tensor]:
    """:func:`mix_sparse` of every flat ``X [m, D]`` in ``xs`` for the
    ``n`` receivers of ``idx``, giving ``[n, D]`` each: the operands are
    prepared once, and on the card one launch mixes every leaf.  Receiver
    i's own row is ``self0 + i`` (``None``: no self term, as
    :func:`~.graph_mix_sparse.graph_mix_sparse_leaves`)."""
    return graph_mix_sparse_leaves(
        *_csr_operands(idx, w, w_self, mask, self0),
        [x.contiguous() for x in xs], self0)


def mix_sparse_pytree(idx: torch.Tensor, w: torch.Tensor,
                      w_self: Optional[torch.Tensor],
                      stacked: Dict[str, torch.Tensor],
                      mask: Optional[torch.Tensor] = None,
                      self0: Optional[int] = 0
                      ) -> "OrderedDict[str, torch.Tensor]":
    """:func:`mix_sparse_leaves` over every leaf of node-stacked
    parameters ``[m, ...]``, giving ``[n, ...]`` leaves."""
    ys = mix_sparse_leaves(idx, w, w_self,
                           [v.reshape(v.shape[0], -1)
                            for v in stacked.values()], mask, self0)
    n = idx.shape[0]
    return OrderedDict((k, y.reshape((n,) + v.shape[1:]))
                       for (k, v), y in zip(stacked.items(), ys))
