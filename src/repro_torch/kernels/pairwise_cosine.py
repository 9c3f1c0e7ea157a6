"""Gram-matrix kernel for Eq. 3 (``csrc/pairwise_cosine.cu``), the port of
``repro.kernels.pairwise_cosine.gram_matrix``.

:func:`gram_matrices` takes the Gram matrix of every leaf of a parameter
dict in one launch; :func:`gram_matrix` is its one-leaf case.  Both launch
the CUDA kernel for CUDA tensors and run
:func:`repro_torch.kernels.ref.gram_matrix` (leaf by leaf) for CPU tensors;
they never fall back from one to the other.  ``gram_matrix.launches``
counts kernel launches.

:func:`plan_gram` is the launch plan: which 64 x 64 output tiles are
computed, how each leaf's D is split among clusters of 8 blocks, and where
each leaf's cluster sums and tickets lie.  A leaf's own numbers depend only
on its n, its D and the SM count, so a grouped call gives each leaf the
bits a call of its own would.  The tickets are zeroed int32 counters kept
per device (:func:`repro_torch.kernels.cuda.counters`) that the kernel
leaves zeroed, so calls on one device must run one after another.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from . import cuda, ref

_NAME = "pairwise_cosine"
_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_SIGNATURES = {"gram_f32": _ARGS, "gram_bf16": _ARGS}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
TILE = 64          # output tile side (kTile in the source)
DEPTH = 64         # D columns per pipeline stage (kDepth)
CLUSTER = 8        # blocks per cluster (kCluster)
MAX_LEAVES = 32    # leaves per launch (kMaxLeaves)
MIN_STAGES = 2     # a split takes at least this many stages where D allows


class LeafPlan(NamedTuple):
    """One leaf of a grouped call: ``clusters`` of 8 blocks per tile, each
    block summing ``split_len`` columns of D; its clusters, cluster sums
    (floats) and tickets start at ``cluster0``, ``scratch0`` and
    ``ticket0``."""
    d: int
    clusters: int
    split_len: int
    cluster0: int
    scratch0: int
    ticket0: int


def gram_tiles(n: int) -> List[Tuple[int, int]]:
    """The computed output tiles ``(i, j)``, ``i <= j``, in the order the
    kernel numbers them (row by row of the upper triangle)."""
    t = -(-n // TILE)
    return [(i, j) for i in range(t) for j in range(i, t)]


def leaf_split(n: int, d: int, sms: int) -> Tuple[int, int]:
    """``(clusters per tile, split_len)`` of one leaf: up to about one
    block per SM for its tiles, each split a whole number of stages and at
    least :data:`MIN_STAGES` of them where D is long enough."""
    tiles = len(gram_tiles(n))
    stages = max(1, -(-d // DEPTH))
    clusters = max(1, min(sms // (CLUSTER * tiles),
                          -(-stages // (CLUSTER * MIN_STAGES))))
    return clusters, -(-stages // (CLUSTER * clusters)) * DEPTH


def gram_splits(d: int, clusters: int, split_len: int
                ) -> List[Tuple[int, int]]:
    """The D range ``[begin, end)`` of each block of a tile, in split
    order (block ``rank`` of cluster ``c`` sums split ``8 c + rank``);
    trailing splits may be empty."""
    out = []
    for s in range(clusters * CLUSTER):
        begin = min(d, s * split_len)
        out.append((begin, min(d, begin + split_len)))
    return out


def plan_gram(n: int, ds: Sequence[int], sms: int
              ) -> Tuple[List[LeafPlan], int, int]:
    """The plan of one launch over leaves of widths ``ds``: per leaf a
    :class:`LeafPlan`, then the floats of scratch and the tickets it
    needs.  A leaf with one cluster per tile writes its result directly
    and takes no scratch and no ticket."""
    tiles = len(gram_tiles(n))
    plans, cluster0, scratch0, ticket0 = [], 0, 0, 0
    for d in ds:
        clusters, split_len = leaf_split(n, d, sms)
        plans.append(LeafPlan(d, clusters, split_len, cluster0, scratch0,
                              ticket0))
        cluster0 += tiles * clusters
        if clusters > 1:
            scratch0 += tiles * clusters * TILE * TILE
            ticket0 += tiles * CLUSTER
    return plans, scratch0, ticket0


def gram_matrices(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``X [n, D]`` for every ``X`` in ``xs`` (f32 or bf16, one dtype, one
    n, any D each) -> the stack of their ``X X^T``, ``[len(xs), n, n]``
    f32; one launch for up to :data:`MAX_LEAVES` leaves."""
    if xs and xs[0].device.type == "cpu":
        return torch.stack([ref.gram_matrix(x) for x in xs])
    if not xs:
        raise ValueError("gram_matrices: needs at least one leaf")
    cuda.require("gram_matrix", *xs, dtypes=(torch.float32, torch.bfloat16))
    n = xs[0].shape[0] if xs[0].dim() == 2 else -1
    for x in xs:
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(f"gram_matrix: needs [n, D] leaves of one n, "
                             f"got {tuple(x.shape)}")
        if x.dtype != xs[0].dtype:
            raise ValueError(f"gram_matrix: the leaves of one call share one "
                             f"dtype, got {xs[0].dtype} and {x.dtype}")
    dev, count = xs[0].device, len(xs)
    sms = cuda.sm_count(dev)
    chunks = [range(s, min(s + MAX_LEAVES, count))
              for s in range(0, count, MAX_LEAVES)]
    plans = [plan_gram(n, [xs[i].shape[1] for i in c], sms) for c in chunks]
    scratch = max(p[1] for p in plans)
    # One allocation: the outputs, then the chunks' (shared) cluster sums.
    buf = torch.empty(count * n * n + scratch, dtype=torch.float32,
                      device=dev)
    out = buf[:count * n * n].view(count, n, n)
    tickets = cuda.counters(dev, _NAME, max(p[2] for p in plans))
    fn = cuda.function(_NAME, f"gram_{_SUFFIX[xs[0].dtype]}", _SIGNATURES)
    stream = cuda.stream_handle(dev)
    for chunk, (leaves, _, _) in zip(chunks, plans):
        rows = []
        for i, p in zip(chunk, leaves):
            rows += [xs[i].data_ptr(), p.d, p.clusters, p.split_len,
                     p.cluster0, p.scratch0, p.ticket0]
        status = fn((ctypes.c_longlong * len(rows))(*rows), len(leaves), n,
                    out[chunk.start].data_ptr(),
                    buf.data_ptr() + 4 * count * n * n, tickets.data_ptr(),
                    stream)
        cuda.check(cuda.library(_NAME, _SIGNATURES), _NAME, status,
                   "gram_matrix")
        gram_matrix.launches += 1
    return out


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``X [n, D]`` (f32 or bf16) -> ``X X^T [n, n]`` f32."""
    if x.device.type == "cpu":
        return ref.gram_matrix(x)
    return gram_matrices([x])[0]


gram_matrix.launches = 0
