"""Graph-mixing kernels (``csrc/graph_mix.cu``), the port of
``repro.kernels.graph_mix``: :func:`graph_mix` (``W [m, n] @ X [n, D]``)
and :func:`graph_mix_masked` (uniform averaging built from the in-edge
matrix inside the kernel), and their grouped forms
:func:`graph_mix_leaves` and :func:`graph_mix_masked_leaves`, which mix
every leaf of a parameter dict in one launch, on the small route (up to
128 nodes and rows) and on the tiled one past it alike.  The one-tensor
wrappers are the one-leaf case of the same launch.

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version in :mod:`repro_torch.kernels.ref` (leaf by leaf) for CPU tensors,
never falling back from one to the other; ``graph_mix.launches`` and
``graph_mix_masked.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Sequence, Tuple

import torch

from . import cuda, ref

_NAME = "graph_mix"
_P, _I, _T = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "graph_mix_f32": [_P, _T, _I, _I, _I, _I, _P, _P],
    "graph_mix_bf16": [_P, _T, _I, _I, _I, _I, _P, _P],
    "graph_mix_masked_f32": [_P, _T, _I, _I, _I, _P, _P],
    "graph_mix_masked_bf16": [_P, _T, _I, _I, _I, _P, _P],
}
_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
COLS = 64            # D columns per tile of the small route (kItemCols)
SMALL_NODES = 128    # past this many nodes or rows: the tiled route
TILE = 128           # the tiled route's tiles: TILE rows x TILE columns
MAX_LEAVES = 64      # leaves per launch (kMaxLeaves)


def plan_mix(ds: Sequence[int]) -> List[int]:
    """The number of each leaf's first 64-column tile among a grouped
    call's tiles, numbered leaf after leaf; it depends only on the widths
    of the leaves before it."""
    firsts, at = [], 0
    for d in ds:
        firsts.append(at)
        at += -(-d // COLS)
    return firsts


def mix_items(ds: Sequence[int], firsts: Sequence[int]
              ) -> Iterator[Tuple[int, int, int]]:
    """``(leaf, first column, end column)`` of every tile of a grouped
    call, found from the tile's number as the kernel finds it."""
    total = firsts[-1] + -(-ds[-1] // COLS) if ds else 0
    for item in range(total):
        leaf = 0
        while leaf + 1 < len(ds) and firsts[leaf + 1] <= item:
            leaf += 1
        c0 = (item - firsts[leaf]) * COLS
        yield leaf, c0, min(ds[leaf], c0 + COLS)


def plan_tiled(m: int, ds: Sequence[int]) -> List[int]:
    """The tiled route's plan: the number of each leaf's first item among
    a grouped call's items, an item being ``TILE`` output rows x ``TILE``
    columns of one leaf, ``ceil(m / TILE)`` of them per column stripe;
    numbered leaf after leaf, it depends only on m and the widths of the
    leaves before it."""
    firsts, at = [], 0
    for d in ds:
        firsts.append(at)
        at += -(-m // TILE) * -(-d // TILE)
    return firsts


def tiled_items(m: int, ds: Sequence[int], firsts: Sequence[int]
                ) -> Iterator[Tuple[int, int, int, int, int]]:
    """``(leaf, first row, end row, first column, end column)`` of every
    item of a grouped call on the tiled route, in item order, found from
    the item's number as the kernel finds it: inside a leaf the row tiles
    of one column stripe follow each other, so the blocks working at one
    time share that stripe of X."""
    row_tiles = -(-m // TILE)
    total = firsts[-1] + row_tiles * -(-ds[-1] // TILE) if ds else 0
    for item in range(total):
        leaf = 0
        while leaf + 1 < len(ds) and firsts[leaf + 1] <= item:
            leaf += 1
        stripe, tile = divmod(item - firsts[leaf], row_tiles)
        r0, c0 = tile * TILE, stripe * TILE
        yield leaf, r0, min(m, r0 + TILE), c0, min(ds[leaf], c0 + TILE)


def _check_leaves(what: str, xs: Sequence[torch.Tensor], n: int) -> None:
    for x in xs:
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(f"{what}: X must be [{n}, D], got "
                             f"{tuple(x.shape)}")
        if x.dtype != xs[0].dtype:
            raise ValueError(f"{what}: the leaves of one call share one "
                             f"dtype, got {xs[0].dtype} and {x.dtype}")


def _launch(kernel, what: str, src: torch.Tensor, xs: Sequence[torch.Tensor],
            m: int, n: int) -> List[torch.Tensor]:
    """Allocate the outputs and launch ``kernel``'s C function over the
    leaves, at most :data:`MAX_LEAVES` a launch."""
    dev, dtype = xs[0].device, xs[0].dtype
    ds = [x.shape[1] for x in xs]
    ys = [torch.empty((m, d), dtype=dtype, device=dev) for d in ds]
    masked = kernel is graph_mix_masked
    fn = cuda.function(_NAME, f"{kernel.__name__}_{_SUFFIX[dtype]}",
                       _SIGNATURES)
    shape = (n,) if masked else (m, n)
    sms, stream = cuda.sm_count(dev), cuda.stream_handle(dev)
    sched = cuda.counters(dev, _NAME, 2).data_ptr()
    tiled = m > SMALL_NODES or n > SMALL_NODES
    for start in range(0, len(xs), MAX_LEAVES):
        chunk = range(start, min(start + MAX_LEAVES, len(xs)))
        widths = ds[chunk.start:chunk.stop]
        rows = []
        plan = plan_tiled(m, widths) if tiled else plan_mix(widths)
        for i, first in zip(chunk, plan):
            rows += [xs[i].data_ptr(), ys[i].data_ptr(), xs[i].shape[1],
                     first]
        status = fn(src.data_ptr(), (ctypes.c_longlong * len(rows))(*rows),
                    len(widths), *shape, sms, sched, stream)
        cuda.check(cuda.library(_NAME, _SIGNATURES), _NAME, status, what)
        kernel.launches += int(any(d > 0 for d in widths))
    return ys


def graph_mix_leaves(w: torch.Tensor, xs: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """``W [m, n]`` (f32) ``@ X [n, D]`` for every ``X`` in ``xs`` (f32 or
    bf16, one dtype, any D each) -> ``[m, D]`` in X's dtype, accumulated
    in f32; one launch (up to :data:`MAX_LEAVES` leaves)."""
    if not xs:
        return []
    if xs[0].device.type == "cpu":
        return [ref.graph_mix(w, x) for x in xs]
    cuda.require("graph_mix", w, *xs, dtypes=_DTYPES)
    if w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError("graph_mix: W must be a 2-D f32 tensor")
    m, n = w.shape
    _check_leaves("graph_mix", xs, n)
    return _launch(graph_mix, "graph_mix", w, xs, m, n)


def graph_mix_masked_leaves(edges: torch.Tensor, xs: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Uniform averaging ``((E + I) / rowsum) @ X`` from the bool in-edge
    matrix ``E [n, n]`` (``E[i, j]``: j sends to i) for every ``X [n, D]``
    in ``xs`` (f32 or bf16, one dtype) -> ``[n, D]`` in X's dtype."""
    if not xs:
        return []
    if xs[0].device.type == "cpu":
        return [ref.graph_mix_masked(edges, x) for x in xs]
    cuda.require("graph_mix_masked", edges, *xs, dtypes=_DTYPES)
    n = edges.shape[0]
    if edges.dtype != torch.bool or tuple(edges.shape) != (n, n):
        raise ValueError("graph_mix_masked: E must be a square bool tensor")
    _check_leaves("graph_mix_masked", xs, n)
    return _launch(graph_mix_masked, "graph_mix_masked", edges, xs, n, n)


def graph_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W [m, n]`` (f32) ``@ X [n, D]`` (f32 or bf16) -> ``[m, D]`` in
    ``x.dtype``, accumulated in f32."""
    return graph_mix_leaves(w, [x])[0]


def graph_mix_masked(edges: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Uniform averaging ``((E + I) / rowsum) @ X`` from the bool in-edge
    matrix ``E [n, n]``; ``X [n, D]`` f32 or bf16 -> ``[n, D]`` in
    ``x.dtype``."""
    return graph_mix_masked_leaves(edges, [x])[0]


graph_mix.launches = 0
graph_mix_masked.launches = 0
