"""k-sparse graph-mixing kernel (``csrc/graph_mix_sparse.cu``), the port of
``repro.kernels.graph_mix_sparse``: ``out[i] = w_self[i] x[self0 + i] +
sum_s w[i, s] x[idx[i, s]]`` straight from CSR slots (``self0`` 0 on one
device; a sharded engine's receiver block gives its first row, its push
partials None: no self term).

:func:`graph_mix_sparse_leaves` mixes every leaf of a parameter dict with
the same slots in one launch; :func:`graph_mix_sparse` is its one-leaf
case.  Each launches the CUDA kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.graph_mix_sparse` (leaf by leaf) for CPU
tensors, never falling back from one to the other;
``graph_mix_sparse.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from . import cuda, ref

_NAME = "graph_mix_sparse"
_P, _I, _T = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
_ARGS = [_P, _P, _P, _T, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"graph_mix_sparse_f32": _ARGS, "graph_mix_sparse_bf16": _ARGS}
_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
RECEIVERS = 4        # receivers per item (kRecv)
LANE_BYTES = 16      # bytes of a row each of a warp's 32 lanes takes
MAX_LEAVES = 64      # leaves per launch (kMaxLeaves)


def stripe_cols(itemsize: int) -> int:
    """Columns per stripe: a warp's 32 lanes x 16 bytes (128 f32, 256
    bf16)."""
    return 32 * LANE_BYTES // itemsize


def plan_sparse(n: int, ds: Sequence[int], itemsize: int) -> List[int]:
    """The number of each leaf's first item among a grouped call's items,
    an item being :data:`RECEIVERS` receivers x one stripe of columns of
    one leaf; numbered leaf after leaf, it depends only on n, the element
    size and the widths of the leaves before it."""
    firsts, at = [], 0
    for d in ds:
        firsts.append(at)
        at += -(-n // RECEIVERS) * -(-d // stripe_cols(itemsize))
    return firsts


def sparse_items(n: int, ds: Sequence[int], firsts: Sequence[int],
                 itemsize: int) -> Iterator[Tuple[int, int, int, int, int]]:
    """``(leaf, first column, end column, first receiver, end receiver)``
    of every item of a grouped call, in item order, found from the item's
    number as the kernel finds it: inside a leaf every receiver group of a
    stripe comes before the next stripe, so the rows of a stripe stay in
    L2 while the receivers that name them are mixed."""
    groups, width = -(-n // RECEIVERS), stripe_cols(itemsize)
    total = firsts[-1] + groups * -(-ds[-1] // width) if ds else 0
    for item in range(total):
        leaf = 0
        while leaf + 1 < len(ds) and firsts[leaf + 1] <= item:
            leaf += 1
        stripe, group = divmod(item - firsts[leaf], groups)
        c0, r0 = stripe * width, group * RECEIVERS
        yield leaf, c0, min(ds[leaf], c0 + width), r0, min(n, r0 + RECEIVERS)


def graph_mix_sparse_leaves(idx: torch.Tensor, w: torch.Tensor,
                            w_self: Optional[torch.Tensor],
                            xs: Sequence[torch.Tensor],
                            self0: Optional[int] = 0) -> List[torch.Tensor]:
    """CSR mix of every ``X [m, D]`` in ``xs`` (f32 or bf16, one dtype,
    any D each) for the ``n`` receivers of ``idx [n, k]`` -> ``[n, D]`` in
    X's dtype, accumulated in f32; one launch (up to :data:`MAX_LEAVES`
    leaves).  Receiver i's own row is ``self0 + i`` (``self0 + n <= m``);
    ``self0=None`` leaves the self term out (``w_self`` unread).  ``idx``
    (int32 on the card, each in ``[0, m)``), ``w [n, k]`` and ``w_self
    [n]`` f32; invalid slots point at a row of X with weight 0
    (:func:`~.ops.mix_sparse` parks them)."""
    if not xs:
        return []
    if xs[0].device.type == "cpu":
        return [ref.graph_mix_sparse(idx, w, w_self, x, self0) for x in xs]
    operands = (idx, w) if self0 is None else (idx, w, w_self)
    cuda.require("graph_mix_sparse", *operands, *xs, dtypes=_DTYPES)
    n, k = idx.shape if idx.dim() == 2 else (-1, -1)
    m = xs[0].shape[0] if xs[0].dim() == 2 else -1
    for x in xs:
        if x.dim() != 2 or x.shape[0] != m or (
                self0 is not None and not 0 <= self0 <= m - n):
            raise ValueError(f"graph_mix_sparse: idx [n, k], X [m, D] and "
                             f"self0 {self0} (0 <= self0 <= m - n) "
                             f"disagree: {tuple(idx.shape)}, "
                             f"{tuple(x.shape)}")
        if x.dtype != xs[0].dtype:
            raise ValueError(f"graph_mix_sparse: the leaves of one call "
                             f"share one dtype, got {xs[0].dtype} and "
                             f"{x.dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32 \
            or tuple(w.shape) != (n, k) or self0 is not None and (
                w_self.dtype != torch.float32
                or tuple(w_self.shape) != (n,)):
        raise ValueError("graph_mix_sparse: needs idx [n, k] int32, w [n, k] "
                         "f32 and w_self [n] f32")
    dev, dtype = xs[0].device, xs[0].dtype
    ys = [x.new_empty((n, x.shape[1])) for x in xs]
    fn = cuda.function(_NAME, f"graph_mix_sparse_{_SUFFIX[dtype]}",
                       _SIGNATURES)
    sms, stream = cuda.sm_count(dev), cuda.stream_handle(dev)
    size = xs[0].element_size()
    for start in range(0, len(xs), MAX_LEAVES):
        chunk = range(start, min(start + MAX_LEAVES, len(xs)))
        widths = [xs[i].shape[1] for i in chunk]
        rows = []
        for i, first in zip(chunk, plan_sparse(n, widths, size)):
            rows += [xs[i].data_ptr(), ys[i].data_ptr(), xs[i].shape[1],
                     first]
        status = fn(idx.data_ptr(), w.data_ptr(),
                    None if self0 is None else w_self.data_ptr(),
                    (ctypes.c_longlong * len(rows))(*rows), len(widths), n,
                    k, -1 if self0 is None else self0, sms, stream)
        cuda.check(cuda.library(_NAME, _SIGNATURES), _NAME, status,
                   "graph_mix_sparse")
        graph_mix_sparse.launches += int(any(d > 0 for d in widths))
    return ys


def graph_mix_sparse(idx: torch.Tensor, w: torch.Tensor,
                     w_self: Optional[torch.Tensor], x: torch.Tensor,
                     self0: Optional[int] = 0) -> torch.Tensor:
    """CSR mix of ``X [m, D]`` (f32 or bf16) -> ``[n, D]`` in ``x.dtype``,
    accumulated in f32: the one-leaf case of
    :func:`graph_mix_sparse_leaves`."""
    return graph_mix_sparse_leaves(idx, w, w_self, [x], self0)[0]


graph_mix_sparse.launches = 0
