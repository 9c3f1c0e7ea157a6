"""k-sparse graph-mixing kernel (``csrc/graph_mix_sparse.cu``), the port of
``repro.kernels.graph_mix_sparse``: ``out[i] = w_self[i] x[i] + sum_s
w[i, s] x[idx[i, s]]`` straight from CSR slots.

:func:`graph_mix_sparse` launches the CUDA kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.graph_mix_sparse` for CPU tensors, never
falling back from one to the other; ``graph_mix_sparse.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda, ref

_NAME = "graph_mix_sparse"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _L, _P]
_SIGNATURES = {"graph_mix_sparse_f32": _ARGS, "graph_mix_sparse_bf16": _ARGS}


def graph_mix_sparse(idx: torch.Tensor, w: torch.Tensor,
                     w_self: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """CSR mix of ``X [n, D]`` (f32 or bf16) -> ``[n, D]`` in ``x.dtype``,
    accumulated in f32.  ``idx [n, k]`` (int32 on the card, each in ``[0,
    n)``), ``w [n, k]`` and ``w_self [n]`` f32; invalid slots point at
    their own row with weight 0 (:func:`~.ops.mix_sparse` parks them)."""
    if x.device.type == "cpu":
        return ref.graph_mix_sparse(idx, w, w_self, x)
    cuda.require("graph_mix_sparse", idx, w, w_self, x,
                 dtypes=(torch.float32, torch.bfloat16))
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"graph_mix_sparse: idx [n, k] and X [n, D] "
                         f"disagree: {tuple(idx.shape)}, {tuple(x.shape)}")
    n, k = idx.shape
    if idx.dtype != torch.int32 or w.dtype != torch.float32 \
            or w_self.dtype != torch.float32 or tuple(w.shape) != (n, k) \
            or tuple(w_self.shape) != (n,):
        raise ValueError("graph_mix_sparse: needs idx [n, k] int32, w [n, k] "
                         "f32 and w_self [n] f32")
    d = x.shape[1]
    y = torch.empty_like(x)
    lib = cuda.library(_NAME, _SIGNATURES)
    fn = lib.graph_mix_sparse_f32 if x.dtype == torch.float32 \
        else lib.graph_mix_sparse_bf16
    status = fn(idx.data_ptr(), w.data_ptr(), w_self.data_ptr(),
                x.data_ptr(), y.data_ptr(), n, k, d,
                cuda.stream_handle(x.device))
    cuda.check(lib, _NAME, status, "graph_mix_sparse")
    graph_mix_sparse.launches += 1
    return y


graph_mix_sparse.launches = 0
