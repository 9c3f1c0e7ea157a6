"""Graph-mixing kernels (``csrc/graph_mix.cu``), the port of
``repro.kernels.graph_mix``: :func:`graph_mix` (``W [m, n] @ X [n, D]``)
and :func:`graph_mix_masked` (uniform averaging built from the in-edge
matrix inside the kernel).

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version in :mod:`repro_torch.kernels.ref` for CPU tensors, never falling
back from one to the other; ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda, ref

_NAME = "graph_mix"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "graph_mix_f32": [_P, _P, _P, _I, _I, _L, _P],
    "graph_mix_bf16": [_P, _P, _P, _I, _I, _L, _P],
    "graph_mix_masked_f32": [_P, _P, _P, _I, _L, _P],
    "graph_mix_masked_bf16": [_P, _P, _P, _I, _L, _P],
}
_DTYPES = (torch.float32, torch.bfloat16)


def _check_x(what: str, x: torch.Tensor, n: int) -> None:
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"{what}: X must be [{n}, D], got {tuple(x.shape)}")


def graph_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W [m, n]`` (f32) ``@ X [n, D]`` (f32 or bf16) -> ``[m, D]`` in
    ``x.dtype``, accumulated in f32."""
    if x.device.type == "cpu":
        return ref.graph_mix(w, x)
    cuda.require("graph_mix", w, x, dtypes=_DTYPES)
    if w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError("graph_mix: W must be a 2-D f32 tensor")
    m, n = w.shape
    _check_x("graph_mix", x, n)
    d = x.shape[1]
    y = torch.empty((m, d), dtype=x.dtype, device=x.device)
    lib = cuda.library(_NAME, _SIGNATURES)
    fn = lib.graph_mix_f32 if x.dtype == torch.float32 \
        else lib.graph_mix_bf16
    status = fn(w.data_ptr(), x.data_ptr(), y.data_ptr(), m, n, d,
                cuda.stream_handle(x.device))
    cuda.check(lib, _NAME, status, "graph_mix")
    graph_mix.launches += 1
    return y


def graph_mix_masked(edges: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Uniform averaging ``((E + I) / rowsum) @ X`` from the bool in-edge
    matrix ``E [n, n]`` (``E[i, j]``: j sends to i); ``X [n, D]`` f32 or
    bf16 -> ``[n, D]`` in ``x.dtype``."""
    if x.device.type == "cpu":
        return ref.graph_mix_masked(edges, x)
    cuda.require("graph_mix_masked", edges, x, dtypes=_DTYPES)
    n = edges.shape[0]
    if edges.dtype != torch.bool or tuple(edges.shape) != (n, n):
        raise ValueError("graph_mix_masked: E must be a square bool tensor")
    _check_x("graph_mix_masked", x, n)
    d = x.shape[1]
    y = torch.empty_like(x)
    lib = cuda.library(_NAME, _SIGNATURES)
    fn = lib.graph_mix_masked_f32 if x.dtype == torch.float32 \
        else lib.graph_mix_masked_bf16
    status = fn(edges.data_ptr(), x.data_ptr(), y.data_ptr(), n, d,
                cuda.stream_handle(x.device))
    cuda.check(lib, _NAME, status, "graph_mix_masked")
    graph_mix_masked.launches += 1
    return y


graph_mix.launches = 0
graph_mix_masked.launches = 0
