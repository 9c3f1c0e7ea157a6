"""Gram-matrix kernel for Eq. 3 (``csrc/pairwise_cosine.cu``), the port of
``repro.kernels.pairwise_cosine.gram_matrix``.

:func:`gram_matrix` launches the CUDA kernel for a CUDA tensor and runs
:func:`repro_torch.kernels.ref.gram_matrix` for a CPU tensor; it never
falls back from one to the other.  ``gram_matrix.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda, ref

_NAME = "pairwise_cosine"
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p]
_SIGNATURES = {"gram_f32": _ARGS, "gram_bf16": _ARGS}
TILE = 64        # output tile side (kTile in the source)
DEPTH = 32       # D elements per shared-memory stage (kDepth)


def plan_splits(n: int, d: int, sms: int):
    """``(splits, split_len)`` of the split-K over D: about two blocks per
    SM in all, each split a whole number of ``DEPTH`` stages."""
    tiles = (-(-n // TILE)) ** 2
    stages = -(-d // DEPTH)
    splits = max(1, min(stages, -(-2 * sms // tiles)))
    split_len = -(-stages // splits) * DEPTH
    return -(-d // split_len), split_len


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``X [n, D]`` (f32 or bf16) -> ``X X^T [n, n]`` f32."""
    if x.device.type == "cpu":
        return ref.gram_matrix(x)
    cuda.require("gram_matrix", x, dtypes=(torch.float32, torch.bfloat16))
    if x.dim() != 2:
        raise ValueError(f"gram_matrix: needs [n, D], got {tuple(x.shape)}")
    n, d = x.shape
    splits, split_len = plan_splits(n, d, cuda.sm_count(x.device))
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    scratch = out if splits == 1 else torch.empty(
        (splits, n, n), dtype=torch.float32, device=x.device)
    lib = cuda.library(_NAME, _SIGNATURES)
    fn = lib.gram_f32 if x.dtype == torch.float32 else lib.gram_bf16
    status = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, d,
                split_len, splits, cuda.stream_handle(x.device))
    cuda.check(lib, _NAME, status, "gram_matrix")
    gram_matrix.launches += 1
    return out


gram_matrix.launches = 0
