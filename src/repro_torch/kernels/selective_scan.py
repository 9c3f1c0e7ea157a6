"""Fused Mamba (S6) selective-scan kernel (``csrc/selective_scan.cu``), the
port of ``repro.kernels.selective_scan``: ``h = exp(dt a) h + (dt x) b``,
``y_t = sum_s h c`` over the whole sequence with ``h`` carried on chip.

:func:`selective_scan` launches the CUDA kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.selective_scan` for CPU tensors, never
falling back from one to the other; ``selective_scan.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda, ref

_NAME = "selective_scan"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"selective_scan": [_P] * 8 + [_I] * 7 + [_P]}
D_STATES = (4, 8, 16)
_TYPES = (torch.float32, torch.bfloat16)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """S6 scan over ``L`` steps from state ``h0``.

    ``x, dt [batch, L, di]`` and ``b, c [batch, L, ds]`` (f32 or bf16; ``b``
    and ``c`` of one type), ``a [di, ds]`` and ``h0 [batch, di, ds]`` f32 ->
    ``(y [batch, L, di], h [batch, di, ds])``, both f32.  ``dt`` is
    post-softplus and ``a = -exp(A_log)``; ``y`` has no ``D x`` term.  On
    the card ``ds`` must be 4, 8 or 16; any ``L >= 1`` and ``di``."""
    if x.device.type == "cpu":
        return ref.selective_scan(x, dt, b, c, a, h0)
    cuda.require("selective_scan", x, dt, b, c, a, h0)
    if x.dim() != 3 or dt.shape != x.shape or b.dim() != 3 \
            or c.shape != b.shape or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"selective_scan: needs x, dt [batch, L, di] and b, "
                         f"c [batch, L, ds]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    batch, L, di = x.shape
    ds = b.shape[2]
    if ds not in D_STATES:
        raise ValueError(f"selective_scan: d_state {ds} not in {D_STATES}")
    if L < 1 or di < 1 or batch < 1:
        raise ValueError(f"selective_scan: empty input {tuple(x.shape)}")
    if tuple(a.shape) != (di, ds) or tuple(h0.shape) != (batch, di, ds):
        raise ValueError(f"selective_scan: needs a [di, ds] and h0 [batch, "
                         f"di, ds]; got {tuple(a.shape)}, "
                         f"{tuple(h0.shape)}")
    if x.dtype not in _TYPES or dt.dtype not in _TYPES \
            or b.dtype not in _TYPES or c.dtype != b.dtype \
            or a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError("selective_scan: dtype: x, dt, b, c f32 or bf16 (b "
                         "and c alike), a and h0 f32")
    y = torch.empty((batch, L, di), dtype=torch.float32, device=x.device)
    h = torch.empty((batch, di, ds), dtype=torch.float32, device=x.device)
    bf16 = [int(t.dtype == torch.bfloat16) for t in (x, dt, b)]
    lib = cuda.library(_NAME, _SIGNATURES)
    status = lib.selective_scan(x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                                c.data_ptr(), a.data_ptr(), h0.data_ptr(),
                                y.data_ptr(), h.data_ptr(), batch, L, di, ds,
                                *bf16, cuda.stream_handle(x.device))
    cuda.check(lib, _NAME, status, "selective_scan")
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
