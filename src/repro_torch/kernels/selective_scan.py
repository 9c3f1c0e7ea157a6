"""Fused Mamba (S6) selective-scan kernel (``csrc/selective_scan.cu``), the
port of ``repro.kernels.selective_scan``: ``h = exp(dt a) h + (dt x) b``,
``y_t = sum_s h c`` over the whole sequence with ``h`` carried on chip;
and its backward (``csrc/selective_scan_bwd.cu``), which the reference
does not write as a kernel: it differentiates its chunked associative
scan.

:func:`selective_scan` launches the CUDA kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.selective_scan` for CPU tensors, never
falling back from one to the other.  Under autograd on the card it goes
through :class:`_Scan`, whose forward also keeps the state at each 8-step
window's start and whose backward is :func:`selective_scan_bwd`: the
backward kernel, never autograd through the plain loop.  On the CPU
autograd runs through the plain scan.  ``selective_scan.launches`` and
``selective_scan_bwd.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda, ref

_NAME = "selective_scan"
_BWD = "selective_scan_bwd"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"selective_scan": [_P] * 9 + [_I] * 7 + [_P]}
_BWD_SIGNATURES = {"selective_scan_bwd": [_P] * 15 + [_I] * 7 + [_P],
                   "selective_scan_bwd_channels": [_I]}
D_STATES = (4, 8, 16)
TILE = 8             # the backward's window: h is kept as each one starts
_TYPES = (torch.float32, torch.bfloat16)


def _check(what: str, x, dt, b, c, a, h0) -> None:
    cuda.require(what, x, dt, b, c, a, h0)
    if x.dim() != 3 or dt.shape != x.shape or b.dim() != 3 \
            or c.shape != b.shape or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"{what}: needs x, dt [batch, L, di] and b, c "
                         f"[batch, L, ds]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    batch, L, di = x.shape
    ds = b.shape[2]
    if ds not in D_STATES:
        raise ValueError(f"{what}: d_state {ds} not in {D_STATES}")
    if L < 1 or di < 1 or batch < 1:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    if tuple(a.shape) != (di, ds) or tuple(h0.shape[1:]) != (di, ds):
        raise ValueError(f"{what}: needs a [di, ds] and h0 [batch, di, ds]; "
                         f"got {tuple(a.shape)}, {tuple(h0.shape)}")
    if x.dtype not in _TYPES or dt.dtype not in _TYPES \
            or b.dtype not in _TYPES or c.dtype != b.dtype \
            or a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError(f"{what}: dtype: x, dt, b, c f32 or bf16 (b and c "
                         "alike), a and h0 f32")


def _bf16_flags(x, dt, b):
    return [int(t.dtype == torch.bfloat16) for t in (x, dt, b)]


def _forward(x, dt, b, c, a, h0, keep_tiles: bool):
    """One forward launch -> ``(y, h, h_tiles)``; ``h_tiles [batch,
    ceil(L / 8), di, ds]`` (the state each 8-step window starts from) only
    when ``keep_tiles``, else None."""
    _check("selective_scan", x, dt, b, c, a, h0)
    batch, L, di = x.shape
    ds = b.shape[2]
    if h0.shape[0] != batch:
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)} for batch "
                         f"{batch}")
    y = torch.empty((batch, L, di), dtype=torch.float32, device=x.device)
    h = torch.empty((batch, di, ds), dtype=torch.float32, device=x.device)
    tiles = torch.empty((batch, -(-L // TILE), di, ds), dtype=torch.float32,
                        device=x.device) if keep_tiles else None
    lib = cuda.library(_NAME, _SIGNATURES)
    status = lib.selective_scan(x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                                c.data_ptr(), a.data_ptr(), h0.data_ptr(),
                                y.data_ptr(), h.data_ptr(),
                                None if tiles is None else tiles.data_ptr(),
                                batch, L, di, ds, *_bf16_flags(x, dt, b),
                                cuda.stream_handle(x.device))
    cuda.check(lib, _NAME, status, "selective_scan")
    selective_scan.launches += 1
    return y, h, tiles


class _Scan(torch.autograd.Function):
    """The scan under autograd on the card: the forward kernel, keeping
    the window states, and the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, h0):
        y, h, tiles = _forward(x, dt, b, c, a, h0, keep_tiles=True)
        ctx.save_for_backward(x, dt, b, c, a, h0, tiles)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, b, c, a, h0, tiles = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return selective_scan_bwd(x, dt, b, c, a, h0, dy, dh, tiles)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """S6 scan over ``L`` steps from state ``h0``.

    ``x, dt [batch, L, di]`` and ``b, c [batch, L, ds]`` (f32 or bf16; ``b``
    and ``c`` of one type), ``a [di, ds]`` and ``h0 [batch, di, ds]`` f32 ->
    ``(y [batch, L, di], h [batch, di, ds])``, both f32.  ``dt`` is
    post-softplus and ``a = -exp(A_log)``; ``y`` has no ``D x`` term.  On
    the card ``ds`` must be 4, 8 or 16; any ``L >= 1`` and ``di``.
    Differentiable on both devices."""
    if x.device.type == "cpu":
        return ref.selective_scan(x, dt, b, c, a, h0)
    inputs = (x, dt, b, c, a, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Scan.apply(*inputs)
    y, h, _ = _forward(*inputs, keep_tiles=False)
    return y, h


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       dy: torch.Tensor, dh: Optional[torch.Tensor],
                       h_tiles: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The scan's vector-Jacobian product: given the forward's inputs, the
    state at each 8-step window's start that its launch kept (``h_tiles
    [batch, ceil(L / 8), di, ds]``) and the cotangents ``dy [batch, L,
    di]`` of ``y`` and ``dh [batch, di, ds]`` of the last state (None:
    zero), ``(dx, ddt, db, dc, da, dh0)``, each in its input's dtype.

    CPU tensors: autograd through the plain scan
    (:func:`repro_torch.kernels.ref.selective_scan_bwd`), which does not
    read ``h_tiles``.  CUDA tensors: the backward kernel.  No float
    atomics: two calls give the same bits."""
    if x.device.type == "cpu":
        return ref.selective_scan_bwd(x, dt, b, c, a, h0, dy, dh)
    _check("selective_scan_bwd", x, dt, b, c, a, h0)
    batch, L, di = x.shape
    ds = b.shape[2]
    dy = dy.float().contiguous()
    if dh is not None:
        dh = dh.float().contiguous()
    cuda.require("selective_scan_bwd", h_tiles, dy,
                 *(() if dh is None else (dh,)))
    if tuple(h_tiles.shape) != (batch, -(-L // TILE), di, ds) \
            or tuple(dy.shape) != (batch, L, di) \
            or (dh is not None and tuple(dh.shape) != (batch, di, ds)):
        raise ValueError(f"selective_scan_bwd: needs h_tiles [batch, "
                         f"ceil(L / {TILE}), di, ds], dy [batch, L, di] and "
                         f"dh [batch, di, ds]; got {tuple(h_tiles.shape)}, "
                         f"{tuple(dy.shape)}, "
                         f"{None if dh is None else tuple(dh.shape)}")
    lib = cuda.library(_BWD, _BWD_SIGNATURES)
    chan_tiles = -(-di // lib.selective_scan_bwd_channels(ds))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((batch, L, di), dtype=x.dtype, device=x.device)
    ddt = torch.empty((batch, L, di), dtype=dt.dtype, device=x.device)
    dbc = torch.empty((2, batch, L, ds), **f32)
    da = torch.empty((di, ds), **f32)
    dh0 = torch.empty((batch, di, ds), **f32)
    dbc_part = torch.empty((2, batch, chan_tiles, L, ds), **f32)
    da_part = torch.empty((batch, di, ds), **f32)
    status = lib.selective_scan_bwd(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), h_tiles.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dbc.data_ptr(), da.data_ptr(), dh0.data_ptr(),
        dbc_part.data_ptr(), da_part.data_ptr(), batch, L, di, ds,
        *_bf16_flags(x, dt, b), cuda.stream_handle(x.device))
    cuda.check(lib, _BWD, status, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return dx, ddt, dbc[0].to(b.dtype), dbc[1].to(c.dtype), da, dh0


selective_scan.launches = 0
selective_scan_bwd.launches = 0
