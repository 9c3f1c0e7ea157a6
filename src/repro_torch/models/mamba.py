"""Mamba (S6) selective state-space mixer, the SSM half of Jamba: the port
of ``repro.models.mamba``.

The reference walks a prefill in 64-token chunks, with
``lax.associative_scan`` inside a chunk and ``lax.scan`` carrying ``h``
across chunks.  Here :func:`apply_mamba` launches the hand-written
selective-scan kernel (:func:`repro_torch.kernels.selective_scan`) once
per layer over the whole sequence, carrying ``h`` inside the kernel; it
computes the same ``y`` (without the ``D x`` skip, added here) and, for
CPU tensors, runs the kernel's plain version.  Under autograd the scan's
gradient on the card is the backward kernel (``csrc/selective_scan_bwd.cu``)
and on the CPU autograd through the plain scan, where the reference
differentiates its associative scan.  Decode is the exact one-step
recurrence on the carried state, as in the reference.

State carried between tokens:
  ``h``    [batch, d_inner, d_state]  SSM hidden state (f32)
  ``conv`` [batch, d_conv-1, d_inner] causal-conv tail
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..kernels import selective_scan
from . import layers
from .shards import split_dim, unsupported


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` (torch's ``softplus``
    returns ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba_params(gen, cfg, dtype):
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    dtr = _dt_rank(cfg)
    dev = gen.device
    # S4D-real initialisation for A; dt bias so softplus(dt) spans
    # [dt_min, dt_max] as in the reference implementation.
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    u = layers.drawn(gen, (di,), torch.float32, lambda: torch.rand(
        (di,), generator=gen, dtype=torch.float32, device=dev))
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    inv_softplus = dt + torch.log(-torch.expm1(-dt))
    in_proj = layers.dense_params(gen, d, 2 * di, dtype)
    conv_w = layers.drawn(gen, (s.d_conv, di), dtype, lambda: torch.randn(
        (s.d_conv, di), generator=gen, dtype=torch.float32,
        device=dev) / math.sqrt(s.d_conv))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": layers.dense_params(gen, di, dtr + 2 * s.d_state, dtype),
        "dt_proj": {"w": layers._dense_init(gen, (dtr, di), dtype),
                    "b": inv_softplus.to(dtype)},
        "A_log": torch.log(a),                     # f32: numerics-critical
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": layers.dense_params(gen, di, d, dtype),
    }


def _causal_conv(p, x, tail):
    """Depthwise causal conv1d. x: [b, L, di]; tail: [b, d_conv-1, di]."""
    dc = p["conv_w"].shape[0]
    xt = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xt[:, i:i + x.shape[1], :] * p["conv_w"][i].to(x.dtype)
              for i in range(dc))
    new_tail = xt[:, -(dc - 1):, :] if dc > 1 else tail
    return out + p["conv_b"].to(x.dtype), new_tail


def _scan_inputs(p, x, cfg):
    """x: [b, L, di] -> (dt [b,L,di] f32 post-softplus, B, C [b,L,ds] in
    x's dtype, A = -exp(A_log) [di, ds] f32)."""
    s = cfg.ssm
    dtr = _dt_rank(cfg)
    proj = layers.dense(p["x_proj"], x)
    dt, B, C = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = _softplus(layers.dense(p["dt_proj"], dt).float())
    return dt, B, C, -torch.exp(p["A_log"])


def _ssm_inputs(p, x, cfg):
    """x: [b, L, di] -> (dA [b,L,di,ds], dBx [b,L,di,ds], C [b,L,ds])."""
    dt, B, C, A = _scan_inputs(p, x, cfg)
    dA = torch.exp(dt[..., None] * A[None, None])
    dBx = (dt * x.float())[..., None] * B[..., None, :].float()
    return dA, dBx, C.float()


def apply_mamba(p, x, cfg) -> torch.Tensor:
    """Training/prefill forward. x: [b, S, d_model] -> [b, S, d_model].

    One selective-scan launch per layer over the whole sequence; the
    [b, S, d_inner, d_state] discretised tensors are never built.
    """
    s = cfg.ssm
    b, S, _ = x.shape
    di = s.expand * cfg.d_model
    xz = layers.dense(p["in_proj"], x)
    xr, z = torch.chunk(xz, 2, dim=-1)
    tail0 = torch.zeros((b, s.d_conv - 1, di), dtype=x.dtype,
                        device=x.device)
    xr, _ = _causal_conv(p, xr, tail0)
    xr = torch.nn.functional.silu(xr)

    L = min(s.chunk, S)
    if S % L != 0:          # the reference's chunking accepts no other S
        raise ValueError(f"seq {S} not divisible by ssm chunk {L}")
    dt, B, C, A = _scan_inputs(p, xr, cfg)
    h0 = torch.zeros((b, di, s.d_state), dtype=torch.float32,
                     device=x.device)
    y, _ = selective_scan(xr.contiguous(), dt.contiguous(), B.contiguous(),
                          C.contiguous(), A.contiguous(), h0)
    y = y + p["D"][None, None] * xr.float()
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    return layers.dense(p["out_proj"], y)


# ---------------------------------------------------------------------------
# Decode (O(1) per token).
# ---------------------------------------------------------------------------

def init_mamba_state(cfg, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {"h": torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=dtype,
                                device=device)}


def decode_mamba(p, x, cfg, state, shards=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [b, 1, d_model] -> (y [b,1,d_model], state), the state updated
    in place.  ``shards`` (a :class:`~.shards.CacheShards` of ``{"h",
    "conv"}``): the state is this rank's block; the conv runs on this
    rank's channels and its output ``[b, 1, d_inner]`` is gathered, and
    ``h`` steps on its d_state columns, ``y``'s partial sums added over
    the ranks."""
    xz = layers.dense(p["in_proj"], x)
    xr, z = torch.chunk(xz, 2, dim=-1)
    conv_dim = split_dim(shards, "conv")
    if conv_dim is None:
        xr, new_tail = _causal_conv(p, xr, state["conv"])
    elif conv_dim == 2:
        cols = shards.cols(xr.shape[-1])
        xr, new_tail = _causal_conv(
            {"conv_w": p["conv_w"][:, cols], "conv_b": p["conv_b"][cols]},
            xr[..., cols], state["conv"])
        xr = shards.gather(xr, 2)
    else:
        raise unsupported("Mamba's conv state", conv_dim)
    xr = torch.nn.functional.silu(xr)
    dA, dBx, C = _ssm_inputs(p, xr, cfg)
    h_dim = split_dim(shards, "h")
    if h_dim is None:
        h = state["h"] * dA[:, 0] + dBx[:, 0]
        y = torch.einsum("bds,bs->bd", h, C[:, 0])[:, None]
    elif h_dim == 2:
        cols = shards.cols(dA.shape[-1])
        h = state["h"] * dA[:, 0, :, cols] + dBx[:, 0, :, cols]
        y = shards.sum(torch.einsum("bds,bs->bd", h,
                                    C[:, 0, cols]).contiguous())[:, None]
    else:
        raise unsupported("Mamba's h", h_dim)
    y = y + p["D"][None, None] * xr.float()
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    state["h"].copy_(h)
    state["conv"].copy_(new_tail)
    return layers.dense(p["out_proj"], y), state
