"""RWKV-6 ("Finch") attention-free mixer with data-dependent decay: the
port of ``repro.models.rwkv``.

Recurrence (per head, state S in R^{hd x hd}, key dim x value dim):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(-exp(wraw_t))

with r/k/v/g/w produced from data-dependent token-shift interpolation
(the "ddlerp" of v6).  A prefill walks the sequence in chunks of
``cfg.ssm.chunk`` tokens, the reference's chunked linear-attention form:
within a chunk the pairwise decay products are a masked ``[L, L]``
interaction (every ratio at most 1, so nothing overflows), and the state
is carried from chunk to chunk.  The reference writes this in plain
``jnp`` (no Pallas kernel), so here it is stock torch ops in f32.  Decode
is the exact one-step recurrence, its state written in place as
:func:`repro_torch.models.mamba.decode_mamba` writes its own.

Parameters keep the reference's layout and dtypes: ``w0`` and ``u`` are
f32 whatever ``param_dtype`` is; ``mix_b``, ``w2`` and ``u`` are plain
normals (the others truncated at fan-in scale).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import layers
from .shards import split_dim, unsupported

_DECAY_LORA = 64
_MIX_LORA = 32
_MIX_KINDS = 5          # r, k, v, g, w


def _num_heads(cfg) -> int:
    return cfg.num_heads if cfg.num_heads > 0 \
        else cfg.d_model // cfg.ssm.head_dim


def rwkv_params(gen, cfg, dtype):
    d = cfg.d_model
    dev = gen.device
    return {
        # token-shift ddlerp: base mus + low-rank data-dependent correction
        "mu_base": torch.zeros((d,), dtype=dtype, device=dev),
        "mu": torch.zeros((_MIX_KINDS, d), dtype=dtype, device=dev),
        "mix_a": layers._dense_init(gen, (d, _MIX_KINDS * _MIX_LORA), dtype),
        "mix_b": layers.normal(gen, (_MIX_KINDS, _MIX_LORA, d), 0.01, dtype),
        # projections
        "r": layers.dense_params(gen, d, d, dtype),
        "k": layers.dense_params(gen, d, d, dtype),
        "v": layers.dense_params(gen, d, d, dtype),
        "g": layers.dense_params(gen, d, d, dtype),
        "o": layers.dense_params(gen, d, d, dtype),
        # data-dependent decay: w = exp(-exp(w0 + tanh(xw @ w1) @ w2))
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "w1": layers._dense_init(gen, (d, _DECAY_LORA), dtype),
        "w2": layers.normal(gen, (_DECAY_LORA, d), 0.01, dtype),
        # per-channel current-token bonus
        "u": layers.normal(gen, (d,), 0.1, torch.float32),
        # post-WKV group norm (per head)
        "ln_x": {"scale": torch.ones((d,), dtype=dtype, device=dev),
                 "bias": torch.zeros((d,), dtype=dtype, device=dev)},
    }


def channel_mix_params(gen, cfg, dtype):
    d, ff = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "mu_k": torch.zeros((d,), dtype=dtype, device=dev),
        "mu_r": torch.zeros((d,), dtype=dtype, device=dev),
        "k": layers.dense_params(gen, d, ff, dtype),
        "v": layers.dense_params(gen, ff, d, dtype),
        "r": layers.dense_params(gen, d, d, dtype),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Previous token per position; ``last`` [b, 1, d] carries state."""
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x, x_prev):
    """Data-dependent interpolation producing the 5 mixed inputs
    ``[b, s, 5, d]``."""
    dx = x_prev - x
    base = x + dx * p["mu_base"].to(x.dtype)
    lora = torch.tanh(base @ p["mix_a"].to(x.dtype))
    b, s, _ = x.shape
    lora = lora.reshape(b, s, _MIX_KINDS, _MIX_LORA)
    corr = torch.einsum("bskr,krd->bskd", lora, p["mix_b"].to(x.dtype))
    mix = p["mu"].to(x.dtype)[None, None] + corr
    return x[:, :, None] + dx[:, :, None] * mix


def _rkvgw(p, x, x_prev, cfg):
    mixed = _ddlerp(p, x, x_prev)
    xr, xk, xv, xg, xw = mixed.unbind(2)
    r = layers.dense(p["r"], xr)
    k = layers.dense(p["k"], xk)
    v = layers.dense(p["v"], xv)
    g = torch.nn.functional.silu(layers.dense(p["g"], xg))
    wraw = (p["w0"][None, None]
            + torch.tanh(xw @ p["w1"].to(x.dtype)).float()
            @ p["w2"].float())
    log_w = -torch.exp(wraw)                                # log decay < 0
    return r, k, v, g, log_w


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _group_norm(p, x, h, eps=1e-5):
    """Per-head layer norm over head_dim (RWKV's ln_x), in f32 with the
    population variance."""
    b, s, d = x.shape
    xh = x.reshape(b, s, h, d // h).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(b, s, d)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _min0(x):
    """``min(x, 0)`` with ``jnp.minimum``'s derivative: half the cotangent
    each way where ``x`` is 0 (the diagonal's empty decay products are 0
    or a rounding off it); ``clamp`` would pass all of it."""
    return torch.minimum(x, x.new_zeros(()))


def _chunk_wkv(r, k, v, log_w, u, s0):
    """One chunk of the WKV recurrence, parallel within the chunk.

    r/k/v: [b, L, h, hd]; log_w: [b, L, h, hd]; u: [h, hd];
    s0: [b, h, hd, hd] (key dim x value dim).  Returns (y [b, L, h, hd],
    s_final), all in f32.  The largest temporary is ``[b, L, L, h, hd]``.
    """
    r, k, v, log_w = (t.float() for t in (r, k, v, log_w))
    L = r.shape[1]
    cum = torch.cumsum(log_w, dim=1)                # inclusive [b,L,h,hd]
    ecum = cum - log_w                              # exclusive
    # inter-chunk: y_t += (r_t * prod_{s<t} w_s)^T S0
    q = r * torch.exp(ecum)
    y_inter = torch.einsum("blhk,bhkv->blhv", q, s0)
    # intra-chunk: A[t,s] = sum_d r_td k_sd exp(ecum_t - cum_s), s < t
    #              diag:   (r_t * u * k_t) . v_t
    diff = ecum[:, :, None] - cum[:, None, :]       # [b, t, s, h, hd]
    idx = torch.arange(L, device=r.device)
    mask = (idx[:, None] > idx[None, :]).to(diff.dtype)
    decay = torch.exp(_min0(diff)) * mask[None, :, :, None, None]
    A = (decay * k[:, None] * r[:, :, None]).sum(-1)       # [b, t, s, h]
    y_intra = torch.einsum("btsh,bshv->bthv", A, v)
    bonus = (r * u.float() * k).sum(-1)                    # [b, L, h]
    y = y_inter + y_intra + bonus[..., None] * v
    # state update: S_L = diag(P_L) S0 + sum_s diag(P_L/P_s) k_s v_s^T
    p_total = torch.exp(cum[:, -1])                 # [b, h, hd]
    k_scaled = k * torch.exp(_min0(cum[:, -1:] - cum))
    s_new = (p_total[..., None] * s0
             + torch.einsum("blhk,blhv->bhkv", k_scaled, v))
    return y, s_new


def apply_rwkv_time_mix(p, x, cfg, *, last_token=None, state=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training/prefill forward. x: [b, S, d] -> (y, final_state)."""
    b, S, d = x.shape
    h = _num_heads(cfg)
    hd = d // h
    if last_token is None:
        last_token = x.new_zeros((b, 1, d))
    x_prev = _token_shift(x, last_token)
    r, k, v, g, log_w = _rkvgw(p, x, x_prev, cfg)
    r, k, v, log_w = (_heads(t, h) for t in (r, k, v, log_w))
    u = p["u"].reshape(h, hd)

    L = min(cfg.ssm.chunk, S)
    if S % L != 0:
        raise ValueError(f"seq {S} not divisible by rwkv chunk {L}")
    s = (state["s"] if state is not None
         else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=x.device))
    ys = []
    for c in range(S // L):
        piece = slice(c * L, (c + 1) * L)
        y, s = _chunk_wkv(r[:, piece], k[:, piece], v[:, piece],
                          log_w[:, piece], u, s)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(b, S, d)
    y = _group_norm(p["ln_x"], y.to(x.dtype), h)
    y = y * g
    out = layers.dense(p["o"], y)
    return out, {"s": s, "last": x[:, -1:, :]}


def apply_channel_mix(p, x, *, last_token=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, S, d = x.shape
    if last_token is None:
        last_token = x.new_zeros((b, 1, d))
    x_prev = _token_shift(x, last_token)
    dx = x_prev - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(layers.dense(p["k"], xk)))
    out = torch.sigmoid(layers.dense(p["r"], xr)) \
        * layers.dense(p["v"], kk)
    return out, x[:, -1:, :]


# ---------------------------------------------------------------------------
# Decode (exact recurrence, O(1) per token).
# ---------------------------------------------------------------------------

def init_rwkv_state(cfg, batch: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h = _num_heads(cfg)
    hd = d // h
    return {
        "s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        "last_tm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "last_cm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
    }


def decode_rwkv_time_mix(p, x, cfg, state, shards=None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [b, 1, d] -> (y, state): the exact single-step recurrence,
    ``state["s"]`` and ``state["last_tm"]`` updated in place.  ``shards``
    (a :class:`~.shards.CacheShards` of the state): the state is this
    rank's block; the previous token is gathered, ``s`` steps on its value
    columns, whose ``y`` is gathered, and this rank's slice of the token
    is kept."""
    b, _, d = x.shape
    h = _num_heads(cfg)
    hd = d // h
    tm_dim = split_dim(shards, "last_tm")
    last = state["last_tm"]
    x_prev = (last if tm_dim is None else shards.gather(last, tm_dim)
              ).to(x.dtype)
    r, k, v, g, log_w = _rkvgw(p, x, x_prev, cfg)
    rh = r.reshape(b, h, hd).float()
    kh = k.reshape(b, h, hd).float()
    vh = v.reshape(b, h, hd).float()
    wh = torch.exp(log_w.reshape(b, h, hd))
    u = p["u"].reshape(h, hd).float()
    s = state["s"]
    s_dim = split_dim(shards, "s")
    if s_dim not in (None, 3):
        raise unsupported("the WKV state", s_dim)
    if s_dim == 3:
        vh = vh[..., shards.cols(hd)]
    kv = kh[..., :, None] * vh[..., None, :]              # [b,h,hd,hd]
    y = torch.einsum("bhk,bhkv->bhv", rh, s + u[None, :, :, None] * kv)
    s_new = wh[..., None] * s + kv
    if s_dim == 3:
        y = shards.gather(y, 2)
    y = y.reshape(b, 1, d)
    y = _group_norm(p["ln_x"], y.to(x.dtype), h) * g
    state["s"].copy_(s_new)
    last.copy_(x if tm_dim is None else shards.take(x, tm_dim))
    return layers.dense(p["o"], y), state


def decode_channel_mix(p, x, state_last, shards=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, 1, d] -> (y, new last token); the caller keeps it.
    ``shards`` (of ``{"last_cm"}``): ``state_last`` is this rank's slice,
    gathered whole first, and the new last token is returned sliced."""
    dim = split_dim(shards, "last_cm")
    if dim is None:
        return apply_channel_mix(p, x, last_token=state_last)
    out, last = apply_channel_mix(p, x, last_token=shards.gather(
        state_last, dim))
    return out, shards.take(last, dim)
