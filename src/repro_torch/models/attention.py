"""GQA attention with RoPE, causal / sliding-window / cross variants and
a KV cache that decode updates in place: the port of
``repro.models.attention``.

Shapes: activations ``[batch, seq, d_model]``; caches
``{"k","v": [batch, max_len, kv_heads, head_dim]}``.  Attention logits are
f32 products of the activations' values (the reference's
``preferred_element_type=f32``), and the probabilities are cast to
``v``'s dtype before the second product, as the reference does.  The
reference's mesh helpers are single-device no-ops here, so the chunked
path never fuses (batch, heads).  Cross-attention (Whisper's decoder
reading the encoder's memory) has no RoPE and sees every memory position.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import layers
from . import shards as shards_mod

NEG_INF = -1e30


def attn_params(gen, cfg, dtype):
    """Q, K, V and output projections (a decoder block's cross-attention
    takes the same layout)."""
    d, hd = cfg.d_model, cfg.head_dim
    q_dim = cfg.num_heads * hd
    kv_dim = cfg.num_kv_heads * hd
    return {
        "q": layers.dense_params(gen, d, q_dim, dtype, bias=cfg.qkv_bias),
        "k": layers.dense_params(gen, d, kv_dim, dtype, bias=cfg.qkv_bias),
        "v": layers.dense_params(gen, d, kv_dim, dtype, bias=cfg.qkv_bias),
        "o": layers.dense_params(gen, q_dim, d, dtype),
    }


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _repeat_kv(x, groups: int):
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=2)


def _sdpa(q, k, v, mask, head_dim):
    """q: [b,s,h,hd], k/v: [b,t,h,hd], mask: broadcastable [b,1,s,t]."""
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """[..., q, k] boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


# Sequences at least this long take the chunked (flash-style) path.
CHUNKED_THRESHOLD = 2048
Q_CHUNK = 1024
KV_CHUNK = 1024


def _pick_chunk(s: int, target: int = Q_CHUNK, floor: int = 128) -> int:
    """Largest power-of-two divisor of ``s`` in [floor, target]."""
    c = target
    while c >= floor:
        if s % c == 0:
            return c
        c //= 2
    return 0


def _flash_attention(q, k, v, q_pos, k_pos, window, head_dim,
                     q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK):
    """Blockwise attention with online softmax (memory O(qc*kc) per step).

    q: [b, s, h, hd]; k/v: [b, t, h, hd] (kv already head-repeated);
    q_pos: [b, s]; k_pos: [b, t].  Causal + optional sliding window.  Each
    q chunk visits only the kv chunks its mask can reach, as the
    reference's unrolled loop does.
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    if s % q_chunk != 0 or t % kv_chunk != 0:
        raise ValueError(f"seq {s}/{t} not divisible by chunks "
                         f"{q_chunk}/{kv_chunk}")
    nq, nk = s // q_chunk, t // kv_chunk
    scale = 1.0 / math.sqrt(head_dim)
    qs = q.reshape(b, nq, q_chunk, h, hd).permute(0, 3, 1, 2, 4)
    ks = k.reshape(b, nk, kv_chunk, h, hd).permute(0, 3, 1, 2, 4)
    vs = v.reshape(b, nk, kv_chunk, h, hd).permute(0, 3, 1, 2, 4)
    qp = q_pos.reshape(b, nq, q_chunk)
    kp = k_pos.reshape(b, nk, kv_chunk)

    def q_block(qi: int, kv_lo: int, kv_hi: int):
        qb = qs[:, :, qi].float()                       # [b, h, qc, hd]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for kj in range(kv_lo, kv_hi):
            vv = vs[:, :, kj]
            logits = torch.einsum("bhqd,bhkd->bhqk", qb,
                                  ks[:, :, kj].float()) * scale
            mask = causal_mask(qp[:, qi], kp[:, kj], window)[:, None]
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vv.dtype), vv).float()
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        return out.to(q.dtype)                          # [b, h, qc, hd]

    same_grid = s == t
    outs = []
    for qi in range(nq):
        if same_grid and q_chunk == kv_chunk:
            lo, hi = 0, qi + 1
            if window is not None:
                lo = max(0, (qi * q_chunk - window) // kv_chunk)
        else:
            lo, hi = 0, nk
        outs.append(q_block(qi, lo, hi))
    out = torch.stack(outs, dim=2)                      # [b, h, nq, qc, hd]
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def self_attention(p, x, cfg, *, positions: torch.Tensor,
                   causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    b, s, _ = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    q = _split_heads(layers.dense(p["q"], x), cfg.num_heads, cfg.head_dim)
    k = _split_heads(layers.dense(p["k"], x), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(layers.dense(p["v"], x), cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta is not None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    chunk = _pick_chunk(s)
    if causal and s >= CHUNKED_THRESHOLD and chunk:
        out = _flash_attention(q, k, v, positions, positions, window,
                               cfg.head_dim, q_chunk=chunk, kv_chunk=chunk)
    else:
        if causal:
            mask = causal_mask(positions, positions, window)[:, None]
        else:
            mask = torch.ones((b, 1, s, s), dtype=torch.bool,
                              device=x.device)
        out = _sdpa(q, k, v, mask, cfg.head_dim)
    return layers.dense(p["o"], out.reshape(b, s, -1))


def cross_attention(p, x, memory, cfg) -> torch.Tensor:
    """Decoder -> encoder attention: queries from ``x [b, s, d]``, keys and
    values from ``memory [b, t, d]``, no RoPE, every position visible."""
    b, s, _ = x.shape
    t = memory.shape[1]
    groups = cfg.num_heads // cfg.num_kv_heads
    q = _split_heads(layers.dense(p["q"], x), cfg.num_heads, cfg.head_dim)
    k = _split_heads(layers.dense(p["k"], memory), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(layers.dense(p["v"], memory), cfg.num_kv_heads,
                     cfg.head_dim)
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    mask = torch.ones((b, 1, s, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, cfg.head_dim)
    return layers.dense(p["o"], out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# KV-cache decode path.
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype,
               device) -> Dict[str, Any]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# Decode reads the cache in blocks of this many slots, so that a step's
# transient memory is the [batch, heads, max_len] scores and never a copy
# of the cache.
DECODE_BLOCK = 1024


def _decode_sdpa(q, ck, cv, mask, head_dim, shards=None, dim=None):
    """``_sdpa`` for one query position against the cache, without
    repeating the KV heads or upcasting the whole cache: q [b, 1, h, hd],
    ck/cv [b, t, kvh, hd], mask [t] bool -> [b, 1, h, hd] in ``cv``'s
    dtype.  Query head i reads KV head ``i // groups`` (``_repeat_kv``).

    On a mesh (``shards``, a :class:`~.shards.CacheShards`) ck and cv are
    this rank's block, split on ``dim``: 3 (head_dim; the partial logits
    ``[b, kvh, g, t]`` summed over the ranks, then the rank's columns of
    the output gathered) or 2 (KV heads; its heads' outputs gathered).
    The result is whole on every rank."""
    b, _, h, hd = q.shape
    t = ck.shape[1]
    kvh = ck.shape[2] * (shards.size if dim == 2 else 1)
    qg = q.reshape(b, kvh, h // kvh, hd)
    if dim is not None:
        if dim not in (2, 3):
            raise shards_mod.unsupported("a KV cache", dim)
        qg = shards.take(qg, 1 if dim == 2 else 3)
    qg = qg.float()
    logits = torch.empty(qg.shape[:3] + (t,), dtype=torch.float32,
                         device=q.device)
    blocks = [slice(lo, min(lo + DECODE_BLOCK, t))
              for lo in range(0, t, DECODE_BLOCK)]
    for blk in blocks:
        logits[..., blk] = torch.einsum("bkgd,btkd->bkgt", qg,
                                        ck[:, blk].float())
    if dim == 3:
        shards.sum(logits)
    logits.mul_(1.0 / math.sqrt(head_dim)).masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype)
    del logits
    out = torch.zeros(qg.shape[:3] + (cv.shape[3],), dtype=torch.float32,
                      device=q.device)
    for blk in blocks:
        out += torch.einsum("bkgt,btkd->bkgd", probs[..., blk].float(),
                            cv[:, blk].float())
    out = out.to(cv.dtype)
    if dim is not None:
        out = shards.gather(out, 1 if dim == 2 else 3)
    return out.reshape(b, 1, h, hd)


def decode_self_attention(p, x, cfg, cache, pos: int,
                          window: Optional[int] = None, shards=None
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode. x: [b, 1, d]; ``pos``: the current position.

    With a sliding window and ``max_len == window`` the cache is a ring of
    ``window`` slots (slot = pos % window, all slots valid once wrapped);
    otherwise it is linear in ``max_len``.  The new key and value are
    written into their slot of the given cache, which is returned: a step
    costs O(1) cache writes, where the reference builds a new cache.
    ``shards`` (a :class:`~.shards.CacheShards` of ``{"k", "v"}``): the
    cache is this rank's block; the new token's slice of k and v goes into
    it, and :func:`_decode_sdpa` meets the other ranks.
    """
    b = x.shape[0]
    q = _split_heads(layers.dense(p["q"], x), cfg.num_heads, cfg.head_dim)
    k = _split_heads(layers.dense(p["k"], x), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(layers.dense(p["v"], x), cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta is not None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    dim = shards_mod.split_dim(shards, "k")
    if dim is not None:
        k, v = shards.take(k, dim), shards.take(v, dim)
    max_len = ck.shape[1]
    ring = window is not None and max_len == window
    slot = pos % max_len if ring else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    k_pos = torch.arange(max_len, device=x.device)
    if ring:
        # Before the first wrap only slots <= pos are live; afterwards
        # every slot holds an in-window key.
        mask = (k_pos <= pos) | (pos >= max_len)
    else:
        mask = k_pos <= pos
        if window is not None:
            mask &= k_pos > pos - window
    out = _decode_sdpa(q, ck, cv, mask, cfg.head_dim, shards, dim)
    y = layers.dense(p["o"], out.reshape(b, 1, -1))
    return y, cache
