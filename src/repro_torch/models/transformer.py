"""Architecture-agnostic transformer stack: the port of
``repro.models.transformer``.

A model is ``prefix blocks + (pattern blocks x num_periods) + head``, with
the reference's parameter layout::

  {"embed": ...,
   "frontend_proj": ...,             # stub modality projector (audio/vlm)
   "pos_embed": ...,                 # learned positions (rope_theta=None)
   "prefix": (block, ...),           # non-repeating leading blocks
   "body": (block_stacked, ...),     # one entry per pattern position,
                                     # each leaf stacked [num_periods, ...]
   "encoder": {"blocks": (block, ...), "pos": ..., "final_norm": ...},
                                     # Whisper only
   "final_norm": ..., "lm_head": ...}

so weights carried over from the reference are a copy.  The reference's
``lax.scan`` over periods is a loop here that indexes the stacked leaves
(with ``cfg.remat``, a non-reentrant ``torch.utils.checkpoint`` around
each period under autograd, as the reference's ``jax.checkpoint``).
Caches mirror the layout, and decode updates them in place.  Every
architecture of the reference's zoo runs: attention, Mamba and RWKV-6
mixers, dense and MoE MLPs (the RWKV mixer with its channel-mix MLP),
Whisper's encoder, cross-attention and learned positions, and the stub
frontends (``frames``, 1,500 precomputed audio frame embeddings for
Whisper's encoder; ``patch_embeds``, precomputed 1024-wide patch
embeddings a VLM projects and prepends to the text).  ``forward``'s second
output sums the MoE layers' aux terms.

As in the reference, decode's cross-attention reads ``cross_k`` and
``cross_v`` caches that :func:`init_cache` makes zeros and nothing fills:
a decode step attends over zeros, adds nothing, and never sees the
encoder.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import BlockSpec
from ..tree import tree_map
from . import attention, layers, mamba, moe, rwkv
from .shards import split_dim, sub

# Whisper's encoder blocks: attention with a dense MLP.
_ENCODER_SPEC = BlockSpec(mixer="attn", moe=False)
# Width of a stub vision frontend's patch embeddings (the audio stub's
# frames are d_model wide).
VISION_DIM = 1024


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _index(tree, i: int):
    """Period ``i`` of a period-stacked tree."""
    return tree_map(lambda leaf: leaf[i], tree)


# ---------------------------------------------------------------------------
# Single block.
# ---------------------------------------------------------------------------

def block_params(gen, cfg, spec, dtype, cross: bool = False):
    """One block's parameters; ``cross`` adds a decoder block's
    cross-attention (``cross``) and its norm (``norm_cross``)."""
    dev = gen.device
    p: Dict[str, Any] = {
        "norm1": layers.norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
        "norm2": layers.norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
    }
    if spec.mixer == "attn":
        p["mixer"] = attention.attn_params(gen, cfg, dtype)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba.mamba_params(gen, cfg, dtype)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv.rwkv_params(gen, cfg, dtype)
    else:
        raise ValueError(spec.mixer)
    if spec.mixer == "rwkv":
        p["mlp"] = rwkv.channel_mix_params(gen, cfg, dtype)
    elif spec.moe:
        p["mlp"] = moe.moe_params(gen, cfg, dtype)
    else:
        p["mlp"] = layers.mlp_params(gen, cfg.d_model, cfg.d_ff,
                                     cfg.mlp_type, dtype)
    if cross:
        p["cross"] = attention.attn_params(gen, cfg, dtype)
        p["norm_cross"] = layers.norm_params(cfg.d_model, cfg.norm_type,
                                             dtype, dev)
    return p


def apply_block(p, x, cfg, spec, *, positions, causal=True, window=None,
                memory=None, rows=None):
    """Training/prefill forward through one block: the mixer, then (a
    decoder block given the encoder's ``memory``) cross-attention, then
    the MLP (a MoE MLP routing across ``rows``, a
    :class:`~.shards.RowShards`, where given). Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_type)
    if spec.mixer == "attn":
        mixed = attention.self_attention(p["mixer"], h, cfg,
                                         positions=positions,
                                         causal=causal, window=window)
    elif spec.mixer == "mamba":
        mixed = mamba.apply_mamba(p["mixer"], h, cfg)
    else:
        mixed, _ = rwkv.apply_rwkv_time_mix(p["mixer"], h, cfg)
    x = x + mixed
    if "cross" in p and memory is not None:
        hx = layers.apply_norm(p["norm_cross"], x, cfg.norm_type)
        x = x + attention.cross_attention(p["cross"], hx, memory, cfg)
    h2 = layers.apply_norm(p["norm2"], x, cfg.norm_type)
    if spec.mixer == "rwkv":
        out, _ = rwkv.apply_channel_mix(p["mlp"], h2)
    elif spec.moe:
        out, aux = moe.apply_moe(p["mlp"], h2, cfg, rows)
    else:
        out = layers.apply_mlp(p["mlp"], h2, cfg.mlp_type)
    return x + out, aux


# ---------------------------------------------------------------------------
# Block decode (one token, the cache updated in place).
# ---------------------------------------------------------------------------

def init_block_cache(cfg, spec, batch: int, max_len: int, dtype, device,
                     cross_len: int = 0):
    """One block's decode state; ``cross_len`` adds the cross-attention's
    ``cross_k`` and ``cross_v`` ``[batch, cross_len, kv_heads, head_dim]``,
    zeros, as the reference makes them."""
    if spec.mixer == "attn":
        c = {"attn": attention.init_cache(cfg, batch, max_len, dtype,
                                          device)}
    elif spec.mixer == "mamba":
        c = {"ssm": mamba.init_mamba_state(cfg, batch, dtype, device)}
    else:
        c = {"wkv": rwkv.init_rwkv_state(cfg, batch, dtype, device)}
    if cross_len:
        shape = (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def _decode_cross(p, x, cfg, cache, shards=None):
    """Cross-attention of one token against the cached ``cross_k`` and
    ``cross_v``, every slot visible (on a mesh, this rank's blocks of
    them: ``shards``)."""
    b = x.shape[0]
    q = layers.dense(p["q"], x).reshape(b, 1, cfg.num_heads, cfg.head_dim)
    ck, cv = cache["cross_k"], cache["cross_v"]
    visible = torch.ones(ck.shape[1], dtype=torch.bool, device=x.device)
    out = attention._decode_sdpa(q, ck, cv, visible, cfg.head_dim, shards,
                                 split_dim(shards, "cross_k"))
    return layers.dense(p["o"], out.reshape(b, 1, -1))


def decode_block(p, x, cfg, spec, cache, pos, *, window=None, shards=None,
                 rows=None):
    """One-token decode through one block. Returns (x, cache), the cache
    updated in place.  ``shards`` (a :class:`~.shards.CacheShards` of the
    block's cache): on a mesh, the cache is this rank's blocks; ``rows``
    (a :class:`~.shards.RowShards`): a MoE MLP routes across them."""
    h = layers.apply_norm(p["norm1"], x, cfg.norm_type)
    if spec.mixer == "attn":
        mixed, _ = attention.decode_self_attention(
            p["mixer"], h, cfg, cache["attn"], pos, window=window,
            shards=sub(shards, "attn"))
    elif spec.mixer == "mamba":
        mixed, _ = mamba.decode_mamba(p["mixer"], h, cfg, cache["ssm"],
                                      shards=sub(shards, "ssm"))
    else:
        mixed, _ = rwkv.decode_rwkv_time_mix(p["mixer"], h, cfg,
                                             cache["wkv"],
                                             shards=sub(shards, "wkv"))
    x = x + mixed
    if "cross" in p:
        hx = layers.apply_norm(p["norm_cross"], x, cfg.norm_type)
        x = x + _decode_cross(p["cross"], hx, cfg, cache, shards)
    h2 = layers.apply_norm(p["norm2"], x, cfg.norm_type)
    if spec.mixer == "rwkv":
        out, last = rwkv.decode_channel_mix(p["mlp"], h2,
                                            cache["wkv"]["last_cm"],
                                            shards=sub(shards, "wkv"))
        cache["wkv"]["last_cm"].copy_(last)
    elif spec.moe:
        out, _ = moe.apply_moe(p["mlp"], h2, cfg, rows)
    else:
        out = layers.apply_mlp(p["mlp"], h2, cfg.mlp_type)
    return x + out, cache


# ---------------------------------------------------------------------------
# Full stack.
# ---------------------------------------------------------------------------

def init_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters in the reference's layout, drawn on ``device``
    (the card unless the caller asks for the CPU) from a
    ``torch.Generator`` seeded with ``seed``; each leaf is drawn in f32
    and cast there, so a full-width model is never built on the host.  On
    ``device="meta"`` it draws nothing and allocates nothing: the leaves
    are meta tensors of the model's shapes and dtypes."""
    dev = resolve_device(device)
    gen = layers.generator(dev, seed)
    dtype = _dtype(cfg.param_dtype)
    p: Dict[str, Any] = {
        "embed": layers.embed_params(gen, cfg.vocab_size, cfg.d_model,
                                     dtype),
        "final_norm": layers.norm_params(cfg.d_model, cfg.norm_type, dtype,
                                         dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_params(gen, cfg.d_model, cfg.vocab_size,
                                           dtype)
    if cfg.learned_pos:
        p["pos_embed"] = layers.normal(
            gen, (cfg.max_position_embed(), cfg.d_model), 0.02, dtype)
    if cfg.frontend is not None:
        d_in = cfg.d_model if cfg.frontend == "audio" else VISION_DIM
        p["frontend_proj"] = layers.dense_params(gen, d_in, cfg.d_model,
                                                 dtype, bias=True)
    cross = cfg.encoder is not None
    if cfg.prefix:
        p["prefix"] = tuple(block_params(gen, cfg, s, dtype, cross=cross)
                            for s in cfg.prefix)
    p["body"] = tuple(layers.stacked(
        lambda spec=spec: block_params(gen, cfg, spec, dtype, cross=cross),
        cfg.num_periods) for spec in cfg.pattern)
    if cfg.encoder is not None:
        p["encoder"] = {
            "blocks": tuple(block_params(gen, cfg, _ENCODER_SPEC, dtype)
                            for _ in range(cfg.encoder.num_layers)),
            "pos": layers.normal(gen, (cfg.encoder.seq_len, cfg.d_model),
                                 0.02, dtype),
            "final_norm": layers.norm_params(cfg.d_model, cfg.norm_type,
                                             dtype, dev),
        }
    return p


def _encode(p, frames, cfg):
    """Whisper's encoder over stub frame embeddings ``[b, T, d]`` (already
    in the compute dtype): the projector, learned positions, non-causal
    blocks, the final norm."""
    if "frontend_proj" in p:
        frames = layers.dense(p["frontend_proj"], frames)
    x = frames + p["encoder"]["pos"][None, :frames.shape[1]].to(frames.dtype)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)
    for blk in p["encoder"]["blocks"]:
        x, _ = apply_block(blk, x, cfg, _ENCODER_SPEC, positions=positions,
                           causal=False)
    return layers.apply_norm(p["encoder"]["final_norm"], x, cfg.norm_type)


def _embed_inputs(p, batch, cfg):
    """Token embedding, with a VLM's projected ``patch_embeds`` prepended
    (projected in their own dtype, then cast to the embedding's, as the
    reference does) and learned positions added. Returns (x, positions)."""
    x = layers.embed(p["embed"], batch["tokens"])
    if cfg.frontend is not None and cfg.encoder is None \
            and "patch_embeds" in batch:
        patches = layers.dense(p["frontend_proj"], batch["patch_embeds"])
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.learned_pos:
        x = x + p["pos_embed"][None, :s].to(x.dtype)
    return x, positions


def forward(p, batch, cfg, *, window="cfg", last_only: bool = False,
            rows=None):
    """Full forward -> (logits [b, S, vocab] f32, aux_loss scalar).

    ``batch``: ``tokens [b, s]``; for an encoder-decoder ``frames [b, T,
    d]``, cast to the compute dtype before the encoder; for a VLM,
    optionally ``patch_embeds [b, P, 1024]``, whose P positions come
    before the text's, so the logits have P + s positions.  ``window``:
    attention window; the sentinel "cfg" uses ``cfg.sliding_window`` (None
    = full attention).  ``last_only``: logits for the final position only
    (the serving prefill).  ``rows`` (a :class:`~.shards.RowShards`): on a
    mesh, ``batch`` is this rank's rows of a node's batch, which the MoE
    layers route whole.
    """
    if window == "cfg":
        window = cfg.sliding_window
    cdtype = _dtype(cfg.compute_dtype)
    memory = None
    if cfg.encoder is not None:
        memory = _encode(p, batch["frames"].to(cdtype), cfg)
    x, positions = _embed_inputs(p, batch, cfg)
    x = x.to(cdtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk, spec in zip(p.get("prefix", ()), cfg.prefix):
        x, a = apply_block(blk, x, cfg, spec, positions=positions,
                           window=window, memory=memory, rows=rows)
        aux = aux + a

    def period_fn(x, period_params, memory):
        a_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk, spec in zip(period_params, cfg.pattern):
            x, a = apply_block(blk, x, cfg, spec, positions=positions,
                               window=window, memory=memory, rows=rows)
            a_sum = a_sum + a
        return x, a_sum

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_periods):
        period = tuple(_index(blk, i) for blk in p["body"])
        if remat:
            # jax.checkpoint around the period, as the reference does:
            # only the period's input is kept, its activations recomputed
            # in the backward; the numbers do not change.
            x, a = checkpoint(period_fn, x, period, memory,
                              use_reentrant=False)
        else:
            x, a = period_fn(x, period, memory)
        aux = aux + a
    if last_only:
        x = x[:, -1:]
    x = layers.apply_norm(p["final_norm"], x, cfg.norm_type)
    return _lm_logits(p, x, cfg), aux


class _F32Product(torch.autograd.Function):
    """``x @ w`` of two bf16 matrices with an f32 result, as one cuBLAS
    product (``out_dtype``), which has no derivative of its own.  The
    backward is the reference's: each cotangent product takes the f32
    cotangent against the other operand upcast (exact), sums in f32 and
    rounds once to the operand's dtype — two plain products; the reference
    computes this product outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w.float().T).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        gw = (x.float().T @ g).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return gx, gw


def _lm_logits(p, x, cfg):
    """Logits in f32 from the compute dtype's values, as the reference's
    bf16 product with f32 output; a bf16 ``matmul`` would round them to
    bf16.  On the card that is one cuBLAS product with an f32 output
    (:class:`_F32Product`) that reads the head as it lies.  The CPU has no
    such product, so there both operands are upcast: products of bf16
    values are exact in f32, so the two differ only in summation order."""
    cdtype = _dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = p["embed"]["table"].T.to(cdtype)
    else:
        w = p["lm_head"]["w"].to(cdtype)
    x2 = x.to(cdtype).reshape(-1, x.shape[-1])
    if x2.is_cuda and cdtype != torch.float32:
        out = _F32Product.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], out.shape[-1])


# ---------------------------------------------------------------------------
# Decode path.
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=None, device="cuda"):
    """Decode cache on ``device`` (the card unless the caller asks for the
    CPU): ``{"prefix": (...), "body": (...)}`` with body leaves stacked
    ``[num_periods, ...]``; an encoder-decoder's blocks also hold the
    cross-attention's zero ``cross_k`` and ``cross_v`` over the encoder's
    ``seq_len`` slots."""
    dev = resolve_device(device)
    dtype = _dtype(dtype or cfg.param_dtype)
    cross_len = cfg.encoder.seq_len if cfg.encoder is not None else 0
    prefix = tuple(init_block_cache(cfg, s, batch, max_len, dtype, dev,
                                    cross_len)
                   for s in cfg.prefix)
    body = tuple(layers.stacked(
        lambda spec=spec: init_block_cache(cfg, spec, batch, max_len, dtype,
                                           dev, cross_len),
        cfg.num_periods) for spec in cfg.pattern)
    return {"prefix": prefix, "body": body}


def decode_step(p, cache, tokens, pos: int, cfg, *, window="cfg",
                shards=None, rows=None):
    """One-token decode. tokens: [b, 1] int; pos: the position.

    Returns (logits [b, 1, vocab] f32, cache): every block writes its new
    state into ``cache`` in place (a period's blocks into their index of
    the stacked leaves), so a step copies no cache.  Learned positions
    take row ``pos`` clamped into the table, as the reference's
    ``dynamic_slice_in_dim`` clamps it (Whisper's 448 rows: a position
    past 447 reads row 447).  ``shards`` (a :class:`~.shards.CacheShards`
    whose ``dims`` mirror ``cache``, a body block's dims without the
    period axis): on a mesh, ``cache`` holds this rank's blocks and
    ``tokens`` its batch rows (the device mesh's serve step,
    ``repro_torch.dlrt.mesh_serve``); ``rows`` (a
    :class:`~.shards.RowShards`): the ranks holding the node's other rows,
    which the MoE layers route with this rank's.
    """
    if window == "cfg":
        window = cfg.sliding_window
    x = layers.embed(p["embed"], tokens).to(_dtype(cfg.compute_dtype))
    if cfg.learned_pos:
        table = p["pos_embed"]
        row = min(max(int(pos), 0), table.shape[0] - 1)
        x = x + table[row][None, None].to(x.dtype)
    for j, (blk, spec, c) in enumerate(zip(p.get("prefix", ()), cfg.prefix,
                                           cache["prefix"])):
        x, _ = decode_block(blk, x, cfg, spec, c, pos, window=window,
                            shards=sub(shards, "prefix", j), rows=rows)
    for i in range(cfg.num_periods):
        for j, (blk, spec, c) in enumerate(zip(p["body"], cfg.pattern,
                                               cache["body"])):
            x, _ = decode_block(_index(blk, i), x, cfg, spec, _index(c, i),
                                pos, window=window,
                                shards=sub(shards, "body", j), rows=rows)
    x = layers.apply_norm(p["final_norm"], x, cfg.norm_type)
    return _lm_logits(p, x, cfg), cache
