"""Mixture-of-Experts MLP with sort-based token dispatch: the port of
``repro.models.moe``.

Each (token, slot) pair the router picks is ranked within its expert in
flat order (token-major, slot-minor); pairs ranked at or past the expert's
capacity ``C`` are dropped, their gate mass lost (Switch's rule, no second
renormalisation).  The kept pairs are packed into an ``[E, C, d]`` buffer,
every expert's MLP runs as one batched product over the expert axis, and
each token's output is its gated slots added in slot order.  DeepSeek-MoE's
always-on shared experts are one dense MLP of ``num_shared * d_ff_expert``;
the load-balance aux term is Switch/GShard's ``E * sum(frac_tokens *
frac_probs) * aux_loss_weight``, which counts every top-k pick, dropped or
not.

The reference computes the expert products as plain einsums outside any
Pallas kernel; here they are batched products (``torch.bmm``).  Choices
that keep the reference's numbers:

* the top-k breaks ties to the lower expert, as ``lax.top_k`` does
  (:func:`repro_torch.core.selection.stable_topk`; in bf16 equal router
  probabilities are common);
* a pair's rank is a stable sort's position within its expert, which is
  the reference's cumulative count;
* the combine adds a token's K gated slots in slot order, each add rounded
  in the activation dtype, as the reference's scatter-add takes them;
  ``index_add_`` on the card adds by atomics in no fixed order.

The capacity comes from the call's own token count ``T``, so a decode step
(``T`` = batch) has its own, often 1: colliding pairs are dropped there as
in the reference.  Router jitter is never drawn: the reference's forward
and decode pass no key.

Rows on other ranks.  On a device mesh a node's batch may be split over
ranks (``node_fsdp``: over ``data``), while the reference, partitioned by
GSPMD, still routes the node's whole batch.  Given ``rows`` (a
:class:`~.shards.RowShards`), a call gathers the hidden rows of its group
(an all-gather whose gradient sums each rank's rows back to it), routes
the whole batch, or each whole ``piece`` of it, with that batch's
capacity, drops and aux term, and keeps this rank's rows.  Without it
nothing changes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import collectives
from ..core.selection import stable_topk
from . import layers
from .shards import RowShards


def _expert_bank(gen, E: int, d_in: int, d_out: int, dtype):
    """``E`` experts' ``[d_in, d_out]`` weights, each drawn on its own at
    fan-in ``d_in`` (one ``[E, d_in, d_out]`` draw would take ``E`` as
    its fan-in)."""
    def draw():
        bank = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
        for e in range(E):
            bank[e] = layers._dense_init(gen, (d_in, d_out), dtype)
        return bank
    return layers.drawn(gen, (E, d_in, d_out), dtype, draw)


def moe_params(gen, cfg, dtype):
    m = cfg.moe
    d = cfg.d_model
    ff = m.d_ff_expert or cfg.d_ff
    E = m.num_experts
    p = {"router": layers.dense_params(gen, d, E, dtype)}
    if cfg.mlp_type == "swiglu":
        p["gate"] = _expert_bank(gen, E, d, ff, dtype)
    p["up"] = _expert_bank(gen, E, d, ff, dtype)
    p["down"] = _expert_bank(gen, E, ff, d, dtype)
    if m.num_shared > 0:
        p["shared"] = layers.mlp_params(gen, d, m.num_shared * ff,
                                        cfg.mlp_type, dtype)
    return p


def capacity(cfg, T: int) -> int:
    """Slots an expert takes for a call of ``T`` tokens, in the
    reference's float order."""
    m = cfg.moe
    C = max(1, math.ceil(T * m.top_k / m.num_experts * m.capacity_factor))
    return min(C, T)


def _route(p, xf, cfg):
    """``xf [T, d]`` -> (probs [T, E] f32, gates [T, K] f32 renormalised,
    experts [T, K])."""
    logits = layers.dense(p["router"], xf).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = stable_topk(probs, cfg.moe.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def _counts(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Pairs picked per expert ``[E]`` int64 (``bincount`` would read its
    input's largest value back to the host)."""
    flat = experts.reshape(-1)
    return flat.new_zeros((E,)).scatter_add_(0, flat, torch.ones_like(flat))


def _ranks(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, slot) pair's rank among the pairs of its expert, in
    flat order: ``[T, K]`` int64."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = _counts(experts, E)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(flat.numel(), device=flat.device) \
        - starts[flat[order]]
    ranks = torch.empty_like(flat)
    ranks[order] = rank_sorted
    return ranks.reshape(experts.shape)


def _dispatch(xf, experts, C: int, E: int):
    """Pack the kept pairs into ``[E, C, d]``.  Returns (buffer, slot
    [T, K]: each pair's row of the flat buffer, ``E C`` where it was
    dropped, keep [T, K])."""
    T, K = experts.shape
    ranks = _ranks(experts, E)
    keep = ranks < C
    slot = torch.where(keep, experts * C + ranks, E * C)
    # Dropped pairs all land on the extra row, which is cut off.
    buf = xf.new_zeros((E * C + 1, xf.shape[1]))
    buf[slot.reshape(-1)] = xf.repeat_interleave(K, dim=0)
    return buf[:-1].reshape(E, C, -1), slot, keep


def _expert_ffn(p, xs, mlp_type: str):
    """xs: [E, C, d]; every expert's MLP as one batched product over the
    expert axis."""
    w = lambda name: p[name].to(xs.dtype)
    if mlp_type == "swiglu":
        h = torch.nn.functional.silu(torch.bmm(xs, w("gate"))) \
            * torch.bmm(xs, w("up"))
    elif mlp_type == "gelu":
        h = torch.nn.functional.gelu(torch.bmm(xs, w("up")),
                                     approximate="tanh")
    elif mlp_type == "sqrelu":
        h = torch.square(torch.relu(torch.bmm(xs, w("up"))))
    else:
        raise ValueError(mlp_type)
    return torch.bmm(h, w("down"))


def _combine(out_buf, slot, keep, gates):
    """Each token's gated slots added in slot order: ``[T, d]``."""
    E, C, d = out_buf.shape
    rows = torch.cat([out_buf.reshape(E * C, d),
                      out_buf.new_zeros((1, d))])[slot]          # [T, K, d]
    weighted = rows * (gates * keep).to(rows.dtype)[..., None]
    y = weighted[:, 0]
    for k in range(1, weighted.shape[1]):
        y = y + weighted[:, k]
    return y


class _GatherRows(torch.autograd.Function):
    """``x [b, ...]`` of every rank of ``rows.group`` as ``[size b, ...]``
    in rank order; the gradient of each rank's rows summed over the
    ranks back to it."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        out = x.new_empty((rows.size * x.shape[0],) + x.shape[1:])
        collectives.all_gather_into(out, x.contiguous(), group=rows.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // ctx.rows.size,) + g.shape[1:])
        collectives.reduce_scatter_into(out, g, group=ctx.rows.group)
        return out, None


def _moe_rows(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [batch, seq, d] routed as one batch -> (y, aux)."""
    m = cfg.moe
    b, s, d = x.shape
    T, E = b * s, m.num_experts
    C = capacity(cfg, T)
    xf = x.reshape(T, d)
    probs, gates, experts = _route(p, xf, cfg)
    buf, slot, keep = _dispatch(xf, experts, C, E)
    y = _combine(_expert_ffn(p, buf, cfg.mlp_type), slot, keep, gates)
    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], xf, cfg.mlp_type)
    frac_tokens = _counts(experts, E).float() / experts.numel()
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs) * m.aux_loss_weight
    return y.reshape(b, s, d).to(x.dtype), aux


def apply_moe(p, x, cfg, rows: Optional[RowShards] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [batch, seq, d] -> (y, aux_loss f32 scalar).  Given ``rows``,
    ``x`` is this rank's share of a batch routed whole (see the module
    docstring), and the aux term the mean over its pieces."""
    if rows is None or rows.size == 1:
        return _moe_rows(p, x, cfg)
    b = x.shape[0]
    whole = _GatherRows.apply(x, rows)
    step = rows.piece or whole.shape[0]
    ys, auxes = zip(*(_moe_rows(p, whole[lo:lo + step], cfg)
                      for lo in range(0, whole.shape[0], step)))
    y = torch.cat(ys) if len(ys) > 1 else ys[0]
    aux = torch.stack(auxes).mean() if len(auxes) > 1 else auxes[0]
    return y[rows.index * b:(rows.index + 1) * b], aux
