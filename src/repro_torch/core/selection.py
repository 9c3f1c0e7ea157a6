"""Diversity-driven neighbour selection (paper Eq. 5, Alg. 3) as batched
Gumbel-top-k — the port of ``repro.core.selection``.

Every function works on the last axis, so a ``[n, n]`` input selects for
all nodes at once (the reference ``vmap``s a per-node function).  Each
function that draws takes its Gumbel noise as an optional tensor and
otherwise draws from the given ``torch.Generator``; the parity tests hand
in the reference's ``jax.random`` draws.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_TINY = torch.finfo(torch.float32).tiny


def stable_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row,
    ties going to the lower index as ``jax.lax.top_k`` breaks them.

    ``torch.topk`` does not promise that order, and the masked entries
    (all ``NEG_INF``) tie on every call, so the controller would pick
    other peers than the reference."""
    values, indices = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def scatter_or(indices: torch.Tensor, valid: torch.Tensor, n: int
               ) -> torch.Tensor:
    """Row-wise boolean scatter-OR: ``out[r, indices[r, s]] |= valid[r,
    s]`` into a false ``[rows, n]`` mask (the reference's
    ``.at[idx].max(valid)``)."""
    hits = torch.zeros(indices.shape[:-1] + (n,), dtype=torch.int32,
                       device=indices.device)
    return hits.scatter_add_(-1, indices, valid.int()) > 0


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel(0, 1) noise drawn from ``generator`` (on its own
    device, then moved to ``device``)."""
    u = torch.rand(shape, generator=generator,
                   device=generator.device).clamp_min(_TINY)
    return (-torch.log(-torch.log(u))).to(device)


def softmax_logits(sim: torch.Tensor, beta: float) -> torch.Tensor:
    """Selection logits: the most dissimilar peers get the largest logit."""
    return -beta * sim


def sample_gumbel_topk(sim: torch.Tensor, candidate_mask: torch.Tensor,
                       k: int, beta: float, *,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential softmax sampling without replacement (Eq. 5) as
    Gumbel-top-k: ``(indices [..., k], valid [..., k])``; ``valid`` marks
    picks of a real candidate (there may be fewer than ``k``)."""
    k = min(k, sim.shape[-1])
    if noise is None:
        noise = gumbel(sim.shape, generator, sim.device)
    scores = torch.where(candidate_mask, softmax_logits(sim, beta) + noise,
                         NEG_INF)
    _, idx = stable_topk(scores, k)
    rank = torch.arange(k, device=sim.device)
    valid = candidate_mask.gather(-1, idx) \
        & (rank < candidate_mask.sum(-1, keepdim=True))
    return idx, valid


def random_injection(pool_mask: torch.Tensor, count: int, *,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 3 line 3: a uniform sample of ``count`` peers from the pool,
    as Gumbel-top-k with constant logits."""
    count = min(count, pool_mask.shape[-1])
    if noise is None:
        noise = gumbel(pool_mask.shape, generator, pool_mask.device)
    _, idx = stable_topk(torch.where(pool_mask, noise, NEG_INF), count)
    rank = torch.arange(count, device=pool_mask.device)
    valid = pool_mask.gather(-1, idx) \
        & (rank < pool_mask.sum(-1, keepdim=True))
    return idx, valid
