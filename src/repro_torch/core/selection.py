"""Diversity-driven neighbour selection (paper Eq. 5, Alg. 3) — the port
of ``repro.core.selection``.

The tensor functions are batched Gumbel-top-k: every function works on the
last axis, so a ``[n, n]`` input selects for all nodes at once (the
reference ``vmap``s a per-node function).  Each function that draws takes
its Gumbel noise as an optional tensor and otherwise draws from the given
``torch.Generator``; the parity tests hand in the reference's
``jax.random`` draws.  :func:`sample_sequential` and
:func:`update_wanted_senders_host` are the paper-faithful host loop of
Alg. 3 for the message-faithful protocol, a copy of the reference's: the
same numpy ``Generator`` gives the same draws.  :func:`update_wanted_senders`
is its tensor twin, the reference's jit-safe view mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def update_wanted_senders(sim: torch.Tensor, local_candidates: torch.Tensor,
                          full_candidates: torch.Tensor, k: int,
                          view_size: int, beta: float, *,
                          select_noise: Optional[torch.Tensor] = None,
                          inject_noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Alg. 3 as tensor code: the boolean view ``V`` of up to ``view_size``
    wanted senders, ``k`` diversity-sampled from C_A (``local_candidates``,
    the peers with a usable estimate in ``sim``) and ``view_size - k``
    uniformly random ones from the rest of C (``full_candidates``).  The
    Gumbel noise of the two picks (``select_noise``, ``inject_noise``,
    each shaped like ``sim``) is drawn from ``generator`` where not given;
    leading dimensions of ``sim`` and the masks are batch dimensions."""
    n = sim.shape[-1]
    idx, valid = sample_gumbel_topk(sim, local_candidates, k, beta,
                                    noise=select_noise, generator=generator)
    view = scatter_or(idx, valid, n)
    pool = full_candidates & ~local_candidates & ~view
    r = min(max(view_size - k, 0), n)
    if r > 0:
        ridx, rvalid = random_injection(pool, r, noise=inject_noise,
                                        generator=generator)
        view = view | scatter_or(ridx, rvalid, n)
    return view


# ---------------------------------------------------------------------------
# Host side (numpy): the literal Alg. 3 loop of the protocol simulator.
# ---------------------------------------------------------------------------

def sample_sequential(rng: np.random.Generator, sim: np.ndarray,
                      candidate_mask: np.ndarray, k: int,
                      beta: float) -> np.ndarray:
    """Sequentially sample ``k`` indices without replacement from the
    softmax over ``-beta * sim`` restricted to ``candidate_mask`` (fewer
    when there are fewer candidates)."""
    sim = np.asarray(sim, np.float64)
    avail = np.asarray(candidate_mask, bool).copy()
    chosen = []
    for _ in range(min(k, int(avail.sum()))):
        logits = np.where(avail, -beta * sim, -np.inf)
        logits = logits - logits.max()
        probs = np.exp(logits)
        probs = probs / probs.sum()
        j = int(rng.choice(len(sim), p=probs))
        chosen.append(j)
        avail[j] = False
    return np.asarray(chosen, np.int64)


def update_wanted_senders_host(rng: np.random.Generator, sim: np.ndarray,
                               local_candidates: np.ndarray,
                               full_candidates: np.ndarray, k: int,
                               view_size: int, beta: float) -> np.ndarray:
    """Alg. 3 on the host: a boolean view of ``k`` diversity-sampled
    senders (:func:`sample_sequential` over C_A) and ``view_size - k``
    uniformly random ones from the rest of C."""
    n = len(sim)
    chosen = sample_sequential(rng, sim, local_candidates, k, beta)
    view = np.zeros(n, bool)
    view[chosen] = True
    pool = np.flatnonzero(full_candidates & ~local_candidates & ~view)
    r = min(max(view_size - k, 0), len(pool))
    if r > 0:
        view[rng.choice(pool, size=r, replace=False)] = True
    return view
