"""Gossiped candidate discovery and the sparse-native strategies — the port
of ``repro.sparse.discovery`` (DESIGN.md §11).

Each receiver's candidate set is its current k senders, a gossip sample
of its senders' senders and a few uniform random peers (c = O(k) in all);
Eq. 3 is measured against those c peers only and the k senders are
Gumbel-top-k picks among them (Eq. 5), so the in-degree is exactly k.

Randomness: one round's draws are :class:`SparseDraws`.  Passed in, they
are used as given (the parity tests replay the reference's ``jax.random``
draws, keyed ``fold_in(round_key(seed, rnd), 3 / 4 / 5)``); otherwise
:meth:`SparseMorphStrategy.draw` makes them from a CPU generator seeded
with ``fold_seed(seed, rnd)``, a pure function of ``(seed, rnd)``, so a
run's graphs are the same on the card and on the CPU.

The strategies have the reference's sparse in-graph contract: ``sparse =
True``, ``needs_params``, and ``graph_round(gstate, rnd, params) ->
(gstate, SparseAdjacency)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import fold_seed, resolve_device
from ..core.selection import gumbel, sample_gumbel_topk
from .adjacency import SparseAdjacency, uniform_csr_weights
from .mix import candidate_similarity


class SparseDraws(NamedTuple):
    """One round's draws; ``gossip`` and ``random`` are ``None`` when the
    candidate set is the whole population."""
    gossip: Optional[torch.Tensor]   # [n, n_gossip] int in [0, k^2)
    random: Optional[torch.Tensor]   # [n, n_rand] int in [0, n)
    select: torch.Tensor             # [n, c] f32 Gumbel, row i = node i's


def _ring_bootstrap(n: int, k: int) -> np.ndarray:
    """Node i's in-neighbours are the next k nodes around the ring."""
    base = np.arange(n)[:, None] + np.arange(1, k + 1)[None, :]
    return base % n


def candidate_counts(c: int, k: int):
    """``(n_gossip, n_rand)``: the candidate slots past the k current
    senders, half (rounded down) gossip, the rest random."""
    if c <= k:
        raise ValueError(f"candidate set c={c} must exceed k={k}")
    n_gossip = (c - k) // 2
    return n_gossip, c - k - n_gossip


def gossip_candidates(idx: torch.Tensor, c: int, gossip: torch.Tensor,
                      random: torch.Tensor):
    """``[n, c]`` candidate senders for every receiver and their ``[n, c]``
    validity (self and repeats of an earlier slot masked).  Slots 0..k-1
    are the current senders, then ``gossip`` picks among the senders'
    senders (``[n, n_gossip]`` positions in the flattened ``[k, k]``),
    then the ``random`` peers ``[n, n_rand]``."""
    n, k = idx.shape
    n_gossip, _ = candidate_counts(c, k)
    parts = [idx]
    if n_gossip:
        nn = idx[idx].reshape(n, k * k)            # neighbours of neighbours
        parts.append(nn.gather(1, gossip.long()))
    parts.append(random.long())
    cand = torch.cat(parts, dim=1)
    slot = torch.arange(c, device=idx.device)
    dup = (cand[:, :, None] == cand[:, None, :]) \
        & (slot[None, :, None] > slot[None, None, :])
    rows = torch.arange(n, device=idx.device)[:, None]
    return cand, ~dup.any(dim=2) & (cand != rows)


def full_candidates(n: int, device="cpu"):
    """The whole population as every node's candidate set (self masked)."""
    cand = torch.arange(n, device=device)[None, :].expand(n, n)
    return cand, ~torch.eye(n, dtype=torch.bool, device=device)


def _select_topk(sim: torch.Tensor, valid: torch.Tensor, cand: torch.Tensor,
                 k: int, beta: float, noise: torch.Tensor) -> torch.Tensor:
    """Receiver-side Gumbel-top-k over the candidate axis -> ``[n, k]``
    sender indices (every row has at least k valid candidates)."""
    slots, _ = sample_gumbel_topk(sim, valid, k, beta, noise=noise)
    return cand.gather(1, slots)


class _SparseStrategy:
    """What the two sparse strategies share: the candidate-set size, the
    draws and the candidates of one round."""

    in_graph = True
    sparse = True
    needs_sim = False
    uniform_mixing = True

    def __init__(self, n: int, k: int, candidates: Optional[int], seed: int,
                 device):
        if k >= n:
            raise ValueError(f"k={k} must be < n={n}")
        self.device = resolve_device(device)
        self.n, self.k, self.seed = n, k, seed
        self.c = min(n, candidates if candidates is not None else 4 * k + 2)
        self._gen = torch.Generator()

    def draw(self, rnd: int) -> SparseDraws:
        """Round ``rnd``'s draws, from a CPU generator seeded with
        ``fold_seed(seed, rnd)``."""
        self._gen.manual_seed(fold_seed(self.seed, rnd))
        n, k, c = self.n, self.k, self.c
        gossip = random = None
        if c < n:
            n_gossip, n_rand = candidate_counts(c, k)
            gossip = torch.randint(0, k * k, (n, n_gossip),
                                   generator=self._gen).to(self.device)
            random = torch.randint(0, n, (n, n_rand),
                                   generator=self._gen).to(self.device)
        return SparseDraws(gossip, random, gumbel((n, c), self._gen,
                                                  self.device))

    def _candidates(self, idx: torch.Tensor, draws: SparseDraws):
        if self.c >= self.n:
            return full_candidates(self.n, self.device)
        return gossip_candidates(idx, self.c, draws.gossip, draws.random)

    def _adjacency(self, idx: torch.Tensor) -> SparseAdjacency:
        return uniform_csr_weights(idx, torch.ones_like(idx,
                                                        dtype=torch.bool))


class SparseMorphStrategy(_SparseStrategy):
    """Morph with gossiped candidate discovery: every ``delta_r`` rounds
    each node draws its candidates, measures Eq. 3 against them and picks
    k diverse senders; in between the senders are held.  The state is the
    ``[n, k]`` sender index array, O(n k) where the dense controller
    carries O(n^2).

    ``candidates=None`` means ``min(n, 4k + 2)``; ``candidates >= n``
    makes every peer a candidate.  ``sim_row_chunk`` bounds the Eq.-3
    gather to that many receivers at a time (the result does not depend
    on it)."""

    needs_params = True
    name = "sparse-morph"

    def __init__(self, n: int, k: int, candidates: Optional[int] = None,
                 beta: float = 5.0, delta_r: int = 5, seed: int = 0,
                 sim_row_chunk: Optional[int] = None, device="cuda"):
        super().__init__(n, k, candidates, seed, device)
        self.beta, self.delta_r = beta, delta_r
        self.sim_row_chunk = sim_row_chunk
        self.idx = torch.as_tensor(_ring_bootstrap(n, k), device=self.device)

    def init_graph_state(self) -> torch.Tensor:
        """The ``[n, k]`` senders: the bootstrap ring's, or those an engine
        handed back."""
        return self.idx

    def set_graph_state(self, gstate: torch.Tensor, sim=None):
        """Adopt the senders an engine evolved, so a follow-up run
        continues from them instead of the bootstrap ring."""
        self.idx = gstate

    def graph_round(self, gstate, rnd: int, params,
                    draws: Optional[SparseDraws] = None):
        """Negotiate on round ``rnd % delta_r == 0`` (with ``draws`` when
        given), else hold the senders."""
        idx = gstate
        if rnd % self.delta_r == 0:
            if draws is None:
                draws = self.draw(rnd)
            cand, valid = self._candidates(idx, draws)
            sim = candidate_similarity(params, cand,
                                       row_chunk=self.sim_row_chunk)
            idx = _select_topk(sim, valid, cand, self.k, self.beta,
                               draws.select)
        return idx, self._adjacency(idx)


class SparseEpidemicStrategy(_SparseStrategy):
    """Epidemic Learning's round-random topology in CSR form: every round
    each receiver takes k distinct random senders among its candidates
    (the ring guarantees the floor, the random candidates shuffle).
    Stateless and parameter-free."""

    needs_params = False
    name = "sparse-epidemic"

    def __init__(self, n: int, k: int, candidates: Optional[int] = None,
                 seed: int = 0, device="cuda"):
        super().__init__(n, k, candidates, seed, device)
        self._ring = torch.as_tensor(_ring_bootstrap(n, k),
                                     device=self.device)

    def init_graph_state(self):
        """Stateless: the draw depends only on the round."""
        return ()

    def graph_round(self, gstate, rnd: int, params=None,
                    draws: Optional[SparseDraws] = None):
        """Pure Gumbel scores (beta = 0 on a constant similarity) pick k
        senders uniformly without replacement among the valid
        candidates."""
        if draws is None:
            draws = self.draw(rnd)
        cand, valid = self._candidates(self._ring, draws)
        idx = _select_topk(torch.zeros(cand.shape, device=self.device),
                           valid, cand, self.k, 0.0, draws.select)
        return gstate, self._adjacency(idx)
