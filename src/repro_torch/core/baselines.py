"""Topology strategies for the dense superstep — the port of the in-graph
strategies of ``repro.core.baselines`` (paper §IV-A3).

Every strategy has the reference's in-graph contract:

* ``needs_sim`` — whether the engine keeps the ``[n, n]`` Eq.-3 cache
  (refreshed every ``sim_every`` rounds);
* ``uniform_mixing`` — W is the uniform average over self + senders, so
  the engine mixes with the masked kernel straight from the edges;
* ``init_graph_state()`` — the state the engine carries between rounds;
  a stateful strategy also has ``set_graph_state(gstate, sim)``, which the
  engine calls after each chunk so a later run continues from it;
* ``graph_round(gstate, rnd, sim)`` -> ``(gstate, edges [n, n] bool,
  W [n, n] f32)`` on the strategy's device, ``rnd`` a host int; W is
  ``None`` where ``uniform_mixing`` holds (the engine never reads it).

Each strategy that draws takes its draw as an optional keyword of
``graph_round`` and otherwise uses its own CPU ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import fold_seed, resolve_device
from . import mixing, topology
from .morph import MorphNoise, init_state, update_topology
from .selection import NEG_INF, gumbel, scatter_or, stable_topk


class InGraphMorphStrategy:
    """Morph: negotiate every ``delta_r`` rounds on the cached similarity
    matrix, keep the held edges in between."""

    uniform_mixing = True
    needs_sim = True

    def __init__(self, n: int, k: int, view_size: Optional[int] = None,
                 beta: float = 500.0, delta_r: int = 5, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.name = "morph-ingraph"
        self.n, self.k = n, k
        self.view_size = view_size if view_size is not None else k + 2
        self.beta, self.delta_r = beta, delta_r
        ring = np.roll(np.eye(n, dtype=bool), 1, axis=1) \
            | np.roll(np.eye(n, dtype=bool), -1, axis=1)
        self.state = init_state(torch.as_tensor(ring, device=self.device),
                                seed)

    def init_graph_state(self):
        """The :class:`MorphGraphState` the engine carries: the bootstrap
        ring overlay with empty estimates, or the state an engine handed
        back."""
        return self.state

    def set_graph_state(self, gstate, sim: Optional[torch.Tensor] = None):
        """Adopt the state an engine evolved, so a follow-up run continues
        from its topology (and its draws) instead of the bootstrap ring."""
        self.state = gstate

    def graph_round(self, gstate, rnd: int, sim: torch.Tensor,
                    noise: Optional[MorphNoise] = None):
        """Negotiate on round ``rnd % delta_r == 0`` (with ``noise`` as the
        draws when given), else reuse the held edges."""
        if rnd % self.delta_r != 0:
            return gstate, gstate.edges, None
        new_state = update_topology(
            gstate, sim, k=min(self.k, self.n - 1),
            view_size=min(self.view_size, self.n - 1), beta=self.beta,
            noise=noise)
        return new_state, new_state.edges, None


class InGraphStaticStrategy:
    """Static baseline: a fixed random ``degree``-regular undirected graph
    with Metropolis-Hastings weights, the same every round."""

    uniform_mixing = False
    needs_sim = False

    def __init__(self, n: int, degree: int, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.name = "static-mh-ingraph"
        self.n, self.degree = n, degree
        adj = topology.random_regular_graph(n, degree,
                                            np.random.default_rng(seed))
        self._edges = torch.as_tensor(adj, device=self.device)
        self._w = torch.as_tensor(mixing.metropolis_hastings_weights(adj),
                                  dtype=torch.float32, device=self.device)

    def init_graph_state(self):
        """Stateless."""
        return ()

    def graph_round(self, gstate, rnd: int, sim):
        """The fixed ``(edges, W)``."""
        return gstate, self._edges, self._w


class InGraphFullyConnectedStrategy:
    """All-to-all exchange with ``W = 1/n`` — the optimistic upper bound."""

    uniform_mixing = False
    needs_sim = False

    def __init__(self, n: int, device="cuda"):
        self.device = resolve_device(device)
        self.name = "fully-connected-ingraph"
        self.n = n
        self._edges = torch.as_tensor(topology.fully_connected(n),
                                      device=self.device)
        self._w = torch.as_tensor(mixing.fully_connected_weights(n),
                                  dtype=torch.float32, device=self.device)

    def init_graph_state(self):
        """Stateless."""
        return ()

    def graph_round(self, gstate, rnd: int, sim):
        """The complete graph and ``1/n`` weights."""
        return gstate, self._edges, self._w


class InGraphEpidemicStrategy:
    """EL-Oracle: each node sends to ``k`` uniformly random peers, drawn
    afresh every round from a generator seeded with ``fold_seed(seed,
    rnd)`` — a pure function of ``(seed, rnd)``."""

    uniform_mixing = True
    needs_sim = False

    def __init__(self, n: int, k: int, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.name = "el-oracle-ingraph"
        self.n, self.k, self.seed = n, k, seed
        self._gen = torch.Generator()
        self._eye = torch.eye(n, dtype=torch.bool, device=self.device)

    def init_graph_state(self):
        """Stateless: the draw depends only on the round."""
        return ()

    def graph_round(self, gstate, rnd: int, sim,
                    noise: Optional[torch.Tensor] = None):
        """Gumbel-top-k picks ``k`` distinct receivers per sender from
        ``noise [n, n]`` (row j = sender j's scores) or a fresh draw."""
        n, k = self.n, min(self.k, self.n - 1)
        if noise is None:
            self._gen.manual_seed(fold_seed(self.seed, rnd))
            noise = gumbel((n, n), self._gen, self.device)
        _, idx = stable_topk(torch.where(~self._eye, noise, NEG_INF), k)
        out = scatter_or(idx, torch.ones_like(idx, dtype=torch.bool), n)
        edges = out.T.contiguous()          # edges[i, j]: j sends to i
        return gstate, edges, None
