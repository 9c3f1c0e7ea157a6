"""Topology strategies (paper §IV-A3) — the port of
``repro.core.baselines``.

Every strategy implements the host surface of :class:`TopologyStrategy`:
``round_edges(rnd, stacked_params)`` -> ``(edges [n, n] bool, W [n, n])``
as numpy arrays, one call a round, which the runner's host loop drives.
The host strategies (:class:`StaticStrategy`,
:class:`FullyConnectedStrategy`, :class:`EpidemicStrategy`, and
:class:`~repro_torch.core.protocol.MorphProtocol`) are host numpy copies of
the reference's.

The ``InGraph*`` strategies also have the reference's in-graph contract,
which the dense superstep drives:

* ``in_graph = True``;
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
``graph_round`` and otherwise uses its own CPU ``torch.Generator``.  Their
``round_edges`` adapters drive the same ``graph_round`` one round at a
time and keep the state as the engine does, so the host loop gives the
engine's trajectory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple

import numpy as np
import torch

from .. import fold_seed, resolve_device
from ..kernels import ops
from . import mixing, topology
from .morph import MorphNoise, init_state, update_topology
from .selection import NEG_INF, gumbel, scatter_or, stable_topk


def _host_round(edges: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """A uniform strategy's ``(edges, W)`` as host arrays."""
    e = edges.cpu().numpy()
    return e, mixing.uniform_weights(e)


class InGraphMorphStrategy:
    """Morph: negotiate every ``delta_r`` rounds on the cached similarity
    matrix, keep the held edges in between."""

    uniform_mixing = True
    needs_params = True       # negotiates on the actual stacked models
    in_graph = True
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
        self._sim_cache: Optional[torch.Tensor] = None

    def init_graph_state(self):
        """The :class:`MorphGraphState` the engine carries: the bootstrap
        ring overlay with empty estimates, or the state an engine handed
        back."""
        return self.state

    def set_graph_state(self, gstate, sim: Optional[torch.Tensor] = None):
        """Adopt the state an engine evolved, so a follow-up run continues
        from its topology (and its draws) instead of the bootstrap ring."""
        self.state = gstate
        if sim is not None:
            self._sim_cache = sim

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

    def round_edges(self, rnd: int, stacked_params=None):
        """Host adapter: ``stacked_params`` (node-stacked tensors, offered
        every ``sim_every`` rounds) refreshes the Eq.-3 cache through
        :func:`~repro_torch.kernels.ops.model_pairwise_cosine` on their
        device, then :meth:`graph_round` runs on the cache."""
        if stacked_params is not None:
            self._sim_cache = ops.model_pairwise_cosine(stacked_params)
        if rnd % self.delta_r == 0 and self._sim_cache is None:
            raise ValueError("in-graph Morph needs stacked params before "
                             "its first negotiation round")
        self.state, edges, _ = self.graph_round(self.state, rnd,
                                                self._sim_cache)
        return _host_round(edges)


class InGraphStaticStrategy:
    """Static baseline: a fixed random ``degree``-regular undirected graph
    with Metropolis-Hastings weights, the same every round."""

    uniform_mixing = False
    needs_params = False
    in_graph = True
    needs_sim = False

    def __init__(self, n: int, degree: int, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.name = "static-mh-ingraph"
        self.n, self.degree = n, degree
        self._host = StaticStrategy(n=n, degree=degree, seed=seed)
        edges, w = self._host.round_edges(0)
        self._edges = torch.as_tensor(edges, device=self.device)
        self._w = torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def init_graph_state(self):
        """Stateless."""
        return ()

    def graph_round(self, gstate, rnd: int, sim):
        """The fixed ``(edges, W)``."""
        return gstate, self._edges, self._w

    def round_edges(self, rnd: int, stacked_params=None):
        """Host adapter: the fixed graph and MH weights (f64)."""
        return self._host.round_edges(rnd)


class InGraphFullyConnectedStrategy:
    """All-to-all exchange with ``W = 1/n`` — the optimistic upper bound."""

    uniform_mixing = False
    needs_params = False
    in_graph = True
    needs_sim = False

    def __init__(self, n: int, device="cuda"):
        self.device = resolve_device(device)
        self.name = "fully-connected-ingraph"
        self.n = n
        self._host = FullyConnectedStrategy(n=n)
        edges, w = self._host.round_edges(0)
        self._edges = torch.as_tensor(edges, device=self.device)
        self._w = torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def init_graph_state(self):
        """Stateless."""
        return ()

    def graph_round(self, gstate, rnd: int, sim):
        """The complete graph and ``1/n`` weights."""
        return gstate, self._edges, self._w

    def round_edges(self, rnd: int, stacked_params=None):
        """Host adapter: the complete graph and ``1/n`` weights (f64)."""
        return self._host.round_edges(rnd)


class InGraphEpidemicStrategy:
    """EL-Oracle: each node sends to ``k`` uniformly random peers, drawn
    afresh every round from a generator seeded with ``fold_seed(seed,
    rnd)`` — a pure function of ``(seed, rnd)``."""

    uniform_mixing = True
    needs_params = False
    in_graph = True
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

    def round_edges(self, rnd: int, stacked_params=None):
        """Host adapter over :meth:`graph_round` (the engine's edges for
        the same seed and round)."""
        _, edges, _ = self.graph_round((), rnd, None)
        return _host_round(edges)


class InGraphEpidemicLocalStrategy:
    """EL-Local with the partial view carried in graph state: each node
    sends to ``k`` peers drawn uniformly from the ones it knows (fewer when
    it knows fewer), and receiving a model from ``j`` teaches ``i`` that
    ``j`` exists, so views densify over rounds.  The host
    :class:`EpidemicStrategy` with ``oracle=False`` keeps a frozen view;
    this one evolves it.

    The state is the ``[n, n]`` bool view (row i = the peers node i
    knows), starting from the ring plus ``view_extra`` random peers a node
    (a numpy generator seeded ``seed``); the round's draw comes from a
    generator seeded ``fold_seed(seed, rnd)``, as EL-Oracle's does.  The
    engine starts each run from the bootstrap view, as the reference's
    does; :meth:`set_graph_state` hands the evolved view to the host
    adapter, which carries it from call to call."""

    uniform_mixing = True
    needs_params = False
    in_graph = True
    needs_sim = False

    def __init__(self, n: int, k: int, seed: int = 0, view_extra: int = 2,
                 device="cuda"):
        self.device = resolve_device(device)
        if not 0 < k < n:
            raise ValueError("need 0 < k < n")
        self.name = "el-local-ingraph"
        self.n, self.k, self.seed = n, k, seed
        rng = np.random.default_rng(seed)
        view = np.roll(np.eye(n, dtype=bool), 1, axis=1) \
            | np.roll(np.eye(n, dtype=bool), -1, axis=1)
        for i in range(n):
            pool = np.flatnonzero(~view[i] & (np.arange(n) != i))
            if len(pool) and view_extra > 0:
                view[i, rng.choice(pool, size=min(view_extra, len(pool)),
                                   replace=False)] = True
        self._view0 = torch.as_tensor(view, device=self.device)
        self._gstate: Optional[torch.Tensor] = None
        self._gen = torch.Generator()
        self._eye = torch.eye(n, dtype=torch.bool, device=self.device)

    def init_graph_state(self):
        """The bootstrap view ``[n, n]``."""
        return self._view0

    def set_graph_state(self, gstate, sim=None):
        """Adopt the view an engine evolved, so follow-up host rounds
        continue from it."""
        self._gstate = gstate

    def graph_round(self, gstate, rnd: int, sim,
                    noise: Optional[torch.Tensor] = None):
        """Gumbel-top-k over each sender's known peers (``noise [n, n]``,
        row j = sender j's scores, or a fresh draw), then membership
        gossip: receivers learn their senders."""
        n, k = self.n, min(self.k, self.n - 1)
        if noise is None:
            self._gen.manual_seed(fold_seed(self.seed, rnd))
            noise = gumbel((n, n), self._gen, self.device)
        pool = gstate & ~self._eye          # row j = sender j's view
        _, idx = stable_topk(torch.where(pool, noise, NEG_INF), k)
        out = scatter_or(idx, pool.gather(-1, idx), n)
        edges = out.T.contiguous()          # edges[i, j]: j sends to i
        return gstate | edges, edges, None

    def round_edges(self, rnd: int, stacked_params=None):
        """Host adapter: :meth:`graph_round` carrying the evolving view
        from call to call, as the engine carries it from round to round."""
        if self._gstate is None:
            self._gstate = self.init_graph_state()
        self._gstate, edges, _ = self.graph_round(self._gstate, rnd, None)
        return _host_round(edges)


# ---------------------------------------------------------------------------
# Host strategies: numpy copies of the reference's.
# ---------------------------------------------------------------------------

class TopologyStrategy(Protocol):
    """Duck-typed strategy surface the host loop drives: one call per round
    producing that round's in-edge matrix and mixing matrix.

    Optional attribute flags refine dispatch: ``needs_params`` (wants the
    stacked models), ``uniform_mixing`` (W is the uniform average, so the
    masked kernel mixes from the edges), and the in-graph contract
    (``in_graph``/``needs_sim``/``init_graph_state``/``graph_round``)
    documented in the module docstring.
    """
    name: str

    def round_edges(self, rnd: int, stacked_params=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(edges, W)`` for this round: ``edges[i, j]`` = j
        sends to i ([n, n] bool), ``W`` row-stochastic ([n, n] float)."""
        ...


@dataclass
class StaticStrategy:
    """Fixed d-regular undirected graph + MH weights (paper's 'Static')."""
    n: int
    degree: int
    seed: int = 0
    name: str = "static-mh"
    needs_params = False      # round_edges ignores the stacked models

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._adj = topology.random_regular_graph(self.n, self.degree, rng)
        self._w = mixing.metropolis_hastings_weights(self._adj)
        self._edges = self._adj.copy()   # symmetric: send both ways

    def round_edges(self, rnd: int, stacked_params=None):
        """Same fixed graph and MH weights every round."""
        return self._edges, self._w


@dataclass
class FullyConnectedStrategy:
    """All-to-all exchange with W = 1/n — the paper's optimistic upper
    bound (n*(n-1) transfers per round)."""
    n: int
    name: str = "fully-connected"
    needs_params = False

    def __post_init__(self):
        self._edges = topology.fully_connected(self.n)
        self._w = mixing.fully_connected_weights(self.n)

    def round_edges(self, rnd: int, stacked_params=None):
        """Complete graph + uniform 1/n weights, every round."""
        return self._edges, self._w


@dataclass
class EpidemicStrategy:
    """Epidemic Learning: fresh random k-out edges every round from a host
    numpy generator; ``oracle=False`` is EL-Local over a frozen partial
    ``view``."""
    n: int
    k: int
    seed: int = 0
    oracle: bool = True            # EL-Oracle vs EL-Local
    view: Optional[np.ndarray] = None   # [n, n] known-peer mask (EL-Local)
    name: str = "epidemic"
    needs_params = False
    uniform_mixing = True

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.name = "el-oracle" if self.oracle else "el-local"
        if not self.oracle and self.view is None:
            raise ValueError("EL-Local needs an initial partial view")

    def round_edges(self, rnd: int, stacked_params=None):
        """Fresh random k-out in-edge matrix + uniform weights."""
        view = None if self.oracle else self.view
        edges = topology.random_out_regular(self.n, self.k, self._rng, view)
        return edges, mixing.uniform_weights(edges)
