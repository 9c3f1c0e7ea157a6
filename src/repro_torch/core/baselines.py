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

The sweep engine (:class:`repro_torch.dlrt.SweepSuperstep`) runs E
experiments, each with its own strategy object of one class, through
experiment 0's object: ``sweep_graph_state(strategies)`` stacks the
experiments' states on a leading ``[E]`` axis (a fixed graph, the Morph
state, a seed), and ``stacked_graph_round(gstate, rnd, sim)`` returns
``(gstate, edges [E, n, n], W [E, n, n] or None)``, each experiment's its
own strategy's solo ``graph_round`` would, bit for bit.  Morph also has
``sweep_graph_round(gstate, rnd, sim, delta_r=None, beta=None)``, the
per-experiment hyperparameter axes; without them it is ``graph_round``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple

import numpy as np
import torch

from .. import fold_seed, resolve_device
from ..kernels import ops
from . import mixing, topology
from .morph import (MorphGraphState, MorphNoise, init_state, stack_states,
                    update_topology)
from .selection import NEG_INF, gumbel, scatter_or, stable_topk


def _host_round(edges: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """A uniform strategy's ``(edges, W)`` as host arrays."""
    e = edges.cpu().numpy()
    return e, mixing.uniform_weights(e)


def _same_shape(strategies, *attrs) -> None:
    """A sweep's strategies share the attributes that fix its shapes."""
    first = strategies[0]
    for e, st in enumerate(strategies):
        for a in attrs:
            if getattr(st, a) != getattr(first, a):
                raise ValueError(
                    f"experiment {e}: {a}={getattr(st, a)!r} but "
                    f"experiment 0 has {getattr(first, a)!r} (one shape "
                    "for the whole sweep)")


def _gumbel_stack(seeds, rnd: int, n: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """``[E, n, n]`` Gumbel scores, experiment ``e``'s from a generator
    seeded ``fold_seed(seeds[e], rnd)`` as its solo draw, moved to
    ``device`` in one copy."""
    draws = []
    for seed in seeds:
        gen.manual_seed(fold_seed(seed, rnd))
        draws.append(gumbel((n, n), gen, "cpu"))
    return torch.stack(draws).to(device)


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
        return self.sweep_graph_round(gstate, rnd, sim, noise=noise)

    def sweep_graph_state(self, strategies) -> MorphGraphState:
        """The experiments' states (``strategies``, this one first)
        stacked, each keeping its own generator."""
        _same_shape(strategies, "n", "k", "view_size")
        return stack_states([st.init_graph_state() for st in strategies])

    def stacked_graph_round(self, gstate, rnd: int, sim: torch.Tensor,
                            noise: Optional[MorphNoise] = None):
        """:meth:`sweep_graph_round` without hyperparameter axes."""
        return self.sweep_graph_round(gstate, rnd, sim, noise=noise)

    def sweep_graph_round(self, gstate, rnd: int, sim: torch.Tensor,
                          delta_r=None, beta=None,
                          noise: Optional[MorphNoise] = None):
        """:meth:`graph_round` with hyperparameter overrides (the
        reference's ``sweep_graph_round``): ``delta_r`` replaces the
        negotiation cadence and ``beta`` the selection's inverse
        temperature; with both ``None`` this is :meth:`graph_round`.

        On a stacked state (:meth:`sweep_graph_state`, ``sim [E, n, n]``)
        ``delta_r`` and ``beta`` are one value an experiment; only the
        experiments whose cadence is due negotiate (together, each with
        its own generator, which advances only then; ``noise`` stacks the
        draws of those experiments, in experiment order), the others keep
        their edges.  ``k`` and ``view_size`` are experiment 0's."""
        k, view = min(self.k, self.n - 1), min(self.view_size, self.n - 1)
        if gstate.known.dim() == 2:
            dr = self.delta_r if delta_r is None else int(delta_r)
            if rnd % dr != 0:
                return gstate, gstate.edges, None
            new_state = update_topology(
                gstate, sim, k=k, view_size=view,
                beta=self.beta if beta is None else float(beta),
                noise=noise)
            return new_state, new_state.edges, None
        E = gstate.known.shape[0]
        drs = [self.delta_r] * E if delta_r is None \
            else [int(d) for d in delta_r]
        due = [e for e in range(E) if rnd % drs[e] == 0]
        if not due:
            return gstate, gstate.edges, None
        b = self.beta if beta is None else torch.as_tensor(
            np.asarray(beta, np.float32)[due])
        if len(due) == E:
            new_state = update_topology(gstate, sim, k=k, view_size=view,
                                        beta=b, noise=noise)
            return new_state, new_state.edges, None
        idx = torch.as_tensor(due, device=gstate.known.device)
        sub = MorphGraphState(*(t[idx] for t in gstate[:4]),
                              generator=tuple(gstate.generator[e]
                                              for e in due))
        new_sub = update_topology(sub, sim[idx], k=k, view_size=view,
                                  beta=b, noise=noise)
        merged = []
        for old_t, new_t in zip(gstate[:4], new_sub[:4]):
            t = old_t.clone()
            t[idx] = new_t
            merged.append(t)
        new_state = MorphGraphState(*merged, generator=gstate.generator)
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

    def sweep_graph_state(self, strategies):
        """Each experiment's own fixed graph and weights, stacked: ``(edges
        [E, n, n], W [E, n, n])``."""
        _same_shape(strategies, "n")
        return (torch.stack([st._edges for st in strategies]),
                torch.stack([st._w for st in strategies]))

    def stacked_graph_round(self, gstate, rnd: int, sim):
        """Every experiment's fixed ``(edges, W)``."""
        return gstate, gstate[0], gstate[1]

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

    def sweep_graph_state(self, strategies):
        """``(edges [E, n, n], W [E, n, n])``: the complete graph and
        ``1/n`` weights once an experiment."""
        _same_shape(strategies, "n")
        E = len(strategies)
        return (self._edges.expand(E, -1, -1).contiguous(),
                self._w.expand(E, -1, -1).contiguous())

    def stacked_graph_round(self, gstate, rnd: int, sim):
        """Every experiment's complete graph and ``1/n`` weights."""
        return gstate, gstate[0], gstate[1]

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

    def sweep_graph_state(self, strategies):
        """The experiments' seeds, each keying its own draws."""
        _same_shape(strategies, "n", "k")
        return tuple(st.seed for st in strategies)

    def stacked_graph_round(self, gstate, rnd: int, sim,
                            noise: Optional[torch.Tensor] = None):
        """:meth:`graph_round` for every experiment: ``noise [E, n, n]``,
        or experiment ``e``'s draw keyed ``fold_seed(gstate[e], rnd)``."""
        n, k = self.n, min(self.k, self.n - 1)
        if noise is None:
            noise = _gumbel_stack(gstate, rnd, n, self._gen, self.device)
        _, idx = stable_topk(torch.where(~self._eye, noise, NEG_INF), k)
        out = scatter_or(idx, torch.ones_like(idx, dtype=torch.bool), n)
        return gstate, out.transpose(-1, -2).contiguous(), None

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

    def sweep_graph_state(self, strategies):
        """``(views [E, n, n], seeds)``: each experiment's bootstrap view
        and the seed keying its draws."""
        _same_shape(strategies, "n", "k")
        return (torch.stack([st.init_graph_state() for st in strategies]),
                tuple(st.seed for st in strategies))

    def stacked_graph_round(self, gstate, rnd: int, sim,
                            noise: Optional[torch.Tensor] = None):
        """:meth:`graph_round` for every experiment, each over its own
        view (``noise [E, n, n]`` or each experiment's keyed draw)."""
        views, seeds = gstate
        n, k = self.n, min(self.k, self.n - 1)
        if noise is None:
            noise = _gumbel_stack(seeds, rnd, n, self._gen, self.device)
        pool = views & ~self._eye
        _, idx = stable_topk(torch.where(pool, noise, NEG_INF), k)
        out = scatter_or(idx, pool.gather(-1, idx), n)
        edges = out.transpose(-1, -2).contiguous()
        return (views | edges, seeds), edges, None

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
