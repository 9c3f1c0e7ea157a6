"""The sweep farm: E whole experiments as one stacked round on one device
— the port of ``repro.dlrt.sweep`` (DESIGN.md §14).

A :class:`SweepSpec` declares E experiments (seeds x network profiles x
Morph's ``delta_r`` and ``beta``), and :class:`SweepSuperstep` runs them
together: each round is one local step over the ``[E n]`` stack of every
experiment's nodes, one Eq.-3 refresh over every leaf of every
experiment (one grouped Gram launch per
:data:`~repro_torch.kernels.pairwise_cosine.MAX_LEAVES` leaves), one
stacked graph round (the strategy's ``stacked_graph_round`` or, with
hyperparameter axes, Morph's ``sweep_graph_round``), and one grouped mix
launch per :data:`~repro_torch.kernels.graph_mix.MAX_LEAVES` leaves, each
experiment's leaves with its own W (or edges).

What defines a trajectory is kept per experiment, so experiment ``e`` is
bit for bit the solo :class:`~repro_torch.dlrt.Superstep` run of its
configuration:

* parameters — drawn from a CPU generator seeded ``spec.seeds[e]``, as
  the runner draws a solo run's (or given, e.g. from the reference);
* data — one shared dataset on the device, per-experiment ``[n, S]``
  index tables (:func:`repro_torch.data.stack_streams`) and each stream's
  own keyed slots (``DeviceDataStream.slots``);
* the graph — each experiment's own strategy state (its generator, its
  fixed graph, its seed);
* the network — a :class:`repro_torch.netsim.SweepNetwork`: each
  experiment's keyed matrices and fault timeline, the shared ring
  ``max_e S_e`` deep, each experiment's staleness clamped to its own
  depth.  As in the reference, an experiment shallower than the ring
  contracts ``n S_max`` columns where its solo run contracts ``n S_e``
  (the extra weights are zeros); equal depths are exact.

Where the reference differs: its sweep runs experiment 0's strategy
object for every experiment, so a Static sweep over several seeds mixes
every experiment over experiment 0's graph; here each experiment keeps
its own (ROADMAP queue 3).

Scope, as the reference's: the dense engine without a codec.  Sparse
strategies, compressed gossip and partition windows are refused.

**The ``("exp", "data")`` mesh** (:func:`repro_torch.launch.make_sweep_mesh`,
one ``torch.distributed`` rank a card): every rank is given the whole
spec, streams, strategies and network, and keeps block ``exp`` of ``E /
exp_devices`` consecutive experiments (their parameters, optimizer state,
index tables, strategy state, Eq.-3 cache and network ring).  With
``data`` = d > 1 their node axis is padded to ``n_pad = ceil(n / d) d`` by
repeating the last node, and the rank keeps rows ``[c n_local, (c + 1)
n_local)``; a round is then the batch of its own nodes, the local step
over its ``[E_local n_local]`` stack, one packed gather over the ``data``
group, the Eq.-3 refresh on the gathered logical rows (the Gram kernel),
the controller (every ``data`` rank of an experiment makes the same
draws) and this rank's row block of each experiment's W, embedded at
``n_pad`` with an identity tail, over the gathered population (one
grouped ``graph_mix`` launch).  With d = 1 the population is the rank's
own rows and the mix is the meshless one (a uniform strategy through the
masked kernel).  At each decode the edges, delivered masks and counters
are gathered over ``exp``, so every rank ends with the same logs,
histories, comm bytes and ``net_stats`` for all E experiments.  The
refusals are the reference's: ``E % exp_devices``, node sharding under a
network model, a mesh without both axes.  The row block sums over the
nodes in the order the whole contraction does, so on the CPU a tiny-MLP
sweep is bit for bit the meshless one; a split ``exp`` axis changes no
bits on any device.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..collectives import packed_all_gather
from ..compress import CompressConfig
from ..core.mixing import uniform_weights_torch
from ..data.pipeline import stack_streams
from ..kernels import ops
from ..tree import stack
from .metrics import MetricsLog, RoundRecord, net_staleness_mean
from .runtime import (RunnerConfig, _unstaged, make_evaluator,
                      make_local_step, make_round_record,
                      stacked_model_bytes, to_device)
from .sharded import embed_w
from .superstep import (eval_boundaries, net_effective, net_observed,
                        net_push, net_select)


@dataclass(frozen=True)
class SweepSpec:
    """The experiment axis: per-experiment tuples, zipped.

    ``seeds`` seeds each experiment's parameters (a solo run's
    ``cfg.seed``); ``profiles`` is an optional per-experiment label (the
    network profile's name) carried into benchmark records, the models
    themselves coming as a :class:`repro_torch.netsim.SweepNetwork`;
    ``delta_r`` / ``beta`` are optional per-experiment Morph
    hyperparameters, routed through the strategy's ``sweep_graph_round``.

    Build cross products with :meth:`grid`; every axis given must have
    ``len(self)`` entries.
    """

    seeds: Tuple[int, ...]
    profiles: Optional[Tuple[str, ...]] = None
    delta_r: Optional[Tuple[int, ...]] = None
    beta: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if len(self.seeds) == 0:
            raise ValueError("SweepSpec needs at least one experiment")
        for name in ("profiles", "delta_r", "beta"):
            axis = getattr(self, name)
            if axis is not None and len(axis) != len(self.seeds):
                raise ValueError(
                    f"SweepSpec.{name} has {len(axis)} entries for "
                    f"{len(self.seeds)} experiments — per-experiment "
                    "axes are zipped, use SweepSpec.grid for cross "
                    "products")

    def __len__(self) -> int:
        return len(self.seeds)

    @classmethod
    def grid(cls, *, seeds: Sequence[int],
             profiles: Optional[Sequence[str]] = None,
             delta_r: Optional[Sequence[int]] = None,
             beta: Optional[Sequence[float]] = None) -> "SweepSpec":
        """Cross product of the axes given: ``seeds`` varies fastest, then
        ``profiles``, ``delta_r``, ``beta``; E is the product of their
        lengths."""
        axes = [tuple(seeds)]
        for a in (profiles, delta_r, beta):
            axes.append((None,) if a is None else tuple(a))
        rows = [tuple(reversed(row))
                for row in itertools.product(*reversed(axes))]
        cols = list(zip(*rows))
        return cls(
            seeds=tuple(cols[0]),
            profiles=None if profiles is None else tuple(cols[1]),
            delta_r=None if delta_r is None else tuple(cols[2]),
            beta=None if beta is None else tuple(cols[3]))

    def describe(self, e: int) -> Dict:
        """Experiment ``e``'s coordinates as a plain dict (benchmark record
        metadata)."""
        out: Dict = {"seed": int(self.seeds[e])}
        if self.profiles is not None:
            out["profile"] = self.profiles[e]
        if self.delta_r is not None:
            out["delta_r"] = int(self.delta_r[e])
        if self.beta is not None:
            out["beta"] = float(self.beta[e])
        return out


def _flat(tree: Dict[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """``[E, n, ...]`` leaves as ``[E n, ...]`` views."""
    return OrderedDict((k, v.reshape((-1,) + v.shape[2:]))
                       for k, v in tree.items())


def _split(tree, E: int):
    """The inverse of :func:`_flat` over a state tree (dicts, tuples,
    tensors); leaves not on the ``[E n]`` axis (shared optimizer counters)
    pass through."""
    if isinstance(tree, dict):
        return type(tree)((k, _split(v, E)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(_split(v, E) for v in tree)
    if tree.dim() == 0 or tree.shape[0] % E:
        return tree
    return tree.reshape((E, tree.shape[0] // E) + tree.shape[1:])


class SweepSuperstep:
    """E experiments' rounds, stacked on one device (the module
    docstring).

    * ``spec`` — the :class:`SweepSpec`;
    * ``loss_fn`` / ``eval_fn`` / ``optimizer`` — the solo engine's;
      ``init_fn(generator)`` makes one node's parameters, drawn for
      experiment ``e`` from a CPU generator seeded ``spec.seeds[e]``
      unless ``params`` (one node-stacked dict an experiment) is given;
    * ``streams`` — one :class:`repro_torch.data.DeviceDataStream` an
      experiment over one dataset (:func:`repro_torch.data.stack_streams`);
      each draws its own slots;
    * ``strategies`` — one in-graph strategy an experiment, all of one
      class; experiment 0's object runs the stacked graph round over every
      experiment's state (``sweep_graph_state``);
    * ``cfg`` — the shared :class:`RunnerConfig` (``rounds``,
      ``eval_every``, ``sim_every``, ``mix_chunk_d``,
      ``eval_batch_chunk``; ``spec.seeds`` supersede ``cfg.seed``);
    * ``net`` — an optional :class:`repro_torch.netsim.SweepNetwork`;
    * ``mesh`` — an optional ``("exp", "data")`` mesh
      (:func:`repro_torch.launch.make_sweep_mesh`; the module docstring):
      the run's device is then the mesh's, ``params`` and ``opt_state``
      are this rank's experiments (and rows), :meth:`logical_params`
      gathers every experiment's, and the logs, histories and counters
      cover all E on every rank;
    * ``chunk`` — rounds buffered on the device between host decodes.

    The local step runs over the ``[E n]`` stack in one call: each
    experiment's rows get its solo step's bits (its convolutions become
    grouped ones over ``E n`` groups instead of ``n``; held on the CPU by
    ``tests/test_torch_sweep.py`` and on the card, with deterministic
    cuDNN, by ``chip_smoke.py`` phase 14(a)).
    """

    def __init__(self, *, spec: SweepSpec, loss_fn: Callable,
                 eval_fn: Callable, optimizer, streams: Sequence,
                 test_batch: Dict[str, np.ndarray], strategies: Sequence,
                 cfg: RunnerConfig, init_fn: Optional[Callable] = None,
                 params: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                 net=None, mesh=None, chunk: Optional[int] = None,
                 device="cuda"):
        E = len(spec)
        if len(streams) != E:
            raise ValueError(f"{len(streams)} data streams for {E} "
                             "experiments")
        if len(strategies) != E:
            raise ValueError(f"{len(strategies)} strategies for {E} "
                             "experiments")
        if net is not None and len(net) != E:
            raise ValueError(f"SweepNetwork stacks {len(net)} profiles "
                             f"for {E} experiments")
        first = strategies[0]
        name = getattr(first, "name", first)
        if not getattr(first, "in_graph", False):
            raise TypeError(
                f"strategy {name!r} has no in-graph surface; the sweep "
                "engine stacks graph_round")
        if getattr(first, "sparse", False):
            raise TypeError("sparse-native strategies are outside the "
                            "sweep axis (dense gather path only)")
        if any(type(s) is not type(first) for s in strategies):
            raise TypeError("all experiments must run the same strategy "
                            "class — experiment 0's graph round is the "
                            "shared control plane")
        if not hasattr(first, "sweep_graph_state"):
            raise TypeError(f"strategy {name!r} has no stacked graph round "
                            "(sweep_graph_state / stacked_graph_round)")
        hp_axis = spec.delta_r is not None or spec.beta is not None
        if hp_axis and not hasattr(first, "sweep_graph_round"):
            raise TypeError(
                f"strategy {name!r} has no sweep_graph_round; delta_r/beta "
                "sweep axes need the hyperparameter surface "
                "(InGraphMorphStrategy)")
        codec = CompressConfig.parse(cfg.compress)
        if codec.enabled:
            raise ValueError("compressed gossip is outside the sweep axis "
                             "(the reference sweeps the dense gather path "
                             "only); use compress='none'")
        if cfg.engine != "dense" or cfg.net is not None:
            raise ValueError("the sweep runs the dense engine; pass its "
                             "network model as net=SweepNetwork(...), not "
                             "cfg.net")
        for st in streams:
            if st.n != cfg.n_nodes:
                raise ValueError(f"data stream covers {st.n} nodes, "
                                 f"config says {cfg.n_nodes}")
        exp_world = data_world = 1
        if mesh is not None:
            shape = getattr(mesh, "shape", None) or {}
            if "exp" not in shape or "data" not in shape:
                raise ValueError("sweep mesh needs ('exp', 'data') axes — "
                                 "build it with launch.mesh.make_sweep_mesh")
            exp_world, data_world = shape["exp"], shape["data"]
            if E % exp_world != 0:
                raise ValueError(f"E={E} experiments do not divide over "
                                 f"exp_devices={exp_world}")
            if data_world > 1 and net is not None:
                raise ValueError(
                    "the sweep's network model keeps its snapshot ring "
                    "per-experiment; node-axis sharding is a no-net "
                    "configuration (use exp_devices only)")

        self.device = dev = mesh.device if mesh is not None \
            else resolve_device(device)
        self.spec, self.cfg, self.E = spec, cfg, E
        self.mesh, self.exp_world, self.data_world = \
            mesh, exp_world, data_world
        n = cfg.n_nodes
        # This rank's experiments [lo, lo + E_local) and node rows
        # [offset, offset + n_local) of the padded axis; a padded row
        # repeats the last real node (edge padding).
        self.E_local = E // exp_world
        lo = mesh.coords["exp"] * self.E_local if mesh is not None else 0
        self.experiments = range(lo, lo + self.E_local)
        mine = slice(lo, lo + self.E_local)
        self.n_pad = -(-n // data_world) * data_world
        self.n_local = self.n_pad // data_world
        self.offset = mesh.coords["data"] * self.n_local \
            if mesh is not None else 0
        self._src_rows = torch.arange(
            self.offset, self.offset + self.n_local, device=dev).clamp(
                max=n - 1)
        self.strategy = strategies[lo]
        self.chunk = chunk
        self.log: List[MetricsLog] = [MetricsLog() for _ in range(E)]
        self.edge_history: List[list] = [[] for _ in range(E)]
        self.delivered_history: List[list] = [[] for _ in range(E)]
        self._comm_bytes = [0] * E
        self.test_batch = to_device(test_batch, dev)
        if params is None:
            params = []
            for seed in spec.seeds[mine]:
                gen = torch.Generator().manual_seed(int(seed))
                params.append(stack(init_fn(gen) for _ in range(n)))
        elif len(params) != E:
            raise ValueError(f"{len(params)} parameter sets for {E} "
                             "experiments")
        else:
            params = params[mine]
        self.params = OrderedDict(
            (k, self._rows(torch.stack([p[k] for p in params]).to(dev)))
            for k in params[0])                   # [E_local, n_local, ...]
        self._opt = optimizer
        self._opt_state = optimizer.init(_flat(self.params))
        self._model_bytes = cfg.model_bytes \
            or stacked_model_bytes(params[0], n)

        self.streams = list(streams)
        self._streams = self.streams[mine]
        self._data, index, self._sizes, _, self._batch_size = \
            stack_streams(self.streams)
        self._index = self._rows(index[mine])
        self._hp = None if not hp_axis else {
            name: None if axis is None else axis[mine]
            for name, axis in (("delta_r", spec.delta_r),
                               ("beta", spec.beta))}

        self.net = net
        self.net_stats: Optional[List[Dict]] = None
        if net is not None:
            # The ring is the whole sweep's depth on every rank, so an
            # experiment contracts the columns it does without a mesh.
            self.net_S = S = net.depth(self._model_bytes)
            self._net = net.experiments(lo, lo + self.E_local)
            up, step = self._net.round_masks(cfg.rounds, n)
            self._net_up = torch.as_tensor(up, device=dev)      # [E, R, n]
            self._net_step = torch.as_tensor(step, device=dev)
            self.hist = OrderedDict(
                (k, v[:, :, None].repeat((1, 1, S) + (1,) * (v.dim() - 2)))
                for k, v in self.params.items())           # [E, n, S, ...]
            self.lhist = torch.full((self.E_local, n, S), -1,
                                    dtype=torch.int32, device=dev)
            self.net_stats = [{"delivered": 0, "dropped": 0,
                               "staleness_hist": np.zeros(S, np.int64),
                               "staleness_sum": 0} for _ in range(E)]

        self.gstate = self.strategy.sweep_graph_state(strategies[mine])
        self.sim = torch.zeros((self.E_local, n, n), dtype=torch.float32,
                               device=dev) if first.needs_sim else None
        self._local_step = make_local_step(loss_fn, optimizer)
        self._evaluate = make_evaluator(eval_fn,
                                        batch_chunk=cfg.eval_batch_chunk)

    @property
    def opt_state(self) -> list:
        """Each of this rank's experiments' optimizer state (its rows under
        a ``data`` split; shared counters shared)."""
        E = self.E_local
        split = _split(self._opt_state, E)
        return [_index_tree(split, e, E) for e in range(E)]

    def experiment_params(self, e: int) -> "OrderedDict[str, torch.Tensor]":
        """Experiment ``e``'s node-stacked parameters: views without a
        mesh; under one, from :meth:`logical_params` (so every rank calls
        it together)."""
        if self.mesh is None:
            return OrderedDict((k, v[e]) for k, v in self.params.items())
        return OrderedDict((k, v[e]) for k, v in self.logical_params().items())

    def logical_params(self) -> "OrderedDict[str, torch.Tensor]":
        """Every experiment's parameters at logical n, ``[E, n, ...]``, the
        same on every rank: one packed gather over the whole mesh (the
        parameters themselves without one)."""
        if self.mesh is None:
            return self.params
        ex, d, E_l, n_l = (self.exp_world, self.data_world, self.E_local,
                           self.n_local)
        keys = list(self.params)
        got = packed_all_gather([self.params[k] for k in keys], ex * d)
        out = OrderedDict()
        for k, g in zip(keys, got):
            tail = g.shape[3:]
            g = g.reshape((ex, d, E_l, n_l) + tail).transpose(1, 2)
            out[k] = g.reshape((self.E, self.n_pad) + tail)[
                :, :self.cfg.n_nodes]
        return out

    # -- layout and collectives ----------------------------------------------

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an ``[E_local, n, ...]`` tensor."""
        if self.data_world == 1:
            return x
        return x.index_select(1, self._src_rows.to(x.device))

    def _logical(self, tree):
        """The logical nodes ``[:, :n]`` of an ``[E_local, n_pad, ...]``
        population."""
        n = self.cfg.n_nodes
        if self.n_pad == n:
            return tree
        return OrderedDict((k, v[:, :n]) for k, v in tree.items())

    def _population(self, stage: Callable = _unstaged):
        """Every node of this rank's experiments, ``[E_local, n_pad,
        ...]``: its own rows on one ``data`` rank, else one packed gather
        of every leaf over the ``data`` group."""
        if self.data_world == 1:
            return self.params

        def gather():
            keys = list(self.params)
            got = packed_all_gather([self.params[k] for k in keys],
                                    self.data_world,
                                    self.mesh.group(("data",)))
            return OrderedDict(
                (k, g.transpose(0, 1).reshape(
                    (self.E_local, self.n_pad) + g.shape[3:]))
                for k, g in zip(keys, got))
        return stage("gather", gather)

    def _gather_experiments(self, tensors: List[torch.Tensor], axis: int
                            ) -> List[torch.Tensor]:
        """Each tensor's ``E_local`` experiments at dim ``axis`` gathered
        over the ``exp`` group into all E, bit for bit (as they are without
        a mesh)."""
        if self.mesh is None:
            return tensors
        got = packed_all_gather(tensors, self.exp_world,
                                self.mesh.group(("exp",)))
        return [g.movedim(0, axis).reshape(
                    t.shape[:axis] + (self.E,) + t.shape[axis + 1:])
                for t, g in zip(tensors, got)]


    # -- one round ----------------------------------------------------------

    def _batch(self, rnd: int) -> Dict[str, torch.Tensor]:
        """Round ``rnd``'s ``[E, n, b, ...]`` batch of this rank's
        experiments and rows: each experiment's own slots, through the
        stacked index tables over the one dataset."""
        take = self._rows(torch.stack([st.slots(rnd).to(self.device)
                                       for st in self._streams]))
        sel = self._index.gather(2, take)
        return {k: v[sel] for k, v in self._data.items()}

    def _step(self, batch):
        """The local step over every experiment's nodes at once:
        ``(params, opt_state)``, the parameters flat ``[E n, ...]``."""
        return self._local_step(_flat(self.params), self._opt_state,
                                _flat(batch))

    def _graph_round(self, rnd: int, population, stage: Callable):
        """The Eq.-3 refresh of ``population``'s logical nodes on its
        cadence, then the stacked graph round: ``(edges [E, n, n], W [E,
        n, n] or None)``."""
        first = self.strategy
        if first.needs_sim and rnd % self.cfg.sim_every == 0:
            self.sim = stage("similarity", lambda: ops.model_pairwise_cosine(
                self._logical(population), experiments=True))
        if self._hp is None:
            fn = lambda: first.stacked_graph_round(self.gstate, rnd,
                                                   self.sim)
        else:
            fn = lambda: first.sweep_graph_round(self.gstate, rnd, self.sim,
                                                 **self._hp)
        self.gstate, edges, w = stage("controller", fn)
        return edges, w

    def round(self, rnd: int, stage: Callable = _unstaged):
        """One round of every experiment; returns the ``[E, n, n]`` edges,
        or :meth:`net_round`'s tuple under a network model.  Each stage
        runs as ``stage(name, fn)`` (batch, local_step, similarity,
        controller, mix), so a caller can time them."""
        if self.net is not None:
            return self.net_round(rnd, stage)
        batch = stage("batch", lambda: self._batch(rnd))
        flat, self._opt_state = stage("local_step",
                                      lambda: self._step(batch))
        self.params = _split(flat, self.E_local)
        full = self._population(stage)
        edges, w = self._graph_round(rnd, full, stage)
        self.params = stage("mix", lambda: self._mix(edges, w, full))
        return edges

    def _mix(self, edges, w, full):
        """This rank's rows of each experiment's ``W full``: the whole W
        on one ``data`` rank (a uniform strategy's from its edges, through
        the masked kernel), else this rank's row block of the embedded W
        over the gathered population."""
        chunk_d = self.cfg.mix_chunk_d
        uniform = self.strategy.uniform_mixing
        if self.data_world == 1:
            if uniform:
                return ops.mix_masked_pytree(edges, full, chunk_d)
            return ops.mix_pytree(w, full, chunk_d)
        w_pad = embed_w(uniform_weights_torch(edges) if uniform else w,
                        self.n_pad)
        a = self.offset
        return ops.mix_pytree(w_pad[:, a:a + self.n_local], full, chunk_d)

    def net_round(self, rnd: int, stage: Callable = _unstaged):
        """One round under the network model: ``(edges [E, n, n],
        delivered [E, n, n], stale_counts [E, S], obs_sum [E])``; stages
        batch, local_step, masks, push, similarity, controller,
        delivery_plan and mix, as the solo engine's ``net_round``."""
        E, n, S, dev = self.E_local, self.cfg.n_nodes, self.net_S, self.device
        r = min(rnd, self.cfg.rounds - 1)
        up, step = self._net_up[:, r], self._net_step[:, r]      # [E, n]
        batch = stage("batch", lambda: self._batch(rnd))

        def local_step():
            old_p, old_o = _flat(self.params), self._opt_state
            new_p, new_o = self._step(batch)
            keep = step.reshape(-1)
            return (net_select(keep, new_p, old_p),
                    net_select(keep, new_o, old_o))

        def push():
            flat_hist = OrderedDict((k, h.reshape((E * n,) + h.shape[2:]))
                                    for k, h in self.hist.items())
            hist, lhist = net_push(_flat(self.params),
                                   (flat_hist, self.lhist.reshape(E * n, S)),
                                   rnd, step.reshape(-1), S)
            return _split(hist, E), lhist.reshape(E, n, S)

        def plan():
            delivered, d_idx, w_stal, stale_counts = net_effective(
                edges, w, up, step, stal, drop, S,
                uniform=self.strategy.uniform_mixing)
            return (delivered, w_stal, stale_counts,
                    net_observed(rnd, self.lhist, d_idx, delivered))

        def mix():
            ring = OrderedDict((k, h.reshape((E, n * S) + h.shape[3:]))
                               for k, h in self.hist.items())
            return ops.mix_pytree(w_stal.reshape(E, n, n * S), ring,
                                  self.cfg.mix_chunk_d)

        flat, self._opt_state = stage("local_step", local_step)
        self.params = _split(flat, E)
        stal, drop = stage("masks", lambda: self._net.round_matrices(
            rnd, n, self._model_bytes, device=dev))
        self.hist, self.lhist = stage("push", push)
        edges, w = self._graph_round(rnd, self.params, stage)
        delivered, w_stal, stale_counts, obs_sum = stage("delivery_plan",
                                                         plan)
        self.params = stage("mix", mix)
        return edges, delivered, stale_counts, obs_sum

    # -- chunks, evaluation, runs -------------------------------------------

    def _run_chunk(self, start: int, end: int) -> np.ndarray:
        """Rounds ``[start, end]`` of every experiment, buffered on the
        device, gathered over ``exp`` and decoded into the per-experiment
        histories at the end; returns the ``[K, E, n, n]`` negotiated
        edges."""
        E, n, k, dev = self.E, self.cfg.n_nodes, end - start + 1, self.device
        E_l = self.E_local
        edges = torch.empty((k, E_l, n, n), dtype=torch.bool, device=dev)
        if self.net is None:
            for i, rnd in enumerate(range(start, end + 1)):
                edges[i] = self.round(rnd)
            edges, = self._gather_experiments([edges], 1)
            edges_np = edges.cpu().numpy()
            sums = edges_np.sum(axis=(0, 2, 3))
            for e in range(E):
                self.edge_history[e].extend(edges_np[:, e])
                self._comm_bytes[e] += int(sums[e]) * self._model_bytes
            return edges_np
        delivered = torch.empty_like(edges)
        stale = torch.empty((k, E_l, self.net_S), dtype=torch.int32,
                            device=dev)
        obs = torch.empty((k, E_l), dtype=torch.int32, device=dev)
        for i, rnd in enumerate(range(start, end + 1)):
            edges[i], delivered[i], stale[i], obs[i] = self.net_round(rnd)
        edges, delivered, stale, obs = self._gather_experiments(
            [edges, delivered, stale, obs], 1)
        edges_np, delivered_np = edges.cpu().numpy(), delivered.cpu().numpy()
        edge_sums = edges_np.sum(axis=(0, 2, 3))
        del_sums = delivered_np.sum(axis=(0, 2, 3))
        stale_sums = stale.cpu().numpy().astype(np.int64).sum(axis=0)
        obs_sums = obs.cpu().numpy().astype(np.int64).sum(axis=0)
        for e in range(E):
            self.edge_history[e].extend(edges_np[:, e])
            self.delivered_history[e].extend(delivered_np[:, e])
            n_del = int(del_sums[e])
            self._comm_bytes[e] += n_del * self._model_bytes
            st = self.net_stats[e]
            st["delivered"] += n_del
            st["dropped"] += int(edge_sums[e]) - n_del
            st["staleness_hist"] += stale_sums[e]
            st["staleness_sum"] += int(obs_sums[e])
        return edges_np

    def staleness_mean(self, e: int) -> float:
        """Experiment ``e``'s mean delivered content staleness in rounds
        (0.0 without a network model)."""
        if self.net_stats is None:
            return 0.0
        return net_staleness_mean(self.net_stats[e])

    def comm_bytes(self, e: int) -> int:
        """Experiment ``e``'s cumulative communication bytes."""
        return self._comm_bytes[e]

    @torch.no_grad()
    def evaluate(self, rnd: int, edges: np.ndarray) -> List[RoundRecord]:
        """Evaluate every experiment's nodes on the shared test set after
        round ``rnd`` (this rank's experiments one by one on their logical
        parameters, the solo evaluator's bits, then gathered over ``exp``)
        and append one record an experiment (``edges``: the ``[E, n, n]``
        last-round stack)."""
        pop = self._logical(self._population())
        outs = [self._evaluate(OrderedDict((k, v[i]) for k, v in pop.items()),
                               self.test_batch) for i in range(self.E_local)]
        keys = list(outs[0][1])
        got = self._gather_experiments(
            [torch.stack([o[0] for o in outs])]
            + [torch.stack([o[1][k] for o in outs]) for k in keys], 0)
        losses, metrics = got[0].cpu().numpy(), [m.cpu().numpy()
                                                 for m in got[1:]]
        recs = []
        for e in range(self.E):
            rec = make_round_record(
                rnd, losses[e], {k: m[e] for k, m in zip(keys, metrics)},
                self._comm_bytes[e], edges[e])
            self.log[e].add(rec)
            recs.append(rec)
        return recs

    def run(self, progress: Optional[Callable] = None) -> List[MetricsLog]:
        """All ``cfg.rounds`` rounds of every experiment, evaluating at the
        solo engine's boundaries; returns one :class:`MetricsLog` an
        experiment (``progress`` sees each boundary's records)."""
        for start, end in eval_boundaries(self.cfg.rounds,
                                          self.cfg.eval_every):
            s = start
            while True:
                e = end if not self.chunk else min(s + self.chunk - 1, end)
                edges_np = self._run_chunk(s, e)
                if e == end:
                    break
                s = e + 1
            recs = self.evaluate(end, edges_np[-1])
            if progress is not None:
                progress(recs)
        return self.log

    def run_steps(self, rounds: int, chunk: Optional[int] = None) -> None:
        """Throughput mode: ``rounds`` rounds of every experiment in chunks
        of ``chunk``, no evaluation (the fig14 loop)."""
        chunk = chunk or self.chunk or rounds
        start = 0
        while start < rounds:
            end = min(start + chunk, rounds) - 1
            self._run_chunk(start, end)
            start = end + 1


def _index_tree(tree, e: int, E: int):
    """Experiment ``e``'s slice of a :func:`_split` tree."""
    if isinstance(tree, dict):
        return type(tree)((k, _index_tree(v, e, E)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index_tree(v, e, E) for v in tree)
    if tree.dim() == 0 or tree.shape[0] != E:
        return tree
    return tree[e]
