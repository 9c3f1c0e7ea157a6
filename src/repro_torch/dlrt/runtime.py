"""Decentralized-learning runner — the port of ``repro.dlrt.runtime``.

Per round: a node-batched local SGD step, the strategy's topology, and
row-stochastic mixing; evaluation of every node on the shared test set at
the ``eval_every`` boundaries and after the last round (paper §IV-A4).
Two paths run the rounds (``RunnerConfig.compiled``):

* the round engine (:mod:`repro_torch.dlrt.superstep`, dense or sparse)
  for an in-graph strategy: ``graph_round`` each round, the Eq.-3 cache
  refreshed every ``sim_every`` rounds; with ``RunnerConfig.mesh_devices``
  its node axis sharded over ``torch.distributed`` ranks
  (:mod:`repro_torch.dlrt.sharded`);
* the host loop (:meth:`DecentralizedRunner._round`) for any strategy
  with ``round_edges``, the host protocol and baselines included: the
  strategy sees the stacked models every ``sim_every`` rounds (a host
  numpy copy for a host strategy, the device tensors for an in-graph
  one's adapter; none for a strategy without ``needs_params``) and
  returns numpy ``(edges, W)``, and the mix runs on the runner's device
  through the same grouped kernels as the engine's: the masked mix from
  the edges for a uniform strategy, ``W`` in f32 otherwise.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from .. import resolve_device
from ..core.topology import isolated_nodes
from ..kernels import ops
from ..optim import Optimizer, apply_updates
from ..tree import stack
from .metrics import (MetricsLog, RoundRecord, internode_variance,
                      net_staleness_mean)


@dataclass
class RunnerConfig:
    """The experiment grid of the reference's ``RunnerConfig`` that the
    port's engines read (the reference's Pallas and ``block_d`` knobs have
    no counterpart: the card runs the hand-written kernels)."""
    n_nodes: int                           # population size n
    rounds: int                            # total training rounds
    eval_every: int = 20                   # evaluation cadence (rounds)
    sim_every: int = 1                     # Eq.-3 refresh cadence (rounds)
    seed: int = 0
    # Path: None = the round engine for an in-graph strategy and the host
    # loop otherwise; True = require the engine, False = force the host
    # loop (which drives an in-graph strategy through round_edges).
    compiled: Optional[bool] = None
    # Evaluate at most this many test samples per node-batched forward
    # pass (chunk means recombined by sample-count weights); None = one
    # pass.  Bounds the [n, b_test, ...] activation footprint.
    eval_batch_chunk: Optional[int] = None
    # Engine: "dense" (the [n, n] path), "sparse" (CSR adjacency, O(n k D)
    # mixing; a dense strategy there runs in compat mode) or "auto"
    # (resolved through the repro_torch.tune cache for this run's shape;
    # a sparse-native strategy always runs sparse).
    engine: str = "dense"
    # Compat-mode mixing of a dense strategy under engine="sparse":
    # "exact" mixes as the dense engine does (bitwise), "gather" converts
    # each round's edges to CSR and mixes through the sparse kernel.
    sparse_mix: str = "exact"
    # Per-transfer payload the comm accounting charges without a codec
    # (None: one node's slice of the stacked parameters).
    model_bytes: Optional[int] = None
    # Chunked per-layer exchange: the CPU's plain mixes take the flattened
    # feature axis this many columns at a time, bounding their f32 buffers
    # at O(n mix_chunk_d); the node axis is never split, so the trajectory
    # has the same bits whatever it is (None: whole leaves).  The card's
    # kernels block D themselves and do not read it.
    mix_chunk_d: Optional[int] = None
    # Cap on the rounds the round engine runs between host decodes (int |
    # "auto"); None runs each whole evaluation segment at once.  The
    # trajectory has the same bits whatever it is.  "auto" here, in engine
    # and in compress is resolved through the repro_torch.tune cache for
    # this run's (backend, n, D, devices, net) shape before the engine is
    # built, falling back to the hand-set default when the cache has no
    # entry, so an "auto" run is bit for bit the resolved values passed
    # explicitly (DecentralizedRunner.resolved_knobs says which).
    chunk: Optional[object] = None
    # Compressed gossip (repro_torch.compress): "none", a codec spec such
    # as "int8", "fp8" or "int8+topk0.75", a CompressConfig, or "auto".
    # A codec carries an error-feedback residual and the replicas every
    # peer holds, mixes over the replicas with a consensus correction, and
    # charges the analytic wire bytes; a disabled one is exactly "none".
    compress: object = "none"
    # Dense in-scan network model (repro_torch.netsim.DenseNetwork):
    # latency, staleness, drops, churn and stragglers priced inside every
    # round of the dense engine (DESIGN.md §9).  None = the idealized
    # lockstep network.  Requires the round engine and, when sharded,
    # collective="gather".
    net: Optional[object] = None
    # Sharded round engine (repro_torch.dlrt.ShardedSuperstep, DESIGN.md
    # §8): shard the node axis over this many torch.distributed ranks,
    # one process each (NCCL on the card, gloo on the CPU).  None = the
    # single-device engine; 0 = the initialised process group's world
    # size; N > 0 = exactly N ranks.  Under torchrun (or
    # repro_torch.launch.spawn) the mesh is the default process group;
    # without one, N = 1 starts a one-rank group that the runner destroys
    # after its run, and N > 1 raises.
    mesh_devices: Optional[int] = None
    # Sharded mixing schedule: "gather" (this rank's row block of W
    # applied to the all-gathered population; bit for bit the
    # single-device engine on the CPU), "psum" (partial products summed
    # over the ranks by a reduce-scatter; f32-rounding-close), or "auto"
    # (resolved through the repro_torch.tune cache like the other knobs).
    collective: str = "gather"


ENGINES = ("dense", "sparse")
SPARSE_MIX_MODES = ("exact", "gather")


def resolve_engine(cfg: RunnerConfig, strategy,
                   engine: Optional[str] = None) -> str:
    """The engine ``engine`` (``cfg.engine`` by default) selects for
    ``strategy``, after the reference's checks (``ValueError`` for an
    unknown engine or compat mix or a network model under the sparse
    engine, ``TypeError`` for a sparse-native strategy under the dense
    engine).  Under ``"auto"`` a sparse-native strategy runs sparse; a
    dense strategy's ``"auto"`` is the tuning cache's to resolve
    (:func:`repro_torch.tune.resolve_knobs`) and comes back as it is."""
    sparse_native = bool(getattr(strategy, "sparse", False))
    engine = cfg.engine if engine is None else engine
    if engine == "auto" and sparse_native:
        engine = "sparse"
    if engine not in ENGINES + ("auto",):
        raise ValueError(f"engine={engine!r} not in {ENGINES + ('auto',)}")
    if cfg.sparse_mix not in SPARSE_MIX_MODES:
        raise ValueError(f"sparse_mix={cfg.sparse_mix!r} not in "
                         f"{SPARSE_MIX_MODES}")
    if sparse_native and engine != "sparse":
        raise TypeError(
            f"strategy {getattr(strategy, 'name', strategy)!r} returns CSR "
            "adjacency (sparse=True); select it with "
            "RunnerConfig.engine='sparse'")
    if engine == "sparse" and cfg.net is not None:
        raise ValueError(
            "the sparse engine does not support the dense in-scan "
            "network model yet (ROADMAP: compressed/priced gossip); "
            "use engine='dense' with cfg.net")
    return engine


@contextmanager
def f32_convolutions():
    """A context in which cuDNN convolutions compute in full f32, not TF32
    (torch's default for them), as the reference does.  Only the TF32 flag
    is touched, and the caller's value comes back on exit."""
    cudnn = torch.backends.cudnn
    caller = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = caller


def make_local_step(loss_fn: Callable, optimizer: Optimizer) -> Callable:
    """Node-batched local step: ``vmap(grad(loss))`` over the node axis of
    the parameters and the batch, then the optimizer update, with f32
    convolutions (:func:`f32_convolutions`)."""
    node_grads = vmap(grad(lambda p, b: loss_fn(p, b)[0]))

    def local_step(params, opt_state, batch):
        with f32_convolutions():
            grads = node_grads(dict(params), batch)
        upd, opt_state = optimizer.update(
            OrderedDict((k, grads[k]) for k in params), opt_state, params)
        return apply_updates(params, upd), opt_state
    return local_step


def make_evaluator(eval_fn: Callable,
                   batch_chunk: Optional[int] = None) -> Callable:
    """Every node on the shared test batch: ``(losses [n], metrics dict of
    [n])``, with f32 convolutions (:func:`f32_convolutions`).
    ``batch_chunk`` splits the test batch and recombines the per-chunk
    means by sample-count weights (``eval_fn`` returns means)."""
    def evaluate(params, test):
        with f32_convolutions():
            return _evaluate(params, test)

    def _evaluate(params, test):
        per_node = lambda t: vmap(lambda p: eval_fn(p, t))(dict(params))
        b = next(iter(test.values())).shape[0]
        if batch_chunk is None or b <= batch_chunk:
            return per_node(test)
        losses, metrics = None, None
        for s in range(0, b, batch_chunk):
            size = min(batch_chunk, b - s)
            pl, pm = per_node({k: v[s:s + batch_chunk]
                               for k, v in test.items()})
            wl = pl * (size / b)
            wm = {k: v * (size / b) for k, v in pm.items()}
            losses = wl if losses is None else losses + wl
            metrics = wm if metrics is None \
                else {k: metrics[k] + wm[k] for k in metrics}
        return losses, metrics
    return evaluate


def stacked_model_bytes(params: Dict[str, torch.Tensor], n_nodes: int) -> int:
    """Per-transfer payload: one node's slice of the stacked params."""
    return sum(v.numel() * v.element_size() // n_nodes
               for v in params.values())


def make_round_record(rnd: int, losses, metrics, comm_bytes: int,
                      edges: np.ndarray,
                      isolated: Optional[int] = None) -> RoundRecord:
    """§IV-A4 metrics for one evaluation point.  ``isolated`` overrides
    the count from ``edges`` (the sparse engine counts in-degree-0 rows
    from its CSR mask)."""
    acc = np.asarray(metrics["accuracy"])
    return RoundRecord(
        rnd=rnd,
        mean_accuracy=float(acc.mean()),
        mean_loss=float(np.asarray(losses).mean()),
        internode_variance=internode_variance(acc),
        comm_bytes=comm_bytes,
        isolated=len(isolated_nodes(edges)) if isolated is None
        else isolated,
        per_node_accuracy=acc,
    )


@torch.no_grad()
def evaluate_record(evaluate: Callable, params, test_batch, rnd: int,
                    comm_bytes: int, edges: np.ndarray,
                    isolated: Optional[int] = None) -> RoundRecord:
    """Every node on the test batch after round ``rnd``, as the round's
    :class:`RoundRecord` (:func:`make_round_record`)."""
    losses, metrics = evaluate(params, test_batch)
    return make_round_record(
        rnd, losses.cpu().numpy(),
        {k: v.cpu().numpy() for k, v in metrics.items()}, comm_bytes, edges,
        isolated=isolated)


def _unstaged(stage: str, fn: Callable):
    """The default stage hook of :meth:`DecentralizedRunner._round` and
    :meth:`~repro_torch.dlrt.Superstep.net_round`: run ``fn``."""
    return fn()


def host_params(params: Dict[str, torch.Tensor]
                ) -> "OrderedDict[str, np.ndarray]":
    """Node-stacked parameters copied to the host as numpy arrays (what a
    host strategy's ``round_edges`` reads)."""
    return OrderedDict((k, v.detach().cpu().numpy())
                       for k, v in params.items())


class DecentralizedRunner:
    """D-PSGD over node-stacked parameters with any topology strategy.

    ``init_fn(generator) -> OrderedDict`` makes one node's parameters; the
    runner draws ``n`` of them from a CPU generator seeded with
    ``cfg.seed``, unless ``params`` (node-stacked, e.g. carried over from
    the reference with :func:`repro_torch.tree.params_from_jax`) is given.
    ``batcher`` is a host :class:`~repro_torch.data.StackedBatcher` or
    (round engine only) a :class:`~repro_torch.data.DeviceDataStream`.
    ``run`` picks the round engine or the host loop (the module
    docstring).
    """

    def __init__(self, *, init_fn: Optional[Callable], loss_fn: Callable,
                 eval_fn: Callable, optimizer: Optimizer, batcher,
                 test_batch: Dict[str, np.ndarray], strategy,
                 cfg: RunnerConfig, params=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strategy = strategy
        resolve_engine(cfg, strategy)
        # The knobs the last round engine was built with (repro_torch.tune).
        self.resolved_knobs = None
        self.batcher = batcher
        self.test_batch = to_device(test_batch, self.device)
        if params is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            params = stack(init_fn(gen) for _ in range(cfg.n_nodes))
        self.params = OrderedDict((k, v.to(self.device))
                                  for k, v in params.items())
        self.opt = optimizer
        self.opt_state = optimizer.init(self.params)
        self._loss_fn = loss_fn
        self._eval_fn = eval_fn
        self.log = MetricsLog()
        self.edge_history: list = []
        # The last run's delivered edges and network counters (cfg.net
        # runs only).
        self.delivered_history: list = []
        self.net_stats = None
        # The host loop's state: its cumulative comm bytes.
        self._comm_bytes = 0
        self._model_bytes = cfg.model_bytes \
            or stacked_model_bytes(self.params, cfg.n_nodes)

    # The host loop's round functions, built on its first use (the engine
    # builds its own).
    @cached_property
    def _local_step(self) -> Callable:
        return make_local_step(self._loss_fn, self.opt)

    @cached_property
    def _evaluate(self) -> Callable:
        return make_evaluator(self._eval_fn,
                              batch_chunk=self.cfg.eval_batch_chunk)

    def _knobs(self):
        """``(knobs, engine)``: ``cfg``'s ``"auto"`` knobs resolved through
        the tuning cache for this run's shape
        (:func:`repro_torch.tune.resolve_knobs`), and the engine they
        select; a sparse-native strategy under ``engine="auto"`` runs
        sparse whatever the cache says, as the reference's does."""
        from ..tune import AUTO, resolve_knobs
        knobs = resolve_knobs(self.cfg, self.params)
        engine = knobs.engine
        if self.cfg.engine == AUTO and getattr(self.strategy, "sparse",
                                               False):
            engine = "sparse"
        return knobs, engine

    @property
    def engine(self) -> str:
        """The engine the next round engine runs: ``"dense"`` or
        ``"sparse"``."""
        return self._knobs()[1]

    def _make_engine(self):
        """A round engine on the runner's current state, its ``"auto"``
        knobs resolved (:meth:`_knobs`; the values land in
        ``resolved_knobs``); each ``run()`` builds a fresh one, so the
        codec's replicas and residual restart from the parameters and from
        zero, and the network model's ring from the parameters, as the
        reference's do.  ``cfg.mesh_devices`` makes it the sharded engine
        on a :func:`repro_torch.launch.make_superstep_mesh` mesh (call its
        ``close()`` when done with it; :meth:`run` does)."""
        from .superstep import Superstep
        knobs, engine = self._knobs()
        self.resolved_knobs = knobs
        kw = dict(loss_fn=self._loss_fn, eval_fn=self._eval_fn,
                  optimizer=self.opt, batcher=self.batcher,
                  test_batch=self.test_batch, strategy=self.strategy,
                  cfg=self.cfg, params=self.params,
                  opt_state=self.opt_state, engine=engine,
                  chunk=knobs.chunk, compress=knobs.compress)
        if self.cfg.mesh_devices is None:
            return Superstep(device=self.device, **kw)
        from ..launch import make_superstep_mesh
        from .sharded import ShardedSuperstep
        mesh = make_superstep_mesh(self.cfg.mesh_devices or None,
                                   device=self.device)
        try:
            return ShardedSuperstep(mesh=mesh, collective=knobs.collective,
                                    **kw)
        except BaseException:
            mesh.close()
            raise

    def _round(self, rnd: int, stage: Callable = _unstaged) -> np.ndarray:
        """One host-loop round (reference ``runtime.py`` ``_round``);
        returns its ``[n, n]`` bool edges.

        Each stage runs as ``stage(name, fn)`` (by default just ``fn()``):
        batch, local_step, copy_to_host (on the rounds a host strategy
        reads the parameters), strategy (its ``round_edges``) and mix, so a
        caller can time the round's own code stage by stage."""
        batch = stage("batch", lambda: to_device(self.batcher.next(),
                                                 self.device))
        self.params, self.opt_state = stage("local_step", lambda: (
            self._local_step(self.params, self.opt_state, batch)))
        strategy = self.strategy
        stacked = None
        if rnd % self.cfg.sim_every == 0 \
                and getattr(strategy, "needs_params", True):
            stacked = self.params if getattr(strategy, "in_graph", False) \
                else stage("copy_to_host", lambda: host_params(self.params))
        edges, w = stage("strategy",
                         lambda: strategy.round_edges(rnd, stacked))
        edges = np.array(edges, dtype=bool)
        self.edge_history.append(edges)
        self.params = stage("mix", lambda: self._mix(edges, w))
        self._comm_bytes += int(edges.sum()) * self._model_bytes
        return edges

    def _mix(self, edges: np.ndarray, w: np.ndarray):
        """One grouped mix over every leaf on the runner's device: the
        masked kernel builds a uniform strategy's W from the edges (its f32
        quotients ``1 / d`` are the f32 casts of the host's f64 ones for
        every degree up to 1,000 nodes), the general one takes ``W`` in
        f32."""
        chunk_d = self.cfg.mix_chunk_d
        if getattr(self.strategy, "uniform_mixing", False):
            return ops.mix_masked_pytree(
                torch.as_tensor(edges, device=self.device), self.params,
                chunk_d)
        return ops.mix_pytree(
            torch.as_tensor(np.asarray(w), dtype=torch.float32,
                            device=self.device), self.params, chunk_d)

    def evaluate(self, rnd: int, edges: np.ndarray) -> RoundRecord:
        """Evaluate every node on the shared test set after host-loop round
        ``rnd`` and append the §IV-A4 :class:`RoundRecord`."""
        rec = evaluate_record(self._evaluate, self.params, self.test_batch,
                              rnd, self._comm_bytes, edges)
        self.log.add(rec)
        return rec

    def _check_host_loop(self) -> None:
        """The reference's refusals: what only the round engine runs."""
        if getattr(self.strategy, "sparse", False):
            raise TypeError(
                "sparse-native strategies (CSR graph_round) only run "
                "inside the round engine — leave cfg.compiled unset "
                "(auto) or set it True")
        if self.cfg.net is not None:
            raise TypeError(
                "RunnerConfig.net (the dense in-scan network model) "
                "requires the round engine — use an in-graph strategy")
        if self.cfg.mesh_devices is not None:
            raise TypeError(
                "RunnerConfig.mesh_devices (the sharded superstep) shards "
                "the round engine's node axis; the per-round host loop "
                "runs on one device — use an in-graph strategy, or "
                "mesh_devices=None for the host loop")
        comp = self.cfg.compress
        if comp is not None and comp != "none":
            from ..compress import CompressConfig
            if comp == "auto" or not isinstance(comp, CompressConfig) \
                    or comp.enabled:
                raise TypeError(
                    "RunnerConfig.compress (compressed gossip) carries "
                    "its error-feedback residual in the engine's state "
                    "and requires the round engine — use an in-graph "
                    "strategy, or compress='none' for the per-round host "
                    "loop")
        if hasattr(self.batcher, "draw"):
            raise TypeError(
                "DeviceDataStream draws batches inside the round engine; "
                "the per-round host loop needs a host batcher "
                "(StackedBatcher)")

    def run(self, progress: Optional[Callable[[RoundRecord], None]] = None
            ) -> MetricsLog:
        """Run all ``cfg.rounds`` rounds and return the metrics log
        (``progress`` sees each record).

        ``cfg.compiled=None`` runs an in-graph strategy through the round
        engine and any other through the host loop; True/False force one
        path.  The engine's log replaces the runner's; the host loop
        appends to it and keeps counting comm bytes, as the reference's
        does."""
        compiled = self.cfg.compiled
        if compiled is None:
            compiled = getattr(self.strategy, "in_graph", False)
        if compiled:
            engine = self._make_engine()
            try:
                self.log = engine.run(progress)
                self.params, self.opt_state = engine.logical_state()
            finally:
                engine.close()
            self.edge_history = engine.edge_history
            self.delivered_history = engine.delivered_history
            self.net_stats = engine.net_stats
            self._comm_bytes = engine._comm_bytes
            return self.log
        self._check_host_loop()
        edges = np.zeros((self.cfg.n_nodes, self.cfg.n_nodes), bool)
        for rnd in range(self.cfg.rounds):
            edges = self._round(rnd)
            if rnd % self.cfg.eval_every == 0 \
                    or rnd == self.cfg.rounds - 1:
                rec = self.evaluate(rnd, edges)
                if progress is not None:
                    progress(rec)
        return self.log

    def staleness_mean(self) -> float:
        """Mean delivered content staleness in rounds of the last run (0.0
        without a network model or when nothing was delivered)."""
        return net_staleness_mean(self.net_stats)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``; integer labels become int64
    (the index type of ``gather``)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out
