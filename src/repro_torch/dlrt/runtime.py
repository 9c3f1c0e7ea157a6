"""Decentralized-learning runner — the port of the single-device path of
``repro.dlrt.runtime`` (the round engine, dense or sparse, is
:mod:`repro_torch.dlrt.superstep`).

Per round: a node-batched local SGD step, the Eq.-3 similarity refresh
every ``sim_every`` rounds (dense strategies), the strategy's graph
round, and row-stochastic mixing; evaluation of every node on the shared
test set at the ``eval_every`` boundaries and after the last round (paper
§IV-A4).
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from .. import resolve_device
from ..core.topology import isolated_nodes
from ..optim import Optimizer, apply_updates
from ..tree import stack
from .metrics import MetricsLog, RoundRecord, internode_variance


@dataclass
class RunnerConfig:
    """The experiment grid of the reference's ``RunnerConfig`` that the
    single-device engines read."""
    n_nodes: int                           # population size n
    rounds: int                            # total training rounds
    eval_every: int = 20                   # evaluation cadence (rounds)
    sim_every: int = 1                     # Eq.-3 refresh cadence (rounds)
    seed: int = 0
    # Evaluate at most this many test samples per node-batched forward
    # pass (chunk means recombined by sample-count weights); None = one
    # pass.  Bounds the [n, b_test, ...] activation footprint.
    eval_batch_chunk: Optional[int] = None
    # Engine: "dense" (the [n, n] path), "sparse" (CSR adjacency, O(n k D)
    # mixing; a dense strategy there runs in compat mode) or "auto"
    # (sparse for a sparse-native strategy, dense otherwise).
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
    # Compressed gossip (repro_torch.compress): "none", a codec spec such
    # as "int8", "fp8" or "int8+topk0.75", or a CompressConfig.  A codec
    # carries an error-feedback residual and the replicas every peer
    # holds, mixes over the replicas with a consensus correction, and
    # charges the analytic wire bytes; a disabled one is exactly "none".
    compress: object = "none"


ENGINES = ("dense", "sparse")
SPARSE_MIX_MODES = ("exact", "gather")


def resolve_engine(cfg: RunnerConfig, strategy) -> str:
    """The engine ``cfg`` selects for ``strategy``: ``"auto"`` resolved,
    then the reference's checks (``ValueError`` for an unknown engine or
    compat mix, ``TypeError`` for a sparse-native strategy under the dense
    engine)."""
    sparse_native = bool(getattr(strategy, "sparse", False))
    engine = cfg.engine
    if engine == "auto":
        engine = "sparse" if sparse_native else "dense"
    if engine not in ENGINES:
        raise ValueError(f"engine={cfg.engine!r} not in {ENGINES + ('auto',)}")
    if cfg.sparse_mix not in SPARSE_MIX_MODES:
        raise ValueError(f"sparse_mix={cfg.sparse_mix!r} not in "
                         f"{SPARSE_MIX_MODES}")
    if sparse_native and engine != "sparse":
        raise TypeError(
            f"strategy {getattr(strategy, 'name', strategy)!r} returns CSR "
            "adjacency (sparse=True); select it with "
            "RunnerConfig.engine='sparse'")
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


class DecentralizedRunner:
    """D-PSGD over node-stacked parameters with an in-graph strategy.

    ``init_fn(generator) -> OrderedDict`` makes one node's parameters; the
    runner draws ``n`` of them from a CPU generator seeded with
    ``cfg.seed``, unless ``params`` (node-stacked, e.g. carried over from
    the reference with :func:`repro_torch.tree.params_from_jax`) is given.
    ``batcher`` is a host :class:`~repro_torch.data.StackedBatcher` or a
    :class:`~repro_torch.data.DeviceDataStream`.
    """

    def __init__(self, *, init_fn: Optional[Callable], loss_fn: Callable,
                 eval_fn: Callable, optimizer: Optimizer, batcher,
                 test_batch: Dict[str, np.ndarray], strategy,
                 cfg: RunnerConfig, params=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strategy = strategy
        self.engine = resolve_engine(cfg, strategy)
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

    def _make_engine(self):
        """A round engine on the runner's current state; each ``run()``
        builds a fresh one, so the codec's replicas and residual restart
        from the parameters and from zero, as the reference's do."""
        from .superstep import Superstep
        return Superstep(
            loss_fn=self._loss_fn, eval_fn=self._eval_fn,
            optimizer=self.opt, batcher=self.batcher,
            test_batch=self.test_batch, strategy=self.strategy,
            cfg=self.cfg, params=self.params, opt_state=self.opt_state,
            device=self.device)

    def run(self, progress: Optional[Callable[[RoundRecord], None]] = None
            ) -> MetricsLog:
        """Run all ``cfg.rounds`` rounds through the superstep and return
        the metrics log (``progress`` sees each record)."""
        engine = self._make_engine()
        self.log = engine.run(progress)
        self.params, self.opt_state = engine.params, engine.opt_state
        self.edge_history = engine.edge_history
        return self.log


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
