"""Tuning workloads: the runner factories the tuner drives — the port of
``repro.tune.workload``.

The canonical one is the tiny-MLP Morph population (fig9's and fig12's
workload, D = 1,580) over the same dataset, Dirichlet(0.5) shards and
:class:`~repro_torch.data.StackedBatcher` as
:func:`repro_torch.bench.common.tiny_mlp_experiment`, so the cache entries
it writes are what ``repro_torch.bench.fig9``'s ``compiled-auto`` row
resolves to (the cache key depends only on ``(backend, n, D)``).  At
n = 1000 no Dirichlet(0.5) draw of that 4-class dataset gives every node
the two samples the split asks for (the reference's workload raises
there too), so ``shards="equal"`` takes equal ``array_split`` shards of
the same data instead, as fig12's fixture does.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .space import Candidate

SHARDS = ("dirichlet", "equal")


def mlp_runner_factory(n: int, *, batch: int = 4, rounds: int = 10 ** 9,
                       seed: int = 0, k: int = 3, sim_every: int = 5,
                       net=None, shards: str = "dirichlet", device="cuda",
                       mesh_devices=None) -> Callable[[Candidate], object]:
    """``make_runner(candidate)`` for the tiny-MLP Morph workload at
    population size ``n`` on ``device`` (fig9's configuration:
    ``sim_every=5``, ``view_size=k+2``; ``shards`` picks the module
    docstring's Dirichlet or equal shards).  Each call builds a fresh
    runner from the same seed with the candidate's knobs set concretely;
    a sparse candidate runs the sparse-native Morph control plane with the
    candidate's candidate-set size.  ``mesh_devices`` shards the node axis
    (``RunnerConfig.mesh_devices``) and the candidate's ``collective``
    picks the schedule."""
    from ..bench.common import tiny_mlp_experiment
    from ..core import InGraphMorphStrategy
    from ..data import StackedBatcher
    from ..dlrt import DecentralizedRunner, RunnerConfig
    from ..models import mlp_loss, mlp_params
    from ..optim import sgd
    from ..sparse import SparseMorphStrategy

    if shards not in SHARDS:
        raise ValueError(f"shards={shards!r} not in {SHARDS}")
    if shards == "dirichlet":
        _, _, make_batcher, test = tiny_mlp_experiment(n, seed=seed,
                                                       batch=batch)
    else:
        from ..data import make_image_classification, train_test_split
        ds = make_image_classification(max(600, n * 20), num_classes=4,
                                       image_size=8, seed=seed)
        tr, te = train_test_split(ds, 0.25)
        parts = np.array_split(np.arange(len(tr.labels)), n)
        make_batcher = lambda: StackedBatcher(tr, parts, batch,
                                              seed=seed + 3)
        test = {"images": te.images[:64], "labels": te.labels[:64]}

    def make_runner(cand: Candidate):
        if cand.engine == "sparse":
            strategy = SparseMorphStrategy(n=n, k=k,
                                           candidates=cand.candidates,
                                           delta_r=sim_every, seed=seed,
                                           device=device)
        else:
            strategy = InGraphMorphStrategy(n=n, k=k, view_size=k + 2,
                                            seed=seed, device=device)
        return DecentralizedRunner(
            init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
            optimizer=sgd(0.05), batcher=make_batcher(), test_batch=test,
            strategy=strategy,
            cfg=RunnerConfig(
                n_nodes=n, rounds=rounds, eval_every=10 ** 9,
                sim_every=sim_every, seed=seed, compiled=True,
                chunk=cand.chunk, engine=cand.engine,
                compress=cand.compress, net=net,
                mesh_devices=mesh_devices, collective=cand.collective),
            device=device)

    return make_runner


def sweep_runner_factory(n: int, sweep: int, *, batch: int = 4,
                         seed: int = 0, k: int = 3, sim_every: int = 5,
                         device="cuda", mesh=None
                         ) -> Callable[[Candidate], object]:
    """``make_runner(candidate)`` for the sweep-shaped tiny-MLP Morph
    workload: ``sweep`` seed-varied experiments stacked in one
    :class:`~repro_torch.dlrt.SweepSuperstep`, on ``mesh`` (an ``("exp",
    "data")`` mesh, :func:`repro_torch.launch.make_sweep_mesh`) where
    given.

    The sweep's only knob is ``chunk`` (it runs the dense engine), so
    drive :func:`repro_torch.tune.tune` with an explicit ``TuneShape(...,
    sweep=sweep)`` and a chunk-only candidate list.  Each adapter exposes
    the tuner's surface (``cfg``, ``_make_engine``) and builds a fresh
    sweep engine with the candidate's chunk."""
    from ..bench.common import tiny_mlp_experiment
    from ..core import InGraphMorphStrategy
    from ..data import DeviceDataStream
    from ..dlrt import RunnerConfig, SweepSpec, SweepSuperstep
    from ..models import mlp_loss, mlp_params
    from ..optim import sgd

    tr, parts, _, test = tiny_mlp_experiment(n, seed=seed, batch=batch)
    spec = SweepSpec(seeds=tuple(range(seed, seed + sweep)))
    cfg = RunnerConfig(n_nodes=n, rounds=10 ** 9, eval_every=10 ** 9,
                       sim_every=sim_every, seed=seed)

    class _SweepAdapter:
        """The tuner's surface over a lazily built sweep engine."""

        def __init__(self, chunk: int):
            self.cfg, self.chunk = cfg, chunk

        def _make_engine(self):
            streams = [DeviceDataStream(tr, parts, batch, seed=s,
                                        device=device) for s in spec.seeds]
            strategies = [InGraphMorphStrategy(n=n, k=k, view_size=k + 2,
                                               seed=s, device=device)
                          for s in spec.seeds]
            return SweepSuperstep(
                spec=spec, init_fn=mlp_params, loss_fn=mlp_loss,
                eval_fn=mlp_loss, optimizer=sgd(0.05), streams=streams,
                test_batch=test, strategies=strategies, cfg=cfg,
                mesh=mesh, chunk=self.chunk, device=device)

    return lambda cand: _SweepAdapter(cand.chunk)
