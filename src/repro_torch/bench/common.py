"""Shared harness of the paper-experiment scripts — the port of
``benchmarks/common.py``.

One decentralized-learning experiment = (dataset, partition, strategy,
rounds).  The paper's four strategies are built as §IV-A3 describes
(:func:`make_strategy`: the host protocol and baselines, which
:func:`run_experiment` drives through the runner's host loop), with their
in-graph twins for the round engine (:func:`make_ingraph_strategy`).  The
scale is the reference's: synthetic CIFAR-like data, 16 nodes, GN-LeNet
width 12 on 16-pixel images.  Local steps, evaluation and mixing run on
``device`` (the card unless the caller passes ``"cpu"``); Morph's protocol
runs on the host, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .. import resolve_device
from ..core import (EpidemicStrategy, FullyConnectedStrategy,
                    InGraphEpidemicLocalStrategy, InGraphEpidemicStrategy,
                    InGraphFullyConnectedStrategy, InGraphMorphStrategy,
                    InGraphStaticStrategy, MorphConfig, MorphProtocol,
                    StaticStrategy)
from ..data import (StackedBatcher, dirichlet_partition,
                    make_image_classification, train_test_split)
from ..dlrt import DecentralizedRunner, MetricsLog, RunnerConfig
from ..models import cnn_loss, cnn_params
from ..optim import sgd


@dataclass
class ExpConfig:
    """One paper-experiment configuration (§IV-A scale knobs)."""
    n_nodes: int = 16
    rounds: int = 150
    eval_every: int = 15
    k: int = 3                   # connectivity (paper: 3/7/14)
    alpha: float = 0.1           # Dirichlet non-IID severity
    num_classes: int = 10
    image_size: int = 16
    width: int = 12              # CNN width
    batch: int = 8
    lr: float = 0.05
    n_samples: int = 4000
    noise: float = 3.0           # class overlap: hard enough that
                                 # collaboration under non-IID matters
    seed: int = 0
    beta: float = 500.0
    delta_r: int = 5
    view_extra: int = 2          # |R| random edges (Fig. 2: 2 suffices)


def add_scale_args(ap, *, nodes: int = 16, rounds: int = 150,
                   seed: int = 0, multi_nodes: bool = False):
    """The shared experiment-scale flags (``--nodes``/``--n``,
    ``--rounds``, ``--seed``); ``multi_nodes`` makes ``--nodes`` accept a
    list."""
    kw = dict(type=int, default=nodes, help="population size n")
    if multi_nodes:
        kw.update(nargs="+", default=[nodes])
    ap.add_argument("--nodes", "--n", dest="nodes", **kw)
    ap.add_argument("--rounds", type=int, default=rounds)
    ap.add_argument("--seed", type=int, default=seed)
    return ap


def make_strategy(name: str, cfg: ExpConfig):
    """The paper's §IV-A3 strategy by name, at ``cfg``'s scale: the host
    protocol and baselines."""
    n, k, seed = cfg.n_nodes, cfg.k, cfg.seed
    if name == "static":
        deg = k if (n * k) % 2 == 0 else k + 1
        return StaticStrategy(n=n, degree=deg, seed=seed)
    if name == "fully-connected":
        return FullyConnectedStrategy(n=n)
    if name == "el-oracle":
        return EpidemicStrategy(n=n, k=k, seed=seed, oracle=True)
    if name == "morph":
        return MorphProtocol(MorphConfig(
            n=n, k=k, view_size=k + cfg.view_extra, beta=cfg.beta,
            delta_r=cfg.delta_r, seed=seed))
    raise ValueError(name)


def make_ingraph_strategy(name: str, cfg: ExpConfig, device="cuda"):
    """The in-graph twin of :func:`make_strategy` on ``device``: drivable
    by the round engine and, through ``round_edges``, by the host loop."""
    n, k, seed = cfg.n_nodes, cfg.k, cfg.seed
    if name == "static":
        deg = k if (n * k) % 2 == 0 else k + 1
        return InGraphStaticStrategy(n=n, degree=deg, seed=seed,
                                     device=device)
    if name == "fully-connected":
        return InGraphFullyConnectedStrategy(n=n, device=device)
    if name == "el-oracle":
        return InGraphEpidemicStrategy(n=n, k=k, seed=seed, device=device)
    if name == "el-local":
        return InGraphEpidemicLocalStrategy(n=n, k=k, seed=seed,
                                            view_extra=cfg.view_extra,
                                            device=device)
    if name == "morph":
        return InGraphMorphStrategy(
            n=n, k=k, view_size=k + cfg.view_extra, beta=cfg.beta,
            delta_r=cfg.delta_r, seed=seed, device=device)
    raise ValueError(name)


def tiny_mlp_experiment(n: int, seed: int = 0, batch: int = 4):
    """The shared tiny-MLP fixture: a synthetic dataset sized to the
    population, Dirichlet(0.5) shards, a :class:`StackedBatcher` factory
    and a small test batch."""
    rng = np.random.default_rng(seed)
    ds = make_image_classification(max(600, n * 20), num_classes=4,
                                   image_size=8, seed=seed)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, rng)
    make_batcher = lambda: StackedBatcher(tr, parts, batch, seed=seed + 3)
    test = {"images": te.images[:64], "labels": te.labels[:64]}
    return tr, parts, make_batcher, test


def build_experiment(strategy, cfg: ExpConfig,
                     device="cuda", compiled=None) -> DecentralizedRunner:
    """The runner of one (dataset, partition, strategy) experiment, not
    run: GN-LeNet at ``cfg.width`` on synthetic data, Dirichlet(alpha)
    shards served by a host :class:`StackedBatcher`, 512 test images."""
    rng = np.random.default_rng(cfg.seed)
    ds = make_image_classification(
        cfg.n_samples, num_classes=cfg.num_classes,
        image_size=cfg.image_size, noise=cfg.noise, seed=cfg.seed)
    tr, te = train_test_split(ds, 0.2, seed=cfg.seed)
    parts = dirichlet_partition(tr.labels, cfg.n_nodes, cfg.alpha, rng)
    return DecentralizedRunner(
        init_fn=lambda g: cnn_params(
            g, in_channels=3, num_classes=cfg.num_classes,
            image_size=cfg.image_size, width=cfg.width),
        loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(cfg.lr),
        batcher=StackedBatcher(tr, parts, cfg.batch, seed=cfg.seed),
        test_batch={"images": te.images[:512], "labels": te.labels[:512]},
        strategy=strategy,
        cfg=RunnerConfig(n_nodes=cfg.n_nodes, rounds=cfg.rounds,
                         eval_every=cfg.eval_every, seed=cfg.seed,
                         compiled=compiled),
        device=resolve_device(device))


def run_experiment(strategy_name: str, cfg: ExpConfig,
                   progress: bool = False, device="cuda") -> MetricsLog:
    """Run one experiment end to end with :func:`make_strategy`'s strategy
    through the host loop on ``device``."""
    runner = build_experiment(make_strategy(strategy_name, cfg), cfg,
                              device)
    cb = (lambda r: print(f"  [{strategy_name}] round {r.rnd} "
                          f"acc {r.mean_accuracy:.3f}", flush=True)) \
        if progress else None
    return runner.run(cb)


def summarize(log: MetricsLog) -> Dict[str, float]:
    """Final/best accuracy and comm columns from one metrics log."""
    last = log.records[-1]
    return {
        "final_acc": last.mean_accuracy,
        "best_acc": log.best_accuracy(),
        "final_loss": last.mean_loss,
        "internode_var": last.internode_variance,
        "comm_bytes": last.comm_bytes,
        "mean_isolated": float(np.mean([r.isolated for r in log.records])),
    }
