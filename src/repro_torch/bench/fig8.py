"""Fig. 8 (beyond the paper) through the port's event-driven runtime: Morph
against Static and EL-Oracle under LAN, WAN and a flaky WAN with drops, a
mid-run partition, stragglers and churn — the port of
``benchmarks/fig8_async.py``, with its defaults.

    python -m repro_torch.bench.fig8 [--nodes 8] [--rounds 30]
        [--target 0.5] [--seed S] [--device cuda|cpu]

Each (profile, strategy) cell is one :class:`~repro_torch.netsim.AsyncRunner`
run at the reference's scale (synthetic CIFAR-like data, GN-LeNet width 12
on 16-pixel images, Dirichlet(0.1) shards, k = 3, the strategies of
:func:`~repro_torch.bench.common.make_strategy`, ``MorphProtocol`` as
Morph), one virtual second of compute a local step and a 3-second mix
deadline.  Local steps, evaluation and lockstep mixes run on ``--device``;
events, the protocol and the per-node mixes on the host.  Rows
``<profile>/<strategy>/<metric>`` (final accuracy and inter-node variance,
virtual seconds, time to ``--target`` accuracy, mean staleness, model and
control bytes, dropped messages, peak in flight, nodes down at the end)
are printed as ``torch_fig8,<key>,<value>`` and written to
``$BENCH_DIR/BENCH_torch_fig8.json`` (``harness`` schema 1).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from .. import resolve_device
from ..data import (StackedBatcher, dirichlet_partition,
                    make_image_classification, train_test_split)
from ..models import cnn_loss, cnn_params
from ..netsim import (AsyncConfig, AsyncRunner, FaultConfig, FaultModel,
                      profiles)
from ..optim import sgd
from . import harness
from .common import ExpConfig, add_scale_args, make_strategy

PROFILES = ("lan", "wan", "flaky-wan")
STRATEGIES = ("morph", "static", "el-oracle")
MIX_TIMEOUT_S = 3.0


def network(name: str, n: int, horizon_s: float, seed: int):
    """The ``(profile, fault model)`` of one fig8 regime: LAN and WAN
    without faults; flaky-WAN with a half/half partition at 0.3 of the
    horizon for 0.15 of it, a quarter of the nodes straggling 2x and a
    quarter churning (no crashes, mean outage horizon / 8, fault seed
    ``seed + 1``)."""
    if name == "lan":
        return profiles.lan(seed), FaultModel.none(n)
    if name == "wan":
        return profiles.wan(seed), FaultModel.none(n)
    if name == "flaky-wan":
        prof = profiles.flaky_wan(n, partition_at=horizon_s * 0.3,
                                  partition_len=horizon_s * 0.15,
                                  seed=seed)
        faults = FaultModel(FaultConfig(
            straggler_fraction=0.25, straggler_slowdown=2.0,
            churn_fraction=0.25, crash_fraction=0.0,
            mean_downtime_s=horizon_s / 8.0, horizon_s=horizon_s,
            seed=seed + 1), n)
        return prof, faults
    raise ValueError(name)


def build_async(strategy, cfg: ExpConfig, device="cuda", profile=None,
                faults=None,
                mix_timeout_s: Optional[float] = MIX_TIMEOUT_S
                ) -> AsyncRunner:
    """The event-driven runner of one experiment at ``cfg``'s scale on
    ``device`` (:func:`~repro_torch.bench.common.build_experiment`'s data,
    model and host batcher; one virtual second of compute a step), not
    run."""
    rng = np.random.default_rng(cfg.seed)
    ds = make_image_classification(
        cfg.n_samples, num_classes=cfg.num_classes,
        image_size=cfg.image_size, noise=cfg.noise, seed=cfg.seed)
    tr, te = train_test_split(ds, 0.2, seed=cfg.seed)
    parts = dirichlet_partition(tr.labels, cfg.n_nodes, cfg.alpha, rng)
    return AsyncRunner(
        init_fn=lambda g: cnn_params(
            g, in_channels=3, num_classes=cfg.num_classes,
            image_size=cfg.image_size, width=cfg.width),
        loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(cfg.lr),
        batcher=StackedBatcher(tr, parts, cfg.batch, seed=cfg.seed),
        test_batch={"images": te.images[:512], "labels": te.labels[:512]},
        strategy=strategy,
        cfg=AsyncConfig(n_nodes=cfg.n_nodes, rounds=cfg.rounds,
                        eval_every=cfg.eval_every, compute_time_s=1.0,
                        mix_timeout_s=mix_timeout_s, seed=cfg.seed),
        profile=profile, faults=faults, device=device)


def run_async(strategy_name: str, profile_name: str, cfg: ExpConfig,
              device="cuda"):
    """One fig8 cell run at ``cfg``'s scale on ``device``; returns the
    runner and its wall-clock log."""
    profile, faults = network(profile_name, cfg.n_nodes, cfg.rounds * 1.0,
                              cfg.seed)
    runner = build_async(make_strategy(strategy_name, cfg), cfg, device,
                         profile, faults)
    return runner, runner.run()


def main(argv=None):
    """Asynchronous-gossip comparison rows; returns each cell's final
    accuracy by ``<profile>/<strategy>``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_scale_args(ap, nodes=8, rounds=30)
    ap.add_argument("--target", type=float, default=0.5,
                    help="accuracy for the time-to-accuracy metric")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig8", device.type)
    results = {}
    for profile_name in PROFILES:
        for strategy_name in STRATEGIES:
            cfg = ExpConfig(n_nodes=args.nodes, rounds=args.rounds,
                            eval_every=max(args.rounds // 6, 1),
                            seed=args.seed)
            runner, log = run_async(strategy_name, profile_name, cfg,
                                    device)
            last = log.last()
            stats = runner.transport.stats
            tta = log.time_to_accuracy(args.target)
            key = f"{profile_name}/{strategy_name}"
            rows = {
                "final_acc": f"{last.mean_accuracy:.4f}",
                "internode_var": f"{last.internode_variance:.4f}",
                "virtual_s": f"{last.t:.2f}",
                "time_to_acc": f"{tta:.2f}" if tta is not None else "nan",
                "staleness_mean": f"{log.staleness_mean():.3f}",
                "model_mbytes": f"{last.model_bytes / 1e6:.2f}",
                "control_kbytes": f"{last.control_bytes / 1e3:.2f}",
                "dropped_msgs": stats.dropped,
                "peak_in_flight": stats.peak_in_flight,
                "dead_at_end": last.dead,
            }
            for metric, value in rows.items():
                bench.record(f"{key}/{metric}", value)
            results[key] = last.mean_accuracy
    bench.finish()
    return results


if __name__ == "__main__":
    main()
