"""Fig. 11 (repo extension) through the port: the dense in-scan network
model against the event-driven runtime — the port of
``benchmarks/fig11_fused_net.py``, with its defaults.

    python -m repro_torch.bench.fig11 [--nodes 50 [100 ...]] [--rounds 30]
        [--profiles ideal wan flaky-wan]
        [--strategies morph static el-oracle] [--seed S]
        [--device cuda|cpu]

The same profile x strategy grid (the in-graph strategies of
:func:`~repro_torch.bench.common.make_ingraph_strategy`, the tiny MLP of
:func:`~repro_torch.bench.common.tiny_mlp_experiment`) runs through both
network realizations on the identical profile, fault timeline (fig8's
flaky-WAN mix), strategy seed and data:

* ``fused`` — :class:`~repro_torch.dlrt.DecentralizedRunner` with
  ``RunnerConfig.net = DenseNetwork(profile, round_s=1.0, faults=...)``:
  the lossy, stale round inside the round engine (DESIGN.md §9);
* ``async`` — :class:`~repro_torch.netsim.AsyncRunner`, one message at a
  time on the host event loop, with a 3-second mix deadline.

Reported per cell: rounds a second of both (host clock), their ratio
``fused_over_async``, and the fidelity columns (model-transfer drop
fractions and mean delivered staleness of each realization, and each
final accuracy); ``derived/min_fused_over_async`` names the slowest
cell's ratio.  As in the reference, the ratio is recorded, not asserted.
Rows are printed as ``torch_fig11,<profile>/<strategy>/n<n>/<metric>,
<value>`` and written to ``$BENCH_DIR/BENCH_torch_fig11.json``
(``harness`` schema 1).

The port has no ``run_steps`` and no HLO: the fused side's time is a
second ``run()`` of the runner after an untimed first ``run()`` (which
warms the process and gives the fidelity columns), both with evaluation
only after the last round; the reference's ``hlo`` and ``shape`` columns
are left out.  The async side is timed over its one run, as in the
reference.  Under churn the dense engine counts an edge to a down or
straggling receiver as a drop, where the event-driven runner lets the
node fall behind the virtual clock and deliver later (DESIGN.md §9's
round- against time-normalization), so the fused drop fraction is
expectedly higher under the fault profile.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..dlrt import DecentralizedRunner, RunnerConfig
from ..models import mlp_loss, mlp_params
from ..netsim import (AsyncConfig, AsyncRunner, DenseNetwork, FaultConfig,
                      FaultModel, profiles)
from ..optim import sgd
from . import harness
from .common import (ExpConfig, add_scale_args, make_ingraph_strategy,
                     tiny_mlp_experiment)

PROFILES = ("ideal", "wan", "flaky-wan")
STRATEGIES = ("morph", "static", "el-oracle")
MIX_TIMEOUT_S = 3.0


def network(profile_name: str, n: int, rounds: int, seed: int):
    """The ``(profile, fault model)`` pair both runtimes share — fig8's
    flaky-WAN fault mix (no partition), keyed by the same seeds; no
    faults for the other profiles."""
    horizon = rounds * 1.0
    profile = profiles.get_profile(profile_name, n, seed)
    if profile_name == "flaky-wan":
        faults = FaultModel(FaultConfig(
            straggler_fraction=0.25, straggler_slowdown=2.0,
            churn_fraction=0.25, crash_fraction=0.0,
            mean_downtime_s=horizon / 8.0, horizon_s=horizon,
            seed=seed + 1), n)
    else:
        faults = None
    return profile, faults


def _common_kwargs(strategy_name: str, cfg: ExpConfig, device):
    _, _, batcher, test = tiny_mlp_experiment(cfg.n_nodes, cfg.seed)
    return dict(init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
                optimizer=sgd(0.05), batcher=batcher(), test_batch=test,
                strategy=make_ingraph_strategy(strategy_name, cfg, device),
                device=device)


def build_fused(strategy_name: str, profile_name: str, cfg: ExpConfig,
                device="cuda") -> DecentralizedRunner:
    """The round engine with the dense network model, not run."""
    profile, faults = network(profile_name, cfg.n_nodes, cfg.rounds,
                              cfg.seed)
    return DecentralizedRunner(
        cfg=RunnerConfig(
            n_nodes=cfg.n_nodes, rounds=cfg.rounds, eval_every=10 ** 9,
            seed=cfg.seed,
            net=DenseNetwork(profile, round_s=1.0, faults=faults)),
        **_common_kwargs(strategy_name, cfg, device))


def build_async(strategy_name: str, profile_name: str, cfg: ExpConfig,
                device="cuda") -> AsyncRunner:
    """The event-driven runner on the identical configuration (evaluation
    only after the last round, like the fused side), not run."""
    profile, faults = network(profile_name, cfg.n_nodes, cfg.rounds,
                              cfg.seed)
    return AsyncRunner(
        cfg=AsyncConfig(n_nodes=cfg.n_nodes, rounds=cfg.rounds,
                        eval_every=10 ** 9, compute_time_s=1.0,
                        mix_timeout_s=MIX_TIMEOUT_S, seed=cfg.seed),
        profile=profile, faults=faults,
        **_common_kwargs(strategy_name, cfg, device))


def _synced(fn, device):
    """Host seconds of ``fn()``, the device synchronised on both sides."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def run_fused(strategy_name: str, profile_name: str, cfg: ExpConfig,
              device="cuda"):
    """An untimed first ``run()`` (the fidelity columns are read from it)
    then a timed second one; returns ``(fidelity, seconds)``."""
    runner = build_fused(strategy_name, profile_name, cfg, device)
    runner.run()
    stats = dict(runner.net_stats)
    fidelity = {"total": stats["delivered"] + stats["dropped"],
                "dropped": stats["dropped"],
                "staleness_mean": runner.staleness_mean(),
                "final_acc": runner.log.records[-1].mean_accuracy}
    return fidelity, _synced(runner.run, device)


def run_async(strategy_name: str, profile_name: str, cfg: ExpConfig,
              device="cuda"):
    """One timed event-driven run; returns ``(runner, seconds)``."""
    runner = build_async(strategy_name, profile_name, cfg, device)
    return runner, _synced(runner.run, device)


def run_cell(strategy_name: str, profile_name: str, cfg: ExpConfig,
             device="cuda"):
    """Both realizations of one cell; returns ``(row, async runner)``:
    the row holds both times (``fused_s``, ``async_s``), their ratio
    ``fused_over_async`` and the fidelity columns."""
    fused, t_f = run_fused(strategy_name, profile_name, cfg, device)
    asyn, t_a = run_async(strategy_name, profile_name, cfg, device)
    astats = asyn.transport.stats
    # model transfers only, so the two columns count the same message
    # population (control packets use their own loss stream and are not
    # modelled by the dense engine).
    a_sent = astats.sent_by_kind.get("model", 0)
    a_drop = astats.dropped_by_kind.get("model", 0)
    return {"fused_s": t_f, "async_s": t_a, "fused_over_async": t_a / t_f,
            "fused_drop_frac": fused["dropped"] / max(fused["total"], 1),
            "async_drop_frac": a_drop / max(a_sent, 1),
            "fused_staleness_mean": fused["staleness_mean"],
            "async_staleness_mean": asyn.netlog.staleness_mean(),
            "fused_final_acc": fused["final_acc"],
            "async_final_acc": asyn.log.records[-1].mean_accuracy}, asyn


FIDELITY = (("fused_drop_frac", ".4f"), ("async_drop_frac", ".4f"),
            ("fused_staleness_mean", ".3f"), ("async_staleness_mean", ".3f"),
            ("fused_final_acc", ".4f"), ("async_final_acc", ".4f"))


def main(argv=None):
    """Fused-net against event-driven rows; returns ``fused_over_async``
    by ``<profile>/<strategy>/n<n>``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_scale_args(ap, nodes=50, rounds=30, multi_nodes=True)
    ap.add_argument("--profiles", nargs="+", default=list(PROFILES),
                    choices=list(PROFILES))
    ap.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                    choices=list(STRATEGIES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig11", device.type)
    speedups = {}
    for n in args.nodes:
        for profile_name in args.profiles:
            for strategy_name in args.strategies:
                cfg = ExpConfig(n_nodes=n, rounds=args.rounds,
                                eval_every=max(args.rounds // 3, 1),
                                seed=args.seed)
                row, _ = run_cell(strategy_name, profile_name, cfg, device)
                t_f, t_a = row["fused_s"], row["async_s"]
                fidelity = {m: row[m] for m, _ in FIDELITY}
                key = f"{profile_name}/{strategy_name}/n{n}"
                bench.record(f"{key}/fused_rounds_per_sec",
                             f"{args.rounds / t_f:.1f}",
                             rounds_per_sec=args.rounds / t_f,
                             wall_clock_s=t_f, fidelity=fidelity)
                bench.record(f"{key}/async_rounds_per_sec",
                             f"{args.rounds / t_a:.1f}",
                             rounds_per_sec=args.rounds / t_a,
                             wall_clock_s=t_a)
                bench.record(f"{key}/fused_over_async", f"{t_a / t_f:.1f}",
                             ratio=t_a / t_f)
                for metric, fmt in FIDELITY:
                    bench.record(f"{key}/{metric}",
                                 format(fidelity[metric], fmt))
                speedups[key] = t_a / t_f
    worst = min(speedups, key=speedups.get)
    bench.record("derived/min_fused_over_async",
                 f"{speedups[worst]:.1f} ({worst})")
    bench.finish()
    return speedups


if __name__ == "__main__":
    main()
