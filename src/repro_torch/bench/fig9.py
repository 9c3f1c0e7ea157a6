"""Fig. 9 (repo extension): round throughput of the port's engines — the
port of ``benchmarks/fig9_superstep.py``'s four rows, with its defaults.

    python -m repro_torch.bench.fig9 [--device cuda|cpu] [--nodes N ...]

The same Morph workload (the tiny-MLP population of
:func:`repro_torch.bench.common.tiny_mlp_experiment`, batches served from
a ring of 64 pre-drawn stacks so data loading is off the critical path)
at n = 16, 50, 100, k = 3, ``sim_every`` 5, through four engines:

* ``host-protocol`` — the runner's host loop with the message-faithful
  ``MorphProtocol`` (negotiation and similarities on the host, the masked
  mix kernel on ``--device``), timed through ``DecentralizedRunner._round``;
* ``host-ingraph`` — the host loop with ``InGraphMorphStrategy``
  (``compiled=False``): the Gram kernel and the controller on the device,
  the edges copied to the host every round;
* ``compiled`` — the round engine, ``Superstep.run_steps(rounds, chunk)``
  with the hand-set ``--chunk`` (whole chunks only, two warm chunks, best
  of 3, between synchronisations);
* ``compiled-auto`` — the same with ``chunk="auto"``, resolved through the
  tuning cache (``repro_torch.tune``; ``cuda_default.json`` on the card).
  The reference's ``block_d`` and ``collective`` have no knob here.

Host rows warm ``max(rounds // 10, 5)`` rounds and time the rest between
two synchronisations.  Rows ``<engine>/n<n>`` (rounds a second, the row's
kernel launches; shape, resolved knobs and rounds run on the engine rows)
and the three ``derived/`` ratios are
written to ``$BENCH_DIR/BENCH_torch_fig9.json``.  The reference's HLO-cost
columns have no counterpart (a torch program has no HLO).
"""
from __future__ import annotations

import argparse
import time

from .. import resolve_device
from . import harness

ENGINES = ("host-protocol", "host-ingraph", "compiled", "compiled-auto")


class RingBatcher:
    """Pre-drawn stacked batches served round-robin: keeps per-round host
    work out of the throughput measurement for every engine equally."""

    def __init__(self, inner, length: int):
        self.batches = [inner.next() for _ in range(length)]
        self.i = 0

    def next(self):
        """The next per-node batch stack, advancing the ring."""
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b


def build(n: int, strategy, compiled: bool, rounds: int, device="cuda",
          auto: bool = False):
    """The runner of one row (not run); ``auto`` sets ``chunk="auto"``."""
    from ..dlrt import DecentralizedRunner, RunnerConfig
    from ..models import mlp_loss, mlp_params
    from ..optim import sgd
    from .common import tiny_mlp_experiment
    _, _, make_batcher, test = tiny_mlp_experiment(n)
    knobs = dict(chunk="auto") if auto else {}
    return DecentralizedRunner(
        init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=RingBatcher(make_batcher(), 64),
        test_batch=test, strategy=strategy,
        cfg=RunnerConfig(n_nodes=n, rounds=rounds, eval_every=10 ** 9,
                         sim_every=5, compiled=compiled, **knobs),
        device=device)


def make_strategy(engine: str, n: int, k: int, device="cuda"):
    """``MorphProtocol`` for the host-protocol row, in-graph Morph for the
    others."""
    from ..core import InGraphMorphStrategy, MorphConfig, MorphProtocol
    if engine == "host-protocol":
        return MorphProtocol(MorphConfig(n=n, k=k, seed=0))
    return InGraphMorphStrategy(n=n, k=k, view_size=k + 2, seed=0,
                                device=device)


def time_host(runner, rounds: int, warmup: int) -> float:
    """Rounds a second of the host loop's rounds ``warmup .. rounds - 1``
    after ``warmup`` untimed ones."""
    for r in range(warmup):
        runner._round(r)
    harness.synchronize(runner.device)
    t0 = time.perf_counter()
    for r in range(warmup, rounds):
        runner._round(r)
    harness.synchronize(runner.device)
    return (rounds - warmup) / (time.perf_counter() - t0)


def time_compiled(engine, rounds: int, chunk: int, repeats: int = 3) -> float:
    """Rounds a second of ``run_steps`` in whole chunks: two warm chunks,
    then the best of ``repeats`` timed calls."""
    chunk = min(chunk, rounds)
    rounds -= rounds % chunk
    engine.run_steps(2 * chunk, chunk)
    best = float("inf")
    for _ in range(repeats):
        harness.synchronize(engine.device)
        t0 = time.perf_counter()
        engine.run_steps(rounds, chunk)
        harness.synchronize(engine.device)
        best = min(best, time.perf_counter() - t0)
    return rounds / best


def compiled_row(bench, runner, n: int, rounds: int, chunk: int,
                 label: str) -> float:
    """Build, warm and time one round engine; the resolved chunk (an
    ``"auto"`` run's cache entry) takes precedence over ``chunk``."""
    before = harness.launches()
    engine = runner._make_engine()
    chunk = min(runner.resolved_knobs.chunk or chunk, rounds)
    rps = time_compiled(engine, rounds, chunk)
    after = harness.launches()
    bench.record(
        f"{label}/n{n}", f"{rps:.1f}", rounds_per_sec=rps,
        shape=harness.shape_dict(runner.cfg, runner.params,
                                 runner.device.type),
        knobs=dict(harness.knobs_dict(runner.resolved_knobs),
                   timed_chunk=chunk),
        launches={k: after[k] - before[k] for k in after},
        warm_rounds=2 * chunk, rounds_per_call=rounds - rounds % chunk,
        calls=1 + 3)
    return rps


def main(argv=None):
    """Engine throughput rows; returns the records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[16, 50, 100])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--chunk", type=int, default=50,
                    help="rounds a run_steps chunk for the hand-set "
                         "compiled row")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig9", device.type)
    warmup = max(args.rounds // 10, 5)
    for n in args.nodes:
        rps = {}
        for engine in ("host-protocol", "host-ingraph"):
            runner = build(n, make_strategy(engine, n, args.k, device),
                           False, args.rounds, device)
            before = harness.launches()
            rps[engine] = time_host(runner, args.rounds, warmup)
            after = harness.launches()
            bench.record(f"{engine}/n{n}", f"{rps[engine]:.1f}",
                         rounds_per_sec=rps[engine],
                         launches={k: after[k] - before[k] for k in after})
        for label, auto in (("compiled", False), ("compiled-auto", True)):
            runner = build(n, make_strategy(label, n, args.k, device),
                           True, args.rounds, device, auto=auto)
            rps[label] = compiled_row(bench, runner, n, args.rounds,
                                      args.chunk, label)
        bench.record(f"derived/compiled_over_host_protocol_n{n}",
                     f"{rps['compiled'] / rps['host-protocol']:.1f}")
        bench.record(f"derived/compiled_over_host_ingraph_n{n}",
                     f"{rps['compiled'] / rps['host-ingraph']:.1f}")
        bench.record(f"derived/auto_over_default_n{n}",
                     f"{rps['compiled-auto'] / rps['compiled']:.2f}")
    bench.finish()
    return bench.records


if __name__ == "__main__":
    main()
