"""Fig. 14 (repo extension) through the port: the sweep farm — the port of
``benchmarks/fig14_sweep.py``, with its defaults.

    python -m repro_torch.bench.fig14 [--nodes 6] [--rounds 24]
        [--seeds 16] [--profiles ideal wan]
        [--strategies morph static el-oracle] [--chunk 1]
        [--timing-rounds 24] [--timing-repeats 3] [--device cuda|cpu]

One :class:`~repro_torch.dlrt.SweepSuperstep` runs ``E = seeds x
profiles`` trajectories of each strategy (the tiny MLP of
:func:`~repro_torch.bench.common.tiny_mlp_experiment`, the dense engine,
a :class:`~repro_torch.netsim.SweepNetwork` at ``round_s`` = 1, so every
profile has ring depth 1), and the script holds the headline strategy
(the first) to DESIGN.md §14's two claims:

* bit for bit — every experiment of the sweep against the same
  experiment run alone through the solo engine
  (:class:`~repro_torch.dlrt.Superstep`): parameters, edge history, comm
  bytes (``acceptance/bitwise_vs_singles``);
* faster — one E-wide run against E solo runs of the same rounds, host
  clock around ``run_steps`` (best of ``--timing-repeats``), the device
  synchronised (``sweep/<s>_ms_per_round``, ``seq/<s>_ms_per_round``,
  ``derived/speedup``; ``acceptance/speedup_ge_5x`` is recorded, not
  asserted, as in the reference).

Every strategy's per-experiment final records and their spread land as
``<strategy>/e<i>``, ``<strategy>/agg_mean`` and ``<strategy>/agg_std``.
Rows print as ``torch_fig14,<key>,<value>`` and go to
``$BENCH_DIR/BENCH_torch_fig14.json`` (``harness`` schema 1).  The
reference's HLO-cost columns (``hlo/*`` and each record's ``hlo``) have no
counterpart in eager PyTorch; the JSON says so in ``meta/hlo``.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import DeviceDataStream
from ..dlrt import (DecentralizedRunner, RunnerConfig, SweepSpec,
                    SweepSuperstep)
from ..models import mlp_loss, mlp_params
from ..netsim import DenseNetwork, SweepNetwork, profiles
from ..optim import sgd
from . import harness
from .common import ExpConfig, make_ingraph_strategy, tiny_mlp_experiment


def _strategy(name, args, seed, device):
    return make_ingraph_strategy(name, ExpConfig(
        n_nodes=args.nodes, k=args.k, seed=seed, delta_r=args.delta_r),
        device)


def build_sweep_engine(name, spec, tr, parts, test, nets, args, device):
    """The E-experiment sweep engine for one strategy."""
    streams = [DeviceDataStream(tr, parts, args.batch, seed=s,
                                device=device) for s in spec.seeds]
    cfg = RunnerConfig(n_nodes=args.nodes, rounds=args.rounds,
                       eval_every=args.eval_every, sim_every=args.sim_every)
    return SweepSuperstep(
        spec=spec, init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), streams=streams, test_batch=test,
        strategies=[_strategy(name, args, s, device) for s in spec.seeds],
        cfg=cfg, net=SweepNetwork(nets), chunk=args.chunk, device=device)


def build_single_engine(name, spec, e, tr, parts, test, nets, args, device):
    """Experiment ``e`` of the sweep as a solo engine: the pin's ground
    truth and the sequential timing's unit."""
    s = spec.seeds[e]
    runner = DecentralizedRunner(
        init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05),
        batcher=DeviceDataStream(tr, parts, args.batch, seed=s,
                                 device=device),
        test_batch=test, strategy=_strategy(name, args, s, device),
        cfg=RunnerConfig(n_nodes=args.nodes, rounds=args.rounds,
                         eval_every=args.eval_every,
                         sim_every=args.sim_every, seed=s, net=nets[e]),
        device=device)
    return runner._make_engine()


def snapshot_sweep(sweep):
    """The sweep's state after ``run()`` (parameters, edge history, comm
    bytes), kept for the pin while the timing rounds move the engine."""
    params = {k: v.detach().cpu().clone() for k, v in sweep.params.items()}
    edges = [list(h) for h in sweep.edge_history]
    comm = [sweep.comm_bytes(e) for e in range(sweep.E)]
    return params, edges, comm


def pin_experiment(single, snap, e) -> bool:
    """Experiment ``e`` of the snapshot bit for bit its solo run:
    parameters, edge history, comm bytes."""
    params, edges, comm = snap
    bit = all(torch.equal(single.params[k].cpu(), params[k][e])
              for k in params)
    edges_ok = (len(single.edge_history) == len(edges[e])
                and all(np.array_equal(a, b) for a, b in
                        zip(single.edge_history, edges[e])))
    return bit and edges_ok and single._comm_bytes == comm[e]


def timed_steps(engine, rounds: int, chunk: int, device) -> float:
    """Host seconds of ``rounds`` rounds after one untimed chunk, the
    device synchronised on both sides and garbage collection paused."""
    engine.run_steps(chunk, chunk)
    gc.disable()
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        engine.run_steps(rounds, chunk)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0
    finally:
        gc.enable()


def main(argv=None):
    """Sweep-farm rows: spreads, the bitwise pin, the speedup; returns the
    bench's records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", "--n", dest="nodes", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--eval-every", type=int, default=12)
    ap.add_argument("--seeds", type=int, default=16,
                    help="seed-axis length (seeds 0 .. seeds - 1)")
    ap.add_argument("--profiles", nargs="+", default=["ideal", "wan"],
                    help="network-profile axis (crossed with the seeds)")
    ap.add_argument("--strategies", nargs="+",
                    default=["morph", "static", "el-oracle"],
                    help="the first is pinned and timed")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=1,
                    help="rounds between host decodes")
    ap.add_argument("--sim-every", type=int, default=5)
    ap.add_argument("--delta-r", type=int, default=5)
    ap.add_argument("--timing-rounds", type=int, default=24)
    ap.add_argument("--timing-repeats", type=int, default=3,
                    help="best of this many timed repeats")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig14", device.type)
    spec = SweepSpec.grid(seeds=range(args.seeds), profiles=args.profiles)
    E = len(spec)
    print(f"# fig14: E={E} trajectories ({args.seeds} seeds x "
          f"{len(args.profiles)} profiles), n={args.nodes}, "
          f"rounds={args.rounds}, chunk={args.chunk}", flush=True)
    bench.record("meta/hlo", "none",
                 note="the reference's HLO-cost columns (hlo/* rows, each "
                      "record's hlo) have no counterpart in eager PyTorch")

    tr, parts, _, test = tiny_mlp_experiment(args.nodes, seed=0,
                                             batch=args.batch)
    test = {"images": test["images"][:32], "labels": test["labels"][:32]}
    # round_s = 1 keeps every profile at ring depth 1 (an equal-depth
    # sweep: the staleness clamp is exact).
    nets = [DenseNetwork(profiles.get_profile(spec.profiles[e], args.nodes,
                                              spec.seeds[e]), round_s=1.0)
            for e in range(E)]

    headline = args.strategies[0]
    for name in args.strategies:
        engine = build_sweep_engine(name, spec, tr, parts, test, nets, args,
                                    device)
        d = sum(v.numel() for v in engine.params.values()) \
            // (E * args.nodes)
        shape = {"backend": device.type, "n": args.nodes, "d": int(d),
                 "devices": 1, "net": 1, "sweep": E}
        logs = engine.run()
        harness.sweep_experiment_records(
            bench, name, spec, logs,
            extra_fidelity=lambda e: {
                "staleness_mean": engine.staleness_mean(e)})
        if name != headline:
            continue

        # The sweep is timed before the solo engines exist, so neither
        # side pays for the other's memory.
        T, R = args.timing_rounds, args.timing_repeats
        snap = snapshot_sweep(engine)
        dt_sweep = min(timed_steps(engine, T, args.chunk, device)
                       for _ in range(R))
        singles, mismatches = [], 0
        for e in range(E):
            single = build_single_engine(name, spec, e, tr, parts, test,
                                         nets, args, device)
            single.run_steps(args.rounds, args.chunk)
            if not pin_experiment(single, snap, e):
                mismatches += 1
                print(f"fig14: BITWISE MISMATCH experiment {e} "
                      f"({spec.describe(e)})", file=sys.stderr)
            singles.append(single)
        bench.record("acceptance/bitwise_vs_singles", int(mismatches == 0),
                     fidelity={"experiments": E, "mismatches": mismatches})
        bench.record("acceptance/trajectories", E,
                     fidelity={"ge_32": int(E >= 32)})
        dt_seq = min(sum(timed_steps(s, T, args.chunk, device)
                         for s in singles) for _ in range(R))
        speedup = dt_seq / dt_sweep
        knobs = {"chunk": args.chunk}
        bench.record(f"sweep/{name}_ms_per_round",
                     f"{dt_sweep / T * 1e3:.3f}", wall_clock_s=dt_sweep,
                     rounds_per_sec=T / dt_sweep, shape=shape, knobs=knobs)
        bench.record(f"seq/{name}_ms_per_round", f"{dt_seq / T * 1e3:.3f}",
                     wall_clock_s=dt_seq, shape=shape, knobs=knobs)
        bench.record("derived/speedup", f"{speedup:.2f}",
                     fidelity={"experiments": E, "timing_rounds": T})
        bench.record("acceptance/speedup_ge_5x", int(speedup >= 5.0))
    bench.finish()
    return bench.records


if __name__ == "__main__":
    main()
