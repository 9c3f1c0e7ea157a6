"""Fig. 12 (repo extension): dense against sparse engine scaling — the port
of ``benchmarks/fig12_sparse.py``'s wall-clock rows, with its fixture and
defaults.

    python -m repro_torch.bench.fig12 [--device cuda|cpu] [--nodes N ...]

The same tiny-MLP Morph workload (D = 1,580; equal ``array_split`` shards
of a dataset of about two samples a node, a ``DeviceDataStream`` of batch
2 seeded 3, k = 3, ``sim_every`` 5) through both engines:

* ``dense`` — ``InGraphMorphStrategy``: the ``[n, n]`` Gram kernel every
  fifth round, the dense controller and the masked graph-mix kernel (its
  tiled route past 128 nodes), at n = 100 and 1000 (``--dense-max``);
* ``sparse`` — ``SparseMorphStrategy`` under ``engine="sparse"``: ``[n, k]``
  CSR adjacency, gossiped candidates and one CSR mix launch a round, at
  n = 100, 1000 and 10,000 (past ``SPARSE_EDGE_DECODE_MAX`` the engine
  keeps ``(idx, mask)`` pairs, not ``[n, n]`` edges).

Each row times ``run_steps(rounds, rounds)`` between two synchronisations
after one warm call, best of 3 at n <= 200 and of 1 above, and records
``throughput/<engine>_n<n>`` (rounds a second, with the shape, knobs, the
row's kernel launches and peak device memory), ``per_round_ms/...``,
``derived/sparse_over_dense_n<n>`` and ``derived/crossover_n`` (the
smallest n where sparse beats dense: the crossover the tuner's ``engine``
knob resolves per shape), to ``$BENCH_DIR/BENCH_torch_fig12.json``.

The reference's HLO-cost and multi-device rows (``hlo_only/dense_n*``,
``derived/flops_drop_n*``, ``collective/*``, ``derived/collective_drop_n*``)
are XLA costs of compiled and sharded programs; a torch program has no
HLO, and the port runs one device, so nothing is recorded for them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import resolve_device
from . import harness


def fixture(n: int, seed: int = 0):
    """The reference's scalable data fixture: a dataset of about two
    samples a node and equal ``array_split`` shards (every node owns at
    least one sample)."""
    from ..data import make_image_classification, train_test_split
    ds = make_image_classification(max(600, 2 * n), num_classes=4,
                                   image_size=8, seed=seed)
    tr, _ = train_test_split(ds, 0.25)
    parts = np.array_split(np.arange(len(tr.labels)), n)
    return tr, parts


def build(n: int, k: int, engine: str, rounds: int, device="cuda"):
    """The runner of one row (not run)."""
    from ..core import InGraphMorphStrategy
    from ..data import DeviceDataStream
    from ..dlrt import DecentralizedRunner, RunnerConfig
    from ..models import mlp_loss, mlp_params
    from ..optim import sgd
    from ..sparse import SparseMorphStrategy
    tr, parts = fixture(n)
    if engine == "sparse":
        strategy = SparseMorphStrategy(n=n, k=k, delta_r=5, seed=0,
                                       device=device)
    else:
        strategy = InGraphMorphStrategy(n=n, k=k, view_size=k + 2,
                                        delta_r=5, seed=0, device=device)
    return DecentralizedRunner(
        init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05),
        batcher=DeviceDataStream(tr, parts, 2, seed=3, device=device),
        test_batch={"images": tr.images[:64], "labels": tr.labels[:64]},
        strategy=strategy,
        cfg=RunnerConfig(n_nodes=n, rounds=rounds, eval_every=10 ** 9,
                         sim_every=5, compiled=True, engine=engine),
        device=device)


def time_one_dispatch(engine, rounds: int, repeats: int) -> float:
    """Rounds a second of ``run_steps(rounds, rounds)``: one warm call,
    then the best of ``repeats`` calls, each between two
    synchronisations."""
    engine.run_steps(rounds, rounds)
    best = float("inf")
    for _ in range(repeats):
        harness.synchronize(engine.device)
        t0 = time.perf_counter()
        engine.run_steps(rounds, rounds)
        harness.synchronize(engine.device)
        best = min(best, time.perf_counter() - t0)
    return rounds / best


def main(argv=None):
    """Dense against sparse rows; returns the records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[100, 1000, 10000])
    ap.add_argument("--rounds", type=int, default=20,
                    help="rounds a timed call (one run_steps call)")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--dense-max", type=int, default=1000,
                    help="largest n the dense engine is timed at")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig12", device.type)
    rps = {}
    for n in args.nodes:
        repeats = 3 if n <= 200 else 1
        for engine in ("dense", "sparse"):
            if engine == "dense" and n > args.dense_max:
                continue
            harness.reset_peak_memory(device)
            before = harness.launches()
            runner = build(n, args.k, engine, args.rounds, device)
            eng = runner._make_engine()
            r = time_one_dispatch(eng, args.rounds, repeats)
            after = harness.launches()
            rps[(engine, n)] = r
            extra = {}
            peak = harness.peak_memory_bytes(device)
            if peak is not None:
                extra["peak_memory_bytes"] = peak
            bench.record(
                f"throughput/{engine}_n{n}", f"{r:.1f}",
                rounds_per_sec=r,
                shape=harness.shape_dict(runner.cfg, runner.params,
                                         device.type),
                knobs=harness.knobs_dict(runner.resolved_knobs),
                launches={k: after[k] - before[k] for k in after},
                calls=1 + repeats, rounds_per_call=args.rounds, **extra)
            bench.record(f"per_round_ms/{engine}_n{n}", f"{1e3 / r:.2f}",
                         wall_clock_s=1.0 / r)
        if ("dense", n) in rps:
            bench.record(f"derived/sparse_over_dense_n{n}",
                         f"{rps[('sparse', n)] / rps[('dense', n)]:.2f}")
    crossover = next((n for n in sorted(args.nodes)
                      if ("dense", n) in rps
                      and rps[("sparse", n)] > rps[("dense", n)]), None)
    bench.record("derived/crossover_n",
                 str(crossover) if crossover else "none")
    bench.finish()
    return bench.records


if __name__ == "__main__":
    main()
