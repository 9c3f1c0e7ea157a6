"""Fig. 10 (repo extension): the sharded superstep at 1 against N devices —
the port of ``benchmarks/fig10_sharded.py``, with its workload and
defaults.

    python -m repro_torch.bench.fig10 [--device cuda|cpu] [--devices 1 8]
        [--nodes 100] [--rounds 60] [--chunk 20] [--collective gather|psum]

The tiny-MLP Morph population of fig9's ``compiled`` engine (n = 100,
D = 1,580, k = 3, ``sim_every`` 5, Dirichlet(0.5) shards, a
``DeviceDataStream`` of batch 4 seeded 3) with its node axis sharded over
``d`` ranks (``RunnerConfig(mesh_devices=d, collective=...)``, DESIGN.md
§8).  Each device count runs in ``d`` child processes of one process
group (:func:`repro_torch.launch.start`): NCCL ranks on ``cuda:0 ..
cuda:d-1``, or gloo ranks on the CPU with ``--device cpu`` (each given an
equal share of the host's cores, at least one thread).  Every rank warms
one chunk, then times ``run_steps(rounds, chunk)`` between two
synchronisations; the slowest rank's time is the row's.  Recorded to
``$BENCH_DIR/BENCH_torch_fig10.json``: ``sharded-d<d>/n<n>`` (rounds a
second, with the shape, knobs and rank 0's kernel launches),
``per_round_ms/d<d>_n<n>`` and ``derived/d<d>_over_d<first>_n<n>``.

NCCL refuses two ranks on one card, so on the card a device count above
``torch.cuda.device_count()`` stops the script before any child starts,
printing the reference's ``fig10_error,need_<d>_devices,have_<m>`` and
exiting with status 3.  CPU ranks share the host's cores, so ``--device
cpu`` measures the mechanics of the sharded program (collectives,
padding), not scaling.  The reference's HLO rows have no counterpart.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .. import resolve_device
from . import harness


def build(n: int, devices: int, rounds: int, k: int, collective: str,
          device):
    """The runner of one row on this rank (not run)."""
    from ..core import InGraphMorphStrategy
    from ..data import (DeviceDataStream, dirichlet_partition,
                        make_image_classification, train_test_split)
    from ..dlrt import DecentralizedRunner, RunnerConfig
    from ..models import mlp_loss, mlp_params
    from ..optim import sgd
    rng = np.random.default_rng(0)
    ds = make_image_classification(max(600, n * 20), num_classes=4,
                                   image_size=8, seed=0)
    tr, _ = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, rng)
    return DecentralizedRunner(
        init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05),
        batcher=DeviceDataStream(tr, parts, 4, seed=3, device=device),
        test_batch={"images": tr.images[:64], "labels": tr.labels[:64]},
        strategy=InGraphMorphStrategy(n=n, k=k, view_size=k + 2, seed=0,
                                      device=device),
        cfg=RunnerConfig(n_nodes=n, rounds=rounds, eval_every=10 ** 9,
                         sim_every=5, compiled=True, mesh_devices=devices,
                         collective=collective),
        device=device)


def _rank_main(n: int, devices: int, rounds: int, chunk: int, k: int,
               collective: str, device: str):
    """One rank of one device count: ``(seconds for the timed rounds,
    this rank's kernel launches in them, the shape)``."""
    import torch
    import torch.distributed as dist
    from ..kernels import reset_launches
    # The spawn helper made this rank's card the current one.
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    runner = build(n, devices, rounds, k, collective, dev)
    engine = runner._make_engine()
    try:
        engine.run_steps(chunk, chunk)            # warm caches
        reset_launches()
        harness.synchronize(engine.device)
        dist.barrier()
        t0 = time.perf_counter()
        engine.run_steps(rounds, chunk)
        harness.synchronize(engine.device)
        seconds = time.perf_counter() - t0
        launches = harness.launches()
    finally:
        engine.close()
    return seconds, launches, harness.shape_dict(runner.cfg, runner.params,
                                                 dev.type)


def main(argv=None):
    """Sharded-superstep rows (fig10); returns the records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=20,
                    help="rounds between host decodes")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--collective", default="gather",
                    choices=["gather", "psum"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: NCCL ranks) or cpu (gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch
        have = torch.cuda.device_count()
        for d in args.devices:
            if d > have:
                print(f"fig10_error,need_{d}_devices,have_{have}",
                      file=sys.stderr, flush=True)
                sys.exit(3)
    from ..launch import start

    chunk = min(args.chunk, args.rounds)
    rounds = args.rounds - args.rounds % chunk      # whole chunks only
    bench = harness.Bench("torch_fig10", device.type)
    rps = {}
    for d in args.devices:
        threads = max(1, (os.cpu_count() or 1) // d) \
            if device.type == "cpu" else None
        ranks = start(_rank_main, d, args.nodes, d, rounds, chunk, args.k,
                      args.collective, device.type, device=device.type,
                      threads=threads).join()
        seconds = max(r[0] for r in ranks)
        rps[d] = rounds / seconds
        knobs = {"chunk": chunk, "collective": args.collective,
                 "devices": d, "source": "explicit",
                 "backend": "nccl" if device.type == "cuda" else "gloo",
                 **({"threads_per_rank": threads} if threads else {})}
        bench.record(f"sharded-d{d}/n{args.nodes}", f"{rps[d]:.1f}",
                     rounds_per_sec=rps[d], shape=ranks[0][2], knobs=knobs,
                     launches=ranks[0][1], rounds=rounds)
        bench.record(f"per_round_ms/d{d}_n{args.nodes}",
                     f"{1e3 * seconds / rounds:.2f}",
                     wall_clock_s=seconds / rounds)
    base = args.devices[0]
    for d in args.devices[1:]:
        bench.record(f"derived/d{d}_over_d{base}_n{args.nodes}",
                     f"{rps[d] / rps[base]:.2f}")
    bench.finish()
    return bench.records


if __name__ == "__main__":
    main()
