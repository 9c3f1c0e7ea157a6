"""Paper Fig. 3 / Table I through the port's engines: the GN-LeNet
Morph-versus-baselines contest at n = 50 — the port of
``benchmarks/fig3_accuracy.py``, with its defaults.

    python -m repro_torch.bench.fig3 [--device cuda|cpu] [--seed S]

GN-LeNet (width 8, 16-pixel images: 6,442 parameters a node) on synthetic
CIFAR-like data, Dirichlet(0.1) shards, a device-resident
:class:`~repro_torch.data.DeviceDataStream`, 150 rounds of Morph, Static,
EL-Oracle and fully-connected through the dense engine, then Morph on the
sparse engine.  Rows written to ``$BENCH_DIR/BENCH_torch_fig3_accuracy.json``
(``harness`` schema 1):

* ``curve/<strategy>_n50/r<r>`` — accuracy, loss and inter-node variance
  at each evaluation;
* ``final/<strategy>_n50`` and ``final/morph-sparse_n50``;
* ``conformance/chunk_bitwise_n50`` — a rerun of dense Morph with
  ``mix_chunk_d`` must give the bits of the whole-leaf run, or the script
  raises.  On the CPU the plain mixes take ``mix_chunk_d`` columns at a
  time; on the card the kernels block D themselves and do not read it, so
  there the row checks that two runs give the same bits;
* ``acceptance/morph_ge_baselines_n50`` — 1 when Morph's final accuracy is
  at least Static's and EL-Oracle's (recorded, not raised, as in the
  reference);
* ``derived/morph_minus_static_n50`` and ``derived/morph_minus_el_n50``;
* ``sharded/morph_n50`` (with ``--hlo-devices N``, N > 1, the reference's
  default 2) — the collective bytes of one round of the Morph row through
  the sharded engine under ``collective="psum"`` (:func:`sharded_bytes`):
  N gloo ranks on the host, whatever ``--device``, and the bytes rank 0
  moves through ``torch.distributed`` (:class:`~.harness.CollectiveBytes`:
  each call counted by its largest tensor).  The reference's row is
  XLA's compile-only ``collective_bytes`` of one ``eval_every``-round scan
  (each collective's result bytes, weighted by kind and trip count), so
  the two count the same traffic in other units and over other spans: the
  port's row is the traffic itself, not a number to hold to the
  reference's.

Each final is printed beside the reference's
(``benchmarks/results/BENCH_fig3_accuracy_n50.json``).  The port draws its
own random numbers (``torch.Generator``, not ``jax.random``), so its
finals are another sample of the same experiment, not the reference's
numbers.  On the card the run fixes cuDNN to deterministic algorithms,
so that two runs can give the same bits.
"""
from __future__ import annotations

import argparse
import copy
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_cnn_config
from ..data import (DeviceDataStream, dirichlet_partition,
                    make_image_classification, train_test_split)
from ..dlrt import DecentralizedRunner, RunnerConfig
from ..models import cnn_loss, cnn_params
from ..optim import sgd
from ..launch import spawn
from ..sparse import SparseMorphStrategy
from . import harness
from .common import ExpConfig, make_ingraph_strategy

STRATEGIES = ("morph", "static", "el-oracle", "fully-connected")
# The reference's finals at n = 50, seed 0
# (benchmarks/results/BENCH_fig3_accuracy_n50.json).
REFERENCE = {"morph": 0.4597, "static": 0.3543, "el-oracle": 0.4079,
             "fully-connected": 0.707, "morph-sparse": 0.4482}


def experiment(args, n: int, device):
    """The data every row shares at population ``n``: synthetic data with
    the paper CNN's class and channel counts, Dirichlet(alpha) shards, a
    device stream factory (seed + 3) and the test batch."""
    cfg = args.dataset
    ds = make_image_classification(
        args.samples, num_classes=cfg.num_classes,
        image_size=args.image_size, channels=cfg.in_channels,
        noise=args.noise, seed=args.seed)
    tr, te = train_test_split(ds, 0.2, seed=args.seed)
    parts = dirichlet_partition(tr.labels, n, args.alpha,
                                np.random.default_rng(args.seed))
    stream = lambda: DeviceDataStream(tr, parts, args.batch,
                                      seed=args.seed + 3, device=device)
    test = {"images": te.images[:args.test_samples],
            "labels": te.labels[:args.test_samples]}
    return stream, test


def build(args, n: int, name: str, engine: str = "dense",
          mix_chunk_d: Optional[int] = None, compress="none",
          devices: Optional[int] = None, collective: str = "gather"
          ) -> DecentralizedRunner:
    """One row's runner (not run) on ``args.device``; ``devices`` shards
    its nodes over that many ranks of the default process group (the
    sharded engine, under ``collective``)."""
    device = resolve_device(args.device)
    cfg = args.dataset
    if engine == "sparse":
        strategy = SparseMorphStrategy(
            n=n, k=args.k, delta_r=args.delta_r, seed=args.seed,
            sim_row_chunk=args.sim_row_chunk, device=device)
    else:
        strategy = make_ingraph_strategy(
            name, ExpConfig(n_nodes=n, k=args.k, seed=args.seed,
                            delta_r=args.delta_r), device)
    stream, test = experiment(args, n, device)
    return DecentralizedRunner(
        init_fn=lambda g: cnn_params(
            g, in_channels=cfg.in_channels, num_classes=cfg.num_classes,
            image_size=args.image_size, width=args.width),
        loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(args.lr),
        batcher=stream(), test_batch=test, strategy=strategy,
        cfg=RunnerConfig(n_nodes=n, rounds=args.rounds,
                         eval_every=args.eval_every, seed=args.seed,
                         engine=engine, mix_chunk_d=mix_chunk_d,
                         compress=compress, mesh_devices=devices,
                         collective=collective,
                         eval_batch_chunk=args.eval_batch_chunk),
        device=device)


def sharded_round(args, n: int, collective: str, specs) -> Dict[str, int]:
    """One rank of :func:`sharded_bytes`: for each codec spec, the Morph
    row's first round through the sharded engine, and the bytes of the
    collectives this rank made in it."""
    import torch.distributed as dist
    out = {}
    for spec in specs:
        engine = build(args, n, "morph",
                       mix_chunk_d=getattr(args, "mix_chunk_d", None),
                       compress=spec, devices=dist.get_world_size(),
                       collective=collective)._make_engine()
        with harness.CollectiveBytes() as counted:
            engine.run_steps(1)
        out[spec] = counted.total
    return out


def sharded_bytes(args, n: int, collective: str, specs=("none",)
                  ) -> Dict[str, int]:
    """The collective bytes of one round of the Morph row on
    ``args.hlo_devices`` gloo ranks (whatever ``args.device``), as rank 0
    counts them, for each codec spec."""
    ranks = copy.copy(args)
    ranks.device = "cpu"
    return spawn(sharded_round, args.hlo_devices, ranks, n, collective,
                 tuple(specs), device="cpu", threads=1)[0]


def record_sharded(bench: harness.Bench, key: str, args, nbytes: int,
                   **knobs):
    """A ``sharded/`` row: one round's collective bytes (the reference's
    value format) with the knobs it ran under."""
    return bench.record(key, f"{nbytes:.3e}", collective_bytes=nbytes,
                        rounds=1, knobs={"devices": args.hlo_devices,
                                         **knobs})


def params_equal(a: Dict[str, torch.Tensor],
                 b: Dict[str, torch.Tensor]) -> bool:
    """Same leaves with the same bits."""
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def timed_run(runner: DecentralizedRunner):
    """``runner.run()`` and its wall seconds (synchronised on the card)."""
    sync = torch.cuda.synchronize if runner.device.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    log = runner.run()
    sync()
    return log, time.perf_counter() - t0


def record_final(bench: harness.Bench, key: str, runner, log, wall: float,
                 **extra):
    """A ``final/`` row with its fidelity columns."""
    last = log.records[-1]
    return bench.record(
        key, f"{last.mean_accuracy:.4f}", wall_clock_s=wall,
        shape=harness.shape_dict(runner.cfg, runner.params,
                                 runner.device.type),
        fidelity={"accuracy": last.mean_accuracy,
                  "best_accuracy": log.best_accuracy(),
                  "loss": last.mean_loss,
                  "internode_var": last.internode_variance}, **extra)


def run_contest(args, bench: harness.Bench) -> Dict[str, object]:
    """Every row at each ``args.nodes``; returns ``{"finals": {(name, n):
    accuracy}, "bitwise": {n: bool}, "walls": {(name, n): seconds}}``.
    Raises when a chunked rerun is not bitwise the whole-leaf run."""
    finals, walls, bitwise = {}, {}, {}
    for n in args.nodes:
        morph_params = None
        for name in args.strategies:
            runner = build(args, n, name)
            log, wall = timed_run(runner)
            for r in log.records:
                bench.record(
                    f"curve/{name}_n{n}/r{r.rnd}", f"{r.mean_accuracy:.4f}",
                    print_csv=False,
                    fidelity={"accuracy": r.mean_accuracy,
                              "loss": r.mean_loss,
                              "internode_var": r.internode_variance})
            finals[(name, n)], walls[(name, n)] = \
                log.records[-1].mean_accuracy, wall
            record_final(bench, f"final/{name}_n{n}", runner, log, wall)
            if name == "morph":
                morph_params = OrderedDict(runner.params)

        if morph_params is not None:
            chunked = build(args, n, "morph", mix_chunk_d=args.mix_chunk_d)
            _, walls[("morph-chunked", n)] = timed_run(chunked)
            bitwise[n] = params_equal(morph_params, chunked.params)
            bench.record(f"conformance/chunk_bitwise_n{n}", int(bitwise[n]),
                         knobs={"mix_chunk_d": args.mix_chunk_d,
                                "eval_batch_chunk": args.eval_batch_chunk,
                                "device": args.device})
            if not bitwise[n]:
                raise AssertionError(
                    f"chunked mixing (mix_chunk_d={args.mix_chunk_d}) "
                    f"diverged from the whole-leaf path at n={n}")

        runner = build(args, n, "morph", engine="sparse",
                       mix_chunk_d=args.mix_chunk_d)
        log, wall = timed_run(runner)
        finals[("morph-sparse", n)] = log.records[-1].mean_accuracy
        walls[("morph-sparse", n)] = wall
        record_final(bench, f"final/morph-sparse_n{n}", runner, log, wall)

        if {"static", "el-oracle", "morph"} <= set(args.strategies):
            m = finals[("morph", n)]
            ok = m >= finals[("static", n)] and m >= finals[("el-oracle", n)]
            bench.record(f"acceptance/morph_ge_baselines_n{n}", int(ok))
            bench.record(f"derived/morph_minus_static_n{n}",
                         f"{m - finals[('static', n)]:.4f}")
            bench.record(f"derived/morph_minus_el_n{n}",
                         f"{m - finals[('el-oracle', n)]:.4f}")
        for name, want in REFERENCE.items():
            if (name, n) in finals:
                got = finals[(name, n)]
                print(f"{bench.name},reference/{name}_n{n},got={got:.4f} "
                      f"reference={want:.4f} distance={got - want:+.4f}",
                      flush=True)
    return {"finals": finals, "bitwise": bitwise, "walls": walls}


def parse_args(argv=None):
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="cifar10",
                    help="paper CNN preset (configs/paper_cnn.py)")
    ap.add_argument("--nodes", type=int, nargs="+", default=[50])
    # 150 rounds: where the reference found the paper's ordering at n = 50
    # on this synthetic shape.
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--delta-r", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--samples", type=int, default=6000)
    ap.add_argument("--test-samples", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--noise", type=float, default=3.0)
    ap.add_argument("--mix-chunk-d", type=int, default=1024)
    ap.add_argument("--eval-batch-chunk", type=int, default=128)
    ap.add_argument("--sim-row-chunk", type=int, default=None)
    ap.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                    choices=STRATEGIES)
    ap.add_argument("--hlo-devices", type=int, default=2,
                    help="gloo ranks of the sharded/ row (none at 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    args.dataset = get_cnn_config(args.dataset)
    return args


def deterministic(device: str):
    """Fix cuDNN to deterministic algorithms on the card (two runs then
    give the same bits); nothing to do on the CPU."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def main(argv=None):
    """Run the contest and write its JSON; returns the finals."""
    args = parse_args(argv)
    deterministic(args.device)
    bench = harness.Bench("torch_fig3_accuracy",
                          resolve_device(args.device).type)
    out = run_contest(args, bench)
    if args.hlo_devices > 1:
        for n in args.nodes:
            got = sharded_bytes(args, n, "psum")["none"]
            record_sharded(bench, f"sharded/morph_n{n}", args, got,
                           collective="psum", mix_chunk_d=args.mix_chunk_d)
    bench.finish()
    return out["finals"]


if __name__ == "__main__":
    main()
