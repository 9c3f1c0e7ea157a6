"""Tune the round engine's knobs for one or more shapes and save the cache.

Regenerate the committed card defaults on the card they are for (n = 1000
on equal shards: no Dirichlet(0.5) split of the workload's data gives
every node two samples there):

  PYTHONPATH=src python -m repro_torch.tune --n 16 50 100 --fresh \\
      --out src/repro_torch/tune/cuda_default.json
  PYTHONPATH=src python -m repro_torch.tune --n 1000 --shards equal \\
      --out src/repro_torch/tune/cuda_default.json

The output file is merged over (same-shape entries replaced, other
shapes kept), so caches accumulate across cards and populations;
``--fresh`` starts empty.  The reference's ``--include-pallas`` has no
counterpart: every kernel here is the hand-written CUDA one, with no
alternative path to time.  Its ``--devices`` is left out: the CLI tunes
one-device shapes (a sharded shape's runs need one process per rank;
``mlp_runner_factory(mesh_devices=...)`` builds them inside each).  Exit
status 0 on success.
"""
from __future__ import annotations

import argparse
import sys

from .. import resolve_device
from .cache import DEFAULT_CACHE_PATH, TuningCache
from .resolve import shape_of
from .space import DEFAULT_CHUNKS, Candidate, candidate_space
from .tuner import tune_into
from .workload import SHARDS, mlp_runner_factory


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, nargs="+", default=[8, 16, 50],
                    help="population sizes to tune (tiny-MLP workload)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--shards", choices=SHARDS, default="dirichlet",
                    help="the workload's shards: Dirichlet(0.5) or equal")
    ap.add_argument("--rounds", type=int, default=32,
                    help="stage-2 timed rounds per survivor")
    ap.add_argument("--probe-rounds", type=int, default=8,
                    help="stage-1 timed rounds per candidate")
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=list(DEFAULT_CHUNKS))
    ap.add_argument("--prune-ratio", type=float, default=2.0)
    ap.add_argument("--keep", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(DEFAULT_CACHE_PATH))
    ap.add_argument("--fresh", action="store_true",
                    help="start from an empty cache instead of merging "
                         "over --out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cache = TuningCache() if args.fresh else TuningCache.load(args.out)
    for n in args.n:
        factory = mlp_runner_factory(n, batch=args.batch,
                                     shards=args.shards, device=device)
        probe = factory(Candidate())
        shape = shape_of(probe.cfg, probe.params)
        cands = candidate_space(shape, chunks=tuple(args.chunks))
        result = tune_into(cache, factory, shape=shape, candidates=cands,
                           rounds=args.rounds,
                           probe_rounds=args.probe_rounds,
                           prune_ratio=args.prune_ratio, keep=args.keep,
                           provenance={"shards": args.shards},
                           verbose=True)
        best = result.best
        print(f"tune,best,{shape.key()},{best.label()},"
              f"{result.seconds_per_round[best] * 1e3:.3f}ms/round",
              flush=True)
    cache.save(args.out)
    print(f"tune,saved,{args.out},{len(cache)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
