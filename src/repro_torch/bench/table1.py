"""Paper Table I through the port's host loop: best accuracy per strategy
at the reference's scale — the port of ``benchmarks/table1_accuracy.py``,
with its defaults and flags.

    python -m repro_torch.bench.table1 [--device cuda|cpu] [--seed S]

16 nodes, 150 rounds, GN-LeNet width 12 on 16-pixel synthetic CIFAR-like
images, Dirichlet(0.1) shards, k = 3: fully-connected, Morph (the
message-faithful protocol), EL-Oracle and Static, each through
``DecentralizedRunner``'s host loop (local steps, evaluation and mixing on
``--device``; Morph's protocol on the host).  Paper (CIFAR-10, 100 nodes,
k = 3): FC 69.3 > Morph 68.9 > EL 60.8 ~ Static 61.5; the claim held here
is the ordering and Morph's gap to FC.  Rows written to
``$BENCH_DIR/BENCH_torch_table1.json`` (``harness`` schema 1):
``<strategy>/acc`` (mean over ``--seeds`` seeds from ``--seed`` of the
best accuracy; variance and comm GB as fidelity), the reference's three
``derived/`` ratios, and ``derived/ordering``, the strategies by accuracy.
Each accuracy is printed beside the reference's own run at seed 0
(:data:`REFERENCE`).  The port draws its own initial weights, so its rows
are another sample of the same experiment, held by their spread over
seeds, not by a tolerance.
"""
from __future__ import annotations

import argparse
import json

from .. import resolve_device
from . import harness
from .common import ExpConfig, run_experiment, summarize

STRATEGIES = ("fully-connected", "morph", "el-oracle", "static")
# CPU, reference: ``python -m benchmarks.table1_accuracy`` at its defaults
# (seed 0) with JAX on a CPU host.
REFERENCE = {
    "fully-connected": {"acc": 0.740234375, "var": 0.0,
                        "comm_gb": 1.736352},
    "morph": {"acc": 0.5335693359375, "var": 30.962080001831055,
              "comm_gb": 0.34630576},
    "el-oracle": {"acc": 0.5198974609375, "var": 56.31074523925781,
                  "comm_gb": 0.3472704},
    "static": {"acc": 0.407470703125, "var": 42.466522216796875,
               "comm_gb": 0.3472704},
}


def ordering(rows) -> str:
    """The strategies by accuracy, best first (``a>b>c>d``)."""
    return ">".join(sorted(rows, key=lambda name: -rows[name]["acc"]))


def main(argv=None):
    """Table I rows; returns ``{strategy: {"acc", "var", "comm_gb"}}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0, help="first seed")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = {}
    for name in STRATEGIES:
        accs, variances, comm = [], [], []
        for seed in range(args.seed, args.seed + args.seeds):
            cfg = ExpConfig(n_nodes=args.nodes, rounds=args.rounds,
                            seed=seed)
            s = summarize(run_experiment(name, cfg, progress=args.progress,
                                         device=device))
            accs.append(s["best_acc"])
            variances.append(s["internode_var"])
            comm.append(s["comm_bytes"])
        rows[name] = {"acc": sum(accs) / len(accs),
                      "var": sum(variances) / len(variances),
                      "comm_gb": sum(comm) / len(comm) / 1e9}

    bench = harness.Bench("torch_table1", device.type)
    print(f"\ntable1,{'strategy':>16}, acc,   var,   comm_GB")
    for name, r in rows.items():
        print(f"table1,{name:>16},{r['acc']:.3f},{r['var']:6.2f},"
              f"{r['comm_gb']:8.3f}")
        bench.record(f"{name}/acc", f"{r['acc']:.3f}", print_csv=False,
                     fidelity={"acc": r["acc"], "var": r["var"],
                               "comm_gb": r["comm_gb"]})
    morph, el = rows["morph"]["acc"], rows["el-oracle"]["acc"]
    fc, static = rows["fully-connected"]["acc"], rows["static"]["acc"]
    bench.record("derived/morph_over_el", f"{morph / max(el, 1e-9):.3f}")
    bench.record("derived/morph_gap_to_fc_pp", f"{(fc - morph) * 100:.2f}")
    bench.record("derived/morph_over_static",
                 f"{morph / max(static, 1e-9):.3f}")
    bench.record("derived/ordering", ordering(rows))
    for name, want in REFERENCE.items():
        got = rows[name]["acc"]
        print(f"{bench.name},reference/{name},got={got:.4f} "
              f"reference={want['acc']:.4f} distance={got - want['acc']:+.4f}",
              flush=True)
    print(f"{bench.name},reference/ordering,{ordering(REFERENCE)}",
          flush=True)
    bench.finish()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
