"""Paper Fig. 4 through the port's host loop: best accuracy at several
connectivity levels k — the port of
``benchmarks/fig4_connectivity_levels.py``, with its defaults and flags.

    python -m repro_torch.bench.fig4 [--device cuda|cpu]

Paper: Morph stays within 0.4 pp of fully-connected at every k while EL
is highly sensitive at low k (60.9% at k = 3 against 68.0% at k = 14).
Fully-connected, Morph and EL-Oracle at each ``--ks`` (16 nodes, 120
rounds) through the host loop on ``--device``; rows ``<strategy>/k<k>``
and ``derived/gap_to_fc_at_k<k>`` written to
``$BENCH_DIR/BENCH_torch_fig4.json``.
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from . import harness
from .common import ExpConfig, run_experiment, summarize


def main(argv=None):
    """Connectivity-level sweep rows; returns the gaps to FC by k."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--ks", type=int, nargs="+", default=[2, 3, 5])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig4", device.type)
    gaps = {}
    for k in args.ks:
        accs = {}
        for name in ("fully-connected", "morph", "el-oracle"):
            cfg = ExpConfig(n_nodes=args.nodes, rounds=args.rounds, k=k)
            accs[name] = summarize(run_experiment(
                name, cfg, device=device))["best_acc"]
            bench.record(f"{name}/k{k}", f"{accs[name]:.3f}")
        gaps[k] = {"morph": accs["fully-connected"] - accs["morph"],
                   "el": accs["fully-connected"] - accs["el-oracle"]}
    for k, g in gaps.items():
        bench.record(f"derived/gap_to_fc_at_k{k}",
                     f"morph={g['morph']*100:.1f}pp"
                     f" el={g['el']*100:.1f}pp",
                     fidelity={"morph_gap_pp": g["morph"] * 100,
                               "el_gap_pp": g["el"] * 100})
    bench.finish()
    return gaps


if __name__ == "__main__":
    main()
