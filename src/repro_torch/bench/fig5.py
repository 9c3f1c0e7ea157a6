"""Paper Fig. 5 through the port's host loop: Morph's hyperparameter
ablations — the port of ``benchmarks/fig5_ablation.py``, with its
defaults and flags.

    python -m repro_torch.bench.fig5 [--device cuda|cpu]

Left panel: softmax sharpness beta (paper: lower beta converges faster
and more stably).  Right panel: the similarity-evaluation interval
Delta_r (paper: values < 1000 barely matter; very large slows
convergence).  Morph (the message-faithful protocol, 16 nodes, 100 rounds)
through the host loop on ``--device``; rows ``beta/<beta>``,
``delta_r/<delta_r>`` and ``derived/delta_r_acc_spread_pp`` written to
``$BENCH_DIR/BENCH_torch_fig5.json``.
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from . import harness
from .common import ExpConfig, run_experiment, summarize


def main(argv=None):
    """Beta and delta_r ablation rows; returns the best accuracies."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--betas", type=float, nargs="+",
                    default=[5.0, 50.0, 500.0])
    ap.add_argument("--deltas", type=int, nargs="+", default=[1, 5, 25])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig5", device.type)
    out = {"beta": {}, "delta_r": {}}
    for beta in args.betas:
        cfg = ExpConfig(n_nodes=args.nodes, rounds=args.rounds, beta=beta)
        s = summarize(run_experiment("morph", cfg, device=device))
        out["beta"][beta] = s["best_acc"]
        bench.record(f"beta/{beta}", f"{s['best_acc']:.3f}",
                     fidelity={"best_acc": s["best_acc"],
                               "final_var": s["internode_var"]})
    for dr in args.deltas:
        cfg = ExpConfig(n_nodes=args.nodes, rounds=args.rounds,
                        delta_r=dr)
        s = summarize(run_experiment("morph", cfg, device=device))
        out["delta_r"][dr] = s["best_acc"]
        bench.record(f"delta_r/{dr}", f"{s['best_acc']:.3f}",
                     fidelity={"best_acc": s["best_acc"],
                               "final_var": s["internode_var"]})
    spread = max(out["delta_r"].values()) - min(out["delta_r"].values())
    bench.record("derived/delta_r_acc_spread_pp", f"{spread * 100:.2f}")
    bench.finish()
    return out


if __name__ == "__main__":
    main()
