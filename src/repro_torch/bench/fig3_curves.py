"""Paper Fig. 3: accuracy, loss and inter-node variance over rounds for the
four strategies — the port of ``benchmarks/fig3_curves.py``, with its
defaults, flags and rows.

    python -m repro_torch.bench.fig3_curves [--device cuda|cpu]

Fully-connected, Morph (the message-faithful protocol), EL-Oracle and
Static through :func:`repro_torch.bench.common.run_experiment` (16
nodes, 120 rounds, GN-LeNet width 12 on 16-pixel images, the host loop on
``--device``; Morph's protocol and its f64 similarities on the host; the
masked mix kernel for Morph and EL, the general one for Static and FC).
The headline is panel (c): EL's inter-node variance is orders of
magnitude above Morph's.  Rows ``<strategy>/r<round>`` (mean accuracy, with accuracy,
loss and inter-node variance as fidelity) at every evaluation round and
``derived/el_var_over_morph_var``, written to
``$BENCH_DIR/BENCH_torch_fig3_curves.json``.  The port draws its own
initial weights, so its curves are another sample of the experiment.
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from . import harness
from .common import ExpConfig, run_experiment

STRATEGIES = ("fully-connected", "morph", "el-oracle", "static")


def main(argv=None):
    """Learning-curve rows; returns the final inter-node variance by
    strategy."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    bench = harness.Bench("torch_fig3_curves", device.type)
    final_vars = {}
    for name in STRATEGIES:
        cfg = ExpConfig(n_nodes=args.nodes, rounds=args.rounds)
        log = run_experiment(name, cfg, device=device)
        for r in log.records:
            bench.record(
                f"{name}/r{r.rnd}", f"{r.mean_accuracy:.4f}",
                fidelity={"accuracy": r.mean_accuracy,
                          "loss": r.mean_loss,
                          "internode_var": r.internode_variance})
        final_vars[name] = log.records[-1].internode_variance
    if final_vars["morph"] > 0:
        ratio = final_vars["el-oracle"] / max(final_vars["morph"], 1e-6)
        bench.record("derived/el_var_over_morph_var", f"{ratio:.1f}")
    bench.finish()
    return final_vars


if __name__ == "__main__":
    main()
