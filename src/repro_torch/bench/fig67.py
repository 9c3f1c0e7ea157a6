"""Paper Figs. 6 and 7: isolated nodes (no incoming connection) a round —
the port of ``benchmarks/fig67_isolation.py``, with its defaults, flags
and rows.

    python -m repro_torch.bench.fig67 [--nodes N] [--rounds R] [--ks K ...]

Paper (100 nodes): EL averages 14.1 isolated nodes at k = 3, 0.44 at
k = 7; Morph stays below one at every k; Static is about 0 by
construction.  Protocol only, on the host: EL (``EpidemicStrategy``),
Morph (the message-faithful ``MorphProtocol``), Morph with one slot of
sender slack (``k_out = k + 1``) and Static at k = 3, 5, 7, n = 100, 50
rounds, over fixed random models.  Rows ``<strategy>/k<k>`` (mean
isolated count), ``morph-kout<k+1>/k<k>``, ``deficit/...`` (mean
in-degree deficit below k), the ``derived/`` headline and slack rows,
written to ``$BENCH_DIR/BENCH_torch_fig67.json``.  The port's strategies
draw from numpy as the reference's do, so the rows equal the reference's.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import (EpidemicStrategy, MorphConfig, MorphProtocol,
                    StaticStrategy, in_degrees, isolated_nodes)
from . import harness

# A slack run "helps" only when it beats the tight run by more than this
# (the two follow different matching draw sequences).
NOISE = 0.05


def run_metrics(strategy, rounds: int, n: int, k: int, params):
    """Per-round mean isolated count and mean in-degree deficit below k."""
    iso, deficit = [], []
    for t in range(rounds):
        edges, _ = strategy.round_edges(t, params)
        iso.append(len(isolated_nodes(edges)))
        deficit.append(float(np.maximum(k - in_degrees(edges), 0).mean()))
    return float(np.mean(iso)), float(np.mean(deficit))


def main(argv=None):
    """Isolation rows; returns ``{k: {"el", "morph", "static",
    "morph_deficit", "morph_slack", "morph_slack_deficit"}}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--ks", type=int, nargs="+", default=[3, 5, 7])
    args = ap.parse_args(argv)

    n = args.nodes
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(n, 64)).astype(np.float32)}

    bench = harness.Bench("torch_fig67", "cpu")
    out = {}
    for k in args.ks:
        el, _ = run_metrics(EpidemicStrategy(n=n, k=k, seed=0),
                            args.rounds, n, k, params)
        morph, morph_def = run_metrics(
            MorphProtocol(MorphConfig(n=n, k=k, seed=0)),
            args.rounds, n, k, params)
        slack, slack_def = run_metrics(
            MorphProtocol(MorphConfig(n=n, k=k, k_out=k + 1, seed=0)),
            args.rounds, n, k, params)
        deg = k if (n * k) % 2 == 0 else k + 1
        static, _ = run_metrics(StaticStrategy(n=n, degree=deg, seed=0),
                                args.rounds, n, k, params)
        out[k] = {"el": el, "morph": morph, "static": static,
                  "morph_deficit": morph_def,
                  "morph_slack": slack, "morph_slack_deficit": slack_def}
        for name in ("el", "morph", "static"):
            bench.record(f"{name}/k{k}", f"{out[k][name]:.2f}")
        bench.record(f"morph-kout{k + 1}/k{k}", f"{slack:.2f}")
        bench.record(f"deficit/morph/k{k}", f"{morph_def:.3f}")
        bench.record(f"deficit/morph-kout{k + 1}/k{k}", f"{slack_def:.3f}")
    bench.record("derived/el_isolated_at_k3",
                 f"{out[args.ks[0]]['el']:.2f}")
    bench.record("derived/morph_max_isolated",
                 f"{max(v['morph'] for v in out.values()):.2f}")
    for k, v in out.items():
        bench.record(f"derived/slack_delta_isolated_k{k}",
                     f"{v['morph_slack'] - v['morph']:+.3f}")
        bench.record(f"derived/slack_delta_deficit_k{k}",
                     f"{v['morph_slack_deficit'] - v['morph_deficit']:+.3f}")
    helps_iso = any(v["morph_slack"] < v["morph"] - NOISE
                    for v in out.values())
    helps_def = any(v["morph_slack_deficit"] < v["morph_deficit"] - NOISE
                    for v in out.values())
    bench.record("derived/slack_helps_isolation", int(helps_iso))
    bench.record("derived/slack_helps_indegree_fill", int(helps_def))
    bench.finish()
    return out


if __name__ == "__main__":
    main()
