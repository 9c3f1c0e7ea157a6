"""Paper Fig. 2: probability that the communication graph is connected
against (d_s similarity edges, d_r random edges) at n = 100, 1000, 2000 —
the port of ``benchmarks/fig2_connectivity.py``, with its defaults, flags
and rows.

    python -m repro_torch.bench.fig2 [--trials T] [--sizes N ...]

Graph only, on the host (numpy): no training and no card.  The claim is
that d_r = 2 keeps the graph connected with high probability even when the
d_s similarity edges cluster adversarially.  Rows ``n<n>/ds<d_s>/dr<d_r>``
(with their trial count) and ``derived/min_p_connected_at_dr2``, written
to ``$BENCH_DIR/BENCH_torch_fig2.json``; they equal the reference's.
"""
from __future__ import annotations

import argparse

from ..core import connectivity_probability
from . import harness


def main(argv=None):
    """Connectivity-against-view-size rows; returns ``{(n, d_s, d_r):
    probability}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[100, 1000, 2000])
    args = ap.parse_args(argv)

    bench = harness.Bench("torch_fig2", "cpu")
    results = {}
    for n in args.sizes:
        trials = args.trials if n <= 100 else max(args.trials // 4, 10)
        for d_s in (1, 2, 3):
            for d_r in (0, 1, 2, 3):
                p = connectivity_probability(n, d_s, d_r, trials=trials,
                                             seed=0)
                results[(n, d_s, d_r)] = p
                bench.record(f"n{n}/ds{d_s}/dr{d_r}", f"{p:.3f}",
                             trials=trials)
    # The paper's claim: two random edges suffice at every size.
    worst_dr2 = min(v for (n, ds_, dr), v in results.items() if dr >= 2)
    bench.record("derived/min_p_connected_at_dr2", f"{worst_dr2:.3f}")
    bench.finish()
    return results


if __name__ == "__main__":
    main()
