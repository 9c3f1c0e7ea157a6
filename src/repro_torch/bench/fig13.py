"""Compressed gossip frontier: accuracy against bytes on the wire — the port
of ``benchmarks/fig13_compress.py``, with its defaults.

    python -m repro_torch.bench.fig13 [--device cuda|cpu] [--seed S]

The fig3 GN-LeNet Morph row (:mod:`repro_torch.bench.fig3`'s builder and
data) at n = 8, 60 rounds, rerun under each codec in ``--compress``
(default ``none, int8, fp8, int8+topk0.75, int8+topk0.25``; the last one
shows where the contest collapses).  Rows written to
``$BENCH_DIR/BENCH_torch_fig13_compress.json`` (``<spec>`` slugged, e.g.
``int8_topk0_25``):

* ``final/<spec>_n8`` — final accuracy;
* ``bytes/<spec>_n8`` — the logged communication bytes, the analytic wire
  bytes of a transfer times the transfers
  (:func:`repro_torch.compress.wire_bytes_tree`);
* ``derived/bytes_ratio_<spec>_n8`` and ``derived/acc_delta_<spec>_n8`` —
  against the ``none`` row;
* ``acceptance/bytes_ge_4x_n8`` — 1 when ``int8+topk0.75`` moves at least
  4x fewer bytes than ``none``;
* ``acceptance/acc_within_2pts_n8`` — 1 when its final accuracy is within
  2 points of ``none``'s.

Left out: the reference's compile-only ``sharded/`` rows, which need the
multi-GPU engine, not yet ported.
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from ..configs import get_cnn_config
from . import harness
from .fig3 import build, deterministic, record_final, timed_run

DEFAULT_SPECS = ("none", "int8", "fp8", "int8+topk0.75", "int8+topk0.25")
STAR = "int8+topk0.75"


def slug(spec: str) -> str:
    """A spec as a record-key fragment (``int8+topk0.25`` ->
    ``int8_topk0_25``)."""
    return spec.replace("+", "_").replace(".", "_")


def run_frontier(args, bench: harness.Bench):
    """Every spec's run; returns ``(finals, bytes)`` by spec."""
    n = args.nodes
    finals, bytes_total = {}, {}
    for spec in args.compress:
        runner = build(args, n, "morph", compress=spec)
        log, wall = timed_run(runner)
        last = log.records[-1]
        finals[spec], bytes_total[spec] = last.mean_accuracy, last.comm_bytes
        record_final(bench, f"final/{slug(spec)}_n{n}", runner, log, wall,
                     knobs={"compress": spec})
        bench.record(f"bytes/{slug(spec)}_n{n}", last.comm_bytes,
                     knobs={"compress": spec})
    if "none" in finals:
        for spec in args.compress:
            if spec == "none":
                continue
            ratio = bytes_total["none"] / bytes_total[spec]
            bench.record(f"derived/bytes_ratio_{slug(spec)}_n{n}",
                         f"{ratio:.2f}")
            bench.record(f"derived/acc_delta_{slug(spec)}_n{n}",
                         f"{finals[spec] - finals['none']:+.4f}")
        if STAR in finals:
            bench.record(f"acceptance/bytes_ge_4x_n{n}",
                         int(bytes_total["none"] / bytes_total[STAR] >= 4.0))
            bench.record(f"acceptance/acc_within_2pts_n{n}",
                         int(finals[STAR] >= finals["none"] - 0.02))
    return finals, bytes_total


def parse_args(argv=None):
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="cifar10")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--delta-r", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=8)
    ap.add_argument("--samples", type=int, default=1500)
    ap.add_argument("--test-samples", type=int, default=288)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--noise", type=float, default=3.0)
    ap.add_argument("--eval-batch-chunk", type=int, default=32)
    ap.add_argument("--sim-row-chunk", type=int, default=None)
    ap.add_argument("--compress", nargs="+", default=list(DEFAULT_SPECS),
                    help="codec specs ('none' anchors the derived and "
                         "acceptance rows)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    args.dataset = get_cnn_config(args.dataset)
    return args


def main(argv=None):
    """Run the frontier and write its JSON; returns the finals."""
    args = parse_args(argv)
    deterministic(args.device)
    bench = harness.Bench("torch_fig13_compress",
                          resolve_device(args.device).type)
    finals, _ = run_frontier(args, bench)
    bench.finish()
    return finals


if __name__ == "__main__":
    main()
