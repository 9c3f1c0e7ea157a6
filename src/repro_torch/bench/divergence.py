"""Where two devices' host loops part at Table I's shape: MorphProtocol and
fully-connected, each built twice (``--device`` and the CPU) from the same
seed and stepped in lockstep round by round.

    python -m repro_torch.bench.divergence [--device cuda|cpu]
        [--rounds 150] [--seed 0]

Table I's experiment (16 nodes, GN-LeNet width 12 on 16-pixel images,
Dirichlet(0.1) shards, k = 3): both runners start from the same parameters
and draw the same batches, so only the two devices' local steps round
differently.  Fully-connected, a fixed graph, shows that rounding alone;
Morph's edges can turn on it.  Printed as one JSON line: how far the
models are apart after a few rounds, the number of rounds whose edges
differ, and for Morph the first such round, whether it negotiated, how
far the models and the nodes' direct Eq.-3 measurements were apart just
before it, the receivers whose wanted senders differ, and the protocol's
tallies on both devices.  It records; it asserts nothing.  With
``--device cpu`` both runs are the CPU's and nothing differs.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import resolve_device
from .common import ExpConfig, build_experiment, make_strategy

CHECKPOINTS = (1, 10, 50, 100, 150)


def params_apart(runs) -> float:
    """The largest |difference| of the two runners' parameters."""
    return max(float((runs[0].params[k].cpu() - runs[1].params[k].cpu())
                     .abs().max()) for k in runs[1].params)


def sims_apart(a, b) -> float:
    """The largest |difference| of the direct Eq.-3 measurements the two
    protocols' nodes both hold."""
    return max((abs(x.history.direct[j] - y.history.direct[j])
                for x, y in zip(a.nodes, b.nodes)
                for j in set(x.history.direct) & set(y.history.direct)),
               default=0.0)


def lockstep(name: str, cfg: ExpConfig, device) -> dict:
    """Strategy ``name`` on ``device`` and on the CPU, round by round."""
    runs = [build_experiment(make_strategy(name, cfg), cfg, d)
            for d in (device, torch.device("cpu"))]
    first, differing, drift, before = None, 0, {}, None
    for rnd in range(cfg.rounds):
        if name == "morph" and first is None:
            a, b = (r.strategy for r in runs)
            before = (params_apart(runs), sims_apart(a, b),
                      a.negotiation_due(rnd))
        edges = [r._round(rnd) for r in runs]
        if rnd + 1 in CHECKPOINTS or rnd + 1 == cfg.rounds:
            drift[rnd + 1] = params_apart(runs)
        if np.array_equal(*edges):
            continue
        differing += 1
        if first is None and name == "morph":
            a, b = (r.strategy for r in runs)
            first = {"round": rnd, "negotiation": before[2],
                     "params_max_abs_apart": before[0],
                     "direct_sims_max_abs_apart": before[1],
                     "receivers_wanting_other_senders": [
                         x.nid for x, y in zip(a.nodes, b.nodes)
                         if x.wanted != y.wanted],
                     "edges_differing": int((edges[0] != edges[1]).sum())}
    out = {"params_max_abs_apart_after_round": drift,
           "rounds_with_other_edges": differing}
    if name == "morph":
        a, b = (r.strategy for r in runs)
        out.update(first_divergence=first,
                   control_messages=[a.control_messages, b.control_messages],
                   similarity_floats=[a.similarity_floats,
                                      b.similarity_floats])
    return out


def main(argv=None) -> dict:
    """Both strategies in lockstep; returns ``{strategy: record}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = ExpConfig(rounds=args.rounds, seed=args.seed)
    device = resolve_device(args.device)
    out = {name: lockstep(name, cfg, device)
           for name in ("morph", "fully-connected")}
    print(json.dumps({"divergence": out, "device": str(device),
                      "rounds": args.rounds, "seed": args.seed}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
