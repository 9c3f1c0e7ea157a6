"""Multi-pod dry run of the zoo's sharding: the port of
``repro.launch.dryrun``, on meta tensors.

For every (architecture x input shape x production mesh) it builds the
step's arguments as meta tensors (``repro_torch.dlrt.distributed``'s
``abstract_*`` helpers and ``launch.shapes.input_specs``: no device, no
host memory for tensors), gives each the reference's sharding
(``train_state_sharding``, ``params_sharding``, ``cache_sharding``, the
inputs as the reference's ``_input_shardings`` lays them out) and records
what one card of the mesh holds:

* ``memory.argument_bytes``: the per-card sum of shard bytes over the
  step's arguments (train: the state and the batch; prefill: the
  parameters and the batch; decode: the parameters, the caches, the
  tokens and ``pos``).  The port's train state has no PRNG key on the
  device (Morph draws from a host generator), so its train records are
  the reference's less its key's 8 bytes;
* ``model_flops_per_chip``: 6 (train) or 2 (prefill, decode) x the active
  parameters x the tokens of a step, over the cards.

The reference's XLA columns (``compile_s``, ``xla_cost_raw``, temp and peak
bytes, ``collectives``, the HLO roofline) come from lowering and compiling
on 512 placeholder devices and from ``launch/hlo_cost.py``'s reading of
the HLO text; torch has no counterpart, so they are left out, as fig9's
HLO columns were.

  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --mesh both --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict

from ..configs import ASSIGNED, get_config
from ..dlrt import distributed as D
from ..optim import sgd
from . import shapes as S
from .mesh import make_production_mesh


def input_shardings(mesh, cfg, n_nodes: int, specs) -> Dict[str, Any]:
    """Each input's sharding: the batch's spec (``batch_sharding``) on its
    leading dims, the rest replicated; a scalar replicated."""
    b_node = specs["tokens"].shape[1]
    base = tuple(D.batch_sharding(mesh, cfg, n_nodes, b_node).spec)
    return {k: (D.replicated(mesh) if len(v.shape) == 0 else
                D.NamedSharding(mesh, D.P(*(base + (None,) * (
                    len(v.shape) - 3)))))
            for k, v in specs.items()}


def per_card_bytes(tree, shardings) -> int:
    """The bytes one card holds of every tensor (or :class:`TensorSpec`)
    of ``tree`` under the matching leaf of ``shardings``; a leaf without a
    shape (Morph's generator, host state) holds none."""
    if isinstance(tree, dict):
        return sum(per_card_bytes(v, shardings[k]) for k, v in tree.items())
    if isinstance(tree, (tuple, list)) and not isinstance(tree, S.TensorSpec):
        return sum(per_card_bytes(v, s) for v, s in zip(tree, shardings))
    if not hasattr(tree, "shape"):
        return 0
    return (math.prod(D.shard_shape(tuple(tree.shape), shardings.spec,
                                    shardings.mesh))
            * tree.dtype.itemsize)


def run_one(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """One record (or a ``skipped`` record with the reason)."""
    cfg0 = get_config(arch)
    spec = S.SHAPES[shape_name]
    skip = S.skip_reason(cfg0, spec)
    if skip:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": skip}
    cfg, n_nodes, window, meta = S.shape_config(cfg0, spec,
                                                multi_pod=multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    specs = S.input_specs(cfg, spec, n_nodes)
    info = {"arch": arch, "shape": shape_name, "n_nodes": n_nodes,
            "multi_pod": multi_pod, "policy": cfg.sharding_policy, **meta}
    inputs = per_card_bytes(specs, input_shardings(mesh, cfg, n_nodes,
                                                   specs))
    if spec.kind == "train":
        # Paper-faithful plain SGD (Alg. 2 l.4), as the reference's.
        state = D.abstract_train_state(cfg, sgd(1e-2), n_nodes)
        args = per_card_bytes(state, D.train_state_sharding(mesh, cfg,
                                                            state))
        info["tokens_per_step"] = (spec.global_batch
                                   * specs["tokens"].shape[-1])
    else:
        params = D.abstract_stacked_params(cfg, n_nodes)
        args = per_card_bytes(params, D.params_sharding(mesh, cfg, params))
        if spec.kind == "prefill":
            info["tokens_per_step"] = (spec.global_batch
                                       * specs["tokens"].shape[-1])
        else:
            clen = S.cache_len(cfg, spec, window)
            cache = D.abstract_cache(cfg, n_nodes,
                                     spec.global_batch // n_nodes, clen)
            args += per_card_bytes(cache, D.cache_sharding(mesh, cfg,
                                                           cache))
            info["cache_len"] = clen
            info["tokens_per_step"] = spec.global_batch
    info["active_params"] = cfg0.active_param_count()
    info["total_params"] = cfg0.param_count()
    info["chips"] = mesh.size
    info["kind"] = spec.kind
    mult = 6 if spec.kind == "train" else 2
    info["model_flops_per_chip"] = (mult * info["active_params"]
                                    * info["tokens_per_step"]) / info["chips"]
    info["memory"] = {"argument_bytes": args + inputs}
    return info


def run(archs, shapes, pods):
    """Every record of ``archs`` x ``shapes`` x ``pods`` (multi_pod
    flags), in that order."""
    return [run_one(a, s, mp) for a in archs for s in shapes for mp in pods]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = list(S.SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]
    records = run(archs, shapes, pods)
    for rec in records:
        tag = (f"{rec['arch']} x {rec['shape']} x "
               f"{'multi' if rec['multi_pod'] else 'single'}-pod")
        if "skipped" in rec:
            print(f"[SKIP] {tag}: {rec['skipped']}", flush=True)
            continue
        gb = rec["memory"]["argument_bytes"] / 1e9
        print(f"[ OK ] {tag}: n={rec['n_nodes']} {rec['policy']} "
              f"arguments {gb:.3f} GB a card model_flops/card "
              f"{rec['model_flops_per_chip']:.4g}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
