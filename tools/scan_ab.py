"""Time the selective scan's kernels of one or more trees of this repository
on one card, side by side: the forward as serving launches it (no kept
states), the forward keeping the states the backward reads, and the
backward, at the served shape ``(2, 2048, 16384, 16)`` with apply_mamba's
types (x, b, c bf16; dt f32; dy, dh f32); and one Jamba-1.5-Large Mamba
layer's forward and backward with its peak device memory.

    python tools/scan_ab.py [--reps N] [TREE ...]

Each ``TREE`` is a directory holding ``src/repro_torch`` (default: this
checkout).  Every tree's kernels are built first, all trees at once, under
``TREE/build/``; then each is timed in an interpreter of its own, in the
order given, so ``A B B A`` brackets drift.  The inputs, the timing and
the layer are this checkout's ``chip_smoke.py`` (``served_backward_sets``,
``device_ms``: calls rotating through three input sets captured in one
CUDA graph and replayed between CUDA events; ``jamba_layer_step``, phase
17(d)), run on each tree's package.  ``backward_kernels_ms`` splits one
backward call into its launches by ``torch.profiler`` (device time a
call, by kernel name; empty where the profiler sees no device time).
Prints the card's name and power limit, then one JSON line per run (after
the layer's own log line), and exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: str, reps: int) -> dict:
    """The device times of ``tree``'s scan kernels and its Mamba layer (run
    in its own interpreter, with its ``src`` first on the path)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import cuda, selective_scan_bwd
    from repro_torch.kernels.selective_scan import _forward
    cuda.build_all(["selective_scan", "selective_scan_bwd"])
    dev = torch.device("cuda")
    # The layer first, so that its peak is its own.
    out = {"tree": tree, "jamba_layer": chip_smoke.jamba_layer_step(dev)}
    torch.cuda.empty_cache()
    sets = chip_smoke.served_backward_sets(dev)
    forward = [s[:6] for s in sets]
    out["forward_serving_ms"] = chip_smoke.device_ms(
        lambda *s: _forward(*s, keep_tiles=False), forward, reps)
    out["forward_keep_ms"] = chip_smoke.device_ms(
        lambda *s: _forward(*s, keep_tiles=True), forward, reps)
    out["backward_ms"] = chip_smoke.device_ms(selective_scan_bwd, sets, reps)
    out["backward_kernels_ms"] = kernel_split(selective_scan_bwd, sets)
    out["kept_states_shape"] = list(sets[0][-1].shape)
    return out


def kernel_split(fn, sets, calls=3):
    """Device ms a call of each kernel ``fn`` launches, by name, from
    ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for args in sets[:1]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0:
            split[ev.key[:80]] = us / 1e3 / calls
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        import torch
        if not torch.cuda.is_available():
            print("scan_ab: no card", file=sys.stderr)
            return 1
        print(json.dumps(measure(args.child, args.reps)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    if card.returncode != 0:
        print("scan_ab: nvidia-smi found no card", file=sys.stderr)
        return 1
    print(card.stdout.strip().splitlines()[0], flush=True)
    trees = [str(Path(t).resolve()) for t in args.trees or [str(ROOT)]]
    env = {t: dict(os.environ, PYTHONPATH=str(Path(t) / "src"))
           for t in trees}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import cuda; "
         "cuda.build_all(['selective_scan', 'selective_scan_bwd'])"],
        env=env[t], cwd=t) for t in dict.fromkeys(trees)]
    status = 0
    for proc in builds:
        status = status or proc.wait()
    for tree in trees:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--child", tree, "--reps", str(args.reps)],
                              env=env[tree], cwd=tree)
        status = status or proc.returncode
    return status


if __name__ == "__main__":
    sys.exit(main())
