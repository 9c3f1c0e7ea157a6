"""End-to-end decentralized training launcher (the port of
``repro.launch.train``).

Trains a population of nodes on synthetic non-IID token streams (each
node's own Markov "dialect") with the in-graph Morph controller: every
round each node's local step, on every ``--delta-r``-th round a Morph
negotiation on Eq. 3 (the Gram kernel), and the uniform mix over the new
edges (the masked-mix kernel).  Runs on the card unless ``--device cpu``:

  python -m repro_torch.launch.train --arch llama3.2-3b --reduced \\
      --nodes 8 --rounds 200 --batch 8 --seq 128

``--arch`` takes every architecture the port registers: the dense
decoders, ``deepseek-moe-16b``, ``rwkv6-7b``, ``jamba-1.5-large-398b``
with its experts, and the two stub-frontend VLMs ``pixtral-12b`` and
``llama4-scout-17b-a16e``, which train text-only as the reference's
launcher feeds them (``tokens`` and ``labels``; their ``patch_embeds`` are
optional).  ``whisper-tiny`` is refused with a ``ValueError``: its
encoder needs a ``frames`` input that token streams do not give (the
reference's launcher fails there with a ``KeyError``; ROADMAP queue 3).

The token streams build a ``[vocab, vocab]`` transition matrix, as the
reference's do, so an unreduced vocabulary needs more host memory than a
machine has (ROADMAP queue 3).  ``--checkpoint-dir D`` saves ``{"params":
...}`` in the reference's file format (``repro_torch.checkpoint``) every
100th round and at the end, under step ``--rounds``, the newest three
kept.

``--mesh single|multi`` trains on the production mesh
(``make_production_mesh``: 256 ranks as ``("data", "model")``, or 512 as
``("pod", "data", "model")``), as the reference's ``--mesh`` does: the
state under ``train_state_sharding`` as DTensors
(``distribute_train_state``) and the train step over the ``DeviceMesh``
(``repro_torch.dlrt.mesh_step``).  Start one process a card:

  torchrun --nnodes 16 --nproc-per-node 16 -m repro_torch.launch.train \\
      --mesh single ...

Each rank builds every node's batches and takes its shard; rank 0 prints
and writes the checkpoints (the parameters gathered whole, the same
file).  Without a process group of that many ranks it raises the
``ValueError`` naming the ranks it needs, as ``jax.make_mesh`` fails with
fewer devices.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..configs import get_config
from ..data import TokenBatcher, make_token_stream
from ..dlrt.distributed import (MorphHParams, init_train_state,
                                make_train_step)
from ..dlrt.mesh_step import distribute_train_state, gather_train_state
from ..optim import sgd
from .mesh import backend_for, make_production_mesh, rank_device


def build_batcher(args, cfg, node: int) -> TokenBatcher:
    """Node ``node``'s batches: a Markov stream whose transitions depend
    on the node (non-IID local distributions)."""
    toks = make_token_stream(args.stream_len, cfg.vocab_size,
                             seed=1000 + node,
                             concentration=0.05 + 0.1 * (node % 4))
    return TokenBatcher(toks, args.batch, args.seq, seed=node)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the CPU smoke-scale variant")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="per-node batch size")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=3, help="Morph in-degree")
    ap.add_argument("--view-size", type=int, default=5)
    ap.add_argument("--beta", type=float, default=500.0)
    ap.add_argument("--delta-r", type=int, default=5)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--stream-len", type=int, default=200_000)
    ap.add_argument("--mesh", choices=("none", "single", "multi"),
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where to train (the card unless 'cpu')")
    return ap.parse_args(argv)


def join_mesh(args, dev: torch.device):
    """``--mesh``: the production mesh's layout and ``DeviceMesh``, this
    rank's device, and whether the launcher started the default group
    (from ``torchrun``'s environment, where none is initialised yet)."""
    layout = make_production_mesh(multi_pod=args.mesh == "multi")
    started = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend_for(dev))
        started = True
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        mesh = layout.device_mesh(dev.type)
    except ValueError:
        if started:
            dist.destroy_process_group()
        raise
    return layout, mesh, dev, started


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.encoder is not None:
        raise ValueError(f"--arch {args.arch}: its encoder reads a 'frames' "
                         "input (stub audio frame embeddings) that the "
                         "launcher's token streams do not give")
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    mesh, started, rank = None, False, 0
    if args.mesh != "none":
        layout, mesh, dev, started = join_mesh(args, dev)
        rank = dist.get_rank()
    opt = sgd(args.lr)
    hp = MorphHParams(k=min(args.k, args.nodes - 1),
                      view_size=min(args.view_size, args.nodes - 1),
                      beta=args.beta)
    state = init_train_state(cfg, opt, args.nodes, seed=0, device=dev)
    if mesh is not None:
        state = distribute_train_state(state, layout, mesh, cfg)
    step_topo = make_train_step(cfg, opt, hp, microbatch=args.microbatch,
                                do_topology=True, mesh=mesh)
    step_plain = make_train_step(cfg, opt, hp, microbatch=args.microbatch,
                                 do_topology=False, mesh=mesh)
    batchers = [build_batcher(args, cfg, i) for i in range(args.nodes)]
    ckpt = None
    if args.checkpoint_dir:
        from ..checkpoint import CheckpointManager
        ckpt = CheckpointManager(args.checkpoint_dir)

    def save(step):
        # Gathering is a collective: every rank gathers, rank 0 writes.
        params = (gather_train_state(state).params if mesh is not None
                  else state.params)
        if rank == 0:
            ckpt.save(step, {"params": params})

    t0 = time.time()
    for rnd in range(args.rounds):
        node_batches = [b.next() for b in batchers]
        stacked = {k: np.stack([nb[k] for nb in node_batches])
                   for k in ("tokens", "labels")}
        step = step_topo if rnd % args.delta_r == 0 else step_plain
        state, metrics = step(state, stacked)
        if rank == 0 and (rnd % args.log_every == 0
                          or rnd == args.rounds - 1):
            loss = float(metrics["loss"])
            deg = state.morph.edges.sum(1).cpu().numpy()
            print(f"round {rnd:5d}  loss {loss:.4f}  "
                  f"in-deg [{deg.min()}..{deg.max()}]  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if ckpt is not None and rnd and rnd % 100 == 0:
            save(rnd)
    if ckpt is not None:
        save(args.rounds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if rank == 0:
        print(f"done: {args.rounds} rounds in {time.time() - t0:.1f}s")
    if started:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
