#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit) when it does not hold:

1. a CUDA device is present; print ``nvidia-smi``'s name and power limit;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (five sources, one ``nvcc`` each, all at once);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (n = 50; D = 10, 32, 64, 2400, 40960, 51200) and awkward
   ones (n = 7, 33; D = 129, 8199), f32 and bf16; the dense mixes also at
   n = 200 and 1000 (the tiled route); the grouped calls over GN-LeNet's
   ten leaves (the Gram at n = 50, 100 and 129, the mixes at n = 16, 50,
   100, 129, 200 and 1000) and over phase 12(a)'s model's leaves (the
   mixes at n = 16) bit for bit the per-leaf calls, and two calls the same
   bits; the CSR kernel bit for bit its plain version at n = 50 and 1000
   over the same D with k = 3 and 8, at the awkward shapes, and at
   k = n - 1 with invalid slots, and one grouped CSR call over the ten
   leaves (n = 50 and 1000, k = 3 and n - 1) the per-leaf calls and the
   plain version bit for bit; the selective scan at
   ``tests/test_kernels.py``'s shapes, ragged and odd d_inner, L = 1, 33,
   37 and 65 and the served shape (2 x 2,048 tokens, d_inner 16,384,
   d_state 16), in f32, bf16 and apply_mamba's serving mix, and chained
   halves against one call; the Gram at n = 1000 (one leaf, D = 51,200, and
   grouped over the tree, bit for bit the per-leaf calls); each kernel
   timed at the largest main-path shape (inputs rotated through more than
   the 50 MB L2 so every call reads from device memory), the CSR kernel at
   n = 50 and 1000: ``ms`` is CUDA events around 30 calls made from Python,
   ``device_ms`` the same calls replayed from a CUDA graph (no host work
   between launches), ``host_enqueue_us`` the host clock per call without
   a synchronise, and each library call is timed the same two ways; each
   grouped call over the whole GN-LeNet tree at n = 50 beside a per-leaf
   loop of the library call; the dense mixes and the Gram at n = 1000
   (``at_n1000``); each grouped mix (dense, masked, CSR) and the grouped
   Gram over the whole tree at n = 1000 (``tree_n1000``) beside a
   per-leaf loop of the library call; the scan's bound from the bytes,
   the exponentials and the FP32 and all instructions the recurrence
   needs, beside the instructions its inner step issues, counted in the
   built library's SASS (``cuobjdump``);
4. the main path at full width: GN-LeNet CIFAR-10 (width 32, 94,858
   parameters per node), n = 50, fig3 settings (k = 3, delta_r = 5,
   beta = 500, Dirichlet 0.1, batch 8, lr 0.05) on a ``DeviceDataStream``,
   ten rounds each of Morph, Static, EL-Oracle and fully-connected through
   ``DecentralizedRunner``; launch counts prove the rounds went through
   the kernels, one grouped launch per call site per round;
5. where a Morph round's time goes at that size (host clock around each
   stage, synchronised);
6. the same tiny runs on the card and on the CPU agree (edges identical,
   parameters within 1e-4), the two sparse strategies included; reduced
   Jamba without experts (f32) gives the CPU's logits within 1e-4 and its
   greedy tokens;
7. the sparse (CSR) engine at full width through
   ``DecentralizedRunner(engine="sparse")``: sparse Morph and sparse
   Epidemic at n = 50 (the fig3 ``morph-sparse`` row), sparse Morph at
   n = 1000 (fig12's middle population; equal shards of 12,000 samples,
   256 test images), and the compat modes at n = 50 (Static through the
   CSR kernel, Morph exactly as the dense engine, bitwise); launch counts
   prove each run went through the CSR kernel, one grouped launch a
   round, and nothing else;
8. where a sparse Morph round's time goes at n = 1000; then fig12's dense
   row: dense Morph at n = 1000 on the same set-up, five rounds through
   ``DecentralizedRunner`` (one grouped Gram launch and one grouped masked
   mix a round, on the tiled route), and where its round's time goes;
9. the model zoo's serving path at full width: Jamba-1.5-Large at its
   published widths, one period (7 Mamba layers, 1 attention), dense
   SwiGLU in place of the experts (a period with its four MoE layers is
   some 44 B parameters, 88 GB in bf16: it does not fit the card; phase
   18(c) runs one MoE layer), bf16, drawn on the card: (a) prefill of
   two 2,048-token prompts through ``forward(last_only=True)``, exactly
   7 scan launches each; (b) four requests served as
   ``examples/serve_decode.py`` does (64-token prompts token by token
   through ``decode_step``, then 32 greedy tokens on a linear cache of
   96), no scan launch; ``greedy_generate`` gives the same tokens; (c) the
   forward's last logits against decode's on the same prompts; (d) where a
   prefill's time goes; (e) a decode step's transient device memory does
   not take a copy of the cache as the cache grows from 2,048 to 16,384
   slots, and the card's LM head (a bf16 product with f32 output) agrees
   with the f32 product of the same values;
10. (a) the fig3 contest at the reference artifact's shape (n = 50,
   GN-LeNet width 8 on 16-pixel images, 150 rounds, seed 0) through
   ``repro_torch.bench.fig3``: Morph, Static, EL-Oracle, fully-connected,
   the chunked Morph rerun (bit for bit the first: the chunk pin) and
   sparse Morph, each final printed beside the reference's, with the
   ordering; (b) compressed gossip at full width: dense Morph at n = 50,
   10 rounds under int8, fp8 and int8+topk0.75, and sparse Morph at
   n = 1000, 5 rounds under int8+topk0.75, one grouped Gram launch per
   refresh and one grouped mix a round, comm bytes the analytic wire bytes
   times the edges, each run's stages with the codec's encode, decode and
   correction, and the top-k sort's time; (c) tiny compressed runs on the
   card and on the CPU: identical edges, parameters within the CPU tests'
   codec tolerance;
11. the dense in-scan network model (``RunnerConfig.net``) at full width,
   each run with one grouped ``graph_mix`` launch a round over the
   staleness-expanded ``[n, n S]`` weights (and Morph's Gram a round), no
   masked mix: (a) the ideal network against no network model at n = 50,
   Morph, Static, EL-Oracle and fully-connected, ten rounds each with
   deterministic cuDNN (edges identical, every edge delivered, parameters
   bit for bit); (b) fig11's profiles at
   n = 50 and ``round_s`` = 1: WAN, and flaky-WAN with fig11's fault mix,
   Morph, Static and EL-Oracle (ring depth, drop fraction, mean staleness,
   ms a round); (c) the deep ring, flaky-WAN at ``round_s`` = 0.05 (S = 5):
   dense Morph at n = 50 for ten rounds and at n = 1000 (phase 8's set-up)
   for three, each round broken down by stage with its peak memory;
   (d) the keyed matrices on the card bit for bit the CPU's, then tiny runs
   under a lossy, stale, partitioned and churned network (``round_s``
   = 0.3) on the card and on the CPU: identical edges, delivered sets and
   counters, parameters within 1e-4 (Morph under int8 as in 10(c)); and
   the ring contraction ``[n, 5 n] @ [5 n, D]`` at n = 50 and 1000 held to
   its plain version (within the f32 tolerance of the nonzeros a row sums)
   and timed at D = 51,200 and over GN-LeNet's tree
   beside ``torch.matmul``;
12. the host protocol loop (``RunnerConfig.compiled`` None or False):
   (a) Table I through ``repro_torch.bench.table1`` at the reference's
   defaults (16 nodes, 150 rounds, GN-LeNet width 12 on 16-pixel images,
   seed 0): the four best accuracies and the ordering row beside the
   reference's own CPU run, one mix launch a round; (b) the four Table-I
   strategies (the message-faithful ``MorphProtocol``, Static, EL-Oracle,
   fully-connected, as ``bench.common.make_strategy`` builds them) at full
   width and Table I's population, n = 100, with fig3's settings on a host
   batcher, ten rounds each: one grouped mix launch a round (the masked
   one for Morph and EL) and no Gram launch, comm bytes, peak memory, the
   protocol's tallies and views, then where a protocol round's time goes,
   timed inside the runner's own round (batch, local step, copy to the
   host, ``round_edges``: negotiation and deliver, the digests, the direct
   Eq.-3 measurements and the report ingestion; mix; evaluation); (c) Static, FC, EL-Oracle, in-graph Morph and EL-Local at
   full width and n = 50 through the engine and through the host loop's
   ``round_edges`` adapters with deterministic cuDNN: identical edges,
   parameters bit for bit, the same launches; (d) tiny host-loop runs of
   the four Table-I strategies on the card and on the CPU: identical
   edges, the protocol's tallies and views, parameters within 1e-5;
13. the event-driven runtime (``repro_torch.netsim.AsyncRunner``): (a) the
   lockstep property at full width, n = 50, 11 rounds on the ideal
   network with deterministic cuDNN: ``MorphProtocol``, Static,
   EL-Oracle, fully-connected and in-graph Morph through ``AsyncRunner``
   and through the host loop give identical edges, parameters bit for bit
   and equal protocol tallies, one grouped mix launch a round on both
   paths and the same Gram launches; (b) fig8's WAN and flaky-WAN regimes
   (its fault mix and 3 s mix deadline) at full width, n = 50, ten rounds
   of MorphProtocol, Static and EL-Oracle: in-degree at most k (EL-Oracle,
   k-out, out-degree k), nothing in flight at the end, no truncation; virtual seconds, staleness, drops by
   kind, host ms a round and its stages (local-step calls, snapshot
   copies, direct similarities, per-node mixes, event-loop overhead);
   (c) tiny WAN and flaky-WAN runs on the card and on the CPU: identical
   edges, transport stats, staleness histograms and event counts,
   parameters within 1e-5; (d) fig11's WAN row at n = 50, ten rounds,
   through ``repro_torch.bench.fig11`` (``fused_over_async`` and the
   fidelity columns);
14. the sweep farm (``repro_torch.dlrt.SweepSuperstep``): (a) GN-LeNet
   at full width, n = 50, fig3's settings, ten rounds, deterministic
   cuDNN: first one local step of the ``[8 n]`` stack against each
   experiment's own step (bit for bit, both timed), then Morph over 4
   seeds x {ideal, wan} at round_s = 1 (E = 8), Morph with delta_r (2, 3,
   5) and no network (E = 3) and Static over 4 seeds (E = 4, the
   general-W route), counts set to 0 just before each sweep and read just
   after: ceil(E L / MAX_LEAVES) grouped mix launches a round and as many
   Gram launches a refresh, and every experiment bit for bit its solo
   ``Superstep`` run (parameters, edges, delivered masks, comm bytes,
   staleness counters); (b) the grouped mixes with one W (or E) a row
   over E experiments' GN-LeNet leaves bit for bit E one-W launches, f32
   and bf16, at n = 50 (small route), 200 and 1000 (tiled), both timed by
   CUDA-graph replay; (c) where a sweep round's time goes against E solo
   runs of the same rounds (host clock around synchronised stages: batch,
   local step, masks, similarity, controller, push, delivery plan, mix)
   and peak memory: GN-LeNet at E = 8 and 32, the tiny MLP at fig14's
   shape; (d) tiny sweeps card == CPU (edges identical, parameters within
   1e-5, batches keyed on the CPU); (e) ``repro_torch.bench.fig14`` at its
   defaults, ``acceptance/bitwise_vs_singles`` = 1;
15. the tuner (``repro_torch.tune``) and the last one-card figure scripts:
   (a) resolution on the card: a temporary cache with an entry for the
   tiny-MLP Morph workload at n = 16 (chunk 4, ``engine="sparse"``,
   ``compress="int8"``); a runner with those knobs ``"auto"`` is bit for
   bit the runner given the resolved values (parameters, edges, comm
   bytes), its ``resolved_knobs.source`` is ``cache:<key>``, and the
   committed ``cuda_default.json`` has the fig9/fig12 shapes; (b) the tuner
   end to end at n = 16 over chunks (8, 16) and compress (none, int8) into
   a temporary file, reloaded: its best candidate and ms a round;
   (c) ``repro_torch.bench.fig12`` at 5 rounds (dense n = 100, 1000;
   sparse n = 100, 1000, 10,000): each row's launches (one CSR launch a
   round on the sparse rows; a Gram launch every fifth round and a masked
   mix a round on the dense ones), peak memory, and the sparse engine past
   ``SPARSE_EDGE_DECODE_MAX`` keeping ``(idx, mask)`` edges; (d)
   ``repro_torch.bench.fig9`` at n = 16, 30 rounds, chunk 10, all four
   rows, ``compiled-auto`` resolved through the committed cache; (e)
   ``fig2``, ``fig67`` and ``fig3_curves`` (n = 4, 4 rounds) at smoke depth
   through their ``main(argv)``;

16. the sharded superstep (``RunnerConfig(mesh_devices=1)``, DESIGN.md
   §8) on one card, inside one one-rank NCCL group, GN-LeNet at full
   width with fig3's settings on a ``DeviceDataStream``, ten rounds,
   deterministic cuDNN, each run against the same run without a mesh and
   with its counts set to 0 just before it and read just after: (a) the
   gather schedule at n = 50 for Morph, Static and FC: identical edges,
   parameters bit for bit (for Morph the no-mesh run mixes through the
   masked kernel, the sharded one through ``graph_mix`` on
   ``uniform_weights_torch``, and the two sum alike), one grouped
   ``graph_mix`` launch a round and one Gram launch a refresh round for
   Morph; (b) bit for bit too: the psum schedule at n = 50, Morph under
   int8 on both schedules, Morph under fig11's WAN profile with gather
   (identical delivered sets and counters), and sparse Morph at n = 1000
   (phase 8's set-up) on both schedules against the single-device sparse
   engine (identical ``(idx, mask)``; one grouped CSR launch a round for
   the row block or the push partials);
   (c) ms a round against the run without a mesh, host clock
   around synchronised stages through the engines' ``stage`` hook
   (``gather``, ``similarity``, ``controller``, ``mix``, ``reduce`` and the
   rest), for dense Morph at n = 50 (gather and psum) and 1000 (the tiled
   route) and sparse Morph at n = 1000; (d) ``repro_torch.bench.fig10 --devices 1`` on the
   card (one NCCL rank in a child process) and ``--device cpu --devices 1
   2 4 --rounds 20 --chunk 10`` (gloo ranks on the card's host);

17. decentralized LM training (``repro_torch.dlrt.distributed``,
   ``python -m repro_torch.launch.train``): (a) the selective scan's
   backward kernel against autograd through the plain scan at phase 3's
   scan shapes and the served shape, f32, bf16 and the serving mix, with
   and without the last state's cotangent, two calls the same bits, and
   timed at the served shape beside its bound; (b) Llama-3.2-3B at its
   published widths (d_model 3,072, 24/8 heads, d_ff 8,192, vocab 128,256,
   tied, bf16) with 8 of its 28 layers, n = 8, ten rounds of the train
   step as the launcher runs it (sgd 0.05, k = 3, view 5, beta 500,
   delta_r 5, batch 8 of 128 tokens from streams over 2,048 of its ids):
   the loss finite and lower at the last round than at the first, one
   Gram launch on each topology round and one masked-mix launch per group
   of leaves every round, the stage breakdown, peak memory beside the
   reckoning, and the Gram and masked-mix kernels on a leaf of the
   embedding's shape (3.15 B elements, rows 6 and 7 wholly past 2^31)
   whose rows differ, against f64 and their plain versions, with planted
   faults (node 7's row one element off, rows 6 and 7 swapped) shown to
   break the limits;
   (c) reduced Llama-3.2-3B and Jamba without experts, three rounds each
   (a topology round first) on the card and on the CPU from one state:
   identical edges, parameters within 1e-4; (d) one Jamba-1.5-Large Mamba
   layer at its published widths, bf16, 2 x 2,048 tokens, forward and
   backward between CUDA events with the scan backward's share;
   (e) ``make_serve_step`` each node's ``decode_step`` bit for bit; (f) the
   launcher at ``--reduced --nodes 8 --rounds 20`` exits 0;
   ``launches_train`` in every kernel row counts (b) and (c)'s card runs;

18. the zoo's MoE MLP and RWKV-6 mixer (``repro_torch.models.moe``,
   ``.rwkv``): (a) DeepSeek-MoE-16B whole (28 layers, 64 experts top-6 and
   2 shared, bf16, drawn on the card): prefill of two 2,048-token prompts,
   four requests decoded as 9(b) and ``greedy_generate`` the same tokens,
   the prefill's stages (attention, router, dispatch, expert products,
   combine, shared experts), the share of (token, slot) pairs dropped at
   prefill and at decode, and peak memory beside the parameters' bytes;
   (b) DeepSeek-MoE and RWKV-6 at published widths, 2 layers, f32 (MoE at
   a capacity factor of 100): prefill against decode within 9(c)'s f32
   limits; (c) one Jamba-1.5-Large MoE layer (16 experts top-2, d_model
   8,192, d_ff 24,576) at published widths, bf16, 2 x 2,048 tokens under
   autograd: forward and backward between CUDA events with the expert
   products' share, and peak memory; (d) RWKV-6 7B whole (32 layers, bf16)
   as (a), its prefill's stages with the WKV chunks' share; (e) reduced
   DeepSeek-MoE, Jamba with its experts and RWKV-6 (f32) on the card and
   on the CPU: logits within 1e-4 and greedy tokens identical, then three
   train rounds (a topology round first): identical edges, parameters
   within 1e-4, a router pick that differs named; (f) DeepSeek-MoE-16B at
   published widths with 2 of its 28 layers trained as 17(b) (n = 8, ten
   rounds; its routed banks are leaves of 2.95 B elements): loss finite and
   falling, the Gram and masked-mix launches, stage breakdown, peak memory
   beside the reckoning; (g) the launcher at ``--reduced --nodes 8
   --rounds 20`` exits 0 for deepseek-moe-16b, rwkv6-7b and
   jamba-1.5-large-398b with its experts; ``launches_zoo`` in every kernel
   row counts (e) and (f)'s card runs;
19. the zoo's encoder and stub frontends (Whisper's encoder,
   cross-attention and learned positions; the audio and vision
   projectors), bf16, drawn on the card, the frontend inputs shaped by
   ``repro_torch.launch.shapes.input_specs``: (a) Whisper-tiny whole (4 +
   4 layers, d_model 384): prefill of two requests of 448 tokens over
   1,500 frames, four requests decoded as 9(b) and ``greedy_generate`` the
   same tokens, the prefill's stages (encoder, decoder self-attention,
   cross-attention, MLPs, head) and peak memory beside the parameters'
   bytes; (b) Pixtral-12B whole (40 layers) as (a), prompts of 256 patch
   embeddings and 1,792 tokens, the stages with the projector; (c)
   Llama-4-Scout at published widths with 8 of its 48 layers (16 experts
   top-1 and a shared expert; whole it does not fit the card) as (b), with
   the share of (token, slot) pairs dropped at prefill and at decode;
   (d) Pixtral and Llama-4-Scout at published widths, 2 layers, f32, text
   only (MoE at a capacity factor of 100): prefill against decode within
   9(c)'s f32 limits (Whisper's decode never reads the encoder: its cross
   caches are zeros, as in the reference); (e) the three reduced configs
   (f32) with their frontend inputs on the card and on the CPU as 18(e);
   (f) Whisper-tiny whole at n = 16 (batches of 8 x 448 tokens and their
   frames) and Pixtral-12B with 2 of its 40 layers at n = 8 (with its
   patches) trained as 17(b); (g) the launcher at ``--reduced --nodes 8
   --rounds 20`` exits 0 for pixtral-12b and llama4-scout-17b-a16e (text
   only) and refuses whisper-tiny with a ``ValueError`` naming its
   ``frames``; ``launches_frontends`` in every kernel row counts (e) and
   (f)'s card runs;
20. checkpoints, the launcher's checkpoint directory and the dry run
   (``repro_torch.checkpoint``, ``repro_torch.launch.dryrun``): (a)
   Whisper-tiny whole at n = 2 (bf16, 149.4 MB of population), two rounds
   of batches of 2 x 448 tokens and their frames (a topology round first,
   through :func:`train_rounds`), ``{"params": ...}`` saved by
   ``CheckpointManager`` (zlib where ``zstandard`` is missing) and
   restored onto the card: every leaf the same dtype, shape and bits;
   then one plain round on one batch from the restored parameters and
   from the live ones: losses bit for bit, parameters bit for bit or
   within 1e-6 (the record says which); the file's bytes, save and
   restore seconds and MB/s, the compressor; (b) the launcher at
   ``--reduced --nodes 4 --rounds 3 --checkpoint-dir`` leaves exactly
   ``ckpt_00000003.msgpack.zst``, a population of a fresh one's
   structure, shapes and dtypes; (c) the dry run over every ``ASSIGNED``
   architecture, shape and production mesh on meta tensors: the card's
   allocated bytes unchanged, each record's per-card argument GB beside
   the card's memory; ``launches_checkpoint`` in every kernel row counts
   (a)'s four rounds;
21. the zoo's train step on a device mesh (``repro_torch.dlrt.mesh_step``)
   on a one-rank NCCL group, every mesh axis of size 1, so every spec is
   replicated: each part runs the mesh step (``make_train_step(...,
   mesh=...)`` on a ``distribute_train_state`` state) and the one-device
   step, each from its own copy of one state, three rounds (topology on
   rounds 0 and 2) on the same batches: per-node losses, edges and the
   last parameters (``gather_train_state``) bit for bit, every kernel
   launched as often, ms a round and peak memory of both; (a)
   Llama-3.2-3B at published widths, 2 of 28 layers, n = 4, bf16, 2 x
   512 tokens, ``("data", "model")``; (b) Qwen1.5-110B at published
   widths, 1 of 80 layers, n = 2, bf16, 1 x 512 tokens, ``("pod",
   "data", "model")`` (node_fsdp: the batch over ``data``); (c) reduced
   Jamba without experts (the scan and its backward kernel inside);
   ``launches_mesh`` in every kernel row counts the mesh runs;
22. the zoo's serve step and prefill on a device mesh
   (``repro_torch.dlrt.mesh_serve``) on a one-rank NCCL group, every mesh
   axis of size 1: each part serves on the mesh (``make_serve_step(...,
   kv_spec=serve_kv_spec(...), mesh=...)`` on ``distribute_params``
   parameters, which share the one-device leaves, and
   ``init_mesh_caches``) and on one device from the same parameters: 4
   requests a node, 16-token prompts fed one token at a time, then 8
   greedy tokens, in 24 slots; every step's logits, the caches at the end
   (``gather_tree``) and the prefills (``make_prefill_step``) bit for bit,
   every kernel launched as often, ms a decode step and peak memory on
   both; (a) Llama-3.2-3B whole at published widths (28 layers), n = 2,
   bf16; (b) Jamba-1.5-Large's serving period (:func:`jamba_serving_config`),
   n = 1, with a prefill of 2 x 2,048 tokens (7 scan launches a prefill);
   (c) RWKV-6 7B at published widths, 2 of 32 layers, n = 2;
   ``launches_serve_mesh`` in every kernel row counts the mesh runs;
23. the sweep farm on an ``("exp", "data")`` mesh
   (``SweepSuperstep(mesh=make_sweep_mesh(1, 1))``, a one-rank NCCL group
   the mesh starts and closes) against the meshless sweep, deterministic
   cuDNN, each pair from the same parameters and draws: (a) GN-LeNet
   CIFAR-10 at full width, n = 50, E = 4, five rounds and an evaluation,
   Morph and Static; (b) the tiny MLP at n = 6, E = 4, under a
   ``SweepNetwork`` of mixed ring depths, eleven rounds; edges, records,
   comm bytes, network counters and every experiment's parameters bit for
   bit, every kernel launched as often (none of the meshless run's kernels
   left out), ms a round of both; ``launches_sweep_mesh`` in every kernel
   row counts the mesh runs;

17(f), 18(g), 19(g) and 20(b) run last, their eight launcher processes
started together; then one JSON line with every kernel's numbers, the card line, and the
result line ``{"ok": true, "device": {...}}`` last.  TF32 is off for
cuDNN convolutions and matmuls in every phase, so the card computes in
full f32 like the plain versions it is compared with, and bf16 products
reduce in f32.
"""
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # f32 outside the tensor cores, same source
BF16_ULP = 2.0 ** -7             # one bf16 ulp, relative to the value
SFU_PER_CLOCK_PER_SM = 16        # exp results (CUDA C Programming Guide,
                                 # throughput table, compute capability 9.0)
# Lane-instructions an SM issues a clock: 4 schedulers, one warp
# instruction each; the FP32 pipe takes as many (128 FP32 lanes), so an
# unfused FMUL or FADD costs a whole slot (same source).
ISSUE_PER_CLOCK_PER_SM = 128
FP32_PER_CLOCK_PER_SM = 128
# What the S6 step needs per (t, channel, state) element, with its bits
# (each product rounded before its add, the accurate expf), whatever the
# kernel: 12 FP32-pipe instructions, namely dt a, da h, (dt x) b, their sum,
# h c and its add into y (dt x once a channel, the sum over the states one
# add fewer than states: 6 an element), and the 6 that expf issues around
# its exponential (4 FFMA, an FADD, an FMUL); and one MUFU.EX2.
SCAN_FP32_PER_ELEMENT = 12
SCAN_MUFU_PER_ELEMENT = 1
SCAN_TOL = (1e-5, 1e-5)          # selective scan (atol, rtol); see tolerance


def tolerance(name, n, bf16, k=None):
    """``(atol, rtol)`` of a kernel against its plain version:
    ``|got - want| <= atol + rtol * |want|`` everywhere.

    ``atol`` is ``tests/test_kernels.py``'s f32 tolerance (the Gram kernel
    on its cosine epilogue; the CSR mix of ``k`` slots and the self term
    sums ``k + 1`` terms).  bf16 inputs convert to f32 exactly and both
    sides sum in f32, so bf16 keeps that ``atol``; the mixes then round
    their f32 sums to bf16, where two sums a hair apart can land one bf16
    ulp apart, hence ``rtol`` = one ulp for them.  The Gram output is f32.

    The selective scan keeps ``tests/test_kernels.py``'s f32 atol of 1e-5
    and adds an rtol of 1e-5 (:data:`SCAN_TOL`), in f32 and bf16 alike:
    kernel and plain version round the same products and sums in the same
    order and differ only where their ``exp`` does; a one-ulp ``exp``
    difference moves ``h``, and ``y`` grows with L where ``dt a`` is near
    0, so the bound is relative there.  Its outputs are f32.
    """
    if name == "selective_scan":
        return SCAN_TOL
    if name == "selective_scan_bwd":
        # atol is relative to each gradient's largest magnitude (phase 17).
        return SCAN_BWD_TOL, SCAN_BWD_TOL
    atol = {"gram_matrix": 5e-5, "graph_mix": 1e-4 * math.sqrt(n),
            "graph_mix_masked": 1e-4,
            "graph_mix_sparse": 1e-4 * math.sqrt((k or 0) + 1)}[name]
    return atol, (BF16_ULP if bf16 and name != "gram_matrix" else 0.0)


MAIN_N, MAIN_D = 50, (10, 32, 64, 2400, 40960, 51200)
# GN-LeNet CIFAR-10 at width 32: its ten leaves' widths per node, in order.
GN_LENET_LEAVES = (32, 2400, 64, 51200, 10, 40960, 32, 32, 64, 64)
AWKWARD = [(7, 129), (7, 8199), (33, 129), (33, 8199)]
ROUNDS, K, DELTA_R = 10, 3, 5
LARGE_N = 1000                   # the sparse slice's second population
HOST_N = 100                     # Table I's own population (phase 12)
DENSE_LARGE = [(200, 2400), (200, 51200), (1000, 2400), (1000, 51200)]


_T0 = time.perf_counter()


def log(msg):
    """``msg`` on its own line after the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions, and their times.
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    from repro_torch.kernels import graph_mix, graph_mix_masked, ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(n, d, dtype):
        x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        w = torch.softmax(torch.randn((n, n), generator=gen, device=dev), 1)
        e = torch.rand((n, n), generator=gen, device=dev) < 3.0 / n
        e.fill_diagonal_(False)
        e[0] = False                          # a node with no in-edges
        return x, w, e

    return inputs, {
        "gram_matrix": (lambda x, w, e: ops.pairwise_cosine(x),
                        lambda x, w, e: ref.pairwise_cosine(x)),
        "graph_mix": (lambda x, w, e: graph_mix(w, x),
                      lambda x, w, e: ref.graph_mix(w, x)),
        "graph_mix_masked": (lambda x, w, e: graph_mix_masked(e, x),
                             lambda x, w, e: ref.graph_mix_masked(e, x)),
    }


def compare(name, got, want, n, dtype, what, worst, k=None):
    """Hold ``got`` to ``want`` within :func:`tolerance`; keep the worst
    |err| per kernel and dtype in ``worst``."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    key = str(dtype).removeprefix("torch.")
    atol, rtol = tolerance(name, n, dtype == torch.bfloat16, k)
    excess = float((diff - rtol * want.abs()).max())
    worst[name][key] = max(worst[name][key], float(diff.max()))
    if not excess <= atol:
        raise AssertionError(f"{name} {what} {key}: |err| exceeds "
                             f"{rtol} * |want| by {excess} > {atol}")


def check_kernels(dev):
    inputs, kernels = kernel_cases(dev)
    shapes = [(MAIN_N, d) for d in MAIN_D] + AWKWARD
    worst = {name: {"float32": 0.0, "bfloat16": 0.0} for name in kernels}
    count = 0
    for n, d in shapes + DENSE_LARGE:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, e = inputs(n, d, dtype)
            for name, (kernel, plain) in kernels.items():
                if name == "gram_matrix" and (n, d) in DENSE_LARGE:
                    continue                 # past 128 nodes: the mixes only
                compare(name, kernel(x, w, e), plain(x, w, e), n, dtype,
                        f"n={n} D={d}", worst)
                count += 1
    log(f"phase 3: {count} kernel/plain comparisons within tolerance "
        f"(dense mixes also at n = 200, 1000); worst {json.dumps(worst)}")
    return worst


def sparse_inputs(dev, gen, n, d, k, dtype, invalid=0.0):
    """``X [n, D]``, ``k`` distinct non-self senders per row with positive
    weights summing to 1 with the self weight, and a slot mask with a
    share ``invalid`` of invalid slots."""
    x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    scores = torch.rand((n, n), generator=gen, device=dev)
    scores.fill_diagonal_(-1.0)
    idx = scores.topk(k, dim=1).indices
    wfull = torch.softmax(torch.randn((n, k + 1), generator=gen,
                                      device=dev), dim=1)
    mask = torch.rand((n, k), generator=gen, device=dev) >= invalid
    return x, idx, wfull[:, :k].contiguous(), wfull[:, k].contiguous(), mask


def check_sparse(dev, worst):
    """The CSR kernel (through ``ops.mix_sparse``, which parks the invalid
    slots) against its plain version on the parked operands."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    worst["graph_mix_sparse"] = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(n, d, k, 0.0) for n in (MAIN_N, LARGE_N) for d in MAIN_D
             for k in (3, 8)]
    cases += [(n, d, 3, 0.0) for n, d in AWKWARD]
    cases += [(n, d, n - 1, 0.3) for n, d in ((7, 129), (MAIN_N, 2400))]
    for n, d, k, invalid in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, idx, w, w_self, mask = sparse_inputs(dev, gen, n, d, k, dtype,
                                                    invalid)
            rows = torch.arange(n, device=dev)[:, None]
            want = ref.graph_mix_sparse(torch.where(mask, idx, rows),
                                        torch.where(mask, w, 0.0), w_self, x)
            got = ops.mix_sparse(idx, w, w_self, x, mask=mask)
            compare("graph_mix_sparse", got, want, n, dtype,
                    f"n={n} D={d} k={k}", worst, k=k)
            if not torch.equal(got, want):
                raise AssertionError(f"graph_mix_sparse n={n} D={d} k={k} "
                                     f"{dtype}: not the plain version's bits")
    log(f"phase 3: {len(cases) * 2} CSR kernel/plain comparisons bit for "
        f"bit (n = 50, 1000, 7, 33; k = 3, 8, n - 1 with invalid slots); "
        f"worst {json.dumps(worst['graph_mix_sparse'])}")
    check_sparse_grouped(dev, gen)


def check_sparse_grouped(dev, gen):
    """One grouped CSR call over GN-LeNet's ten leaves is the per-leaf
    calls and the plain version bit for bit, and two calls give the same
    bits: n = 50 and 1000, k = 3 and k = n - 1 with invalid slots."""
    from repro_torch.kernels import (graph_mix_sparse,
                                     graph_mix_sparse_leaves, ref)
    count = 0
    for n in (MAIN_N, LARGE_N):
        for k, invalid in ((K, 0.0), (n - 1, 0.3)):
            for dtype in (torch.float32, torch.bfloat16):
                _, idx, w, w_self, mask = sparse_inputs(dev, gen, n, 1, k,
                                                        dtype, invalid)
                xs = [torch.randn((n, d), generator=gen, device=dev).to(dtype)
                      for d in GN_LENET_LEAVES]
                rows = torch.arange(n, device=dev)[:, None]
                idx32 = torch.where(mask, idx, rows).to(torch.int32)
                parked = (idx32.contiguous(), torch.where(mask, w, 0.0),
                          w_self)
                before = graph_mix_sparse.launches
                ys = graph_mix_sparse_leaves(*parked, xs)
                if graph_mix_sparse.launches - before != 1:
                    raise AssertionError("grouped CSR call: not one launch")
                again = graph_mix_sparse_leaves(*parked, xs)
                for y, y2, x in zip(ys, again, xs):
                    if not (torch.equal(y, y2)
                            and torch.equal(y, graph_mix_sparse(*parked, x))
                            and torch.equal(y, ref.graph_mix_sparse(
                                *parked, x))):
                        raise AssertionError(
                            f"grouped CSR n={n} k={k} D={x.shape[1]} {dtype}:"
                            f" not the per-leaf call, the plain version and "
                            f"the same bits twice")
                    count += 1
    log(f"phase 3: grouped CSR calls over GN-LeNet's leaves (n = 50, 1000; "
        f"k = 3 and n - 1 with invalid slots; f32, bf16) are one launch each "
        f"and {count} leaves equal the per-leaf calls and the plain version "
        f"bit for bit, the same twice")
    check_sparse_blocks(dev, gen)


def check_sparse_blocks(dev, gen):
    """The CSR kernel as the sharded engine calls it, over GN-LeNet's
    leaves at n = 1000: a receiver block whose own rows start at ``self0``
    of a larger population (the gather row block of one rank of two), bit
    for bit the plain version and those rows of the whole mix; and the
    push partials (every receiver over one rank's senders, no self term),
    bit for bit the plain version."""
    from repro_torch.kernels import graph_mix_sparse_leaves, ref
    n, half, count = LARGE_N, LARGE_N // 2, 0
    for dtype in (torch.float32, torch.bfloat16):
        _, idx, w, w_self, mask = sparse_inputs(dev, gen, n, 1, K, dtype)
        xs = [torch.randn((n, d), generator=gen, device=dev).to(dtype)
              for d in GN_LENET_LEAVES]
        whole = graph_mix_sparse_leaves(idx.to(torch.int32).contiguous(),
                                        w, w_self, xs)
        block = (idx[half:].to(torch.int32).contiguous(),
                 w[half:].contiguous(), w_self[half:].contiguous())
        ys = graph_mix_sparse_leaves(*block, xs, self0=half)
        push = (idx.remainder(half).to(torch.int32).contiguous(), w)
        parts = graph_mix_sparse_leaves(*push, None,
                                        [x[:half] for x in xs], self0=None)
        for x, y, full, part in zip(xs, ys, whole, parts):
            if not (torch.equal(y, ref.graph_mix_sparse(*block, x, half))
                    and torch.equal(y, full[half:])
                    and torch.equal(part, ref.graph_mix_sparse(
                        *push, None, x[:half], None))):
                raise AssertionError(
                    f"CSR block/partials D={x.shape[1]} {dtype}: not the "
                    "plain version's bits")
            count += 2
    log(f"phase 3: CSR receiver block (self0 = {half} of {n} rows) and push "
        f"partials (no self term) over GN-LeNet's leaves, f32 and bf16: "
        f"{count} leaves bit for bit the plain version")


def time_ms(fn, args_list, reps=30, warmup=3):
    """Mean ms per call over ``reps`` calls cycling through ``args_list``
    (distinct buffers, more bytes than L2 holds), after a warm-up: CUDA
    events around the calls as Python makes them, so once a call's device
    work is shorter than its host cost this measures the host."""
    for args in args_list[:warmup]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, args_list, reps=30):
    """Mean device ms per call: the same ``reps`` calls as :func:`time_ms`
    captured in one CUDA graph, the graph replayed three times between
    CUDA events (after one untimed replay), so no host work lies between
    the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the default
        for args in args_list[:2]:               # stream, as capture asks
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (3 * reps)


def enqueue_us(fn, args_list, reps=30):
    """Mean host microseconds to enqueue one call: the host clock around
    ``reps`` calls with no synchronise between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def timings(kernel, library, reps=30):
    """A kernel's ``ms``, ``device_ms`` and ``host_enqueue_us``, and its
    library call's ``library_ms`` and ``library_device_ms`` (None without
    one), each ``(fn, args_list)``."""
    t = {"ms": time_ms(*kernel, reps=reps),
         "device_ms": device_ms(*kernel, reps=reps),
         "host_enqueue_us": enqueue_us(*kernel, reps=reps),
         "library_ms": None, "library_device_ms": None}
    if library is not None:
        t["library_ms"] = time_ms(*library, reps=reps)
        t["library_device_ms"] = device_ms(*library, reps=reps)
    return t


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_kernels(dev):
    from repro_torch.kernels import graph_mix, graph_mix_masked, gram_matrix
    from repro_torch.kernels import ref
    inputs, _ = kernel_cases(dev)
    n, d = MAIN_N, MAIN_D[-1]
    copies = max(3, math.ceil(120e6 / (n * d * 4)))
    sets = [inputs(n, d, torch.float32) for _ in range(copies)]
    uniform = [((e.float() + torch.eye(n, device=dev))
                / (e.float() + torch.eye(n, device=dev)).sum(1, keepdim=True),
                x) for x, _, e in sets]
    es = 4
    # W's nonzeros in the masked mix: each node's in-edges and itself.
    nnz = sum(int(e.sum()) + n for _, _, e in sets) / len(sets)
    rows = {
        "gram_matrix": dict(
            kernel=(gram_matrix, [(x,) for x, _, _ in sets]),
            plain=(ref.gram_matrix, [(x,) for x, _, _ in sets]),
            library=(lambda x: torch.matmul(x, x.T),
                     [(x,) for x, _, _ in sets]),
            # X X^T is symmetric: n (n + 1) / 2 dot products of length D.
            bytes=n * d * es + n * n * 4, flops=n * (n + 1) * d),
        "graph_mix": dict(
            kernel=(graph_mix, [(w, x) for x, w, _ in sets]),
            plain=(ref.graph_mix, [(w, x) for x, w, _ in sets]),
            library=(torch.matmul, [(w, x) for x, w, _ in sets]),
            bytes=n * n * 4 + 2 * n * d * es, flops=2 * n * n * d),
        "graph_mix_masked": dict(
            kernel=(graph_mix_masked, [(e, x) for x, _, e in sets]),
            plain=(ref.graph_mix_masked, [(e, x) for x, _, e in sets]),
            # No one PyTorch call builds W from E and applies it; the
            # product alone is timed beside it as "matmul_ms".
            library=None, matmul=(torch.matmul, uniform),
            bytes=n * n + 2 * n * d * es, flops=2 * nnz * d),
    }
    out = {}
    for name, r in rows.items():
        t = timings(r["kernel"], r["library"])
        t["plain_ms"] = time_ms(*r["plain"])
        if "matmul" in r:
            t["matmul_ms"] = time_ms(*r["matmul"])
            t["matmul_device_ms"] = device_ms(*r["matmul"])
        t["bound_ms"], t["bound_by"] = bound(r["bytes"], r["flops"])
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        t["shape"] = [n, d, "float32"]
        out[name] = t
        log(f"phase 3: {name} at n={n} D={d} f32: {json.dumps(t)}")
    return out


def tree_inputs(dev, gen, n, dtype=torch.float32, leaves=GN_LENET_LEAVES):
    """``leaves``' widths per node (GN-LeNet's ten by default) at ``n``
    nodes (``[n, D]`` each), a row-stochastic W and an in-edge matrix with
    about 3 in-edges a row."""
    xs = [torch.randn((n, d), generator=gen, device=dev).to(dtype)
          for d in leaves]
    w = torch.softmax(torch.randn((n, n), generator=gen, device=dev), 1)
    e = torch.rand((n, n), generator=gen, device=dev) < 3.0 / n
    e.fill_diagonal_(False)
    return xs, w, e


def table1_leaves():
    """The widths per node of the leaves of phase 12(a)'s model: GN-LeNet
    at ``repro_torch.bench.table1``'s defaults (width 12, 16-pixel
    images, ten classes)."""
    from repro_torch.bench import common
    from repro_torch.models import cnn_params
    exp = common.ExpConfig()
    params = cnn_params(torch.Generator().manual_seed(0), in_channels=3,
                        num_classes=exp.num_classes,
                        image_size=exp.image_size, width=exp.width)
    return tuple(v.numel() for v in params.values())


GRAM_GROUPED_N = (MAIN_N, 100, 129)          # past one 64-row Gram tile
# The host loop's populations (phase 12(a) at 16 nodes, 12(b) at HOST_N),
# the engine's at 50, and the tiled route past 128.
MIX_GROUPED_N = (16, MAIN_N, HOST_N, 129, 200, LARGE_N)


def check_grouped(dev, worst):
    """Grouped calls over a model's leaves give each leaf the bits of its
    own call, within tolerance of the plain version, and two calls on the
    same input give the same bits: the Gram over GN-LeNet's leaves at
    n = 50, 100 and 129; the dense mixes over them at n = 16, 50 and 100
    (the small route's 8 x 7 and 16 x 7 builds) and on the tiled route at
    n = 129, 200 and 1000, and over phase 12(a)'s model at n = 16."""
    from repro_torch.kernels import gram_matrices, gram_matrix, ref
    gen = torch.Generator(device=dev).manual_seed(8)
    for n in GRAM_GROUPED_N:
        for dtype in (torch.float32, torch.bfloat16):
            xs, _, _ = tree_inputs(dev, gen, n, dtype)
            g = gram_matrices(xs)
            if not torch.equal(g, gram_matrices(xs)):
                raise AssertionError(f"gram n={n} {dtype}: two calls differ")
            for i, x in enumerate(xs):
                what = f"grouped n={n} D={x.shape[1]}"
                if not torch.equal(g[i], gram_matrix(x)):
                    raise AssertionError(f"{what} {dtype}: grouped gram is "
                                         f"not the per-leaf call")
                compare("gram_matrix", _cosine(g[i]), ref.pairwise_cosine(x),
                        n, dtype, what, worst)
    leaves12 = table1_leaves()
    cases = [(n, GN_LENET_LEAVES) for n in MIX_GROUPED_N] + [(16, leaves12)]
    count = 0
    for n, leaves in cases:
        for dtype in (torch.float32, torch.bfloat16):
            xs, w, e = tree_inputs(dev, gen, n, dtype, leaves)
            count += check_grouped_mix(w, e, xs, n, dtype, worst)
    log(f"phase 3: grouped calls over GN-LeNet's {len(GN_LENET_LEAVES)} "
        f"leaves (the Gram at n = {GRAM_GROUPED_N}, the mixes at n = "
        f"{MIX_GROUPED_N}) and over phase 12(a)'s model's leaves "
        f"{leaves12} at n = 16 (the mixes; f32, bf16) equal the per-leaf "
        f"calls bit for bit and two calls give the same bits; {count} "
        f"grouped leaves of the mixes within tolerance")


def check_grouped_mix(w, e, xs, n, dtype, worst):
    """Both grouped mixes over ``xs``: each leaf the bits of its own call,
    two calls the same bits, within tolerance of the plain version;
    returns the number of leaves."""
    from repro_torch.kernels import (graph_mix, graph_mix_leaves,
                                     graph_mix_masked,
                                     graph_mix_masked_leaves, ref)
    ys = graph_mix_leaves(w, xs)
    zs = graph_mix_masked_leaves(e, xs)
    again = (graph_mix_leaves(w, xs), graph_mix_masked_leaves(e, xs))
    for i, x in enumerate(xs):
        what = f"grouped n={n} D={x.shape[1]}"
        if not (torch.equal(ys[i], again[0][i])
                and torch.equal(zs[i], again[1][i])):
            raise AssertionError(f"{what} {dtype}: two grouped mixes differ")
        if not (torch.equal(ys[i], graph_mix(w, x)) and torch.equal(
                zs[i], graph_mix_masked(e, x))):
            raise AssertionError(f"{what} {dtype}: grouped mix is not the "
                                 f"per-leaf call")
        compare("graph_mix", ys[i], ref.graph_mix(w, x), n, dtype, what,
                worst)
        compare("graph_mix_masked", zs[i], ref.graph_mix_masked(e, x), n,
                dtype, what, worst)
    return len(xs)


def _cosine(g):
    """The cosine epilogue of ``ops.pairwise_cosine`` on a Gram matrix."""
    norms = torch.sqrt(torch.diagonal(g)).clamp_min(1e-12)
    return g / (norms[:, None] * norms[None, :])


def time_tree(dev):
    """One grouped call over GN-LeNet's whole tree at n = 50 per kernel,
    beside a per-leaf loop of the library call, with the tree's bound."""
    from repro_torch.kernels import (graph_mix_leaves, graph_mix_masked_leaves,
                                     gram_matrices)
    gen = torch.Generator(device=dev).manual_seed(9)
    n, total = MAIN_N, sum(GN_LENET_LEAVES)
    copies = max(3, math.ceil(120e6 / (n * total * 4)))
    sets = [tree_inputs(dev, gen, n) for _ in range(copies)]
    uniform = []
    for xs, _, e in sets:
        a = e.float() + torch.eye(n, device=dev)
        uniform.append((a / a.sum(1, keepdim=True), xs))
    leaves, es = len(GN_LENET_LEAVES), 4
    nnz = sum(int(e.sum()) + n for _, _, e in sets) / len(sets)
    loop_mm = lambda w, xs: [torch.matmul(w, x) for x in xs]
    rows = {
        "gram_matrix": ((gram_matrices, [(xs,) for xs, _, _ in sets]),
                        (lambda xs: [x @ x.T for x in xs],
                         [(xs,) for xs, _, _ in sets]),
                        n * total * es + leaves * n * n * 4,
                        n * (n + 1) * total),
        "graph_mix": ((graph_mix_leaves, [(w, xs) for xs, w, _ in sets]),
                      (loop_mm, [(w, xs) for xs, w, _ in sets]),
                      n * n * 4 + 2 * n * total * es, 2 * n * n * total),
        "graph_mix_masked": ((graph_mix_masked_leaves,
                              [(e, xs) for xs, _, e in sets]),
                             (loop_mm, uniform),
                             n * n + 2 * n * total * es, 2 * nnz * total),
    }
    out = {}
    for name, (kernel, library, nbytes, flops) in rows.items():
        t = timings(kernel, library)
        t["library"] = ("per-leaf loop of x @ x.T" if name == "gram_matrix"
                        else "per-leaf loop of torch.matmul")
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        t["shape"] = [n, f"GN-LeNet's {leaves} leaves, {total} columns",
                      "float32"]
        out[name] = t
        log(f"phase 3: {name} grouped over the GN-LeNet tree at n={n} f32: "
            f"{json.dumps(t)}")
    return out


def time_dense_large(dev, worst):
    """The dense mixes at n = 1000, D = 51,200 (the tiled route) beside
    ``torch.matmul`` of the same W, and the Gram beside ``x @ x.T`` (held
    to its plain version there first), each with its bound."""
    from repro_torch.kernels import (graph_mix, graph_mix_masked,
                                     gram_matrix, ref)
    inputs, _ = kernel_cases(dev)
    n, d = LARGE_N, MAIN_D[-1]
    sets = [inputs(n, d, torch.float32) for _ in range(2)]
    x = sets[0][0]
    compare("gram_matrix", _cosine(gram_matrix(x)), ref.pairwise_cosine(x),
            n, torch.float32, f"n={n} D={d}", worst)
    uniform = []
    for x, _, e in sets:
        a = e.float() + torch.eye(n, device=dev)
        uniform.append((a / a.sum(1, keepdim=True), x))
    out = {}
    for name, kernel in (("graph_mix", (graph_mix, [(w, x) for x, w, _ in
                                                    sets])),
                         ("graph_mix_masked", (graph_mix_masked,
                                               [(e, x) for x, _, e in
                                                sets]))):
        library = (torch.matmul, [(w, x) for x, w, _ in sets]) \
            if name == "graph_mix" else (torch.matmul, uniform)
        t = timings(kernel, library, reps=6)
        t["library"] = "torch.matmul" + (" of the built uniform W"
                                         if name == "graph_mix_masked" else "")
        # X read once, Y written once, W read once; 2 n^2 D operations
        # (the dense product, whatever W's zeros).
        t["bound_ms"], t["bound_by"] = bound(n * n * 4 + 2 * n * d * 4,
                                             2 * n * n * d)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        t["shape"] = [n, d, "float32"]
        out[name] = t
        log(f"phase 3: {name} at n={n} D={d} f32 (tiled route): "
            f"{json.dumps(t)}")
    t = timings((gram_matrix, [(x,) for x, _, _ in sets]),
                (lambda x: x @ x.T, [(x,) for x, _, _ in sets]), reps=6)
    t["library"] = "x @ x.T"
    # X read once, the Gram written once; the kernel computes the tiles
    # i <= j only: n (n + 1) / 2 dot products of length D, an FMA a term.
    t["bound_ms"], t["bound_by"] = bound(n * d * 4 + n * n * 4,
                                         n * (n + 1) * d)
    t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
    t["shape"] = [n, d, "float32"]
    out["gram_matrix"] = t
    log(f"phase 3: gram_matrix at n={n} D={d} f32: {json.dumps(t)}")
    return out


def csr_matrix(idx, w, w_self):
    """The CSR slots as a ``torch.sparse_csr`` matrix W (self weight on
    the diagonal), for ``torch.sparse.mm``."""
    n, k = idx.shape
    diag = torch.arange(n, device=idx.device)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat([diag.repeat_interleave(k), diag]),
                     torch.cat([idx.long().reshape(-1), diag])]),
        torch.cat([w.reshape(-1), w_self]), (n, n))
    return coo.coalesce().to_sparse_csr()


def time_tree_large(dev, worst):
    """One grouped call over GN-LeNet's whole tree at n = 1000 for each
    mix (dense, masked, CSR with k = 3) and the Gram, beside a per-leaf
    loop of the library call (``torch.matmul``; of the built uniform W for
    the masked mix; ``torch.sparse.mm`` for the CSR mix; ``x @ x.T`` for
    the Gram), with the tree's bound.  The grouped Gram is first held to
    the per-leaf calls (bit for bit) and the plain version."""
    from repro_torch.kernels import (graph_mix_leaves, graph_mix_masked_leaves,
                                     graph_mix_sparse_leaves, gram_matrices,
                                     gram_matrix, ref)
    gen = torch.Generator(device=dev).manual_seed(10)
    n, total, k = LARGE_N, sum(GN_LENET_LEAVES), K
    sets = [tree_inputs(dev, gen, n) for _ in range(2)]
    g = gram_matrices(sets[0][0])
    for i, x in enumerate(sets[0][0]):
        what = f"grouped n={n} D={x.shape[1]}"
        if not torch.equal(g[i], gram_matrix(x)):
            raise AssertionError(f"{what}: grouped gram is not the per-leaf "
                                 f"call")
        compare("gram_matrix", _cosine(g[i]), ref.pairwise_cosine(x), n,
                torch.float32, what, worst)
    uniform, csr = [], []
    for xs, _, e in sets:
        a = e.float() + torch.eye(n, device=dev)
        uniform.append((a / a.sum(1, keepdim=True), xs))
        _, idx, w, w_self, _ = sparse_inputs(dev, gen, n, 1, k,
                                             torch.float32)
        csr.append(((idx.to(torch.int32).contiguous(), w, w_self, xs),
                    (csr_matrix(idx, w, w_self), xs)))
    loop_mm = lambda w, xs: [torch.matmul(w, x) for x in xs]
    loop_sp = lambda w, xs: [torch.sparse.mm(w, x) for x in xs]
    rows = {
        # X read once, Y written once, W (or E) read once; the dense mixes
        # count the dense product's 2 n^2 D operations, whatever W's zeros,
        # as at_n1000 does.
        "graph_mix": ((graph_mix_leaves, [(w, xs) for xs, w, _ in sets]),
                      (loop_mm, [(w, xs) for xs, w, _ in sets]),
                      "per-leaf loop of torch.matmul",
                      n * n * 4 + 2 * n * total * 4, 2 * n * n * total),
        "graph_mix_masked": ((graph_mix_masked_leaves,
                              [(e, xs) for xs, _, e in sets]),
                             (loop_mm, uniform),
                             "per-leaf loop of torch.matmul of the built "
                             "uniform W",
                             n * n + 2 * n * total * 4, 2 * n * n * total),
        # idx, w, w_self and X read once, Y written once; 2 (k + 1) n D.
        "graph_mix_sparse": ((graph_mix_sparse_leaves,
                              [c[0] for c in csr]),
                             (loop_sp, [c[1] for c in csr]),
                             "per-leaf loop of torch.sparse.mm",
                             n * k * 8 + n * 4 + 2 * n * total * 4,
                             2 * (k + 1) * n * total),
        # X read once, each leaf's Gram written once; tiles i <= j only.
        "gram_matrix": ((gram_matrices, [(xs,) for xs, _, _ in sets]),
                        (lambda xs: [x @ x.T for x in xs],
                         [(xs,) for xs, _, _ in sets]),
                        "per-leaf loop of x @ x.T",
                        n * total * 4 + len(GN_LENET_LEAVES) * n * n * 4,
                        n * (n + 1) * total),
    }
    out = {}
    for name, (kernel, library, label, nbytes, flops) in rows.items():
        t = timings(kernel, library, reps=6)
        t["library"] = label
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        t["shape"] = [n, f"GN-LeNet's {len(GN_LENET_LEAVES)} leaves, "
                      f"{total} columns", "float32"]
        if name == "graph_mix_sparse":
            t["shape"].insert(2, k)
        out[name] = t
        log(f"phase 3: {name} grouped over the GN-LeNet tree at n={n} f32: "
            f"{json.dumps(t)}")
    return out


def time_sparse(dev):
    """The CSR kernel at k = 3 and the largest leaf, n = 50 and 1000:
    kernel, plain version and ``torch.sparse.mm`` of the same W as a CSR
    matrix (built outside the timed region), with the bound."""
    from repro_torch.kernels import graph_mix_sparse, ref
    gen = torch.Generator(device=dev).manual_seed(2)
    d, k = MAIN_D[-1], K
    out = {}
    for n in (MAIN_N, LARGE_N):
        copies = max(3, math.ceil(120e6 / (n * d * 4)))
        sets, library = [], []
        for _ in range(copies):
            x, idx, w, w_self, _ = sparse_inputs(dev, gen, n, d, k,
                                                 torch.float32)
            sets.append((idx.to(torch.int32).contiguous(), w, w_self, x))
            library.append((csr_matrix(idx, w, w_self), x))
        t = timings((graph_mix_sparse, sets), None)
        t["plain_ms"] = time_ms(ref.graph_mix_sparse, sets)
        try:          # a yardstick only: report its absence, do not fail
            t["library_max_abs_err"] = float(
                (torch.sparse.mm(*library[0])
                 - graph_mix_sparse(*sets[0])).abs().max())
            t["library_ms"] = time_ms(torch.sparse.mm, library)
            t["library_device_ms"] = device_ms(torch.sparse.mm, library)
        except RuntimeError as err:
            log(f"phase 3: torch.sparse.mm at n={n} failed: {err}")
        # idx, w, w_self and X read once, Y written once; 2 (k + 1) n D
        # operations (each slot and the self term: a multiply, an add).
        t["bound_ms"], t["bound_by"] = bound(
            n * k * 8 + n * 4 + 2 * n * d * 4, 2 * (k + 1) * n * d)
        t["shape"] = [n, d, k, "float32"]
        out[n] = t
        log(f"phase 3: graph_mix_sparse at n={n} D={d} k={k} f32: "
            f"{json.dumps(t)}")
    return out


# Phase 3, the selective scan: (batch, L, d_inner, d_state) of
# tests/test_kernels.py's four, a ragged d_inner (its bf16 rows not 16-byte
# aligned), one step, an L that is no multiple of the kernel's 32-step
# tile, an odd d_inner (bf16 rows not 4-byte aligned) with odd L, a width
# past two blocks of channels at d_state 8, and the served shape (two
# prompts of 2,048 tokens through Jamba's d_inner 16,384 and d_state 16).
SCAN_SHAPES = [(2, 16, 64, 8), (1, 32, 128, 16), (3, 8, 96, 4),
               (2, 64, 256, 16), (2, 16, 100, 8), (2, 1, 64, 16),
               (1, 37, 96, 16), (3, 33, 37, 4), (1, 65, 300, 8)]
SERVED_SCAN = (2, 2048, 16384, 16)
# dtypes of (x, dt, b and c): all f32, all bf16, and what apply_mamba
# passes when serving bf16 (x, b, c bf16; dt f32 after the softplus).
SCAN_TYPES = {"f32": (torch.float32,) * 3, "bf16": (torch.bfloat16,) * 3,
              "serving": (torch.bfloat16, torch.float32, torch.bfloat16)}


def scan_inputs(dev, gen, bt, L, di, ds, types):
    """x, dt (post-softplus), b, c, a = -exp(.) and h0 on the card."""
    tx, tdt, tbc = types
    x = torch.randn((bt, L, di), generator=gen, device=dev).to(tx)
    dt = torch.nn.functional.softplus(torch.randn(
        (bt, L, di), generator=gen, device=dev)).to(tdt)
    b = (torch.randn((bt, L, ds), generator=gen, device=dev) * 0.5).to(tbc)
    c = (torch.randn((bt, L, ds), generator=gen, device=dev) * 0.5).to(tbc)
    a = -torch.exp(torch.randn((di, ds), generator=gen, device=dev) * 0.3)
    h0 = torch.randn((bt, di, ds), generator=gen, device=dev) * 0.1
    return x, dt, b, c, a, h0


def check_scan(dev, worst):
    """The scan kernel against its plain version at every phase-3 shape and
    type, and two chained halves against one call at the served shape."""
    from repro_torch.kernels import ref, selective_scan
    gen = torch.Generator(device=dev).manual_seed(4)
    worst["selective_scan"] = {"float32": 0.0, "bfloat16": 0.0}
    count = 0
    for shape in SCAN_SHAPES + [SERVED_SCAN]:
        for label, types in SCAN_TYPES.items():
            args = scan_inputs(dev, gen, *shape, types)
            key = torch.float32 if label == "f32" else torch.bfloat16
            (y, h), (yr, hr) = selective_scan(*args), ref.selective_scan(*args)
            for got, want in ((y, yr), (h, hr)):
                if got.dtype != torch.float32:
                    raise AssertionError(f"selective_scan returned "
                                         f"{got.dtype}, not f32")
                compare("selective_scan", got, want, shape[0], key,
                        f"{shape} {label}", worst)
            count += 1
    x, dt, b, c, a, h0 = scan_inputs(dev, gen, *SERVED_SCAN,
                                     SCAN_TYPES["serving"])
    y, h = selective_scan(x, dt, b, c, a, h0)
    cut = SERVED_SCAN[1] // 2
    y1, h1 = selective_scan(*(t[:, :cut].contiguous()
                              for t in (x, dt, b, c)), a, h0)
    y2, h2 = selective_scan(*(t[:, cut:].contiguous()
                              for t in (x, dt, b, c)), a, h1)
    compare("selective_scan", torch.cat([y1, y2], 1), y, 2, torch.bfloat16,
            "chained halves (y)", worst)
    compare("selective_scan", h2, h, 2, torch.bfloat16,
            "chained halves (h)", worst)
    log(f"phase 3: {count} scan kernel/plain comparisons within (atol, "
        f"rtol) {SCAN_TOL} (shapes {SCAN_SHAPES + [SERVED_SCAN]}, types "
        f"{list(SCAN_TYPES)}), chained halves at {SERVED_SCAN} equal one "
        f"call; worst {json.dumps(worst['selective_scan'])}")


def sm_clock_hz():
    """The SM clock ``nvidia-smi`` reports as the card's maximum."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


# The scan kernels' instantiations for the served types (d_state 16; x, b
# and c bf16, dt f32), as their mangled names show them in the SASS.
SCAN_SERVED_SASS = ("scan_kernelILi16E", "13__nv_bfloat16fS")
SCAN_BWD_SERVED_SASS = ("scan_bwd_kernelILi16E", "13__nv_bfloat16fS")
# The backward's window a lane: 8 steps of 4 states (kSeg x kSpl in
# selective_scan_bwd.cu), the elements its unrolled steps cover.
SCAN_BWD_WINDOW_ELEMENTS = 8 * 4
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")


def sass_blocks(library, patterns):
    """The straight-line blocks (split at labels, branches and exits) of
    the one function of ``library``'s built SASS (``cuobjdump -sass``)
    whose mangled name holds every string in ``patterns``, as lists of
    opcodes; and that name."""
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(cuda.library_path(library))],
        capture_output=True, text=True, check=True).stdout
    functions, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            functions[name] = []
        elif name is not None:
            functions[name].append(line)
    served = [f for f in functions if all(p in f for p in patterns)]
    if len(served) != 1:
        raise AssertionError(f"{library} SASS: {len(served)} functions match "
                             f"{patterns}")
    blocks, block = [], []
    for line in functions[served[0]]:
        if re.match(r"\s*\.L_x_\d+:", line):
            blocks.append(block)
            block = []
            continue
        op = SASS_LINE.search(line)
        if op:
            block.append(op.group(1))
            if op.group(1).startswith(("BRA", "EXIT")):
                blocks.append(block)
                block = []
    return blocks + [block], served[0]


def per_element(step, function, elements=None):
    """Counts of the opcodes in ``step``, a straight run of code over
    ``elements`` elements (default: its ``MUFU.EX2`` count, one exponential
    an element), per element: ``all``, ``fp32`` (FFMA, FADD and FMUL, the
    FP32 pipe), ``mufu``."""
    if step.count("MUFU.EX2") == 0:
        raise AssertionError(f"{function}: no MUFU.EX2 in the inner step")
    elements = elements or step.count("MUFU.EX2")
    ops = {}
    for op in step:
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    fp32 = sum(ops.get(k, 0) for k in ("FFMA", "FADD", "FMUL"))
    return {"function": function, "block_instructions": len(step),
            "elements": elements, "all": len(step) / elements,
            "fp32": fp32 / elements, "mufu": ops.get("MUFU", 0) / elements,
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def scan_sass():
    """Instructions per (t, channel, state) element in the scan kernel's
    inner step, read from the built library's SASS: in the served
    instantiation, the largest straight-line block (the unrolled full-tile
    steps with their loop's own count and branch) holds one ``MUFU.EX2``
    per element, so its counts over its ``MUFU.EX2`` count are per element
    (:func:`per_element`); the per-tile staging outside that block is left
    out."""
    blocks, function = sass_blocks("selective_scan", SCAN_SERVED_SASS)
    return per_element(max(blocks, key=len), function)


def scan_bwd_sass():
    """Instructions per (t, channel, state) element in the backward
    kernel's window, read from the built library's SASS: in the served
    instantiation, the blocks that hold a ``MUFU.EX2`` are the window's
    unrolled recompute and backward walk, :data:`SCAN_BWD_WINDOW_ELEMENTS`
    elements a lane, so their counts over that are per element
    (:func:`per_element`; ``mufu`` above 1 where the compiler took an
    exponential again rather than keep it in a register); the window's
    staging, b and c orders and epilogue outside them are left out, and
    reported apart as ``outside_block_instructions`` (the rest of the
    function's code, each instruction once, whatever its trip count)."""
    blocks, function = sass_blocks("selective_scan_bwd",
                                   SCAN_BWD_SERVED_SASS)
    step = [op for b in blocks if "MUFU.EX2" in b for op in b]
    per = per_element(step, function, SCAN_BWD_WINDOW_ELEMENTS)
    per["blocks"] = sum(1 for b in blocks if "MUFU.EX2" in b)
    per["outside_block_instructions"] = sum(
        len(b) for b in blocks if "MUFU.EX2" not in b)
    return per


def time_scan(dev):
    """The scan kernel at the served shape with apply_mamba's types, inputs
    rotated through more than L2; the plain version (a loop of PyTorch
    operations over L, no yardstick) beside it.  No one PyTorch call
    computes the S6 recurrence, so there is no library time.  The bound is
    the largest of four parts, each counted from the function and not from
    this kernel: the bytes; the exponentials on the special-function unit;
    the FP32-pipe instructions (``SCAN_FP32_PER_ELEMENT``) at 128 lanes a
    clock per SM; and their issue together with the exponentials', one
    warp-instruction a clock per scheduler.  ``kernel_issue_ms`` prices
    every instruction the kernel's inner step issues (:func:`scan_sass`)
    the same way; it is this kernel's own cost, not a bound."""
    from repro_torch.kernels import ref, selective_scan
    gen = torch.Generator(device=dev).manual_seed(5)
    bt, L, di, ds = SERVED_SCAN
    sets = [scan_inputs(dev, gen, *SERVED_SCAN, SCAN_TYPES["serving"])
            for _ in range(3)]
    t = {**timings((selective_scan, sets), None, reps=10),
         "plain_ms": time_ms(ref.selective_scan, sets, reps=2, warmup=1),
         "library": "none: no single PyTorch call computes the S6 "
                    "recurrence (a scan with an input-dependent decay)"}
    # Each input read once, y and the last h written once (f32).
    nbytes = sum(v.numel() * v.element_size() for v in sets[0]) \
        + bt * L * di * 4 + bt * di * ds * 4
    elements = bt * L * di * ds
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = scan_sass()
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "mufu": elements * SCAN_MUFU_PER_ELEMENT
             / (SFU_PER_CLOCK_PER_SM * sms * clock) * 1e3,
             "f32_issue": elements * SCAN_FP32_PER_ELEMENT
             / (FP32_PER_CLOCK_PER_SM * sms * clock) * 1e3,
             "issue": elements
             * (SCAN_FP32_PER_ELEMENT + SCAN_MUFU_PER_ELEMENT)
             / (ISSUE_PER_CLOCK_PER_SM * sms * clock) * 1e3}
    t["bound_ms"] = max(times.values())
    t["bound_part"] = max(times, key=times.get)
    t["bound_by"] = "bytes" if t["bound_part"] == "bytes" else "operations"
    t["bound_parts_ms"] = times
    t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
    t["kernel_issue_ms"] = elements * per["all"] \
        / (ISSUE_PER_CLOCK_PER_SM * sms * clock) * 1e3
    t["sass_per_element"] = per
    t["sm_clock_mhz"], t["sms"] = clock / 1e6, sms
    t["shape"] = [bt, L, di, ds, "x bf16, dt f32, b/c bf16"]
    log(f"phase 3: selective_scan at {SERVED_SCAN}: {json.dumps(t)}")
    return t


# ---------------------------------------------------------------------------
# Phases 4-6: the main path.
# ---------------------------------------------------------------------------

def paper_setup(n, dev, image_size=32, width=32, classes=10, samples=6000,
                test=512, stream=True, equal_shards=False, seed=0,
                alpha=None):
    from repro_torch.data import (DeviceDataStream, StackedBatcher,
                                  dirichlet_partition,
                                  make_image_classification,
                                  train_test_split)
    from repro_torch.models import cnn_params
    ds = make_image_classification(samples, num_classes=classes,
                                   image_size=image_size, channels=3,
                                   noise=3.0, seed=seed)
    tr, te = train_test_split(ds, 0.2, seed=seed)
    if alpha is None:
        alpha = 0.1 if stream else 0.5
    # Equal shards (fig12's fixture) where Dirichlet(0.1) would leave
    # some of n nodes without a sample.
    parts = np.array_split(np.arange(len(tr.labels)), n) if equal_shards \
        else dirichlet_partition(tr.labels, n, alpha,
                                 np.random.default_rng(seed))
    batcher = DeviceDataStream(tr, parts, 8, seed=seed + 3, device=dev) \
        if stream else StackedBatcher(tr, parts, 8, seed=seed + 3)
    init = lambda g: cnn_params(g, in_channels=3, num_classes=classes,
                                image_size=image_size, width=width)
    return batcher, {"images": te.images[:test],
                     "labels": te.labels[:test]}, init


def make_strategy(name, n, dev, seed=0):
    from repro_torch import core, sparse
    k = min(K, n - 1)
    if name == "sparse-morph":
        return sparse.SparseMorphStrategy(n=n, k=k, delta_r=DELTA_R,
                                          seed=seed, device=dev)
    if name == "sparse-epidemic":
        return sparse.SparseEpidemicStrategy(n=n, k=k, seed=seed, device=dev)
    if name == "morph":
        return core.InGraphMorphStrategy(n=n, k=k, view_size=k + 2,
                                         beta=500.0, delta_r=DELTA_R,
                                         seed=seed, device=dev)
    if name == "static":
        deg = k if (n * k) % 2 == 0 else k + 1
        return core.InGraphStaticStrategy(n=n, degree=deg, seed=seed,
                                          device=dev)
    if name == "el-oracle":
        return core.InGraphEpidemicStrategy(n=n, k=k, seed=seed, device=dev)
    return core.InGraphFullyConnectedStrategy(n=n, device=dev)


STRATEGIES = ("morph", "static", "el-oracle", "fully-connected")
SPARSE_STRATEGIES = ("sparse-morph", "sparse-epidemic")
# The n = 1000 set-up: equal shards of 12,000 training samples, 256 test
# images, evaluation 16 test images at a time ([1000, 16, ...] batches).
LARGE = dict(samples=15000, test=256, equal_shards=True)


def make_runner(name, n, dev, rounds, eval_every, engine="dense",
                sparse_mix="exact", eval_chunk=128, compress="none",
                net=None, strategy=None, compiled=None, mesh_devices=None,
                collective="gather", **setup):
    from repro_torch.dlrt import DecentralizedRunner, RunnerConfig
    from repro_torch.models import cnn_loss
    from repro_torch.optim import sgd
    batcher, test, init = paper_setup(n, dev, **setup)
    return DecentralizedRunner(
        init_fn=init, loss_fn=cnn_loss, eval_fn=cnn_loss,
        optimizer=sgd(0.05), batcher=batcher, test_batch=test,
        strategy=strategy or make_strategy(name, n, dev),
        cfg=RunnerConfig(n_nodes=n, rounds=rounds, eval_every=eval_every,
                         eval_batch_chunk=eval_chunk, engine=engine,
                         sparse_mix=sparse_mix, compress=compress, net=net,
                         compiled=compiled, mesh_devices=mesh_devices,
                         collective=collective),
        device=dev)


def run_strategy(name, n, dev, rounds, eval_every, **kw):
    runner = make_runner(name, n, dev, rounds, eval_every, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def main_path(dev):
    from repro_torch import kernels
    from repro_torch.kernels import (graph_mix, graph_mix_masked,
                                     gram_matrix, selective_scan_bwd)
    # One-time costs (cuDNN and CUDA context set-up, first calls of each
    # operator) land in a two-round warm-up, not in the first strategy.
    run_strategy("morph", MAIN_N, dev, 2, DELTA_R)
    kernels.reset_launches()
    for name in STRATEGIES:
        before = (gram_matrix.launches, graph_mix_masked.launches,
                  graph_mix.launches)
        runner, wall = run_strategy(name, MAIN_N, dev, ROUNDS, DELTA_R)
        got = tuple(b - a for a, b in zip(before, (
            gram_matrix.launches, graph_mix_masked.launches,
            graph_mix.launches)))
        # One grouped launch per call site per round, over all ten leaves.
        uniform = name in ("morph", "el-oracle")
        want = (ROUNDS if name == "morph" else 0, ROUNDS if uniform else 0,
                0 if uniform else ROUNDS)
        if got != want:
            raise AssertionError(f"{name}: launches (gram, masked, mix) "
                                 f"{got} != {want}")
        recs = runner.log.records
        last = runner.edge_history[-1]
        if not all(np.isfinite(r.mean_loss) for r in recs):
            raise AssertionError(f"{name}: non-finite loss")
        for p in runner.params.values():
            if not torch.isfinite(p).all():
                raise AssertionError(f"{name}: non-finite parameters")
        indeg = np.stack(runner.edge_history).sum(axis=2)
        if name == "morph" and indeg.max() > K:
            raise AssertionError(f"morph in-degree {indeg.max()} > {K}")
        if name == "el-oracle" and not (
                np.stack(runner.edge_history).sum(axis=1) == K).all():
            raise AssertionError("el-oracle out-degree != k")
        if name in ("static", "fully-connected") and any(
                r.isolated for r in recs):
            raise AssertionError(f"{name}: isolated nodes on a fixed graph")
        if recs[-1].isolated != int((last.sum(axis=1) == 0).sum()):
            raise AssertionError(f"{name}: isolated count disagrees")
        summary = {
            "ms_per_round_incl_eval": wall / ROUNDS * 1e3,
            "accuracy": recs[-1].mean_accuracy,
            "loss": recs[-1].mean_loss, "isolated": recs[-1].isolated,
            "max_in_degree": int(indeg.max()),
            "launches": dict(zip(("gram_matrix", "graph_mix_masked",
                                  "graph_mix"), got))}
        log(f"phase 4: {name} n={MAIN_N} {ROUNDS} rounds: "
            f"{json.dumps(summary)}")
    if selective_scan_bwd.launches:
        raise AssertionError(f"phase 4 launched the scan's backward "
                             f"{selective_scan_bwd.launches} times")
    return {"gram_matrix": gram_matrix.launches,
            "graph_mix": graph_mix.launches,
            "graph_mix_masked": graph_mix_masked.launches,
            "selective_scan_bwd": selective_scan_bwd.launches}


def morph_breakdown(dev, n=MAIN_N, rounds=10, phase=5, **setup):
    """Host-clock time of each stage of a full-width Morph round at ``n``
    nodes (every stage ends in a synchronise, so stages do not overlap)."""
    from repro_torch.dlrt import RunnerConfig, Superstep
    from repro_torch.dlrt.runtime import to_device
    from repro_torch.models import cnn_loss
    from repro_torch.optim import sgd
    from repro_torch.kernels import ops
    from repro_torch.tree import stack
    batcher, test, init = paper_setup(n, dev, **setup)
    gen = torch.Generator().manual_seed(0)
    params = stack(init(gen) for _ in range(n))
    params = type(params)((k, v.to(dev)) for k, v in params.items())
    opt = sgd(0.05)
    strategy = make_strategy("morph", n, dev)
    eng = Superstep(loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=opt,
                    batcher=batcher, test_batch=to_device(test, dev),
                    strategy=strategy,
                    cfg=RunnerConfig(n_nodes=n, rounds=rounds,
                                     eval_batch_chunk=16 if n > MAIN_N
                                     else None),
                    params=params, opt_state=opt.init(params), device=dev)
    stages = {"batch": 0.0, "local_step": 0.0, "similarity": 0.0,
              "graph_round": 0.0, "mix": 0.0}

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] += time.perf_counter() - t0
        return out

    eng.round(0)                                   # warm-up
    for rnd in range(1, rounds + 1):
        batch = timed("batch", lambda: eng._batch(rnd))
        eng.params, eng.opt_state = timed(
            "local_step", lambda: eng._local_step(eng.params, eng.opt_state,
                                                  batch))
        eng.sim = timed("similarity",
                        lambda: ops.model_pairwise_cosine(eng.params))
        eng.gstate, edges, _ = timed(
            "graph_round", lambda: strategy.graph_round(eng.gstate, rnd,
                                                        eng.sim))
        eng.params = timed("mix", lambda: ops.mix_masked_pytree(edges,
                                                                 eng.params))
    t_eval = time.perf_counter()
    eng.evaluate(rounds, edges.cpu().numpy())
    torch.cuda.synchronize()
    out = {k: v / rounds * 1e3 for k, v in stages.items()}
    out["evaluate_ms_once"] = (time.perf_counter() - t_eval) * 1e3
    log(f"phase {phase}: morph n={n} round stages, ms per round "
        f"(negotiation every {DELTA_R}th): {json.dumps(out)}")
    return out


def launch_counts():
    from repro_torch.kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def sparse_path(dev):
    """Phase 7: the sparse engine's runs, each with its counts set to 0
    just before it and read just after; returns the CSR kernel's launches
    over the phase."""
    from repro_torch import kernels
    from repro_torch.dlrt import stacked_model_bytes
    sparse_launches = 0
    runs = [("sparse-morph", MAIN_N, dict(engine="sparse")),
            ("sparse-epidemic", MAIN_N, dict(engine="sparse")),
            ("static", MAIN_N, dict(engine="sparse", sparse_mix="gather")),
            ("sparse-morph", LARGE_N, dict(engine="sparse", eval_chunk=16,
                                           **LARGE))]
    for name, n, kw in runs:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        runner, wall = run_strategy(name, n, dev, ROUNDS, DELTA_R, **kw)
        got = launch_counts()
        want = dict.fromkeys(got, 0)
        want["graph_mix_sparse"] = ROUNDS        # one grouped launch a round
        if got != want:
            raise AssertionError(f"{name} n={n}: launches {got} != {want}")
        sparse_launches += got["graph_mix_sparse"]
        edges = np.stack(runner.edge_history)            # [R, n, n]
        if not (edges.sum(axis=2) == K).all():
            raise AssertionError(f"{name} n={n}: in-degree is not {K}")
        if edges[:, np.arange(n), np.arange(n)].any():
            raise AssertionError(f"{name} n={n}: a self-loop")
        recs = runner.log.records
        if not all(np.isfinite(r.mean_loss) for r in recs):
            raise AssertionError(f"{name} n={n}: non-finite loss")
        for p in runner.params.values():
            if not torch.isfinite(p).all():
                raise AssertionError(f"{name} n={n}: non-finite parameters")
        model_bytes = stacked_model_bytes(runner.params, n)
        if recs[-1].comm_bytes != ROUNDS * n * K * model_bytes:
            raise AssertionError(f"{name} n={n}: comm_bytes "
                                 f"{recs[-1].comm_bytes} != rounds n k "
                                 f"model_bytes")
        summary = {
            "engine": kw["engine"], "sparse_mix": kw.get("sparse_mix"),
            "ms_per_round_incl_eval": wall / ROUNDS * 1e3,
            "accuracy": recs[-1].mean_accuracy, "loss": recs[-1].mean_loss,
            "isolated": recs[-1].isolated, "comm_bytes": recs[-1].comm_bytes,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": got}
        log(f"phase 7: {name} n={n} {ROUNDS} rounds: {json.dumps(summary)}")

    # Compat exact against the dense engine, bitwise: both runs with
    # deterministic cuDNN algorithms, so the local steps agree bit for bit.
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launches()
        dense, _ = run_strategy("morph", MAIN_N, dev, ROUNDS, DELTA_R)
        dense_counts = launch_counts()
        kernels.reset_launches()
        exact, _ = run_strategy("morph", MAIN_N, dev, ROUNDS, DELTA_R,
                                engine="sparse", sparse_mix="exact")
        exact_counts = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    if exact_counts != dense_counts or exact_counts["graph_mix_sparse"]:
        raise AssertionError(f"compat exact launches {exact_counts} != "
                             f"dense {dense_counts}")
    same = all(np.array_equal(a, b) for a, b in
               zip(dense.edge_history, exact.edge_history)) \
        and all(torch.equal(dense.params[k], exact.params[k])
                for k in dense.params) \
        and [(r.comm_bytes, r.mean_accuracy, r.mean_loss)
             for r in dense.log.records] == \
        [(r.comm_bytes, r.mean_accuracy, r.mean_loss)
         for r in exact.log.records]
    if not same:
        raise AssertionError("compat exact is not bitwise the dense engine")
    log(f"phase 7: compat exact morph n={MAIN_N}: bitwise the dense engine "
        f"(edges, parameters, records); launches {json.dumps(exact_counts)}")
    return sparse_launches


def sparse_breakdown(dev, rounds=10):
    """Host-clock time of each stage of a sparse Morph round at n = 1000
    (every stage ends in a synchronise); the graph round apart for its
    negotiation rounds and its hold rounds."""
    from repro_torch.dlrt import RunnerConfig, Superstep
    from repro_torch.dlrt.runtime import to_device
    from repro_torch.models import cnn_loss
    from repro_torch.optim import sgd
    from repro_torch.sparse import sparse_mix_pytree
    from repro_torch.tree import stack
    n = LARGE_N
    batcher, test, init = paper_setup(n, dev, **LARGE)
    gen = torch.Generator().manual_seed(0)
    params = stack(init(gen) for _ in range(n))
    params = type(params)((k, v.to(dev)) for k, v in params.items())
    opt = sgd(0.05)
    strategy = make_strategy("sparse-morph", n, dev)
    eng = Superstep(loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=opt,
                    batcher=batcher, test_batch=to_device(test, dev),
                    strategy=strategy,
                    cfg=RunnerConfig(n_nodes=n, rounds=rounds,
                                     engine="sparse"),
                    params=params, opt_state=opt.init(params), device=dev)
    stages = dict.fromkeys(("batch", "local_step", "negotiation", "hold",
                            "mix"), 0.0)

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] += time.perf_counter() - t0
        return out

    eng.round(0)                                   # warm-up (negotiates)
    for rnd in range(1, rounds + 1):
        batch = timed("batch", lambda: eng._batch(rnd))
        eng.params, eng.opt_state = timed(
            "local_step", lambda: eng._local_step(eng.params, eng.opt_state,
                                                  batch))
        stage = "negotiation" if rnd % DELTA_R == 0 else "hold"
        eng.gstate, adj = timed(stage, lambda: strategy.graph_round(
            eng.gstate, rnd, eng.params))
        eng.params = timed("mix", lambda: sparse_mix_pytree(adj,
                                                            eng.params))
    negotiations = rounds // DELTA_R
    out = {k: stages[k] / rounds * 1e3 for k in ("batch", "local_step",
                                                   "mix")}
    out["graph_round"] = (stages["negotiation"] + stages["hold"]) \
        / rounds * 1e3
    out["negotiation_ms_each"] = stages["negotiation"] / negotiations * 1e3
    out["hold_ms_each"] = stages["hold"] / (rounds - negotiations) * 1e3
    log(f"phase 8: sparse morph n={n} round stages, ms per round "
        f"(negotiation every {DELTA_R}th): {json.dumps(out)}")
    return out


DENSE_LARGE_ROUNDS = 5


def dense_large(dev):
    """Phase 8, fig12's dense row: dense Morph at n = 1000 on the sparse
    n = 1000 run's set-up through ``DecentralizedRunner``, with its counts
    set to 0 just before and read just after (one grouped Gram launch and
    one grouped masked mix a round, on the tiled route), then where its
    round's time goes."""
    from repro_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runner, wall = run_strategy("morph", LARGE_N, dev, DENSE_LARGE_ROUNDS,
                                DELTA_R, eval_chunk=16, **LARGE)
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), gram_matrix=DENSE_LARGE_ROUNDS,
                graph_mix_masked=DENSE_LARGE_ROUNDS)
    if got != want:
        raise AssertionError(f"dense morph n={LARGE_N}: launches {got} != "
                             f"{want}")
    recs = runner.log.records
    indeg = np.stack(runner.edge_history).sum(axis=2)
    if not all(np.isfinite(r.mean_loss) for r in recs) or not all(
            torch.isfinite(p).all() for p in runner.params.values()):
        raise AssertionError(f"dense morph n={LARGE_N}: non-finite values")
    if indeg.max() > K:
        raise AssertionError(f"dense morph n={LARGE_N}: in-degree "
                             f"{indeg.max()} > {K}")
    summary = {"engine": "dense",
               "ms_per_round_incl_eval": wall / DENSE_LARGE_ROUNDS * 1e3,
               "accuracy": recs[-1].mean_accuracy, "loss": recs[-1].mean_loss,
               "isolated": recs[-1].isolated,
               "max_in_degree": int(indeg.max()),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": got}
    log(f"phase 8: morph n={LARGE_N} {DENSE_LARGE_ROUNDS} rounds (dense, "
        f"fig12's dense row): {json.dumps(summary)}")
    return morph_breakdown(dev, LARGE_N, rounds=DENSE_LARGE_ROUNDS, phase=8,
                           **LARGE)


def reference_check(dev):
    """Tiny GN-LeNet runs on the card and on the CPU from the same
    parameters, batches and (host-drawn) controller noise."""
    tiny = dict(image_size=8, width=4, classes=4, samples=400, test=100,
                stream=False)
    for name in STRATEGIES + SPARSE_STRATEGIES:
        engine = "sparse" if name in SPARSE_STRATEGIES else "dense"
        gpu, _ = run_strategy(name, 6, dev, 11, 5, engine=engine, **tiny)
        cpu, _ = run_strategy(name, 6, torch.device("cpu"), 11, 5,
                              engine=engine, **tiny)
        for r, (a, b) in enumerate(zip(gpu.edge_history, cpu.edge_history)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: card and CPU edges differ "
                                     f"at round {r}")
        err = max(float((gpu.params[k].cpu() - cpu.params[k]).abs().max())
                  for k in cpu.params)
        if not err <= 1e-4:
            raise AssertionError(f"{name}: card vs CPU params {err} > 1e-4")
        log(f"phase 6: {name} tiny run, card == CPU edges over 11 rounds, "
            f"params max |err| {err:.3g}")


# ---------------------------------------------------------------------------
# Phases 6 and 9: the model zoo's serving path (Jamba without experts).
# ---------------------------------------------------------------------------

PROMPT_LEN, PREFILLS = 2048, 3             # phase 9(a): 2 prompts each
REQUESTS, REQUEST_LEN, NEW_TOKENS = 4, 64, 32   # phase 9(b), (c)
# Phase 9(c): prefill against decode logits.  In bf16 the two paths take
# products of other shapes (M = 256 rows against M = 4), so an f32 sum a
# hair apart now and then rounds to another bf16 value; each such flip
# (one bf16 ulp, 2^-8) travels through the later layers.  On the CPU at
# this configuration's widths cut to d_model 512, 1024 and 2048 the largest
# logit difference was 2.6 to 6.1 bf16 ulps of the largest logit, growing
# 1.3 to 1.55 times per doubling of width, which put d_model 8192 at
# 10 to 21.  Two runs on the H100 read 5.6 ulps (the same bits twice), so
# the bf16 limit is that reading with room for decode's blockwise
# attention and the LM head's cuBLAS product, which sum in other orders:
# 16 ulps (2^-4) of the largest logit.  The same weights in f32 remove
# the rounding: there the two paths must agree within
# tests/test_arch_smoke.py's prefill/decode tolerance.
PREFILL_DECODE_BF16 = 16 * 2.0 ** -8
PREFILL_DECODE_F32 = dict(atol=2e-4, rtol=1e-3)
# Phase 9(e): cache lengths, and the most a decode step's transient
# memory may grow per (request, query head, slot) between them: the f32
# scores, their softmax and the bf16 probabilities of one attention layer
# take 10 bytes; a copy of one layer's K and V would take
# 2 x 2 x 8 x 128 / 64 = 64.
DECODE_CACHE_LENS = (2048, 16384)
DECODE_TRANSIENT_PER_SLOT = 16
# Phase 9(e): the card's LM head against the f32 product of the same bf16
# values: both sum 8,192 exact products in f32, in other orders.
LM_HEAD_TOL = dict(atol=1e-4, rtol=1e-5)


def jamba_serving_config():
    """Jamba-1.5-Large at its published widths, one whole period of 8
    layers (7 Mamba, attention at index 4), and every MoE layer Jamba's
    dense SwiGLU at d_ff 24,576: a period with its four MoE layers of 16
    experts (some 44 B parameters, 88 GB in bf16) does not fit one card
    (phase 18(c) runs one such layer)."""
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        cfg, num_layers=len(cfg.pattern), moe=None,
        pattern=tuple(dataclasses.replace(s, moe=False) for s in cfg.pattern))


def zoo_reference_check(dev):
    """Reduced Jamba without experts (f32) on the card and on the CPU from
    the same parameters and prompts: logits within 1e-4, greedy tokens
    identical."""
    from repro_torch import kernels
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = jamba_serving_config().reduced()
    cpu = model.init_params(cfg, 0, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(6))
    kernels.reset_launches()
    got, _ = model.forward(gpu, {"tokens": tokens.to(dev)}, cfg)
    launches = launch_counts()["selective_scan"]
    want, _ = model.forward(cpu, {"tokens": tokens}, cfg)
    err = float((got.cpu() - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"reduced jamba: card vs CPU logits {err} > "
                             f"1e-4")
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern)
    if launches != n_mamba:
        raise AssertionError(f"reduced jamba forward: {launches} scan "
                             f"launches, not {n_mamba}")
    toks_gpu = model.greedy_generate(gpu, cfg, tokens[:, :8].to(dev), 8)
    toks_cpu = model.greedy_generate(cpu, cfg, tokens[:, :8], 8)
    if not torch.equal(toks_gpu.cpu(), toks_cpu):
        raise AssertionError(f"reduced jamba: greedy tokens differ, card "
                             f"{toks_gpu.tolist()} CPU {toks_cpu.tolist()}")
    log(f"phase 6: reduced jamba (no experts, f32) card == CPU: logits max "
        f"|err| {err:.3g} over [2, 32, {cfg.vocab_size}], {launches} scan "
        f"launches in the card's forward, 8 greedy tokens identical")


def synced(fn, *args, **kw):
    """``fn``'s result and its ms on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def staged_forward(params, tokens, cfg, patched):
    """One ``forward(last_only=True)`` over ``tokens`` (or a whole batch
    dict) with each function of ``patched`` (``(module, attribute,
    stage)`` triples) synchronised on the host clock and its ms added to
    its stage; the wrappers are put back afterwards.  Returns (ms by
    stage, the forward's total ms)."""
    from repro_torch.models import model
    stages = {stage: 0.0 for _, _, stage in patched}
    originals = [getattr(mod, name) for mod, name, _ in patched]

    def timed(fn, stage):
        def run(*args, **kw):
            out, ms = synced(fn, *args, **kw)
            stages[stage] += ms
            return out
        return run

    try:
        for (mod, name, stage), fn in zip(patched, originals):
            setattr(mod, name, timed(fn, stage))
        batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        _, total = synced(model.forward, params, batch, cfg, last_only=True)
    finally:
        for (mod, name, _), fn in zip(patched, originals):
            setattr(mod, name, fn)
    return stages, total


def prefill_breakdown(params, tokens, cfg):
    """Phase 9(d): one prefill with each stage synchronised on the host
    clock."""
    from repro_torch.models import attention, layers, mamba, transformer
    stages, total = staged_forward(params, tokens, cfg, [
        (mamba, "apply_mamba", "mamba"), (mamba, "selective_scan", "scan"),
        (attention, "self_attention", "attention"),
        (layers, "apply_mlp", "mlp"), (layers, "apply_norm", "norms"),
        (transformer, "_lm_logits", "lm_head")])
    out = {"total": total,
           "mamba_projections_conv_gates": stages["mamba"] - stages["scan"],
           "scan_kernel": stages["scan"], "attention": stages["attention"],
           "mlps": stages["mlp"], "norms": stages["norms"],
           "lm_head": stages["lm_head"]}
    out["other"] = total - sum(stages.values()) + stages["scan"]
    return out


def prefill_vs_decode(a, b):
    return {"max_abs_diff": float((a - b).abs().max()),
            "max_abs_logit": float(a.abs().max()),
            "same_argmax": int((a.argmax(-1) == b.argmax(-1)).sum())}


def decode_memory(params, cfg, dev, gen):
    """Phase 9(e): one decode step's transient device memory (its peak
    above what was allocated before it) at two cache lengths."""
    from repro_torch.models import model
    tok = torch.randint(0, cfg.vocab_size, (REQUESTS, 1), generator=gen,
                        device=dev)
    out = {}
    for max_len in DECODE_CACHE_LENS:
        cache = model.init_cache(cfg, REQUESTS, max_len, device=dev)
        model.decode_step(params, cache, tok, 0, cfg)          # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, ms = synced(model.decode_step, params, cache, tok, max_len - 1,
                       cfg)
        out[max_len] = {"transient_bytes":
                        torch.cuda.max_memory_allocated() - base,
                        "step_ms": ms}
        del cache
    lo, hi = DECODE_CACHE_LENS
    grew = out[hi]["transient_bytes"] - out[lo]["transient_bytes"]
    allowed = (hi - lo) * REQUESTS * cfg.num_heads \
        * DECODE_TRANSIENT_PER_SLOT
    return out, grew, allowed


def lm_head_check(params, cfg, dev, gen):
    """Phase 9(e): ``_lm_logits`` on the card (bf16 product, f32 output)
    against the f32 product of the same bf16 values."""
    from repro_torch.models import transformer
    x = torch.randn((REQUESTS, 1, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    got = transformer._lm_logits(params, x, cfg)
    want = x.float() @ params["lm_head"]["w"].float()
    torch.testing.assert_close(got, want, **LM_HEAD_TOL)
    return float((got - want).abs().max())


def serve_jamba(dev):
    """Phase 9: the serving path at full width.  Returns the scan kernel's
    launches over 9(a)'s prefills, the main path's run."""
    from repro_torch import kernels
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = jamba_serving_config()
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern)
    di = cfg.ssm.expand * cfg.d_model
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced(model.init_params, cfg, 0, device=dev)
    count = model.param_count(params)
    if count != cfg.param_count() + n_mamba * 2 * di + cfg.d_model:
        raise AssertionError(f"jamba: {count} parameters")
    log(f"phase 9: {cfg.name} one period, no experts, {cfg.param_dtype}: "
        f"{count} "
        f"parameters, {model.param_bytes(params)} bytes, drawn on the card "
        f"in {init_ms:.1f} ms")
    gen = torch.Generator(device=dev).manual_seed(7)
    want = dict.fromkeys(launch_counts(), 0)

    # (a) prefill: two prompts of 2,048 tokens, last-position logits.
    prompts = torch.randint(0, cfg.vocab_size, (2, PROMPT_LEN),
                            generator=gen, device=dev)
    model.forward(params, {"tokens": prompts}, cfg, last_only=True)  # warm
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prefill_ms = []
    for _ in range(PREFILLS):
        (logits, _), ms = synced(model.forward, params, {"tokens": prompts},
                                 cfg, last_only=True)
        prefill_ms.append(ms)
    got = launch_counts()
    if got != dict(want, selective_scan=n_mamba * PREFILLS):
        raise AssertionError(f"prefill launches {got}: want {n_mamba} scan "
                             f"launches per prefill and nothing else")
    scan_launches = got["selective_scan"]
    if logits.shape != (2, 1, cfg.vocab_size) \
            or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {logits.shape} "
                             f"{logits.dtype}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    prefill = {"ms_per_prefill": sum(prefill_ms) / PREFILLS,
               "ms_each": prefill_ms, "prompts": 2, "prompt_len": PROMPT_LEN,
               "tokens_per_s": 2 * PROMPT_LEN / (sum(prefill_ms) / PREFILLS)
               * 1e3, "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": got}
    log(f"phase 9(a): prefill 2 x {PROMPT_LEN} tokens (forward, last "
        f"logits): {json.dumps(prefill)}")

    # (b) serving as examples/serve_decode.py: prompts fed token by token
    # through the cache, then greedy tokens, on a linear cache of 96.
    requests = torch.randint(0, cfg.vocab_size, (REQUESTS, REQUEST_LEN),
                             generator=gen, device=dev)
    cache = model.init_cache(cfg, REQUESTS, REQUEST_LEN + NEW_TOKENS,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms, out = [], []
    for t in range(REQUEST_LEN + NEW_TOKENS):
        tok = requests[:, t:t + 1] if t < REQUEST_LEN \
            else logits.argmax(-1)
        if t >= REQUEST_LEN:
            out.append(tok[:, 0])
        (logits, cache), ms = synced(model.decode_step, params, cache, tok,
                                     t, cfg)
        step_ms.append(ms)
        if t == REQUEST_LEN - 1:
            after_prompt = logits
    got = launch_counts()
    if got != want:
        raise AssertionError(f"decode launches {got}: want none")
    tokens = torch.stack(out, dim=1)
    if tokens.shape != (REQUESTS, NEW_TOKENS) or not torch.isfinite(
            logits).all() or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"decode: tokens {tokens.shape}, logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    generated = model.greedy_generate(params, cfg, requests, NEW_TOKENS)
    if not torch.equal(generated, tokens):
        raise AssertionError("greedy_generate's tokens differ from the "
                             "decode loop's")
    decode = {"ms_per_step": sum(step_ms[1:]) / (len(step_ms) - 1),
              "first_step_ms": step_ms[0], "steps": len(step_ms),
              "requests": REQUESTS, "cache_len": REQUEST_LEN + NEW_TOKENS,
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "launches": got, "first_tokens": tokens[:, :6].tolist()}
    log(f"phase 9(b): serving {REQUESTS} requests, {REQUEST_LEN}-token "
        f"prompts token by token then {NEW_TOKENS} greedy tokens: "
        f"{json.dumps(decode)}; greedy_generate gives the same tokens")

    # (c) prefill against decode on the same prompts: in bf16, and with
    # the same weights in f32.
    kernels.reset_launches()
    fwd, _ = model.forward(params, {"tokens": requests}, cfg, last_only=True)
    got = launch_counts()
    if got != dict(want, selective_scan=n_mamba):
        raise AssertionError(f"prefill (c) launches {got}")
    versus = {"bf16": prefill_vs_decode(fwd, after_prompt)}
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    fwd32, _ = model.forward(params32, {"tokens": requests}, f32,
                             last_only=True)
    cache = model.init_cache(f32, REQUESTS, REQUEST_LEN, device=dev)
    for t in range(REQUEST_LEN):
        dec32, cache = model.decode_step(params32, cache,
                                         requests[:, t:t + 1], t, f32)
    del params32, cache
    versus["f32"] = prefill_vs_decode(fwd32, dec32)
    versus["bf16_prefill_vs_f32"] = prefill_vs_decode(fwd, fwd32)
    versus["bf16_decode_vs_f32"] = prefill_vs_decode(after_prompt, dec32)
    log(f"phase 9(c): last logits over {REQUESTS} x {REQUEST_LEN} tokens, "
        f"prefill vs decode (and each bf16 path vs the f32 one): "
        f"{json.dumps(versus)}")
    if not versus["bf16"]["max_abs_diff"] <= \
            PREFILL_DECODE_BF16 * versus["bf16"]["max_abs_logit"]:
        raise AssertionError(f"bf16 prefill vs decode beyond "
                             f"{PREFILL_DECODE_BF16} of the largest logit")
    torch.testing.assert_close(dec32, fwd32, **PREFILL_DECODE_F32)

    # (d) where a prefill's time goes.
    stages = prefill_breakdown(params, prompts, cfg)
    log(f"phase 9(d): prefill stages, ms (host clock, synchronised): "
        f"{json.dumps(stages)}")

    # (e) decode's memory against the cache's length, and the LM head.
    memory, grew, allowed = decode_memory(params, cfg, dev, gen)
    head_err = lm_head_check(params, cfg, dev, gen)
    log(f"phase 9(e): decode step at cache lengths {DECODE_CACHE_LENS}: "
        f"{json.dumps(memory)}; transient grew {grew} bytes (at most "
        f"{allowed}); LM head on the card vs the f32 product max |err| "
        f"{head_err:.3g}")
    if not grew <= allowed:
        raise AssertionError(f"decode step's transient memory grew {grew} "
                             f"bytes with the cache, more than {allowed}")
    return scan_launches, dict(prefill=prefill, decode=decode,
                               stages=stages, prefill_vs_decode=versus,
                               decode_memory=memory)


# ---------------------------------------------------------------------------
# Phase 10: the fig3 contest, and compressed gossip at full width.
# ---------------------------------------------------------------------------

FIG3_ROWS = ("morph", "static", "el-oracle", "fully-connected",
             "morph-sparse")
CODEC_SPECS = ("int8", "fp8", "int8+topk0.75")
SPARSE_CODEC_SPEC, SPARSE_CODEC_ROUNDS = "int8+topk0.75", 5
# tests/test_torch_compress_engine.py's tolerance for the reduced GN-LeNet
# under a codec: a payload coordinate at a rounding edge may take the
# neighbouring code on one side (one quantization step, about 3e-3 there),
# and a flipped code changes the next gradients.
CODEC_TOL = 1e-2


def fig3_contest(dev):
    """Phase 10(a): ``repro_torch.bench.fig3``'s contest at the artifact's
    shape, seed 0, with deterministic cuDNN (its chunk pin compares two
    runs bit for bit); counts set to 0 just before and read just after."""
    from repro_torch import kernels
    from repro_torch.bench import fig3, harness
    args = fig3.parse_args(["--device", "cuda", "--seed", "0"])
    bench = harness.Bench("torch_fig3_accuracy", "cuda", out_dir="")
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launches()
        out = fig3.run_contest(args, bench)
        got = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    n, rounds = args.nodes[0], args.rounds
    # Morph twice (whole leaves and the chunked rerun): a Gram and a
    # masked mix a round; EL a masked mix; Static and FC a dense mix;
    # sparse Morph a CSR mix.
    want = dict(dict.fromkeys(got, 0), gram_matrix=2 * rounds,
                graph_mix_masked=3 * rounds, graph_mix=2 * rounds,
                graph_mix_sparse=rounds)
    if got != want:
        raise AssertionError(f"fig3 contest: launches {got} != {want}")
    if not out["bitwise"][n]:
        raise AssertionError("fig3 contest: chunk pin failed")
    finals = {name: out["finals"][(name, n)] for name in FIG3_ROWS}
    if not all(math.isfinite(a) for a in finals.values()):
        raise AssertionError(f"fig3 contest: non-finite finals {finals}")
    summary = {
        "finals": finals,
        "reference": fig3.REFERENCE,
        "distance": {k: finals[k] - fig3.REFERENCE[k] for k in finals},
        "morph_ge_static": finals["morph"] >= finals["static"],
        "morph_ge_el_oracle": finals["morph"] >= finals["el-oracle"],
        "morph_minus_static": finals["morph"] - finals["static"],
        "morph_minus_el_oracle": finals["morph"] - finals["el-oracle"],
        "chunk_bitwise": out["bitwise"][n],
        "wall_s": {f"{k[0]}": v for k, v in out["walls"].items()},
        "ms_per_round": {f"{k[0]}": v / rounds * 1e3
                         for k, v in out["walls"].items()},
        "launches": got}
    log(f"phase 10(a): fig3 contest n={n} seed 0 {rounds} rounds: "
        f"{json.dumps(summary)}")
    return got


def codec_breakdown(dev, name, n, spec, rounds, phase="10(b)", **setup):
    """Host-clock time of each stage of a compressed round (every stage
    ends in a synchronise): phase 5's (dense Morph) or phase 8's (sparse
    Morph) stages with the codec's ``encode`` (payload and wire),
    ``decode`` (decoded delta, replica advance, residual) and
    ``correction`` (the consensus correction after the mix)."""
    from repro_torch.compress import (decode_leaf, encode_leaf,
                                      next_residual, payload_rows)
    from repro_torch.core.mixing import apply_consensus_correction
    from repro_torch.dlrt import RunnerConfig, Superstep
    from repro_torch.dlrt.runtime import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import cnn_loss
    from repro_torch.optim import sgd
    from repro_torch.sparse import sparse_mix_pytree
    from repro_torch.tree import stack
    sparse = name == "sparse-morph"
    batcher, test, init = paper_setup(n, dev, **setup)
    gen = torch.Generator().manual_seed(0)
    params = stack(init(gen) for _ in range(n))
    params = type(params)((k, v.to(dev)) for k, v in params.items())
    opt = sgd(0.05)
    strategy = make_strategy(name, n, dev)
    eng = Superstep(loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=opt,
                    batcher=batcher, test_batch=to_device(test, dev),
                    strategy=strategy,
                    cfg=RunnerConfig(n_nodes=n, rounds=rounds,
                                     engine="sparse" if sparse else "dense",
                                     compress=spec),
                    params=params, opt_state=opt.init(params), device=dev)
    codec, gamma = eng.codec, eng.codec.consensus_gamma
    names = ["batch", "local_step", "encode", "decode"] \
        + (["graph_round", "mix"] if sparse
           else ["similarity", "graph_round", "mix"]) + ["correction"]
    stages = dict.fromkeys(names, 0.0)

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] += time.perf_counter() - t0
        return out

    def encode():
        rows = {k: payload_rows(v.float() - eng.hat[k], eng.resid[k], codec)
                for k, v in eng.params.items()}
        return rows, {k: encode_leaf(b, codec) for k, b in rows.items()}

    def decode(rows, wire):
        hat, resid = type(eng.hat)(), type(eng.resid)()
        for k, b in rows.items():
            dec = decode_leaf(wire[k], b.shape[1], codec)
            hat[k] = eng.hat[k] + dec.reshape(eng.hat[k].shape)
            resid[k] = next_residual(b, dec, wire[k], eng.resid[k], codec,
                                     True).reshape(eng.resid[k].shape)
        return hat, resid

    eng.round(0)                                   # warm-up
    for rnd in range(1, rounds + 1):
        batch = timed("batch", lambda: eng._batch(rnd))
        eng.params, eng.opt_state = timed(
            "local_step", lambda: eng._local_step(eng.params, eng.opt_state,
                                                  batch))
        rows, wire = timed("encode", encode)
        eng.hat, eng.resid = timed("decode", lambda: decode(rows, wire))
        if sparse:
            eng.gstate, adj = timed("graph_round", lambda: strategy
                                    .graph_round(eng.gstate, rnd, eng.hat))
            mixed = timed("mix", lambda: sparse_mix_pytree(adj, eng.hat))
        else:
            eng.sim = timed("similarity",
                            lambda: ops.model_pairwise_cosine(eng.hat))
            eng.gstate, edges, _ = timed(
                "graph_round", lambda: strategy.graph_round(eng.gstate, rnd,
                                                            eng.sim))
            mixed = timed("mix", lambda: ops.mix_masked_pytree(edges,
                                                               eng.hat))
        eng.params = timed("correction", lambda: apply_consensus_correction(
            mixed, eng.params, eng.hat, gamma))
    out = {k: v / rounds * 1e3 for k, v in stages.items()}
    log(f"phase {phase}: {name} n={n} {spec} round stages, ms per round "
        f"(negotiation every {DELTA_R}th): {json.dumps(out)}")
    return out


def topk_ms(dev, n, d=51200, reps=10):
    """The codec's top-k selection (a stable sort of each row's
    magnitudes) at ``[n, d]``: mean ms over ``reps`` calls, CUDA events."""
    from repro_torch.compress import topk_k
    from repro_torch.core.selection import stable_topk
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = [torch.randn((n, d), generator=gen, device=dev) for _ in range(2)]
    k = topk_k(d, 0.75)
    return time_ms(lambda x: stable_topk(x.abs(), k), [(x,) for x in xs],
                   reps=reps)


def compressed_path(dev):
    """Phase 10(b): GN-LeNet CIFAR-10 at full width under a codec: dense
    Morph at n = 50, 10 rounds of each of ``CODEC_SPECS``; sparse Morph at
    n = 1000 (phase 7's set-up), 5 rounds of ``int8+topk0.75``.  Each run
    with its counts set to 0 just before and read just after (a Gram launch
    per refresh and a masked mix a round, dense; a CSR launch a round,
    sparse), its comm bytes against the analytic wire bytes times the
    edges, and its stage breakdown.  Returns the launches over the
    phase."""
    from repro_torch import kernels
    from repro_torch.compress import CompressConfig, wire_bytes_tree
    runs = [("morph", MAIN_N, spec, ROUNDS, {}) for spec in CODEC_SPECS] \
        + [("sparse-morph", LARGE_N, SPARSE_CODEC_SPEC, SPARSE_CODEC_ROUNDS,
            dict(engine="sparse", eval_chunk=16, **LARGE))]
    total = dict.fromkeys(launch_counts(), 0)
    for name, n, spec, rounds, kw in runs:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        runner, wall = run_strategy(name, n, dev, rounds, DELTA_R,
                                    compress=spec, **kw)
        got = launch_counts()
        want = dict.fromkeys(got, 0)
        if name == "sparse-morph":
            want["graph_mix_sparse"] = rounds
        else:
            want.update(gram_matrix=rounds, graph_mix_masked=rounds)
        if got != want:
            raise AssertionError(f"{name} n={n} {spec}: launches {got} != "
                                 f"{want}")
        for key, v in got.items():
            total[key] += v
        recs = runner.log.records
        if not all(np.isfinite(r.mean_loss) for r in recs) or not all(
                torch.isfinite(p).all() for p in runner.params.values()):
            raise AssertionError(f"{name} n={n} {spec}: non-finite values")
        edges = np.stack(runner.edge_history)
        if edges.sum(axis=2).max() > K:
            raise AssertionError(f"{name} n={n} {spec}: in-degree > {K}")
        wire = wire_bytes_tree(runner.params, n, CompressConfig.parse(spec))
        if recs[-1].comm_bytes != int(edges.sum()) * wire:
            raise AssertionError(f"{name} n={n} {spec}: comm_bytes "
                                 f"{recs[-1].comm_bytes} != edges x wire "
                                 f"bytes {int(edges.sum())} x {wire}")
        summary = {
            "engine": kw.get("engine", "dense"),
            "ms_per_round_incl_eval": wall / rounds * 1e3,
            "accuracy": recs[-1].mean_accuracy, "loss": recs[-1].mean_loss,
            "comm_bytes": recs[-1].comm_bytes, "wire_bytes": wire,
            "dense_bytes": sum(v.numel() * 4 // n
                               for v in runner.params.values()),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": got}
        log(f"phase 10(b): {name} n={n} {spec} {rounds} rounds: "
            f"{json.dumps(summary)}")
        setup = {k: v for k, v in kw.items() if k in LARGE}
        codec_breakdown(dev, name, n, spec, rounds, **setup)
    log(f"phase 10(b): codec top-k (stable sort) at [n, 51200] f32, ms: "
        + json.dumps({f"n={n}": topk_ms(dev, n) for n in (MAIN_N, LARGE_N)}))
    return total


def codec_reference_check(dev):
    """Phase 10(c): the same tiny compressed runs on the card and on the
    CPU (host batches, host-drawn controller noise; the codec itself is
    the CPU's bit for bit, ``tests/test_torch_cuda.py``): parameters within
    ``CODEC_TOL`` and identical edges, or, where the two sides' f32
    rounding flipped a code and a Morph negotiation then picked other
    senders, identical edges up to that negotiation and the replicas it
    read within ``CODEC_TOL`` (reported with the Eq.-3 matrices'
    difference there).  Under fp8 on this tiny model that happens (on an
    H100 80GB HBM3: the Eq.-3 matrices 0.026 apart at round 10)."""
    tiny = dict(image_size=8, width=4, classes=4, samples=400, test=100,
                stream=False)
    cpu_dev = torch.device("cpu")
    cases = [("morph", spec, "dense") for spec in CODEC_SPECS] \
        + [("static", "int8", "dense"),
           ("sparse-morph", SPARSE_CODEC_SPEC, "sparse")]
    for name, spec, engine in cases:
        gpu, _ = run_strategy(name, 6, dev, 11, 5, engine=engine,
                              compress=spec, **tiny)
        cpu, _ = run_strategy(name, 6, cpu_dev, 11, 5, engine=engine,
                              compress=spec, **tiny)
        if [r.comm_bytes for r in gpu.log.records] != \
                [r.comm_bytes for r in cpu.log.records]:
            raise AssertionError(f"{name} {spec}: comm bytes differ")
        differ = [r for r, (a, b) in enumerate(zip(gpu.edge_history,
                                                   cpu.edge_history))
                  if not np.array_equal(a, b)]
        if not differ:
            err = max(float((gpu.params[k].cpu() - cpu.params[k]).abs()
                            .max()) for k in cpu.params)
            if not err <= CODEC_TOL:
                raise AssertionError(f"{name} {spec}: card vs CPU params "
                                     f"{err} > {CODEC_TOL}")
            log(f"phase 10(c): {name} {spec} tiny run, card == CPU edges "
                f"and comm bytes over 11 rounds, params max |err| "
                f"{err:.3g}")
            continue
        first = differ[0]
        if first % 5 or not name.endswith("morph"):
            raise AssertionError(f"{name} {spec}: card and CPU edges "
                                 f"differ at round {first}, not at a "
                                 f"negotiation")
        # Both sides again up to that negotiation: the replicas it read.
        engines = []
        for d in (dev, cpu_dev):
            eng = make_runner(name, 6, d, first + 1, 5, engine=engine,
                              compress=spec, **tiny)._make_engine()
            eng.run()
            engines.append(eng)
        err = max(float((engines[0].hat[k].cpu() - engines[1].hat[k])
                        .abs().max()) for k in engines[1].hat)
        if not err <= CODEC_TOL:
            raise AssertionError(f"{name} {spec}: card vs CPU replicas "
                                 f"{err} > {CODEC_TOL} at round {first}")
        codes = sum(int((engines[0].hat[k].cpu() != engines[1].hat[k])
                        .sum()) for k in engines[1].hat)
        sim = None if engines[1].sim is None else float(
            (engines[0].sim.cpu() - engines[1].sim).abs().max())
        log(f"phase 10(c): {name} {spec} tiny run: card and CPU edges "
            f"identical in rounds 0 to {first - 1}, then the negotiation at "
            f"round {first} picked other senders; there the replicas are "
            f"within {err:.3g} and the Eq.-3 matrices within {sim} ({codes} "
            f"replica coordinates differ: a code flipped by the local "
            f"steps' f32 rounding spreads through the mix and the next "
            f"steps)")


# ---------------------------------------------------------------------------
# Phase 11: the dense in-scan network model at full width.
# ---------------------------------------------------------------------------

NET_STRATEGIES = ("morph", "static", "el-oracle")
NET_LARGE_ROUNDS = 3
DEEP_ROUND_S = 0.05     # flaky-WAN's worst delay, 0.2007 s, is 4.01 slots
RING_S = 5


def fig11_network(profile, n, rounds, faults=False, seed=0):
    """``benchmarks/fig11_fused_net.py``'s network: the named profile and,
    with ``faults``, fig8's flaky-WAN fault mix (stragglers 0.25 x 2.0,
    churn 0.25, no crashes, mean downtime horizon / 8 over a horizon of
    ``rounds`` seconds, fault seed ``seed + 1``)."""
    from repro_torch.netsim import (DenseNetwork, FaultConfig, FaultModel,
                                    profiles)
    fm = None
    if faults:
        horizon = rounds * 1.0
        fm = FaultModel(FaultConfig(
            straggler_fraction=0.25, straggler_slowdown=2.0,
            churn_fraction=0.25, crash_fraction=0.0,
            mean_downtime_s=horizon / 8.0, horizon_s=horizon,
            seed=seed + 1), n)
    return DenseNetwork(profiles.get_profile(profile, n, seed), faults=fm)


def net_want(name, rounds):
    """A network run's launches: one grouped ``graph_mix`` a round (every
    strategy), one grouped Gram a round for Morph (``sim_every`` 1)."""
    from repro_torch.kernels import KERNELS
    want = dict.fromkeys((k.__name__ for k in KERNELS), 0)
    want["graph_mix"] = rounds
    if name == "morph":
        want["gram_matrix"] = rounds
    return want


def net_summary(runner, net, wall, rounds, got):
    """What a network run prints, after its checks: finite values, comm
    bytes = delivered transfers x the payload."""
    from repro_torch.dlrt import stacked_model_bytes
    n = runner.cfg.n_nodes
    stats = runner.net_stats
    recs = runner.log.records
    if not all(np.isfinite(r.mean_loss) for r in recs) or not all(
            torch.isfinite(p).all() for p in runner.params.values()):
        raise AssertionError("non-finite values")
    payload = stacked_model_bytes(runner.params, n)
    if recs[-1].comm_bytes != stats["delivered"] * payload:
        raise AssertionError(f"comm_bytes {recs[-1].comm_bytes} != "
                             f"delivered {stats['delivered']} x {payload}")
    sent = stats["delivered"] + stats["dropped"]
    return {"S": net.depth(payload), "round_s": net.round_s,
            "drop_fraction": stats["dropped"] / sent if sent else 0.0,
            "staleness_mean": runner.staleness_mean(),
            "staleness_hist": stats["staleness_hist"].tolist(),
            "delivered": stats["delivered"], "dropped": stats["dropped"],
            "ms_per_round_incl_eval": wall / rounds * 1e3,
            "accuracy": recs[-1].mean_accuracy, "loss": recs[-1].mean_loss,
            "launches": got}


def net_run(dev, name, n, net, rounds, totals, phase, **kw):
    """One network run through ``DecentralizedRunner`` with its counts set
    to 0 just before and read just after, held to :func:`net_want`."""
    from repro_torch import kernels
    kernels.reset_launches()
    runner, wall = run_strategy(name, n, dev, rounds, DELTA_R, net=net, **kw)
    got = launch_counts()
    if got != net_want(name, rounds):
        raise AssertionError(f"phase {phase} {name} n={n}: launches {got} "
                             f"!= {net_want(name, rounds)}")
    for key, v in got.items():
        totals[key] += v
    return runner, wall, got


def ideal_vs_vanilla(dev, totals):
    """Phase 11(a): the ideal network (ring depth 1) against no network
    model at n = 50, ten rounds of each dense strategy, both runs with
    deterministic cuDNN so the local steps agree bit for bit.  Edges must be
    identical, every edge delivered and the parameters bit for bit: for the
    uniform strategies the two runs mix through different kernels
    (``graph_mix_masked`` builds W in the kernel, ``graph_mix`` reads
    ``uniform_weights_torch(delivered)``), and both form each weight as
    the same f32 quotient and sum the same fmaf chain in node order."""
    from repro_torch import kernels
    from repro_torch.netsim import DenseNetwork, profiles
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name in STRATEGIES:
            kernels.reset_launches()
            plain, _ = run_strategy(name, MAIN_N, dev, ROUNDS, DELTA_R)
            net = DenseNetwork(profiles.ideal())
            runner, wall, got = net_run(dev, name, MAIN_N, net, ROUNDS,
                                        totals, "11(a)")
            for r, (a, b, d) in enumerate(zip(plain.edge_history,
                                              runner.edge_history,
                                              runner.delivered_history)):
                if not (np.array_equal(a, b) and np.array_equal(b, d)):
                    raise AssertionError(f"11(a) {name}: edges or delivered "
                                         f"differ at round {r}")
            differ = [k for k in plain.params
                      if not torch.equal(plain.params[k], runner.params[k])]
            if differ:
                raise AssertionError(f"11(a) {name}: ideal network vs none "
                                     f"params not bitwise in {differ}")
            if [r.comm_bytes for r in plain.log.records] != \
                    [r.comm_bytes for r in runner.log.records]:
                raise AssertionError(f"11(a) {name}: comm bytes differ")
            out[name] = {"accuracy_equal": [r.mean_accuracy for r in
                                            plain.log.records] ==
                         [r.mean_accuracy for r in runner.log.records],
                         **net_summary(runner, net, wall, ROUNDS, got)}
            log(f"phase 11(a): {name} n={MAIN_N} ideal network vs none, "
                f"{ROUNDS} rounds: {json.dumps(out[name])}")
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def fig11_profiles(dev, totals):
    """Phase 11(b): fig11's lossy profiles at n = 50, ``round_s`` = 1 (ring
    depth 1): WAN, and flaky-WAN with fig11's fault mix, Morph, Static and
    EL-Oracle for ten rounds each."""
    out = {}
    for profile, faults in (("wan", False), ("flaky-wan", True)):
        for name in NET_STRATEGIES:
            net = fig11_network(profile, MAIN_N, ROUNDS, faults=faults)
            runner, wall, got = net_run(dev, name, MAIN_N, net, ROUNDS,
                                        totals, "11(b)")
            summary = net_summary(runner, net, wall, ROUNDS, got)
            if summary["S"] != 1:
                raise AssertionError(f"11(b) {profile}: depth "
                                     f"{summary['S']} != 1")
            if profile == "wan" and (summary["dropped"]
                                     or summary["staleness_mean"]):
                raise AssertionError("11(b) wan: drops or staleness on a "
                                     "lossless sub-slot network")
            if profile == "flaky-wan" and not summary["dropped"]:
                raise AssertionError("11(b) flaky-wan: nothing dropped")
            out[f"{profile}/{name}"] = summary
            log(f"phase 11(b): {name} n={MAIN_N} {profile}"
                f"{' + fig11 faults' if faults else ''} {ROUNDS} rounds: "
                f"{json.dumps(summary)}")
    return out


def net_breakdown(dev, n, rounds, net, **setup):
    """Host-clock time of each stage of a dense Morph round under the
    network model, timed inside the engine's own round
    (:meth:`Superstep.net_round`'s stage hook; every stage ends in a
    synchronise): the batch, the local step with its per-node keep, the
    masks (keyed draws, staleness and drop matrices), the similarity
    refresh, the controller, the ring push, the delivery plan, the grouped
    ``[n, n S]`` mix and the settle."""
    kw = dict(eval_chunk=16, **setup) if n > MAIN_N else setup
    eng = make_runner("morph", n, dev, rounds + 1, rounds + 1, net=net,
                      **kw)._make_engine()
    stages = {}

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    eng.net_round(0)                               # warm-up
    for rnd in range(1, rounds + 1):
        eng.net_round(rnd, timed)
    out = {k: v / rounds * 1e3 for k, v in stages.items()}
    out["S"] = eng.net_S
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["ring_bytes"] = sum(h.numel() * h.element_size()
                            for h in eng.hist.values())
    return out


def deep_ring(dev, totals):
    """Phase 11(c): flaky-WAN at ``round_s`` = 0.05 (ring depth 5): dense
    Morph at n = 50 for ten rounds, then fig12's dense row (dense Morph at
    n = 1000 on phase 8's set-up) for three, each with its stage
    breakdown and peak memory."""
    from repro_torch.netsim import profiles
    out = {}
    for n, rounds, setup in ((MAIN_N, ROUNDS, {}),
                             (LARGE_N, NET_LARGE_ROUNDS, LARGE)):
        net = profiles.dense_network("flaky-wan", n, round_s=DEEP_ROUND_S)
        torch.cuda.reset_peak_memory_stats()
        kw = dict(eval_chunk=16, **setup) if n > MAIN_N else {}
        runner, wall, got = net_run(dev, "morph", n, net, rounds, totals,
                                    "11(c)", **kw)
        summary = net_summary(runner, net, wall, rounds, got)
        summary["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        if summary["S"] != RING_S:
            raise AssertionError(f"11(c) n={n}: depth {summary['S']} != "
                                 f"{RING_S}")
        if not summary["staleness_mean"] > 0:
            raise AssertionError(f"11(c) n={n}: no stale delivery")
        log(f"phase 11(c): morph n={n} flaky-wan round_s={DEEP_ROUND_S} "
            f"{rounds} rounds: {json.dumps(summary)}")
        # At least DELTA_R rounds, so the controller's time includes a
        # negotiation.
        stages = net_breakdown(dev, n, max(rounds, DELTA_R), net, **setup)
        log(f"phase 11(c): morph n={n} flaky-wan round_s={DEEP_ROUND_S} "
            f"round stages, ms per round: {json.dumps(stages)}")
        out[n] = dict(summary, stages=stages)
    return out


def time_ring(dev, worst):
    """The staleness-expanded contraction ``[n, n S] @ [n S, D]`` at S = 5
    (n = 50 and 1000), W one-hot in S as :func:`net_effective` builds it
    (about three delivered senders a row, staleness 0 to 4): held to its
    plain version, then timed at the widest leaf (D = 51,200) and as one
    grouped call over GN-LeNet's tree, beside ``torch.matmul`` of the same
    W.  The check sums only W's nonzeros (a structural zero adds exactly
    0 on both sides), so its f32 tolerance is that of the most nonzeros in
    a row, not of the ``n S`` terms.  ``bound_ms`` counts what this W
    needs: W read once, the ring rows it references (its nonzero columns)
    read once, the output written once, and two operations per nonzero of
    W and column; ``dense_bound_ms`` the ``2 n (n S) D`` operations of the
    dense product at the f32 rate."""
    from repro_torch.dlrt.superstep import net_effective
    from repro_torch.kernels import graph_mix, graph_mix_leaves, ref
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for n in (MAIN_N, LARGE_N):
        S, d = RING_S, MAIN_D[-1]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        edges = torch.rand((n, n), generator=gen, device=dev) < 3.0 / n
        edges.fill_diagonal_(False)
        stal = torch.randint(0, S, (n, n), generator=gen, device=dev,
                             dtype=torch.int32)
        _, _, w_stal, _ = net_effective(edges, None, ones, ones, stal,
                                        torch.zeros_like(edges), S,
                                        uniform=True)
        w = w_stal.reshape(n, n * S).contiguous()
        xs = [torch.randn((n * S, d), generator=gen, device=dev)
              for _ in range(2)]
        nnz = int((w != 0).sum())
        row_nnz = int((w != 0).sum(dim=1).max())
        rows = int((w != 0).any(dim=0).sum())
        got, want = graph_mix(w, xs[0]), ref.graph_mix(w, xs[0])
        compare("graph_mix", got, want, row_nnz, torch.float32,
                f"ring m={n} n={n * S} D={d}", worst)
        err = float((got - want).abs().max())
        del got, want
        reps = 30 if n == MAIN_N else 6
        t = timings((graph_mix, [(w, x) for x in xs]),
                    (torch.matmul, [(w, x) for x in xs]), reps=reps)
        t["plain_ms"] = time_ms(ref.graph_mix, [(w, xs[0])], reps=1,
                                warmup=0)
        t["bound_ms"], t["bound_by"] = bound(
            w.numel() * 4 + (rows + n) * d * 4, 2 * nnz * d)
        t["dense_bound_ms"] = 2 * n * (n * S) * d / F32_FLOPS * 1e3
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        t["max_abs_err"] = err
        t["w_nonzeros"] = nnz
        t["w_row_nonzeros_max"] = row_nnz
        t["ring_rows_referenced"] = rows
        t["library"] = "torch.matmul"
        t["shape"] = [n, n * S, d, "float32"]
        del xs
        trees = [[torch.randn((n * S, dd), generator=gen, device=dev)
                  for dd in GN_LENET_LEAVES]
                 for _ in range(2 if n == MAIN_N else 1)]
        tree = {"device_ms": device_ms(graph_mix_leaves,
                                       [(w, ts) for ts in trees],
                                       reps=reps),
                "library_device_ms": device_ms(
                    lambda w, ts: [torch.matmul(w, x) for x in ts],
                    [(w, ts) for ts in trees], reps=reps),
                "library": "per-leaf loop of torch.matmul",
                "shape": [n, n * S, f"GN-LeNet's {len(GN_LENET_LEAVES)} "
                          f"leaves, {sum(GN_LENET_LEAVES)} columns",
                          "float32"]}
        total = sum(GN_LENET_LEAVES)
        tree["bound_ms"], tree["bound_by"] = bound(
            w.numel() * 4 + (rows + n) * total * 4, 2 * nnz * total)
        t["tree"] = tree
        del trees
        out[f"ring_n{n}"] = t
        log(f"phase 11: graph_mix on the ring, [{n}, {n * S}] @ "
            f"[{n * S}, {d}] f32 (tiled route): {json.dumps(t)}")
    return out


def net_reference_check(dev):
    """Phase 11(d): the card against the CPU.  The keyed matrices bit for
    bit (flaky-WAN with a partition window, and a lossy profile at
    ``round_s`` = 0.05 where a delay sits next to a slot boundary); then
    the same tiny runs on both under a lossy, stale profile (``round_s``
    = 0.3, delays 4 to 6 rounds back, a partition window [0.9, 1.8) whose
    ends are not exact in binary, churn, crashes and stragglers): Morph,
    Static and EL-Oracle with identical edges and delivered sets,
    parameters within 1e-4 and equal network counters; Morph under int8
    held as phase 10(c) holds compressed runs."""
    from repro_torch.netsim import (DenseNetwork, FaultConfig, FaultModel,
                                    NetworkProfile, Partition, profiles)
    cpu_dev = torch.device("cpu")
    lossy = NetworkProfile(name="lossy", base_latency_s=1.4, jitter_s=0.5,
                           drop_rate=0.05, seed=7)
    # Round 25 of the lossy profile at n = 300: edge 121 -> 264 is delayed
    # 1.6999999285 s, 33 slots by division and 34 by the reciprocal product.
    cases = [(profiles.dense_network("flaky-wan", 50, round_s=0.05),
              50, range(12)),
             (DenseNetwork(profiles.flaky_wan(50, partition_at=0.1,
                                              partition_len=0.3),
                           round_s=0.05), 50, range(12)),
             (DenseNetwork(lossy, round_s=0.05, max_staleness=64), 300,
              (25,))]
    for net, n, rnds in cases:
        depth = net.depth(379_432)
        for rnd in rnds:
            pairs = [(net.staleness_matrix(rnd, n, 379_432, depth,
                                           device=d).cpu(),
                      net.drop_mask(rnd, n, device=d).cpu())
                     for d in (dev, cpu_dev)]
            if not (torch.equal(pairs[0][0], pairs[1][0])
                    and torch.equal(pairs[0][1], pairs[1][1])):
                raise AssertionError(f"11(d) {net.profile.name} n={n} "
                                     f"round {rnd}: card matrices differ")
            if n == 300 and int(pairs[0][0][264, 121]) != 33:
                raise AssertionError("11(d): the boundary delay is not 33 "
                                     "slots on the card")
    log("phase 11(d): staleness and drop matrices on the card bit for bit "
        "the CPU's (flaky-wan n=50 rounds 0-11 with and without a "
        "partition window, round_s 0.05; lossy n=300 round 25, a delay "
        "of 33 slots by division and 34 by the reciprocal product)")

    tiny = dict(image_size=8, width=4, classes=4, samples=400, test=100,
                stream=False)
    n, rounds = 6, 11
    groups = (frozenset(range(3)), frozenset(range(3, 6)))

    def stale_net():
        prof = NetworkProfile(name="lossy-stale", base_latency_s=1.4,
                              jitter_s=0.5, drop_rate=0.05, seed=7,
                              partitions=(Partition(0.9, 1.8, groups),))
        fm = FaultModel(FaultConfig(
            straggler_fraction=0.34, straggler_slowdown=2.0,
            churn_fraction=0.5, crash_fraction=0.34, mean_downtime_s=1.0,
            horizon_s=3.0, seed=2), n)
        return DenseNetwork(prof, round_s=0.3, faults=fm)

    for name, spec in [(s, "none") for s in NET_STRATEGIES] \
            + [("morph", "int8")]:
        runs = [run_strategy(name, n, d, rounds, 5, net=stale_net(),
                             compress=spec, **tiny)[0]
                for d in (dev, cpu_dev)]
        gpu, cpu = runs
        differ = [r for r, (a, b, c, e) in enumerate(zip(
            gpu.edge_history, cpu.edge_history, gpu.delivered_history,
            cpu.delivered_history))
            if not (np.array_equal(a, b) and np.array_equal(c, e))]
        tol = 1e-4 if spec == "none" else CODEC_TOL
        if differ and spec != "none" and name == "morph" \
                and differ[0] % 5 == 0:
            # As phase 10(c): a code flipped by the local steps' f32
            # rounding may move a later Morph negotiation; up to it the
            # runs agree, and the replicas it read (the ring's slot 0)
            # are within CODEC_TOL.
            first = differ[0]
            engines = []
            for d in (dev, cpu_dev):
                eng = make_runner(name, n, d, first + 1, 5, net=stale_net(),
                                  compress=spec, **tiny)._make_engine()
                eng.run()
                engines.append(eng)
            err = max(float((engines[0].hist[k][:, 0].cpu()
                             - engines[1].hist[k][:, 0]).abs().max())
                      for k in engines[1].hist)
            if not err <= CODEC_TOL:
                raise AssertionError(f"11(d) {name} {spec}: card vs CPU "
                                     f"replicas {err} > {CODEC_TOL} at "
                                     f"round {first}")
            log(f"phase 11(d): {name} {spec} tiny run: card and CPU edges "
                f"identical in rounds 0 to {first - 1}, then the "
                f"negotiation at round {first} picked other senders; there "
                f"the replicas are within {err:.3g}")
            continue
        if differ:
            raise AssertionError(f"11(d) {name} {spec}: card and CPU edges "
                                 f"or delivered sets differ at round "
                                 f"{differ[0]}")
        if gpu.net_stats["staleness_hist"].tolist() != \
                cpu.net_stats["staleness_hist"].tolist() or any(
                    gpu.net_stats[k] != cpu.net_stats[k]
                    for k in ("delivered", "dropped", "staleness_sum")):
            raise AssertionError(f"11(d) {name} {spec}: network counters "
                                 f"{gpu.net_stats} != {cpu.net_stats}")
        err = max(float((gpu.params[k].cpu() - cpu.params[k]).abs().max())
                  for k in cpu.params)
        if not err <= tol:
            raise AssertionError(f"11(d) {name} {spec}: card vs CPU params "
                                 f"{err} > {tol}")
        if [r.comm_bytes for r in gpu.log.records] != \
                [r.comm_bytes for r in cpu.log.records]:
            raise AssertionError(f"11(d) {name} {spec}: comm bytes differ")
        log(f"phase 11(d): {name} {spec} tiny run under a lossy, stale, "
            f"partitioned, churned network (round_s 0.3, S = "
            f"{len(cpu.net_stats['staleness_hist'])}): card == CPU edges, "
            f"delivered sets and counters over {rounds} rounds "
            f"({json.dumps({k: (v.tolist() if hasattr(v, 'tolist') else v) for k, v in cpu.net_stats.items()})}), "
            f"params max |err| {err:.3g}")


def net_path(dev, worst):
    """Phase 11: (a) to (d) and the ring contraction's times; returns the
    launches of every network run (counted run by run) and the times."""
    totals = dict.fromkeys(launch_counts(), 0)
    ideal_vs_vanilla(dev, totals)
    fig11_profiles(dev, totals)
    deep_ring(dev, totals)
    net_reference_check(dev)
    rings = time_ring(dev, worst)
    log(f"phase 11: launches over the network runs {json.dumps(totals)}")
    return totals, rings

# ---------------------------------------------------------------------------
# Phase 12: the host protocol loop.
# ---------------------------------------------------------------------------

HOST_STRATEGIES = ("morph", "static", "el-oracle", "fully-connected")
HOST_VS_ENGINE = ("static", "fully-connected", "el-oracle", "morph",
                  "el-local")
# The full-width host loop's set-up: fig3's Dirichlet(0.1) shards on a host
# batcher (the host loop takes no device stream).
HOST_SETUP = dict(stream=False, alpha=0.1)
HOST_CARD_TOL = 1e-5


def host_runner(name, n, dev, rounds, eval_every, ingraph=False, **kw):
    """:func:`make_runner` with ``repro_torch.bench.common``'s strategy
    ``name`` (the host protocol and baselines, or with ``ingraph`` their
    in-graph twins) at fig3's settings, not run."""
    from repro_torch.bench import common
    exp = common.ExpConfig(n_nodes=n, k=min(K, n - 1), delta_r=DELTA_R)
    strategy = common.make_ingraph_strategy(name, exp, dev) if ingraph \
        else common.make_strategy(name, exp)
    return make_runner(name, n, dev, rounds, eval_every, strategy=strategy,
                       **kw)


def timed_host_run(runner):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def want_mix(name, rounds):
    """One grouped mix launch a round: the masked kernel for a uniform
    strategy, graph_mix for Static and FC; no Gram launch."""
    uniform = name in ("morph", "el-oracle")
    counts = dict.fromkeys(launch_counts(), 0)
    counts["graph_mix_masked" if uniform else "graph_mix"] = rounds
    return counts


def check_finite(label, runner):
    if not all(np.isfinite(r.mean_loss) for r in runner.log.records) or \
            not all(torch.isfinite(p).all() for p in runner.params.values()):
        raise AssertionError(f"{label}: non-finite values")


def table1_script(dev):
    """Phase 12(a): ``repro_torch.bench.table1`` at the reference's
    defaults (16 nodes, 150 rounds, width 12, image 16, seed 0) through
    the host loop; counts set to 0 just before and read just after."""
    import os
    from repro_torch import kernels
    from repro_torch.bench import table1
    saved = os.environ.get("BENCH_DIR")
    os.environ["BENCH_DIR"] = ""                 # no JSON file here
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rows = table1.main(["--device", "cuda"])
        wall = time.perf_counter() - t0
        got = launch_counts()
    finally:
        if saved is None:
            del os.environ["BENCH_DIR"]
        else:
            os.environ["BENCH_DIR"] = saved
    rounds = 150
    want = dict(dict.fromkeys(got, 0), graph_mix_masked=2 * rounds,
                graph_mix=2 * rounds)
    if got != want:
        raise AssertionError(f"table1: launches {got} != {want}")
    if not all(math.isfinite(r["acc"]) for r in rows.values()):
        raise AssertionError(f"table1: non-finite rows {rows}")
    summary = {
        "rows": rows, "ordering": table1.ordering(rows),
        "reference_cpu": table1.REFERENCE,
        "reference_ordering": table1.ordering(table1.REFERENCE),
        "distance": {k: rows[k]["acc"] - table1.REFERENCE[k]["acc"]
                     for k in rows},
        "wall_s": wall, "launches": got}
    log(f"phase 12(a): table1 n=16 seed 0 150 rounds: {json.dumps(summary)}")
    return got


def host_path(dev):
    """Phase 12(b): the four Table-I strategies through the host loop at
    full width and n = 100, ten rounds each, counts set to 0 just before
    each run and read just after; returns their launches summed."""
    from repro_torch import kernels
    totals = dict.fromkeys(launch_counts(), 0)
    for name in HOST_STRATEGIES:
        runner = host_runner(name, HOST_N, dev, ROUNDS, DELTA_R,
                             **HOST_SETUP)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        wall = timed_host_run(runner)
        got = launch_counts()
        if got != want_mix(name, ROUNDS):
            raise AssertionError(f"host loop {name} n={HOST_N}: launches "
                                 f"{got} != {want_mix(name, ROUNDS)}")
        for k, v in got.items():
            totals[k] += v
        check_finite(f"host loop {name}", runner)
        edges = np.stack(runner.edge_history)
        recs = runner.log.records
        if recs[-1].comm_bytes != int(edges.sum()) * runner._model_bytes:
            raise AssertionError(f"host loop {name}: comm bytes")
        summary = {"ms_per_round_incl_eval": wall / ROUNDS * 1e3,
                   "accuracy": recs[-1].mean_accuracy,
                   "loss": recs[-1].mean_loss, "isolated": recs[-1].isolated,
                   "max_in_degree": int(edges.sum(axis=2).max()),
                   "comm_bytes": recs[-1].comm_bytes,
                   "peak_device_bytes": torch.cuda.max_memory_allocated(),
                   "launches": got}
        if name == "morph":
            proto = runner.strategy
            if edges.sum(axis=2).max() > K or edges.sum(axis=1).max() > K:
                raise AssertionError("morph: a degree above k")
            views = proto.view_sizes()
            summary.update(control_messages=proto.control_messages,
                           similarity_floats=proto.similarity_floats,
                           view_sizes={"min": int(views.min()),
                                       "mean": float(views.mean()),
                                       "max": int(views.max())})
        log(f"phase 12(b): host loop {name} n={HOST_N} {ROUNDS} rounds: "
            f"{json.dumps(summary)}")
    host_breakdown(dev)
    return totals


def host_breakdown(dev, rounds=10):
    """Phase 12(b): where a MorphProtocol host-loop round's time goes at
    full width and n = 100, timed inside the runner's own round
    (:meth:`DecentralizedRunner._round`'s stage hook; every stage ends in
    a synchronise): the batch, the local step, the copy of the stack to
    the host, the protocol's ``round_edges`` and the mix; inside
    ``round_edges`` the negotiation (on its rounds) and ``deliver`` (the
    digests, the rows, the direct Eq.-3 measurements and the report
    ingestion), and inside ``deliver`` the rows and direct measurements
    alone; then one evaluation."""
    from repro_torch.core import protocol
    runner = host_runner("morph", HOST_N, dev, rounds + 1, DELTA_R,
                         **HOST_SETUP)
    proto = runner.strategy
    stages = {}
    deliver_each = []

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t0
        return out

    def host_timed(stage, fn, each=None):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            took = time.perf_counter() - t0
            stages[stage] = stages.get(stage, 0.0) + took
            if each is not None:
                each.append(took * 1e3)
            return out
        return wrapped

    begin, complete = proto.begin_negotiation, proto.complete_negotiation
    proto.begin_negotiation = host_timed("negotiation", begin)
    proto.complete_negotiation = host_timed("negotiation", complete)
    proto.deliver = host_timed("deliver", proto.deliver, deliver_each)
    saved = protocol.node_row, protocol.pair_similarity_numpy
    protocol.node_row = host_timed("direct_similarity", saved[0])
    protocol.pair_similarity_numpy = host_timed("direct_similarity",
                                                saved[1])
    try:
        for rnd in range(rounds + 1):
            edges = runner._round(rnd, timed)
    finally:
        protocol.node_row, protocol.pair_similarity_numpy = saved
        for name in ("begin_negotiation", "complete_negotiation", "deliver"):
            delattr(proto, name)
    timed("evaluate", lambda: runner.evaluate(rounds, edges))
    steps = rounds + 1
    negotiations = sum(proto.negotiation_due(r) for r in range(steps))
    out = {k: stages[k] / steps * 1e3 for k in (
        "batch", "local_step", "copy_to_host", "strategy", "deliver",
        "direct_similarity", "mix")}
    out["negotiation_ms_each"] = stages["negotiation"] / negotiations * 1e3
    out["negotiation_per_round"] = stages["negotiation"] / steps * 1e3
    out["evaluate_ms_once"] = stages["evaluate"] * 1e3
    out["deliver_ms_by_round"] = deliver_each
    out["direct_pairs_last_round"] = int(edges.sum())
    out["copy_bytes"] = sum(v.numel() * v.element_size()
                            for v in runner.params.values())
    out["round_ms_without_eval"] = sum(
        out[k] for k in ("batch", "local_step", "copy_to_host", "strategy",
                         "mix"))
    out["control_messages"] = proto.control_messages
    out["similarity_floats"] = proto.similarity_floats
    out["view_sizes_mean"] = float(proto.view_sizes().mean())
    log(f"phase 12(b): morph protocol n={HOST_N} round stages, ms per "
        f"round over {steps} rounds (negotiation at 0, {DELTA_R}, "
        f"{2 * DELTA_R}): {json.dumps(out)}")
    return out


def host_vs_engine(dev):
    """Phase 12(c): each in-graph strategy at full width and n = 50,
    ten rounds through the engine and through the host loop's
    ``round_edges`` adapters, deterministic cuDNN: identical edges,
    parameters bit for bit, the same launches."""
    from repro_torch import kernels
    torch.backends.cudnn.deterministic = True
    try:
        for name in HOST_VS_ENGINE:
            runs, counts = [], []
            for compiled in (True, False):
                runner = host_runner(name, MAIN_N, dev, ROUNDS, DELTA_R,
                                     ingraph=True, compiled=compiled,
                                     **HOST_SETUP)
                kernels.reset_launches()
                wall = timed_host_run(runner)
                counts.append(launch_counts())
                runs.append((runner, wall))
            (engine, t_engine), (host, t_host) = runs
            same_edges = all(np.array_equal(a, b) for a, b in
                             zip(engine.edge_history, host.edge_history))
            same_params = all(torch.equal(engine.params[k], host.params[k])
                              for k in engine.params)
            if not (same_edges and same_params and counts[0] == counts[1]
                    and len(host.edge_history) == ROUNDS):
                raise AssertionError(
                    f"{name}: host loop is not the engine (edges "
                    f"{same_edges}, params {same_params}, launches "
                    f"{counts})")
            log(f"phase 12(c): {name} n={MAIN_N} {ROUNDS} rounds: host "
                f"loop == engine bit for bit; " + json.dumps({
                    "engine_ms_per_round": t_engine / ROUNDS * 1e3,
                    "host_loop_ms_per_round": t_host / ROUNDS * 1e3,
                    "launches": counts[1]}))
    finally:
        torch.backends.cudnn.deterministic = False


def host_reference_check(dev):
    """Phase 12(d): tiny host-loop runs on the card and on the CPU from the
    same parameters and batches over 11 rounds: identical edges (and, for
    the protocol, identical tallies and views), parameters within 1e-5."""
    tiny = dict(image_size=8, width=4, classes=4, samples=400, test=100,
                stream=False)
    for name in HOST_STRATEGIES:
        gpu = host_runner(name, 6, dev, 11, 5, **tiny)
        cpu = host_runner(name, 6, torch.device("cpu"), 11, 5, **tiny)
        gpu.run()
        cpu.run()
        for r, (a, b) in enumerate(zip(gpu.edge_history, cpu.edge_history)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: card and CPU edges differ at "
                                     f"round {r}")
        extra = {}
        if name == "morph":
            a, b = gpu.strategy, cpu.strategy
            tallies = [(p.control_messages, p.similarity_floats,
                        p.view_sizes().tolist()) for p in (a, b)]
            if tallies[0] != tallies[1]:
                raise AssertionError(f"morph: card and CPU tallies differ "
                                     f"{tallies}")
            extra = dict(zip(("control_messages", "similarity_floats",
                              "view_sizes"), tallies[0]))
        err = max(float((gpu.params[k].cpu() - cpu.params[k]).abs().max())
                  for k in cpu.params)
        if not err <= HOST_CARD_TOL:
            raise AssertionError(f"{name}: card vs CPU params {err} > "
                                 f"{HOST_CARD_TOL}")
        log(f"phase 12(d): host loop {name} tiny run, card == CPU edges "
            f"over 11 rounds, params max |err| {err:.3g} "
            f"{json.dumps(extra)}")


def host_loop_path(dev):
    """Phase 12: (a) to (d); returns the launches of (a) and of (b)."""
    table1_counts = table1_script(dev)
    host_counts = host_path(dev)
    host_vs_engine(dev)
    host_reference_check(dev)
    return table1_counts, host_counts


# ---------------------------------------------------------------------------
# Phase 13: the event-driven runtime.
# ---------------------------------------------------------------------------

ASYNC_ROUNDS = 11            # 13(a): negotiations at 0, 5 and 10
ASYNC_LOCKSTEP = ("morph", "static", "el-oracle", "fully-connected",
                  "ingraph-morph")
ASYNC_NET_ROUNDS = 10        # 13(b), 13(d)
ASYNC_NET = ("morph", "static", "el-oracle")


def async_strategy(name, n, dev):
    """``repro_torch.bench.common``'s strategy ``name`` at fig3's settings
    (``ingraph-morph``: the in-graph Morph on ``dev``)."""
    from repro_torch.bench import common
    exp = common.ExpConfig(n_nodes=n, k=min(K, n - 1), delta_r=DELTA_R)
    if name == "ingraph-morph":
        return common.make_ingraph_strategy("morph", exp, dev)
    return common.make_strategy(name, exp)


def async_runner(name, n, dev, rounds, eval_every, profile=None,
                 faults=None, mix_timeout_s=None, max_events=None, **setup):
    """An ``AsyncRunner`` on :func:`paper_setup`'s model, data and host
    batcher with :func:`async_strategy`'s strategy, not run."""
    from repro_torch.models import cnn_loss
    from repro_torch.netsim import AsyncConfig, AsyncRunner
    from repro_torch.optim import sgd
    batcher, test, init = paper_setup(n, dev, **setup)
    runner = AsyncRunner(
        init_fn=init, loss_fn=cnn_loss, eval_fn=cnn_loss,
        optimizer=sgd(0.05), batcher=batcher, test_batch=test,
        strategy=async_strategy(name, n, dev),
        cfg=AsyncConfig(n_nodes=n, rounds=rounds, eval_every=eval_every,
                        compute_time_s=1.0, mix_timeout_s=mix_timeout_s,
                        max_events=max_events),
        profile=profile, faults=faults, device=dev)
    # Evaluation 128 test images at a time, as make_runner's.
    runner.cfg.eval_batch_chunk = 128
    return runner


def async_lockstep(dev):
    """Phase 13(a): each of the five strategies at full width and n = 50,
    11 rounds on the ideal network through ``AsyncRunner`` and through the
    host loop, deterministic cuDNN, counts set to 0 just before each run
    and read just after: identical edges, parameters bit for bit, the
    protocol's tallies equal, one grouped mix launch a round on both
    paths and the same Gram launches; returns the async runs' launches
    summed."""
    from repro_torch import kernels
    from repro_torch.netsim import profiles
    totals = dict.fromkeys(launch_counts(), 0)
    torch.backends.cudnn.deterministic = True
    try:
        for name in ASYNC_LOCKSTEP:
            host = make_runner(name, MAIN_N, dev, ASYNC_ROUNDS, DELTA_R,
                               strategy=async_strategy(name, MAIN_N, dev),
                               compiled=False, **HOST_SETUP)
            # The default runaway guard, 32 events a node a round, is
            # short of FC's n (n - 1) deliveries a round at n = 50.
            asyn = async_runner(name, MAIN_N, dev, ASYNC_ROUNDS, DELTA_R,
                                profile=profiles.ideal(),
                                max_events=ASYNC_ROUNDS * MAIN_N
                                * (MAIN_N + 32) + 4096, **HOST_SETUP)
            walls, counts = [], []
            for runner in (host, asyn):
                kernels.reset_launches()
                walls.append(timed_host_run(runner))
                counts.append(launch_counts())
            mix = "graph_mix" if name in ("static", "fully-connected") \
                else "graph_mix_masked"
            want = dict.fromkeys(counts[0], 0)
            want[mix] = ASYNC_ROUNDS
            if name == "ingraph-morph":
                want["gram_matrix"] = ASYNC_ROUNDS
            same_edges = len(host.edge_history) == ASYNC_ROUNDS and all(
                np.array_equal(a, b) for a, b in zip(host.edge_history,
                                                     asyn.edge_history)) \
                and len(asyn.edge_history) == ASYNC_ROUNDS
            same_params = all(torch.equal(host.params[k], asyn.params[k])
                              for k in host.params)
            extra = {}
            if name == "morph":
                tallies = [(r.strategy.control_messages,
                            r.strategy.similarity_floats)
                           for r in (host, asyn)]
                if tallies[0] != tallies[1]:
                    raise AssertionError(f"13(a) morph: tallies {tallies}")
                extra = dict(zip(("control_messages", "similarity_floats"),
                                 tallies[0]))
            if asyn.truncated or not (same_edges and same_params
                                      and counts[0] == want
                                      and counts[1] == want):
                raise AssertionError(
                    f"13(a) {name}: AsyncRunner is not the host loop "
                    f"(truncated {asyn.truncated}, edges {same_edges}, "
                    f"params {same_params}, launches {counts} != {want})")
            check_finite(f"13(a) {name}", asyn)
            for k, v in counts[1].items():
                totals[k] += v
            log(f"phase 13(a): {name} n={MAIN_N} {ASYNC_ROUNDS} rounds, "
                f"ideal: AsyncRunner == host loop bit for bit; "
                + json.dumps(dict(
                    host_loop_ms_per_round=walls[0] / ASYNC_ROUNDS * 1e3,
                    async_ms_per_round=walls[1] / ASYNC_ROUNDS * 1e3,
                    events=asyn.loop.processed,
                    launches_host_loop=counts[0],
                    launches_async=counts[1], **extra)))
    finally:
        torch.backends.cudnn.deterministic = False
    return totals


class AsyncStages:
    """Host-clock time of an ``AsyncRunner``'s stages, timed inside its
    own handlers (each wrapped call ends in a synchronise): local steps,
    the compute handler's batch draw and copy and live-row select,
    snapshots (calls counted only where a row is copied), direct Eq.-3
    similarities (the receiver's row and the pair), per-node mixes,
    lockstep mixes and evaluation; the rest of the run is event-loop
    overhead (heap, transport, protocol, ledgers)."""

    STAGES = ("local_step", "batch_and_select", "snapshot",
              "direct_similarity", "mix_one", "mix", "evaluate")

    def __init__(self, runner):
        from repro_torch.netsim import async_runner as ar
        self.ms = dict.fromkeys(self.STAGES, 0.0)
        self.calls = dict.fromkeys(self.STAGES, 0)
        self._module = ar
        self._saved = ar.node_row, ar.pair_similarity_numpy
        step = runner._local_step
        runner.__dict__["_local_step"] = self.timed("local_step", step)
        on_compute = self.timed("batch_and_select", runner._on_compute)

        def compute_handler(batch):
            # The handler less its step: the batch's draw, stack and copy,
            # and the live-row select.
            before = self.ms["local_step"]
            on_compute(batch)
            self.ms["batch_and_select"] -= self.ms["local_step"] - before
        runner._on_compute = compute_handler
        for stage, attr in (("mix_one", "_mix_one"), ("mix", "_mix"),
                            ("evaluate", "_eval_at")):
            setattr(runner, attr, self.timed(stage, getattr(runner, attr)))
        snapshot = self.timed("snapshot", runner._snapshot_row, count=False)

        def snapshot_row(j):
            # A copy is made unless the sender's row is cached at its
            # current version.
            hit = runner._snap_cache.get(j)
            self.calls["snapshot"] += hit is None \
                or hit[0] != int(runner._version[j])
            return snapshot(j)
        runner._snapshot_row = snapshot_row
        ar.node_row = self.timed("direct_similarity", self._saved[0],
                                 count=False)
        ar.pair_similarity_numpy = self.timed("direct_similarity",
                                              self._saved[1])

    def timed(self, stage, fn, count=True):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[stage] += (time.perf_counter() - t0) * 1e3
            self.calls[stage] += count
            return out
        return wrapped

    def restore(self):
        self._module.node_row, self._module.pair_similarity_numpy = \
            self._saved

    def per_round(self, wall_s, rounds):
        out = {f"{k}_ms": self.ms[k] / rounds for k in self.STAGES}
        out.update({f"{k}_calls": self.calls[k] / rounds
                    for k in self.STAGES})
        out["event_loop_ms"] = (wall_s * 1e3 - sum(self.ms.values())) \
            / rounds
        return out


def async_regimes(dev):
    """Phase 13(b): fig8's WAN and flaky-WAN regimes (the fault mix of
    ``repro_torch.bench.fig8.network``, mix deadline 3 s) at full width and
    n = 50, ten rounds of MorphProtocol, Static and EL-Oracle, counts set
    to 0 just before each run and read just after: in-degree at most k in
    every edge set of Morph and Static (EL-Oracle, k-out, out-degree k),
    no realized mix above its edges' in-degree, nothing in flight at the
    end, no truncation; virtual seconds, staleness, drops by kind, host ms a
    round and the stage breakdown.  Returns the launches summed."""
    from repro_torch import kernels
    from repro_torch.bench import fig8
    totals = dict.fromkeys(launch_counts(), 0)
    rounds = ASYNC_NET_ROUNDS
    for regime in ("wan", "flaky-wan"):
        for name in ASYNC_NET:
            profile, faults = fig8.network(regime, MAIN_N, rounds * 1.0, 0)
            runner = async_runner(name, MAIN_N, dev, rounds, DELTA_R,
                                  profile=profile, faults=faults,
                                  mix_timeout_s=fig8.MIX_TIMEOUT_S,
                                  **HOST_SETUP)
            stages = AsyncStages(runner)
            kernels.reset_launches()
            try:
                wall = timed_host_run(runner)
            finally:
                stages.restore()
            got = launch_counts()
            for k, v in got.items():
                totals[k] += v
            stats = runner.transport.stats
            edges = np.stack(runner.edge_history)
            indeg = int(edges.sum(axis=2).max())
            if name == "el-oracle":
                # EL-Oracle is k-out: each node sends to k peers.
                bounded = (edges.sum(axis=1) == K).all()
            else:
                bounded = indeg <= K
            if not bounded or max(runner.realized_indegrees) > indeg:
                raise AssertionError(f"13(b) {regime} {name}: degrees "
                                     f"(in {indeg}, realized "
                                     f"{max(runner.realized_indegrees)})")
            if stats.in_flight != 0 or runner.truncated:
                raise AssertionError(f"13(b) {regime} {name}: in flight "
                                     f"{stats.in_flight}, truncated "
                                     f"{runner.truncated}")
            check_finite(f"13(b) {regime} {name}", runner)
            last = runner.netlog.last()
            summary = {
                "virtual_s": last.t, "accuracy": last.mean_accuracy,
                "staleness_mean": runner.netlog.staleness_mean(),
                "staleness_hist": {str(k): v for k, v in sorted(
                    runner.netlog.staleness_hist.items())},
                "sent_by_kind": stats.sent_by_kind,
                "dropped_by_kind": stats.dropped_by_kind,
                "late_discards": runner.late_discards,
                "unavailable_sends": runner.unavailable_sends,
                "events": runner.loop.processed,
                "host_ms_per_round": wall / rounds * 1e3,
                "stages_per_round": stages.per_round(wall, rounds),
                "launches": got}
            log(f"phase 13(b): {name} n={MAIN_N} {regime} {rounds} rounds: "
                f"{json.dumps(summary)}")
    return totals


def node_gaps(a, b):
    """``[n]``: the largest parameter difference of each node's row
    between two runners (``b`` on the CPU)."""
    n = b.cfg.n_nodes
    return np.max(np.stack([(a.params[k].cpu() - b.params[k]).abs()
                            .reshape(n, -1).amax(dim=1).numpy()
                            for k in b.params]), axis=0)


KINK_EPS, KINK_SEEDS = 1e-7, (1, 2, 3)


def async_reference_check(dev):
    """Phase 13(c): ``tests/test_netsim.py``'s tiny shape (GN-LeNet width
    8 on 8-pixel images) under WAN (EL-Oracle and MorphProtocol, n = 6,
    8 rounds) and flaky-WAN with a partition, stragglers and churn
    (MorphProtocol n = 8, 10 rounds; in-graph Morph n = 6, 8 rounds; mix
    deadline 2 s) on the card and on the CPU: identical edges, transport
    stats, staleness histograms and event counts, and every node's
    parameters within 1e-5.

    A node whose row parts by more is held to the CPU's own spread: the
    CPU run is repeated from its initial parameters moved by 1e-7 (about
    the card's rounding gap per step), three ways; where the trajectory
    crosses a ReLU or max-pool kink a step's gradient jumps, and such a
    rerun moves the same node's row by as much.  The node passes only if
    a rerun that mixed as the CPU run did (the same edges, arrivals and
    staleness; Morph's requests may differ) moved its row past 1e-5 and
    the card's gap is at most twice the largest such move."""
    import dataclasses
    from repro_torch.netsim import FaultConfig, FaultModel, profiles
    tiny = dict(image_size=8, width=8, classes=4, samples=400, test=100,
                stream=False, alpha=0.5)

    def flaky(n, rounds):
        horizon = rounds * 1.5
        return (profiles.flaky_wan(n, partition_at=horizon * 0.3,
                                   partition_len=horizon * 0.2, seed=1),
                FaultModel(FaultConfig(
                    straggler_fraction=0.25, straggler_slowdown=2.0,
                    churn_fraction=0.25, crash_fraction=0.0,
                    mean_downtime_s=3.0, horizon_s=horizon, seed=2), n))

    def build(name, regime, n, rounds, d):
        profile, faults = (profiles.wan(), None) if regime == "wan" \
            else flaky(n, rounds)
        return async_runner(name, n, d, rounds, 4, profile=profile,
                            faults=faults,
                            mix_timeout_s=None if regime == "wan" else 2.0,
                            **tiny)

    def same_mixing(a, b):
        return (len(a.edge_history) == len(b.edge_history) > 0
                and all(np.array_equal(x, y) for x, y in
                        zip(a.edge_history, b.edge_history))
                and a.netlog.staleness_hist == b.netlog.staleness_hist
                and a.realized_indegrees == b.realized_indegrees)

    def same_run(a, b):
        return (same_mixing(a, b) and a.loop.processed == b.loop.processed
                and dataclasses.asdict(a.transport.stats)
                == dataclasses.asdict(b.transport.stats))

    cases = [("el-oracle", "wan", 6, 8), ("morph", "wan", 6, 8),
             ("morph", "flaky-wan", 8, 10),
             ("ingraph-morph", "flaky-wan", 6, 8)]
    cpu_dev = torch.device("cpu")
    for name, regime, n, rounds in cases:
        card, cpu = (build(name, regime, n, rounds, d) for d in (dev, cpu_dev))
        card.run()
        cpu.run()
        if not same_run(card, cpu):
            raise AssertionError(f"13(c) {name} {regime}: card and CPU "
                                 f"runs differ")
        gaps = node_gaps(card, cpu)
        extra = {}
        if gaps.max() > HOST_CARD_TOL:
            spread = np.zeros(n)
            for seed in KINK_SEEDS:
                moved = build(name, regime, n, rounds, cpu_dev)
                gen = torch.Generator().manual_seed(seed)
                for v in moved.params.values():
                    v.add_(KINK_EPS * torch.randn(v.shape, generator=gen))
                moved.run()
                if same_mixing(moved, cpu):
                    spread = np.maximum(spread, node_gaps(moved, cpu))
            far = np.flatnonzero(gaps > HOST_CARD_TOL)
            if not ((spread[far] > HOST_CARD_TOL).all()
                    and (gaps[far] <= 2 * spread[far]).all()):
                raise AssertionError(
                    f"13(c) {name} {regime}: card vs CPU params "
                    f"{gaps.tolist()} > {HOST_CARD_TOL}, the CPU's own "
                    f"spread {spread.tolist()}")
            extra = {"kink_nodes": far.tolist(),
                     "card_gap_by_node": gaps.tolist(),
                     "cpu_spread_1e-7_by_node": spread.tolist()}
        log(f"phase 13(c): {name} {regime} n={n} {rounds} rounds, card == "
            f"CPU edges, stats, staleness and {cpu.loop.processed} events, "
            f"params max |err| {gaps.max():.3g}; " + json.dumps({
                "staleness_hist": {str(k): v for k, v in sorted(
                    cpu.netlog.staleness_hist.items())},
                "dropped": cpu.transport.stats.dropped,
                "late_discards": cpu.late_discards,
                "dead": sorted(cpu.dead), **extra}))


def fig11_wan_row(dev):
    """Phase 13(d): fig11's WAN row at n = 50, ten rounds, through
    ``repro_torch.bench.fig11.run_cell``: both realizations' times, their
    ratio and the fidelity columns (recorded, not held to a limit)."""
    from repro_torch.bench import common, fig11
    for name in fig11.STRATEGIES:
        cfg = common.ExpConfig(n_nodes=MAIN_N, rounds=ASYNC_NET_ROUNDS,
                               eval_every=max(ASYNC_NET_ROUNDS // 3, 1))
        row, asyn = fig11.run_cell(name, "wan", cfg, dev)
        if asyn.transport.stats.in_flight or asyn.truncated or not all(
                math.isfinite(v) for v in row.values()):
            raise AssertionError(f"13(d) {name}: {row}")
        log(f"phase 13(d): fig11 wan/{name}/n{MAIN_N} {ASYNC_NET_ROUNDS} "
            f"rounds: {json.dumps(row)}")


def async_path(dev):
    """Phase 13: (a) to (d); returns the launches of (a) and (b)."""
    totals = async_lockstep(dev)
    for k, v in async_regimes(dev).items():
        totals[k] += v
    for name in ("gram_matrix", "graph_mix", "graph_mix_masked"):
        if totals[name] == 0:
            raise AssertionError(f"phase 13: {name} never launched")
    log(f"phase 13: launches over (a) and (b) {json.dumps(totals)}")
    async_reference_check(dev)
    fig11_wan_row(dev)
    return totals


# ---------------------------------------------------------------------------
# Phase 14: the sweep farm.
# ---------------------------------------------------------------------------

SWEEP_ROUNDS = 10            # 14(a): negotiations at 0 and 5
SWEEP_SEEDS = 4
SWEEP_TIMED = 5              # 14(c): rounds timed after one untimed round
SWEEP_E = (8, 32)            # 14(c): GN-LeNet sweeps of 4 and 16 seeds
SWEEP_MIX = ((50, 8), (200, 4), (1000, 2))      # 14(b): (n, E)


def sweep_fixture(n, dev, seeds, name="morph", profiles=None,
                  delta_rs=None, tiny=False, host_slots=False):
    """Phase 14's set-up: paper_setup's data and model (or the tiny
    GN-LeNet of phase 6), one ``DeviceDataStream`` an experiment over one
    dataset (data seed = seed + 3, as paper_setup's), one strategy an
    experiment at fig3's settings (strategy seed = the experiment's seed),
    and ``profiles`` as a ``SweepNetwork`` at round_s = 1.  A stream draws
    its slots from a generator on its device, so card and CPU draw other
    batches; ``host_slots`` keys them on a CPU generator instead (the same
    batches on both).  Returns ``(sweep(**kw), solo(e))``, which build the
    sweep and experiment ``e``'s solo engine."""
    from repro_torch import core, fold_seed
    from repro_torch.data import (DeviceDataStream, dirichlet_partition,
                                  make_image_classification,
                                  train_test_split)
    from repro_torch.dlrt import (DecentralizedRunner, RunnerConfig,
                                  SweepSpec, SweepSuperstep)
    from repro_torch.models import cnn_loss, cnn_params
    from repro_torch.netsim import DenseNetwork, SweepNetwork
    from repro_torch.netsim import profiles as prof
    from repro_torch.optim import sgd
    shape = dict(samples=400, classes=4, image_size=8, width=4, test=64) \
        if tiny else dict(samples=6000, classes=10, image_size=32,
                          width=32, test=512)
    ds = make_image_classification(shape["samples"],
                                   num_classes=shape["classes"],
                                   image_size=shape["image_size"],
                                   channels=3, noise=3.0, seed=0)
    tr, te = train_test_split(ds, 0.2, seed=0)
    parts = dirichlet_partition(tr.labels, n, 0.5 if tiny else 0.1,
                                np.random.default_rng(0))
    test = {"images": te.images[:shape["test"]],
            "labels": te.labels[:shape["test"]]}
    init = lambda g: cnn_params(g, in_channels=3,
                                num_classes=shape["classes"],
                                image_size=shape["image_size"],
                                width=shape["width"])
    E = len(seeds)
    nets = None if profiles is None else [
        DenseNetwork(prof.get_profile(p, n, s), round_s=1.0)
        for p, s in zip(profiles, seeds)]
    drs = delta_rs or (DELTA_R,) * E
    k = min(K, n - 1)

    def strategy(e):
        if name == "morph":
            return core.InGraphMorphStrategy(
                n=n, k=k, view_size=k + 2, beta=500.0, delta_r=drs[e],
                seed=seeds[e], device=dev)
        return make_strategy(name, n, dev, seed=seeds[e])

    def cfg(**kw):
        return RunnerConfig(n_nodes=n, rounds=SWEEP_ROUNDS, eval_every=5,
                            eval_batch_chunk=128, **kw)

    class HostSlots(DeviceDataStream):
        def slots(self, rnd):
            gen = torch.Generator().manual_seed(fold_seed(self.seed, rnd))
            sizes = self.sizes.cpu()[:, None]
            u = torch.rand((self.n, self.batch), generator=gen)
            return torch.minimum((u * sizes).long(), sizes - 1).to(dev)

    def stream(e):
        return (HostSlots if host_slots else DeviceDataStream)(
            tr, parts, 8, seed=seeds[e] + 3, device=dev)

    def sweep(**kw):
        spec = SweepSpec(seeds=tuple(seeds), profiles=profiles,
                         delta_r=None if delta_rs is None
                         else tuple(delta_rs))
        return SweepSuperstep(
            spec=spec, init_fn=init, loss_fn=cnn_loss, eval_fn=cnn_loss,
            optimizer=sgd(0.05), streams=[stream(e) for e in range(E)],
            test_batch=test, strategies=[strategy(e) for e in range(E)],
            cfg=cfg(), net=None if nets is None else SweepNetwork(nets),
            device=dev, **kw)

    def solo(e):
        return DecentralizedRunner(
            init_fn=init, loss_fn=cnn_loss, eval_fn=cnn_loss,
            optimizer=sgd(0.05), batcher=stream(e),
            test_batch={k: v for k, v in test.items()},
            strategy=strategy(e),
            cfg=cfg(seed=seeds[e], net=None if nets is None else nets[e]),
            device=dev)._make_engine()
    return sweep, solo


def sweep_step_bits(dev):
    """Phase 14(a), first: one local step of the E = 8, n = 50 full-width
    stack (grouped convolutions over 400 groups) against each
    experiment's own step of its 50 rows (50 groups), deterministic cuDNN:
    whether the stacked step keeps each experiment's bits, and both
    times.  Returns whether it does."""
    from repro_torch.dlrt.sweep import _flat
    sweep, _ = sweep_fixture(MAIN_N, dev, tuple(range(SWEEP_SEEDS)) * 2,
                             profiles=("ideal",) * SWEEP_SEEDS
                             + ("wan",) * SWEEP_SEEDS)
    eng = sweep()
    batch = eng._batch(0)
    stacked = lambda: eng._local_step(_flat(eng.params), eng._opt_state,
                                      _flat(batch))[0]
    each = lambda: [eng._local_step(eng.experiment_params(e),
                                    eng._opt_state,
                                    {k: v[e] for k, v in batch.items()})[0]
                    for e in range(eng.E)]
    times = {}
    for label, fn in (("stacked", stacked), ("per_experiment", each)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) / 3 * 1e3
        if label == "stacked":
            got = out
        else:
            want = out
    n = MAIN_N
    err = max(float((got[k][e * n:(e + 1) * n] - want[e][k]).abs().max())
              for e in range(eng.E) for k in got)
    bitwise = all(torch.equal(got[k][e * n:(e + 1) * n], want[e][k])
                  for e in range(eng.E) for k in got)
    log(f"phase 14(a): local step of E={eng.E} x n={n} full width, "
        f"deterministic cuDNN: stacked == per-experiment bit for bit "
        f"{bitwise} (max |diff| {err:.3g}); " + json.dumps(dict(
            stacked_ms=times["stacked"],
            per_experiment_ms=times["per_experiment"])))
    return bitwise


def sweep_pin_case(dev, label, sweep, solo, want_rounds):
    """One 14(a) run: the sweep for SWEEP_ROUNDS rounds, counts set to 0
    just before and read just after (held to ``want_rounds`` launches a
    round), then every experiment's solo run, bit for bit."""
    from repro_torch import kernels
    eng = sweep()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_steps(SWEEP_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    want = dict.fromkeys(got, 0)
    for k, v in want_rounds.items():
        want[k] = v * SWEEP_ROUNDS
    if got != want:
        raise AssertionError(f"14(a) {label}: launches {got} != {want}")
    for e in range(eng.E):
        one = solo(e)
        one.run_steps(SWEEP_ROUNDS)
        same = (all(torch.equal(one.params[k], eng.params[k][e])
                    for k in one.params)
                and len(one.edge_history) == SWEEP_ROUNDS
                and all(np.array_equal(a, b) for a, b in
                        zip(one.edge_history, eng.edge_history[e]))
                and one._comm_bytes == eng.comm_bytes(e))
        if eng.net is not None:
            s, w = one.net_stats, eng.net_stats[e]
            same = same and all(np.array_equal(a, b) for a, b in zip(
                one.delivered_history, eng.delivered_history[e])) and (
                (s["delivered"], s["dropped"], s["staleness_sum"],
                 s["staleness_hist"].tolist())
                == (w["delivered"], w["dropped"], w["staleness_sum"],
                    w["staleness_hist"].tolist()))
        if not same:
            raise AssertionError(f"14(a) {label}: experiment {e} is not its "
                                 f"solo run bit for bit")
    for p in eng.params.values():
        if not torch.isfinite(p).all():
            raise AssertionError(f"14(a) {label}: non-finite parameters")
    log(f"phase 14(a): {label} E={eng.E} n={MAIN_N} {SWEEP_ROUNDS} rounds, "
        f"every experiment its solo run bit for bit; " + json.dumps(dict(
            ms_per_round=wall / SWEEP_ROUNDS * 1e3, launches=got,
            comm_bytes=[eng.comm_bytes(e) for e in range(eng.E)],
            net_stats=None if eng.net is None else [
                {"delivered": st["delivered"], "dropped": st["dropped"],
                 "staleness_sum": st["staleness_sum"]}
                for st in eng.net_stats])))
    return got


def sweep_pin(dev):
    """Phase 14(a): GN-LeNet CIFAR-10 at full width, n = 50, fig3's
    settings, ten rounds, deterministic cuDNN: Morph over 4 seeds x
    {ideal, wan} at round_s = 1 (E = 8), Morph with delta_r (2, 3, 5) and
    no network (E = 3), Static over 4 seeds (E = 4, the general-W route);
    each experiment bit for bit its solo ``Superstep`` run, with
    ceil(E L / MAX_LEAVES) grouped mix launches a round and as many Gram
    launches a refresh.  Returns the launches summed."""
    import importlib
    from repro_torch.kernels import pairwise_cosine as pc
    gm = importlib.import_module("repro_torch.kernels.graph_mix")
    L = len(GN_LENET_LEAVES)
    mix = lambda E: -(-E * L // gm.MAX_LEAVES)
    gram = lambda E: -(-E * L // pc.MAX_LEAVES)
    totals = dict.fromkeys(launch_counts(), 0)
    torch.backends.cudnn.deterministic = True
    try:
        if not sweep_step_bits(dev):
            raise AssertionError("14(a): the stacked local step is not "
                                 "each experiment's own step bit for bit")
        seeds = tuple(range(SWEEP_SEEDS))
        cases = [
            ("morph ideal/wan", sweep_fixture(
                MAIN_N, dev, seeds * 2,
                profiles=("ideal",) * SWEEP_SEEDS + ("wan",) * SWEEP_SEEDS),
             {"graph_mix": mix(8), "gram_matrix": gram(8)}),
            ("morph delta_r (2, 3, 5)", sweep_fixture(
                MAIN_N, dev, (0, 1, 2), delta_rs=(2, 3, 5)),
             {"graph_mix_masked": mix(3), "gram_matrix": gram(3)}),
            ("static", sweep_fixture(MAIN_N, dev, seeds, name="static"),
             {"graph_mix": mix(4)})]
        for label, (sweep, solo), want in cases:
            got = sweep_pin_case(dev, label, sweep, solo, want)
            for k, v in got.items():
                totals[k] += v
    finally:
        torch.backends.cudnn.deterministic = False
    return totals


def per_row_mix(dev):
    """Phase 14(b): the grouped mixes with one W (or E) a row over E
    experiments' GN-LeNet leaves, against E one-W launches of the same
    leaves, bit for bit, f32 and bf16, at n = 50 (small route), 200 and
    1000 (tiled route); both timed by CUDA-graph replay.  (Phase 3 holds
    the one-W launches to the plain version.)"""
    from repro_torch.kernels import graph_mix_leaves, graph_mix_masked_leaves
    out = {}
    for n, E in SWEEP_MIX:
        gen = torch.Generator(device=dev).manual_seed(n + E)
        for dtype in (torch.float32, torch.bfloat16):
            sets = [tree_inputs(dev, gen, n, dtype) for _ in range(E)]
            flat = [x for xs, _, _ in sets for x in xs]
            ws = [w for _, w, _ in sets for _ in GN_LENET_LEAVES]
            es = [e for _, _, e in sets for _ in GN_LENET_LEAVES]
            L = len(GN_LENET_LEAVES)
            rows = (graph_mix_leaves(ws, flat), graph_mix_masked_leaves(es,
                                                                       flat))
            for e, (xs, w, em) in enumerate(sets):
                one = (graph_mix_leaves(w, xs), graph_mix_masked_leaves(em,
                                                                        xs))
                for i in range(L):
                    if not (torch.equal(rows[0][e * L + i], one[0][i])
                            and torch.equal(rows[1][e * L + i], one[1][i])):
                        raise AssertionError(
                            f"14(b) n={n} E={E} {dtype}: experiment {e} "
                            f"leaf {i} is not its one-W launch's bits")
            if dtype != torch.float32:
                continue
            per_exp = lambda fn, mats: [fn(m, xs) for m, (xs, _, _)
                                        in zip(mats, sets)]
            t = {}
            for name, fn, mats, per_leaf in (
                    ("graph_mix", graph_mix_leaves,
                     [w for _, w, _ in sets], ws),
                    ("graph_mix_masked", graph_mix_masked_leaves,
                     [em for _, _, em in sets], es)):
                t[name] = {
                    "per_row_w_device_ms": device_ms(
                        fn, [(per_leaf, flat)], reps=10),
                    "per_experiment_device_ms": device_ms(
                        lambda m: per_exp(fn, m), [(mats,)], reps=10)}
            out[f"n{n}_E{E}"] = t
            log(f"phase 14(b): n={n} E={E} GN-LeNet leaves, one W a row == "
                f"E one-W launches bit for bit (f32, bf16); device ms "
                f"(CUDA-graph replay, f32): {json.dumps(t)}")
    return out


class SweepStages:
    """Host-clock time of a round's stages, each ending in a synchronise
    (the ``stage`` hook of ``SweepSuperstep.round``,
    ``Superstep.net_round`` and the LM train step)."""

    def __init__(self):
        self.ms = {}

    def __call__(self, stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[stage] = self.ms.get(stage, 0.0) \
            + (time.perf_counter() - t0) * 1e3
        return out

    def per_round(self, rounds):
        out = {k: v / rounds for k, v in self.ms.items()}
        out["total"] = sum(out.values())
        return out


def timed_stages(engines, rounds):
    """``engines``' rounds 1 .. rounds (after an untimed round 0 each),
    stage by stage, one engine after another; returns ``(stages a round,
    peak device bytes)``."""
    for eng in engines:
        eng.net_round(0) if eng.net is not None else eng.round(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = SweepStages()
    for eng in engines:
        for rnd in range(1, rounds + 1):
            if eng.net is not None:
                eng.net_round(rnd, stages)
            else:
                eng.round(rnd, stages)
    return stages.per_round(rounds), torch.cuda.max_memory_allocated()


def sweep_breakdown(dev):
    """Phase 14(c): where a sweep round's time goes, against E solo runs
    of the same rounds: GN-LeNet at full width, n = 50, seeds x {ideal,
    wan} at E = 8 and E = 32, and the tiny MLP at fig14's shape (n = 6,
    16 seeds x {ideal, wan}); host clock around synchronised stages, peak
    memory."""
    import argparse
    from repro_torch.bench import common, fig14
    from repro_torch.dlrt import SweepSpec
    from repro_torch.netsim import DenseNetwork
    from repro_torch.netsim import profiles as prof
    out = {}
    for E in SWEEP_E:
        half = E // 2
        sweep, solo = sweep_fixture(MAIN_N, dev, tuple(range(half)) * 2,
                                    profiles=("ideal",) * half
                                    + ("wan",) * half)
        eng = sweep()
        swept, peak_sweep = timed_stages([eng], SWEEP_TIMED)
        del eng
        solos = [solo(e) for e in range(E)]
        seq, peak_seq = timed_stages(solos, SWEEP_TIMED)
        del solos
        row = {"sweep_ms_per_round": swept, "seq_ms_per_round": seq,
               "speedup": seq["total"] / swept["total"],
               "peak_bytes_sweep": peak_sweep, "peak_bytes_seq": peak_seq}
        out[f"gn_lenet_E{E}"] = row
        log(f"phase 14(c): GN-LeNet full width n={MAIN_N} E={E} (seeds x "
            f"ideal/wan, round_s 1), {SWEEP_TIMED} rounds: "
            f"{json.dumps(row)}")
    args = argparse.Namespace(nodes=6, rounds=24, eval_every=12, k=3,
                              batch=4, chunk=1, sim_every=5, delta_r=5)
    spec = SweepSpec.grid(seeds=range(16), profiles=["ideal", "wan"])
    tr, parts, _, test = common.tiny_mlp_experiment(6, seed=0, batch=4)
    test = {"images": test["images"][:32], "labels": test["labels"][:32]}
    nets = [DenseNetwork(prof.get_profile(spec.profiles[e], 6,
                                          spec.seeds[e]), round_s=1.0)
            for e in range(len(spec))]
    eng = fig14.build_sweep_engine("morph", spec, tr, parts, test, nets,
                                   args, dev)
    swept, peak_sweep = timed_stages([eng], SWEEP_TIMED)
    solos = [fig14.build_single_engine("morph", spec, e, tr, parts, test,
                                       nets, args, dev)
             for e in range(len(spec))]
    seq, peak_seq = timed_stages(solos, SWEEP_TIMED)
    row = {"sweep_ms_per_round": swept, "seq_ms_per_round": seq,
           "speedup": seq["total"] / swept["total"],
           "peak_bytes_sweep": peak_sweep, "peak_bytes_seq": peak_seq}
    out["tiny_mlp_E32"] = row
    log(f"phase 14(c): tiny MLP n=6 E=32 (fig14's shape), {SWEEP_TIMED} "
        f"rounds: {json.dumps(row)}")
    return out


def sweep_reference_check(dev):
    """Phase 14(d): tiny sweeps (GN-LeNet width 4 on 8-pixel images, n = 6,
    E = 3, ten rounds, batches keyed on the CPU) of Morph with and without
    WAN on the card and on the CPU: identical edges (and delivered masks),
    parameters within 1e-5."""
    cpu = torch.device("cpu")
    for profiles in (None, ("wan",) * 3):
        runs = []
        for d in (dev, cpu):
            sweep, _ = sweep_fixture(6, d, (0, 1, 2), profiles=profiles,
                                     tiny=True, host_slots=True)
            eng = sweep()
            eng.run_steps(SWEEP_ROUNDS)
            runs.append(eng)
        card, host = runs
        for e in range(3):
            hist = zip(card.edge_history[e] + card.delivered_history[e],
                       host.edge_history[e] + host.delivered_history[e])
            if not all(np.array_equal(a, b) for a, b in hist):
                raise AssertionError(f"14(d) net={profiles}: card and CPU "
                                     f"edges differ in experiment {e}")
        err = max(float((card.params[k].cpu() - host.params[k]).abs().max())
                  for k in host.params)
        if not err <= HOST_CARD_TOL:
            raise AssertionError(f"14(d) net={profiles}: card vs CPU params "
                                 f"{err} > {HOST_CARD_TOL}")
        log(f"phase 14(d): tiny morph sweep E=3 n=6 "
            f"{'wan' if profiles else 'no network'}: card == CPU edges over "
            f"{SWEEP_ROUNDS} rounds, params max |err| {err:.3g}")


def fig14_script(dev):
    """Phase 14(e): ``repro_torch.bench.fig14`` at its defaults (E = 32,
    n = 6, 24 rounds, Morph, Static, EL-Oracle); the sweep bit for bit the
    solo runs (``acceptance/bitwise_vs_singles`` = 1)."""
    import os
    from repro_torch.bench import fig14
    saved = os.environ.get("BENCH_DIR")
    os.environ["BENCH_DIR"] = ""            # records only, no file
    try:
        recs = {r["key"]: r for r in fig14.main(["--device", dev.type])}
    finally:
        if saved is None:
            del os.environ["BENCH_DIR"]
        else:
            os.environ["BENCH_DIR"] = saved
    if recs["acceptance/bitwise_vs_singles"]["value"] != 1:
        raise AssertionError(f"14(e) fig14: sweep is not the solo runs "
                             f"{recs['acceptance/bitwise_vs_singles']}")
    keys = ("acceptance/bitwise_vs_singles", "acceptance/trajectories",
            "sweep/morph_ms_per_round", "seq/morph_ms_per_round",
            "derived/speedup", "acceptance/speedup_ge_5x",
            "morph/agg_mean", "static/agg_mean", "el-oracle/agg_mean")
    log(f"phase 14(e): fig14 at its defaults: "
        f"{json.dumps({k: recs[k]['value'] for k in keys})}")


def sweep_path(dev):
    """Phase 14: (a) to (e); returns (a)'s launches and (b)'s times."""
    totals = sweep_pin(dev)
    for name in ("gram_matrix", "graph_mix", "graph_mix_masked"):
        if totals[name] == 0:
            raise AssertionError(f"phase 14: {name} never launched")
    log(f"phase 14: launches over (a) {json.dumps(totals)}")
    mixes = per_row_mix(dev)
    sweep_breakdown(dev)
    sweep_reference_check(dev)
    fig14_script(dev)
    return totals, mixes


# ---------------------------------------------------------------------------
# Phase 15: the tuner and the last one-card figure scripts.
# ---------------------------------------------------------------------------

TUNE_N = 16
TUNED_N = (16, 50, 100, 1000)      # the committed cache's shapes (fig9, 12)
FIG12_ROUNDS, FIG9_ROUNDS, FIG9_CHUNK = 5, 30, 10


@contextlib.contextmanager
def scoped_env(**values):
    """Environment variables set for the block and restored after it."""
    import os
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def tune_resolution(dev, tmp):
    """Phase 15(a): ``"auto"`` through a cache on the card, bit for bit the
    resolved values passed explicitly; the committed cache's shapes."""
    from repro_torch import tune as tt
    factory = tt.mlp_runner_factory(TUNE_N, rounds=12, device=dev)
    probe = factory(tt.Candidate())
    shape = tt.shape_of(probe.cfg, probe.params)
    if shape.key() != f"{dev.type}|n={TUNE_N}|d=1580|devices=1|net=0":
        raise AssertionError(f"15(a): shape {shape.key()}")
    entry = tt.TuneEntry(chunk=4, engine="sparse", compress="int8")
    cache = tt.TuningCache()
    cache.put(shape, entry)
    path = str(Path(tmp) / "resolve.json")
    cache.save(path)

    def run(**knobs):
        runner = factory(tt.Candidate())
        runner.cfg = dataclasses.replace(runner.cfg, eval_every=5, **knobs)
        runner.run()
        return runner

    with scoped_env(**{tt.ENV_CACHE: path}):
        auto = run(chunk="auto", engine="auto", compress="auto")
    explicit = run(chunk=4, engine="sparse", compress="int8")
    knobs = auto.resolved_knobs
    if knobs.source != f"cache:{shape.key()}" or \
            (knobs.chunk, knobs.engine, knobs.compress) != (4, "sparse",
                                                            "int8"):
        raise AssertionError(f"15(a): resolved {knobs}")
    same = (all(torch.equal(auto.params[k], explicit.params[k])
                for k in auto.params)
            and len(auto.edge_history) == len(explicit.edge_history) == 12
            and all(np.array_equal(a, b) for a, b in
                    zip(auto.edge_history, explicit.edge_history))
            and [r.comm_bytes for r in auto.log.records]
            == [r.comm_bytes for r in explicit.log.records])
    if not same:
        raise AssertionError("15(a): the auto run is not the explicit run")
    default = tt.load_default_cache()
    missing = [n for n in TUNED_N if default.get(tt.TuneShape(
        backend="cuda", n=n, d=1580)) is None]
    if missing:
        raise AssertionError(f"15(a): {tt.DEFAULT_CACHE_PATH.name} has no "
                             f"entry at n = {missing}")
    log(f"phase 15(a): auto == explicit bit for bit at n={TUNE_N} "
        f"({knobs.source}: chunk 4, sparse, int8); committed cache: "
        + json.dumps({k: {"chunk": e.chunk, "engine": e.engine,
                          "compress": e.compress,
                          "ms": e.seconds_per_round * 1e3}
                      for k, e in sorted(default.entries.items())}))


def tune_end_to_end(dev, tmp):
    """Phase 15(b): the tuner at n = 16 over a small space, into a file."""
    from repro_torch import tune as tt
    factory = tt.mlp_runner_factory(TUNE_N, device=dev)
    probe = factory(tt.Candidate())
    shape = tt.shape_of(probe.cfg, probe.params)
    cands = tt.candidate_space(shape, chunks=(8, 16),
                               compress_options=("none", "int8"))
    path = Path(tmp) / "tuned.json"
    cache = tt.TuningCache()
    t0 = time.perf_counter()
    result = tt.tune_into(cache, factory, shape=shape, candidates=cands,
                          rounds=16, probe_rounds=8)
    wall = time.perf_counter() - t0
    cache.save(path)
    entry = tt.TuningCache.load(path).get(shape)
    best = result.best
    if entry is None or (entry.chunk, entry.engine, entry.compress) != \
            (best.chunk, best.engine, best.compress):
        raise AssertionError(f"15(b): reloaded {entry} for {best}")
    if dev.type == "cuda" and \
            entry.tuned.get("card") != torch.cuda.get_device_name(0):
        raise AssertionError(f"15(b): provenance {entry.tuned}")
    log(f"phase 15(b): tuned {shape.key()} over {len(cands)} candidates "
        f"({len(result.survivors)} survivors) in {wall:.1f} s: best "
        f"{best.label()} at {entry.seconds_per_round * 1e3:.4f} ms a round; "
        + json.dumps({c.label(): round(v * 1e3, 4)
                      for c, v in result.seconds_per_round.items()}))


def _records(module, argv):
    with scoped_env(BENCH_DIR=""):          # records only, no file
        return {r["key"]: r for r in module.main(argv)}


def _add(totals, launches):
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def fig12_rows(dev):
    """Phase 15(c): fig12 at 5 rounds; returns its launches."""
    from repro_torch.bench import fig12
    from repro_torch.dlrt.superstep import SPARSE_EDGE_DECODE_MAX
    from repro_torch.kernels import reset_launches
    reset_launches()
    recs = _records(fig12, ["--rounds", str(FIG12_ROUNDS)])
    counts = launch_counts()
    refreshes = sum(1 for r in range(FIG12_ROUNDS) if r % 5 == 0)
    totals, rows = {}, {}
    for key, rec in recs.items():
        if not key.startswith("throughput/"):
            continue
        engine, n = key.split("/")[1].split("_n")
        got, calls = rec["launches"], rec["calls"]
        rounds = calls * rec["rounds_per_call"]
        want = {"gram_matrix": calls * refreshes if engine == "dense" else 0,
                "graph_mix_masked": rounds if engine == "dense" else 0,
                "graph_mix_sparse": rounds if engine == "sparse" else 0,
                "graph_mix": 0, "selective_scan": 0,
                "selective_scan_bwd": 0}
        if got != want:
            raise AssertionError(f"15(c) {key}: launches {got} != {want}")
        _add(totals, got)
        rows[key.split("/")[1]] = {
            "per_round_ms": 1e3 / rec["rounds_per_sec"],
            "peak_gb": rec["peak_memory_bytes"] / 1e9, "launches": {
                k: v for k, v in got.items() if v}}
    if totals != {k: v for k, v in counts.items()}:
        raise AssertionError(f"15(c): launches outside the rows "
                             f"{counts} != {totals}")
    if "throughput/sparse_n10000" not in recs or 10000 <= \
            SPARSE_EDGE_DECODE_MAX:
        raise AssertionError("15(c): no sparse row past the decode limit")
    big = fig12.build(10000, 3, "sparse", 2, dev)
    eng = big._make_engine()
    eng.run_steps(2)
    idx, mask = eng.edge_history[-1]
    if len(eng.edge_history) != 2 or idx.shape != (10000, 3) \
            or mask.shape != (10000, 3) or not all(
                torch.isfinite(p).all() for p in eng.params.values()):
        raise AssertionError("15(c): n = 10000 keeps no (idx, mask) pair")
    derived = {k: recs[k]["value"] for k in recs if k.startswith("derived/")}
    log(f"phase 15(c): fig12 at {FIG12_ROUNDS} rounds: {json.dumps(rows)}; "
        f"{json.dumps(derived)}")
    return counts


def fig9_rows(dev):
    """Phase 15(d): fig9 at n = 16, all four rows; returns its launches."""
    from repro_torch import tune as tt
    from repro_torch.bench import fig9
    from repro_torch.kernels import reset_launches
    reset_launches()
    recs = _records(fig9, ["--nodes", str(TUNE_N), "--rounds",
                           str(FIG9_ROUNDS), "--chunk", str(FIG9_CHUNK)])
    counts = launch_counts()
    warm = max(FIG9_ROUNDS // 10, 5)
    refresh = lambda rounds: sum(1 for r in range(rounds) if r % 5 == 0)
    rows, totals = {}, {}
    for label in fig9.ENGINES:
        rec = recs[f"{label}/n{TUNE_N}"]
        got = rec["launches"]
        if label.startswith("host"):
            rounds = FIG9_ROUNDS
            gram = 0 if label == "host-protocol" else refresh(rounds)
        else:
            rounds = rec["warm_rounds"] + 3 * rec["rounds_per_call"]
            gram = refresh(rec["warm_rounds"]) \
                + 3 * refresh(rec["rounds_per_call"])
        want = {"gram_matrix": gram, "graph_mix_masked": rounds,
                "graph_mix": 0, "graph_mix_sparse": 0, "selective_scan": 0,
                "selective_scan_bwd": 0}
        if got != want:
            raise AssertionError(f"15(d) {label}: launches {got} != {want}")
        _add(totals, got)
        rows[label] = {"rounds_per_sec": rec["rounds_per_sec"],
                       **({"knobs": rec["knobs"]} if "knobs" in rec
                          else {})}
    if totals != counts:
        raise AssertionError(f"15(d): launches outside the rows {counts}")
    key = f"cuda|n={TUNE_N}|d=1580|devices=1|net=0"
    entry = tt.load_default_cache().entries.get(key)
    auto = rows["compiled-auto"]["knobs"]
    if entry is None or auto["source"] != f"cache:{key}" \
            or auto["chunk"] != entry.chunk:
        raise AssertionError(f"15(d): compiled-auto resolved {auto}")
    derived = {k: recs[k]["value"] for k in recs if k.startswith("derived/")}
    log(f"phase 15(d): fig9 at n={TUNE_N} ({FIG9_ROUNDS} rounds, warm "
        f"{warm}): {json.dumps(rows)}; {json.dumps(derived)}")
    return counts


def smoke_figures(dev):
    """Phase 15(e): fig2, fig67 and fig3_curves at smoke depth."""
    from repro_torch.bench import fig2, fig3_curves, fig67
    with scoped_env(BENCH_DIR=""):          # records only, no file
        fig2.main(["--trials", "4", "--sizes", "20"])
        fig67.main(["--nodes", "12", "--rounds", "3", "--ks", "3"])
        final = fig3_curves.main(["--rounds", "4", "--nodes", "4",
                                  "--device", dev.type])
    if set(final) != set(fig3_curves.STRATEGIES) or not all(
            np.isfinite(v) for v in final.values()):
        raise AssertionError(f"15(e): fig3_curves final variances {final}")
    log(f"phase 15(e): fig2, fig67 and fig3_curves at smoke depth; "
        f"fig3_curves final inter-node variance {json.dumps(final)}")


def tune_path(dev):
    """Phase 15: (a) to (e); returns fig12's and fig9's launches."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tune_resolution(dev, tmp)
        tune_end_to_end(dev, tmp)
    fig12_counts = fig12_rows(dev)
    fig9_counts = fig9_rows(dev)
    smoke_figures(dev)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return fig12_counts, fig9_counts


# ---------------------------------------------------------------------------
# Phase 16: the sharded superstep on one card.
# ---------------------------------------------------------------------------

SHARD_STRATEGIES = ("morph", "static", "fully-connected")
SHARD_TIMED = {MAIN_N: 10, LARGE_N: 5}      # rounds timed a run in 16(c)


@contextlib.contextmanager
def one_rank_nccl_group():
    """A one-rank NCCL process group on a ``file://`` store for the block:
    runners given ``mesh_devices=1`` shard over it and leave it up."""
    import tempfile
    from datetime import timedelta
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=(Path(tmp) / "store").as_uri(),
            world_size=1, rank=0, timeout=timedelta(seconds=300))
        try:
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def deterministic_cudnn():
    """Deterministic cuDNN algorithms for the block, so two runs' local
    steps agree bit for bit."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def counted_run(name, n, dev, rounds=ROUNDS, **kw):
    """``run_strategy`` with the counts set to 0 just before and read just
    after: ``(runner, wall seconds, launches)``."""
    from repro_torch import kernels
    kernels.reset_launches()
    runner, wall = run_strategy(name, n, dev, rounds, DELTA_R, **kw)
    return runner, wall, launch_counts()


def sharded_want(name, rounds=ROUNDS, engine="dense"):
    """A sharded run's launches: one grouped ``graph_mix`` a round (the row
    block or the psum partials, every dense strategy and the network
    ring) and one grouped Gram a round for Morph (``sim_every`` 1); one
    grouped CSR launch a round for the sparse engine (its row block or
    its push partials)."""
    from repro_torch.kernels import KERNELS
    want = dict.fromkeys((k.__name__ for k in KERNELS), 0)
    if engine == "dense":
        want["graph_mix"] = rounds
        want["gram_matrix"] = rounds if name == "morph" else 0
    else:
        want["graph_mix_sparse"] = rounds
    return want


def shard_pair(name, n, dev, totals, label, tol, plain=None, **kw):
    """Phase 16(a), (b): one case without a mesh and on one rank, both
    with deterministic cuDNN: identical edges (and delivered sets and
    network counters), parameters within ``tol`` (bit for bit at 0),
    equal comm bytes, finite values, :func:`sharded_want`'s launches.
    ``plain`` is the run without a mesh where one was made already, as
    ``(runner, wall, launches)``; returns it."""
    engine = kw.get("engine", "dense")
    plain_kw = {k: v for k, v in kw.items() if k != "collective"}
    with deterministic_cudnn():
        if plain is None:
            plain = counted_run(name, n, dev, **plain_kw)
        sharded, wall, got = counted_run(name, n, dev, mesh_devices=1, **kw)
    plain, plain_wall, plain_got = made = plain
    _add(totals, got)
    if got != sharded_want(name, engine=engine):
        raise AssertionError(f"16 {label}: launches {got} != "
                             f"{sharded_want(name, engine=engine)}")
    if len(plain.edge_history) != len(sharded.edge_history) or not all(
            np.array_equal(a, b) for a, b in zip(plain.edge_history,
                                                 sharded.edge_history)):
        raise AssertionError(f"16 {label}: edges differ from the run "
                             "without a mesh")
    if plain.net_stats is not None:
        same = all(np.array_equal(a, b) for a, b in zip(
            plain.delivered_history, sharded.delivered_history)) and all(
            np.array_equal(plain.net_stats[k], sharded.net_stats[k])
            for k in plain.net_stats)
        if not same:
            raise AssertionError(f"16 {label}: delivered sets or network "
                                 "counters differ")
    bits = all(torch.equal(plain.params[k], sharded.params[k])
               for k in plain.params)
    gap = max(float((plain.params[k].float() - sharded.params[k].float())
                    .abs().max()) for k in plain.params)
    if (tol == 0.0 and not bits) or gap > tol:
        raise AssertionError(f"16 {label}: parameters {gap:.3g} apart "
                             f"(limit {tol:g}, bit for bit {bits})")
    recs = sharded.log.records
    if [r.comm_bytes for r in plain.log.records] != \
            [r.comm_bytes for r in recs]:
        raise AssertionError(f"16 {label}: comm bytes differ")
    if not all(np.isfinite(r.mean_loss) for r in recs) or not all(
            torch.isfinite(p).all() for p in sharded.params.values()):
        raise AssertionError(f"16 {label}: non-finite values")
    summary = {"bits": bits, "max_abs_diff": gap, "tol": tol,
               "ms_per_round_incl_eval": wall / ROUNDS * 1e3,
               "no_mesh_ms_per_round_incl_eval": plain_wall / ROUNDS * 1e3,
               "accuracy": recs[-1].mean_accuracy,
               "accuracy_equal": [r.mean_accuracy for r in recs] ==
               [r.mean_accuracy for r in plain.log.records],
               "comm_bytes": recs[-1].comm_bytes, "launches": got,
               "no_mesh_launches": plain_got}
    log(f"phase 16{label}: {json.dumps(summary)}")
    return made


def sharded_conformance(dev, totals):
    """Phase 16(a) and (b)."""
    # Every pair is held bit for bit: on one rank a reduce-scatter is a
    # copy, the gather codec path is the single-device arithmetic, and the
    # masked and general dense mixes and the sparse row block and partials
    # reach kernels that sum in the same order.
    for name in SHARD_STRATEGIES:
        shard_pair(name, MAIN_N, dev, totals,
                   f"(a) {name} n={MAIN_N} gather", 0.0)
    shard_pair("morph", MAIN_N, dev, totals, f"(b) morph n={MAIN_N} psum",
               0.0, collective="psum")
    for col in ("gather", "psum"):
        shard_pair("morph", MAIN_N, dev, totals,
                   f"(b) morph n={MAIN_N} int8 {col}", 0.0,
                   collective=col, compress="int8")
    shard_pair("morph", MAIN_N, dev, totals,
               f"(b) morph n={MAIN_N} fig11 wan gather", 0.0,
               net=fig11_network("wan", MAIN_N, ROUNDS))
    plain = None
    for col in ("gather", "psum"):
        plain = shard_pair("sparse-morph", LARGE_N, dev, totals,
                           f"(b) sparse morph n={LARGE_N} {col}",
                           0.0, plain=plain, collective=col,
                           engine="sparse", eval_chunk=16, **LARGE)


def shard_breakdown(dev, name, n, totals, engine="dense",
                    collective="gather", **setup):
    """Phase 16(c): ms a round of one case without a mesh and on one rank,
    first the rounds alone (one synchronise each side), then by stage
    through the engines' ``stage`` hook (each stage ends in a
    synchronise); one warm round first, evaluation left out."""
    from repro_torch import kernels
    rounds = SHARD_TIMED[n]
    out = {}
    # One runner for both engines: each starts from its parameters, and
    # the stream draws a round's batch from that round's key alone.
    runner = make_runner(name, n, dev, 2 * rounds + 1, 10 ** 9,
                         engine=engine, eval_chunk=16, collective=collective,
                         **setup)
    for label, mesh in (("no_mesh", None), ("one_rank", 1)):
        runner.cfg = dataclasses.replace(runner.cfg, mesh_devices=mesh)
        eng = runner._make_engine()
        kernels.reset_launches()
        eng.round(0)                               # warm (negotiates)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rnd in range(1, rounds + 1):
            eng.round(rnd)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) / rounds * 1e3
        stages = {}

        def timed(stage, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            stages[stage] = stages.get(stage, 0.0) \
                + time.perf_counter() - t
            return got

        for rnd in range(rounds + 1, 2 * rounds + 1):
            eng.round(rnd, stage=timed)
        if mesh is not None:
            _add(totals, launch_counts())
        eng.close()
        out[label] = {"ms_per_round": whole, "stages_ms": {
            k: v / rounds * 1e3 for k, v in stages.items()}}
    out["one_rank_over_no_mesh"] = out["one_rank"]["ms_per_round"] \
        / out["no_mesh"]["ms_per_round"]
    log(f"phase 16(c): {name} n={n} ({engine}, {collective}), {rounds} "
        f"rounds each "
        f"(negotiation every {DELTA_R}th): {json.dumps(out)}")
    return out


def fig10_rows(dev, totals):
    """Phase 16(d): fig10 with one NCCL rank on the card, and with one,
    two and four gloo ranks on the card's host."""
    from repro_torch.bench import fig10
    rounds, refreshes = 60, sum(1 for r in range(60) if r % 5 == 0)
    with scoped_env(BENCH_DIR=""):           # records only, no file
        card = {r["key"]: r for r in fig10.main(["--devices", "1"])}
        host = {r["key"]: r for r in fig10.main(
            ["--device", "cpu", "--devices", "1", "2", "4", "--rounds",
             "20", "--chunk", "10"])}
    row = card["sharded-d1/n100"]
    want = dict(dict.fromkeys(row["launches"], 0), graph_mix=rounds,
                gram_matrix=refreshes)
    if row["launches"] != want or row["rounds"] != rounds:
        raise AssertionError(f"16(d): fig10 card launches "
                             f"{row['launches']} != {want}")
    _add(totals, row["launches"])
    rows = {f"card/{k}": v.get("value") for k, v in card.items()}
    rows.update({f"host/{k}": v.get("value") for k, v in host.items()})
    if not all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0
               for v in rows.values()):
        raise AssertionError(f"16(d): fig10 rows {rows}")
    log(f"phase 16(d): fig10 (n = 100; card {rounds} rounds, chunk 20; "
        f"host 20 rounds, chunk 10): "
        f"{json.dumps(rows)}; card row launches "
        f"{json.dumps(row['launches'])}")


def sharded_path(dev):
    """Phase 16: (a) to (d); returns the launches of its sharded runs."""
    from repro_torch.kernels import KERNELS
    t0 = time.perf_counter()
    totals = dict.fromkeys((k.__name__ for k in KERNELS), 0)
    with one_rank_nccl_group():
        sharded_conformance(dev, totals)
        t1 = time.perf_counter()
        shard_breakdown(dev, "morph", MAIN_N, totals)
        shard_breakdown(dev, "morph", MAIN_N, totals, collective="psum")
        shard_breakdown(dev, "morph", LARGE_N, totals, **LARGE)
        shard_breakdown(dev, "sparse-morph", LARGE_N, totals,
                        engine="sparse", **LARGE)
    t2 = time.perf_counter()
    fig10_rows(dev, totals)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s ((a) and (b) "
        f"{t1 - t0:.1f}, (c) {t2 - t1:.1f}, (d) "
        f"{time.perf_counter() - t2:.1f})")
    return totals


# ---------------------------------------------------------------------------
# Phase 17: decentralized LM training (the launcher's path) and the scan's
# backward kernel.
# ---------------------------------------------------------------------------

# The least the S6 backward needs per (t, channel, state) element, whatever
# the kernel.  It has no bit contract (it is held to autograd at
# SCAN_BWD_TOL), so every product that feeds an add counts as one FFMA.
# h_{t-1} again, since [b, L, di, ds] is never stored: dt a (FMUL), its
# exponential by the forward's expf (6 FP32-pipe instructions around its
# MUFU.EX2, counted as the forward's row counts them: the recompute and the
# carry must use the factor the forward multiplied by, so that the states
# are the forward's and the gradients those of the function it computed),
# q = exp h_{t-1} (FMUL) and h_t = (dt x) b + q (FFMA), dt x once a
# channel: 9.  The step: g = dy c + exp' g' (FMUL, FFMA); e = g q (FMUL);
# the sums over the states into dx of g b and into ddt of e a (2 FFMA);
# da += e dt (FFMA); dc += dy h and db += g (dt x) over the channels
# (2 FFMA): 8.  17 in all, and one MUFU.EX2.
SCAN_BWD_FP32_PER_ELEMENT = 17
SCAN_BWD_MUFU_PER_ELEMENT = 1
# The backward kernel against autograd through the plain scan: each
# gradient within 1e-4 of its largest magnitude, plus 1e-4 of the value
# (and one bf16 ulp where the gradient is bf16): both differ where their
# exp does, as the forward, and in the order of their sums over the states
# (dx, ddt), the channels (db, dc) and batch and time (da).
SCAN_BWD_TOL = 1e-4
SCAN_GRADS = ("dx", "ddt", "db", "dc", "da", "dh0")
# 17(b): Llama-3.2-3B at its published widths with 8 of its 28 layers,
# bf16, trained as launch/train.py does it (n = 8, sgd 0.05, Morph k = 3,
# view 5, beta 500, delta_r 5; batch 8 of 128 tokens a node), 10 rounds,
# on token streams over TRAIN_IDS of its 128,256 ids.
TRAIN_LAYERS, TRAIN_N, TRAIN_ROUNDS, TRAIN_IDS = 8, 8, 10, 2048
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STREAM = 8, 128, 20_000
# 17(b): the Gram kernel's cosine of a leaf of the embedding's shape (D =
# 394 M a node) against f64.  Its f32 sums run chains of about 3 M
# products a block, so each Gram entry is off by some sqrt(3e6) x 2^-24,
# about 1e-4 of |x_i| |x_j|; the limit is ten times that.  The leaf's rows
# (embedding_like_leaf) have cosines a_i a_j from 0.012 to 0.79, so a row
# read from a wrong offset (past 2^31) or a swapped pair of rows moves an
# entry by 0.01 or more; the planted faults show it.
EMBED_COS_ATOL = 1e-3


def scan_grads_close(got, want, worst, what):
    """Hold the backward kernel's gradients to the plain version's within
    :data:`SCAN_BWD_TOL`; keep the worst |err| by the inputs' type."""
    key = "float32" if got[0].dtype == torch.float32 else "bfloat16"
    for name, g, w in zip(SCAN_GRADS, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"scan backward {what} {name}: {g.dtype} "
                                 f"{tuple(g.shape)} against {w.dtype} "
                                 f"{tuple(w.shape)}")
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        rtol = SCAN_BWD_TOL + (BF16_ULP if got[SCAN_GRADS.index(name)].dtype
                               == torch.bfloat16 else 0.0)
        atol = SCAN_BWD_TOL * float(w.abs().max())
        excess = float((diff - rtol * w.abs()).max())
        worst[key] = max(worst[key], float(diff.max()))
        if not excess <= atol:
            raise AssertionError(f"scan backward {what} {name}: |err| "
                                 f"exceeds {rtol} * |want| by {excess} > "
                                 f"{atol}")


def check_scan_backward(dev):
    """17(a): the backward kernel, given the tile states of a forward
    launch as the training path gives them, against autograd through the
    plain scan at phase 3's scan shapes and the served shape, each type,
    with and without the last state's cotangent, and two calls the same
    bits."""
    from repro_torch.kernels import ref, selective_scan_bwd
    from repro_torch.kernels.selective_scan import _forward
    gen = torch.Generator(device=dev).manual_seed(17)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    count = 0
    for shape in SCAN_SHAPES + [SERVED_SCAN]:
        served = shape == SERVED_SCAN
        for label, types in SCAN_TYPES.items():
            args = scan_inputs(dev, gen, *shape, types)
            _, _, tiles = _forward(*args, keep_tiles=True)
            bt, L, di, ds = shape
            dy = torch.randn((bt, L, di), generator=gen, device=dev)
            dh = torch.randn((bt, di, ds), generator=gen, device=dev) * 0.1
            for last in ((dh,) if served else (dh, None)):
                got = selective_scan_bwd(*args, dy, last, tiles)
                want = ref.selective_scan_bwd(*args, dy, last)
                scan_grads_close(got, want, worst, f"{shape} {label}")
                again = selective_scan_bwd(*args, dy, last, tiles)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"scan backward {shape} {label}: "
                                         "two calls differ")
                count += 1
                del got, want, again
    log(f"phase 17(a): {count} scan backward kernel/plain comparisons "
        f"within atol {SCAN_BWD_TOL} x max|grad| and rtol {SCAN_BWD_TOL} "
        f"(+ one bf16 ulp), each twice with the same bits (shapes "
        f"{SCAN_SHAPES + [SERVED_SCAN]}, types {list(SCAN_TYPES)}); worst "
        f"{json.dumps(worst)}")
    return worst


def served_backward_sets(dev, count=3, seed=18):
    """``count`` sets of the backward's arguments at the served shape with
    apply_mamba's types, as the training path gives them: x, dt, b, c, a,
    h0, dy, dh and the window states of a forward launch keeping them
    (together more bytes than L2 holds)."""
    from repro_torch.kernels.selective_scan import _forward
    gen = torch.Generator(device=dev).manual_seed(seed)
    bt, L, di, ds = SERVED_SCAN
    sets = []
    for _ in range(count):
        args = scan_inputs(dev, gen, *SERVED_SCAN, SCAN_TYPES["serving"])
        _, _, tiles = _forward(*args, keep_tiles=True)
        dy = torch.randn((bt, L, di), generator=gen, device=dev)
        dh = torch.randn((bt, di, ds), generator=gen, device=dev) * 0.1
        sets.append((*args, dy, dh, tiles))
    return sets


def time_scan_backward(dev):
    """17(a): the backward kernel at the served shape with apply_mamba's
    types (dh given), inputs rotated through more than L2, against
    autograd through the plain scan; no library call computes it.  The
    bound is phase 3's four parts for the backward's counts
    (:data:`SCAN_BWD_FP32_PER_ELEMENT`): bytes (x, dt, b, c, a, h0, dy
    and dh read once; the gradients written once; the tile states are
    this design's own scratch, not the function's), exponentials, FP32
    lanes, issue.  ``kernel_issue_ms`` prices the instructions of the
    kernel's own window (:func:`scan_bwd_sass`) the same way: this kernel's
    cost, beside the bound and not in it."""
    from repro_torch.kernels import ref, selective_scan_bwd
    bt, L, di, ds = SERVED_SCAN
    sets = served_backward_sets(dev)

    def kernel(x, dt, b, c, a, h0, dy, dh, tiles):
        return selective_scan_bwd(x, dt, b, c, a, h0, dy, dh, tiles)

    t = {**timings((kernel, sets), None, reps=10),
         "plain_ms": time_ms(lambda *s: ref.selective_scan_bwd(*s[:8]),
                             sets[:1], reps=1, warmup=1),
         "library": "none: no single PyTorch call computes the S6 "
                    "recurrence's backward"}
    x, dt, b, c, a, h0, dy, dh, _ = sets[0]
    size = lambda *ts: sum(v.numel() * v.element_size() for v in ts)
    # Read: x, dt, b, c, a, h0, dy, dh; written: dx, ddt, db, dc (the
    # inputs' types), da and dh0 (f32).
    nbytes = size(x, dt, b, c, a, h0, dy, dh) + size(x, dt, b, c, a, h0)
    elements = bt * L * di * ds
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "mufu": elements * SCAN_BWD_MUFU_PER_ELEMENT
             / (SFU_PER_CLOCK_PER_SM * sms * clock) * 1e3,
             "f32_issue": elements * SCAN_BWD_FP32_PER_ELEMENT
             / (FP32_PER_CLOCK_PER_SM * sms * clock) * 1e3,
             "issue": elements
             * (SCAN_BWD_FP32_PER_ELEMENT + SCAN_BWD_MUFU_PER_ELEMENT)
             / (ISSUE_PER_CLOCK_PER_SM * sms * clock) * 1e3}
    t["bound_ms"] = max(parts.values())
    t["bound_part"] = max(parts, key=parts.get)
    t["bound_by"] = "bytes" if t["bound_part"] == "bytes" else "operations"
    t["bound_parts_ms"] = parts
    t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
    per = scan_bwd_sass()
    t["kernel_issue_ms"] = elements * per["all"] \
        / (ISSUE_PER_CLOCK_PER_SM * sms * clock) * 1e3
    t["sass_per_element"] = per
    t["sm_clock_mhz"], t["sms"] = clock / 1e6, sms
    t["shape"] = [bt, L, di, ds, "x bf16, dt f32, b/c bf16; dy, dh f32"]
    log(f"phase 17(a): selective_scan_bwd at {SERVED_SCAN}: "
        f"{json.dumps(t)}")
    return t


def full_width_train_config():
    """17(b): Llama-3.2-3B at its published widths with TRAIN_LAYERS of its
    28 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-3b"),
                               num_layers=TRAIN_LAYERS)


def train_batchers(n, seed0=1000, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """Each node's batches as launch/train.py builds them, over a stream
    of TRAIN_IDS token ids (valid ids of the full vocabulary; a stream
    over all 128,256 would need a 131 GB transition matrix)."""
    from repro_torch.data import TokenBatcher, make_token_stream
    return [TokenBatcher(make_token_stream(
        TRAIN_STREAM, TRAIN_IDS, seed=seed0 + i,
        concentration=0.05 + 0.1 * (i % 4)), batch, seq, seed=i)
        for i in range(n)]


def next_batch(batchers):
    nbs = [b.next() for b in batchers]
    return {k: np.stack([nb[k] for nb in nbs]) for k in ("tokens", "labels")}


def train_rounds(dev, cfg, phase, n=TRAIN_N, batch_size=TRAIN_BATCH,
                 seq=TRAIN_SEQ, frontend=None, rounds=TRAIN_ROUNDS):
    """``rounds`` rounds of the train step at ``cfg``'s widths as
    launch/train.py runs them (``n`` nodes, sgd 0.05, Morph k = 3, view 5,
    beta 500, delta_r 5; ``batch_size`` sequences of ``seq`` tokens a node
    from :func:`train_batchers`, and ``frontend(gen)``'s stub-frontend
    inputs, drawn on the card, if given) with the stage breakdown, peak
    memory against the reckoning, and launch counts: the loss finite and
    lower at the last round than at the first, the Gram launches of Eq. 3
    (one a dtype and 32 leaves) on each topology round and one masked-mix
    launch a group of leaves (and 64 leaves) every round, and nothing
    else.  Returns (launches, record, state)."""
    from repro_torch import kernels
    from repro_torch.dlrt import (MorphHParams, init_train_state,
                                  make_train_step)
    from repro_torch.dlrt.distributed import MIX_GROUP_BYTES
    from repro_torch.kernels import ops
    from repro_torch.kernels.graph_mix import MAX_LEAVES as MIX_LEAVES
    from repro_torch.kernels.pairwise_cosine import MAX_LEAVES as GRAM_LEAVES
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    opt = sgd(0.05)
    hp = MorphHParams(k=min(3, n - 1), view_size=min(5, n - 1), beta=500.0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, n, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = flatten(state.params)
    per_node = sum(v[0].numel() for v in params.values())
    population = sum(v.numel() * v.element_size() for v in params.values())
    groups = ops.mix_groups(params, MIX_GROUP_BYTES)
    largest = max(sum(params[k].numel() * params[k].element_size()
                      for k in g) for g in groups)
    dtypes = [v.dtype for v in params.values()]
    grams = sum(-(-dtypes.count(t) // GRAM_LEAVES) for t in set(dtypes))
    mixes = sum(-(-len(g) // MIX_LEAVES) for g in groups)
    batchers = train_batchers(n, batch=batch_size, seq=seq)
    gen = torch.Generator(device=dev).manual_seed(17)
    steps = {topo: make_train_step(cfg, opt, hp, do_topology=topo)
             for topo in (True, False)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    losses, rounds_ms, timers = [], [], []
    for rnd in range(rounds):
        batch = next_batch(batchers)
        if frontend is not None:
            batch.update(frontend(gen))
        timer = SweepStages()
        t1 = time.perf_counter()
        state, m = steps[rnd % DELTA_R == 0](state, batch, stage=timer)
        torch.cuda.synchronize()
        rounds_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        timers.append(timer.ms)
    got = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    topo_rounds = sum(1 for r in range(rounds) if r % DELTA_R == 0)
    want = dict.fromkeys(got, 0)
    want.update(gram_matrix=topo_rounds * grams,
                graph_mix_masked=rounds * mixes)
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: losses {losses}: not finite or not "
                             "lower at the last round than at the first")
    stages = {}
    for name in timers[0] | timers[-1]:
        per = [t.get(name, 0.0) for t in timers]
        stages[name] = {"mean_ms": float(np.mean(per)),
                        "steady_mean_ms": float(np.mean(per[1:]))}
    total = sum(v["steady_mean_ms"] for v in stages.values())
    for v in stages.values():
        v["share"] = v["steady_mean_ms"] / total
    # Reckoning: the population, one node's gradients, its f32 logits
    # (and their softmax), and the mix's largest group of new leaves.
    positions = seq + (cfg.frontend_tokens if frontend is not None
                       and cfg.encoder is None else 0)
    logits = batch_size * positions * cfg.vocab_size * 4
    reckoned = population + population // n + 2 * logits + largest
    rec = {"config": {"name": cfg.name, "d_model": cfg.d_model,
                      "layers": cfg.num_layers,
                      "heads": [cfg.num_heads, cfg.num_kv_heads],
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                      "tied": cfg.tie_embeddings, "dtype": cfg.param_dtype,
                      "remat": cfg.remat},
           "nodes": n, "batch": [batch_size, positions],
           "params_per_node": per_node,
           "population_gb": population / 1e9, "init_s": init_s,
           "losses": losses, "round_ms": rounds_ms,
           "steady_round_ms": float(np.mean(rounds_ms[1:])),
           "stages": stages, "mix_groups": len(groups),
           "mix_largest_group_gb": largest / 1e9,
           "largest_leaf_elements": max(v.numel() for v in params.values()),
           "peak_gb": peak / 1e9, "peak_over_base_gb": (peak - base) / 1e9,
           "reckoned_gb": reckoned / 1e9, "launches": got}
    return got, rec, state


def train_full_width(dev):
    """17(b): ten rounds of the full-width train step (:func:`train_rounds`
    on Llama-3.2-3B); then :func:`embedding_past_2_31` on a leaf of the
    embedding's shape with the run's last edges.  Returns the launches."""
    from repro_torch.tree import flatten
    cfg = full_width_train_config()
    got, rec, state = train_rounds(dev, cfg, "17(b)")
    log(f"phase 17(b): llama3.2-3b full width, {TRAIN_LAYERS} layers, "
        f"n = {TRAIN_N}, {TRAIN_ROUNDS} rounds: {json.dumps(rec)}")
    edges = state.morph.edges.clone(memory_format=torch.contiguous_format)
    shape = tuple(flatten(state.params)["embed.table"].shape)
    del state
    torch.cuda.empty_cache()
    embedding_past_2_31(dev, edges, shape)
    return got


def embedding_like_leaf(dev, n, d, seed=19):
    """``[n, d]`` bf16 rows ``a_i s + sqrt(1 - a_i^2) z_i`` with one shared
    normal ``s``, each node's own normal ``z_i`` and ``a_i = (i + 1) / (n +
    1)``: cosines about ``a_i a_j``, different for every pair, so a row
    read from another offset or another node's place changes them (the
    trained leaf's rows are near consensus, with every cosine near 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shared = torch.randn(d, generator=gen, device=dev)
    out = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for i in range(n):
        a = (i + 1) / (n + 1)
        out[i] = (torch.randn(d, generator=gen, device=dev)
                  .mul_(math.sqrt(1 - a * a)).add_(shared, alpha=a))
    del shared
    return out


def embedding_past_2_31(dev, edges, shape, step=1 << 25):
    """17(b): the Gram and masked-mix kernels on an embedding-shaped leaf
    (:func:`embedding_like_leaf`, ``[n, 128,256 x 3,072]``, 3.15 B elements
    at n = 8; rows 6 and 7 start past 2^31): the cosine against the Gram
    matrix in f64 within :data:`EMBED_COS_ATOL`, the mix against its plain
    version column block by column block.  Then planted faults, each
    undone bit for bit: node 7's row one element off and rows 6 and 7
    swapped must break the cosine's limit, node 7's row one element off
    the mix's."""
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    n = shape[0]
    emb = embedding_like_leaf(dev, n, math.prod(shape[1:]))
    gram = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for c0 in range(0, emb.shape[1], step):
        block = emb[:, c0:c0 + step].double()
        gram += block @ block.T
        del block
    norms = torch.sqrt(torch.diagonal(gram))
    true_cos = gram / (norms[:, None] * norms[None, :])

    def cos_err():
        return float((ops.pairwise_cosine(emb).double() - true_cos)
                     .abs().max())

    def mix_excess():
        """The largest ``|err| - rtol |want|`` of the kernel's mix of
        ``emb`` over ``want``, the plain mix of the leaf as it was made."""
        mixed = kernels.graph_mix_masked(edges, emb)
        atol, rtol = tolerance("graph_mix_masked", n, True)
        excess = -math.inf
        for c0 in range(0, emb.shape[1], step):
            w = want[:, c0:c0 + step].float()
            diff = (mixed[:, c0:c0 + step].float() - w).abs()
            excess = max(excess, float((diff - rtol * w.abs()).max()))
        return excess, atol

    err = cos_err()
    if not err <= EMBED_COS_ATOL:
        raise AssertionError(f"17(b): the embedding-shaped leaf's cosine is "
                             f"{err} from f64's > {EMBED_COS_ATOL}")
    worst = {"graph_mix_masked": {"float32": 0.0, "bfloat16": 0.0}}
    mixed = kernels.graph_mix_masked(edges, emb)
    want = torch.empty_like(emb)
    for c0 in range(0, emb.shape[1], step):
        want[:, c0:c0 + step] = ref.graph_mix_masked(
            edges, emb[:, c0:c0 + step])
        compare("graph_mix_masked", mixed[:, c0:c0 + step],
                want[:, c0:c0 + step], n, torch.bfloat16,
                "embedding-shaped leaf", worst)
    del mixed

    faults = {}
    emb[7] = emb[7].roll(1)                       # node 7 one element off
    faults["cos_row7_shifted"] = cos_err()
    faults["mix_row7_shifted"], mix_atol = mix_excess()
    emb[7] = emb[7].roll(-1)
    emb[[6, 7]] = emb[[7, 6]]
    faults["cos_rows67_swapped"] = cos_err()
    emb[[6, 7]] = emb[[7, 6]]
    if not (faults["cos_row7_shifted"] > EMBED_COS_ATOL
            and faults["cos_rows67_swapped"] > EMBED_COS_ATOL
            and faults["mix_row7_shifted"] > mix_atol):
        raise AssertionError(f"17(b): a planted fault passes the limits "
                             f"(cosine {EMBED_COS_ATOL}, mix excess "
                             f"{mix_atol}): {faults}")
    if cos_err() != err:
        raise AssertionError("17(b): the leaf did not come back from the "
                             "planted faults")
    log(f"phase 17(b): an embedding-shaped leaf [{n}, {emb.shape[1]}] "
        f"({emb.numel()} elements, cosines "
        f"{float(true_cos.min()):.4f} to "
        f"{float((true_cos - torch.eye(n, device=dev)).max()):.4f} off the "
        f"diagonal): the Gram kernel's cosine within {err} of f64's (limit "
        f"{EMBED_COS_ATOL}); the masked mix within tolerance of its plain "
        f"version, worst {json.dumps(worst['graph_mix_masked'])}; planted "
        f"faults caught: {json.dumps(faults)} (mix excess limit "
        f"{mix_atol})")
    del emb, want
    torch.cuda.empty_cache()


def reduced_train_config(arch):
    """17(c): the reduced config (Jamba without experts)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(
            cfg, moe=None, pattern=tuple(dataclasses.replace(s, moe=False)
                                         for s in cfg.pattern))
    return cfg.reduced()


def train_card_vs_cpu(dev):
    """17(c): reduced Llama-3.2-3B and Jamba without experts, 3 rounds (a
    topology round first) on the card and on the CPU from one state:
    identical edges, parameters within 1e-4.  Returns the card runs'
    launches."""
    from repro_torch import kernels
    from repro_torch.dlrt import (MorphHParams, init_train_state,
                                  make_train_step, train_state_to)
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    totals = dict.fromkeys(launch_counts(), 0)
    out = {}
    for arch in ("llama3.2-3b", "jamba-1.5-large-398b"):
        cfg = reduced_train_config(arch)
        n = 4
        cpu = init_train_state(cfg, sgd(0.05), n, seed=5, device="cpu")
        card = train_state_to(cpu, dev)
        steps = {topo: make_train_step(cfg, sgd(0.05),
                                       MorphHParams(k=2, view_size=3),
                                       do_topology=topo)
                 for topo in (True, False)}
        rng = np.random.default_rng(5)
        gaps = []
        for rnd in range(3):
            toks = rng.integers(0, cfg.vocab_size, (n, 2, 33)).astype(
                np.int32)
            batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
            cpu, _ = steps[rnd == 0](cpu, batch)
            kernels.reset_launches()
            card, _ = steps[rnd == 0](card, batch)
            torch.cuda.synchronize()
            _add(totals, launch_counts())
            if not torch.equal(card.morph.edges.cpu(), cpu.morph.edges):
                raise AssertionError(f"17(c) {arch} round {rnd}: edges "
                                     "differ")
            want = flatten(cpu.params)
            gap = max(float((v.cpu() - want[k]).abs().max())
                      for k, v in flatten(card.params).items())
            if not gap <= 1e-4:
                raise AssertionError(f"17(c) {arch} round {rnd}: params "
                                     f"{gap} > 1e-4")
            gaps.append(gap)
        out[arch] = gaps
    if not (totals["selective_scan"] and totals["selective_scan_bwd"]
            and totals["gram_matrix"] and totals["graph_mix_masked"]):
        raise AssertionError(f"17(c): card launches {totals}")
    log(f"phase 17(c): card == CPU, identical edges, params within 1e-4 "
        f"(max |gap| by round {json.dumps(out)}); card launches "
        f"{json.dumps(totals)}")
    return totals


# 17(d): one Mamba layer of Jamba-1.5-Large at its published widths
# (d_model 8192, d_inner 16,384, d_state 16), bf16, a batch of 2 x 2,048
# tokens; each step timed JAMBA_LAYER_REPS times after a warm-up.
JAMBA_LAYER_BATCH, JAMBA_LAYER_SEQ, JAMBA_LAYER_REPS = 2, 2048, 3


def jamba_layer_step(dev):
    """17(d): one Jamba-1.5-Large Mamba layer (``mamba.apply_mamba``) at
    its published widths in bf16 under autograd: its forward (the scan
    keeping its window states) and its backward, each between CUDA events,
    and inside them the scan's forward and backward between CUDA events of
    their own (``_Scan.forward`` and ``_Scan.backward`` wrapped for the
    run), so the scan backward's share of the layer is device time over
    device time.
    One scan and one scan backward launch a step; every gradient finite
    and of its leaf's shape."""
    import importlib
    from repro_torch import kernels
    from repro_torch.models import mamba
    from repro_torch.tree import flatten
    # The module, not the function that the package exports by its name.
    scan = importlib.import_module("repro_torch.kernels.selective_scan")._Scan
    cfg = jamba_serving_config()
    gen = torch.Generator(device=dev).manual_seed(20)
    params = mamba.mamba_params(gen, cfg, torch.bfloat16)
    leaves = list(flatten(params).values())
    shape = (JAMBA_LAYER_BATCH, JAMBA_LAYER_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    for t in leaves + [x]:
        t.requires_grad_()
    spans = {"scan": [], "scan_bwd": []}

    def timed(key, fn):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            spans[key].append(ev)
            return out
        return call

    forward, backward = scan.forward, scan.backward
    scan.forward = staticmethod(timed("scan", forward))
    scan.backward = staticmethod(timed("scan_bwd", backward))
    runs = []
    try:
        torch.cuda.reset_peak_memory_stats()
        for rep in range(1 + JAMBA_LAYER_REPS):
            if rep == 1:
                kernels.reset_launches()
            for t in leaves + [x]:
                t.grad = None
            for v in spans.values():
                v.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            y = mamba.apply_mamba(params, x, cfg)
            ev[1].record()
            y.backward(dout)
            ev[2].record()
            torch.cuda.synchronize()
            del y
            if rep == 0:
                continue
            ms = {k: sum(a.elapsed_time(b) for a, b in v)
                  for k, v in spans.items()}
            runs.append({"forward_ms": ev[0].elapsed_time(ev[1]),
                         "backward_ms": ev[1].elapsed_time(ev[2]),
                         "scan_ms": ms["scan"], "scan_bwd_ms": ms["scan_bwd"]})
    finally:
        scan.forward = staticmethod(forward)
        scan.backward = staticmethod(backward)
    got = launch_counts()
    want = dict.fromkeys(got, 0)
    want.update(selective_scan=JAMBA_LAYER_REPS,
                selective_scan_bwd=JAMBA_LAYER_REPS)
    if got != want:
        raise AssertionError(f"17(d): launches {got} != {want}")
    for t in leaves + [x]:
        if t.grad is None or t.grad.shape != t.shape \
                or not torch.isfinite(t.grad).all():
            raise AssertionError(f"17(d): a gradient of shape {t.shape} is "
                                 "missing, misshapen or not finite")
    mean = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
    step = mean["forward_ms"] + mean["backward_ms"]
    out = {"config": cfg.name, "d_model": cfg.d_model,
           "d_inner": cfg.ssm.expand * cfg.d_model,
           "d_state": cfg.ssm.d_state, "batch": JAMBA_LAYER_BATCH,
           "seq": JAMBA_LAYER_SEQ, "dtype": "bfloat16", **mean,
           "step_ms": step,
           "scan_bwd_share_of_backward": mean["scan_bwd_ms"]
           / mean["backward_ms"],
           "scan_bwd_share_of_step": mean["scan_bwd_ms"] / step,
           "scan_share_of_forward": mean["scan_ms"] / mean["forward_ms"],
           "runs": runs,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "launches": got}
    log(f"phase 17(d): one jamba-1.5-large mamba layer forward and "
        f"backward: {json.dumps(out)}")
    return out


def serve_step_bits(dev):
    """17(e): make_serve_step on reduced Llama-3.2-3B gives each node's
    own decode_step bit for bit."""
    from repro_torch.dlrt import (init_node_caches, init_train_state,
                                  make_serve_step)
    from repro_torch.models import model
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_map
    cfg = reduced_train_config("llama3.2-3b")
    n, b, max_len = 3, 2, 8
    params = init_train_state(cfg, sgd(0.05), n, seed=6, device=dev).params
    cache = init_node_caches(cfg, n, b, max_len, device=dev)
    own = [model.init_cache(cfg, b, max_len, device=dev) for _ in range(n)]
    serve = make_serve_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(6)
    for pos in range(5):
        toks = torch.randint(0, cfg.vocab_size, (n, b, 1), generator=gen,
                             device=dev)
        logits, cache = serve(params, cache, toks, pos)
        for i in range(n):
            want, own[i] = model.decode_step(
                tree_map(lambda v: v[i], params), own[i], toks[i], pos, cfg)
            if not torch.equal(logits[i], want):
                raise AssertionError(f"17(e): node {i} at {pos}: serve_step "
                                     "differs from decode_step")
    log(f"phase 17(e): make_serve_step on reduced llama3.2-3b, n = {n}, "
        "5 positions: each node's decode_step bit for bit")


def launcher_argv(arch):
    """The launcher's arguments for ``arch`` at the launcher phases' size:
    reduced, 8 nodes, 20 rounds."""
    return ["--arch", arch, "--reduced", "--nodes", "8", "--rounds", "20"]


def launchers(runs):
    """``python -m repro_torch.launch.train <argv>`` on the card for each
    ``{label: argv}`` of ``runs``, the child processes (one torch thread
    each) started together and each awaited (at most 300 s; any still
    running is killed).  Returns {label: (returncode, stdout, stderr,
    wall s)}."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv,
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for label, argv in runs.items()}
    out = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(
                timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            out[label] = (proc.returncode, stdout, stderr,
                          time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def launcher_lines(phase, arch, result):
    """One :func:`launchers` result must exit 0 after its twenty rounds.
    Returns (wall seconds, its first and last lines)."""
    code, stdout, stderr, wall = result
    if code != 0 or "done: 20 rounds" not in stdout:
        raise AssertionError(f"{phase}: the launcher on {arch} exited "
                             f"{code}: {stderr[-2000:]}")
    lines = stdout.strip().splitlines()
    return wall, [lines[0], lines[-2], lines[-1]]




def train_path(dev):
    """Phase 17: (a) to (e) ((f) runs in :func:`launcher_path`); returns
    the backward kernel's worst errors and times (with 17(d)'s layer as
    ``jamba_layer``) and the launches of the training runs on the card."""
    t0 = time.perf_counter()
    worst = check_scan_backward(dev)
    times = time_scan_backward(dev)
    t1 = time.perf_counter()
    totals = train_full_width(dev)
    t2 = time.perf_counter()
    _add(totals, train_card_vs_cpu(dev))
    t3 = time.perf_counter()
    times["jamba_layer"] = jamba_layer_step(dev)
    t4 = time.perf_counter()
    serve_step_bits(dev)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f}, "
        f"(b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, "
        f"(e) {time.perf_counter() - t4:.1f})")
    return worst, times, totals


# ---------------------------------------------------------------------------
# Phase 18: the zoo's MoE MLP and RWKV-6 mixer.
# ---------------------------------------------------------------------------

ZOO_PREFILLS = 2                 # 18(a), (d): timed prefills of 2 x 2,048
ZOO_F32_LEN = 128                # 18(b): tokens a request (two RWKV chunks)
ZOO_F32_LAYERS = 2               # 18(b): layers of each model in f32
# 18(c): one MoE layer of Jamba-1.5-Large at its published widths, bf16,
# 2 x 2,048 tokens under autograd, each step timed ZOO_LAYER_REPS times
# after a warm-up (17(d)'s shape).
ZOO_LAYER_REPS = 3
ZOO_REDUCED = ("deepseek-moe-16b", "jamba-1.5-large-398b", "rwkv6-7b")
ZOO_CARD_TOL = 1e-4              # 18(e): phases 6 and 17(c)'s limit
ZOO_TRAIN_LAYERS = 2             # 18(f): 2 of deepseek-moe-16b's 28 layers


@contextlib.contextmanager
def moe_drops():
    """Counts, on the card, the (token, slot) pairs every MoE call routes
    and the pairs it drops, while the block runs (``moe._dispatch``
    wrapped, then put back); read ``pairs`` and ``dropped`` after it."""
    from repro_torch.models import moe
    dispatch = moe._dispatch
    tally = {"pairs": 0, "dropped": 0}

    def counted(xf, experts, C, E):
        out = dispatch(xf, experts, C, E)
        tally["pairs"] += out[2].numel()
        tally["dropped"] = tally["dropped"] + (~out[2]).sum()   # no sync
        return out

    moe._dispatch = counted
    try:
        yield tally
    finally:
        moe._dispatch = dispatch
        tally["dropped"] = int(tally["dropped"])


def drop_share(tally):
    return tally["dropped"] / tally["pairs"] if tally["pairs"] else None


def moe_stages(params, tokens, cfg):
    """18(a), 19(c): where a MoE prefill's time goes (host clock,
    synchronised); with a stub frontend, the embedding with the patch
    projector."""
    from repro_torch.models import attention, layers, moe, transformer
    frontend = [(transformer, "_embed_inputs", "embed_and_projector")] \
        if cfg.frontend is not None else []
    stages, total = staged_forward(params, tokens, cfg, [
        (attention, "self_attention", "attention"),
        (moe, "_route", "router"), (moe, "_dispatch", "dispatch"),
        (moe, "_expert_ffn", "expert_products"),
        (moe, "_combine", "combine"),
        # every MLP of this model is a MoE layer's shared experts
        (layers, "apply_mlp", "shared_experts"),
        (layers, "apply_norm", "norms"),
        (transformer, "_lm_logits", "lm_head")] + frontend)
    out = {"total": total, "attention": stages["attention"],
           "router_and_dispatch": stages["router"] + stages["dispatch"],
           **{k: stages[k] for k in ("expert_products", "combine",
                                     "shared_experts", "norms", "lm_head")
              + tuple(s for _, _, s in frontend)}}
    out["other"] = total - sum(stages.values())
    return out


def rwkv_stages(params, tokens, cfg):
    """18(d): where an RWKV-6 prefill's time goes (host clock,
    synchronised), the WKV chunks inside the time mix."""
    from repro_torch.models import layers, rwkv, transformer
    stages, total = staged_forward(params, tokens, cfg, [
        (rwkv, "apply_rwkv_time_mix", "time_mix"),
        (rwkv, "_chunk_wkv", "wkv_chunks"),
        (rwkv, "apply_channel_mix", "channel_mix"),
        (layers, "apply_norm", "norms"),
        (transformer, "_lm_logits", "lm_head")])
    out = {"total": total, "wkv_chunks": stages["wkv_chunks"],
           "time_mix_outside_chunks": stages["time_mix"]
           - stages["wkv_chunks"],
           "channel_mix": stages["channel_mix"], "norms": stages["norms"],
           "lm_head": stages["lm_head"]}
    out["other"] = total - sum(stages.values()) + stages["wkv_chunks"]
    out["wkv_chunks_share"] = stages["wkv_chunks"] / total
    return out


def serve_whole(dev, arch, phase, breakdown, cfg=None, frontend=None,
                prompt_len=PROMPT_LEN):
    """18(a) and (d), 19(a) to (c): ``arch`` whole at its published widths
    in bf16 (or ``cfg``, cut in depth), drawn on the card: prefill of two
    ``prompt_len``-token prompts (with ``frontend(gen)``'s stub-frontend
    inputs for both, drawn on the card, if given) through
    ``forward(last_only=True)`` (ZOO_PREFILLS timed after a warm-up), four
    requests served as 9(b) serves them (64-token prompts token by token
    through ``decode_step``, then 32 greedy tokens) and ``greedy_generate``
    the same tokens, no kernel launched; the share of MoE pairs dropped at
    prefill and at decode; the prefill's stages (``breakdown``); peak
    memory beside the parameters' bytes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import model, moe
    cfg = cfg or get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced(model.init_params, cfg, 0, device=dev)
    count, nbytes = model.param_count(params), model.param_bytes(params)
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.param_dtype,
           "params": count, "param_bytes": nbytes,
           "param_count_analytic": cfg.param_count(), "init_ms": init_ms,
           "init_peak_bytes": torch.cuda.max_memory_allocated()}
    gen = torch.Generator(device=dev).manual_seed(18)
    none = dict.fromkeys(launch_counts(), 0)

    # Prefill.
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            generator=gen, device=dev)
    batch = {"tokens": prompts, **(frontend(gen) if frontend else {})}
    model.forward(params, batch, cfg, last_only=True)  # warm
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prefill_ms = []
    for _ in range(ZOO_PREFILLS):
        (logits, _), ms = synced(model.forward, params, batch, cfg,
                                 last_only=True)
        prefill_ms.append(ms)
    if launch_counts() != none:
        raise AssertionError(f"{phase} prefill launches {launch_counts()}")
    if logits.shape != (2, 1, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"{phase} prefill logits {logits.shape}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    rec["prefill"] = {"ms_each": prefill_ms,
                      "ms_per_prefill": sum(prefill_ms) / ZOO_PREFILLS,
                      "tokens_per_s": 2 * prompt_len * ZOO_PREFILLS
                      / sum(prefill_ms) * 1e3,
                      "inputs": {k: list(v.shape) for k, v in batch.items()},
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
    with moe_drops() as prefill_drops:
        model.forward(params, batch, cfg, last_only=True)

    # Decode.
    requests = torch.randint(0, cfg.vocab_size, (REQUESTS, REQUEST_LEN),
                             generator=gen, device=dev)
    cache = model.init_cache(cfg, REQUESTS, REQUEST_LEN + NEW_TOKENS,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms, out = [], []
    with moe_drops() as decode_drops:
        for t in range(REQUEST_LEN + NEW_TOKENS):
            tok = requests[:, t:t + 1] if t < REQUEST_LEN \
                else logits.argmax(-1)
            if t >= REQUEST_LEN:
                out.append(tok[:, 0])
            (logits, cache), ms = synced(model.decode_step, params, cache,
                                         tok, t, cfg)
            step_ms.append(ms)
    if launch_counts() != none:
        raise AssertionError(f"{phase} decode launches {launch_counts()}")
    tokens = torch.stack(out, dim=1)
    if not torch.isfinite(logits).all() or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{phase} decode: logits finite "
                             f"{bool(torch.isfinite(logits).all())}, "
                             f"tokens {tokens.tolist()}")
    del cache
    generated = model.greedy_generate(params, cfg, requests, NEW_TOKENS)
    if not torch.equal(generated, tokens):
        raise AssertionError(f"{phase}: greedy_generate's tokens differ "
                             "from the decode loop's")
    rec["decode"] = {"ms_per_step": sum(step_ms[1:]) / (len(step_ms) - 1),
                     "first_step_ms": step_ms[0], "steps": len(step_ms),
                     "requests": REQUESTS,
                     "cache_len": REQUEST_LEN + NEW_TOKENS,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "first_tokens": tokens[:, :6].tolist()}
    if cfg.moe is not None:
        rec["dropped_share"] = {
            "prefill": drop_share(prefill_drops),
            "prefill_capacity": moe.capacity(cfg, prompts.shape[0] * (
                prompt_len + (batch["patch_embeds"].shape[1]
                              if "patch_embeds" in batch else 0))),
            "decode": drop_share(decode_drops),
            "decode_capacity": moe.capacity(cfg, REQUESTS)}
    rec["stages"] = breakdown(params, batch, cfg)
    rec["peak_over_params_bytes"] = max(
        rec["prefill"]["peak_device_bytes"],
        rec["decode"]["peak_device_bytes"]) - nbytes
    del params
    torch.cuda.empty_cache()
    return rec


def zoo_prefill_vs_decode(dev, archs=("deepseek-moe-16b", "rwkv6-7b"),
                          phase="18(b)"):
    """18(b) (DeepSeek-MoE and RWKV-6) and 19(d) (Pixtral and
    Llama-4-Scout, text only): ``archs`` at published widths,
    ZOO_F32_LAYERS layers, f32 (MoE at a capacity factor of 100, so that
    no pair is dropped, as tests/test_arch_smoke.py runs it): the last
    logits of a prefill over four requests of ZOO_F32_LEN tokens against
    decode's after the same tokens, within 9(c)'s f32 limits."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=ZOO_F32_LAYERS,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=100.0))
        params = model.init_params(cfg, 1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(19)
        requests = torch.randint(0, cfg.vocab_size, (REQUESTS, ZOO_F32_LEN),
                                 generator=gen, device=dev)
        fwd, _ = model.forward(params, {"tokens": requests}, cfg,
                               last_only=True)
        cache = model.init_cache(cfg, REQUESTS, ZOO_F32_LEN, device=dev)
        with moe_drops() as drops:
            for t in range(ZOO_F32_LEN):
                dec, cache = model.decode_step(params, cache,
                                               requests[:, t:t + 1], t, cfg)
        out[arch] = dict(prefill_vs_decode(fwd, dec),
                         dropped=drops["dropped"])
        log(f"phase {phase}: {arch} {ZOO_F32_LAYERS} layers f32, last "
            f"logits over {REQUESTS} x {ZOO_F32_LEN} tokens, prefill vs "
            f"decode: {json.dumps(out[arch])}")
        del params, cache
        torch.cuda.empty_cache()
        if drops["dropped"]:
            raise AssertionError(f"{phase} {arch}: pairs dropped")
        torch.testing.assert_close(dec, fwd, **PREFILL_DECODE_F32)
    return out


def jamba_moe_layer(dev):
    """18(c): one Jamba-1.5-Large MoE layer (``moe.apply_moe``: 16 experts,
    top-2, d_model 8,192, d_ff 24,576) at its published widths in bf16
    under autograd: its forward and its backward, each between CUDA events,
    and inside them the expert products' forward between events of their
    own; then the expert products' backward alone (``_expert_ffn`` on the
    same buffer, its backward between events).  Every gradient finite and
    of its leaf's shape; no kernel launched."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import flatten
    cfg = get_config("jamba-1.5-large-398b")
    gen = torch.Generator(device=dev).manual_seed(21)
    torch.cuda.reset_peak_memory_stats()
    params = moe.moe_params(gen, cfg, torch.bfloat16)
    leaves = list(flatten(params).values())
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    shape = (JAMBA_LAYER_BATCH, JAMBA_LAYER_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    for t in leaves + [x]:
        t.requires_grad_()
    spans, kept = [], {}
    ffn = moe._expert_ffn

    def timed(p, xs, mlp_type):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = ffn(p, xs, mlp_type)
        ev[1].record()
        spans.append(ev)
        kept["xs"] = xs.detach()
        return out

    moe._expert_ffn = timed
    runs = []
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for rep in range(1 + ZOO_LAYER_REPS):
            if rep == 1:
                kernels.reset_launches()
            for t in leaves + [x]:
                t.grad = None
            spans.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            y, aux = moe.apply_moe(params, x, cfg)
            ev[1].record()
            torch.autograd.backward([y, aux], [dout, torch.ones_like(aux)])
            ev[2].record()
            torch.cuda.synchronize()
            del y, aux
            if rep:
                runs.append({"forward_ms": ev[0].elapsed_time(ev[1]),
                             "backward_ms": ev[1].elapsed_time(ev[2]),
                             "expert_products_ms": sum(
                                 a.elapsed_time(b) for a, b in spans)})
    finally:
        moe._expert_ffn = ffn
    peak = torch.cuda.max_memory_allocated()
    if launch_counts() != dict.fromkeys(launch_counts(), 0):
        raise AssertionError(f"18(c): launches {launch_counts()}")
    for t in leaves + [x]:
        if t.grad is None or t.grad.shape != t.shape \
                or not torch.isfinite(t.grad).all():
            raise AssertionError(f"18(c): a gradient of shape {t.shape} is "
                                 "missing, misshapen or not finite")
        t.grad = None
    # The expert products' backward alone, on the buffer of the last run.
    xs = kept["xs"].requires_grad_()
    weights = [params[k] for k in ("gate", "up", "down")]
    bwd = []
    for rep in range(1 + ZOO_LAYER_REPS):
        h = ffn(params, xs, cfg.mlp_type)
        g = torch.randn(h.shape, generator=gen, device=dev).to(h.dtype)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.autograd.grad(h, [xs] + weights, g)
        ev[1].record()
        torch.cuda.synchronize()
        if rep:
            bwd.append(ev[0].elapsed_time(ev[1]))
        del h, g
    mean = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
    mean["expert_products_backward_ms"] = sum(bwd) / len(bwd)
    step = mean["forward_ms"] + mean["backward_ms"]
    C = moe.capacity(cfg, JAMBA_LAYER_BATCH * JAMBA_LAYER_SEQ)
    # Three [E, C, d] x [d, d_ff] products forward; the backward twice.
    flops = 3 * 3 * 2 * cfg.moe.num_experts * C * cfg.d_model * cfg.d_ff
    expert_ms = mean["expert_products_ms"] \
        + mean["expert_products_backward_ms"]
    out = {"config": cfg.name, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "capacity": C, "batch": JAMBA_LAYER_BATCH,
           "seq": JAMBA_LAYER_SEQ, "dtype": "bfloat16", "params": sum(
               t.numel() for t in leaves), "param_bytes": nbytes, **mean,
           "step_ms": step,
           "expert_products_share_of_forward":
               mean["expert_products_ms"] / mean["forward_ms"],
           "expert_products_backward_share_of_backward":
               mean["expert_products_backward_ms"] / mean["backward_ms"],
           "expert_products_tflops": flops / expert_ms / 1e9,
           "runs": runs, "peak_device_bytes": peak,
           "peak_over_params_and_grads_bytes": peak - base - nbytes}
    log(f"phase 18(c): one jamba-1.5-large MoE layer forward and backward: "
        f"{json.dumps(out)}")
    del params, leaves, weights, x, xs, kept
    torch.cuda.empty_cache()
    return out


def topk_flips(cpu_params, card_params, tokens, cfg, extra=None):
    """Where the card's router picks other experts than the CPU's: each MoE
    call's picks recorded in both forwards (over ``tokens`` and the CPU
    tensors of ``extra``); the first call, token and slot that differ,
    with the two probabilities at stake."""
    from repro_torch.models import model, moe
    route = moe._route

    def picks(params, dev):
        calls = []

        def recorded(p, xf, c):
            out = route(p, xf, c)
            calls.append((out[0].float().cpu(), out[2].cpu()))
            return out

        moe._route = recorded
        try:
            model.forward(params, {k: v.to(dev) for k, v in dict(
                extra or {}, tokens=tokens).items()}, cfg)
        finally:
            moe._route = route
        return calls

    card = picks(card_params, card_params["embed"]["table"].device)
    for layer, ((pc, ec), (pg, eg)) in enumerate(
            zip(picks(cpu_params, "cpu"), card)):
        diff = (ec != eg).nonzero()
        if len(diff):
            tok, slot = (int(v) for v in diff[0])
            a, b = int(ec[tok, slot]), int(eg[tok, slot])
            return {"moe_call": layer, "token": tok, "slot": slot,
                    "cpu_expert": a, "card_expert": b,
                    "cpu_probs": [float(pc[tok, a]), float(pc[tok, b])],
                    "card_probs": [float(pg[tok, a]), float(pg[tok, b])]}
    return None


ZOO_CARD_KERNELS = ("gram_matrix", "graph_mix_masked", "selective_scan",
                    "selective_scan_bwd")


def zoo_card_vs_cpu(dev, archs=ZOO_REDUCED, phase="18(e)", frontend=False,
                    need=ZOO_CARD_KERNELS):
    """18(e): reduced DeepSeek-MoE, Jamba with its experts and RWKV-6 (f32)
    (19(e): reduced Whisper, Pixtral and Llama-4-Scout with ``frontend``
    inputs in every forward and train batch) on the card and on the CPU:
    from one set of parameters the logits within 1e-4 and 8 greedy tokens
    identical (as phase 6); then three train rounds (a topology round
    first) from one state: identical edges, parameters within 1e-4 (as
    17(c)).  A router's pick that differs between the two is named.  The
    card runs launch each kernel of ``need``.  Returns their launches."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.dlrt import (MorphHParams, init_train_state,
                                  make_train_step, train_state_to)
    from repro_torch.launch.shapes import frontend_inputs
    from repro_torch.models import model
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten, tree_map
    totals = dict.fromkeys(launch_counts(), 0)
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        cpu_p = model.init_params(cfg, 0, device="cpu")
        card_p = tree_map(lambda t: t.to(dev), cpu_p)
        host = torch.Generator().manual_seed(8)
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=host)
        extra = frontend_inputs(cfg, (2,), host) if frontend else {}
        kernels.reset_launches()
        got, aux = model.forward(card_p, {k: v.to(dev) for k, v in dict(
            extra, tokens=tokens).items()}, cfg)
        toks_card = model.greedy_generate(card_p, cfg,
                                          tokens[:, :8].to(dev), 8)
        torch.cuda.synchronize()
        _add(totals, launch_counts())
        want, want_aux = model.forward(cpu_p, dict(extra, tokens=tokens),
                                       cfg)
        toks_cpu = model.greedy_generate(cpu_p, cfg, tokens[:, :8], 8)
        err = max(float((got.cpu() - want).abs().max()),
                  float((aux.cpu() - want_aux).abs().max()))
        if not err <= ZOO_CARD_TOL or not torch.equal(toks_card.cpu(),
                                                      toks_cpu):
            flip = topk_flips(cpu_p, card_p, tokens, cfg, extra) \
                if cfg.moe is not None else None
            raise AssertionError(f"{phase} {arch}: card vs CPU logits {err}, "
                                 f"greedy tokens card {toks_card.tolist()} "
                                 f"CPU {toks_cpu.tolist()}; router pick "
                                 f"that differs: {flip}")
        n = 4
        cpu = init_train_state(cfg, sgd(0.05), n, seed=5, device="cpu")
        card = train_state_to(cpu, dev)
        steps = {topo: make_train_step(cfg, sgd(0.05),
                                       MorphHParams(k=2, view_size=3),
                                       do_topology=topo)
                 for topo in (True, False)}
        rng = np.random.default_rng(5)
        gaps = []
        for rnd in range(3):
            toks = rng.integers(0, cfg.vocab_size, (n, 2, 33)).astype(
                np.int32)
            batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
            if frontend:
                batch.update(frontend_inputs(cfg, (n, 2), host))
            cpu, _ = steps[rnd == 0](cpu, batch)
            kernels.reset_launches()
            card, _ = steps[rnd == 0](card, batch)
            torch.cuda.synchronize()
            _add(totals, launch_counts())
            if not torch.equal(card.morph.edges.cpu(), cpu.morph.edges):
                raise AssertionError(f"{phase} {arch} round {rnd}: edges "
                                     "differ")
            want_p = flatten(cpu.params)
            gap = max(float((v.cpu() - want_p[k]).abs().max())
                      for k, v in flatten(card.params).items())
            if not gap <= ZOO_CARD_TOL:
                raise AssertionError(f"{phase} {arch} round {rnd}: params "
                                     f"{gap} > {ZOO_CARD_TOL}")
            gaps.append(gap)
        out[arch] = {"logits_err": err, "param_gaps": gaps}
    if not all(totals[name] for name in need):
        raise AssertionError(f"{phase}: card launches {totals}")
    log(f"phase {phase}: reduced {', '.join(archs)} (f32) card == CPU: "
        f"logits within {ZOO_CARD_TOL}, 8 greedy tokens identical, 3 train "
        f"rounds with identical edges: {json.dumps(out)}; card launches "
        f"{json.dumps(totals)}")
    return totals


def zoo_train(dev):
    """18(f): decentralized LM training of DeepSeek-MoE-16B at its
    published widths with ZOO_TRAIN_LAYERS of its 28 layers, bf16, as
    17(b) trains Llama (:func:`train_rounds`).  Returns the launches."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=ZOO_TRAIN_LAYERS)
    got, rec, state = train_rounds(dev, cfg, "18(f)")
    log(f"phase 18(f): deepseek-moe-16b full width, {ZOO_TRAIN_LAYERS} "
        f"layers, n = {TRAIN_N}, {TRAIN_ROUNDS} rounds: {json.dumps(rec)}")
    del state
    torch.cuda.empty_cache()
    return got


def zoo_path(dev):
    """Phase 18: (a) to (f) ((g) runs in :func:`launcher_path`); returns
    the launches of (e) and (f)."""
    t0 = time.perf_counter()
    rec = serve_whole(dev, "deepseek-moe-16b", "18(a)", moe_stages)
    log(f"phase 18(a): deepseek-moe-16b served whole: {json.dumps(rec)}")
    t1 = time.perf_counter()
    zoo_prefill_vs_decode(dev)
    t2 = time.perf_counter()
    jamba_moe_layer(dev)
    t3 = time.perf_counter()
    rec = serve_whole(dev, "rwkv6-7b", "18(d)", rwkv_stages)
    log(f"phase 18(d): rwkv6-7b served whole: {json.dumps(rec)}")
    t4 = time.perf_counter()
    totals = zoo_card_vs_cpu(dev)
    t5 = time.perf_counter()
    _add(totals, zoo_train(dev))
    log(f"phase 18: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f}, "
        f"(b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, "
        f"(e) {t5 - t4:.1f}, (f) {time.perf_counter() - t5:.1f})")
    return totals


# ---------------------------------------------------------------------------
# Phase 19: the zoo's encoder and stub frontends.
# ---------------------------------------------------------------------------

WHISPER, PIXTRAL, SCOUT = ("whisper-tiny", "pixtral-12b",
                           "llama4-scout-17b-a16e")
FRONT_TEXT_LEN = 1792            # 19(b), (c): text after 256 patches
SCOUT_SERVED_LAYERS = 8          # 19(c): 8 of llama4-scout's 48 layers
FRONT_TRAIN_LAYERS = 2           # 19(f): 2 of pixtral-12b's 40 layers
FRONT_TRAIN_N = 8                # 19(f): pixtral's population


def whisper_stages(params, batch, cfg):
    """19(a): where a Whisper prefill's time goes (host clock,
    synchronised): the encoder alone, then the decoder's forward given the
    encoder's memory, by stage."""
    from repro_torch.models import attention, layers, transformer
    frames = batch["frames"].to(getattr(torch, cfg.compute_dtype))
    memory, enc_ms = synced(transformer._encode, params, frames, cfg)
    encode = transformer._encode
    transformer._encode = lambda p, f, c: memory
    try:
        stages, total = staged_forward(params, batch, cfg, [
            (attention, "self_attention", "decoder_self_attention"),
            (attention, "cross_attention", "cross_attention"),
            (layers, "apply_mlp", "decoder_mlps"),
            (layers, "apply_norm", "decoder_norms"),
            (transformer, "_lm_logits", "lm_head")])
    finally:
        transformer._encode = encode
    out = {"total": enc_ms + total, "encoder": enc_ms, **stages}
    out["other"] = total - sum(stages.values())
    return out


def pixtral_stages(params, batch, cfg):
    """19(b): where a Pixtral prefill's time goes (host clock,
    synchronised), the patch projector inside the embedding."""
    from repro_torch.models import attention, layers, transformer
    stages, total = staged_forward(params, batch, cfg, [
        (transformer, "_embed_inputs", "embed_and_projector"),
        (attention, "self_attention", "attention"),
        (layers, "apply_mlp", "mlps"), (layers, "apply_norm", "norms"),
        (transformer, "_lm_logits", "lm_head")])
    out = {"total": total, **stages}
    out["other"] = total - sum(stages.values())
    return out


def frontend_serving(dev):
    """19(a) to (c): Whisper-tiny whole (two requests of 448 tokens over
    1,500 frames), Pixtral-12B whole and Llama-4-Scout at published widths
    with SCOUT_SERVED_LAYERS layers (two prompts of 256 patch embeddings
    and FRONT_TEXT_LEN tokens), each served as :func:`serve_whole` serves
    (its frontend inputs shaped by ``input_specs``, drawn on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import frontend_inputs
    whisper = get_config(WHISPER)
    scout = dataclasses.replace(get_config(SCOUT),
                                num_layers=SCOUT_SERVED_LAYERS)
    runs = [("19(a)", WHISPER, whisper, whisper_stages,
             whisper.max_position),
            ("19(b)", PIXTRAL, get_config(PIXTRAL), pixtral_stages,
             FRONT_TEXT_LEN),
            ("19(c)", SCOUT, scout, moe_stages, FRONT_TEXT_LEN)]
    times = {}
    for phase, arch, cfg, stages, text in runs:
        t0 = time.perf_counter()
        rec = serve_whole(dev, arch, phase, stages, cfg=cfg,
                          frontend=lambda gen, c=cfg: frontend_inputs(
                              c, (2,), gen), prompt_len=text)
        whole = get_config(arch).num_layers
        rec["cut"] = "whole" if cfg.num_layers == whole \
            else f"{cfg.num_layers} of {whole} layers"
        log(f"phase {phase}: {arch} served: {json.dumps(rec)}")
        times[phase] = time.perf_counter() - t0
    return times


def frontend_train(dev):
    """19(f): decentralized LM training as 17(b) (:func:`train_rounds`):
    Whisper-tiny whole at its n_nodes = 16, batches of 8 x 448 tokens
    with ``frames`` of ``input_specs``' shape; Pixtral-12B at published
    widths with FRONT_TRAIN_LAYERS of its 40 layers at n = FRONT_TRAIN_N
    with its 256 patch embeddings.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import frontend_inputs
    whisper = get_config(WHISPER)
    pixtral = dataclasses.replace(get_config(PIXTRAL),
                                  num_layers=FRONT_TRAIN_LAYERS)
    totals = dict.fromkeys(launch_counts(), 0)
    for cfg, n, seq in ((whisper, whisper.n_nodes, whisper.max_position),
                        (pixtral, FRONT_TRAIN_N, TRAIN_SEQ)):
        got, rec, state = train_rounds(
            dev, cfg, "19(f)", n=n, batch_size=TRAIN_BATCH, seq=seq,
            frontend=lambda gen, c=cfg, n=n: frontend_inputs(
                c, (n, TRAIN_BATCH), gen))
        _add(totals, got)
        log(f"phase 19(f): {cfg.name}, {cfg.num_layers} layers, n = {n}, "
            f"{TRAIN_ROUNDS} rounds with its stub-frontend inputs: "
            f"{json.dumps(rec)}")
        del state
        torch.cuda.empty_cache()
    return totals


LAUNCHED = {"17(f)": ("llama3.2-3b",),
            "18(g)": ("deepseek-moe-16b", "rwkv6-7b",
                      "jamba-1.5-large-398b"),
            "19(g)": (PIXTRAL, SCOUT)}


def launcher_path(dev):
    """17(f), 18(g), 19(g) and 20(b): the launcher on the card for the
    architectures of LAUNCHED, for Whisper and with a checkpoint
    directory, the child processes started together: each of LAUNCHED
    exits 0 after twenty rounds (Jamba with its experts; Pixtral and
    Llama-4-Scout text only); Whisper is refused with a ``ValueError`` that
    names the missing ``frames``; 20(b) as :func:`launcher_checkpoint`."""
    import tempfile
    t0 = time.perf_counter()
    runs = {arch: launcher_argv(arch)
            for arch in sum(LAUNCHED.values(), ()) + (WHISPER,)}
    with tempfile.TemporaryDirectory() as tmp:
        runs["20(b)"] = ["--arch", CKPT_LAUNCH_ARCH, "--reduced", "--nodes",
                         str(CKPT_LAUNCH_N), "--rounds",
                         str(CKPT_LAUNCH_ROUNDS), "--checkpoint-dir", tmp]
        got = launchers(runs)
        launcher_checkpoint(got.pop("20(b)"), tmp)
    code, _, stderr, _ = got.pop(WHISPER)
    last = stderr.strip().splitlines()[-1] if stderr.strip() else ""
    if code == 0 or not last.startswith("ValueError") \
            or "'frames'" not in last:
        raise AssertionError(f"19(g): the launcher on {WHISPER} exited "
                             f"{code}, last error line {last!r}")
    for phase, archs in LAUNCHED.items():
        lines = {arch: launcher_lines(phase, arch, got[arch])
                 for arch in archs}
        log(f"phase {phase}: launcher exit 0 for {', '.join(archs)}: "
            f"{json.dumps(lines)}")
    log(f"phase 19(g): {WHISPER} refused: {last}")
    log(f"phase 17(f), 18(g), 19(g), 20(b): {time.perf_counter() - t0:.1f} "
        f"s, {len(runs)} launchers at once")


def frontends_path(dev):
    """Phase 19: (a) to (f) ((g) runs in :func:`launcher_path`); returns
    the launches of (e) and (f)."""
    t0 = time.perf_counter()
    times = frontend_serving(dev)
    t1 = time.perf_counter()
    zoo_prefill_vs_decode(dev, (PIXTRAL, SCOUT), "19(d)")
    t2 = time.perf_counter()
    totals = zoo_card_vs_cpu(dev, (WHISPER, PIXTRAL, SCOUT), "19(e)",
                             frontend=True,
                             need=("gram_matrix", "graph_mix_masked"))
    t3 = time.perf_counter()
    _add(totals, frontend_train(dev))
    log(f"phase 19: {time.perf_counter() - t0:.1f} s ((a) "
        f"{times['19(a)']:.1f}, (b) {times['19(b)']:.1f}, (c) "
        f"{times['19(c)']:.1f}, (d) {t2 - t1:.1f}, (e) {t3 - t2:.1f}, "
        f"(f) {time.perf_counter() - t3:.1f})")
    return totals


# ---------------------------------------------------------------------------
# Phase 20: checkpoints, the launcher's checkpoint directory, the dry run.
# ---------------------------------------------------------------------------

# 20(a): Whisper-tiny whole (37.36 M parameters a node, bf16) at n = 2,
# batch 2 of 448 tokens and their frames a node, two rounds (a topology
# round first), then one more round from the restored parameters and one
# from the live ones.  The save's zlib (the reference's fallback, about
# 13 MB/s on bf16 weights on the card's host) grows with the population,
# so two nodes keep the phase short.
CKPT_N, CKPT_BATCH, CKPT_ROUNDS = 2, 2, 2
# 20(b): the launcher with --checkpoint-dir.
CKPT_LAUNCH_ARCH, CKPT_LAUNCH_N, CKPT_LAUNCH_ROUNDS = "llama3.2-3b", 4, 3


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaNs included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def checkpoint_roundtrip(dev):
    """20(a): Whisper-tiny whole trained CKPT_ROUNDS rounds at n = CKPT_N
    (:func:`train_rounds`), ``{"params": state.params}`` saved by
    ``CheckpointManager`` and restored onto the card: every leaf the same
    dtype, shape and bits; then one plain round (``do_topology=False``) on
    one batch from the restored parameters and from the live ones, each on
    its own copy of the optimizer and Morph state: the losses bit for bit,
    the parameters bit for bit or within 1e-6 (the record says which).
    Returns the launches of the four rounds."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager, compressor
    from repro_torch.configs import get_config
    from repro_torch.dlrt import MorphHParams, make_train_step, train_state_to
    from repro_torch.launch.shapes import frontend_inputs
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    cfg = get_config(WHISPER)
    got, rec, state = train_rounds(
        dev, cfg, "20(a)", n=CKPT_N, batch_size=CKPT_BATCH,
        seq=cfg.max_position, rounds=CKPT_ROUNDS,
        frontend=lambda gen: frontend_inputs(cfg, (CKPT_N, CKPT_BATCH), gen))
    live = flatten(state.params)
    population = sum(v.numel() * v.element_size() for v in live.values())
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(CKPT_ROUNDS, {"params": state.params})
        save_s = time.perf_counter() - t0
        file_bytes = Path(path).stat().st_size
        t0 = time.perf_counter()
        step, tree = mgr.restore(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    back = flatten(tree["params"])
    if step != CKPT_ROUNDS or list(back) != list(live):
        raise AssertionError(f"20(a): restored step {step}, leaves "
                             f"{list(back)[:4]}... != {list(live)[:4]}...")
    bad = [k for k, v in live.items() if not same_bits(back[k], v)
           or back[k].device != v.device]
    if bad:
        raise AssertionError(f"20(a): restored leaves differ: {bad[:8]}")
    # One more round from each: the same batch, each its own state copy.
    batchers = train_batchers(CKPT_N, seed0=2000, batch=CKPT_BATCH,
                              seq=cfg.max_position)
    batch = next_batch(batchers)
    batch.update(frontend_inputs(cfg, (CKPT_N, CKPT_BATCH),
                                 torch.Generator(device=dev).manual_seed(20)))
    opt = sgd(0.05)
    hp = MorphHParams(k=min(3, CKPT_N - 1), view_size=min(3, CKPT_N - 1),
                      beta=500.0)
    step_fn = make_train_step(cfg, opt, hp, do_topology=False)
    resumed = train_state_to(state, dev)._replace(params=tree["params"])
    del tree, back
    kernels.reset_launches()
    with deterministic_cudnn():
        resumed, m_resumed = step_fn(resumed, batch)
        state, m_live = step_fn(state, batch)
    torch.cuda.synchronize()
    more = launch_counts()
    got = {k: got[k] + more[k] for k in got}
    if not same_bits(m_resumed["per_node_loss"], m_live["per_node_loss"]):
        raise AssertionError(f"20(a): resumed losses "
                             f"{m_resumed['per_node_loss'].tolist()} != "
                             f"{m_live['per_node_loss'].tolist()}")
    a, b = flatten(resumed.params), flatten(state.params)
    bitwise = all(same_bits(a[k], b[k]) for k in b)
    gap = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    if not bitwise and gap > 1e-6:
        raise AssertionError(f"20(a): resumed parameters {gap} from the "
                             "live ones (limit 1e-6)")
    out = {"arch": WHISPER, "nodes": CKPT_N, "batch": [CKPT_BATCH,
                                                        cfg.max_position],
           "rounds": CKPT_ROUNDS, "losses": rec["losses"],
           "round_ms": rec["round_ms"], "leaves": len(live),
           "population_bytes": population, "file_bytes": file_bytes,
           "compressor": compressor(), "save_s": save_s,
           "restore_s": restore_s, "save_mb_per_s": population / 1e6 / save_s,
           "restore_mb_per_s": population / 1e6 / restore_s,
           "restored_bits_equal": True,
           "resumed_loss": m_resumed["loss"].item(),
           "resumed_losses_bitwise": True,
           "resumed_params_bitwise": bitwise,
           "resumed_params_max_abs_diff": gap, "launches": got}
    log(f"phase 20(a): {json.dumps(out)}")
    del state, resumed
    torch.cuda.empty_cache()
    return got


def launcher_checkpoint(result, directory):
    """20(b): the launcher with ``--checkpoint-dir`` exits 0 after its
    rounds and leaves exactly ``ckpt_{rounds:08d}.msgpack.zst``, whose
    ``params`` have a fresh population's structure, shapes and dtypes
    (``abstract_stacked_params``, on the meta device)."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import get_config
    from repro_torch.dlrt import abstract_stacked_params
    from repro_torch.tree import flatten
    code, stdout, stderr, wall = result
    if code != 0 or f"done: {CKPT_LAUNCH_ROUNDS} rounds" not in stdout:
        raise AssertionError(f"20(b): the launcher exited {code}: "
                             f"{stderr[-2000:]}")
    name = f"ckpt_{CKPT_LAUNCH_ROUNDS:08d}.msgpack.zst"
    files = sorted(p.name for p in Path(directory).iterdir())
    if files != [name]:
        raise AssertionError(f"20(b): the checkpoint directory holds "
                             f"{files}, not [{name!r}]")
    path = Path(directory) / name
    tree = load_pytree(str(path), device="cuda")
    got = flatten(tree["params"])
    want = flatten(abstract_stacked_params(
        get_config(CKPT_LAUNCH_ARCH).reduced(), CKPT_LAUNCH_N))
    shapes = lambda flat: [(k, tuple(v.shape), v.dtype)
                           for k, v in flat.items()]
    if list(tree) != ["params"] or shapes(got) != shapes(want):
        raise AssertionError("20(b): the checkpoint's tree is not a fresh "
                             "population's")
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    if not finite:
        raise AssertionError("20(b): the checkpoint holds non-finite "
                             "parameters")
    log(f"phase 20(b): launcher --checkpoint-dir exit 0 in {wall:.1f} s: "
        f"{name}, {path.stat().st_size} bytes, {len(got)} leaves as a "
        f"fresh population's; last line {stdout.strip().splitlines()[-1]!r}")


def dryrun_on_meta(dev):
    """20(c): ``repro_torch.launch.dryrun`` over every ``ASSIGNED``
    architecture, every shape and both production meshes, on meta
    tensors: the card's allocated memory does not change; each record's
    per-card argument bytes beside the card's memory."""
    from repro_torch.configs import ASSIGNED
    from repro_torch.launch import SHAPES, dryrun
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    records = dryrun.run(ASSIGNED, list(SHAPES), [False, True])
    wall = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"20(c): the dry run moved the card's "
                             f"allocated memory {before} -> {after}")
    hbm = torch.cuda.get_device_properties(0).total_memory
    rows = {}
    for r in records:
        key = (f"{r['arch']}/{r['shape']}/"
               f"{'multi' if r['multi_pod'] else 'single'}")
        rows[key] = ("skipped" if "skipped" in r else
                     round(r["memory"]["argument_bytes"] / 1e9, 6))
    done = [v for v in rows.values() if v != "skipped"]
    log(f"phase 20(c): dry run, {len(records)} records ({len(done)} run, "
        f"{len(records) - len(done)} skipped) in {wall:.1f} s, allocated "
        f"{before} -> {after} bytes; per-card argument GB beside the card's "
        f"{hbm / 1e9:.3f} GB (largest {max(done):.3f}, "
        f"{max(done) / (hbm / 1e9):.1%}): {json.dumps(rows)}")


def checkpoint_path(dev):
    """Phase 20: (a) and (c) ((b) runs in :func:`launcher_path`); returns
    the launches of (a)."""
    t0 = time.perf_counter()
    got = checkpoint_roundtrip(dev)
    t1 = time.perf_counter()
    dryrun_on_meta(dev)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f}, "
        f"(c) {time.perf_counter() - t1:.1f})")
    return got


# ---------------------------------------------------------------------------
# Phase 21: the zoo's train step on a device mesh, one NCCL rank.
# ---------------------------------------------------------------------------

# Three rounds, topology on rounds 0 and 2, sgd 0.05, Morph k = 3, view 5,
# beta 500; uniform tokens over MESH_IDS ids (the config's vocabulary where
# smaller).  (label, arch, layers kept (None: the reduced config, Jamba
# without experts), nodes, batch, tokens, mesh axes, each of size 1.)
MESH_ROUNDS, MESH_DELTA_R, MESH_IDS = 3, 2, TRAIN_IDS
MESH_CASES = (
    ("21(a)", "llama3.2-3b", 2, 4, 2, 512, ("data", "model")),
    ("21(b)", "qwen1.5-110b", 1, 2, 1, 512, ("pod", "data", "model")),
    ("21(c)", "jamba-1.5-large-398b", None, 4, 2, 64,
     ("pod", "data", "model")))


def mesh_case(dev, label, arch, layers, n, batch_size, seq, axes):
    """One case of phase 21: the mesh step (``make_train_step(...,
    mesh=...)`` on a ``distribute_train_state`` state over a one-rank
    ``DeviceMesh`` of ``axes``, all of size 1) and the one-device step,
    each from its own copy of one state, on the same batches and draws:
    per-node losses, edges and the last parameters bit for bit, and every
    kernel launched as often.  Returns (the mesh runs' launches, record)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.dlrt import (MorphHParams, distribute_train_state,
                                  gather_train_state, init_train_state,
                                  make_train_step, train_state_to)
    from repro_torch.launch import MeshLayout
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    cfg = (reduced_train_config(arch) if layers is None else
           dataclasses.replace(get_config(arch), num_layers=layers))
    layout = MeshLayout(axes, (1,) * len(axes))
    device_mesh = layout.device_mesh(dev.type)
    opt = sgd(0.05)
    hp = MorphHParams(k=min(3, n - 1), view_size=min(5, n - 1), beta=500.0)
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, n, seed=21, device=dev)
    one = train_state_to(state, dev)
    mesh_state = distribute_train_state(state, layout, device_mesh, cfg)
    del state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    population = sum(v.numel() * v.element_size()
                     for v in flatten(one.params).values())
    rng = np.random.default_rng(21)
    ids = min(MESH_IDS, cfg.vocab_size)
    batches = []
    for _ in range(MESH_ROUNDS):
        toks = rng.integers(0, ids, (n, batch_size, seq + 1)).astype(
            np.int32)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})

    def run(state, mesh):
        steps = {topo: make_train_step(cfg, opt, hp, do_topology=topo,
                                       mesh=mesh) for topo in (True, False)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launches()
        ms, losses, edges = [], [], []
        for rnd, batch in enumerate(batches):
            t1 = time.perf_counter()
            state, m = steps[rnd % MESH_DELTA_R == 0](state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(m["per_node_loss"].clone())
            edges.append(state.morph.edges.clone())
        got = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rec = {"round_ms": ms, "steady_round_ms": float(np.mean(ms[1:])),
               "peak_gb": peak / 1e9, "peak_over_base_gb": (peak - base) / 1e9,
               "losses": [v.tolist() for v in losses]}
        return state, got, rec, (losses, edges)

    with deterministic_cudnn():
        one, one_launches, one_rec, one_bits = run(one, None)
        mesh_state, mesh_launches, mesh_rec, mesh_bits = run(mesh_state,
                                                             device_mesh)
    for rnd in range(MESH_ROUNDS):
        for what, a, b in (("losses", mesh_bits[0][rnd], one_bits[0][rnd]),
                           ("edges", mesh_bits[1][rnd], one_bits[1][rnd])):
            if not same_bits(a, b):
                raise AssertionError(f"{label} {arch} round {rnd}: the mesh "
                                     f"step's {what} differ from the "
                                     "one-device step's")
    got, want = flatten(gather_train_state(mesh_state).params), \
        flatten(one.params)
    bad = [k for k in want if not same_bits(got[k], want[k])]
    if bad:
        raise AssertionError(f"{label} {arch}: parameters differ from the "
                             f"one-device step's: {bad[:6]}")
    if mesh_launches != one_launches or not (
            mesh_launches["gram_matrix"]
            and mesh_launches["graph_mix_masked"]):
        raise AssertionError(f"{label} {arch}: launches {mesh_launches} on "
                             f"the mesh, {one_launches} on one device")
    if not all(np.isfinite(mesh_rec["losses"][-1])):
        raise AssertionError(f"{label} {arch}: losses {mesh_rec['losses']}")
    rec = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "dtype": cfg.param_dtype, "policy": cfg.sharding_policy,
           "layout": dict(layout.shape), "nodes": n,
           "batch": [batch_size, seq], "population_gb": population / 1e9,
           "init_s": init_s, "mesh": mesh_rec, "one_device": one_rec,
           "bitwise": True, "launches": mesh_launches}
    log(f"phase {label}: {json.dumps(rec)}")
    del one, mesh_state, got, want
    torch.cuda.empty_cache()
    return mesh_launches, rec


def mesh_path(dev):
    """Phase 21: :func:`mesh_case` for each of MESH_CASES on a one-rank
    NCCL group; returns the mesh runs' launches."""
    t0 = time.perf_counter()
    totals, times = {}, []
    with one_rank_nccl_group():
        for case in MESH_CASES:
            t1 = time.perf_counter()
            _add(totals, mesh_case(dev, *case)[0])
            times.append(f"{case[0][-3:]} {time.perf_counter() - t1:.1f}")
    log(f"phase 21: {time.perf_counter() - t0:.1f} s ({', '.join(times)})")
    return totals


# ---------------------------------------------------------------------------
# Phase 22: the zoo's serve step and prefill on a device mesh.
# ---------------------------------------------------------------------------

# Each node serves SERVE_MESH_REQUESTS requests: prompts of
# SERVE_MESH_PROMPT tokens fed one at a time, then SERVE_MESH_NEW greedy
# tokens, in a cache of as many slots; 22(b) also prefills 2 x 2,048.
SERVE_MESH_REQUESTS, SERVE_MESH_PROMPT, SERVE_MESH_NEW = 4, 16, 8
SERVE_MESH_LONG = (2, 2048)
# (label, arch, layers kept (None: all; "jamba": jamba_serving_config),
# nodes, mesh axes (each of size 1), 22(b)'s long prefill.)
SERVE_MESH_CASES = (
    ("22(a)", "llama3.2-3b", None, 2, ("data", "model"), False),
    ("22(b)", "jamba-1.5-large-398b", "jamba", 1, ("pod", "data", "model"),
     True),
    ("22(c)", "rwkv6-7b", 2, 2, ("data", "model"), False))


def serve_mesh_case(dev, label, arch, layers, n, axes, long_prefill):
    """One case of phase 22: the serve step and the prefill on a one-rank
    ``DeviceMesh`` of ``axes`` (``make_serve_step(..., mesh=)`` on
    ``distribute_params`` parameters, which share the one-device leaves,
    and ``init_mesh_caches``) and on one device, from the same
    parameters and prompts: every step's logits, the greedy tokens, the
    caches at the end (``gather_tree``) and the prefills bit for bit, every
    kernel launched as often.  Returns (the mesh runs' launches, record)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.dlrt import (distribute_params, gather_tree,
                                  init_mesh_caches, init_node_caches,
                                  init_train_state, make_prefill_step,
                                  make_serve_step, serve_kv_spec)
    from repro_torch.launch import MeshLayout
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    cfg = (jamba_serving_config() if layers == "jamba" else get_config(arch)
           if layers is None else
           dataclasses.replace(get_config(arch), num_layers=layers))
    layout = MeshLayout(axes, (1,) * len(axes))
    device_mesh = layout.device_mesh(dev.type)
    b, steps = SERVE_MESH_REQUESTS, SERVE_MESH_PROMPT + SERVE_MESH_NEW
    t0 = time.perf_counter()
    params = init_train_state(cfg, sgd(0.05), n, seed=22, device=dev).params
    mesh_params = distribute_params(params, layout, device_mesh, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat = flatten(params)
    shared = all(v.to_local().data_ptr() == flat[k].data_ptr()
                 for k, v in flatten(mesh_params).items())
    gen = torch.Generator(device=dev).manual_seed(22)
    prompts = torch.randint(0, cfg.vocab_size, (n, b, SERVE_MESH_PROMPT),
                            generator=gen, device=dev)
    long = (torch.randint(0, cfg.vocab_size, (n,) + SERVE_MESH_LONG,
                          generator=gen, device=dev) if long_prefill
            else None)

    def run(mesh):
        p = mesh_params if mesh else params
        if mesh:
            cache = init_mesh_caches(cfg, n, b, steps, layout, device_mesh,
                                     device=dev)
            step = make_serve_step(cfg, kv_spec=serve_kv_spec(layout, cfg, b),
                                   mesh=device_mesh)
        else:
            cache = init_node_caches(cfg, n, b, steps, device=dev)
            step = make_serve_step(cfg)
        prefill = make_prefill_step(cfg, mesh=device_mesh if mesh else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launches()
        logits, ms, tok = [], [], prompts[..., :1]
        for pos in range(steps):
            if pos < SERVE_MESH_PROMPT:
                tok = prompts[..., pos:pos + 1]
            t1 = time.perf_counter()
            got, cache = step(p, cache, tok, pos)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            logits.append(got)
            tok = got.argmax(-1)
        decode_peak = torch.cuda.max_memory_allocated()
        counts = {"decode": launch_counts()}
        prefills, prefill_ms = [], []
        for what in (["prompts"] + (["warm", "long"] if long is not None
                                     else [])):
            kernels.reset_launches()
            t1 = time.perf_counter()
            prefills.append(prefill(p, {"tokens": prompts if what ==
                                        "prompts" else long}))
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t1) * 1e3)
            counts[what] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rec = {"decode_ms": ms,
               "steady_decode_ms": float(np.mean(ms[2:])),
               "decode_peak_over_base_gb": (decode_peak - base) / 1e9,
               "peak_gb": peak / 1e9,
               "prefill_ms": dict(zip(counts, [None] + prefill_ms)),
               "launches": counts}
        full = gather_tree(cache) if mesh else cache
        return logits, full, prefills, rec

    with deterministic_cudnn():
        one = run(False)
        mesh = run(True)
    for pos, (a, c) in enumerate(zip(mesh[0], one[0])):
        if not same_bits(a, c):
            raise AssertionError(f"{label} {arch}: step {pos}'s logits on "
                                 "the mesh differ from one device's")
    got, want = flatten(mesh[1]), flatten(one[1])
    bad = [k for k in want if not same_bits(got[k], want[k])]
    if bad or list(got) != list(want):
        raise AssertionError(f"{label} {arch}: caches differ: {bad[:6]}")
    for i, (a, c) in enumerate(zip(mesh[2], one[2])):
        if not same_bits(a, c):
            raise AssertionError(f"{label} {arch}: prefill {i} differs")
    m_rec, o_rec = mesh[3], one[3]
    if m_rec["launches"] != o_rec["launches"]:
        raise AssertionError(f"{label} {arch}: launches {m_rec['launches']} "
                             f"on the mesh, {o_rec['launches']} on one "
                             "device")
    n_mamba = n * sum(s.mixer == "mamba" for s in cfg.pattern) \
        * cfg.num_periods
    none = dict.fromkeys(m_rec["launches"]["decode"], 0)
    for what, got in m_rec["launches"].items():
        want = none if what == "decode" else dict(
            none, selective_scan=n_mamba)
        if got != want:
            raise AssertionError(f"{label} {arch}: {what} launched {got}, "
                                 f"want {want}")
    shape = (n, b, 1, cfg.vocab_size)
    if mesh[0][-1].shape != shape or not all(
            torch.isfinite(t).all() for t in mesh[0] + mesh[2]):
        raise AssertionError(f"{label}: logits {mesh[0][-1].shape}, want "
                             f"{shape} and finite")
    launches = dict(none)
    for got in m_rec["launches"].values():
        _add(launches, got)
    rec = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
           "policy": cfg.sharding_policy, "layout": dict(layout.shape),
           "nodes": n, "requests": b, "prompt": SERVE_MESH_PROMPT,
           "new_tokens": SERVE_MESH_NEW, "slots": steps,
           "params_per_node_b": sum(v[0].numel() for v in flat.values())
           / 1e9, "shared_storage": shared, "init_s": init_s,
           "long_prefill": list(SERVE_MESH_LONG) if long_prefill else None,
           "mesh": {k: v for k, v in m_rec.items() if k != "launches"},
           "one_device": {k: v for k, v in o_rec.items()
                          if k != "launches"},
           "bitwise": True, "launches": m_rec["launches"]}
    log(f"phase {label}: {json.dumps(rec)}")
    del params, mesh_params, one, mesh, got, want, flat
    torch.cuda.empty_cache()
    return launches, rec


def serve_mesh_path(dev):
    """Phase 22: :func:`serve_mesh_case` for each of SERVE_MESH_CASES on a
    one-rank NCCL group; returns the mesh runs' launches."""
    t0 = time.perf_counter()
    totals, times = {}, []
    with one_rank_nccl_group():
        for case in SERVE_MESH_CASES:
            t1 = time.perf_counter()
            _add(totals, serve_mesh_case(dev, *case)[0])
            times.append(f"{case[0][-3:]} {time.perf_counter() - t1:.1f}")
    log(f"phase 22: {time.perf_counter() - t0:.1f} s ({', '.join(times)})")
    return totals


# ---------------------------------------------------------------------------
# Phase 23: the sweep farm on an ("exp", "data") mesh.
# ---------------------------------------------------------------------------

SWEEP_MESH_ROUNDS = 5                 # 23(a): a negotiation at round 0


def tiny_net_sweep(dev, mesh=None):
    """23(b)'s sweep: the tiny MLP, n = 6, E = 4 Morph experiments under a
    ``SweepNetwork`` of ideal, WAN, LAN and WAN at round_s 0.05 (rings of
    other depths), eleven rounds, batch slots keyed on the host."""
    from repro_torch import core, fold_seed
    from repro_torch.bench.common import tiny_mlp_experiment
    from repro_torch.data import DeviceDataStream
    from repro_torch.dlrt import RunnerConfig, SweepSpec, SweepSuperstep
    from repro_torch.models import mlp_loss, mlp_params
    from repro_torch.netsim import DenseNetwork, SweepNetwork
    from repro_torch.netsim import profiles as prof
    from repro_torch.optim import sgd
    n, seeds = 6, (0, 1, 2, 3)
    tr, parts, _, test = tiny_mlp_experiment(n)

    class HostSlots(DeviceDataStream):
        def slots(self, rnd):
            gen = torch.Generator().manual_seed(fold_seed(self.seed, rnd))
            sizes = self.sizes.cpu()[:, None]
            u = torch.rand((self.n, self.batch), generator=gen)
            return torch.minimum((u * sizes).long(), sizes - 1).to(dev)

    nets = [DenseNetwork(prof.get_profile(p, n, 10 + e), round_s=0.05,
                         max_staleness=4)
            for e, p in enumerate(("ideal", "wan", "lan", "wan"))]
    return SweepSuperstep(
        spec=SweepSpec(seeds=seeds), init_fn=mlp_params, loss_fn=mlp_loss,
        eval_fn=mlp_loss, optimizer=sgd(0.05),
        streams=[HostSlots(tr, parts, 4, seed=s, device=dev) for s in seeds],
        test_batch=test,
        strategies=[core.InGraphMorphStrategy(n=n, k=2, view_size=4, seed=s,
                                              delta_r=2, device=dev)
                    for s in seeds],
        cfg=RunnerConfig(n_nodes=n, rounds=11, eval_every=5),
        net=SweepNetwork(nets), mesh=mesh, device=dev)


def sweep_mesh_run(build, rounds, run_all):
    """One side of a 23 pair: the sweep ``build()`` makes, its counts set
    to 0 just before its rounds and read just after; ``run_all`` runs it
    with its evaluations (``run``), else ``rounds`` rounds and one
    evaluation.  Returns ``(sweep, launches, ms a round, records)``."""
    from repro_torch import kernels
    eng = build()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if run_all:
        eng.run()
        rounds = eng.cfg.rounds
    else:
        eng.run_steps(rounds)
        eng.evaluate(rounds - 1, np.stack([h[-1] for h in eng.edge_history]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / rounds * 1e3
    got = launch_counts()
    recs = [[(r.rnd, r.comm_bytes, r.isolated, r.mean_accuracy, r.mean_loss,
              r.per_node_accuracy.tolist()) for r in log.records]
            for log in eng.log]
    return eng, got, ms, recs


def sweep_mesh_pair(label, meshless, meshed, rounds=SWEEP_MESH_ROUNDS,
                    run_all=False):
    """23's check of one pair: the mesh run against the meshless one, bit
    for bit, with the same launches; returns the mesh run's launches."""
    a, want, ms_a, recs_a = sweep_mesh_run(meshless, rounds, run_all)
    b, got, ms_b, recs_b = sweep_mesh_run(meshed, rounds, run_all)
    params = b.logical_params()
    same = (all(torch.equal(a.params[k], params[k]) for k in a.params)
            and all(len(x) == len(y) and all(np.array_equal(u, v)
                                             for u, v in zip(x, y))
                    for x, y in zip(a.edge_history, b.edge_history))
            and recs_a == recs_b
            and [a.comm_bytes(e) for e in range(a.E)]
            == [b.comm_bytes(e) for e in range(b.E)])
    if a.net is not None:
        same = same and all(
            np.array_equal(u, v) for x, y in zip(a.delivered_history,
                                                 b.delivered_history)
            for u, v in zip(x, y)) and all(
            (s["delivered"], s["dropped"], s["staleness_sum"],
             s["staleness_hist"].tolist())
            == (w["delivered"], w["dropped"], w["staleness_sum"],
                w["staleness_hist"].tolist())
            for s, w in zip(a.net_stats, b.net_stats))
    if not same:
        raise AssertionError(f"23 {label}: the mesh run is not the meshless "
                             "run bit for bit")
    if got != want or not any(want.values()):
        raise AssertionError(f"23 {label}: launches {got} != the meshless "
                             f"run's {want}")
    for p in params.values():
        if not torch.isfinite(p).all():
            raise AssertionError(f"23 {label}: non-finite parameters")
    log(f"phase 23: {label} E={b.E} on a {dict(b.mesh.shape)} mesh == "
        f"meshless bit for bit; " + json.dumps(dict(
            launches=got, mesh_ms_per_round=ms_b, meshless_ms_per_round=ms_a,
            comm_bytes=[b.comm_bytes(e) for e in range(b.E)],
            accuracy=[log_.records[-1].mean_accuracy for log_ in b.log])))
    return got


def sweep_mesh_path(dev):
    """Phase 23: :func:`sweep_mesh_pair` for GN-LeNet at full width (Morph,
    Static) and the tiny MLP under a network, on a 1 x 1 NCCL mesh;
    returns the mesh runs' launches."""
    from repro_torch.launch import make_sweep_mesh
    t0 = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)
    seeds = tuple(range(SWEEP_SEEDS))
    mesh = make_sweep_mesh(1, 1)
    try:
        with deterministic_cudnn():
            for name in ("morph", "static"):
                sweep, _ = sweep_fixture(MAIN_N, dev, seeds, name=name)
                _add(totals, sweep_mesh_pair(
                    f"(a) GN-LeNet {name} n={MAIN_N}", sweep,
                    lambda: sweep(mesh=mesh)))
            _add(totals, sweep_mesh_pair(
                "(b) tiny MLP under a network n=6",
                lambda: tiny_net_sweep(dev), lambda: tiny_net_sweep(dev, mesh),
                run_all=True))
    finally:
        mesh.close()
    for name in ("gram_matrix", "graph_mix", "graph_mix_masked"):
        if totals[name] == 0:
            raise AssertionError(f"phase 23: {name} never launched")
    log(f"phase 23: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(totals)}")
    return totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import cuda

    # The runner clears cuDNN's TF32 around its own local step and
    # evaluation; these global settings keep every other f32 product and
    # convolution of the run (the plain versions, the zoo in f32) in f32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products reduce their split-K partial sums in f32, as the
    # reference's do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    report = cuda.build_all()
    for name, r in report.items():
        usage = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        log(f"phase 2: built {name}.cu in {r['seconds']:.1f} s: "
            + " | ".join(usage))
    log(f"phase 2: build wall {time.perf_counter() - t0:.1f} s")

    worst = check_kernels(dev)
    check_grouped(dev, worst)
    check_sparse(dev, worst)
    check_scan(dev, worst)
    times = time_kernels(dev)
    for name, t in time_tree(dev).items():
        times[name]["tree_n50"] = t
    for name, t in time_dense_large(dev, worst).items():
        times[name]["at_n1000"] = t
    tree_large = time_tree_large(dev, worst)
    for name in ("gram_matrix", "graph_mix", "graph_mix_masked"):
        times[name]["tree_n1000"] = tree_large[name]
    sparse_times = time_sparse(dev)
    times["selective_scan"] = time_scan(dev)
    counts = main_path(dev)
    morph_breakdown(dev)
    reference_check(dev)
    zoo_reference_check(dev)
    counts["graph_mix_sparse"] = sparse_path(dev)
    sparse_breakdown(dev)
    dense_large(dev)
    times["graph_mix_sparse"] = dict(sparse_times[LARGE_N],
                                     at_n50=sparse_times[MAIN_N],
                                     tree_n1000=tree_large["graph_mix_sparse"])
    counts["selective_scan"], _ = serve_jamba(dev)
    fig3_counts = fig3_contest(dev)
    codec_counts = compressed_path(dev)
    codec_reference_check(dev)
    net_counts, rings = net_path(dev, worst)
    times["graph_mix"].update(rings)
    table1_counts, host_counts = host_loop_path(dev)
    async_counts = async_path(dev)
    sweep_counts, sweep_mixes = sweep_path(dev)
    fig12_counts, fig9_counts = tune_path(dev)
    sharded_counts = sharded_path(dev)
    worst["selective_scan_bwd"], times["selective_scan_bwd"], \
        train_counts = train_path(dev)
    zoo_counts = zoo_path(dev)
    front_counts = frontends_path(dev)
    ckpt_counts = checkpoint_path(dev)
    mesh_counts = mesh_path(dev)
    serve_mesh_counts = serve_mesh_path(dev)
    sweep_mesh_counts = sweep_mesh_path(dev)
    launcher_path(dev)
    for name in ("graph_mix", "graph_mix_masked"):
        times[name]["sweep_per_row_w"] = {
            k: v[name] for k, v in sweep_mixes.items()}

    sources = {"gram_matrix": ("src/repro_torch/kernels/csrc/"
                               "pairwise_cosine.cu",
                               "src/repro/kernels/pairwise_cosine.py:50"),
               "graph_mix": ("src/repro_torch/kernels/csrc/graph_mix.cu",
                             "src/repro/kernels/graph_mix.py:44"),
               "graph_mix_masked": ("src/repro_torch/kernels/csrc/"
                                    "graph_mix.cu",
                                    "src/repro/kernels/graph_mix.py:77"),
               "graph_mix_sparse": ("src/repro_torch/kernels/csrc/"
                                    "graph_mix_sparse.cu",
                                    "src/repro/kernels/graph_mix_sparse.py"
                                    ":78"),
               "selective_scan": ("src/repro_torch/kernels/csrc/"
                                  "selective_scan.cu",
                                  "src/repro/kernels/selective_scan.py:75"),
               "selective_scan_bwd": (
                   "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                   "none: the backward of src/repro/models/mamba.py:82-123 "
                   "(jax.grad through lax.associative_scan; the Pallas "
                   "scan at src/repro/kernels/selective_scan.py:75 has no "
                   "backward)")}
    rows = []
    smallest_n = min(n for n, _ in AWKWARD)     # graph_mix's tightest atol
    for name in ("gram_matrix", "graph_mix_masked", "graph_mix",
                 "graph_mix_sparse", "selective_scan", "selective_scan_bwd"):
        t = times[name]
        row = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "launches_fig3": fig3_counts[name],
            "launches_compressed": codec_counts[name],
            "launches_net": net_counts[name],
            "launches_host_loop": host_counts[name],
            "launches_table1": table1_counts[name],
            "launches_async": async_counts[name],
            "launches_sweep": sweep_counts[name],
            "launches_fig12": fig12_counts[name],
            "launches_fig9": fig9_counts[name],
            "launches_sharded": sharded_counts[name],
            "launches_train": train_counts[name],
            "launches_zoo": zoo_counts[name],
            "launches_frontends": front_counts[name],
            "launches_checkpoint": ckpt_counts[name],
            "launches_mesh": mesh_counts[name],
            "launches_serve_mesh": serve_mesh_counts.get(name, 0),
            "launches_sweep_mesh": sweep_mesh_counts.get(name, 0),
            "max_abs_err": worst[name]["float32"],
            "max_abs_err_bf16": worst[name]["bfloat16"],
            "tol": tolerance(name, smallest_n, False, K)[0],
            "tol_f32": dict(zip(("atol", "rtol"),
                                tolerance(name, smallest_n, False, K))),
            "tol_bf16": dict(zip(("atol", "rtol"),
                                 tolerance(name, smallest_n, True, K))),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{key: t[key] for key in ("device_ms", "library_device_ms",
                                       "host_enqueue_us", "share_of_bound",
                                       "matmul_ms", "matmul_device_ms",
                                       "library_max_abs_err", "at_n50",
                                       "tree_n50", "at_n1000",
                                       "tree_n1000", "ring_n50",
                                       "ring_n1000", "sweep_per_row_w",
                                       "library",
                                       "bound_part", "bound_parts_ms",
                                       "kernel_issue_ms", "sass_per_element",
                                       "sm_clock_mhz", "jamba_layer")
               if key in t},
            "shape": t["shape"]}
        # ``max_err`` and ``kernel_ms`` are other names for the same two
        # readings, copied from them here so they cannot differ.
        row.update(max_err=row["max_abs_err"], kernel_ms=row["ms"])
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
