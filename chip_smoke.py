#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit) when it does not hold:

1. a CUDA device is present; print ``nvidia-smi``'s name and power limit;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (four sources, one ``nvcc`` each, all at once);
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
   SwiGLU in place of the experts, bf16, drawn on the card: (a) prefill of
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

then one JSON line with every kernel's numbers, the card line, and the
result line ``{"ok": true, "device": {...}}`` last.  TF32 is off for
cuDNN convolutions and matmuls in every phase, so the card computes in
full f32 like the plain versions it is compared with, and bf16 products
reduce in f32.
"""
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


def log(msg):
    print(msg, flush=True)


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


# The scan kernel's instantiation for the served types (d_state 16; x, b
# and c bf16, dt f32), as its mangled name shows it in the SASS.
SCAN_SERVED_SASS = ("scan_kernelILi16E", "13__nv_bfloat16fS")
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")


def scan_sass():
    """Instructions per (t, channel, state) element in the scan kernel's
    inner step, read from the built library's SASS (``cuobjdump -sass``):
    in the served instantiation, the largest straight-line block (the
    unrolled full-tile steps with their loop's own count and branch) holds
    one ``MUFU.EX2`` per element, so its counts over its ``MUFU.EX2`` count
    are per element.  ``fp32`` counts FFMA, FADD and FMUL (the FP32 pipe);
    the per-tile staging outside that block is left out."""
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(cuda.library_path("selective_scan"))],
                          capture_output=True, text=True, check=True).stdout
    functions, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            functions[name] = []
        elif name is not None:
            functions[name].append(line)
    served = [f for f in functions if all(p in f for p in SCAN_SERVED_SASS)]
    if len(served) != 1:
        raise AssertionError(f"scan SASS: {len(served)} functions match "
                             f"{SCAN_SERVED_SASS}")
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
    step = max(blocks + [block], key=len)
    elements = step.count("MUFU.EX2")
    if elements == 0:
        raise AssertionError("scan SASS: no MUFU.EX2 in the inner step")
    ops = {}
    for op in step:
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    fp32 = sum(ops.get(k, 0) for k in ("FFMA", "FADD", "FMUL"))
    return {"function": served[0], "block_instructions": len(step),
            "elements": elements, "all": len(step) / elements,
            "fp32": fp32 / elements, "mufu": ops.get("MUFU", 0) / elements,
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


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
                net=None, strategy=None, compiled=None, **setup):
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
                         compiled=compiled),
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
    from repro_torch.kernels import graph_mix, graph_mix_masked, gram_matrix
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
    return {"gram_matrix": gram_matrix.launches,
            "graph_mix": graph_mix.launches,
            "graph_mix_masked": graph_mix_masked.launches}


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
    dense SwiGLU at d_ff 24,576: four MoE layers of 16 experts do not fit
    one card (ROADMAP queue 1 item 16 ports MoE on deepseek-moe-16b)."""
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


def prefill_breakdown(params, tokens, cfg):
    """Phase 9(d): one prefill with each stage synchronised on the host
    clock (the wrappers are put back afterwards)."""
    from repro_torch.models import (attention, layers, mamba, model,
                                    transformer)
    stages = dict.fromkeys(("mamba", "scan", "attention", "mlp", "norms",
                            "lm_head"), 0.0)
    patched = [(mamba, "apply_mamba", "mamba"),
               (mamba, "selective_scan", "scan"),
               (attention, "self_attention", "attention"),
               (layers, "apply_mlp", "mlp"), (layers, "apply_norm", "norms"),
               (transformer, "_lm_logits", "lm_head")]
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
        _, total = synced(model.forward, params, {"tokens": tokens}, cfg,
                          last_only=True)
    finally:
        for (mod, name, _), fn in zip(patched, originals):
            setattr(mod, name, fn)
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
                                  "src/repro/kernels/selective_scan.py:75")}
    rows = []
    smallest_n = min(n for n, _ in AWKWARD)     # graph_mix's tightest atol
    for name in ("gram_matrix", "graph_mix_masked", "graph_mix",
                 "graph_mix_sparse", "selective_scan"):
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
                                       "ring_n1000", "library",
                                       "bound_part", "bound_parts_ms",
                                       "kernel_issue_ms", "sass_per_element",
                                       "sm_clock_mhz")
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
