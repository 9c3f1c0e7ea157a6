"""What each gloo rank of ``tests/test_torch_mesh_serve.py`` runs (the
ranks import this module, so it holds no JAX): the zoo's serve step and
prefill on a ``DeviceMesh`` from seeded parameters and tokens.

A case is a dict: ``arch``, ``experts`` (False: Jamba without its
experts), ``head_dim`` (where given, the config's), ``axes`` and
``sizes`` (the mesh layout), ``n`` nodes, ``b`` requests a node,
``max_len`` cache slots, ``window`` (an int, or absent for the
config's), ``steps`` tokens decoded one at a time from position 0 (none:
the round trip alone), ``prefill`` (also the mesh prefill of the same
``steps`` tokens, with Whisper's ``frames``: :func:`prefill_batch`),
``count`` (also one more decode step with every collective's bytes
recorded by stage), ``roundtrip`` (also the state's round trip),
``single`` (rank 0 also runs the one-device step),
``device`` (``"cpu"`` unless given) and ``params`` (a file of the
parameters, drawn once for every rank).  Node i's parameters are
``model.init_params(cfg, i)`` drawn on the CPU, as
``tests/_zoo_parity.py`` ``port_params`` draws them for the reference.
"""
import dataclasses
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.dlrt import (cache_sharding, distribute_cache,
                              distribute_params, gather_tree,
                              init_mesh_caches, init_node_caches,
                              make_prefill_step, make_serve_step,
                              params_sharding, serve_kv_spec, shard_shape)
from repro_torch.bench.harness import CollectiveBytes
from repro_torch.launch import MeshLayout
from repro_torch.launch.dryrun import per_card_bytes
from repro_torch.models import model
from repro_torch.tree import flatten, unflatten

import _mesh_cases as mc

TOKEN_SEED = 11
FRAME_SEED = 12


def config(case):
    """The reduced config; ``head_dim``, where the case gives one,
    replaces the config's."""
    cfg = mc.config(case["arch"], case.get("experts", True))
    if case.get("head_dim"):
        cfg = dataclasses.replace(cfg, head_dim=case["head_dim"])
    return cfg


def stacked_params(cfg, n):
    nodes = [flatten(model.init_params(cfg, i, device="cpu"))
             for i in range(n)]
    return unflatten(OrderedDict((k, torch.stack([t[k] for t in nodes]))
                                 for k in nodes[0]))


def params_of(case, wait_s=300.0):
    """The case's node-stacked parameters: loaded from ``case["params"]``
    (a ``torch.save`` of :func:`stacked_params`' leaves by path, drawn
    once for every rank, which may still be drawing it: waited for up to
    ``wait_s`` seconds) where given, else drawn here."""
    path = case.get("params")
    if not path:
        return stacked_params(config(case), case["n"])
    deadline = time.monotonic() + wait_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no parameters at {path}")
        time.sleep(0.05)
    return unflatten(torch.load(path))


def save_params(case, path):
    """:func:`stacked_params` of ``case`` into ``path``, which appears
    whole."""
    torch.save(flatten(stacked_params(config(case), case["n"])),
               f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


def tokens(cfg, case):
    """``[n, b, steps]`` token ids, the same on both sides."""
    rng = np.random.default_rng(TOKEN_SEED)
    return rng.integers(0, cfg.vocab_size,
                        (case["n"], case["b"], case["steps"])).astype(
                            np.int64)


def prefill_batch(cfg, case):
    """The prefill's inputs as numpy arrays, the same on both sides: the
    case's tokens and, for an encoder-decoder, standard normal ``frames
    [n, b, T, d]`` f32 at the dry run's shape
    (``repro_torch.launch.shapes.input_specs``)."""
    batch = {"tokens": tokens(cfg, case)}
    if cfg.encoder is not None:
        rng = np.random.default_rng(FRAME_SEED)
        batch["frames"] = rng.standard_normal(
            (case["n"], case["b"], cfg.encoder.seq_len, cfg.d_model)
        ).astype(np.float32)
    return batch


def window_of(case):
    return case.get("window", "cfg")


def numpy_flat(tree):
    return OrderedDict((k, v.detach().cpu().numpy().copy())
                       for k, v in flatten(tree).items())


def _local_bytes(tree) -> int:
    return sum(v.to_local().numel() * v.to_local().element_size()
               for v in flatten(tree).values())


def roundtrip(cfg, case, layout, device_mesh, params):
    """distribute then gather, bit for bit; fresh mesh caches of the
    specs' shard shapes; this rank's bytes against the dry run's."""
    n, b, t = case["n"], case["b"], case["max_len"]
    dparams = distribute_params(params, layout, device_mesh, cfg)
    gen = torch.Generator().manual_seed(3)
    full = init_node_caches(cfg, n, b, t, device="cpu")
    for leaf in flatten(full).values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    dcache = distribute_cache(full, layout, device_mesh, cfg)
    same = all(torch.equal(a, c) for a, c in zip(
        list(flatten(gather_tree(dparams)).values())
        + list(flatten(gather_tree(dcache)).values()),
        list(flatten(params).values()) + list(flatten(full).values())))
    fresh = init_mesh_caches(cfg, n, b, t, layout, device_mesh,
                             device="cpu")
    specs = mc._spec_leaves(cache_sharding(layout, cfg, full))
    shapes = list(specs) == list(flatten(fresh)) and all(
        tuple(v.to_local().shape) == shard_shape(tuple(v.shape), specs[k],
                                                 layout)
        for k, v in flatten(fresh).items())
    zeros = all(not v.to_local().any() for v in flatten(fresh).values())
    want = (per_card_bytes(params, params_sharding(layout, cfg, params))
            + per_card_bytes(full, cache_sharding(layout, cfg, full)))
    return {"bitwise": same, "shapes": shapes, "zeros": zeros,
            "bytes": _local_bytes(dparams) + _local_bytes(fresh),
            "dryrun_bytes": want,
            "split": sum(1 for v in flatten(fresh).values()
                         if any(p.is_shard() for p in v.placements))}


def device_of(case) -> torch.device:
    """The case's device: the CPU unless it says ``"cuda"`` (then this
    rank's card)."""
    dev = torch.device(case.get("device", "cpu"))
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def launches():
    from repro_torch.kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def serve(case):
    """The case on this rank: every decode step's logits, the gathered
    caches, the kernels' launches, and the prefill, the collectives, the
    round trip and (rank 0, ``single``) the one-device run where
    asked."""
    from repro_torch import kernels
    cfg = config(case)
    n, b, steps = case["n"], case["b"], case["steps"]
    dev = device_of(case)
    layout = MeshLayout(tuple(case["axes"]), tuple(case["sizes"]))
    device_mesh = layout.device_mesh(dev.type)
    params = params_of(case)
    out = {}
    if case.get("roundtrip"):
        out["roundtrip"] = roundtrip(cfg, case, layout, device_mesh, params)
    if not steps:
        return out
    dparams = distribute_params(_to(params, dev), layout, device_mesh, cfg)
    cache = init_mesh_caches(cfg, n, b, case["max_len"], layout,
                             device_mesh, device=dev)
    step = make_serve_step(cfg, window=window_of(case),
                           kv_spec=serve_kv_spec(layout, cfg, b),
                           mesh=device_mesh)
    toks = torch.as_tensor(tokens(cfg, case))
    kernels.reset_launches()
    logits = []
    for t in range(steps):
        got, cache = step(dparams, cache, toks[..., t:t + 1], t)
        logits.append(got.cpu().numpy().copy())
    out["launches"] = launches()
    out["logits"] = np.stack(logits)
    out["cache"] = numpy_flat(gather_tree(cache))
    if case.get("count"):
        counter = CollectiveBytes()
        with counter:
            step(dparams, cache, toks[..., :1], steps, stage=counter.stage)
        attn = [v.to_local() for k, v in flatten(cache).items()
                if k.endswith("attn.k")]
        out["collectives"] = counter.records
        # One layer's block of the k buffer for one node, this rank's.
        out["block_bytes"] = (attn[0][0, 0].numel()
                              * attn[0].element_size())
    if case.get("prefill"):
        prefill = make_prefill_step(cfg, window=window_of(case),
                                    mesh=device_mesh)
        kernels.reset_launches()
        out["prefill"] = prefill(dparams, _torch_batch(
            prefill_batch(cfg, case), dev)).cpu().numpy()
        out["prefill_launches"] = launches()
    if case.get("single") and torch.distributed.get_rank() == 0:
        out["single"] = one_device(case)
    return out


def _torch_batch(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _to(tree, dev):
    return tree if dev.type == "cpu" else unflatten(OrderedDict(
        (k, v.to(dev)) for k, v in flatten(tree).items()))


def one_device(case):
    """The case through the one-device serve step and prefill, with the
    kernels' launches."""
    from repro_torch import kernels
    cfg = config(case)
    dev = device_of(case)
    params = _to(params_of(case), dev)
    cache = init_node_caches(cfg, case["n"], case["b"], case["max_len"],
                             device=dev)
    step = make_serve_step(cfg, window=window_of(case))
    toks = torch.as_tensor(tokens(cfg, case)).to(dev)
    kernels.reset_launches()
    logits = []
    for t in range(case["steps"]):
        got, cache = step(params, cache, toks[..., t:t + 1], t)
        logits.append(got.cpu().numpy().copy())
    out = {"logits": np.stack(logits), "cache": numpy_flat(cache),
           "launches": launches()}
    if case.get("prefill"):
        kernels.reset_launches()
        out["prefill"] = make_prefill_step(cfg, window=window_of(case))(
            params, _torch_batch(prefill_batch(cfg, case), dev)
        ).cpu().numpy()
        out["prefill_launches"] = launches()
    return out


def rank_main(cases):
    """Every case in turn on this rank."""
    return [serve(c) for c in cases]
