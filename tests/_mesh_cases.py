"""What each gloo rank of ``tests/test_torch_mesh_train.py`` runs (the
ranks import this module, so it holds no JAX): the zoo's train step on a
``DeviceMesh`` from a seeded state and seeded batches, rank 0 also the
one-device step from the same state, and the state's round trip through
``distribute_train_state`` / ``gather_train_state``.

A case is a dict: ``arch``, ``axes`` and ``sizes`` (the mesh layout),
``n`` nodes, ``batch`` per node, ``rounds``, ``delta_r`` (topology on
rounds ``r % delta_r == 0``), ``microbatch``, ``opt`` (``"sgd"`` or
``"clip"``: ``chain_clip(adamw(...), CLIP)``), ``noise`` (one
``MorphNoise`` a topology round, or None to draw from the state's
generator), ``single`` (rank 0 also runs the one-device step),
``device`` (``"cpu"`` unless given) and ``experts`` (False: Jamba
without its experts); with
``roundtrip`` set, only the state's round trip; a case with ``argv`` runs
the launcher instead (:func:`launcher`).
"""
import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import init_state
from repro_torch.dlrt import (MorphHParams, TrainState,
                              distribute_train_state, gather_train_state,
                              make_train_step, shard_shape,
                              train_state_sharding)
from repro_torch.dlrt.distributed import _init_opt_state, _ring
from repro_torch.launch import MeshLayout
from repro_torch.models import model
from repro_torch.optim import adamw, chain_clip, sgd
from repro_torch.tree import flatten, unflatten

LR, ADAM_LR, SEQ = 0.05, 1e-3, 16
HP = dict(k=2, view_size=3)
# A clip that binds on the first rounds of reduced Qwen (gradient norms of
# about 3 there).
CLIP = 0.5


def config(arch, experts=True):
    """The reduced config; Jamba without ``experts`` has a dense MLP in
    every layer (as ``chip_smoke.py`` phase 21(c) trains it)."""
    cfg = get_config(arch)
    if not experts:
        cfg = dataclasses.replace(cfg, moe=None, pattern=tuple(
            dataclasses.replace(s, moe=False) for s in cfg.pattern))
    return cfg.reduced()


def optimizer(name):
    return sgd(LR) if name == "sgd" else chain_clip(adamw(ADAM_LR), CLIP)


def initial_state(cfg, opt, n, device="cpu", seed=0):
    """Node i's parameters ``model.init_params(cfg, seed + i)`` drawn on
    the CPU (as ``tests/_zoo_parity.py`` ``port_params`` draws them for
    the reference), the optimizer's fresh state and Morph on the ring, on
    ``device``."""
    nodes = [flatten(model.init_params(cfg, seed + i, device="cpu"))
             for i in range(n)]
    stacked = OrderedDict((k, torch.stack([t[k] for t in nodes]).to(device))
                          for k in nodes[0])
    return TrainState(unflatten(stacked), _init_opt_state(opt, stacked),
                      init_state(_ring(n, device)))


def batches(cfg, n, b, rounds, seed=7):
    """``tests/_zoo_parity.py`` ``lm_batch`` ``rounds`` times from one
    generator: tokens and next-token labels, the first two masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        toks = rng.integers(0, cfg.vocab_size,
                            (n, b, SEQ + 1)).astype(np.int32)
        labels = toks[..., 1:].copy()
        labels[..., :2] = -100
        out.append({"tokens": toks[..., :-1], "labels": labels})
    return out


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def run(step_of, state, cfg, case):
    """``case['rounds']`` rounds; per round the edges, Morph's similarity
    estimates and the per-node losses, then the state."""
    noise = iter(case["noise"] or ())
    record = []
    for rnd, batch in enumerate(batches(cfg, case["n"], case["batch"],
                                        case["rounds"])):
        topo = rnd % case["delta_r"] == 0
        state, m = step_of[topo](state, batch,
                                 noise=next(noise) if topo and case["noise"]
                                 else None)
        record.append({k: v.cpu().numpy().copy() for k, v in (
            ("edges", state.morph.edges), ("sim", state.morph.sim),
            ("per_node_loss", m["per_node_loss"]), ("loss", m["loss"]))})
    return record, state


def roundtrip(cfg, opt, n, layout, device_mesh):
    """distribute then gather: bit for bit, and every local shape the
    spec's shard shape."""
    state = initial_state(cfg, opt, n)
    dist_state = distribute_train_state(state, layout, device_mesh, cfg)
    sh = train_state_sharding(layout, cfg, state)
    shapes_ok = []
    for tree, specs in ((dist_state.params, sh.params),
                        (dist_state.opt_state, sh.opt_state)):
        flat = flatten(tree)
        flat_specs = _spec_leaves(specs)
        assert list(flat) == list(flat_specs)
        shapes_ok += [tuple(v.to_local().shape) == shard_shape(
            v.shape, flat_specs[k], layout) for k, v in flat.items()]
    back = gather_train_state(dist_state)
    same = all(torch.equal(a, b) for a, b in zip(
        list(flatten(back.params).values())
        + list(flatten(back.opt_state).values()),
        list(flatten(state.params).values())
        + list(flatten(state.opt_state).values())))
    split = sum(1 for v in flatten(dist_state.params).values()
                if any(p.is_shard() for p in v.placements))
    return {"bitwise": same, "shapes": all(shapes_ok),
            "leaves": len(shapes_ok), "split": split}


def _spec_leaves(tree, prefix=""):
    """Dotted path -> spec of a sharding tree (its NamedShardings)."""
    from repro_torch.dlrt import NamedSharding
    out = OrderedDict()
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else list(enumerate(tree)))
    for k, v in items:
        if isinstance(v, NamedSharding):
            out[f"{prefix}{k}"] = v.spec
        else:
            out.update(_spec_leaves(v, f"{prefix}{k}."))
    return out


def one_case(case):
    """One case on this rank (on this rank's card where the case's
    ``device`` is ``"cuda"``, counting the kernels' launches)."""
    from repro_torch import kernels
    cfg = config(case["arch"], case.get("experts", True))
    opt = optimizer(case["opt"])
    hp = MorphHParams(**HP)
    dev = torch.device(case.get("device", "cpu"))
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    layout = MeshLayout(tuple(case["axes"]), tuple(case["sizes"]))
    device_mesh = layout.device_mesh(dev.type)
    out = {}
    if case.get("roundtrip"):
        out["roundtrip"] = roundtrip(cfg, opt, case["n"], layout,
                                     device_mesh)
        return out
    steps = {topo: make_train_step(cfg, opt, hp,
                                   microbatch=case["microbatch"],
                                   do_topology=topo, mesh=device_mesh)
             for topo in (True, False)}
    state = distribute_train_state(initial_state(cfg, opt, case["n"], dev),
                                   layout, device_mesh, cfg)
    kernels.reset_launches()
    out["record"], state = run(steps, state, cfg, case)
    out["launches"] = launches()
    full = gather_train_state(state)
    out["params"] = numpy_tree(flatten(full.params))
    out["count"] = full.opt_state["count"].cpu().numpy()
    if case.get("single") and torch.distributed.get_rank() == 0:
        steps = {topo: make_train_step(cfg, opt, hp,
                                       microbatch=case["microbatch"],
                                       do_topology=topo)
                 for topo in (True, False)}
        kernels.reset_launches()
        record, state = run(steps, initial_state(cfg, opt, case["n"], dev),
                            cfg, case)
        out["single"] = {"record": record, "launches": launches(),
                         "params": numpy_tree(flatten(state.params))}
    return out


def launches():
    from repro_torch.kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def launcher(case):
    """``repro_torch.launch.train.main(case['argv'])`` in this rank, with
    ``make_production_mesh`` standing for the case's layout: (exit code,
    what it printed)."""
    import contextlib
    import io
    from repro_torch.launch import train
    train.make_production_mesh = lambda multi_pod=False: MeshLayout(
        tuple(case["axes"]), tuple(case["sizes"]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = train.main(case["argv"])
    return {"launcher": (code, out.getvalue())}


def rank_main(cases):
    """Every case in turn on this rank."""
    return [launcher(c) if "argv" in c else one_case(c) for c in cases]
