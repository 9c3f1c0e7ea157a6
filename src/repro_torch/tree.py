"""Parameter trees: nested dicts (and tuples) of arrays <-> flat ordered
dicts of tensors.

The port stores a model (or a node-stacked population of models) as an
``OrderedDict[str, Tensor]`` keyed by dotted paths such as ``"conv1.w"``.
The order is ``jax.tree_util.tree_leaves`` order — dict keys sorted at
every level, tuple elements in index order — because Eq. 3 averages its
per-leaf cosines in leaf order
(``repro.core.similarity.pairwise_model_similarity``) and the parity tests
compare leaf for leaf.  A tuple element's path segment is its index (the
model zoo's ``"body.0.mixer.in_proj.w"``).  Layouts are kept as the
reference stores them (conv weights HWIO, ``fc.w`` in NHWC-flatten row
order, the zoo's period-stacked body leaves), so carrying weights across
is a copy.  The model zoo (:mod:`repro_torch.models.transformer`) keeps
its parameters and caches nested, as the reference does:
:func:`unflatten` and :func:`flatten` convert.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Mapping

import numpy as np
import torch


def _children(tree):
    if isinstance(tree, Mapping):
        return [(str(key), tree[key]) for key in sorted(tree)]
    return [(str(i), value) for i, value in enumerate(tree)]


def _flatten(tree, prefix: str, out: list) -> None:
    for key, value in _children(tree):
        path = f"{prefix}{key}"
        if isinstance(value, (Mapping, tuple, list)):
            _flatten(value, path + ".", out)
        else:
            out.append((path, value))


def flatten(tree) -> "OrderedDict[str, object]":
    """Nested dicts and tuples -> ``OrderedDict`` of leaves by dotted path,
    in ``jax.tree_util.tree_leaves`` order.  Empty dicts and tuples have
    no leaves and vanish, as they do in JAX."""
    leaves: list = []
    _flatten(tree, "", leaves)
    return OrderedDict(leaves)


def unflatten(flat: Mapping[str, object]):
    """Inverse of :func:`flatten`: a node whose keys are all indices
    ``0 .. k - 1`` becomes a tuple."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _tuples(root)


def _tuples(node):
    if not isinstance(node, dict):
        return node
    out = {key: _tuples(value) for key, value in node.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return tuple(out[str(i)] for i in range(len(out)))
    return out


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of nested dicts and tuples, keeping the
    structure."""
    if isinstance(tree, Mapping):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, value) for value in tree)
    return fn(tree)


def params_from_jax(np_tree: Mapping, device="cpu"
                    ) -> "OrderedDict[str, torch.Tensor]":
    """Nested dicts and tuples of arrays (a reference pytree, already on the
    host as numpy) -> ``OrderedDict`` of tensors on ``device`` in leaf
    order."""
    return OrderedDict(
        (path, torch.as_tensor(np.array(value), device=device))
        for path, value in flatten(np_tree).items())


def train_state_from_jax(params: Mapping, opt_state: Mapping,
                         morph: Mapping, device="cpu", seed: int = 0):
    """A reference ``TrainState`` (``repro.dlrt.distributed``), its arrays
    already on the host as numpy, as the port's
    :class:`~repro_torch.dlrt.distributed.TrainState` on ``device``:
    ``params`` a nested tree of node-stacked leaves; ``opt_state`` the
    optimizer's dict (``count`` ``[n]``, and moment trees such as ``mu``,
    ``m`` and ``v``, each made a flat dict in leaf order); ``morph`` the
    controller's ``known``, ``sim``, ``sim_valid`` and ``edges``.  The
    reference's PRNG key has no torch counterpart: the state's generator
    is seeded with ``seed``, and a parity test hands the step the
    reference's draws (``MorphNoise``) instead."""
    from .core.morph import MorphGraphState
    from .dlrt.distributed import TrainState
    opt = {}
    for key, value in opt_state.items():
        opt[key] = (params_from_jax(value, device)
                    if isinstance(value, (Mapping, tuple, list))
                    else torch.as_tensor(np.array(value), device=device))
    fields = [torch.as_tensor(np.array(morph[f]), device=device)
              for f in ("known", "sim", "sim_valid", "edges")]
    return TrainState(unflatten(params_from_jax(params, device)), opt,
                      MorphGraphState(*fields,
                                      generator=torch.Generator()
                                      .manual_seed(seed)))


def params_to_numpy(params: Mapping[str, torch.Tensor]):
    """Inverse of :func:`params_from_jax`: ``{"conv1": {"w": ndarray}}``,
    with tuples where the reference has them."""
    return unflatten(OrderedDict(
        (path, tensor.detach().cpu().numpy())
        for path, tensor in params.items()))


def stack(trees) -> "OrderedDict[str, torch.Tensor]":
    """Stack per-node trees on a new leading node axis ``[n, ...]``."""
    trees = list(trees)
    return OrderedDict((k, torch.stack([t[k] for t in trees]))
                       for k in trees[0])
