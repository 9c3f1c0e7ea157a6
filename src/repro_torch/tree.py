"""Parameter trees: nested dicts of arrays <-> flat ordered dicts of tensors.

The port stores a model (or a node-stacked population of models) as an
``OrderedDict[str, Tensor]`` keyed by dotted paths such as ``"conv1.w"``.
The order is ``jax.tree_util.tree_leaves`` order — dict keys sorted at
every level — because Eq. 3 averages its per-leaf cosines in leaf order
(``repro.core.similarity.pairwise_model_similarity``) and the parity tests
compare leaf for leaf.  Layouts are kept as the reference stores them
(conv weights HWIO, ``fc.w`` in NHWC-flatten row order), so carrying
weights across is a copy.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str, out: list) -> None:
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _flatten(value, path + ".", out)
        else:
            out.append((path, value))


def params_from_jax(np_tree: Mapping, device="cpu"
                    ) -> "OrderedDict[str, torch.Tensor]":
    """Nested dict of arrays (a reference pytree, already on the host as
    numpy) -> ``OrderedDict`` of tensors on ``device`` in leaf order."""
    leaves: list = []
    _flatten(np_tree, "", leaves)
    return OrderedDict(
        (path, torch.as_tensor(np.array(value), device=device))
        for path, value in leaves)


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: ``{"conv1": {"w": ndarray}}``."""
    out: dict = {}
    for path, tensor in params.items():
        node = out
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = tensor.detach().cpu().numpy()
    return out


def stack(trees) -> "OrderedDict[str, torch.Tensor]":
    """Stack per-node trees on a new leading node axis ``[n, ...]``."""
    trees = list(trees)
    return OrderedDict((k, torch.stack([t[k] for t in trees]))
                       for k in trees[0])
