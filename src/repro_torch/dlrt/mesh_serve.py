"""The zoo's serve step and prefill on a device mesh (port-owned): the
counterpart of the reference's dry run jitting ``make_serve_step(cfg,
kv_spec=serve_kv_spec(...))`` with ``(params_sharding, cache_sharding,
tokens, replicated)`` in, and its prefill (a vmapped ``forward(...,
last_only=True)``) with ``params_sharding`` (``repro.launch.dryrun``).

State.  :func:`distribute_params` and :func:`distribute_cache` make every
leaf a DTensor under its :func:`~.distributed.params_sharding` or
:func:`~.distributed.cache_sharding` spec, cut from the full tensors every
rank holds (``jax.device_put``); :func:`init_mesh_caches` allocates only
this rank's blocks of fresh caches (a production cache does not fit one
card whole); :func:`gather_tree` gives the full tensors back on every
rank (``jax.device_get``).

A decode step (:func:`make_mesh_serve_step`, reached through
``make_serve_step(..., mesh=device_mesh)``), on each rank:

1. the tokens ``[n, b, 1]`` as the dry run lays them out (the first two
   entries of :func:`~.distributed.batch_sharding`): this rank's nodes
   and batch rows;
2. node by node, ``gather``: the node's leaves whole over the axes that
   split their bodies (:func:`~.mesh_step.gather_whole`; between steps the
   parameters stay under ``params_sharding``);
3. ``decode``: ``model.decode_step`` on this rank's blocks of the node's
   cache, which every mixer updates in place and reads where it lies
   (:class:`~repro_torch.models.shards.CacheShards`: the new token's k and
   v, or SSM and WKV inputs, computed whole; the partial logits of a
   head_dim split summed over ``model``, each mixer's token-sized output
   gathered); a MoE MLP routes the node's whole batch where the batch is
   split.  No collective carries a block of a cache;
4. ``collect``: the logits ``[n, b, 1, vocab]`` gathered over the batch's
   and the node's axes to every rank.

The prefill (:func:`make_mesh_prefill_step`, ``make_prefill_step(...,
mesh=)``) gathers each of its nodes' leaves the same way, runs
``forward(..., last_only=True)`` on its batch shard (the MoE layers
routing the node's whole batch) and collects the logits.  On a mesh whose
axes are all of size 1 every spec is replicated, and both make the
one-device step's calls in the same shapes: the same bits.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..collectives import packed_all_gather
from ..launch.mesh import MeshGroups
from ..models import model
from ..models.shards import CacheShards
from ..tree import flatten, tree_map, unflatten
from .distributed import (META, _entry_axes, _to_device, _unstaged,
                          batch_sharding, cache_sharding, init_node_caches,
                          params_sharding, placements, shard_shape)
from .mesh_step import (_dim_axes, _map_leaves, _map_sharded, _nontrivial,
                        _shard, body_dims, gather_whole, row_shards)


def _put(device_mesh, layout, mesh):
    from torch.distributed.tensor import DTensor

    def put(t, spec):
        local = _shard(t, spec, mesh)
        if local is not t:
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, device_mesh,
                                  placements(spec, layout), run_check=False)
    return put


def _coords(layout, device_mesh) -> MeshGroups:
    mesh = MeshGroups(device_mesh, flattened=False)
    if mesh.layout != layout:
        raise ValueError(f"the device mesh is {dict(mesh.layout.shape)}, "
                         f"the layout {dict(layout.shape)}")
    return mesh


def distribute_params(params, layout, device_mesh, cfg):
    """Node-stacked ``params`` (full tensors, the same on every rank, on
    this rank's device) as DTensors on ``device_mesh`` under
    :func:`~.distributed.params_sharding`: a leaf's local tensor is this
    rank's block (a copy where the spec splits it, the leaf itself where
    it is replicated)."""
    mesh = _coords(layout, device_mesh)
    return _map_sharded(_put(device_mesh, layout, mesh), params,
                        params_sharding(layout, cfg, params))


def distribute_cache(cache, layout, device_mesh, cfg):
    """Node-stacked decode caches (:func:`~.distributed.init_node_caches`)
    as DTensors under :func:`~.distributed.cache_sharding`."""
    mesh = _coords(layout, device_mesh)
    return _map_sharded(_put(device_mesh, layout, mesh), cache,
                        cache_sharding(layout, cfg, cache))


def init_mesh_caches(cfg, n_nodes: int, batch: int, max_len: int, layout,
                     device_mesh, dtype=None, device="cuda"):
    """Fresh node-stacked decode caches as DTensors under
    :func:`~.distributed.cache_sharding` on ``device_mesh``, each rank
    allocating only its own blocks (zeros of the leaf's
    :func:`~.distributed.shard_shape`) on ``device`` (the card unless the
    caller asks for the CPU)."""
    from torch.distributed.tensor import DTensor
    dev = resolve_device(device)
    _coords(layout, device_mesh)
    shape = init_node_caches(cfg, n_nodes, batch, max_len, dtype,
                             device=META)

    def block(leaf, spec):
        local = torch.zeros(shard_shape(tuple(leaf.shape), spec, layout),
                            dtype=leaf.dtype, device=dev)
        return DTensor.from_local(local, device_mesh,
                                  placements(spec, layout), run_check=False)
    return _map_sharded(block, shape, cache_sharding(layout, cfg, shape))


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` (nested dicts and tuples, all on one
    mesh) as its full tensor, on every rank, bit for bit: each split dim
    gathered over its axes, innermost axis first, one packed
    ``all_gather`` an axis for all the leaves (a collective: every rank
    calls it).  Other leaves come back as they are."""
    flat = flatten(tree)
    split = OrderedDict((k, v) for k, v in flat.items()
                        if hasattr(v, "device_mesh"))
    if not split:
        return tree
    mesh = MeshGroups(next(iter(split.values())).device_mesh,
                      flattened=False)
    full = gather_whole(mesh, OrderedDict(
        (k, v.to_local()) for k, v in split.items()), OrderedDict(
            (k, _dim_axes(v, mesh.names)) for k, v in split.items()))
    flat.update(full)
    return unflatten(flat)


# ---------------------------------------------------------------------------
# The steps.
# ---------------------------------------------------------------------------

class _Layout:
    """A call's layout: this rank's nodes and batch rows, the node's
    leaves with their split axes, the collect of the logits and, given the
    caches, their blocks and :class:`CacheShards`.  A node's parameters,
    where no axis splits their bodies, and its cache blocks are views,
    made once."""

    def __init__(self, mesh: MeshGroups, cfg, params, n: int, b: int,
                 cache=None):
        spec = batch_sharding(mesh.layout, cfg, n, b).spec
        self.mesh = mesh
        self.node_ax = _nontrivial(mesh, _entry_axes(spec[0]))
        self.batch_ax = _nontrivial(mesh, _entry_axes(spec[1]))
        flat = flatten(params)
        self.dims = OrderedDict((k, _dim_axes(v, mesh.names))
                                for k, v in flat.items())
        for k, ds in self.dims.items():
            if _nontrivial(mesh, ds.get(0, ())) != self.node_ax:
                raise ValueError(f"{k}: node axis over {ds.get(0, ())}, the "
                                 f"tokens' over {self.node_ax}")
        self.local = OrderedDict((k, v.to_local()) for k, v in flat.items())
        self.shards = mesh.size(self.node_ax)
        self.n_local = n // self.shards
        self.off = mesh.index(self.node_ax) * self.n_local
        self.b_local = b // mesh.size(self.batch_ax)
        self.b0 = mesh.index(self.batch_ax) * self.b_local
        self.rows = row_shards(mesh, self.batch_ax, None)
        self.node_dims = body_dims(self.dims)
        self.whole = not any(self.node_dims.values())
        self._nodes, self._blocks = {}, {}
        if cache is not None:
            self.blocks = _map_leaves(lambda t: t.to_local(), cache)
            self.shards_of_cache = _cache_shards(mesh, cache, self)

    def mine(self, t: torch.Tensor, dev) -> torch.Tensor:
        """This rank's nodes and rows of ``[n, b, ...]``."""
        return _to_device(t[self.off:self.off + self.n_local,
                            self.b0:self.b0 + self.b_local], dev)

    def node(self, j: int):
        """Node ``off + j``'s parameters whole (the ``gather``)."""
        if j in self._nodes:
            return self._nodes[j]
        got = unflatten(gather_whole(self.mesh, OrderedDict(
            (k, v[j]) for k, v in self.local.items()), self.node_dims))
        if self.whole:
            self._nodes[j] = got
        return got

    def node_cache(self, j: int):
        """Node ``off + j``'s blocks of the caches (views)."""
        if j not in self._blocks:
            self._blocks[j] = tree_map(lambda v: v[j], self.blocks)
        return self._blocks[j]

    def collect(self, x: torch.Tensor) -> torch.Tensor:
        """``[n_local, b_local, ...]`` of every rank as ``[n, b, ...]``."""
        mesh = self.mesh
        if self.batch_ax:
            got, = packed_all_gather([x], mesh.size(self.batch_ax),
                                     mesh.group(self.batch_ax))
            x = got.movedim(0, 1).reshape((x.shape[0], -1) + x.shape[2:])
        if self.node_ax:
            got, = packed_all_gather([x], self.shards,
                                     mesh.group(self.node_ax))
            x = got.reshape((-1,) + x.shape[1:])
        return x


def _cache_shards(mesh: MeshGroups, cache, lay: _Layout
                  ) -> Optional[CacheShards]:
    """The serve step's :class:`CacheShards` for ``cache`` (DTensors under
    ``cache_sharding``): each leaf's dim split over a feature axis, in
    its block's coordinates; None where nothing is split (every axis of
    size 1), so that the step is the one-device step's calls."""
    feature = set()

    def dims_of(t, lead):
        ds = _dim_axes(t, mesh.names)
        if _nontrivial(mesh, ds.get(0, ())) != lay.node_ax \
                or _nontrivial(mesh, ds.get(lead, ())) != lay.batch_ax:
            raise ValueError(
                f"a cache leaf {tuple(t.shape)} lies over {ds}; the tokens' "
                f"nodes over {lay.node_ax} and rows over {lay.batch_ax}")
        split = [(d, _nontrivial(mesh, ax)) for d, ax in ds.items()
                 if d > lead and _nontrivial(mesh, ax)]
        if not split:
            return None
        if len(split) > 1 or any(0 < d < lead for d in ds):
            raise NotImplementedError(f"a cache leaf split as {ds}")
        feature.add(split[0][1])
        return split[0][0] - lead

    dims = {"prefix": tuple(tree_map(lambda t: dims_of(t, 1), c)
                            for c in cache["prefix"]),
            "body": tuple(tree_map(lambda t: dims_of(t, 2), c)
                          for c in cache["body"])}
    if len(feature) > 1:
        raise NotImplementedError(f"cache features split over {feature}")
    if not feature:
        return None
    axes, = feature
    return CacheShards(mesh.group(axes), mesh.size(axes), mesh.index(axes),
                       dims)


def make_mesh_serve_step(cfg, *, window, device_mesh, kv_spec=None):
    """The serve step over ``device_mesh`` (see the module docstring):
    ``serve_step(params, cache, tokens, pos, stage=None) -> (logits,
    cache)`` on :func:`distribute_params` parameters and
    :func:`init_mesh_caches` (or :func:`distribute_cache`) caches, updated
    in place; ``tokens [n, b, 1]``, the same on every rank; ``logits [n,
    b, 1, vocab]`` f32, the same on every rank; ``stage(name, fn)`` runs
    ``gather``, ``decode`` and ``collect``.  ``kv_spec``, where given,
    must be :func:`~.distributed.serve_kv_spec` of the mesh, the config
    and the call's batch (a call raises ValueError otherwise).  Every
    rank builds the step at once."""
    from .distributed import serve_kv_spec
    mesh = MeshGroups(device_mesh)
    held = []

    def layout_of(params, cache, n, b) -> _Layout:
        """The call's :class:`_Layout`, kept while the same parameter and
        cache leaves come back: reading a hundred DTensors' placements and
        local tensors is milliseconds of host time a step."""
        leaves = [*flatten(params).values(), *flatten(cache).values()]
        if held and held[0] == (n, b) and len(held[1]) == len(leaves) \
                and all(a is c for a, c in zip(held[1], leaves)):
            return held[2]
        held[:] = [(n, b), leaves, _Layout(mesh, cfg, params, n, b, cache)]
        return held[2]

    def serve_step(params, cache, tokens, pos: int,
                   stage: Optional[Callable] = None):
        stage = stage or _unstaged
        n, b = tokens.shape[:2]
        if kv_spec is not None and kv_spec != serve_kv_spec(
                mesh.layout, cfg, b):
            raise ValueError(f"kv_spec {kv_spec} is not serve_kv_spec of the "
                             f"mesh at batch {b}: "
                             f"{serve_kv_spec(mesh.layout, cfg, b)}")
        lay = layout_of(params, cache, n, b)
        dev = next(iter(lay.local.values())).device
        mine = lay.mine(tokens, dev)
        logits = []
        for j in range(lay.n_local):
            p = stage("gather", lambda: lay.node(j))
            logits.append(stage("decode", lambda: model.decode_step(
                p, lay.node_cache(j), mine[j], pos, cfg, window=window,
                shards=lay.shards_of_cache, rows=lay.rows)[0]))
            del p
        return stage("collect", lambda: lay.collect(torch.stack(logits))), \
            cache

    return serve_step


def make_mesh_prefill_step(cfg, *, window, device_mesh):
    """The prefill over ``device_mesh``: ``prefill(params, batch,
    stage=None) -> logits [n, b, 1, vocab]`` (f32, the same on every
    rank) on :func:`distribute_params` parameters; ``batch``: every
    node's whole inputs (``tokens [n, b, s]``, a frontend's ``frames`` or
    ``patch_embeds``), the same on every rank; stages ``gather``,
    ``prefill`` and ``collect``.  Every rank builds it at once."""
    mesh = MeshGroups(device_mesh)

    def prefill(params, batch, stage: Optional[Callable] = None):
        stage = stage or _unstaged
        n, b = batch["tokens"].shape[:2]
        lay = _Layout(mesh, cfg, params, n, b)
        dev = next(iter(lay.local.values())).device
        mine = {k: lay.mine(v, dev) for k, v in batch.items()}
        logits = []
        with torch.no_grad():
            for j in range(lay.n_local):
                p = stage("gather", lambda: lay.node(j))
                logits.append(stage("prefill", lambda: model.forward(
                    p, {k: v[j] for k, v in mine.items()}, cfg,
                    window=window, last_only=True, rows=lay.rows)[0]))
                del p
            return stage("collect", lambda: lay.collect(
                torch.stack(logits)))

    return prefill
