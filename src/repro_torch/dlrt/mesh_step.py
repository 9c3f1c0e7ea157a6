"""The zoo's train step on a device mesh (port-owned): the counterpart of
the reference's launcher putting a :class:`~.distributed.TrainState` under
``train_state_sharding`` and jitting the train step with those shardings
in and out (``repro.launch.train`` ``--mesh``).

State.  :func:`distribute_train_state` makes every parameter and optimizer
leaf a DTensor on the ``DeviceMesh`` with the placements of its
:func:`~.distributed.train_state_sharding` spec, cut from the full tensor
every rank holds (no collective): the counterpart of ``jax.device_put``.
The controller state stays plain tensors, a copy on every rank (the
reference replicates it).  :func:`gather_train_state` gives the full
tensors back on every rank (``jax.device_get``).

The step (:func:`make_mesh_train_step`, reached through
``make_train_step(..., mesh=device_mesh)``).  XLA partitions the
reference's step and names no collective; here each rank computes the same
function on its shards and meets the others in explicit collectives over
the mesh's axis groups (:class:`~repro_torch.launch.mesh.MeshGroups`).
A round, on each rank:

1. batch: this rank's nodes and batch shard, as
   :func:`~.distributed.batch_sharding` lays them out (``node_dp``: nodes
   over the node axes, the batch replicated over ``model``; ``node_fsdp``:
   nodes replicated or over ``pod``, each node's batch over ``data``);
2. node by node (its own nodes; all n where the node axis is
   replicated): ``gather`` the node's leaves whole over the axes that
   split their bodies (one packed ``all_gather`` an axis), the local
   step's ``forward_backward`` on the batch shard (``microbatch`` counts
   pieces of the node's whole batch), ``reduce``: the gradient averaged
   over the batch's axes and cut to the leaf's layout (a reduce-scatter
   where the batch's axis splits the leaf, else an all-reduce and a cut;
   where the batch is replicated, a cut and no collective), and
   ``update`` on the shards, each gradient handed to the optimizer as a
   DTensor so that ``global_norm`` sums the whole leaf;
3. the optimizer's leaves replicated over the node axes (the ``[n]``
   counts) gathered from their owners, so every rank advances every
   node's;
4. on a topology round, ``similarity``: the population gathered over the
   node axes where they split it (one packed ``all_gather``), each leaf's
   Gram on this rank's body shard through the Gram kernel
   (:func:`~repro_torch.kernels.ops.leaf_grams`), the partial Grams summed
   over exactly the axes that split that leaf's body (one all-reduce a set
   of axes), Eq. 3's epilogue, and rank 0's ``[n, n]`` broadcast so that
   every rank negotiates on the same bits; then the ``controller``;
5. ``mix``: where every node is local (the node axis replicated, or its
   axes of size 1), the masked mix over this rank's body shards, exactly
   as the one-device step runs it; else this rank's rows of the uniform
   W (``[n_local, n]``) times the gathered population through
   ``graph_mix``, as the sharded superstep's gather schedule does.  No
   collective follows the mix;
6. metrics: each node's loss averaged over the batch's axes, gathered
   over the node axes, and rank 0's broadcast.

A node's forward and backward hold its whole leaves (ZeRO-3 style over the
body axes): a node must fit on one card.  On a mesh whose axes are all of
size 1 every spec is replicated and the step is the one-device step's
bits, its kernels launched as often.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..collectives import packed_all_gather, reduce_scatter_into
from ..core.mixing import uniform_weights_torch
from ..core.morph import MorphNoise, update_topology
from ..kernels import ops
from ..launch.mesh import MeshGroups
from ..models.shards import RowShards
from ..optim import Optimizer, apply_updates
from ..tree import flatten
from .distributed import (MIX_GROUP_BYTES, NamedSharding, TrainState,
                          _entry_axes, _to_device, _unstaged,
                          batch_sharding, placements, train_state_sharding)

# ---------------------------------------------------------------------------
# DTensor state.
# ---------------------------------------------------------------------------

def _shard(t: torch.Tensor, spec, mesh: MeshGroups) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``."""
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            size = t.shape[d] // mesh.size(axes)
            t = t.narrow(d, mesh.index(axes) * size, size)
    return t


def _map_sharded(fn, tree, sharding):
    """``fn(leaf, spec)`` over a state's tensors beside their shardings,
    keeping the structure (a mapping's type too)."""
    if isinstance(sharding, NamedSharding):
        return fn(tree, sharding.spec)
    if isinstance(tree, Mapping):
        return type(tree)((k, _map_sharded(fn, v, sharding[k]))
                          for k, v in tree.items())
    return type(tree)(_map_sharded(fn, v, s) for v, s in zip(tree, sharding))


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return type(tree)((k, _map_leaves(fn, v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def distribute_train_state(state: TrainState, layout, device_mesh, cfg
                           ) -> TrainState:
    """``state`` (full tensors, the same on every rank, on this rank's
    device) with every parameter and optimizer leaf a DTensor on
    ``device_mesh`` (made from ``layout``) under its
    :func:`~.distributed.train_state_sharding` spec: its local tensor this
    rank's block (a copy where the spec splits it, the leaf itself where
    it is replicated), its local shape :func:`~.distributed.shard_shape`.
    Morph's tensors stay as they are, a copy on every rank."""
    from torch.distributed.tensor import DTensor
    mesh = MeshGroups(device_mesh, flattened=False)
    if mesh.layout != layout:
        raise ValueError(f"the device mesh is {dict(mesh.layout.shape)}, "
                         f"the layout {dict(layout.shape)}")
    sh = train_state_sharding(layout, cfg, state)

    def put(t, spec):
        local = _shard(t, spec, mesh)
        if local is not t:
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, device_mesh,
                                  placements(spec, layout), run_check=False)
    return TrainState(_map_sharded(put, state.params, sh.params),
                      _map_sharded(put, state.opt_state, sh.opt_state),
                      state.morph)


def gather_train_state(state: TrainState) -> TrainState:
    """Every DTensor leaf of ``state`` as its full tensor, on every rank (a
    collective: every rank calls it)."""
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return TrainState(_map_leaves(full, state.params),
                      _map_leaves(full, state.opt_state), state.morph)


# ---------------------------------------------------------------------------
# The step.
# ---------------------------------------------------------------------------

def _dim_axes(t, names) -> Dict[int, Tuple[str, ...]]:
    """A DTensor's dims split over mesh axes: dim -> axes, mesh order."""
    out: Dict[int, Tuple[str, ...]] = {}
    for name, p in zip(names, t.placements):
        if p.is_shard():
            out[p.dim] = out.get(p.dim, ()) + (name,)
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _nontrivial(mesh: MeshGroups, axes) -> Tuple[str, ...]:
    return tuple(a for a in axes if mesh.size((a,)) > 1)


def gather_whole(mesh: MeshGroups, blocks, dims):
    """Tensors whole from this rank's ``blocks`` (by key; ``dims``: each
    one's split dims -> axes, in its own coordinates): each split dim
    gathered over its axes, innermost axis first, one packed
    ``all_gather`` an axis.  A tensor nothing splits is returned as it
    is."""
    full = OrderedDict(blocks)
    for axis in reversed(mesh.names):
        keys = [k for k, ds in dims.items()
                if any(axis in axes for axes in ds.values())]
        if not keys:
            continue
        got = packed_all_gather([full[k] for k in keys],
                                mesh.size((axis,)), mesh.group((axis,)))
        for k, g in zip(keys, got):
            d = next(d for d, axes in dims[k].items() if axis in axes)
            shape = list(full[k].shape)
            shape[d] *= g.shape[0]
            full[k] = g.movedim(0, d).reshape(shape)
    return full


def body_dims(dims):
    """Each leaf's split dims past the node's, in a node row's
    coordinates."""
    return OrderedDict((k, {d - 1: axes for d, axes in ds.items() if d})
                       for k, ds in dims.items())


def row_shards(mesh: MeshGroups, batch_ax, piece: Optional[int]
               ) -> Optional[RowShards]:
    """The MoE layers' routing batch where ``batch_ax`` splits a node's
    batch (None where it does not): the node's whole batch, routed in
    pieces of ``piece`` rows (None: at once)."""
    if mesh.size(batch_ax) == 1:
        return None
    return RowShards(mesh.group(batch_ax), mesh.size(batch_ax),
                     mesh.index(batch_ax), piece)


def make_mesh_train_step(cfg, optimizer: Optimizer, hp, node_grads: Callable,
                         *, microbatch: Optional[int], do_topology: bool,
                         device_mesh):
    """The train step over ``device_mesh`` (see the module docstring):
    ``train_step(state, batch, noise=None, stage=None) -> (state,
    metrics)`` on a :func:`distribute_train_state` state, updated in place
    and returned.  ``batch`` is every node's whole batch (``[n, B, ...]``,
    the same on every rank); ``noise`` and the metrics as the one-device
    step's, the metrics the same bits on every rank; ``stage`` also sees
    ``gather`` and ``reduce``.  ``node_grads(p, b, microbatch, rows)`` is the
    one-device step's local step (``rows``: the MoE layers' routing
    batch, :func:`row_shards`).  Every rank builds the step at once (it
    makes the mesh's process groups)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = MeshGroups(device_mesh)
    names = mesh.names

    def reduce(grads, loss, dims, batch_ax):
        """Each gradient averaged over ``batch_ax`` and cut to its leaf's
        body layout; the loss averaged."""
        k = mesh.size(batch_ax)
        group = mesh.group(batch_ax)
        out = OrderedDict()
        for key, g in grads.items():
            scatter = None
            for d, axes in dims[key].items():
                if not d:
                    continue
                if batch_ax and tuple(axes) == mesh.order(batch_ax):
                    scatter = d - 1
                    continue
                size = g.shape[d - 1] // mesh.size(axes)
                g = g.narrow(d - 1, mesh.index(axes) * size, size)
            if batch_ax:
                if scatter is None:
                    g = g.contiguous()
                    dist.all_reduce(g, group=group)
                else:
                    x = g.movedim(scatter, 0).contiguous()
                    y = x.new_empty((x.shape[0] // k,) + x.shape[1:])
                    reduce_scatter_into(y, x, group=group)
                    g = y.movedim(0, scatter).contiguous()
                if k > 1:
                    g = g / k
            out[key] = g
        if batch_ax:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            if k > 1:
                loss = loss / k
        return out, loss

    def sharded_grads(grads, dims, submesh, sub_names):
        """The gradients as DTensors on the mesh without the node axes, so
        that ``global_norm`` sums each leaf whole."""
        if submesh is None:
            return grads
        out = OrderedDict()
        for key, g in grads.items():
            where = {a: d - 1 for d, axes in dims[key].items() if d
                     for a in axes}
            out[key] = DTensor.from_local(
                g, submesh, [Shard(where[a]) if a in where else Replicate()
                             for a in sub_names], run_check=False)
        return out

    def similarity(pop, dims):
        grams = ops.leaf_grams(pop)
        sets: Dict[Tuple[str, ...], List[int]] = OrderedDict()
        for l, ds in enumerate(dims.values()):
            axes = mesh.order({a for d, ax in ds.items() if d for a in ax})
            if axes:
                sets.setdefault(axes, []).append(l)
        for axes, idx in sets.items():
            part = grams[idx].contiguous()
            dist.all_reduce(part, group=mesh.group(axes))
            grams[idx] = part
        sim = ops.cosine_from_grams(grams).contiguous()
        dist.broadcast(sim, src=0)
        return sim

    def train_step(state: TrainState, batch,
                   noise: Optional[MorphNoise] = None,
                   stage: Optional[Callable] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        stage = stage or _unstaged
        params = flatten(state.params)
        dims = OrderedDict((k, _dim_axes(v, names))
                           for k, v in params.items())
        node_dims = body_dims(dims)
        local = OrderedDict((k, v.to_local()) for k, v in params.items())
        n = next(iter(params.values())).shape[0]
        dev = next(iter(local.values())).device
        B = batch["tokens"].shape[1]
        spec = batch_sharding(mesh.layout, cfg, n, B).spec
        node_ax = _nontrivial(mesh, _entry_axes(spec[0]))
        batch_ax = _entry_axes(spec[1])
        for k, ds in dims.items():
            if _nontrivial(mesh, ds.get(0, ())) != node_ax:
                raise ValueError(f"{k}: node axis over {ds.get(0, ())}, the "
                                 f"batch's over {node_ax}")
        shards = mesh.size(node_ax)
        n_local = n // shards
        off = mesh.index(node_ax) * n_local
        b_local = B // mesh.size(batch_ax)
        b0 = mesh.index(batch_ax) * b_local
        mb = microbatch
        if mb is not None:
            if B % mb:
                raise ValueError(f"batch {B} not divisible by microbatch "
                                 f"{mb}")
            # Pieces of the node's batch; where they straddle this rank's
            # shard, the shard is one piece (the same mean gradient).
            mb = mb if b_local % mb == 0 else None
        # Where no piece lies on this rank alone, the MoE layers route the
        # node's whole batch (or each whole piece) across the batch's axes.
        routing = None if mb is not None else row_shards(mesh, batch_ax,
                                                         microbatch)
        mine = stage("batch", lambda: {
            k: _to_device(v[off:off + n_local, b0:b0 + b_local], dev)
            for k, v in batch.items()})
        opt_local = _map_leaves(_local, state.opt_state)
        # An optimizer leaf's node row: local where its node dim is split.
        opt_split = _map_leaves(lambda t: bool(_nontrivial(
            mesh, _dim_axes(t, names).get(0, ()))), state.opt_state)
        sub_names = tuple(a for a in names if a not in node_ax)
        submesh = (None if not sub_names else device_mesh
                   if sub_names == names else device_mesh[sub_names])

        def node_opt(i, j):
            return {key: (v[j if opt_split[key] else i]
                          if isinstance(v, torch.Tensor) else
                          OrderedDict((p, t[j if opt_split[key][p] else i])
                                      for p, t in v.items()))
                    for key, v in opt_local.items()}

        def set_node_opt(i, j, new):
            for key, v in new.items():
                if isinstance(v, torch.Tensor):
                    opt_local[key][j if opt_split[key] else i] = v
                else:
                    for p, t in v.items():
                        opt_local[key][p][j if opt_split[key][p]
                                          else i].copy_(t)

        losses = []
        for j in range(n_local):
            i = off + j
            rows = OrderedDict((k, v[j]) for k, v in local.items())
            full = stage("gather", lambda: gather_whole(mesh, rows,
                                                        node_dims))
            p_i = OrderedDict((k, v.detach().requires_grad_())
                              for k, v in full.items())
            grads, loss = stage("forward_backward", lambda: node_grads(
                p_i, {k: v[j] for k, v in mine.items()}, mb, routing))
            del p_i, full
            grads, loss = stage("reduce", lambda: reduce(grads, loss, dims,
                                                         batch_ax))
            losses.append(loss)

            def update():
                with torch.no_grad():
                    node = OrderedDict((k, v.detach())
                                       for k, v in rows.items())
                    upd, new_state = optimizer.update(
                        sharded_grads(grads, dims, submesh, sub_names),
                        node_opt(i, j), node)
                    for k in list(upd):
                        rows[k].copy_(apply_updates({k: node[k]},
                                                    {k: upd.pop(k)})[k])
                    set_node_opt(i, j, new_state)
            stage("update", update)
            del grads
        with torch.no_grad():
            if shards > 1:
                # Replicated optimizer leaves (the counts): from their owners.
                def regather(t, split):
                    if not split:
                        got, = packed_all_gather([t[off:off + n_local]],
                                                 shards, mesh.group(node_ax))
                        t.copy_(got.reshape(t.shape))
                _map_leaves_pair(regather, opt_local, opt_split)
            morph = state.morph
            pop = local
            if n > 1 and shards > 1:
                pop = stage("gather", lambda: OrderedDict(
                    (k, g.reshape((n,) + g.shape[2:])) for k, g in zip(
                        local, packed_all_gather(list(local.values()),
                                                 shards,
                                                 mesh.group(node_ax)))))
            if n > 1:
                if do_topology:
                    sim = stage("similarity", lambda: similarity(pop, dims))
                    morph = stage("controller", lambda: update_topology(
                        state.morph, sim, k=min(hp.k, n - 1),
                        view_size=min(hp.view_size, n - 1), beta=hp.beta,
                        noise=noise))
                stage("mix", lambda: _mix(morph.edges, pop, local, off,
                                          n_local, shards))
            per_node = torch.stack(losses)
            if shards > 1:
                per_node = packed_all_gather([per_node], shards,
                                             mesh.group(node_ax))[0]
                per_node = per_node.reshape(n)
            dist.broadcast(per_node, src=0)
        metrics = {"loss": per_node.mean(), "per_node_loss": per_node}
        return TrainState(state.params, state.opt_state, morph), metrics

    return train_step


def _map_leaves_pair(fn, tree, other):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _map_leaves_pair(fn, v, other[k])
    else:
        fn(tree, other)


def _mix(edges, pop, local, off, n_local, shards):
    """The round's mix into this rank's rows (see the module docstring)."""
    if shards == 1:
        return ops.mix_masked_in_place(edges, local, MIX_GROUP_BYTES)
    w = uniform_weights_torch(edges)[off:off + n_local].contiguous()
    groups = ops.mix_groups(local, MIX_GROUP_BYTES)
    for keys in groups:
        ys = ops.mix_pytree(w, OrderedDict((k, pop[k]) for k in keys))
        for k, y in ys.items():
            local[k].copy_(y)
        del ys
    return len(groups)
