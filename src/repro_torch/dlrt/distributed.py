"""Decentralized training and serving of the model zoo (paper Alg. 2 on
language models), and the node-axis sharding of the round engine — the
port of ``repro.dlrt.distributed``.

Training: :func:`init_train_state` draws a population of ``n`` models,
each leaf node-stacked ``[n, ...]`` in the reference's layout (the
period-stacked body leaves stay one leaf each), and bootstraps Morph on a
bidirectional ring; :func:`make_train_step` builds one round: every
node's local step, a Morph negotiation on topology rounds (Eq. 3 through
the Gram kernel, one grouped launch per 32 leaves of a dtype) and the
uniform mix over the edges through the masked-mix kernel.  Every
architecture of the port's zoo trains so: MoE expert banks, RWKV-6's
mixers (whose ``w0`` and ``u`` stay f32 in a bf16 model, so Eq. 3 takes
one Gram launch per dtype), the MoE aux term in the loss, Whisper's
encoder over a batch's ``frames`` and a VLM's ``patch_embeds``.  Serving:
:func:`make_serve_step` decodes one token on every node, and
:func:`make_prefill_step` runs every node's prefill.

Memory.  A round never holds a second population or every node's
gradients: each node's forward and backward run alone, its update is
written into its slice of the stacked leaves in place, and the mix goes in
groups of leaves bounded in bytes, each group's outputs copied over its
inputs before the next group starts (:func:`repro_torch.kernels.ops.
mix_masked_in_place`).  So a step updates the parameters and optimizer
state of the ``TrainState`` it is given, and returns them.

Sharding policies (DESIGN.md §4).  The zoo's production mesh
(``repro_torch.launch.mesh.make_production_mesh``: ``("data", "model")``
of (16, 16), or ``("pod", "data", "model")`` of (2, 16, 16)) and the
reference's two policies: ``node_dp`` puts the node axis on ``data`` (and
``pod``), each replica tensor-parallel over ``model``; ``node_fsdp``
replicates the node axis (multi-pod: over ``pod``) and shards every node's
leaves over ``data`` x ``model``.  :func:`leaf_spec`, :func:`cache_spec`,
:func:`batch_sharding`, :func:`serve_kv_spec` and the tree builders
(:func:`params_sharding`, :func:`cache_sharding`,
:func:`train_state_sharding`) give the reference's ``PartitionSpec`` for
every leaf, as the port's own :class:`PartitionSpec` (a tuple of None, an
axis name or a tuple of names a dim); :func:`shard_shape` is a leaf's
shape on one card and :func:`placements` its DTensor placements.  The
``abstract_*`` helpers build a state's, a population's or a cache's
leaves on the meta device: shapes and dtypes, no memory.  They are pure
functions of shapes, so they run on any host.  The train step runs on a
``DeviceMesh`` with DTensor state under these specs
(``make_train_step(..., mesh=...)``, :mod:`.mesh_step`), and the serve
step and the prefill on parameters under these specs, each node's caches
staying on their ranks under :func:`cache_sharding`
(``make_serve_step(..., mesh=...)``, ``make_prefill_step(...,
mesh=...)``, :mod:`.mesh_serve`).  The node-axis sharding the sharded
superstep reads (``node_axes``, ``superstep_node_sharding``) is reduced to
what a ``torch.distributed`` node mesh has: the shard count and this
rank's index.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import fold_seed, resolve_device
from ..core.morph import MorphGraphState, MorphNoise, init_state, \
    update_topology
from ..kernels import ops
from ..models import model
from ..optim import Optimizer, apply_updates
from ..tree import flatten, tree_map, unflatten

# The mix's groups of leaves stop below this many bytes (a larger leaf is
# a group of its own), which bounds the mix's extra memory.
MIX_GROUP_BYTES = 2 << 30


def node_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the node axis maps onto under ``node_dp`` (and in the
    sharded superstep): ``("pod", "data")`` on a multi-pod layout, else
    ``("data",)`` (a :class:`~repro_torch.launch.NodeMesh` is one axis of
    ranks)."""
    return (("pod", "data") if "pod" in getattr(mesh, "axis_names", ())
            else ("data",))


def superstep_node_sharding(mesh) -> Tuple[int, int]:
    """``(shard, index)``: the number of node-axis shards (the mesh's world
    size; the engine pads the node axis up to a multiple of it) and this
    rank's shard.  A one-rank mesh runs the same sharded program, its
    collectives over one rank."""
    return mesh.world, mesh.rank


# ---------------------------------------------------------------------------
# Sharding policies on the production mesh.
# ---------------------------------------------------------------------------

_EXPERT_KEYS = ("up", "down", "gate")


class PartitionSpec(tuple):
    """A leaf's sharding, one entry a dim: None (replicated), a mesh axis
    name, or a tuple of names (the dim split over those axes, the first
    outermost); dims past the last entry are replicated.  The reference's
    ``jax.sharding.PartitionSpec``, as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh layout (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's shape on one card of ``mesh`` under ``spec`` (raises where
    a dim does not divide by its axes' sizes)."""
    out = []
    for d, size in enumerate(shape):
        parts = math.prod(mesh.shape[a] for a in _entry_axes(
            spec[d] if d < len(spec) else None))
        if size % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"into {parts} shards ({spec})")
        out.append(size // parts)
    return tuple(out)


def placements(spec, mesh):
    """``spec`` as DTensor placements, one a mesh axis: ``Shard(d)`` where
    dim d is split over that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[list(mesh.axis_names).index(a)] = Shard(d)
    return tuple(out)


def _path_names(path) -> Tuple[str, ...]:
    """The names of a dotted path (or a sequence of segments), tuple
    indices dropped, as the reference's ``_path_names`` drops its
    ``SequenceKey``s."""
    segments = path.split(".") if isinstance(path, str) else path
    return tuple(str(s) for s in segments
                 if str(s) and not (isinstance(s, int) or str(s).isdigit()))


def _map_with_names(fn, tree, names: Tuple[str, ...] = ()):
    """``fn(names, leaf)`` on every tensor (or shape-carrying) leaf of
    nested dicts, tuples and NamedTuples, keeping the structure: a dict
    key adds its names (a flat dict's dotted key all of its segments), a
    NamedTuple field its name, a tuple index none.  A leaf that is neither
    a container nor has a ``shape`` (Morph's generator) maps to None."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_with_names(fn, v, names + _path_names(
            str(k)))) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_names(fn, v, names + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return tuple(_map_with_names(fn, v, names) for v in tree)
    if not hasattr(tree, "shape"):
        return None
    return fn(names, tree)


def _node_spec(mesh, n: int):
    """Greedy mesh axes for the node axis: ("pod", "data") when both
    divide, else whichever does, else replicated."""
    used = []
    rem = n
    for a in node_axes(mesh):
        size = _axis_size(mesh, a)
        if size > 1 and rem % size == 0:
            used.append(a)
            rem //= size
    if not used:
        return None
    return used[0] if len(used) == 1 else tuple(used)


def leaf_spec(path, shape: Tuple[int, ...], *, policy: str, mesh,
              num_periods: int, n_nodes: int) -> PartitionSpec:
    """The spec of one node-stacked parameter leaf ``[n_nodes, ...]`` at
    ``path`` (its dotted path or its names): the node axis by the policy;
    an expert bank's (a leaf named ``up``, ``down`` or ``gate`` with three
    body dims) expert axis to ``model``, else the last divisible dim; under
    ``node_fsdp`` the largest remaining divisible dim to ``data``; the scan
    period axis never."""
    names = _path_names(path)
    spec: list = [None] * len(shape)
    dsize, msize = _axis_size(mesh, "data"), _axis_size(mesh, "model")
    psize = _axis_size(mesh, "pod")

    if policy == "node_dp":
        spec[0] = _node_spec(mesh, shape[0])
    elif psize > 1 and shape[0] % psize == 0:
        spec[0] = "pod"

    start = 1
    skip = set()
    if len(shape) > start + 1 and shape[start] == num_periods:
        skip.add(start)                     # never shard the scan axis
    cand = [i for i in range(start, len(shape)) if i not in skip]

    is_expert_bank = (names and names[-1] in _EXPERT_KEYS
                      and len(cand) >= 3)
    model_dim = None
    if is_expert_bank:
        e_dim = cand[0]
        if shape[e_dim] % msize == 0 and msize > 1:
            spec[e_dim] = "model"
            model_dim = e_dim
    if model_dim is None and msize > 1:
        for i in reversed(cand):
            if shape[i] % msize == 0 and shape[i] >= msize:
                spec[i] = "model"
                model_dim = i
                break
    if policy == "node_fsdp" and dsize > 1:
        rest = [i for i in cand if i != model_dim]
        rest.sort(key=lambda i: -shape[i])
        for i in rest:
            if shape[i] % dsize == 0 and shape[i] >= dsize:
                spec[i] = "data"
                break
    return P(*spec)


def params_sharding(mesh, cfg, params_shape) -> Any:
    """The :class:`NamedSharding` of every node-stacked parameter leaf
    (the leading axis the node's)."""
    return _map_with_names(
        lambda names, leaf: NamedSharding(mesh, leaf_spec(
            names, tuple(leaf.shape), policy=cfg.sharding_policy, mesh=mesh,
            num_periods=cfg.num_periods, n_nodes=leaf.shape[0])),
        params_shape)


def batch_sharding(mesh, cfg, n_nodes: int,
                   per_node_batch: Optional[int] = None) -> NamedSharding:
    """``[n_nodes, per_node_batch, seq]`` inputs."""
    if cfg.sharding_policy == "node_dp":
        return NamedSharding(mesh, P(_node_spec(mesh, n_nodes), None, None))
    pod = ("pod" if "pod" in mesh.axis_names
           and n_nodes % _axis_size(mesh, "pod") == 0 else None)
    data = ("data" if per_node_batch is None
            or (per_node_batch % _axis_size(mesh, "data") == 0
                and per_node_batch >= _axis_size(mesh, "data")) else None)
    return NamedSharding(mesh, P(pod, data, None))


def cache_spec(path, shape, *, policy: str, mesh,
               num_periods: int) -> PartitionSpec:
    """Decode caches: ``[n, (periods,) batch, seq, kv_heads, head_dim]``
    KV buffers and ``[n, (periods,) batch, ...]`` states.  The batch goes
    to ``data`` under ``node_fsdp`` (``node_dp`` gave it the node axis),
    the innermost divisible feature dim to ``model``."""
    msize, dsize = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    psize = _axis_size(mesh, "pod")
    spec: list = [None] * len(shape)
    n = shape[0]
    if policy == "node_dp":
        spec[0] = _node_spec(mesh, n)
    elif psize > 1 and n % psize == 0:
        spec[0] = "pod"
    i = 1
    if len(shape) > i + 1 and shape[i] == num_periods:
        i += 1                               # skip the period axis
    if policy == "node_fsdp" and len(shape) > i \
            and shape[i] % dsize == 0 and dsize > 1:
        spec[i] = "data"
    if msize > 1:
        for j in reversed(range(i + 1, len(shape))):
            if shape[j] % msize == 0 and shape[j] >= msize:
                spec[j] = "model"
                break
    return P(*spec)


def cache_sharding(mesh, cfg, cache_shape) -> Any:
    """The :class:`NamedSharding` of every node-stacked cache leaf
    (:func:`cache_spec`)."""
    return _map_with_names(
        lambda names, leaf: NamedSharding(mesh, cache_spec(
            names, tuple(leaf.shape), policy=cfg.sharding_policy, mesh=mesh,
            num_periods=cfg.num_periods)),
        cache_shape)


def replicated(mesh) -> NamedSharding:
    """Replicated on every card of ``mesh`` (the empty spec)."""
    return NamedSharding(mesh, P())


def serve_kv_spec(mesh, cfg, per_node_batch: int) -> PartitionSpec:
    """The spec of one node's KV buffer ``[b, t, kvh, hd]`` (what
    :func:`cache_sharding` gives the node-stacked leaf)."""
    msize, dsize = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    spec = [None, None, None, None]
    if cfg.sharding_policy == "node_fsdp" and dsize > 1 \
            and per_node_batch % dsize == 0:
        spec[0] = "data"
    for j, size in ((3, cfg.head_dim), (2, cfg.num_kv_heads)):
        if msize > 1 and size % msize == 0 and size >= msize:
            spec[j] = "model"
            break
    return P(*spec)


# ---------------------------------------------------------------------------
# Decentralized train step (paper Alg. 2, one round).
# ---------------------------------------------------------------------------

class MorphHParams(NamedTuple):
    """Morph knobs of the train step (paper defaults)."""
    k: int = 3                  # in-degree / out-degree cap
    view_size: int = 5          # k + |R| (Fig. 2: two random edges)
    beta: float = 500.0         # softmax sharpness of Eq. 5


class TrainState(NamedTuple):
    """``params``: the reference's nested tree, every leaf node-stacked
    ``[n, ...]``; ``opt_state``: the optimizer's state, its ``count`` one
    per node (``[n]`` int32) and its moments flat dicts of node-stacked
    leaves by dotted path (:func:`repro_torch.tree.flatten`); ``morph``:
    the controller state."""
    params: Any
    opt_state: Any
    morph: MorphGraphState


def _ring(n: int, device) -> torch.Tensor:
    """The bidirectional ring's ``[n, n]`` adjacency (none at n = 1)."""
    if n == 1:
        return torch.zeros((1, 1), dtype=torch.bool, device=device)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return torch.roll(eye, 1, dims=1) | torch.roll(eye, -1, dims=1)


def init_train_state(cfg, optimizer: Optimizer, n_nodes: int, seed: int = 0,
                     device="cuda") -> TrainState:
    """A fresh population on ``device`` (the card unless the caller asks
    for the CPU): node i's parameters drawn as
    ``model.init_params(cfg, fold_seed(seed, i))`` and written into the
    node-stacked leaves one node at a time (the population plus one node
    at most), the optimizer's state for every node, and Morph bootstrapped
    on a bidirectional ring with its draws from a generator seeded with
    ``seed``."""
    dev = resolve_device(device)
    stacked: Optional[Dict[str, torch.Tensor]] = None
    for i in range(n_nodes):
        node = flatten(model.init_params(cfg, fold_seed(seed, i), dev))
        if stacked is None:
            stacked = OrderedDict(
                (k, torch.empty((n_nodes,) + v.shape, dtype=v.dtype,
                                device=dev)) for k, v in node.items())
        for k, v in node.items():
            stacked[k][i].copy_(v)
        del node
    return TrainState(unflatten(stacked), _init_opt_state(optimizer, stacked),
                      init_state(_ring(n_nodes, dev), seed))


def train_state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device`` (every tensor copied, so the two
    train apart); Morph's generator is a new CPU generator in the same
    state, so both draw the same negotiations."""
    dev = resolve_device(device)
    copy = lambda t: t.to(dev, copy=True)
    opt = {k: (copy(v) if isinstance(v, torch.Tensor)
               else OrderedDict((p, copy(t)) for p, t in v.items()))
           for k, v in state.opt_state.items()}
    gen = torch.Generator()
    gen.set_state(state.morph.generator.get_state())
    morph = MorphGraphState(*(copy(t) for t in state.morph[:4]),
                            generator=gen)
    return TrainState(tree_map(copy, state.params), opt, morph)


def _init_opt_state(optimizer: Optimizer, stacked: Dict[str, torch.Tensor]):
    """The optimizer's state of every node of node-stacked leaves: its
    moments are node-stacked already, its ``count`` one per node."""
    state = optimizer.init(stacked)
    n = next(iter(stacked.values())).shape[0]
    state["count"] = torch.zeros((n,), dtype=torch.int32,
                                 device=state["count"].device)
    return state


def _node_opt_state(state: Dict, i: int) -> Dict:
    """Node ``i``'s optimizer state: views of its slices."""
    return {k: (v[i] if isinstance(v, torch.Tensor)
                else OrderedDict((p, t[i]) for p, t in v.items()))
            for k, v in state.items()}


def _set_node_opt_state(state: Dict, i: int, new: Dict) -> None:
    for k, v in new.items():
        if isinstance(v, torch.Tensor):
            state[k][i] = v
        else:
            for p, t in v.items():
                state[k][p][i].copy_(t)


def _to_device(value, dev) -> torch.Tensor:
    """A batch entry on ``dev``: integers (``tokens``, ``labels``) as
    ``long``; floats (``frames``, ``patch_embeds``) in their own dtype,
    which the model casts as the reference does."""
    t = torch.as_tensor(value)
    if t.is_floating_point():
        return t.to(dev)
    return t.to(dev, torch.long)


def _unstaged(stage: str, fn: Callable):
    """The default stage hook of a train step: run ``fn``."""
    return fn()


def make_train_step(cfg, optimizer: Optimizer, hp: MorphHParams, *,
                    microbatch: Optional[int] = None,
                    do_topology: bool = True, window="cfg", mesh=None):
    """Returns ``train_step(state, batch, noise=None, stage=None) ->
    (state, metrics)``: one paper round.  Given a ``DeviceMesh``
    (``mesh``), the step over it, on a state under
    :func:`train_state_sharding` (:mod:`.mesh_step`: every rank builds it
    at once); the rest of this docstring is the one-device step.

    1. Local step, node by node: ``model.loss_fn``'s forward and backward
       on the node's slice of every entry of ``batch`` (``tokens`` and
       ``labels``, ``[n, B, S]``, and a stub frontend's ``frames`` or
       ``patch_embeds``, ``[n, B, ...]``), in ``microbatch``-sized pieces
       whose
       gradients add up (each divided by their number) in f32, or in the
       parameter dtype under ``node_fsdp``; then the optimizer's update,
       written into the node's slice.
    2. On a topology round (``do_topology``; the caller picks every
       ``delta_r``-th), Eq. 3 on the updated parameters and
       ``update_topology`` with ``k`` and ``view_size`` capped at
       ``n - 1``; ``noise`` gives its draws (the reference's, replayed),
       else they come from the state's generator.
    3. The uniform mix over the edges, in groups of leaves of at most
       :data:`MIX_GROUP_BYTES` (none at n = 1).

    ``metrics``: ``loss`` (the nodes' mean) and ``per_node_loss`` ``[n]``,
    both before the update.  ``stage(name, fn)`` runs each stage (``batch``
    moves every entry of the batch to the device, ``forward_backward``,
    ``update``, ``similarity``, ``controller``, ``mix``), by default just
    ``fn()``, so a caller can time them."""

    def node_grads(p: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                   mb: Optional[int] = microbatch, rows=None):
        B = b["tokens"].shape[0]
        mb = mb or B
        if B % mb != 0:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        steps = B // mb
        leaves = list(p.values())

        def grads_of(piece):
            loss, _ = model.loss_fn(unflatten(p), piece, cfg, window=window,
                                    rows=rows)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), [torch.zeros_like(v) if g is None else g
                                   for v, g in zip(leaves, got)]

        if steps == 1:
            loss, grads = grads_of(b)
            return OrderedDict(zip(p, grads)), loss
        acc_dtype = (model.transformer._dtype(cfg.param_dtype)
                     if cfg.sharding_policy == "node_fsdp"
                     else torch.float32)
        acc = [torch.zeros(v.shape, dtype=acc_dtype, device=v.device)
               for v in leaves]
        losses = []
        for s in range(steps):
            loss, grads = grads_of({k: v[s * mb:(s + 1) * mb]
                                    for k, v in b.items()})
            for a, g in zip(acc, grads):
                a += g.to(a.dtype) / steps
            losses.append(loss)
            del grads
        return OrderedDict(zip(p, acc)), torch.stack(losses).mean()

    if mesh is not None:
        from .mesh_step import make_mesh_train_step
        return make_mesh_train_step(cfg, optimizer, hp, node_grads,
                                    microbatch=microbatch,
                                    do_topology=do_topology,
                                    device_mesh=mesh)

    def train_step(state: TrainState, batch, noise: Optional[MorphNoise]
                   = None, stage: Optional[Callable] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        stage = stage or _unstaged
        params = flatten(state.params)
        first = next(iter(params.values()))
        n, dev = first.shape[0], first.device
        batch = stage("batch", lambda: {
            k: _to_device(v, dev) for k, v in batch.items()})
        losses = []
        for i in range(n):
            p_i = OrderedDict((k, v[i].detach().requires_grad_())
                              for k, v in params.items())
            grads, loss = stage("forward_backward", lambda: node_grads(
                p_i, {k: v[i] for k, v in batch.items()}))
            losses.append(loss)

            def update():
                with torch.no_grad():
                    node = OrderedDict((k, v.detach())
                                       for k, v in p_i.items())
                    upd, new_state = optimizer.update(
                        grads, _node_opt_state(state.opt_state, i), node)
                    # Leaf by leaf, each f32 update freed once applied.
                    for k in list(upd):
                        params[k][i].copy_(apply_updates(
                            {k: node[k]}, {k: upd.pop(k)})[k])
                    _set_node_opt_state(state.opt_state, i, new_state)
            stage("update", update)
            del grads, p_i
        morph = state.morph
        with torch.no_grad():
            if n > 1:
                if do_topology:
                    sim = stage("similarity",
                                lambda: ops.model_pairwise_cosine(params))
                    morph = stage("controller", lambda: update_topology(
                        state.morph, sim, k=min(hp.k, n - 1),
                        view_size=min(hp.view_size, n - 1), beta=hp.beta,
                        noise=noise))
                stage("mix", lambda: ops.mix_masked_in_place(
                    morph.edges, params, MIX_GROUP_BYTES))
        per_node = torch.stack(losses)
        metrics = {"loss": per_node.mean(), "per_node_loss": per_node}
        return TrainState(state.params, state.opt_state, morph), metrics

    return train_step


# ---------------------------------------------------------------------------
# Node-stacked serving.
# ---------------------------------------------------------------------------

def init_node_caches(cfg, n_nodes: int, batch: int, max_len: int,
                     dtype=None, device="cuda"):
    """Every node's decode cache (``model.init_cache``), each leaf
    node-stacked ``[n, ...]``: the cache :func:`make_serve_step` takes."""
    one = model.init_cache(cfg, batch, max_len, dtype, device=device)
    return tree_map(lambda leaf: leaf.unsqueeze(0).repeat(
        (n_nodes,) + (1,) * leaf.dim()), one)


def make_serve_step(cfg, *, window="cfg", kv_spec=None, mesh=None):
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits,
    cache)`` for node-stacked state: ``tokens [n, b, 1]``, caches ``[n,
    ...]`` (:func:`init_node_caches`); node i's ``model.decode_step`` on
    its slices, the cache updated in place, ``logits [n, b, 1, vocab]``.

    Given a ``DeviceMesh`` (``mesh``), the step over it on parameters
    under :func:`params_sharding` and caches under :func:`cache_sharding`
    that never leave their ranks (:mod:`.mesh_serve`; every rank builds it
    at once); there ``kv_spec`` (the reference's pin of each node's KV
    buffer), where given, must be :func:`serve_kv_spec` of the mesh, the
    config and a call's batch, or that call raises ``ValueError``.  Without
    a mesh ``kv_spec`` changes nothing, as the reference's constraint
    outside a mesh."""
    if mesh is not None:
        from .mesh_serve import make_mesh_serve_step
        return make_mesh_serve_step(cfg, window=window, device_mesh=mesh,
                                    kv_spec=kv_spec)

    def serve_step(params, cache, tokens, pos: int):
        n = tokens.shape[0]
        logits = [model.decode_step(tree_map(lambda v: v[i], params),
                                    tree_map(lambda v: v[i], cache),
                                    tokens[i], pos, cfg, window=window)[0]
                  for i in range(n)]
        return torch.stack(logits), cache

    return serve_step


def make_prefill_step(cfg, *, window="cfg", mesh=None):
    """Returns ``prefill(params, batch) -> logits [n, b, 1, vocab]``: node
    i's ``model.forward(..., last_only=True)`` on its slice of every entry
    of ``batch`` (``tokens [n, b, s]``, a frontend's ``frames`` or
    ``patch_embeds``), without autograd: the reference's dry-run prefill.
    Given a ``DeviceMesh`` (``mesh``), the prefill over it on parameters
    under :func:`params_sharding` (:mod:`.mesh_serve`)."""
    if mesh is not None:
        from .mesh_serve import make_mesh_prefill_step
        return make_mesh_prefill_step(cfg, window=window, device_mesh=mesh)

    def prefill(params, batch):
        n, dev = batch["tokens"].shape[0], \
            next(iter(flatten(params).values())).device
        with torch.no_grad():
            return torch.stack([model.forward(
                tree_map(lambda v: v[i], params),
                {k: _to_device(v[i], dev) for k, v in batch.items()}, cfg,
                window=window, last_only=True)[0] for i in range(n)])

    return prefill


# ---------------------------------------------------------------------------
# Shapes and shardings of whole states (the dry run's arguments).
# ---------------------------------------------------------------------------

META = torch.device("meta")


def abstract_stacked_params(cfg, n_nodes: int):
    """Node-stacked parameters ``[n_nodes, ...]`` as meta tensors: the
    shapes and dtypes of :func:`init_train_state`'s ``params``, with no
    memory and no draws."""
    one = model.init_params(cfg, 0, META)
    return tree_map(lambda leaf: leaf.new_empty((n_nodes,) + leaf.shape),
                    one)


def abstract_train_state(cfg, optimizer: Optimizer, n_nodes: int
                         ) -> TrainState:
    """:func:`init_train_state`'s state as meta tensors (its Morph
    generator a CPU generator, as always): no memory, no draws."""
    params = abstract_stacked_params(cfg, n_nodes)
    return TrainState(params, _init_opt_state(optimizer, flatten(params)),
                      init_state(_ring(n_nodes, META)))


def abstract_cache(cfg, n_nodes: int, per_node_batch: int, max_len: int):
    """Node-stacked decode caches as meta tensors
    (:func:`init_node_caches` on the meta device)."""
    return init_node_caches(cfg, n_nodes, per_node_batch, max_len,
                            device=META)


def train_state_sharding(mesh, cfg, state_shape) -> TrainState:
    """The :class:`NamedSharding` of every tensor of a
    :class:`TrainState`: the parameters by :func:`leaf_spec`, the
    optimizer's moments mirroring them and its ``[n]`` counts replicated,
    Morph's tensors replicated (its generator, host state, None)."""
    def opt_leaf(names, leaf):
        if leaf.dim() <= 1:
            return replicated(mesh)
        return NamedSharding(mesh, leaf_spec(
            names, tuple(leaf.shape), policy=cfg.sharding_policy, mesh=mesh,
            num_periods=cfg.num_periods, n_nodes=leaf.shape[0]))
    morph = MorphGraphState(*(replicated(mesh) for _ in range(4)),
                            generator=None)
    return TrainState(params_sharding(mesh, cfg, state_shape.params),
                      _map_with_names(opt_leaf, state_shape.opt_state),
                      morph)
