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
:func:`make_serve_step` decodes one token on every node.

Memory.  A round never holds a second population or every node's
gradients: each node's forward and backward run alone, its update is
written into its slice of the stacked leaves in place, and the mix goes in
groups of leaves bounded in bytes, each group's outputs copied over its
inputs before the next group starts (:func:`repro_torch.kernels.ops.
mix_masked_in_place`).  So a step updates the parameters and optimizer
state of the ``TrainState`` it is given, and returns them.

The node-axis sharding the sharded superstep reads (``node_axes``,
``superstep_node_sharding``) is reduced to what a ``torch.distributed``
mesh has: the shard count and this rank's index.  Still to port (ROADMAP
queue 1 item 5): ``leaf_spec``, ``params_sharding``, ``cache_spec``,
``train_state_sharding``, ``serve_kv_spec``, the abstract-shape helpers
and ``launch/mesh.py`` ``make_production_mesh``.
"""
from __future__ import annotations

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

# The one axis a NodeMesh has: the reference's single-pod node axis.
NODE_AXES = ("data",)
# The mix's groups of leaves stop below this many bytes (a larger leaf is
# a group of its own), which bounds the mix's extra memory.
MIX_GROUP_BYTES = 2 << 30


def node_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the node axis maps onto: ``("data",)`` (a
    :class:`~repro_torch.launch.NodeMesh` is one axis of ranks)."""
    return NODE_AXES


def superstep_node_sharding(mesh) -> Tuple[int, int]:
    """``(shard, index)``: the number of node-axis shards (the mesh's world
    size; the engine pads the node axis up to a multiple of it) and this
    rank's shard.  A one-rank mesh runs the same sharded program, its
    collectives over one rank."""
    return mesh.world, mesh.rank


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
                    do_topology: bool = True, window="cfg"):
    """Returns ``train_step(state, batch, noise=None, stage=None) ->
    (state, metrics)``: one paper round.

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

    def node_grads(p: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
        B = b["tokens"].shape[0]
        mb = microbatch or B
        if B % mb != 0:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        steps = B // mb
        leaves = list(p.values())

        def grads_of(piece):
            loss, _ = model.loss_fn(unflatten(p), piece, cfg, window=window)
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


def make_serve_step(cfg, *, window="cfg"):
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits,
    cache)`` for node-stacked state: ``tokens [n, b, 1]``, caches ``[n,
    ...]`` (:func:`init_node_caches`); node i's ``model.decode_step`` on
    its slices, the cache updated in place, ``logits [n, b, 1, vocab]``."""

    def serve_step(params, cache, tokens, pos: int):
        n = tokens.shape[0]
        logits = [model.decode_step(tree_map(lambda v: v[i], params),
                                    tree_map(lambda v: v[i], cache),
                                    tokens[i], pos, cfg, window=window)[0]
                  for i in range(n)]
        return torch.stack(logits), cache

    return serve_step
