"""SGD (with momentum, Nesterov and weight decay) and AdamW as transforms on
parameter dicts — the port of ``repro.optim.optim``.

The paper's D-PSGD is plain SGD (``x - gamma * grad``, :func:`sgd` with its
defaults); AdamW and global-norm clipping are for the model zoo's training
launcher.  A state is a dict of the int32 step ``count`` and, where the
optimizer keeps them, dicts of f32 moments shaped like the parameters, so
node-stacked parameters give node-stacked states.  A gradient may be a
DTensor, a shard of a node's leaf: the update reads its local shard, and
:func:`global_norm` sums the whole leaf.  Every update is taken
in f32 and :func:`apply_updates` casts the sum back to each leaf's dtype,
as the reference does.  ``lr`` is a number or a schedule of the count
(:mod:`repro_torch.optim.schedules`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]       # (grads, state, params) -> (upd, state)


def _count(params) -> torch.Tensor:
    leaf = next(iter(params.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _zeros(params) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict((k, torch.zeros_like(p, dtype=torch.float32))
                       for k, p in params.items())


def _lr_at(lr: ScalarOrSchedule, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count)
    return torch.tensor(lr, dtype=torch.float32, device=count.device)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A gradient's values here: a DTensor's local shard, else itself."""
    return x.to_local() if hasattr(x, "to_local") else x


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """A leaf's f32 sum of squares; a DTensor's summed over the mesh axes
    that split it, so it is the whole leaf's."""
    total = torch.sum(torch.square(_local(x).float()))
    if hasattr(x, "to_local"):
        import torch.distributed as dist
        for dim, p in enumerate(x.placements):
            if p.is_shard():
                dist.all_reduce(total, group=x.device_mesh.get_group(dim))
    return total


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt`` of the sum over leaves (in leaf order) of each leaf's f32
    sum of squares; a DTensor leaf (a shard of a node's leaf, as the train
    step on a mesh hands the optimizer its gradients) counts whole."""
    total = 0
    for x in tree.values():
        total = total + _sum_squares(x)
    return torch.sqrt(total)


def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    """``update = -lr * g`` in f32, ``g`` the gradient plus ``weight_decay``
    times the parameter; with ``momentum`` the f32 moment ``mu = momentum
    mu + g`` stands for ``g`` (Nesterov: ``momentum mu + g``)."""
    def init(params):
        state = {"count": _count(params)}
        if momentum > 0:
            state["mu"] = _zeros(params)
        return state

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _lr_at(lr, count)

        def g32(k):
            # Leaf by leaf, so no second f32 copy of every gradient is
            # held at once.
            g = _local(grads[k]).float()
            if weight_decay > 0 and params is not None:
                g = g + weight_decay * params[k].float()
            return g

        new_state = {"count": count}
        if momentum == 0:
            return OrderedDict((k, -step * g32(k)) for k in grads), new_state
        mu = OrderedDict((k, momentum * state["mu"][k] + g32(k))
                         for k in grads)
        new_state["mu"] = mu
        upd = OrderedDict((k, -step * (momentum * mu[k] + g32(k)
                                       if nesterov else mu[k]))
                          for k in grads)
        return upd, new_state

    return Optimizer(init, update)


def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction and decoupled weight decay, in f32."""
    def init(params):
        return {"count": _count(params), "m": _zeros(params),
                "v": _zeros(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _lr_at(lr, count)
        g32 = OrderedDict((k, _local(g).float()) for k, g in grads.items())
        m = OrderedDict((k, b1 * state["m"][k] + (1 - b1) * g)
                        for k, g in g32.items())
        v = OrderedDict((k, b2 * state["v"][k] + (1 - b2) * torch.square(g))
                        for k, g in g32.items())
        c = count.float()
        mh_scale = 1.0 / (1 - torch.pow(torch.tensor(
            b1, dtype=torch.float32, device=c.device), c))
        vh_scale = 1.0 / (1 - torch.pow(torch.tensor(
            b2, dtype=torch.float32, device=c.device), c))
        upd = OrderedDict()
        for k in g32:
            u = (m[k] * mh_scale) / (torch.sqrt(v[k] * vh_scale) + eps)
            if weight_decay > 0 and params is not None:
                u = u + weight_decay * params[k].float()
            upd[k] = -step * u
        return upd, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def chain_clip(inner: Optimizer, max_norm: float) -> Optimizer:
    """Global-norm gradient clipping wrapped around ``inner``: the
    gradients are scaled by ``min(1, max_norm / max(norm, 1e-9))`` in f32
    and cast back to their dtype."""
    def update(grads, state, params=None):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        clipped = OrderedDict((k, (_local(g).float() * scale).to(g.dtype))
                              for k, g in grads.items())
        return inner.update(clipped, state, params)
    return Optimizer(inner.init, update)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]
                  ) -> "OrderedDict[str, torch.Tensor]":
    """``p + u`` in f32, cast back to each leaf's dtype."""
    return OrderedDict((k, (p.float() + updates[k]).to(p.dtype))
                       for k, p in params.items())
