"""Plain SGD as a transform on parameter dicts — the momentum-0 path of
``repro.optim.sgd`` (the paper's D-PSGD step ``x - gamma * grad``)."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]       # (grads, state, params) -> (upd, state)


def sgd(lr: float) -> Optimizer:
    """``update = -lr * grad`` in f32; the state is the int32 step count."""
    def init(params):
        leaf = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(grads, state, params=None):
        upd = OrderedDict((k, -lr * g.float()) for k, g in grads.items())
        return upd, {"count": state["count"] + 1}

    return Optimizer(init, update)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]
                  ) -> "OrderedDict[str, torch.Tensor]":
    """``p + u`` in f32, cast back to each leaf's dtype."""
    return OrderedDict((k, (p.float() + updates[k]).to(p.dtype))
                       for k, p in params.items())
