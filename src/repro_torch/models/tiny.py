"""The tiny MLP of the reference's conformance suites, as functions of a
flat parameter dict — the port of ``repro.models.tiny``.

One hidden layer over flattened images; leaves in reference leaf order
(``b1``, ``b2``, ``w1``, ``w2``), so a reference pytree carries over by
copy (:func:`repro_torch.tree.params_from_jax`).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def mlp_params(generator: Optional[torch.Generator] = None, *,
               d_in: int = 192, num_classes: int = 4, hidden: int = 8
               ) -> "OrderedDict[str, torch.Tensor]":
    """One node's parameters: ``w1 [d_in, hidden]``, ``b1 [hidden]``,
    ``w2 [hidden, num_classes]``, ``b2 [num_classes]`` (f32, normal
    weights scaled by ``1/sqrt(fan_in)`` and drawn from the CPU
    ``generator``, zero biases; the bits differ from the reference's
    ``jax.random`` draws)."""
    w1 = torch.randn((d_in, hidden), generator=generator) / math.sqrt(d_in)
    w2 = torch.randn((hidden, num_classes), generator=generator) \
        / math.sqrt(hidden)
    return OrderedDict([("b1", torch.zeros(hidden)),
                        ("b2", torch.zeros(num_classes)),
                        ("w1", w1), ("w2", w2)])


def mlp_loss(p: Dict[str, torch.Tensor], batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy and accuracy on ``{"images" [b, ...], "labels"
    [b]}``."""
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = F.relu(x @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    labels = batch["labels"]
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}
