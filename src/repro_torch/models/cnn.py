"""GN-LeNet, the paper's CNN (Table I / Figs. 3-7), as functions of a flat
parameter dict — the port of ``repro.models.cnn``.

Parameters keep the reference's layouts: conv weights are HWIO and
``fc.w`` rows follow the NHWC flatten order, so a reference pytree carries
over by copy (:func:`repro_torch.tree.params_from_jax`).  The forward pass
views the weights in PyTorch's layout (``w.permute(3, 2, 0, 1)``) and
permutes the activations instead; images arrive NHWC as in the reference.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _trunc_normal(shape, std: float, generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    if generator is not None:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    else:
        t.zero_()
    return t * std


def cnn_params(generator: Optional[torch.Generator] = None, *,
               in_channels: int = 3, num_classes: int = 10,
               image_size: int = 32, width: int = 32,
               dtype=torch.float32, device="cpu"
               ) -> "OrderedDict[str, torch.Tensor]":
    """One node's GN-LeNet parameters, in reference leaf order.

    With a (CPU) ``generator`` the weights are He fan-in truncated-normal
    draws sampled in f32 and cast, as the reference initializes them (the
    bits differ: the reference draws with ``jax.random``); without one
    they are zeros, for callers that only need the shapes."""
    w2 = 2 * width
    feat = (image_size // 4) ** 2 * w2
    conv1 = (5, 5, in_channels, width)
    conv2 = (5, 5, width, w2)
    leaves = {
        "conv1.b": torch.zeros(width),
        "conv1.w": _trunc_normal(conv1, math.sqrt(2.0 / (25 * in_channels)),
                                 generator),
        "conv2.b": torch.zeros(w2),
        "conv2.w": _trunc_normal(conv2, math.sqrt(2.0 / (25 * width)),
                                 generator),
        "fc.b": torch.zeros(num_classes),
        "fc.w": _trunc_normal((feat, num_classes), 1.0 / math.sqrt(feat),
                              generator),
        "gn1.bias": torch.zeros(width),
        "gn1.scale": torch.ones(width),
        "gn2.bias": torch.zeros(w2),
        "gn2.scale": torch.ones(w2),
    }
    return OrderedDict((k, v.to(device=device, dtype=dtype))
                       for k, v in leaves.items())


def _group_norm(x, scale, bias, groups: int = 2, eps: float = 1e-5):
    """GroupNorm on NCHW with population variance (the reference's
    ``_group_norm``)."""
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(
            f"group norm needs the channel count divisible by the group "
            f"count: got {c} channels, {groups} groups")
    xg = x.reshape(b, groups, c // groups, h, w)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(b, c, h, w) * scale[:, None, None] \
        + bias[:, None, None]


def _conv(p, name: str, x):
    # HWIO -> OIHW view; padding 2 is SAME for a 5x5 window at stride 1.
    return F.conv2d(x, p[name + ".w"].permute(3, 2, 0, 1), p[name + ".b"],
                    padding=2)


def cnn_forward(p: Dict[str, torch.Tensor], images: torch.Tensor
                ) -> torch.Tensor:
    """images ``[b, H, W, C]`` -> logits ``[b, num_classes]``."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_group_norm(_conv(p, "conv1", x), p["gn1.scale"],
                           p["gn1.bias"]))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(_group_norm(_conv(p, "conv2", x), p["gn2.scale"],
                           p["gn2.bias"]))
    x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    return x @ p["fc.w"] + p["fc.b"]


def cnn_loss(p: Dict[str, torch.Tensor], batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy and accuracy on ``{"images", "labels"}``."""
    logits = cnn_forward(p, batch["images"])
    labels = batch["labels"]
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def cnn_accuracy(p: Dict[str, torch.Tensor], images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """The share of ``images`` whose largest logit is their label (the
    first largest on ties, as the reference's ``argmax``)."""
    return (cnn_forward(p, images).argmax(-1) == labels).float().mean()
