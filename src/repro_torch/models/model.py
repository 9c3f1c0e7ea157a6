"""Arch-agnostic model API of the model zoo: the port of
``repro.models.model``.

  ``init_params(cfg, seed, device)``                   -> params tree
  ``forward(params, batch, cfg, last_only=...)``       -> (logits, aux)
  ``loss_fn(params, batch, cfg)``                      -> (loss, metrics)
  ``init_cache(cfg, batch, max_len, device=...)``      -> decode cache
  ``decode_step(params, cache, tokens, pos, cfg)``     -> (logits, cache)
  ``greedy_generate(params, cfg, prompt, steps)``      -> tokens

``init_params`` and ``init_cache`` run on the card unless the caller
passes ``device="cpu"``; the others run where their inputs lie.
``batch`` holds ``tokens`` [b, s] (int) and, for ``loss_fn``, ``labels``
[b, s] (int; ``IGNORE_INDEX`` = -100 masks a position); plus the stub
frontends' inputs: ``frames`` [b, T, d] (float; Whisper's encoder,
required) or ``patch_embeds`` [b, P, 1024] (float; a VLM's, optional).
Patch embeddings come before the text, so the logits are P positions
longer than the labels, and ``loss_fn`` masks those positions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..tree import flatten
from . import transformer

IGNORE_INDEX = -100

init_params = transformer.init_params
forward = transformer.forward
init_cache = transformer.init_cache
decode_step = transformer.decode_step


def loss_fn(params, batch, cfg, *, window="cfg", rows=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ the MoE aux term ``forward`` sums over
    the MoE layers, 0 for a model without experts) over the positions
    whose label is not ``IGNORE_INDEX`` (patch positions never count);
    metrics ``loss``, ``ce``, ``aux`` and ``accuracy``.

    The reference takes the label logit as a masked sum over the vocabulary
    (``iota == label``), which keeps a model-sharded vocabulary local; here
    it is a gather.  The values are equal: that sum adds one logit to
    zeros, which is exact.  ``rows``: as ``forward``'s."""
    logits, aux = transformer.forward(params, batch, cfg, window=window,
                                      rows=rows)
    labels = batch["labels"]
    # Stub-frontend positions come before the text: pad the labels on the
    # left with IGNORE_INDEX so that positions line up.
    pad = logits.shape[1] - labels.shape[1]
    if pad > 0:
        labels = torch.cat([labels.new_full((labels.shape[0], pad),
                                            IGNORE_INDEX), labels], dim=1)
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)                    # [b, s]
    label_logit = logits.gather(-1, safe[..., None])[..., 0]
    nll = lse - label_logit
    denom = torch.clamp(mask.sum(), min=1)
    ce = torch.where(mask, nll, 0.0).sum() / denom
    loss = ce + aux
    correct = torch.where(mask, logits.argmax(-1) == safe, False)
    metrics = {"loss": loss, "ce": ce, "aux": aux,
               "accuracy": correct.sum() / denom}
    return loss, metrics


def greedy_generate(params, cfg, prompt: torch.Tensor, steps: int,
                    max_len: Optional[int] = None) -> torch.Tensor:
    """Feed ``prompt [b, plen]`` token by token through the cache, then
    decode ``steps`` greedy tokens -> ``[b, steps]``."""
    b, plen = prompt.shape
    max_len = max_len or (plen + steps)
    cache = init_cache(cfg, b, max_len, cfg.param_dtype,
                       device=prompt.device)
    logits = torch.zeros((b, 1, cfg.vocab_size), device=prompt.device)
    for t in range(plen):
        logits, cache = decode_step(params, cache, prompt[:, t:t + 1], t,
                                    cfg)
    toks = []
    for t in range(steps):
        tok = logits.argmax(-1)                             # [b, 1]
        logits, cache = decode_step(params, cache, tok, plen + t, cfg)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1)


def param_count(params) -> int:
    return sum(leaf.numel() for leaf in flatten(params).values())


def param_bytes(params) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in flatten(params).values())
