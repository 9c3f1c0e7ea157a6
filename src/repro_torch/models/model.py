"""Arch-agnostic model API of the model zoo: the port of
``repro.models.model``'s serving half.

  ``init_params(cfg, seed, device)``                   -> params tree
  ``forward(params, batch, cfg, last_only=...)``       -> (logits, aux)
  ``init_cache(cfg, batch, max_len, device=...)``      -> decode cache
  ``decode_step(params, cache, tokens, pos, cfg)``     -> (logits, cache)
  ``greedy_generate(params, cfg, prompt, steps)``      -> tokens

``init_params`` and ``init_cache`` run on the card unless the caller
passes ``device="cpu"``; the others run where their inputs lie.
``batch`` holds ``tokens`` [b, s] (int).  ``loss_fn`` waits for the
training slice (ROADMAP queue 1 item 16).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..tree import flatten
from . import transformer

init_params = transformer.init_params
forward = transformer.forward
init_cache = transformer.init_cache
decode_step = transformer.decode_step


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
