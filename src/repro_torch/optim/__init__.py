"""Optimizers and schedules as transforms on parameter dicts (the API of
``repro.optim``: ``opt = sgd(...); state = opt.init(params); updates, state
= opt.update(grads, state, params); params = apply_updates(params,
updates)``)."""
from .optim import (Optimizer, adamw, apply_updates, chain_clip, global_norm,
                    sgd)
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = ["Optimizer", "adamw", "apply_updates", "chain_clip", "sgd",
           "global_norm", "constant", "cosine_decay",
           "linear_warmup_cosine"]
