"""Optimizers as transforms on parameter dicts."""
from .optim import Optimizer, apply_updates, sgd

__all__ = ["Optimizer", "apply_updates", "sgd"]
