"""Launching runs: the node mesh (one ``torch.distributed`` rank per
node-axis shard), a helper that starts the ranks from Python, and the
assigned input shapes (``shapes``)."""
from .mesh import NodeMesh, make_superstep_mesh
from .shapes import (SHAPES, TRAIN_MICROBATCH, ShapeSpec, TensorSpec,
                     cache_len, frontend_inputs, input_specs, shape_config,
                     skip_reason)
from .spawn import Ranks, spawn, start

__all__ = ["NodeMesh", "Ranks", "SHAPES", "ShapeSpec", "TRAIN_MICROBATCH",
           "TensorSpec", "cache_len", "frontend_inputs", "input_specs",
           "make_superstep_mesh", "shape_config", "skip_reason", "spawn",
           "start"]
