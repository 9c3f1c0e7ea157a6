"""Launching runs: the node mesh (one ``torch.distributed`` rank per
node-axis shard), the sweep's ``("exp", "data")`` mesh, the zoo's
production mesh layout, a helper that starts the ranks from Python, and
the assigned input shapes (``shapes``); the dry run is ``python -m
repro_torch.launch.dryrun``."""
from .mesh import (MeshLayout, NodeMesh, SweepMesh, make_production_mesh,
                   make_superstep_mesh, make_sweep_mesh)
from .shapes import (SHAPES, TRAIN_MICROBATCH, ShapeSpec, TensorSpec,
                     cache_len, frontend_inputs, input_specs, shape_config,
                     skip_reason)
from .spawn import Ranks, spawn, start

__all__ = ["MeshLayout", "NodeMesh", "Ranks", "SHAPES", "ShapeSpec",
           "SweepMesh", "TRAIN_MICROBATCH", "TensorSpec", "cache_len",
           "frontend_inputs", "input_specs", "make_production_mesh",
           "make_superstep_mesh", "make_sweep_mesh", "shape_config",
           "skip_reason", "spawn", "start"]
