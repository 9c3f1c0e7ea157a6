"""Launching sharded runs: the node mesh (one ``torch.distributed`` rank
per node-axis shard) and a helper that starts the ranks from Python."""
from .mesh import NodeMesh, make_superstep_mesh
from .spawn import Ranks, spawn, start

__all__ = ["NodeMesh", "Ranks", "make_superstep_mesh", "spawn", "start"]
