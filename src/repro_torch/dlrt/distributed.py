"""Node-axis sharding of the round engine — the part of
``repro.dlrt.distributed`` the sharded superstep reads (``node_axes`` and
``superstep_node_sharding``), reduced to what a ``torch.distributed``
mesh has: the shard count and this rank's index.

The rest of the reference module (``leaf_spec``, ``params_sharding``,
``make_train_step``, ``make_serve_step`` and the abstract-shape helpers)
is the model zoo's training and serving policy and comes with it.
"""
from __future__ import annotations

from typing import Tuple

# The one axis a NodeMesh has: the reference's single-pod node axis.
NODE_AXES = ("data",)


def node_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the node axis maps onto: ``("data",)`` (a
    :class:`~repro_torch.launch.NodeMesh` is one axis of ranks)."""
    return NODE_AXES


def superstep_node_sharding(mesh) -> Tuple[int, int]:
    """``(shard, index)``: the number of node-axis shards (the mesh's world
    size; the engine pads the node axis up to a multiple of it) and this
    rank's shard.  A one-rank mesh runs the same sharded program, its
    collectives over one rank."""
    return mesh.world, mesh.rank
