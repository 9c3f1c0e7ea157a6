"""The meshes of the port (``repro.launch.mesh`` on ``torch.distributed``):
the node mesh of the sharded round engine and the zoo's production mesh.

The reference shards the node axis over a 1-D ``("data",)`` JAX mesh and
runs the round body under ``shard_map``.  Here each shard is a process:
one rank per shard, SPMD, each running the per-shard body and meeting the
others in collectives (NCCL for CUDA tensors, gloo for CPU tensors).  A
:class:`NodeMesh` names this rank and its device; the mesh is always the
default process group, on which every collective of the sharded engine
runs.

Three cases (:func:`make_superstep_mesh`):

* a default process group is initialised (``torchrun``, or
  :func:`repro_torch.launch.spawn`): the mesh is that group, and
  ``num_devices`` must be its world size;
* none is, and one shard is asked for: the mesh starts a one-rank group
  of its own on a ``file://`` store in a fresh temporary directory, and
  :meth:`NodeMesh.close` destroys it;
* none is, and more shards are asked for: the ranks must be started
  first, so it raises and says how.

The production mesh (:func:`make_production_mesh`) is the layout the
zoo's sharding policies (``repro_torch.dlrt.distributed``) and the dry run
(``repro_torch.launch.dryrun``) reason about: 256 cards as ``("data",
"model")`` of (16, 16), or two such pods as ``("pod", "data", "model")``.
It is a :class:`MeshLayout`, names and sizes only, so the policies run on
any host; :meth:`MeshLayout.device_mesh` makes the real ``DeviceMesh``
where a process group of that many ranks runs, and :class:`MeshGroups`
gives a rank its coordinates on it and the process group over any set of
its axes: what the zoo's train step on the mesh
(``repro_torch.dlrt.mesh_step``) meets the other ranks in.

The sweep's 2-D ``("exp", "data")`` mesh (:func:`make_sweep_mesh`, a
:class:`SweepMesh`) is a ``DeviceMesh`` over the default process group in
the same three cases: ``SweepSuperstep(mesh=...)`` splits its experiments
over ``exp`` and, optionally, their nodes over ``data``.
"""
from __future__ import annotations

import itertools
import math
import shutil
import tempfile
from collections import OrderedDict
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

# How long a collective waits for the other ranks before the run fails.
DEFAULT_TIMEOUT = timedelta(seconds=300)


@dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, as the reference's ``Mesh`` gives
    them (``shape``: name -> size, ``axis_names``), and its card count
    ``size``; no devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of this layout over the default process
        group, which must have :attr:`size` ranks (as ``jax.make_mesh``
        fails with fewer devices)."""
        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != self.size:
            raise ValueError(
                f"a {dict(self.shape)} mesh needs {self.size} ranks and the "
                f"default process group has {world}: start {self.size} "
                "ranks (torchrun --nnodes ... --nproc-per-node ...) and "
                "initialise the group first")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, self.sizes,
                                mesh_dim_names=self.axis_names)


class MeshGroups:
    """This rank's place on a ``DeviceMesh``: its coordinate along each
    axis, and the process group over any set of axes (the ranks that share
    this rank's coordinates on the other axes), ranked first axis
    outermost, as a dim split over those axes is laid out.  One axis is
    the mesh's own group; the groups of two or more axes are made here
    (``flattened``), every one of them in the same order on every rank
    (``new_group`` wants all ranks), so build this on every rank at once;
    without them it gives coordinates only."""

    def __init__(self, device_mesh, flattened: bool = True):
        self.device_mesh = device_mesh
        self.names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.sizes: Tuple[int, ...] = tuple(device_mesh.mesh.shape)
        self.coords: Dict[str, int] = dict(zip(
            self.names, device_mesh.get_coordinate()))
        ranks = device_mesh.mesh
        self._groups = {}
        for k in range(2, len(self.names) + 1 if flattened else 2):
            for dims in itertools.combinations(range(len(self.names)), k):
                rest = [d for d in range(len(self.names)) if d not in dims]
                rows = ranks.permute(rest + list(dims)).reshape(
                    -1, math.prod(self.sizes[d] for d in dims))
                me = dist.get_rank()
                for row in rows.tolist():
                    group = dist.new_group(row)
                    if me in row:
                        self._groups[tuple(self.names[d]
                                           for d in dims)] = group

    def order(self, axes) -> Tuple[str, ...]:
        """``axes`` in mesh order."""
        return tuple(a for a in self.names if a in axes)

    def size(self, axes) -> int:
        """The number of ranks over ``axes``."""
        return math.prod(self.sizes[self.names.index(a)] for a in axes)

    @property
    def layout(self) -> MeshLayout:
        return MeshLayout(self.names, self.sizes)

    def index(self, axes) -> int:
        """This rank's index over ``axes``, the first outermost."""
        out = 0
        for a in self.order(axes):
            out = out * self.sizes[self.names.index(a)] + self.coords[a]
        return out

    def group(self, axes):
        """The process group over ``axes`` (mesh order); None for none."""
        axes = self.order(axes)
        if not axes:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single pod: 256 cards as (data=16, model=16).  Multi-pod: 2 pods =
    512 cards as (pod=2, data=16, model=16)."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def backend_for(device: torch.device) -> str:
    """The collective backend for tensors on ``device``: NCCL on the card,
    gloo on the CPU (never gloo staged through the host for CUDA)."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` on the card,
    the CPU otherwise."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass
class NodeMesh:
    """One rank's view of the node mesh, which is the default process
    group: the world size (node-axis shard count), this rank and its
    device.  ``owned`` says whether the mesh started the group itself."""
    world: int
    rank: int
    device: torch.device
    owned: bool = False
    _store_dir: Optional[str] = None

    def close(self) -> None:
        """Destroy the group if this mesh started it (a group it was given
        stays); a second call does nothing."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def make_superstep_mesh(num_devices: Optional[int] = None, *,
                        device="cuda",
                        timeout: timedelta = DEFAULT_TIMEOUT) -> NodeMesh:
    """The node mesh for the sharded round engine (DESIGN.md §8): the
    default process group when one is initialised (``num_devices`` None
    or 0 means its world size, and any other value must equal it), else a
    one-rank group of its own for ``num_devices`` None, 0 or 1 (NCCL for a
    CUDA ``device``, gloo for the CPU, with a finite ``timeout``).  Rank r
    works on ``cuda:(r % torch.cuda.device_count())`` on the card."""
    dev = resolve_device(device)
    want = backend_for(dev)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        nd = world if not num_devices else num_devices
        if nd != world:
            raise ValueError(
                f"num_devices={nd} != {world}, the process group's world "
                "size: one rank runs one shard (start N ranks with torchrun "
                "--nproc-per-node N)")
        got = dist.get_backend()
        if got != want:
            raise ValueError(
                f"the process group runs {got}, and a {dev.type} mesh "
                f"takes {want}")
        return NodeMesh(world, rank, rank_device(dev, rank))
    if num_devices not in (None, 0, 1):
        raise ValueError(
            f"num_devices={num_devices} not in [1, 1] without a process "
            f"group: start {num_devices} ranks with torchrun "
            f"--nproc-per-node {num_devices} (or repro_torch.launch.spawn), "
            "which initialise the default group, and build the mesh in "
            "each")
    return NodeMesh(1, 0, rank_device(dev, 0), owned=True,
                    _store_dir=_one_rank_group(want, timeout))


def _one_rank_group(backend: str, timeout: timedelta) -> str:
    """Start a one-rank default group on a ``file://`` store in a fresh
    temporary directory; returns the directory."""
    store = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    dist.init_process_group(
        backend, init_method=(Path(store) / "store").as_uri(), world_size=1,
        rank=0, timeout=timeout)
    return store


class SweepMesh(MeshGroups):
    """The sweep's ``("exp", "data")`` mesh on this rank (a
    :class:`MeshGroups` over its ``DeviceMesh``): ``shape`` as the
    reference's ``Mesh.shape`` gives it (``{"exp": e, "data": d}``), this
    rank's ``coords`` and the group along each axis (``group(("exp",))``),
    its ``device``, and :meth:`close`, which destroys the default group if
    :func:`make_sweep_mesh` started it."""

    def __init__(self, device_mesh, device: torch.device,
                 node: NodeMesh):
        super().__init__(device_mesh, flattened=False)
        self.device = device
        self._node = node

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return self.layout.shape

    def close(self) -> None:
        """Destroy the default group if this mesh started it (a group it
        was given stays); a second call does nothing."""
        self._node.close()


def make_sweep_mesh(exp_devices: int, node_devices: int = 1, *,
                    device="cuda",
                    timeout: timedelta = DEFAULT_TIMEOUT) -> SweepMesh:
    """The sweep engine's 2-D ``("exp", "data")`` mesh (DESIGN.md §14):
    experiments split over ``exp`` (each trajectory is independent, so the
    split changes no bits) and their nodes over ``data`` (the gather
    schedule of the sharded engine).  It is the default process group,
    which must have ``exp_devices * node_devices`` ranks; with none, a 1 x
    1 mesh starts a one-rank group of its own (NCCL for a CUDA
    ``device``, gloo for the CPU), which :meth:`SweepMesh.close` destroys,
    and a larger one raises and says how to start the ranks.  Rank ``r``
    works on ``cuda:(r % torch.cuda.device_count())`` on the card."""
    dev = resolve_device(device)
    if exp_devices < 1 or node_devices < 1:
        raise ValueError("exp_devices and node_devices must be >= 1")
    want = backend_for(dev)
    ranks = exp_devices * node_devices
    layout = MeshLayout(("exp", "data"), (exp_devices, node_devices))
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != ranks:
            raise ValueError(
                f"a {dict(layout.shape)} sweep mesh needs {ranks} ranks and "
                f"the process group has {world}: start {ranks} with "
                f"torchrun --nproc-per-node {ranks}")
        got = dist.get_backend()
        if got != want:
            raise ValueError(
                f"the process group runs {got}, and a {dev.type} mesh "
                f"takes {want}")
        node = NodeMesh(world, dist.get_rank(),
                        rank_device(dev, dist.get_rank()))
    elif ranks == 1:
        node = NodeMesh(1, 0, rank_device(dev, 0), owned=True,
                        _store_dir=_one_rank_group(want, timeout))
    else:
        raise ValueError(
            f"a {dict(layout.shape)} sweep mesh needs {ranks} ranks and no "
            f"process group is initialised: start them with torchrun "
            f"--nproc-per-node {ranks} (or repro_torch.launch.spawn), which "
            "initialise the default group, and build the mesh in each")
    if node.device.type == "cuda":
        torch.cuda.set_device(node.device)
    return SweepMesh(layout.device_mesh(node.device.type), node.device,
                     node)
