"""Start the ranks of a sharded run from one Python process: the helper
the tests and ``repro_torch.bench.fig10`` use in place of ``torchrun``.

:func:`start` runs ``fn(*args)`` in ``world`` child processes started by
``torch.multiprocessing``, each rank ``r`` of one default process group
(NCCL on ``cuda:(r % device_count)`` by default, gloo for
``device="cpu"``) initialised on a ``file://`` store in a fresh temporary
directory; ``fn`` then builds its mesh with
:func:`repro_torch.launch.make_superstep_mesh` as it would under
``torchrun``.  :meth:`Ranks.join` waits for every child and returns the
ranks' return values in rank order; a child that raises, dies or returns
nothing makes it raise.  ``fn`` must be importable by name (a function at
module level) and return something picklable.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import resolve_device
from .mesh import DEFAULT_TIMEOUT, backend_for, rank_device


def _rank_main(rank: int, world: int, fn: Callable, args: tuple,
               device: str, store: str, timeout: timedelta,
               threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dev = rank_device(torch.device(device), rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev),
                            init_method=(Path(store) / "store").as_uri(),
                            world_size=world, rank=rank, timeout=timeout)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    path = Path(store) / f"rank{rank}.pkl"
    with open(f"{path}.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(f"{path}.tmp", path)


class Ranks:
    """The running children of :func:`start`."""

    def __init__(self, context, world: int, store: str):
        self._context, self.world, self._store = context, world, store

    def join(self) -> List[Any]:
        """Wait for every rank; their return values in rank order."""
        try:
            while not self._context.join():
                pass
            out = []
            for r in range(self.world):
                path = Path(self._store) / f"rank{r}.pkl"
                if not path.exists():
                    raise RuntimeError(f"rank {r} of {self.world} returned "
                                       "no result")
                with open(path, "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            shutil.rmtree(self._store, ignore_errors=True)


def start(fn: Callable, world: int, *args, device: str = "cuda",
          timeout: timedelta = DEFAULT_TIMEOUT,
          threads: Optional[int] = None) -> Ranks:
    """Start ``world`` ranks running ``fn(*args)`` (see the module
    docstring) on the card unless ``device="cpu"``, and return without
    waiting; ``threads`` sets each child's intra-op thread count.  Without
    a card it raises, as every entry point does, and starts nothing."""
    dev = resolve_device(device)
    if world < 1:
        raise ValueError(f"world={world} < 1")
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks need {world} cards, have "
                         f"{torch.cuda.device_count()} (NCCL refuses two "
                         "ranks on one device)")
    store = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    context = mp.start_processes(
        _rank_main,
        args=(world, fn, args, dev.type, store, timeout, threads),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(context, world, store)


def spawn(fn: Callable, world: int, *args, **kw) -> List[Any]:
    """:func:`start` and :meth:`Ranks.join`: the ranks' return values in
    rank order."""
    return start(fn, world, *args, **kw).join()
