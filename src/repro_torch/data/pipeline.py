"""Per-node batching pipelines.

:class:`NodeBatcher` / :class:`StackedBatcher` are bit-for-bit numpy copies
of ``repro.data.pipeline``'s host batchers.  :class:`DeviceDataStream`
keeps the dataset and the ``[n, S]`` shard-index table on the device and
draws every round's ``[n, b, ...]`` batch there, with no host transfer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import fold_seed, resolve_device
from .synthetic import ImageDataset


class NodeBatcher:
    """Infinite shuffled batches from one node's shard."""

    def __init__(self, ds: ImageDataset, indices: np.ndarray,
                 batch_size: int, seed: int):
        if len(indices) == 0:
            raise ValueError("empty shard")
        self.ds = ds
        self.indices = np.asarray(indices)
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(len(self.indices))
        self._pos = 0

    def next(self) -> Dict[str, np.ndarray]:
        """The next ``batch`` samples, reshuffling at each epoch end."""
        take: List[int] = []
        while len(take) < self.batch:
            if self._pos >= len(self._order):
                self._order = self.rng.permutation(len(self.indices))
                self._pos = 0
            take.append(self.indices[self._order[self._pos]])
            self._pos += 1
        sel = np.asarray(take)
        return {"images": self.ds.images[sel], "labels": self.ds.labels[sel]}


class StackedBatcher:
    """One batch per node, stacked on a leading node axis."""

    def __init__(self, ds: ImageDataset, parts: Sequence[np.ndarray],
                 batch_size: int, seed: int = 0):
        self.nodes = [NodeBatcher(ds, p, batch_size, seed + 7919 * i)
                      for i, p in enumerate(parts)]

    def next(self) -> Dict[str, np.ndarray]:
        """``{"images": [n, b, H, W, C], "labels": [n, b]}`` numpy."""
        batches = [n.next() for n in self.nodes]
        return {k: np.stack([b[k] for b in batches])
                for k in batches[0]}


class DeviceDataStream:
    """Device-resident dataset: the shared ``[N_total, ...]`` arrays plus
    an ``[n, S]`` index table (``S`` = largest shard; shorter shards wrap)
    live on ``device`` once, and :meth:`draw` builds each round's batch
    there.

    Batch identity: node ``i``'s round-``r`` sample slots come from a
    generator seeded with ``fold_seed(seed, r)``, so a batch is a pure
    function of ``(seed, r, i)`` on a given device.  Sampling is with
    replacement and uniform over each node's true shard.  The reference
    draws its slots with ``jax.random``, whose bits a ``torch.Generator``
    cannot give; the parity tests pass those slots in as ``take``.
    """

    def __init__(self, ds: ImageDataset, parts: Sequence[np.ndarray],
                 batch_size: int, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        sizes = [len(p) for p in parts]
        if min(sizes) == 0:
            raise ValueError("empty shard")
        S = max(sizes)
        index = np.stack([np.pad(np.asarray(p), (0, S - len(p)),
                                 mode="wrap") for p in parts])
        self.data = {
            "images": torch.as_tensor(ds.images, device=self.device),
            "labels": torch.as_tensor(ds.labels.astype(np.int64),
                                      device=self.device)}
        self.index = torch.as_tensor(index.astype(np.int64),
                                     device=self.device)         # [n, S]
        self.sizes = torch.as_tensor(np.asarray(sizes, np.int64),
                                     device=self.device)         # [n]
        self.batch = batch_size
        self.seed = seed
        self.n = len(parts)
        self._gen = torch.Generator(device=self.device)

    def draw(self, rnd: int, take: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """Round ``rnd``'s ``[n, b, ...]`` batch.  ``take [n, b]`` (slot
        positions inside each node's shard, ``0 <= take < size``) replaces
        the generator's draw."""
        if take is None:
            self._gen.manual_seed(fold_seed(self.seed, rnd))
            u = torch.rand((self.n, self.batch), generator=self._gen,
                           device=self.device)
            take = (u * self.sizes[:, None]).long()
            take = torch.minimum(take, self.sizes[:, None] - 1)
        else:
            take = torch.as_tensor(take, device=self.device).long()
        sel = self.index.gather(1, take)                         # [n, b]
        return {k: v[sel] for k, v in self.data.items()}
