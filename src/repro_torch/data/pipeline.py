"""Per-node batching pipelines.

:class:`NodeBatcher` / :class:`StackedBatcher` / :class:`TokenBatcher` are
bit-for-bit numpy copies of ``repro.data.pipeline``'s host batchers.  :class:`DeviceDataStream`
keeps the dataset and the ``[n, S]`` shard-index table on the device and
draws every round's ``[n, b, ...]`` batch there, with no host transfer;
:func:`stack_streams` stacks a sweep's per-experiment tables over one
shared dataset.
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

    def slots(self, rnd: int) -> torch.Tensor:
        """Round ``rnd``'s ``[n, b]`` int64 slot positions inside each
        node's shard (``0 <= slot < size``), from the generator keyed
        ``fold_seed(seed, rnd)``."""
        self._gen.manual_seed(fold_seed(self.seed, rnd))
        u = torch.rand((self.n, self.batch), generator=self._gen,
                       device=self.device)
        take = (u * self.sizes[:, None]).long()
        return torch.minimum(take, self.sizes[:, None] - 1)

    def draw(self, rnd: int, take: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """Round ``rnd``'s ``[n, b, ...]`` batch.  ``take [n, b]`` (slot
        positions inside each node's shard, ``0 <= take < size``) replaces
        the generator's draw (:meth:`slots`)."""
        if take is None:
            take = self.slots(rnd)
        else:
            take = torch.as_tensor(take, device=self.device).long()
        sel = self.index.gather(1, take)                         # [n, b]
        return {k: v[sel] for k, v in self.data.items()}


def stack_streams(streams: Sequence[DeviceDataStream]):
    """Stack per-experiment :class:`DeviceDataStream` index tables over one
    shared dataset for the sweep engine — the port of
    ``repro.data.pipeline.stack_streams``, with its checks and errors.

    All streams must draw the same batch size from the same dataset (the
    sweep keeps it on the device once; only the ``[n, S]`` tables are per
    experiment).  Shorter tables are wrap-padded on their ``S`` axis up to
    the widest stream's; padding past ``sizes`` is never indexed, so every
    experiment's draws keep their bits.

    Returns ``(data, index [E, n, S_max] int64, sizes [E, n] int64,
    seeds [E] int64, batch)``, the tensors on experiment 0's device."""
    streams = list(streams)
    if not streams:
        raise ValueError("stack_streams needs at least one stream")
    first = streams[0]
    for e, st in enumerate(streams):
        if st.batch != first.batch:
            raise ValueError(f"experiment {e}: batch {st.batch} != "
                             f"{first.batch} (one vmapped draw shape)")
        if st.n != first.n:
            raise ValueError(f"experiment {e}: covers {st.n} nodes, "
                             f"experiment 0 covers {first.n}")
        same = set(st.data) == set(first.data) and all(
            st.data[k].shape == first.data[k].shape
            and torch.equal(st.data[k].to(first.device), first.data[k])
            for k in first.data)
        if not same:
            raise ValueError(f"experiment {e}: dataset differs from "
                             "experiment 0 — the sweep shares one "
                             "device-resident dataset; vary the "
                             "partition (index tables), not the data")
    s_max = max(st.index.shape[1] for st in streams)
    index = torch.stack([
        torch.as_tensor(np.pad(st.index.cpu().numpy(),
                               ((0, 0), (0, s_max - st.index.shape[1])),
                               mode="wrap")) for st in streams])
    sizes = torch.stack([st.sizes.cpu() for st in streams])
    seeds = torch.as_tensor([st.seed for st in streams], dtype=torch.int64)
    dev = first.device
    return (first.data, index.to(dev), sizes.to(dev), seeds.to(dev),
            first.batch)


class TokenBatcher:
    """Next-token LM batches from a per-node token stream: ``batch``
    windows of ``seq + 1`` tokens at random starts, split into ``tokens``
    and the ``labels`` one position on, both ``[batch, seq]`` int32."""

    def __init__(self, tokens: np.ndarray, batch_size: int, seq_len: int,
                 seed: int):
        self.tokens = tokens
        self.batch = batch_size
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        starts = self.rng.integers(0, len(self.tokens) - self.seq - 1,
                                   self.batch)
        idx = starts[:, None] + np.arange(self.seq + 1)[None]
        window = self.tokens[idx]
        return {"tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int32)}
