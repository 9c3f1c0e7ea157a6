"""A model's state split over the ranks of a mesh (port-owned): what a
mixer's one-token decode, or a MoE layer's routing, needs to run on this
rank's share.

On a device mesh the zoo's decode caches lie under ``cache_sharding``
(``repro_torch.dlrt.cache_spec``): a feature dim of every state (a KV
buffer's head_dim or its KV heads, Mamba's d_state and conv channels,
RWKV-6's value dim and token-shift width) is split over ``model``.
:class:`CacheShards` names the ranks of that axis, this rank's place among
them, and, for each leaf of a block's state, the dim its split falls on
(in the block's own coordinates, the node and period axes dropped), or
None.  The mixers compute the new token's inputs whole, update their
block in place and meet the other ranks only in collectives of one
token's size (:meth:`CacheShards.sum`, :meth:`CacheShards.gather`): no
block of a cache ever moves.

A node's batch may be split too (``node_fsdp``: over ``data``).
:class:`RowShards` names the ranks that hold its rows, which a MoE layer
gathers to route the node's whole batch (``repro_torch.models.moe``).
Both are passed explicitly: ``forward(..., rows=)``, ``decode_step(...,
shards=, rows=)``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..collectives import packed_all_gather


class RowShards(NamedTuple):
    """A routing batch whose rows lie on ``size`` ranks of ``group``, this
    rank's ``index``-th in batch order, the same count on each; ``piece``:
    rows of the gathered batch a routing call takes (the train step's
    microbatch), None for all of them."""
    group: Any
    size: int
    index: int
    piece: Optional[int] = None


class CacheShards(NamedTuple):
    """``size`` ranks of ``group`` (this rank ``index``-th) hold a block
    each of the leaves ``dims`` maps to a dim; ``dims``: the state tree,
    each leaf's split dim or None."""
    group: Any
    size: int
    index: int
    dims: Any

    def cols(self, full: int) -> slice:
        """This rank's part of a dim of ``full`` entries."""
        size = full // self.size
        return slice(self.index * size, (self.index + 1) * size)

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of the whole ``t`` along ``dim``."""
        size = t.shape[dim] // self.size
        return t.narrow(dim, self.index * size, size)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order (bit for
        bit, any dtype)."""
        got, = packed_all_gather([t], self.size, self.group)
        shape = list(t.shape)
        shape[dim] *= self.size
        return got.movedim(0, dim).reshape(shape)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (contiguous) summed over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t


def sub(shards: Optional[CacheShards], *keys) -> Optional[CacheShards]:
    """The shards of the state under ``keys`` (None stays None)."""
    if shards is None:
        return None
    dims = shards.dims
    for k in keys:
        dims = dims[k]
    return shards._replace(dims=dims)


def split_dim(shards: Optional[CacheShards], key) -> Optional[int]:
    """Leaf ``key``'s split dim, None without shards."""
    return None if shards is None else shards.dims[key]


def unsupported(what: str, dim) -> NotImplementedError:
    return NotImplementedError(
        f"{what} split on dim {dim} over the mesh: cache_spec puts the "
        "innermost divisible feature dim on 'model', and the decode handles "
        "the dims it picks at the zoo's widths")
