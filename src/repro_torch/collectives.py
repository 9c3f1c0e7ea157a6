"""The port's collective helpers on ``torch.distributed`` (any process
group: NCCL for CUDA tensors, gloo for CPU tensors), shared by the
meshes' engines (``repro_torch.dlrt``) and the models' mesh paths
(``repro_torch.models.moe``, ``repro_torch.models.shards``)."""
from __future__ import annotations

import torch
import torch.distributed as dist

# Byte alignment of each tensor inside a packed gather buffer.
_ALIGN = 128

# torch 2.13 renames these two (the old names warn); both take (output,
# input) as before.
all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def packed_all_gather(tensors, world: int, group=None):
    """Every rank's copy of each tensor (any dtypes) as ``[world, ...]``,
    in group-rank order, bit for bit: one ``all_gather`` of all of them
    packed as bytes into one buffer (``group`` None: the default group of
    ``world`` ranks)."""
    segs, spans, at = [], [], 0
    for t in tensors:
        b = t.contiguous().view(torch.uint8).reshape(-1)
        pad = -b.numel() % _ALIGN
        segs.append(b)
        if pad:
            segs.append(b.new_zeros(pad))
        spans.append((at, b.numel()))
        at += b.numel() + pad
    send = torch.cat(segs) if len(segs) > 1 else segs[0]
    recv = torch.empty(world * at, dtype=torch.uint8, device=send.device)
    all_gather_into(recv, send, group=group)
    recv = recv.view(world, at)
    return [recv[:, a:a + nb].contiguous().view(t.dtype).reshape(
        (world,) + tuple(t.shape)) for t, (a, nb) in zip(tensors, spans)]
