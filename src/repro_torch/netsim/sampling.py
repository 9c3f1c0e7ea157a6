"""Keyed network randomness of the dense network model — the port of
``repro.netsim.sampling``.

Every stochastic network effect (latency jitter, Bernoulli message loss)
is a uniform ``[n, n]`` draw keyed by ``(profile.seed, round, stream)``:
the reference folds a threefry key, ``fold_in(fold_in(PRNGKey(seed),
round), stream)``; the port seeds a CPU ``torch.Generator`` with
``fold_seed(fold_seed(seed, round), stream)`` and moves the draw to the
device, so a round's draws are the same on the card and on the CPU and do
not depend on the rounds that ran before (chunk invariance).  A
``torch.Generator`` cannot give threefry's bits, so every function also
takes its uniforms as ``u``: the parity tests hand over the reference's.

The reference's ``round_key(seed, rnd)`` (a threefry key) becomes
:func:`round_key`, the integer ``fold_seed(seed, rnd)`` the stream's
generator seed is folded from.  The sweep engine's folded twins
(:func:`jitter_matrix_folded`, :func:`drop_matrix_folded`) always draw and
take the profile's scale as a tensor, so one call serves a stack of
experiments; ``u * 0 == 0`` and ``u < 0`` keep the unfolded functions'
zero paths bit for bit.

Entry ``[i, j]`` belongs to the edge *j sends to i* (receiver row, sender
column).  The arithmetic is the reference's: the fixed part of the
latency (base latency plus serialization) is one ``np.float32`` added to
``u * jitter_s``, and a message is lost where ``u < drop_rate``; both
factors are f32 tensors on the draw's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import fold_seed

# Independent sub-streams per round: jitter draws must not be correlated
# with drop draws, and a control packet's drop coin must differ from the
# model transfer's on the same edge in the same round.
STREAM_JITTER = 0
STREAM_DROP_MODEL = 1
STREAM_DROP_CTRL = 2


def round_key(seed: int, rnd: int) -> int:
    """The base key of one round's network draws, ``fold_seed(seed, rnd)``
    (the reference's ``fold_in(PRNGKey(seed), rnd)``); each stream's
    generator is seeded ``fold_seed(round_key(seed, rnd), stream)``."""
    return fold_seed(seed, rnd)


def uniform(seed: int, rnd: int, n: int, stream: int,
            device) -> torch.Tensor:
    """``[n, n]`` f32 uniform in ``[0, 1)`` keyed by ``(seed, rnd,
    stream)``, drawn on the CPU and moved to ``device``."""
    gen = torch.Generator().manual_seed(fold_seed(round_key(seed, rnd),
                                                  stream))
    return torch.rand((n, n), generator=gen,
                      dtype=torch.float32).to(device)


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(x), device=device)


def jitter_matrix(profile, rnd: int, n: int, device,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge latency jitter seconds, ``[n, n]`` f32 uniform in
    ``[0, profile.jitter_s)``; zeros without jitter."""
    if profile.jitter_s <= 0.0:
        return torch.zeros((n, n), dtype=torch.float32, device=device)
    if u is None:
        u = uniform(profile.seed, rnd, n, STREAM_JITTER, device)
    return u.to(device) * _f32(profile.jitter_s, device)


def latency_matrix(profile, rnd: int, n: int, size_bytes: int, device,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Total per-edge delay seconds of a ``size_bytes`` payload: base
    latency + keyed jitter + serialization time, ``[n, n]`` f32.  The
    deterministic part is folded to one f32 first, so the sum is one add,
    as in the reference."""
    fixed = np.float32(profile.base_latency_s
                       + profile.transfer_seconds(size_bytes))
    return _f32(fixed, device) + jitter_matrix(profile, rnd, n, device, u)


def drop_matrix(profile, rnd: int, n: int, device,
                stream: int = STREAM_DROP_MODEL,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bernoulli loss mask ``[n, n]`` bool (True = the network eats the
    message on edge j -> i this round)."""
    if profile.drop_rate <= 0.0:
        return torch.zeros((n, n), dtype=torch.bool, device=device)
    if u is None:
        u = uniform(profile.seed, rnd, n, stream, device)
    return u.to(device) < _f32(profile.drop_rate, device)


def jitter_matrix_folded(seed: int, rnd: int, n: int, jitter_s, device,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sweep's twin of :func:`jitter_matrix`: always draws (or takes
    ``u``, which may be a stack of experiments' ``[E, n, n]`` uniforms) and
    multiplies by ``jitter_s`` (a number, or an f32 tensor that broadcasts
    against ``u``, one scale per experiment).  ``u * 0`` is exactly 0, so
    a zero scale gives the unfolded zeros bit for bit."""
    if u is None:
        u = uniform(seed, rnd, n, STREAM_JITTER, device)
    return u.to(device) * _f32(jitter_s, device)


def drop_matrix_folded(seed: int, rnd: int, n: int, drop_rate, device,
                       stream: int = STREAM_DROP_MODEL,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sweep's twin of :func:`drop_matrix`: always draws (or takes
    ``u``, as in :func:`jitter_matrix_folded`) and compares with
    ``drop_rate`` (a number or a broadcasting f32 tensor).  ``u < 0`` is
    all False, so a zero rate gives the unfolded mask bit for bit."""
    if u is None:
        u = uniform(seed, rnd, n, stream, device)
    return u.to(device) < _f32(drop_rate, device)


def round_time(rnd: int, round_s: float) -> np.float32:
    """Virtual time at the start of round ``rnd`` as the reference's scan
    computes it: ``rnd * round_s`` in f32 (its round index is a traced
    int32), not the f64 product of two host numbers, which can fall on the
    other side of a window's edge."""
    return np.float32(rnd) * np.float32(round_s)


def partition_matrix(profile, t, n: int, device) -> torch.Tensor:
    """Partition-block mask ``[n, n]`` bool at virtual time ``t`` (True =
    the edge crosses an active window and is blocked).  The window's ends
    are compared with ``t`` in f32, as in the reference's scan."""
    t = np.float32(t)
    blocked = torch.zeros((n, n), dtype=torch.bool, device=device)
    for part in profile.partitions:
        if not (np.float32(part.start) <= t < np.float32(part.end)):
            continue
        # an edge passes only when both endpoints share a group; nodes in
        # no group are unreachable for the window (Partition.blocks).
        same = torch.zeros((n, n), dtype=torch.bool, device=device)
        for g in part.groups:
            one = torch.zeros((n,), dtype=torch.bool, device=device)
            one[torch.as_tensor(sorted(g), dtype=torch.long,
                                device=device)] = True
            same |= one[:, None] & one[None, :]
        blocked |= ~same
    return blocked
