"""Dense-state network model for the round engine — the port of
``repro.netsim.dense.DenseNetwork`` (DESIGN.md §9).

One engine round is one virtual time slot of ``round_s`` seconds: fast
nodes complete one local round a slot, a straggler with compute
multiplier ``c`` one every ``c`` slots, a churned-out node none (its
parameters freeze until it rejoins).

**Staleness.** An edge whose delay (base latency + keyed jitter +
serialization of the wire payload) fits inside one slot delivers fresh
parameters; a longer one delivers from ``s = floor(delay / round_s)``
rounds back, out of a ring of the last ``S`` post-step snapshots the
engine carries.  ``S`` (:meth:`DenseNetwork.depth`) is the largest
reachable staleness plus one, capped by ``max_staleness``.

**Drops.** Bernoulli loss, partition windows and down endpoints remove
the edge from the round's delivery; uniform strategies renormalize over
what arrived, fixed-W strategies fold the missing mass into self-weight.

The draws are keyed by ``(profile.seed, round, stream)``
(:mod:`.sampling`) and the fault timeline is a host numpy array from its
seed, so a trajectory does not depend on chunk boundaries.  The division
``delay / round_s`` is by an f32 tensor on the delay's device: PyTorch's
CUDA division by a host number multiplies by its reciprocal, which moves
a delay at a slot boundary into the other slot.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import sampling
from .faults import FaultModel
from .transport import NetworkProfile


class NetDraws(NamedTuple):
    """One round's network uniforms, ``[n, n]`` f32 each, or ``None``
    where the profile draws nothing (no jitter, no loss)."""
    jitter_u: Optional[torch.Tensor]    # stream STREAM_JITTER
    drop_u: Optional[torch.Tensor]      # stream STREAM_DROP_MODEL


class DenseNetwork:
    """The network model the round engine threads through every round
    (``RunnerConfig.net``).

    ``profile`` — the :class:`NetworkProfile`; ``round_s`` — virtual
    seconds per round; ``faults`` — an optional :class:`FaultModel` for
    churn and stragglers; ``max_staleness`` — the ring's depth cap (delays
    past it clamp to the oldest snapshot).
    """

    def __init__(self, profile: NetworkProfile, *, round_s: float = 1.0,
                 faults: Optional[FaultModel] = None,
                 max_staleness: int = 8):
        if round_s <= 0.0:
            raise ValueError("round_s must be positive")
        if max_staleness < 1:
            raise ValueError("max_staleness must be >= 1")
        self.profile = profile
        self.round_s = float(round_s)
        self.faults = faults
        self.max_staleness = int(max_staleness)

    def depth(self, model_bytes: int) -> int:
        """Ring depth ``S``: 1 + the largest reachable staleness of a
        ``model_bytes`` payload, capped at ``max_staleness``."""
        p = self.profile
        worst = p.base_latency_s + p.jitter_s \
            + p.transfer_seconds(model_bytes)
        return 1 + min(self.max_staleness - 1,
                       int(math.floor(worst / self.round_s)))

    def draws(self, rnd: int, n: int, device="cuda") -> NetDraws:
        """Round ``rnd``'s keyed uniforms on ``device``."""
        dev = resolve_device(device)
        p = self.profile
        jit = sampling.uniform(p.seed, rnd, n, sampling.STREAM_JITTER, dev) \
            if p.jitter_s > 0.0 else None
        drop = sampling.uniform(p.seed, rnd, n, sampling.STREAM_DROP_MODEL,
                                dev) if p.drop_rate > 0.0 else None
        return NetDraws(jit, drop)

    def staleness_matrix(self, rnd: int, n: int, model_bytes: int,
                         depth: int, *, draws: Optional[NetDraws] = None,
                         device="cuda") -> torch.Tensor:
        """``[n, n]`` int32: how many rounds back edge j -> i delivers from
        this round (0 = fresh; clamped to ``depth - 1``; 0 on the
        diagonal).  ``draws`` replaces the keyed draw."""
        dev = resolve_device(device)
        u = None if draws is None else draws.jitter_u
        lat = sampling.latency_matrix(self.profile, rnd, n, model_bytes,
                                      dev, u)
        slot = torch.tensor(np.float32(self.round_s), device=dev)
        s = torch.floor(lat / slot).to(torch.int32)
        s = s.clamp(0, depth - 1)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        return torch.where(eye, torch.zeros_like(s), s)

    def drop_mask(self, rnd: int, n: int, *,
                  draws: Optional[NetDraws] = None,
                  device="cuda") -> torch.Tensor:
        """``[n, n]`` bool: edges the network eats this round (Bernoulli
        loss + partition windows at the round's f32 start time; endpoint
        liveness is separate).  ``draws`` replaces the keyed draw."""
        dev = resolve_device(device)
        u = None if draws is None else draws.drop_u
        lost = sampling.drop_matrix(self.profile, rnd, n, dev,
                                    sampling.STREAM_DROP_MODEL, u)
        if self.profile.partitions:
            t = sampling.round_time(rnd, self.round_s)
            lost = lost | sampling.partition_matrix(self.profile, t, n, dev)
        return lost

    def round_masks(self, rounds: int, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(up [rounds, n], step [rounds, n])`` bool numpy arrays from
        the seeded fault timeline, all True without faults."""
        if self.faults is None:
            ones = np.ones((rounds, n), bool)
            return ones, ones
        if self.faults.n != n:
            raise ValueError(f"fault model covers {self.faults.n} nodes, "
                             f"engine has {n}")
        up = self.faults.round_up_masks(rounds, self.round_s)
        return up, self.faults.round_step_masks(rounds, self.round_s,
                                                up=up)
