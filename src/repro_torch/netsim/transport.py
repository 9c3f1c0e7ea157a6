"""The network profile and partition windows — the two frozen dataclasses
of ``repro.netsim.transport`` that the dense in-scan network model reads.

The event-driven ``Transport`` that prices one message at a time is not
part of the port yet; this module holds only the inputs both network
realizations share, so it imports no event loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import FrozenSet, Tuple


@dataclass(frozen=True)
class Partition:
    """During ``[start, end)`` only nodes inside the same group can talk.
    Nodes listed in no group are unreachable for the window."""
    start: float
    end: float
    groups: Tuple[FrozenSet[int], ...]

    def blocks(self, t: float, a: int, b: int) -> bool:
        """Whether the window blocks the edge between ``a`` and ``b`` at
        time ``t``."""
        if not (self.start <= t < self.end):
            return False
        for g in self.groups:
            if a in g and b in g:
                return False
        return True


@dataclass(frozen=True)
class NetworkProfile:
    """Per-link network model; see :mod:`repro_torch.netsim.profiles` for
    the LAN / WAN / flaky-WAN presets."""
    name: str = "ideal"
    base_latency_s: float = 0.0
    jitter_s: float = 0.0            # uniform [0, jitter_s)
    bandwidth_bps: float = math.inf  # payload serialization time
    drop_rate: float = 0.0
    partitions: Tuple[Partition, ...] = ()
    seed: int = 0

    def transfer_seconds(self, size_bytes: int) -> float:
        """Serialization time of a ``size_bytes`` payload (0 at infinite
        bandwidth)."""
        if math.isinf(self.bandwidth_bps):
            return 0.0
        return size_bytes * 8.0 / self.bandwidth_bps
