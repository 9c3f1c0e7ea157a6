"""Latency/bandwidth/loss-modelled message routing (DESIGN.md §5) — the
port of ``repro.netsim.transport``.

:class:`NetworkProfile` and :class:`Partition` are the inputs every
network realization reads (the dense in-scan model and this module).  A
:class:`Transport` turns ``send(src, dst, payload)`` into a delivery event
on the shared :class:`~repro_torch.netsim.events.EventLoop`:

    deliver_at = now + base_latency + jitter + size_bytes * 8 / bandwidth

Messages can be dropped (i.i.d. loss rate), blocked by a network
partition window, or black-holed because an endpoint is down (fault
model).  All drops are visible to the simulator immediately — ``send``
returns ``None`` — which models sender-side failure detection; the async
runner uses that to shrink the set of transfers a receiver waits for
instead of deadlocking.

The transport keeps its own RNG so network randomness never perturbs
protocol RNG streams: a zero-latency, zero-loss profile is *exactly* the
idealized network the synchronous runner assumes.

Randomness comes in two flavours.  When the caller supplies the round a
message belongs to (``send(..., rnd=r)``, which the async runner always
does), jitter and loss are read from the keyed ``[n, n]`` matrices of
:mod:`repro_torch.netsim.sampling` — the draws the dense model makes for
the same ``(profile.seed, round, stream)``, so the two network
realizations price the same edge the same way.  The matrices are made
on the CPU whatever device the runner trains on (event times are host
numbers, so the card and the CPU schedule the same events), and
``draws`` replaces their uniforms (the reference's ``jax.random`` bits in
the parity tests).  Without a round the transport falls back to its
sequential numpy RNG (the reference's distributions and draws).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from . import sampling
from .events import EventLoop
from .messages import Packet

DELIVER_KIND = "net.deliver"


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


@dataclass
class TransportStats:
    """Message counters: totals, per-kind tallies and the in-flight
    ledger."""
    sent: int = 0
    delivered: int = 0
    dropped: int = 0
    bytes_sent: int = 0
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    sent_by_kind: Dict[str, int] = field(default_factory=dict)
    dropped_by_kind: Dict[str, int] = field(default_factory=dict)
    in_flight: int = 0
    peak_in_flight: int = 0


class Transport:
    """Routes messages over ``profile`` on ``loop``.  ``n_nodes`` enables
    the keyed path for sends that name their round; ``draws(rnd, stream)``
    returns that round's ``[n, n]`` uniforms on a stream in place of the
    CPU generator's."""

    def __init__(self, profile: NetworkProfile, loop: EventLoop,
                 faults=None, deliver_phase: int = 0,
                 n_nodes: Optional[int] = None,
                 draws: Optional[Callable[[int, int],
                                          torch.Tensor]] = None):
        self.profile = profile
        self.loop = loop
        self.faults = faults
        self.deliver_phase = deliver_phase
        self.n_nodes = n_nodes            # enables the keyed sampler path
        self.draws = draws
        self.stats = TransportStats()
        self._rng = np.random.default_rng(profile.seed)
        self._keyed_cache: Dict[Tuple[int, int], np.ndarray] = {}

    # -- helpers -----------------------------------------------------------

    def _up(self, node: int, t: float) -> bool:
        return self.faults is None or self.faults.is_up(node, t)

    def _keyed(self, rnd: int, stream: int) -> np.ndarray:
        """Per-round keyed draw matrix (jitter seconds or drop coins),
        shared with the dense model; cached, bounded."""
        key = (rnd, stream)
        hit = self._keyed_cache.get(key)
        if hit is not None:
            return hit
        n = self.n_nodes
        u = None if self.draws is None else self.draws(rnd, stream)
        if stream == sampling.STREAM_JITTER:
            mat = sampling.jitter_matrix(self.profile, rnd, n, "cpu", u)
        else:
            mat = sampling.drop_matrix(self.profile, rnd, n, "cpu", stream,
                                       u)
        mat = mat.numpy()
        if len(self._keyed_cache) > 16:
            self._keyed_cache.pop(next(iter(self._keyed_cache)))
        self._keyed_cache[key] = mat
        return mat

    def _latency(self, rnd: Optional[int], src: int, dst: int) -> float:
        p = self.profile
        if p.jitter_s <= 0.0:
            return p.base_latency_s
        if rnd is not None and self.n_nodes is not None:
            jit = float(self._keyed(rnd, sampling.STREAM_JITTER)[dst, src])
        else:
            jit = float(self._rng.uniform(0.0, p.jitter_s))
        return p.base_latency_s + jit

    def _dropped(self, rnd: Optional[int], kind: str,
                 src: int, dst: int) -> bool:
        p = self.profile
        if p.drop_rate <= 0.0:
            return False
        if rnd is not None and self.n_nodes is not None:
            stream = sampling.STREAM_DROP_MODEL if kind == "model" \
                else sampling.STREAM_DROP_CTRL
            return bool(self._keyed(rnd, stream)[dst, src])
        return bool(self._rng.random() < p.drop_rate)

    def _lost(self, t_send: float, t_deliver: float, src: int, dst: int,
              rnd: Optional[int] = None, kind: str = "model") -> bool:
        p = self.profile
        if any(part.blocks(t_send, src, dst) for part in p.partitions):
            return True
        if not self._up(src, t_send) or not self._up(dst, t_deliver):
            return True
        return self._dropped(rnd, kind, src, dst)

    # -- API ---------------------------------------------------------------

    def send(self, src: int, dst: int, kind: str, payload: Any,
             size_bytes: int, phase: Optional[int] = None,
             rnd: Optional[int] = None) -> Optional[Packet]:
        """Route one message; returns the in-flight packet, or ``None``
        when the network ate it (loss, partition, dead endpoint).
        ``phase`` overrides the delivery event's intra-instant phase;
        ``rnd`` keys jitter/loss draws by ``(seed, round, edge)`` (the
        draws the dense model makes) instead of the sequential RNG."""
        t = self.loop.now
        deliver_at = t + self._latency(rnd, src, dst) \
            + self.profile.transfer_seconds(size_bytes)
        self.stats.sent += 1
        self.stats.bytes_sent += size_bytes
        self.stats.bytes_by_kind[kind] = \
            self.stats.bytes_by_kind.get(kind, 0) + size_bytes
        self.stats.sent_by_kind[kind] = \
            self.stats.sent_by_kind.get(kind, 0) + 1
        if self._lost(t, deliver_at, src, dst, rnd=rnd, kind=kind):
            self.stats.dropped += 1
            self.stats.dropped_by_kind[kind] = \
                self.stats.dropped_by_kind.get(kind, 0) + 1
            return None
        pkt = Packet(src=src, dst=dst, kind=kind, payload=payload,
                     size_bytes=size_bytes, sent_at=t,
                     deliver_at=deliver_at)
        self.stats.in_flight += 1
        self.stats.peak_in_flight = max(self.stats.peak_in_flight,
                                        self.stats.in_flight)
        self.loop.schedule_at(deliver_at, DELIVER_KIND, pkt,
                              phase=self.deliver_phase
                              if phase is None else phase)
        return pkt

    def delivered(self, pkt: Packet) -> None:
        """The runner acknowledges a delivery event it consumed."""
        self.stats.delivered += 1
        self.stats.in_flight -= 1
