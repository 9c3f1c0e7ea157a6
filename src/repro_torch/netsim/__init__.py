"""Network simulation for decentralized learning — the port of
``repro.netsim`` (DESIGN.md §5 and §9):

* :mod:`~repro_torch.netsim.events`    — priority-queue event loop,
  virtual clock;
* :mod:`~repro_torch.netsim.transport` — :class:`NetworkProfile`,
  :class:`Partition` and the per-message :class:`Transport`
  (latency/bandwidth/loss/partitions);
* :mod:`~repro_torch.netsim.faults`    — churn and stragglers, a seeded
  numpy timeline (the reference's bit for bit);
* :mod:`~repro_torch.netsim.messages`  — network envelopes for the
  protocol message objects of :mod:`repro_torch.core.protocol`;
* :mod:`~repro_torch.netsim.profiles`  — the ideal / LAN / WAN /
  flaky-WAN presets;
* :mod:`~repro_torch.netsim.sampling`  — per-``(seed, round, stream)``
  keyed draws shared by the transport and the dense model;
* :mod:`~repro_torch.netsim.dense`     — :class:`DenseNetwork`, the
  round-quantized model the round engine threads through every round
  (``RunnerConfig.net``);
* :mod:`~repro_torch.netsim.async_runner` — :class:`AsyncRunner`, the
  event-driven runtime.

The reference's ``SweepNetwork`` (the sweep engine's batched network) is
not part of the port yet.
"""
from . import profiles, sampling
from .async_runner import AsyncConfig, AsyncRunner
from .dense import DenseNetwork, NetDraws
from .events import Event, EventLoop
from .faults import FaultConfig, FaultModel
from .messages import CTRL_BYTES, ModelTransfer, Packet
from .transport import NetworkProfile, Partition, Transport, TransportStats

__all__ = ["profiles", "sampling", "AsyncConfig", "AsyncRunner",
           "DenseNetwork", "NetDraws", "Event", "EventLoop",
           "FaultConfig", "FaultModel", "CTRL_BYTES", "ModelTransfer",
           "Packet", "NetworkProfile", "Partition", "Transport",
           "TransportStats"]
