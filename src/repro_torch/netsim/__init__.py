"""The dense in-scan network model — the port of the single-experiment
half of ``repro.netsim`` (DESIGN.md §9):

* :mod:`~repro_torch.netsim.transport` — :class:`NetworkProfile` and
  :class:`Partition`, the inputs every network realization reads;
* :mod:`~repro_torch.netsim.faults`    — churn and stragglers, a seeded
  numpy timeline (the reference's bit for bit);
* :mod:`~repro_torch.netsim.profiles`  — the ideal / LAN / WAN /
  flaky-WAN presets;
* :mod:`~repro_torch.netsim.sampling`  — per-``(seed, round, stream)``
  keyed draws;
* :mod:`~repro_torch.netsim.dense`     — :class:`DenseNetwork`, the
  round-quantized model the round engine threads through every round
  (``RunnerConfig.net``).
"""
from . import profiles, sampling
from .dense import DenseNetwork, NetDraws
from .faults import FaultConfig, FaultModel
from .transport import NetworkProfile, Partition

__all__ = ["profiles", "sampling", "DenseNetwork", "NetDraws",
           "FaultConfig", "FaultModel", "NetworkProfile", "Partition"]
