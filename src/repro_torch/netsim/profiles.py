"""Named network profiles — the port of ``repro.netsim.profiles``, with
the same numbers and errors.

* ``lan``       — single datacenter: sub-ms latency, 10 Gb/s, lossless;
* ``wan``       — cross-region: tens of ms, 200 Mb/s, lossless;
* ``flaky-wan`` — consumer links: high jittery latency, 50 Mb/s, 3%
  loss, optionally a partition splitting the population in half.

``ideal()`` is the zero-latency, zero-loss network, under which the dense
network model is bitwise the engine without one.  :func:`dense_network`
gives a profile as the in-scan model
(:class:`~repro_torch.netsim.dense.DenseNetwork`).
"""
from __future__ import annotations

from typing import Optional

from .faults import FaultConfig, FaultModel
from .transport import NetworkProfile, Partition


def ideal(seed: int = 0) -> NetworkProfile:
    """No latency, no loss."""
    return NetworkProfile(name="ideal", seed=seed)


def lan(seed: int = 0) -> NetworkProfile:
    """Single datacenter: 0.2 ms + up to 0.1 ms jitter, 10 Gb/s."""
    return NetworkProfile(name="lan", base_latency_s=2e-4, jitter_s=1e-4,
                          bandwidth_bps=10e9, drop_rate=0.0, seed=seed)


def wan(seed: int = 0) -> NetworkProfile:
    """Cross-region: 40 ms + up to 20 ms jitter, 200 Mb/s."""
    return NetworkProfile(name="wan", base_latency_s=0.04, jitter_s=0.02,
                          bandwidth_bps=200e6, drop_rate=0.0, seed=seed)


def flaky_wan(n_nodes: int, partition_at: Optional[float] = None,
              partition_len: float = 0.0, seed: int = 0) -> NetworkProfile:
    """Lossy consumer-grade WAN; optionally a half/half partition window
    starting at ``partition_at`` for ``partition_len`` seconds."""
    parts = ()
    if partition_at is not None and partition_len > 0.0:
        half = n_nodes // 2
        parts = (Partition(start=partition_at,
                           end=partition_at + partition_len,
                           groups=(frozenset(range(half)),
                                   frozenset(range(half, n_nodes)))),)
    return NetworkProfile(name="flaky-wan", base_latency_s=0.08,
                          jitter_s=0.06, bandwidth_bps=50e6,
                          drop_rate=0.03, partitions=parts, seed=seed)


def get_profile(name: str, n_nodes: int, seed: int = 0) -> NetworkProfile:
    """The profile called ``name`` (``ValueError`` for an unknown one)."""
    if name == "ideal":
        return ideal(seed)
    if name == "lan":
        return lan(seed)
    if name == "wan":
        return wan(seed)
    if name == "flaky-wan":
        return flaky_wan(n_nodes, seed=seed)
    raise ValueError(f"unknown profile {name!r}; "
                     f"valid: ideal, lan, wan, flaky-wan")


def dense_network(name: str, n_nodes: int, *, round_s: float = 1.0,
                  faults: Optional[FaultModel] = None,
                  max_staleness: int = 8, seed: int = 0):
    """The named profile as the in-scan dense model: pass the result as
    ``RunnerConfig.net``."""
    from .dense import DenseNetwork
    return DenseNetwork(get_profile(name, n_nodes, seed),
                        round_s=round_s, faults=faults,
                        max_staleness=max_staleness)


def churny_faults(n_nodes: int, horizon_s: float,
                  seed: int = 0) -> FaultModel:
    """The churn and straggler mix of the reference's flaky-WAN scenario
    (fig8)."""
    return FaultModel(FaultConfig(
        straggler_fraction=0.25, straggler_slowdown=2.5,
        churn_fraction=0.25, crash_fraction=0.25,
        mean_downtime_s=horizon_s / 5.0, horizon_s=horizon_s,
        seed=seed), n_nodes)
