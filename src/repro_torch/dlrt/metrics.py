"""Evaluation metrics — a numpy copy of ``repro.dlrt.metrics``: the
round-domain log (paper §IV-A4) and the wall-clock-domain log of the
event-driven runtime (:class:`NetRecord`, :class:`NetMetricsLog`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RoundRecord:
    """One evaluation point: mean test accuracy/loss over nodes,
    inter-node accuracy variance (percentage points squared), cumulative
    comm bytes, isolated-node count, and the per-node accuracy [n]."""
    rnd: int
    mean_accuracy: float
    mean_loss: float
    internode_variance: float
    comm_bytes: int
    isolated: int
    per_node_accuracy: Optional[np.ndarray] = None


@dataclass
class MetricsLog:
    """Append-only round-domain evaluation log."""
    records: List[RoundRecord] = field(default_factory=list)

    def add(self, rec: RoundRecord) -> None:
        """Append one evaluation point."""
        self.records.append(rec)

    def last(self) -> RoundRecord:
        """Most recent record (raises on an empty log)."""
        return self.records[-1]

    def best_accuracy(self) -> float:
        """Best mean accuracy over all evaluation points."""
        return max(r.mean_accuracy for r in self.records)

    def rounds_to_accuracy(self, target: float) -> Optional[int]:
        """First round reaching ``target`` mean accuracy (paper's
        convergence-efficiency comparison) or None."""
        for r in self.records:
            if r.mean_accuracy >= target:
                return r.rnd
        return None

    def comm_to_accuracy(self, target: float) -> Optional[int]:
        """Cumulative bytes moved when ``target`` mean accuracy is first
        reached (the paper's communication-efficiency axis) or None."""
        for r in self.records:
            if r.mean_accuracy >= target:
                return r.comm_bytes
        return None

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Column-wise view for plotting/CSV (one entry per record)."""
        return {
            "round": np.array([r.rnd for r in self.records]),
            "accuracy": np.array([r.mean_accuracy for r in self.records]),
            "loss": np.array([r.mean_loss for r in self.records]),
            "variance": np.array([r.internode_variance
                                  for r in self.records]),
            "comm_bytes": np.array([r.comm_bytes for r in self.records]),
            "isolated": np.array([r.isolated for r in self.records]),
        }


# ---------------------------------------------------------------------------
# Wall-clock-domain records (event-driven runtime).
# ---------------------------------------------------------------------------

@dataclass
class NetRecord:
    """One evaluation point of the event-driven runtime, stamped with the
    virtual wall clock and the network-layer counters at that instant."""
    t: float                      # virtual seconds
    rnd: int                      # min completed round across live nodes
    mean_accuracy: float
    mean_loss: float
    internode_variance: float
    model_bytes: int              # cumulative model-transfer payload
    control_bytes: int            # cumulative negotiation/control payload
    messages_in_flight: int
    dropped: int                  # cumulative messages lost in the network
    dead: int                     # nodes currently down
    staleness_mean: float         # mean model age in receiver rounds;
                                  # negative = sender ran ahead of a
                                  # straggling receiver


@dataclass
class NetMetricsLog:
    """Wall-clock-domain log of the event-driven runtime: evaluation
    records indexed by virtual seconds plus the global staleness
    histogram (model age in rounds -> count)."""
    records: List[NetRecord] = field(default_factory=list)
    staleness_hist: Dict[int, int] = field(default_factory=dict)

    def add(self, rec: NetRecord) -> None:
        """Append one evaluation point."""
        self.records.append(rec)

    def observe_staleness(self, rounds_old: int) -> None:
        """``rounds_old = receiver_round - sender_round`` for one mixed-in
        model copy; negative values mean the *receiver* was the straggler
        (the sender's model comes from a later round than the receiver's
        own)."""
        key = int(rounds_old)
        self.staleness_hist[key] = self.staleness_hist.get(key, 0) + 1

    def last(self) -> NetRecord:
        """Most recent record (raises on an empty log)."""
        return self.records[-1]

    def best_accuracy(self) -> float:
        """Best mean accuracy over all evaluation points."""
        return max(r.mean_accuracy for r in self.records)

    def time_to_accuracy(self, target: float) -> Optional[float]:
        """Virtual seconds until mean accuracy first reaches ``target``
        (the deployment-level convergence metric) or None."""
        for r in self.records:
            if r.mean_accuracy >= target:
                return r.t
        return None

    def staleness_mean(self) -> float:
        """Histogram mean: average mixed-in model age in rounds (0 =
        always fresh; negative = receivers lagged their senders)."""
        if not self.staleness_hist:
            return 0.0
        total = sum(self.staleness_hist.values())
        return sum(k * v for k, v in self.staleness_hist.items()) / total

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Column-wise view for plotting/CSV (one entry per record)."""
        return {
            "t": np.array([r.t for r in self.records]),
            "round": np.array([r.rnd for r in self.records]),
            "accuracy": np.array([r.mean_accuracy for r in self.records]),
            "loss": np.array([r.mean_loss for r in self.records]),
            "variance": np.array([r.internode_variance
                                  for r in self.records]),
            "model_bytes": np.array([r.model_bytes for r in self.records]),
            "control_bytes": np.array([r.control_bytes
                                       for r in self.records]),
            "in_flight": np.array([r.messages_in_flight
                                   for r in self.records]),
            "dropped": np.array([r.dropped for r in self.records]),
            "dead": np.array([r.dead for r in self.records]),
        }


def internode_variance(per_node_acc: np.ndarray) -> float:
    """Variance of per-node test accuracies, in percentage points squared."""
    return float(np.var(np.asarray(per_node_acc) * 100.0))


def net_staleness_mean(net_stats) -> float:
    """Mean delivered content staleness in rounds from a dense-network
    ``net_stats`` dict (0.0 when absent or nothing was delivered)."""
    if not net_stats or not net_stats["delivered"]:
        return 0.0
    return net_stats["staleness_sum"] / net_stats["delivered"]
