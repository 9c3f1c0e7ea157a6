"""Round-domain evaluation metrics (paper §IV-A4) — a numpy copy of the
round half of ``repro.dlrt.metrics``."""
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


def internode_variance(per_node_acc: np.ndarray) -> float:
    """Variance of per-node test accuracies, in percentage points squared."""
    return float(np.var(np.asarray(per_node_acc) * 100.0))


def net_staleness_mean(net_stats) -> float:
    """Mean delivered content staleness in rounds from a dense-network
    ``net_stats`` dict (0.0 when absent or nothing was delivered)."""
    if not net_stats or not net_stats["delivered"]:
        return 0.0
    return net_stats["staleness_sum"] / net_stats["delivered"]
