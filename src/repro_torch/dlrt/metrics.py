"""Round-domain evaluation metrics (paper §IV-A4) — a numpy copy of the
round half of ``repro.dlrt.metrics``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

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


def internode_variance(per_node_acc: np.ndarray) -> float:
    """Variance of per-node test accuracies, in percentage points squared."""
    return float(np.var(np.asarray(per_node_acc) * 100.0))


def net_staleness_mean(net_stats) -> float:
    """Mean delivered content staleness in rounds from a dense-network
    ``net_stats`` dict (0.0 when absent or nothing was delivered)."""
    if not net_stats or not net_stats["delivered"]:
        return 0.0
    return net_stats["staleness_sum"] / net_stats["delivered"]
