"""Node fault model: churn (crash / leave / rejoin) and stragglers
(DESIGN.md §5) — a copy of ``repro.netsim.faults``: the timelines are
numpy draws from ``np.random.default_rng(seed)``, so the port's masks are
the reference's bit for bit.

The fault timeline is materialized up-front from a seed, so a run is
reproducible and the transport / runner can answer ``is_up(node, t)``
without mutable bookkeeping:

* a ``churn_fraction`` of nodes goes down once, at a uniform time in the
  horizon, for an exponentially distributed outage
  (``mean_downtime_s``); a ``crash_fraction`` of *those* never returns;
* a ``straggler_fraction`` of nodes runs every local step
  ``straggler_slowdown`` times slower (the deployment-heterogeneity
  effect arXiv:2503.11828 measures).

With every knob at zero the model is inert — `FaultModel.none(n)` — and
the async runtime degenerates to fault-free execution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FaultConfig:
    """The fault mix: straggler share and slowdown, churn share, the share
    of churned nodes that never return, the mean outage and the horizon in
    which outages start (seconds), and the timeline's seed."""
    straggler_fraction: float = 0.0
    straggler_slowdown: float = 1.0   # compute-time multiplier
    churn_fraction: float = 0.0       # nodes that go down at some point
    crash_fraction: float = 0.0       # of churned nodes: never rejoin
    mean_downtime_s: float = 0.0      # exponential outage duration
    horizon_s: float = 0.0            # window in which outages start
    seed: int = 0


class FaultModel:
    """The seeded fault timeline of ``n`` nodes: per-node compute
    multipliers and ``[start, end)`` down windows."""

    def __init__(self, cfg: FaultConfig, n: int):
        self.cfg = cfg
        self.n = n
        rng = np.random.default_rng(cfg.seed)
        self._slowdown = np.ones(n)
        n_strag = int(round(cfg.straggler_fraction * n))
        if n_strag > 0:
            idx = rng.choice(n, size=n_strag, replace=False)
            self._slowdown[idx] = cfg.straggler_slowdown
        # down windows: node -> list of [start, end)
        self._down: Dict[int, List[Tuple[float, float]]] = {
            i: [] for i in range(n)}
        n_churn = int(round(cfg.churn_fraction * n))
        if n_churn > 0 and cfg.horizon_s > 0.0:
            churners = rng.choice(n, size=n_churn, replace=False)
            n_crash = int(round(cfg.crash_fraction * n_churn))
            crashers = set(churners[:n_crash].tolist())
            for i in churners:
                start = float(rng.uniform(0.0, cfg.horizon_s))
                if int(i) in crashers:
                    end = math.inf
                elif cfg.mean_downtime_s > 0.0:
                    end = start + float(rng.exponential(cfg.mean_downtime_s))
                else:
                    end = start
                self._down[int(i)].append((start, end))

    @classmethod
    def none(cls, n: int) -> "FaultModel":
        """The inert model: no stragglers, no churn."""
        return cls(FaultConfig(), n)

    # -- queries -----------------------------------------------------------

    def compute_multiplier(self, node: int) -> float:
        """``node``'s compute-time multiplier (1 unless a straggler)."""
        return float(self._slowdown[node])

    def is_up(self, node: int, t: float) -> bool:
        """Whether ``node`` is outside every down window at time ``t``."""
        return all(not (s <= t < e) for s, e in self._down[node])

    def next_up_time(self, node: int, t: float) -> float:
        """Earliest time >= t the node is up (inf if it crashed)."""
        for s, e in self._down[node]:
            if s <= t < e:
                return e
        return t

    def down_windows(self, node: int) -> List[Tuple[float, float]]:
        """``node``'s ``[start, end)`` outages."""
        return list(self._down[node])

    def ever_down(self) -> List[int]:
        """The nodes with at least one outage."""
        return [i for i in range(self.n) if self._down[i]]

    # -- round-quantized views (dense in-scan network model, DESIGN.md §9)

    def up_mask_at(self, t: float) -> np.ndarray:
        """``[n]`` bool: which nodes are up at virtual time ``t``."""
        return np.array([self.is_up(i, t) for i in range(self.n)])

    def round_up_masks(self, rounds: int, round_s: float) -> np.ndarray:
        """``[rounds, n]`` bool: liveness sampled at each round's start
        (``t = r * round_s``) — the churn timeline the dense network
        model consumes, materialized from the same seeded windows the
        event-driven transport checks continuously."""
        return np.stack([self.up_mask_at(r * round_s)
                         for r in range(rounds)])

    def round_step_masks(self, rounds: int, round_s: float,
                         up: Optional[np.ndarray] = None) -> np.ndarray:
        """``[rounds, n]`` bool: which nodes *complete a local step* in
        each round slot.  A straggler with compute multiplier ``c``
        finishes a local round every ``c`` slots (it steps in slot ``r``
        iff ``floor((r+1)/c) > floor(r/c)``), so over ``R`` slots it
        completes ``~R/c`` rounds — the same time-normalized progress the
        event-driven runtime realizes by letting it fall behind the
        virtual clock.  Down slots never step; pass a precomputed
        ``round_up_masks`` result as ``up`` to avoid re-deriving it."""
        r = np.arange(rounds, dtype=np.float64)[:, None]
        c = np.maximum(self._slowdown[None, :], 1.0)
        steps = np.floor((r + 1.0) / c) > np.floor(r / c)
        if up is None:
            up = self.round_up_masks(rounds, round_s)
        return steps & up
