"""Communication-graph generators, metrics and the runtime's topology
book-keeping — host-side numpy, a bit-for-bit copy of
``repro.core.topology``.

Edge convention: ``edges[i, j] = True`` means node ``j`` sends its model to
node ``i`` (row ``i`` lists node i's in-edges).
"""
from __future__ import annotations

import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _pairing_with_repair(d: int, n: int, seed: int) -> set:
    """Steger–Wormald pairing with repair: the edge set of a random
    ``d``-regular graph on ``n`` nodes.  The same algorithm and the same
    ``random.Random(seed)`` draws as ``networkx.random_regular_graph``
    (networkx 3.x), so a given seed yields the reference's graph without
    the port depending on networkx."""
    rs = random.Random(seed)

    def suitable(edges, potential_edges):
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    def try_creation():
        edges = set()
        stubs = list(range(n)) * d
        while stubs:
            potential_edges = defaultdict(lambda: 0)
            rs.shuffle(stubs)
            stubiter = iter(stubs)
            for s1, s2 in zip(stubiter, stubiter):
                if s1 > s2:
                    s1, s2 = s2, s1
                if s1 != s2 and ((s1, s2) not in edges):
                    edges.add((s1, s2))
                else:
                    potential_edges[s1] += 1
                    potential_edges[s2] += 1
            if not suitable(edges, potential_edges):
                return None
            stubs = [node for node, potential in potential_edges.items()
                     for _ in range(potential)]
        return edges

    if d == 0:
        return set()
    edges = try_creation()
    while edges is None:
        edges = try_creation()
    return edges


def random_regular_graph(n: int, degree: int,
                         rng: np.random.Generator,
                         max_tries: int = 200,
                         connected: bool = False) -> np.ndarray:
    """Undirected ``degree``-regular random graph as a symmetric boolean
    adjacency without self-loops; ``connected=True`` resamples until the
    graph is connected."""
    if n * degree % 2 != 0:
        raise ValueError("n * degree must be even for a regular graph")
    if degree >= n:
        raise ValueError("degree must be < n")
    for _ in range(max_tries):
        edges = _pairing_with_repair(degree, n,
                                     int(rng.integers(2**31 - 1)))
        adj = np.zeros((n, n), bool)
        for a, b in edges:
            adj[a, b] = adj[b, a] = True
        if not connected or is_connected(adj):
            return adj
    raise RuntimeError(f"no connected {degree}-regular graph on {n} nodes "
                       f"after {max_tries} tries")


def random_out_regular(n: int, k: int, rng: np.random.Generator,
                       view: Optional[np.ndarray] = None) -> np.ndarray:
    """Each node picks ``k`` distinct recipients uniformly (Epidemic
    Learning's per-round topology); ``view[j]`` optionally restricts node
    j's choices to its known peers (EL-Local).  Returns the in-edge
    matrix."""
    edges = np.zeros((n, n), bool)
    for j in range(n):
        if view is not None:
            pool = np.flatnonzero(view[j])
            pool = pool[pool != j]
        else:
            pool = np.delete(np.arange(n), j)
        kk = min(k, len(pool))
        if kk > 0:
            rcvrs = rng.choice(pool, size=kk, replace=False)
            edges[rcvrs, j] = True
    return edges


def fully_connected(n: int) -> np.ndarray:
    """Complete in-edge matrix (everyone sends to everyone else)."""
    return ~np.eye(n, dtype=bool)


def is_connected(edges: np.ndarray) -> bool:
    """Connectivity in the undirected sense (paper §II-A)."""
    n = edges.shape[0]
    und = edges | edges.T
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.flatnonzero(und[u]):
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def isolated_nodes(edges: np.ndarray) -> np.ndarray:
    """Nodes with no incoming connection this round (paper Figs. 6/7)."""
    return np.flatnonzero(edges.sum(axis=1) == 0)


def in_degrees(edges: np.ndarray) -> np.ndarray:
    """Per-node count of models received this round (row sums)."""
    return edges.sum(axis=1)


def out_degrees(edges: np.ndarray) -> np.ndarray:
    """Per-node count of models sent this round (column sums)."""
    return edges.sum(axis=0)


def comm_cost(edges: np.ndarray, model_bytes: int) -> int:
    """Total bytes moved this round = (#directed model transfers) * size."""
    return int(edges.sum()) * model_bytes


def connectivity_probability(n: int, d_s: int, d_r: int,
                             trials: int, seed: int = 0) -> float:
    """Paper Fig. 2: probability that a graph whose nodes each pick ``d_s``
    similarity-driven in-edges (worst case: disjoint cliques of ``d_s +
    1``) plus ``d_r`` uniformly random in-edges stays connected."""
    rng = np.random.default_rng(seed)
    ok = 0
    for _ in range(trials):
        edges = np.zeros((n, n), bool)
        if d_s > 0:
            perm = rng.permutation(n)
            size = d_s + 1
            for start in range(0, n, size):
                blk = perm[start:start + size]
                for a in blk:
                    for b in blk:
                        if a != b:
                            edges[a, b] = True
        if d_r > 0:
            edges |= random_out_regular(n, d_r, rng)
        ok += is_connected(edges)
    return ok / trials


@dataclass
class TopologyState:
    """Book-keeping shared by strategies and the metrics logger."""
    n: int
    edges: np.ndarray                 # current in-edge matrix
    round: int = 0
    total_transfers: int = 0          # cumulative directed model sends
    isolation_history: List[int] = field(default_factory=list)

    @classmethod
    def empty(cls, n: int) -> "TopologyState":
        """Round-zero state: no edges yet."""
        return cls(n=n, edges=np.zeros((n, n), bool))

    def advance(self, edges: np.ndarray) -> None:
        """Record one round: adopt ``edges``, bump counters, append the
        isolation count."""
        self.edges = edges
        self.round += 1
        self.total_transfers += int(edges.sum())
        self.isolation_history.append(len(isolated_nodes(edges)))
