"""Model similarity (paper Eq. 3 and Eq. 4) — the port of
``repro.core.similarity``.

The tensor functions run on any device and are the oracles for the Gram
kernel path (:func:`repro_torch.kernels.ops.model_pairwise_cosine`).
Every leaf of a parameter dict is one "layer"; leaves are averaged in dict
order, which :mod:`repro_torch.tree` keeps equal to the reference's leaf
order.  The host half (:class:`SimilarityHistory`, Eq. 4's bounded report
store, and Eq. 3 in f64 numpy) is a copy of the reference's and serves the
message-faithful protocol (:mod:`repro_torch.core.protocol`).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

_EPS = 1e-12


def layer_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between two same-shaped parameter tensors."""
    af = a.reshape(-1).float()
    bf = b.reshape(-1).float()
    return torch.dot(af, bf) / (af.norm() * bf.norm()).clamp_min(_EPS)


def model_similarity(params_a: Dict[str, torch.Tensor],
                     params_b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eq. 3 between two models: mean over leaves of the leaf cosine."""
    if len(params_a) != len(params_b):
        raise ValueError(
            f"parameter dicts disagree: {len(params_a)} vs {len(params_b)} "
            "leaves")
    sims = [layer_cosine(a, b)
            for a, b in zip(params_a.values(), params_b.values())]
    return torch.stack(sims).mean()


def pairwise_model_similarity(stacked: Dict[str, torch.Tensor]
                              ) -> torch.Tensor:
    """Eq. 3 for all node pairs of node-stacked parameters ``[n, ...]``
    -> ``[n, n]``."""
    leaves = list(stacked.values())
    if not leaves:
        raise ValueError("empty parameter dict")
    n = leaves[0].shape[0]
    acc = torch.zeros((n, n), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        flat = leaf.reshape(n, -1).float()
        norms = torch.sqrt((flat * flat).sum(dim=1)).clamp_min(_EPS)
        acc = acc + (flat @ flat.T) / (norms[:, None] * norms[None, :])
    return acc / len(leaves)


def dissimilarity(sim):
    """Dissimilarity score used for ranking: lower sim == more diverse."""
    return 1.0 - sim


# ---------------------------------------------------------------------------
# The host half: Eq. 4's report store and Eq. 3 in f64 numpy, a copy of
# ``repro.core.similarity`` for the message-faithful protocol.
# ---------------------------------------------------------------------------

# The paper keeps the 5 most recent similarity reports per target peer.
HISTORY_DEPTH = 5


@dataclass
class SimilarityReport:
    """One gossiped record: at time ``t``, reporter ``y`` claimed
    ``sim(y, z) = sigma_yz`` about target ``z``."""
    t: int
    reporter: int
    target: int
    sigma: float


@dataclass
class SimilarityHistory:
    """Host-side store of direct + gossiped similarity knowledge at a node.

    ``direct[j]`` is the latest directly measured ``sim(self, j)``;
    ``reports[z]`` is the paper's ``H_z`` — a deque of the
    :data:`HISTORY_DEPTH` most recent third-party reports about ``z``.
    """
    depth: int = HISTORY_DEPTH
    direct: Dict[int, float] = field(default_factory=dict)
    reports: Dict[int, Deque[SimilarityReport]] = field(
        default_factory=lambda: collections.defaultdict(
            lambda: collections.deque(maxlen=HISTORY_DEPTH)))

    def observe_direct(self, peer: int, sim: float) -> None:
        """Record a first-hand Eq.-3 measurement against ``peer``."""
        self.direct[peer] = float(sim)

    def observe_report(self, report: SimilarityReport) -> None:
        """Append a gossiped third-party report to H_z (bounded deque,
        newest ``depth`` kept)."""
        dq = self.reports[report.target]
        if dq.maxlen != self.depth:  # honour a non-default depth
            dq = collections.deque(dq, maxlen=self.depth)
            self.reports[report.target] = dq
        dq.append(report)

    def estimate(self, target: int) -> Optional[float]:
        """Eq. 4: sim^(w_i, w_z) = mean over H_z of sim(w_i, w_y) * sigma_yz.

        Only reports whose reporter ``y`` is known directly contribute.
        Returns ``None`` when nothing is known."""
        if target in self.direct:
            return self.direct[target]
        hz = [r for r in self.reports.get(target, ())
              if r.reporter in self.direct]
        if not hz:
            return None
        vals = [self.direct[r.reporter] * r.sigma for r in hz]
        return float(np.mean(vals))

    def known_peers(self) -> List[int]:
        """Every peer with a direct measurement or at least one report."""
        out = set(self.direct)
        out.update(self.reports)
        return sorted(out)

    def snapshot(self, peers: Iterable[int]) -> Dict[int, float]:
        """Best-effort similarity estimate for each peer in ``peers``."""
        out: Dict[int, float] = {}
        for p in peers:
            est = self.estimate(p)
            if est is not None:
                out[p] = est
        return out


def angular_bound(sim_ij: float, sim_jk: float) -> Tuple[float, float]:
    """Bounds on sim(i,k) implied by the angular triangle inequality:
    ``cos(a_ij + a_jk) <= sim(i,k) <= cos(|a_ij - a_jk|)``."""
    a = float(np.arccos(np.clip(sim_ij, -1.0, 1.0)))
    b = float(np.arccos(np.clip(sim_jk, -1.0, 1.0)))
    lo = float(np.cos(min(a + b, np.pi)))
    hi = float(np.cos(abs(a - b)))
    return lo, hi


def _leaves(stacked) -> list:
    """One array or tensor, or a mapping's values in its order (the port's
    leaf order)."""
    if isinstance(stacked, (np.ndarray, torch.Tensor)):
        return [stacked]
    return list(stacked.values())


def _host(x) -> np.ndarray:
    """A tensor copied off its device, or an array, as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def node_row(stacked, i: int) -> List[np.ndarray]:
    """Node ``i``'s parameters as a list of flat float64 leaf vectors, from
    a numpy array, a mapping of numpy arrays or a mapping of tensors.  For
    the same f32 values the f64 vectors, and so every Eq.-3 sum over them,
    are the reference's bits."""
    return [_host(leaf[i]).astype(np.float64).ravel()
            for leaf in _leaves(stacked)]


def pair_similarity_numpy(row_a: List[np.ndarray],
                          row_b: List[np.ndarray]) -> float:
    """Eq. 3 between two single-node rows from :func:`node_row`."""
    if len(row_a) != len(row_b):
        raise ValueError("rows disagree on leaf count")
    acc = 0.0
    for a, b in zip(row_a, row_b):
        na = max(float(np.linalg.norm(a)), _EPS)
        nb = max(float(np.linalg.norm(b)), _EPS)
        acc += float(a @ b) / (na * nb)
    return acc / len(row_a)


def similarity_matrix_numpy(stacked) -> np.ndarray:
    """Eq. 3 for all node pairs in f64 numpy (the host twin of
    :func:`pairwise_model_similarity`)."""
    leaves = [_host(leaf) for leaf in _leaves(stacked)]
    if not leaves:
        raise ValueError("empty pytree")
    n = leaves[0].shape[0]
    acc = np.zeros((n, n), np.float64)
    for leaf in leaves:
        flat = leaf.reshape(n, -1).astype(np.float64)
        dots = flat @ flat.T
        norms = np.maximum(np.linalg.norm(flat, axis=-1), _EPS)
        acc += dots / (norms[:, None] * norms[None, :])
    return acc / len(leaves)
