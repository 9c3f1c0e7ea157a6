"""Message-faithful Morph protocol simulator (paper Algorithms 2 & 3, §III)
— a copy of ``repro.core.protocol``: plain numpy on the host, so the same
numpy ``Generator`` and the same parameters give the reference's messages,
views, histories and tallies.

This is the *paper-faithful* control plane: every node keeps only its own
partial view of the network and negotiates connections through explicit
request/accept/reject messages.  No global knowledge is used anywhere in a
node's decision — direct Eq. 3 measurements are only made against model
copies a node actually received, exactly the measurements the real
protocol grants.

Every negotiation step is an explicit message object so the same protocol
state machine runs under two transports:

* the synchronous driver (:meth:`MorphProtocol.round_edges`) delivers
  every message instantly and in deterministic order — the paper's
  idealized lockstep network;
* the event-driven runner (:class:`repro_torch.netsim.AsyncRunner`)
  routes the *same* objects through a latency/bandwidth/fault-modelled
  transport, so requests can be dropped, accepts can arrive late and
  model transfers carry stale snapshots.

Per round (Alg. 2):
  1. every ``delta_r`` rounds each node recomputes its wanted senders
     (Alg. 3: softmax-without-replacement over dissimilarity + random
     injection) and emits one :class:`ConnectRequest` per wanted sender
     (:meth:`~MorphProtocol.begin_negotiation`); the college-admission
     negotiation resolves the surviving requests into
     :class:`ConnectAccept`/:class:`ConnectReject` messages
     (:meth:`~MorphProtocol.complete_negotiation`);
  2. models flow along the agreed edges; each transfer piggybacks the
     sender's :class:`GossipDigest` — its peer list (gossip discovery) and
     its direct similarity reports (Eq. 4 feed).  The digest is a
     *snapshot taken at send time*: receivers never reach into a peer's
     live state (:meth:`~MorphProtocol.make_digest` /
     :meth:`~MorphProtocol.receive_model`);
  3. every node averages its own + received models uniformly (the runtime
     applies the returned W).

The simulator also tallies protocol overhead so the communication-cost
metric covers negotiation, not just model transfers:
``control_messages`` counts connection requests (one per wanted sender)
plus accept messages (one per agreed edge); ``similarity_floats`` counts
every gossiped similarity report actually delivered to a receiver
(reports about the receiver itself are not sent).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import mixing, topology
from .matching import deferred_acceptance
from .selection import update_wanted_senders_host
from .similarity import (SimilarityHistory, SimilarityReport, node_row,
                         pair_similarity_numpy)


# ---------------------------------------------------------------------------
# Protocol messages.  These are the wire objects: the sync driver applies
# them immediately, an event-driven runner routes them through a transport.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConnectRequest:
    """Receiver asks ``sender`` to serve it, reporting the dissimilarity
    it estimated (Fig. 1: the sender ranks requesters by this value)."""
    rnd: int
    receiver: int
    sender: int
    dissim: float


@dataclass(frozen=True)
class ConnectAccept:
    """Sender agrees to serve ``receiver`` this negotiation round (it
    will transfer its model every round until the next refresh)."""
    rnd: int
    sender: int
    receiver: int


@dataclass(frozen=True)
class ConnectReject:
    """Sender declines (out-capacity full with more-dissimilar
    requesters); the receiver falls back down its preference list."""
    rnd: int
    sender: int
    receiver: int


@dataclass(frozen=True)
class GossipDigest:
    """Knowledge a sender piggybacks on a model transfer: its peer list
    and its direct similarity measurements ``(target, sigma)``.  Built by
    :meth:`MorphProtocol.make_digest` as a snapshot at send time."""
    origin: int
    peers: FrozenSet[int]
    reports: Tuple[Tuple[int, float], ...]


@dataclass
class NegotiationPlan:
    """Output of :meth:`MorphProtocol.begin_negotiation`: the requests in
    flight plus the preference state the matching needs once the network
    has (or has not) delivered them."""
    rnd: int
    requests: List[ConnectRequest]
    prefs: List[List[int]]
    sender_scores: np.ndarray


@dataclass
class MorphConfig:
    """Morph hyper-parameters (paper defaults in comments)."""
    n: int
    k: int                      # in-degree target
    view_size: Optional[int] = None   # s; defaults to k + 2 random edges
    beta: float = 500.0         # softmax sharpness (paper default)
    delta_r: int = 5            # topology refresh cadence (paper default)
    history_depth: int = 5      # |H_z|
    seed: int = 0
    # Out-degree cap.  The paper's tight market is k_out == k (total
    # supply == total demand); k + 1 grants one slot of capacity slack —
    # the alternative the fig67 replay measures (ROADMAP tight-market).
    k_out: Optional[int] = None

    def __post_init__(self):
        if self.view_size is None:
            # Fig. 2: d_r = 2 random edges suffice to stay connected.
            self.view_size = self.k + 2
        if self.k_out is None:
            self.k_out = self.k
        if not (0 < self.k < self.n):
            raise ValueError("need 0 < k < n")
        if self.view_size < self.k:
            raise ValueError("view_size must be >= k")
        if self.k_out < self.k:
            raise ValueError("k_out must be >= k (senders need at least "
                             "demand-matching capacity)")


@dataclass
class MorphNodeState:
    """Everything node i is allowed to know."""
    nid: int
    known_peers: Set[int] = field(default_factory=set)     # P_i
    history: SimilarityHistory = field(default_factory=SimilarityHistory)
    wanted: Set[int] = field(default_factory=set)          # current w_s


class MorphProtocol:
    """Drop-in :class:`~repro_torch.core.baselines.TopologyStrategy` that
    runs the full decentralized negotiation.  ``round_edges`` reads the
    node-stacked parameters as host numpy arrays (or CPU tensors) and
    measures Eq. 3 on them in f64."""

    name = "morph"
    uniform_mixing = True       # Alg. 2 l.12: uniform over self + received

    def __init__(self, cfg: MorphConfig,
                 initial_adj: Optional[np.ndarray] = None):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        n = cfg.n
        if initial_adj is None:
            deg = min(max(cfg.k, 2), n - 1)
            if (n * deg) % 2:
                deg += 1
            # The bootstrap overlay must be connected: partial views grow
            # only along messages, so a disconnected bootstrap splits the
            # population into absorbing components no protocol can merge.
            initial_adj = topology.random_regular_graph(
                n, deg, self._rng, connected=True)
        self.nodes: List[MorphNodeState] = []
        for i in range(n):
            st = MorphNodeState(nid=i)
            st.history = SimilarityHistory(depth=cfg.history_depth)
            st.known_peers = set(np.flatnonzero(initial_adj[i])) - {i}
            st.wanted = set(list(st.known_peers)[:cfg.k])
            self.nodes.append(st)
        self._edges: Optional[np.ndarray] = None
        self.control_messages = 0          # requests + accepts
        self.similarity_floats = 0         # gossiped similarity payload

    # -- helpers ----------------------------------------------------------

    def _estimates(self, st: MorphNodeState) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
        """(sim estimates, C_A mask, C mask) for one node."""
        n = self.cfg.n
        sims = np.zeros(n)
        ca = np.zeros(n, bool)
        c = np.zeros(n, bool)
        for p in st.known_peers:
            if p == st.nid:
                continue
            c[p] = True
            est = st.history.estimate(p)
            if est is not None:
                sims[p] = est
                ca[p] = True
        return sims, ca, c

    # -- negotiation (Alg. 3 + college admission), message-phased ----------

    def negotiation_due(self, rnd: int) -> bool:
        """True on the Δ_r refresh cadence (and before the first one)."""
        return self._edges is None or rnd % self.cfg.delta_r == 0

    @property
    def current_edges(self) -> Optional[np.ndarray]:
        """The held [n, n] in-edge matrix (None before round 0)."""
        return self._edges

    def begin_negotiation(self, rnd: int,
                          alive: Optional[Sequence[int]] = None
                          ) -> NegotiationPlan:
        """Alg. 3 per node: each node recomputes its wanted senders and
        emits one :class:`ConnectRequest` per wanted sender.

        ``alive`` restricts participation (netsim churn): dead nodes
        issue no requests and are dropped from everyone's preference
        lists.  Counts each request into ``control_messages``.
        """
        cfg = self.cfg
        n = cfg.n
        up = np.ones(n, bool) if alive is None else np.zeros(n, bool)
        if alive is not None:
            up[list(alive)] = True
        prefs: List[List[int]] = []
        requests: List[ConnectRequest] = []
        est_dissim = np.zeros((n, n))
        for st in self.nodes:
            if not up[st.nid]:
                prefs.append([])
                continue
            sims, ca, c = self._estimates(st)
            c &= up
            ca &= up
            view = update_wanted_senders_host(
                self._rng, sims, ca, c, cfg.k, cfg.view_size, cfg.beta)
            st.wanted = set(np.flatnonzero(view))
            # Preference order: estimated dissimilarity, random tiebreak.
            wanted = list(st.wanted)
            keys = [(1.0 - sims[j]) if ca[j] else self._rng.uniform(0.5, 1.5)
                    for j in wanted]
            order = sorted(range(len(wanted)), key=lambda t: -keys[t])
            pref = [wanted[t] for t in order]
            # Rejected receivers "look for another connection to maintain
            # k" (§III-B): fall back to remaining known peers, shuffled,
            # behind the diversity-ranked view.
            rest = [j for j in np.flatnonzero(c) if j not in st.wanted]
            self._rng.shuffle(rest)
            pref.extend(rest)
            prefs.append(pref)
            for j, kj in zip(wanted, keys):
                est_dissim[st.nid, j] = kj
                requests.append(ConnectRequest(rnd=rnd, receiver=st.nid,
                                               sender=j, dissim=kj))
            for j in rest:
                est_dissim[st.nid, j] = self._rng.uniform(0.0, 0.3)
            self.control_messages += len(wanted)       # connection requests
        # Fig. 1: a requester shares its dissimilarity value with the
        # sender, so the sender ranks requesters by the *reported* value.
        sender_scores = est_dissim.T.copy()
        return NegotiationPlan(rnd=rnd, requests=requests, prefs=prefs,
                               sender_scores=sender_scores)

    def complete_negotiation(
            self, plan: NegotiationPlan,
            delivered: Optional[Set[Tuple[int, int]]] = None,
    ) -> Tuple[np.ndarray, List[ConnectAccept], List[ConnectReject]]:
        """College-admission matching over the requests that survived the
        network, emitting accept/reject messages.

        ``delivered`` is the set of ``(receiver, sender)`` pairs whose
        :class:`ConnectRequest` actually arrived (``None`` = all — the
        idealized network).  A dropped request removes the sender from
        that receiver's wanted tier; the fallback tier is kept (modelled
        as the follow-up requests a rejected receiver retries).  Counts
        each accept into ``control_messages`` and installs the edges.
        """
        cfg = self.cfg
        prefs = plan.prefs
        if delivered is not None:
            prefs = [[j for j in pref
                      if (i, j) in delivered or j not in self.nodes[i].wanted]
                     for i, pref in enumerate(prefs)]
        edges = deferred_acceptance(prefs, plan.sender_scores, cfg.k,
                                    cfg.k_out)
        self.control_messages += int(edges.sum())       # accept messages
        # One accept per matched edge — including fallback-tier matches
        # (the sender must inform a receiver it is serving it), so the
        # tally above equals the accept packets a transport carries.
        accepts = [ConnectAccept(rnd=plan.rnd, sender=int(j), receiver=int(i))
                   for i, j in zip(*np.nonzero(edges))]
        rejects: List[ConnectReject] = []
        for req in plan.requests:
            if delivered is not None and (req.receiver, req.sender) \
                    not in delivered:
                continue
            if not edges[req.receiver, req.sender]:
                rejects.append(ConnectReject(rnd=plan.rnd, sender=req.sender,
                                             receiver=req.receiver))
        self._edges = edges
        return edges, accepts, rejects

    # -- model exchange side effects, message-phased -----------------------

    def make_digest(self, sender: int) -> GossipDigest:
        """Snapshot of what ``sender`` piggybacks on a model transfer."""
        st = self.nodes[sender]
        return GossipDigest(
            origin=sender,
            peers=frozenset(st.known_peers | {sender}),
            reports=tuple(sorted(st.history.direct.items())))

    def receive_model(self, receiver: int, sender: int,
                      sim: Optional[float], digest: GossipDigest,
                      rnd: int) -> None:
        """Receiver-side effects of one model transfer: the direct Eq. 3
        measurement, gossip peer discovery and Eq. 4 report ingestion."""
        st = self.nodes[receiver]
        if sim is not None:
            st.history.observe_direct(sender, float(sim))
        st.known_peers |= digest.peers
        st.known_peers.discard(receiver)
        for target, sigma in digest.reports:
            if target != receiver:
                st.history.observe_report(
                    SimilarityReport(t=rnd, reporter=sender, target=target,
                                     sigma=sigma))
                self.similarity_floats += 1

    # -- strategy API ------------------------------------------------------

    def round_edges(self, rnd: int, stacked_params=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous driver: every message is delivered instantly —
        negotiate on the Δ_r cadence, then :meth:`deliver` the round's
        models; returns the edges and their uniform W."""
        if self.negotiation_due(rnd):
            plan = self.begin_negotiation(rnd)
            self.complete_negotiation(plan)
        self.deliver(rnd, stacked_params)
        return self._edges, mixing.uniform_weights(self._edges)

    def deliver(self, rnd: int, stacked_params=None) -> None:
        """The receiver side of every transfer along the held edges: direct
        Eq.-3 measurements on ``stacked_params`` (when given), gossip
        discovery and report ingestion.

        Digests are snapshotted for all senders *before* any receiver
        applies them — the same barrier semantics a zero-latency netsim
        round produces, so the two runtimes agree bit-for-bit."""
        edges = self._edges
        senders = sorted({int(j) for j in np.flatnonzero(edges.any(axis=0))})
        digests = {j: self.make_digest(j) for j in senders}
        rows = {}
        if stacked_params is not None:
            for j in set(senders) | {int(i) for i in
                                     np.flatnonzero(edges.any(axis=1))}:
                rows[j] = node_row(stacked_params, j)
        for st in self.nodes:
            i = st.nid
            for j in np.flatnonzero(edges[i]):
                j = int(j)
                sim = (pair_similarity_numpy(rows[i], rows[j])
                       if rows else None)
                self.receive_model(i, j, sim, digests[j], rnd)

    # -- introspection ------------------------------------------------------

    def view_sizes(self) -> np.ndarray:
        """Per-node partial-view size |P_i| (gossip discovery growth)."""
        return np.array([len(st.known_peers) for st in self.nodes])
