"""Event-driven decentralized runtime (DESIGN.md §5) — the port of
``repro.netsim.async_runner``.

:class:`AsyncRunner` executes the same Alg. 1/2 semantics as
:class:`repro_torch.dlrt.DecentralizedRunner`, but as per-node
event-driven agents on a virtual clock instead of a global lockstep loop:

  compute_done(i, r) ──► edges for round r ──► model pulls via transport
        ▲                                            │
        └──────────── mix(i, r) ◄── model deliveries ┘

* Each node runs its *own* round counter; stragglers and churned nodes
  fall behind while the rest of the population keeps moving.
* Model transfers are real messages: sized from actual parameter bytes,
  delayed by per-link latency + bandwidth, dropped by loss/partitions,
  and carrying the sender's parameter *snapshot* (staleness is measured
  and histogrammed, not assumed away).
* Morph's negotiation runs through the same transport:
  :class:`~repro_torch.core.protocol.ConnectRequest` /
  :class:`~repro_torch.core.protocol.ConnectAccept` objects travel as
  control packets, so a dropped request really does cost an edge.  The
  college-admission resolution itself executes as one epoch event (the
  paper's bounded deferred-acceptance exchange, collapsed to its
  fixpoint — see DESIGN.md §5 for the fidelity contract).
* Any other topology strategy is driven generically: its ``round_edges``
  is called lazily, exactly once per round, in round order — the same
  call sequence the synchronous runner makes.  An in-graph strategy gets
  the live device tensors (in-graph Morph's Gram runs on the card), any
  other that reads the models a host numpy copy.

**Lockstep equivalence.**  Events sharing a virtual instant are phase
ordered (compute → negotiate → deliver ctrl → match → send → deliver
models → mix) and coalesced into batches.  Under a zero-latency,
zero-loss profile with no churn and homogeneous compute times, every
batch covers the whole population, the runner takes the stacked fast
paths (the *same* local step and the same grouped mix kernels the host
loop uses), and the execution is bit-identical to
:class:`~repro_torch.dlrt.DecentralizedRunner`'s host loop — edge
sequence and parameters.  ``tests/test_torch_async.py`` enforces this.

Everything else runs on the host as in the reference: a node's snapshot
is a numpy copy of its row, and a mix of what arrived is an f32 numpy
sum in arrival order, written back into the node's row on the device.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.mixing import uniform_weights
from ..core.similarity import node_row, pair_similarity_numpy
from ..dlrt.metrics import NetMetricsLog, NetRecord
from ..dlrt.runtime import (DecentralizedRunner, RunnerConfig,
                            make_round_record, host_params, to_device)
from . import profiles
from .events import EventLoop
from .faults import FaultModel
from .messages import CTRL_BYTES, ModelTransfer, Packet
from .transport import NetworkProfile, Transport

# Phase order within one virtual instant (see module docstring).
P_COMPUTE = 0
P_NEG = 1
P_CTRL_DELIVER = 2
P_MATCH = 3
P_PULL = 4
P_MODEL_DELIVER = 5
P_MIX = 6


@dataclass
class AsyncConfig:
    """Event-driven runtime knobs (durations in virtual seconds)."""
    n_nodes: int
    rounds: int                       # local rounds per node
    eval_every: int = 20              # in (min-completed) rounds
    compute_time_s: float = 1.0       # base local-step duration
    compute_jitter_s: float = 0.0     # uniform extra per step
    mix_timeout_s: Optional[float] = None   # max wait for in-flight models
    model_bytes: Optional[int] = None
    seed: int = 0
    max_events: Optional[int] = None  # runaway guard (default: generous)


@dataclass
class _Arrival:
    sender: int
    snapshot: object
    sender_round: int
    version: int


def _select_rows(mask: torch.Tensor, new, old):
    """``new`` in the rows ``mask`` marks and ``old`` elsewhere, for every
    tensor of a (possibly nested, possibly empty) dict.  A tensor without
    the node axis (the port's ``sgd`` keeps one step count for the whole
    stack) takes ``new``."""
    if isinstance(new, dict):
        return type(new)((k, _select_rows(mask, new[k], old[k]))
                         for k in new)
    if new.ndim == 0 or new.shape[0] != mask.shape[0]:
        return new
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                       old)


class AsyncRunner(DecentralizedRunner):
    """Strategy-agnostic event-driven D-PSGD runner over a simulated
    network.  Shares parameters, the local step, the mix and the
    round-domain metrics log with the synchronous runner; adds ``netlog``
    (wall-clock domain) and per-round realized in-degrees.

    ``params`` and ``device`` are :class:`DecentralizedRunner`'s (the card
    unless the caller passes ``"cpu"``); ``draws(rnd, stream)`` hands the
    transport its keyed uniforms (:class:`~repro_torch.netsim.Transport`).
    """

    def __init__(self, *, init_fn, loss_fn, eval_fn, optimizer, batcher,
                 test_batch, strategy, cfg: AsyncConfig,
                 profile: Optional[NetworkProfile] = None,
                 faults: Optional[FaultModel] = None, params=None,
                 device="cuda",
                 draws: Optional[Callable[[int, int],
                                          torch.Tensor]] = None):
        super().__init__(
            init_fn=init_fn, loss_fn=loss_fn, eval_fn=eval_fn,
            optimizer=optimizer, batcher=batcher, test_batch=test_batch,
            strategy=strategy,
            cfg=RunnerConfig(n_nodes=cfg.n_nodes, rounds=cfg.rounds,
                             eval_every=cfg.eval_every,
                             model_bytes=cfg.model_bytes, seed=cfg.seed),
            params=params, device=device)
        self.acfg = cfg
        n = cfg.n_nodes
        self.loop = EventLoop()
        self.faults = faults if faults is not None else FaultModel.none(n)
        self.profile = profile if profile is not None else profiles.ideal()
        self.transport = Transport(self.profile, self.loop,
                                   faults=self.faults, n_nodes=n,
                                   draws=draws)
        self.netlog = NetMetricsLog()
        self._jrng = np.random.default_rng(cfg.seed + 0x5EED)

        self._is_morph = hasattr(strategy, "begin_negotiation")
        self._uniform_mix = bool(getattr(strategy, "uniform_mixing", False))

        # per-round shared state
        self._edges_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._clean: Dict[int, bool] = {}      # no drop/churn/staleness?
        self._neg_started: Set[int] = set()
        self._neg_plan = None
        self._neg_pending = 0
        self._neg_delivered: Set[Tuple[int, int]] = set()
        self._waiters: Dict[int, List[int]] = {}
        self.edge_history: List[np.ndarray] = []

        # per-node state
        self._stepped = np.full(n, -1)         # last round with compute done
        self._completed = np.full(n, -1)       # last round fully mixed
        self._version = np.zeros(n, np.int64)  # param-row mutation counter
        self._pending: Dict[int, int] = {}     # receiver -> models awaited
        self._arrived: Dict[int, List[_Arrival]] = {}
        self._snap_cache: Dict[int, Tuple[int, object]] = {}
        self._mixed_round = np.full(n, -1)     # guard vs deadline double-mix
        self.dead: Set[int] = set()            # permanently crashed

        # extra counters
        self.realized_indegrees: List[int] = []
        self.late_discards = 0
        self.unavailable_sends = 0
        self.truncated = False
        self._next_eval_idx = 0
        self._eval_rounds = sorted({r for r in range(cfg.rounds)
                                    if r % cfg.eval_every == 0}
                                   | {cfg.rounds - 1})

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _duration(self, node: int) -> float:
        d = self.acfg.compute_time_s * self.faults.compute_multiplier(node)
        if self.acfg.compute_jitter_s > 0.0:
            d += float(self._jrng.uniform(0.0, self.acfg.compute_jitter_s))
        return d

    def _active(self) -> List[int]:
        """Nodes still running (not finished, not permanently dead)."""
        return [i for i in range(self.cfg.n_nodes)
                if i not in self.dead
                and self._completed[i] < self.cfg.rounds - 1]

    def _alive_now(self) -> List[int]:
        return [i for i in range(self.cfg.n_nodes)
                if i not in self.dead and self.faults.is_up(i, self.loop.now)]

    def _mark_unclean(self, rnd: int) -> None:
        self._clean[rnd] = False

    def _snapshot_row(self, j: int) -> "OrderedDict[str, np.ndarray]":
        """Host numpy copy of node j's parameter row, cached per version
        so a sender serving several receivers pays one device transfer.
        Never a view of the device tensors: :meth:`_mix_one` writes rows
        in place, which would change a snapshot already in flight."""
        ver = int(self._version[j])
        cached = self._snap_cache.get(j)
        if cached is not None and cached[0] == ver:
            return cached[1]
        row = OrderedDict((k, v[j].detach().cpu().numpy().copy())
                          for k, v in self.params.items())
        self._snap_cache[j] = (ver, row)
        return row

    def _defer_if_down(self, node: int, kind: str, payload,
                       phase: int) -> bool:
        """Reschedule an event of a down node to its recovery time (or
        drop the node if it crashed for good).  Returns True when the
        event was deferred/cancelled."""
        t = self.loop.now
        if self.faults.is_up(node, t):
            return False
        up_at = self.faults.next_up_time(node, t)
        if np.isinf(up_at):
            self.dead.add(node)
            return True
        self.loop.schedule_at(up_at, kind, payload, phase=phase)
        return True

    # ------------------------------------------------------------------
    # edges for a round (lazy, once, in round order)
    # ------------------------------------------------------------------

    def _request_edges(self, node: int, rnd: int) -> None:
        """Node ``node`` needs round ``rnd``'s edges; schedule its pull
        now if they are known, otherwise enlist it in the negotiation."""
        if rnd in self._edges_cache:
            self.loop.schedule(0.0, "pull", (node, rnd), phase=P_PULL)
            return
        self._waiters.setdefault(rnd, []).append(node)
        if self._is_morph and self.strategy.negotiation_due(rnd):
            if rnd not in self._neg_started:
                self._neg_started.add(rnd)
                self.loop.schedule(0.0, "neg.start", rnd, phase=P_NEG)
            return
        # Known edges without a message wave: previous Morph epoch, or a
        # generic strategy's round_edges (called once, in round order —
        # the synchronous call sequence).
        if self._is_morph:
            # Reuse the edges the previous round used (Alg. 2 keeps the
            # neighbor set for Δ_r rounds).  A later refresh may already
            # have overwritten strategy.current_edges, so read the
            # per-round cache — round rnd-1 is guaranteed present since
            # some node completed it.
            edges = self._edges_cache[rnd - 1][0].copy()
            w = uniform_weights(edges)
        else:
            stacked = None
            if getattr(self.strategy, "needs_params", True):
                stacked = self.params \
                    if getattr(self.strategy, "in_graph", False) \
                    else host_params(self.params)
            edges, w = self.strategy.round_edges(rnd, stacked)
            edges = np.array(edges, dtype=bool)
            w = np.array(w, dtype=np.float64)
        self._install_edges(rnd, edges, w)

    def _install_edges(self, rnd: int, edges: np.ndarray,
                       w: np.ndarray) -> None:
        self._edges_cache[rnd] = (edges, w)
        self._clean.setdefault(rnd, True)
        self.edge_history.append(edges.copy())
        for node in sorted(self._waiters.pop(rnd, [])):
            self.loop.schedule(0.0, "pull", (node, rnd), phase=P_PULL)

    # ------------------------------------------------------------------
    # event handlers
    # ------------------------------------------------------------------

    def _on_compute(self, batch: List) -> None:
        nodes = [ev.payload[0] for ev in batch]
        rounds = [ev.payload[1] for ev in batch]
        live: List[Tuple[int, int]] = []
        for i, r in zip(nodes, rounds):
            if i in self.dead:
                continue
            if self._defer_if_down(i, "compute", (i, r), P_COMPUTE):
                self._mark_unclean(r)
                continue
            live.append((i, r))
        if not live:
            return
        ids = [i for i, _ in live]
        same_round = len({r for _, r in live}) == 1
        full = same_round and len(ids) == self.cfg.n_nodes
        if full:
            # Lockstep fast path: the exact synchronous step — one
            # stacked draw, one node-stacked local step.
            b = to_device(self.batcher.next(), self.device)
            self.params, self.opt_state = self._local_step(
                self.params, self.opt_state, b)
        else:
            # The whole stack steps (the rows of nodes that do not compute
            # on the first live node's batch); only the live rows keep
            # the result.
            draws = {i: self.batcher.nodes[i].next() for i in ids}
            filler = draws[ids[0]]
            stacked = {k: np.stack([draws[i][k] if i in draws else filler[k]
                                    for i in range(self.cfg.n_nodes)])
                       for k in filler}
            b = to_device(stacked, self.device)
            new_p, new_o = self._local_step(self.params, self.opt_state, b)
            mask = np.zeros(self.cfg.n_nodes, bool)
            mask[ids] = True
            tm = torch.as_tensor(mask, device=self.device)
            self.params = _select_rows(tm, new_p, self.params)
            self.opt_state = _select_rows(tm, new_o, self.opt_state)
        for i, r in live:
            self._stepped[i] = r
            self._version[i] += 1
            if not full:
                self._mark_unclean(r)
        for i, r in live:
            self._request_edges(i, r)

    def _on_neg_start(self, rnd: int) -> None:
        """Morph: Alg. 3 runs per node; the connection requests travel
        as control packets through the transport."""
        alive = self._alive_now()
        plan = self.strategy.begin_negotiation(
            rnd, alive=None if len(alive) == self.cfg.n_nodes else alive)
        self._neg_plan = plan
        self._neg_delivered = set()
        self._neg_pending = 0
        for req in plan.requests:
            pkt = self.transport.send(req.receiver, req.sender, "request",
                                      req, CTRL_BYTES,
                                      phase=P_CTRL_DELIVER, rnd=rnd)
            if pkt is None:
                self._mark_unclean(rnd)
            else:
                self._neg_pending += 1
        if self._neg_pending == 0:
            self.loop.schedule(0.0, "neg.match", rnd, phase=P_MATCH)

    def _on_neg_match(self, rnd: int) -> None:
        plan = self._neg_plan
        edges, accepts, rejects = self.strategy.complete_negotiation(
            plan, delivered=self._neg_delivered)
        for msg in accepts:
            self.transport.send(msg.sender, msg.receiver, "accept", msg,
                                CTRL_BYTES, phase=P_CTRL_DELIVER, rnd=rnd)
        for msg in rejects:
            self.transport.send(msg.sender, msg.receiver, "reject", msg,
                                CTRL_BYTES, phase=P_CTRL_DELIVER, rnd=rnd)
        self._neg_plan = None
        self._install_edges(rnd, np.array(edges, dtype=bool),
                            uniform_weights(edges))

    def _on_pull(self, node: int, rnd: int) -> None:
        """Receiver ``node`` pulls its round-``rnd`` senders' models.
        Each sender snapshots its parameters + gossip digest at send
        time."""
        edges, _ = self._edges_cache[rnd]
        senders = [int(j) for j in np.flatnonzero(edges[node])]
        self._pending[node] = 0
        self._arrived[node] = []
        for j in senders:
            if not self.faults.is_up(j, self.loop.now):
                self.unavailable_sends += 1
                self._mark_unclean(rnd)
                continue
            transfer = ModelTransfer(
                sender=j, receiver=node, receiver_round=rnd,
                sender_round=int(self._stepped[j]),
                snapshot=(self._snapshot_row(j), int(self._version[j])),
                digest=(self.strategy.make_digest(j)
                        if self._is_morph else None))
            pkt = self.transport.send(j, node, "model", transfer,
                                      self._model_bytes,
                                      phase=P_MODEL_DELIVER, rnd=rnd)
            if pkt is None:
                self._mark_unclean(rnd)
            else:
                self._pending[node] += 1
        if self._pending[node] == 0:
            self.loop.schedule(0.0, "mix", (node, rnd), phase=P_MIX)
        elif self.acfg.mix_timeout_s is not None:
            self.loop.schedule(self.acfg.mix_timeout_s, "mix.deadline",
                               (node, rnd), phase=P_MIX)

    def _on_ctrl_deliver(self, pkt: Packet) -> None:
        self.transport.delivered(pkt)
        if pkt.kind == "request":
            req = pkt.payload
            self._neg_delivered.add((req.receiver, req.sender))
            self._neg_pending -= 1
            if self._neg_pending == 0:
                self.loop.schedule(0.0, "neg.match", req.rnd, phase=P_MATCH)
        # accepts/rejects inform endpoints the matching already encodes;
        # they only cost bytes here.

    def _on_model_deliver(self, pkt: Packet) -> None:
        self.transport.delivered(pkt)
        tr: ModelTransfer = pkt.payload
        i, r = tr.receiver, tr.receiver_round
        if self._mixed_round[i] >= r:
            self.late_discards += 1          # deadline fired already
            self._mark_unclean(r)
            return
        snapshot, version = tr.snapshot
        self._arrived[i].append(_Arrival(sender=tr.sender, snapshot=snapshot,
                                         sender_round=tr.sender_round,
                                         version=version))
        self.netlog.observe_staleness(r - tr.sender_round)
        if self._is_morph:
            sim = pair_similarity_numpy(
                node_row(self.params, i),
                [leaf.astype(np.float64).ravel()
                 for leaf in snapshot.values()])
            self.strategy.receive_model(i, tr.sender, sim, tr.digest, r)
        self._pending[i] -= 1
        if self._pending[i] == 0:
            self.loop.schedule(0.0, "mix", (i, r), phase=P_MIX)

    def _on_mix(self, batch: List) -> None:
        todo: List[Tuple[int, int]] = []
        for ev in batch:
            i, r = ev.payload
            if self._mixed_round[i] >= r:
                continue                     # mix + deadline double-fire
            if ev.kind == "mix.deadline":
                self._mark_unclean(r)
            if self._defer_if_down(i, ev.kind, (i, r), P_MIX):
                self._mark_unclean(r)
                continue
            todo.append((i, r))
        if not todo:
            return
        rounds = {r for _, r in todo}
        r0 = next(iter(rounds))
        fresh = all(a.version == self._version[a.sender]
                    for i, _ in todo for a in self._arrived[i])
        full = (len(rounds) == 1 and len(todo) == self.cfg.n_nodes
                and self._clean.get(r0, False) and fresh
                and all(self._pending[i] == 0 for i, _ in todo))
        if full:
            # Lockstep fast path: the host loop's grouped mix of the
            # round's edges (one launch over every leaf).
            edges, w = self._edges_cache[r0]
            self.params = self._mix(edges, w)
            for i, _ in todo:
                self._version[i] += 1
        else:
            for i, r in todo:
                self._mix_one(i, r)
        for i, r in todo:
            self._finish_round(i, r)
        self._maybe_eval()

    def _mix_one(self, i: int, r: int) -> None:
        """General path: weighted average of the receiver's current row
        and the *snapshots* that actually arrived, in host numpy f32 in
        the reference's order (own row first, then each arrival in
        arrival order, Python-float weights), written back into row ``i``
        of the device tensors in place."""
        arrivals = self._arrived[i]
        _, w = self._edges_cache[r]
        if self._uniform_mix:
            share = 1.0 / (len(arrivals) + 1)
            weights = [share] * len(arrivals)
            self_w = share
        else:
            weights = [float(w[i, a.sender]) for a in arrivals]
            self_w = float(w[i, i]) + float(
                w[i].sum() - w[i, i] - sum(weights))
        own = [v[i].detach().cpu().numpy() for v in self.params.values()]
        acc = [self_w * leaf.astype(np.float32) for leaf in own]
        for wt, a in zip(weights, arrivals):
            for idx, leaf in enumerate(a.snapshot.values()):
                acc[idx] = acc[idx] + wt * np.asarray(leaf, np.float32)
        with torch.no_grad():
            for v, a, o in zip(self.params.values(), acc, own):
                v[i].copy_(torch.from_numpy(a.astype(o.dtype)))
        self._version[i] += 1

    def _finish_round(self, i: int, r: int) -> None:
        arrivals = self._arrived.pop(i, [])
        self.realized_indegrees.append(len(arrivals))
        self._comm_bytes += len(arrivals) * self._model_bytes
        self._pending.pop(i, None)
        self._mixed_round[i] = r
        self._completed[i] = r
        if r + 1 < self.cfg.rounds:
            self.loop.schedule(self._duration(i), "compute", (i, r + 1),
                               phase=P_COMPUTE)

    # ------------------------------------------------------------------
    # evaluation (wall-clock domain)
    # ------------------------------------------------------------------

    def _maybe_eval(self) -> None:
        active = [i for i in range(self.cfg.n_nodes) if i not in self.dead]
        if not active:
            return
        frontier = int(self._completed[active].min())
        while (self._next_eval_idx < len(self._eval_rounds)
               and frontier >= self._eval_rounds[self._next_eval_idx]):
            self._eval_at(self._eval_rounds[self._next_eval_idx])
            self._next_eval_idx += 1

    @torch.no_grad()
    def _eval_at(self, rnd: int) -> None:
        losses, metrics = self._evaluate(self.params, self.test_batch)
        losses = losses.cpu().numpy()
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        # isolation is attributed to the eval's own round (fast nodes may
        # already have installed later epochs' edges)
        if rnd in self._edges_cache:
            edges = self._edges_cache[rnd][0]
        elif self.edge_history:
            edges = self.edge_history[-1]
        else:
            edges = np.zeros((self.cfg.n_nodes,) * 2, bool)
        rec = make_round_record(rnd, losses, metrics, self._comm_bytes,
                                edges)
        self.log.add(rec)
        stats = self.transport.stats
        down = [i for i in range(self.cfg.n_nodes)
                if i in self.dead
                or not self.faults.is_up(i, self.loop.now)]
        self.netlog.add(NetRecord(
            t=self.loop.now, rnd=rnd,
            mean_accuracy=rec.mean_accuracy, mean_loss=rec.mean_loss,
            internode_variance=rec.internode_variance,
            model_bytes=stats.bytes_by_kind.get("model", 0),
            control_bytes=sum(v for k, v in stats.bytes_by_kind.items()
                              if k != "model"),
            messages_in_flight=stats.in_flight,
            dropped=stats.dropped,
            dead=len(down),
            staleness_mean=self.netlog.staleness_mean()))

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def _dispatch(self, batch: List) -> None:
        kind = batch[0].kind
        if kind == "compute":
            self._on_compute(batch)
        elif kind == "neg.start":
            for ev in batch:
                self._on_neg_start(ev.payload)
        elif kind == "neg.match":
            for ev in batch:
                self._on_neg_match(ev.payload)
        elif kind == "pull":
            for ev in batch:
                self._on_pull(*ev.payload)
        elif kind == "net.deliver":
            for ev in batch:
                pkt: Packet = ev.payload
                if pkt.kind == "model":
                    self._on_model_deliver(pkt)
                else:
                    self._on_ctrl_deliver(pkt)
        elif kind in ("mix", "mix.deadline"):
            self._on_mix(batch)
        else:
            raise RuntimeError(f"unknown event kind {kind!r}")

    def run(self, progress=None) -> NetMetricsLog:
        """Drive the event loop until every live node completes
        ``cfg.rounds`` local rounds (or ``max_events`` trips the runaway
        guard).  Returns the wall-clock-domain log; the inherited
        round-domain ``self.log`` is filled at the same evaluation
        points.  ``progress`` receives each :class:`NetRecord`."""
        n = self.cfg.n_nodes
        for i in range(n):
            start = self.faults.next_up_time(i, 0.0)
            if np.isinf(start):
                self.dead.add(i)
                continue
            self.loop.schedule_at(start + self._duration(i), "compute",
                                  (i, 0), phase=P_COMPUTE)
        max_events = self.acfg.max_events or (
            self.cfg.rounds * n * 32 + 4096)
        last_seen = 0

        def handler(batch):
            nonlocal last_seen
            self._dispatch(batch)
            if progress is not None and len(self.netlog.records) > last_seen:
                last_seen = len(self.netlog.records)
                progress(self.netlog.records[-1])

        self.loop.run(handler, max_events=max_events)
        # The run can end before every scheduled eval fired — every node
        # crashed, or the runaway guard tripped.  Record a final snapshot
        # at the actual frontier and flag the truncation rather than
        # letting an early-round record pose as the final result.
        self.truncated = self._next_eval_idx < len(self._eval_rounds)
        if self.truncated:
            alive = [i for i in range(n) if i not in self.dead]
            frontier = int(self._completed[alive].min()) if alive \
                else int(self._completed.max())
            self._eval_at(max(frontier, 0))
        return self.netlog
