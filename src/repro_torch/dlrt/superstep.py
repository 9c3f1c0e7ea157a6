"""The single-device round engine — the port of
``repro.dlrt.compiled.CompiledSuperstep``'s ``round_body`` and
``round_body_sparse`` (no mesh, Pallas kernels on), with compressed
gossip and the dense in-scan network model.

The reference fuses each evaluation chunk into one ``lax.scan``; here the
rounds of a chunk run eagerly, one after another, with no host transfer
except the controller's matching checks, and each round's topology goes
into a device buffer that is copied to the host once at the chunk end.
The round index is a host ``int``, so the reference's ``lax.cond`` gates
(similarity refresh, negotiation cadence) are plain ``if``s.

Engines (``RunnerConfig.engine``):

* dense — the strategy returns ``[n, n]`` edges; the engine keeps the
  ``[n, n]`` Eq.-3 cache for strategies that read it and buffers ``[K, n,
  n]`` edges;
* sparse, sparse-native strategy — the strategy reads the parameters and
  returns a :class:`~repro_torch.sparse.SparseAdjacency`; no ``[n, n]``
  matrix is kept, the mix is O(n k D) and the chunk buffers ``[K, n, k]``
  indices and masks;
* sparse, dense strategy (compat mode) — ``sparse_mix="exact"`` is the
  dense engine exactly; ``"gather"`` converts each round's edges to CSR
  with ``n - 1`` slots (lossless) and mixes through the sparse kernel.

There is no kernel switch: on a CUDA device the similarity refresh and the
mixing run the hand-written kernels (the Gram kernel through
:func:`repro_torch.kernels.ops.model_pairwise_cosine`, the masked graph-mix
kernel for uniform strategies, the graph-mix kernel for the others, the
CSR kernel on the sparse paths); on the CPU the same wrappers run their
plain versions.

Compressed gossip (``RunnerConfig.compress``, DESIGN.md §13): every round
each node sends ``encode((params - hat) + resid)`` and every peer advances
the replica ``hat += decode(wire)``; the Eq.-3 refresh and the sparse
controller read the replicas when ``CompressConfig.sim``, the mix runs
over the replicas through the same kernels, and the consensus correction
``params + gamma (mixed - hat)`` moves the local models.  ``hat`` starts
as f32 copies of the parameters and ``resid`` as zeros in each engine,
and the runner builds one engine per ``run()``, as the reference does.

The network model (``RunnerConfig.net``, a
:class:`~repro_torch.netsim.DenseNetwork`, dense engine only, DESIGN.md
§9): every node takes its local step and only the nodes the fault
timeline lets step keep it (:func:`net_select`); the post-step models
(the replicas under a codec) are pushed onto a ring of the last ``S``
snapshots (:func:`net_push`); the round's keyed draws decide which
negotiated edges arrive and from how many rounds back
(:func:`net_effective`); and one grouped ``graph_mix`` launch contracts
the staleness-expanded ``[n, n S]`` weights with the ring, for every
strategy, uniform ones included.  Under a codec the ring holds the
replicas: slot 0 is the one the next delta is coded against, so no
separate ``hat`` is kept.  A ring of depth 1 under the ideal network is
bitwise the engine without one on the CPU (both plain mixes sum over the
nodes in node order from the same quotients).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..compress import (CompressConfig, encode_delta_payload,
                        wire_bytes_tree, zero_residual)
from ..core.mixing import apply_consensus_correction, uniform_weights_torch
from ..kernels import ops
from ..sparse.adjacency import dense_to_csr
from ..sparse.mix import sparse_mix_pytree
from .metrics import MetricsLog, RoundRecord, net_staleness_mean
from .runtime import (RunnerConfig, _unstaged, evaluate_record,
                      make_evaluator, make_local_step, resolve_engine,
                      stacked_model_bytes, to_device)

# Above this population the sparse engine keeps (idx, mask) pairs in
# edge_history instead of decoding dense [n, n] edge matrices.
SPARSE_EDGE_DECODE_MAX = 4096


def eval_boundaries(rounds: int, eval_every: int) -> List[Tuple[int, int]]:
    """Inclusive ``(start, end)`` chunks whose ends are the evaluation
    rounds: every ``eval_every``-th round and the last one."""
    ends = sorted({r for r in range(rounds) if r % eval_every == 0}
                  | {rounds - 1})
    chunks, start = [], 0
    for e in ends:
        chunks.append((start, e))
        start = e + 1
    return chunks


def net_select(mask: torch.Tensor, new, old):
    """Per-node ``where(mask, new, old)`` over a state tree (dicts, tuples,
    tensors); scalar leaves (shared optimizer counters) and leaves not on
    the node axis always take ``new``."""
    if isinstance(new, Mapping):
        return type(new)((k, net_select(mask, v, old[k]))
                         for k, v in new.items())
    if isinstance(new, (tuple, list)):
        return type(new)(net_select(mask, a, b) for a, b in zip(new, old))
    if new.dim() == 0 or new.shape[0] != mask.shape[0]:
        return new
    m = mask.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def net_effective(edges: torch.Tensor, w: Optional[torch.Tensor],
                  up: torch.Tensor, step: torch.Tensor, stal: torch.Tensor,
                  drop: torch.Tensor, S: int, *, uniform: bool):
    """The round's delivery and mixing plan: ``(delivered [n, n] bool,
    d_idx [n, n] staleness a delivery reads, w_stal [n, n, S] f32
    staleness-expanded weights, stale_counts [S] int32)``.  Receivers that
    are down or do not step keep their own model; uniform strategies
    average over what arrived, fixed-W ones fold the lost mass into
    self-weight.  A leading ``[E]`` axis on every input (a sweep's
    experiments) gives each experiment its own plan, bit for bit: the one
    sum of real numbers (the lost mass) runs per experiment."""
    n = edges.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=edges.device)
    active = up & step                   # receivers that mix
    delivered = edges & ~drop & up[..., None, :] & active[..., :, None]
    if uniform:
        w_eff = uniform_weights_torch(delivered)
    else:
        support = delivered | eye
        w32 = w.float()
        kept = w32 * support
        lost_terms = w32 * ~support
        lost = lost_terms.sum(dim=1) if lost_terms.dim() == 2 else \
            torch.stack([t.sum(dim=1) for t in lost_terms])
        w_eff = kept + torch.diag_embed(lost)
    w_eff = torch.where(active[..., :, None], w_eff, eye.float())
    d_idx = torch.where(eye, torch.zeros_like(stal), stal)
    onehot = d_idx[..., None] == torch.arange(
        S, dtype=d_idx.dtype, device=edges.device)
    w_stal = w_eff[..., None] * onehot
    stale_counts = (onehot & delivered[..., None]).sum(dim=(-3, -2)) \
        .to(torch.int32)
    return delivered, d_idx, w_stal, stale_counts


def net_push(params, netstate, rnd: int, step: torch.Tensor, S: int):
    """Advance both rings: slot 0 of ``hist`` becomes this round's post-step
    snapshot, slot 0 of ``lhist`` each node's last-step round."""
    hist, lhist = netstate
    hist = type(hist)(
        (k, p[:, None] if S == 1 else torch.cat([p[:, None], h[:, :-1]],
                                                dim=1))
        for (k, h), p in zip(hist.items(), params.values()))
    last = torch.where(step, torch.full_like(lhist[:, 0], rnd), lhist[:, 0])
    lhist = last[:, None] if S == 1 else \
        torch.cat([last[:, None], lhist[:, :-1]], dim=1)
    return hist, lhist


def net_observed(rnd: int, lhist: torch.Tensor, d_idx: torch.Tensor,
                 delivered: torch.Tensor) -> torch.Tensor:
    """Sum over delivered edges of the content staleness: this round minus
    the sender's last completed step as of the snapshot each edge delivers
    from (int32 scalar; ``[E]`` with a leading experiment axis on every
    input)."""
    n = d_idx.shape[-1]
    sender = torch.arange(n, device=d_idx.device)[None, :].expand(n, n)
    if d_idx.dim() == 2:
        seen = lhist[sender, d_idx.long()]
    else:
        exp = torch.arange(d_idx.shape[0], device=d_idx.device)
        seen = lhist[exp[:, None, None], sender, d_idx.long()]
    obs = rnd - seen
    return torch.where(delivered, obs, torch.zeros_like(obs)) \
        .sum(dim=(-2, -1)).to(torch.int32)


class Superstep:
    """Runs an in-graph strategy's rounds over node-stacked parameters on
    one device (see the module docstring); ``params`` / ``opt_state`` are
    the live state, ``hat`` / ``resid`` the codec's replicas and residual
    (None without a codec; ``hat`` None with a network model, whose ring
    holds the replicas), ``edge_history`` the per-round ``[n, n]`` bool
    edges (``(idx, mask)`` pairs past ``SPARSE_EDGE_DECODE_MAX`` nodes on
    the sparse path) and ``log`` the evaluation records.  With a network
    model, ``hist`` / ``lhist`` are the snapshot and last-step rings,
    ``delivered_history`` the per-round delivered edges and ``net_stats``
    the delivered, dropped and staleness counters.

    ``engine`` and ``compress`` default to ``cfg``'s; ``chunk`` caps the
    rounds run between host decodes (None: each evaluation segment at
    once) and does not change the trajectory.  Each must arrive concrete:
    ``"auto"`` is refused, as the runner resolves it through
    :func:`repro_torch.tune.resolve_knobs` first."""

    def __init__(self, *, loss_fn: Callable, eval_fn: Callable, optimizer,
                 batcher, test_batch, strategy, cfg: RunnerConfig,
                 params, opt_state, device, engine: Optional[str] = None,
                 chunk: Optional[int] = None, compress=None):
        engine = cfg.engine if engine is None else engine
        compress = cfg.compress if compress is None else compress
        if engine == "auto" or isinstance(chunk, str) or compress == "auto":
            raise TypeError(
                "the engine takes concrete knobs; \"auto\" sentinels are "
                "resolved by DecentralizedRunner via repro_torch.tune."
                "resolve_knobs before the engine is built")
        if not getattr(strategy, "in_graph", False):
            raise TypeError(
                f"strategy {getattr(strategy, 'name', strategy)!r} has no "
                "in-graph surface (init_graph_state/graph_round); run it "
                "through the runner's host loop (RunnerConfig.compiled "
                "None or False)")
        if getattr(batcher, "n", cfg.n_nodes) != cfg.n_nodes:
            raise ValueError(f"data_stream covers {batcher.n} nodes, "
                             f"config says {cfg.n_nodes}")
        self.cfg = cfg
        self.device = device
        self.strategy = strategy
        self.engine = resolve_engine(cfg, strategy, engine)
        self.chunk = chunk
        self.sparse_native = bool(getattr(strategy, "sparse", False))
        self.compat_gather = (self.engine == "sparse"
                              and not self.sparse_native
                              and cfg.sparse_mix == "gather")
        self.batcher = batcher
        self.test_batch = test_batch
        self.params = params
        self.opt_state = opt_state
        self.log = MetricsLog()
        self.edge_history: list = []
        self._comm_bytes = 0
        self._last_isolated: Optional[int] = None
        codec = CompressConfig.parse(compress)
        # A disabled codec is exactly compress="none": no carry, no ops.
        self.codec = codec if codec.enabled else None
        model_bytes = cfg.model_bytes \
            or stacked_model_bytes(params, cfg.n_nodes)
        # What one transfer costs: the codec's analytic wire bytes.
        self._wire_bytes = model_bytes if self.codec is None \
            else wire_bytes_tree(params, cfg.n_nodes, self.codec)
        n = cfg.n_nodes
        params = self.params = self._place(params)
        self.opt_state = self._place(opt_state)
        self.net = cfg.net
        self.net_stats = None
        self.delivered_history: list = []
        if self.net is not None:
            self._init_net(params)
        self.hat = self.resid = None
        if self.codec is not None:
            if self.net is None:
                self.hat = type(params)((k, v.to(torch.float32, copy=True))
                                        for k, v in params.items())
            self.resid = zero_residual(params)
        self.gstate = strategy.init_graph_state()
        # Sparse-native strategies never read an [n, n] similarity cache.
        self.sim = None if self.sparse_native else torch.zeros(
            (n, n), dtype=torch.float32, device=device)
        self._local_step = make_local_step(loss_fn, optimizer)
        self._evaluate = make_evaluator(eval_fn,
                                        batch_chunk=cfg.eval_batch_chunk)

    def _place(self, tree):
        """The state this engine keeps of a node-stacked tree: all of it
        on one device (a sharded engine keeps its rank's rows)."""
        return tree

    def logical_state(self):
        """``(params, opt_state)`` over all ``n`` nodes."""
        return self.params, self.opt_state

    def close(self) -> None:
        """Release what the engine holds besides its tensors (a sharded
        engine's own process group); nothing here."""

    def _init_net(self, params) -> None:
        """The network model's layout: the ring depth priced on the wire
        bytes, the fault timeline's ``[rounds, n]`` up and step masks on
        the device, the snapshot ring seeded with the initial models (f32
        copies under a codec) and the last-step ring of -1."""
        n, dev = self.cfg.n_nodes, self.device
        self.net_S = S = self.net.depth(self._wire_bytes)
        up, step = self.net.round_masks(self.cfg.rounds, n)
        self._net_up = torch.as_tensor(up, device=dev)
        self._net_step = torch.as_tensor(step, device=dev)
        snap0 = params if self.codec is None else type(params)(
            (k, v.float()) for k, v in params.items())
        self.hist = type(params)(
            (k, v[:, None].repeat((1, S) + (1,) * (v.dim() - 1)))
            for k, v in snap0.items())
        self.lhist = torch.full((n, S), -1, dtype=torch.int32, device=dev)
        self.net_stats = {"delivered": 0, "dropped": 0,
                          "staleness_hist": np.zeros(S, np.int64),
                          "staleness_sum": 0}

    def _batch(self, rnd: int):
        if hasattr(self.batcher, "draw"):
            return self.batcher.draw(rnd)
        return to_device(self.batcher.next(), self.device)

    def _encode(self, hat):
        """One difference-coded error-feedback step against the replicas
        ``hat``: encode ``(params - hat) + resid`` and keep the new
        residual; returns ``(wire, hat + decode(wire))``, the wire and the
        advanced replicas."""
        delta = type(self.params)((k, v.float() - hat[k])
                                  for k, v in self.params.items())
        wire, dec, self.resid = encode_delta_payload(delta, self.resid,
                                                     self.codec)
        return wire, type(dec)((k, hat[k] + v) for k, v in dec.items())

    def _code(self, hat):
        """The advanced replicas of :meth:`_encode`."""
        return self._encode(hat)[1]

    def _settle(self, mixed, decoded):
        """The round's new parameters: the mix itself without a codec, its
        consensus correction against the replicas with one."""
        if decoded is None:
            return mixed
        return apply_consensus_correction(mixed, self.params, decoded,
                                          self.codec.consensus_gamma)

    # ------------------------------------------------------------------
    # Where the population comes from and how it is mixed: one device's
    # layout here; a sharded engine overrides these and keeps the rounds.
    # ------------------------------------------------------------------

    def _population(self, stage: Callable):
        """Encode (under a codec) and bring in what the peers mix:
        ``(decoded, full)``, ``decoded`` the advanced replicas (None without
        a codec) and ``full`` a population gathered from other shards (None
        here: every node is on this device)."""
        decoded = None
        if self.codec is not None:
            decoded = self.hat = stage("encode", lambda: self._code(self.hat))
        return decoded, None

    def _view(self, ctrl, full, stage: Callable):
        """The logical ``[n, ...]`` population the controller reads:
        ``ctrl`` itself on one device."""
        return ctrl

    def _sparse_view(self, rnd: int, ctrl, full, stage: Callable):
        """What a sparse-native strategy's controller reads this round:
        :meth:`_view` if it reads the parameters, else None."""
        if not self.strategy.needs_params:
            return None
        return self._view(ctrl, full, stage)

    def _pad_mask(self, m: torch.Tensor) -> torch.Tensor:
        """This engine's rows of a logical ``[n]`` mask: all of them."""
        return m

    def _mix(self, edges, w, src, full, stage: Callable):
        """The dense round's mix of ``src`` by the round's edges or W."""
        # Under a codec the kernels mix the f32 replicas as they mix the
        # parameters.  The reference refuses its Pallas path with a codec
        # only because its dispatch reads the raw parameters; the
        # function is the same W @ decoded.
        chunk_d = self.cfg.mix_chunk_d

        def mix():
            if self.compat_gather:
                adj = dense_to_csr(edges, w, max(1, self.cfg.n_nodes - 1))
                return sparse_mix_pytree(adj, src)
            if self.strategy.uniform_mixing:
                return ops.mix_masked_pytree(edges, src, chunk_d)
            return ops.mix_pytree(w, src, chunk_d)
        return stage("mix", mix)

    def _sparse_mix(self, adj, src, full, stage: Callable):
        """The sparse-native round's mix of ``src`` by ``adj``."""
        return stage("mix", lambda: sparse_mix_pytree(adj, src))

    def _ring(self, stage: Callable):
        """The network ring the round mixes, ``[rows, S, ...]`` leaves, and
        the population of its slot 0 as :meth:`_view` takes it (None: the
        ring is this device's)."""
        return self.hist, None

    def _ring_rows(self, w_stal: torch.Tensor) -> torch.Tensor:
        """This engine's rows of the staleness-expanded W, ``[n, n S]``."""
        n = self.cfg.n_nodes
        return w_stal.reshape(n, n * self.net_S)

    # ------------------------------------------------------------------
    # Rounds.
    # ------------------------------------------------------------------

    def _graph_round(self, rnd: int, ctrl, full, stage: Callable):
        """A dense strategy's round: the Eq.-3 refresh on :meth:`_view`
        every ``sim_every`` rounds (for a strategy that reads it), then its
        graph round; returns ``(edges, W)``."""
        if self.strategy.needs_sim and rnd % self.cfg.sim_every == 0:
            pop = self._view(ctrl, full, stage)
            self.sim = stage("similarity",
                             lambda: ops.model_pairwise_cosine(pop))
        self.gstate, edges, w = stage(
            "controller",
            lambda: self.strategy.graph_round(self.gstate, rnd, self.sim))
        return edges, w

    def round(self, rnd: int, stage: Callable = _unstaged):
        """One round; returns its ``[n, n]`` bool in-edge matrix, or its
        ``(idx [n, k], mask [n, k])`` for a sparse-native strategy, or
        :meth:`net_round`'s tuple under a network model.

        Each stage runs as ``stage(name, fn)`` (by default just ``fn()``):
        batch, local_step, encode (under a codec), similarity (on its
        cadence), controller, mix and settle (a sharded engine adds
        gather and reduce)."""
        if self.net is not None:
            return self.net_round(rnd, stage)
        batch = stage("batch", lambda: self._batch(rnd))
        self.params, self.opt_state = stage("local_step", lambda: (
            self._local_step(self.params, self.opt_state, batch)))
        decoded, full = self._population(stage)
        # What the peers mix this round, and what the controller reads.
        src = self.params if decoded is None else decoded
        ctrl = src if self.codec is None or self.codec.sim else self.params
        if self.sparse_native:
            view = self._sparse_view(rnd, ctrl, full, stage)
            self.gstate, adj = stage("controller", lambda: (
                self.strategy.graph_round(self.gstate, rnd, view)))
            mixed = self._sparse_mix(adj, src, full, stage)
            self.params = stage("settle",
                                lambda: self._settle(mixed, decoded))
            return adj.idx, adj.mask
        edges, w = self._graph_round(rnd, ctrl, full, stage)
        mixed = self._mix(edges, w, src, full, stage)
        self.params = stage("settle", lambda: self._settle(mixed, decoded))
        return edges

    def net_round(self, rnd: int, stage: Callable = _unstaged):
        """One round under the network model; returns ``(edges [n, n]
        negotiated, delivered [n, n], stale_counts [S], obs_sum)``.

        Each stage runs as ``stage(name, fn)`` (by default just ``fn()``):
        batch, local_step (with the step mask's keep), masks, encode (under
        a codec), push, similarity (on its cadence), controller,
        delivery_plan, mix and settle (a sharded engine gathers the ring
        after the push), so a caller can time the round's own code stage
        by stage."""
        net, n, S, dev = self.net, self.cfg.n_nodes, self.net_S, self.device
        r = min(rnd, self.cfg.rounds - 1)
        up, step = self._net_up[r], self._net_step[r]
        keep = self._pad_mask(step)
        batch = stage("batch", lambda: self._batch(rnd))

        def local_step():
            new_p, new_o = self._local_step(self.params, self.opt_state,
                                            batch)
            return (net_select(keep, new_p, self.params),
                    net_select(keep, new_o, self.opt_state))

        def masks():
            draws = net.draws(rnd, n, dev)
            return (net.staleness_matrix(rnd, n, self._wire_bytes, S,
                                         draws=draws, device=dev),
                    net.drop_mask(rnd, n, draws=draws, device=dev))

        def plan():
            delivered, d_idx, w_stal, stale_counts = net_effective(
                edges, w, up, step, stal, drop, S,
                uniform=self.strategy.uniform_mixing)
            return (delivered, w_stal, stale_counts,
                    net_observed(rnd, self.lhist, d_idx, delivered))

        def mix():
            flat = OrderedDict((k, h.reshape((-1,) + h.shape[2:]))
                               for k, h in ring.items())
            return ops.mix_pytree(self._ring_rows(w_stal), flat,
                                  self.cfg.mix_chunk_d)

        self.params, self.opt_state = stage("local_step", local_step)
        stal, drop = stage("masks", masks)
        decoded = None
        if self.codec is not None:
            # The ring's slot 0 (last round's push) is the replica this
            # round's delta is coded against.
            decoded = stage("encode", lambda: self._code(OrderedDict(
                (k, h[:, 0]) for k, h in self.hist.items())))
        src = self.params if decoded is None else decoded
        ctrl = src if self.codec is None or self.codec.sim else self.params
        self.hist, self.lhist = stage("push", lambda: net_push(
            src, (self.hist, self.lhist), rnd, step, S))
        ring, full = self._ring(stage)
        edges, w = self._graph_round(rnd, ctrl, full, stage)
        delivered, w_stal, stale_counts, obs_sum = stage("delivery_plan",
                                                         plan)
        mixed = stage("mix", mix)
        self.params = stage("settle", lambda: self._settle(mixed, decoded))
        return edges, delivered, stale_counts, obs_sum

    def _run_chunk(self, start: int, end: int) -> np.ndarray:
        """Rounds ``[start, end]``; returns their ``[K, n, n]`` edges (the
        ``[K, n, k]`` masks past ``SPARSE_EDGE_DECODE_MAX`` nodes on the
        sparse path)."""
        if self.sparse_native:
            return self._run_sparse_chunk(start, end)
        if self.net is not None:
            return self._run_net_chunk(start, end)
        n = self.cfg.n_nodes
        buf = torch.empty((end - start + 1, n, n), dtype=torch.bool,
                          device=self.device)
        for i, rnd in enumerate(range(start, end + 1)):
            buf[i] = self.round(rnd)
        edges_np = buf.cpu().numpy()
        self.edge_history.extend(edges_np)
        self._comm_bytes += int(edges_np.sum()) * self._wire_bytes
        return edges_np

    def _run_net_chunk(self, start: int, end: int) -> np.ndarray:
        """Rounds ``[start, end]`` under the network model: buffers each
        round's negotiated and delivered edges and staleness counters on
        the device, then decodes them at the chunk end; comm bytes count
        the transfers that arrived."""
        n, k, dev = self.cfg.n_nodes, end - start + 1, self.device
        edges = torch.empty((k, n, n), dtype=torch.bool, device=dev)
        delivered = torch.empty_like(edges)
        stale = torch.empty((k, self.net_S), dtype=torch.int32, device=dev)
        obs = torch.empty((k,), dtype=torch.int32, device=dev)
        for i, rnd in enumerate(range(start, end + 1)):
            edges[i], delivered[i], stale[i], obs[i] = self.net_round(rnd)
        edges_np, delivered_np = edges.cpu().numpy(), delivered.cpu().numpy()
        self.edge_history.extend(edges_np)
        self.delivered_history.extend(delivered_np)
        n_del = int(delivered_np.sum())
        self._comm_bytes += n_del * self._wire_bytes
        stats = self.net_stats
        stats["delivered"] += n_del
        stats["dropped"] += int(edges_np.sum()) - n_del
        stats["staleness_hist"] += stale.cpu().numpy().astype(np.int64) \
            .sum(axis=0)
        stats["staleness_sum"] += int(obs.cpu().numpy().astype(np.int64)
                                      .sum())
        return edges_np

    def staleness_mean(self) -> float:
        """Mean delivered content staleness in rounds (0.0 without a
        network model or when nothing was delivered)."""
        return net_staleness_mean(self.net_stats)

    def _run_sparse_chunk(self, start: int, end: int) -> np.ndarray:
        n, k = self.cfg.n_nodes, self.strategy.k
        shape = (end - start + 1, n, k)
        idx_buf = torch.empty(shape, dtype=torch.int64, device=self.device)
        mask_buf = torch.empty(shape, dtype=torch.bool, device=self.device)
        for i, rnd in enumerate(range(start, end + 1)):
            idx_buf[i], mask_buf[i] = self.round(rnd)
        idx_np, mask_np = idx_buf.cpu().numpy(), mask_buf.cpu().numpy()
        self._comm_bytes += int(mask_np.sum()) * self._wire_bytes
        self._last_isolated = int((~mask_np[-1].any(axis=1)).sum())
        if n > SPARSE_EDGE_DECODE_MAX:
            self.edge_history.extend(zip(idx_np, mask_np))
            return mask_np
        dense = np.zeros((len(idx_np), n, n), bool)
        t_i, r_i, s_i = np.nonzero(mask_np)
        dense[t_i, r_i, idx_np[t_i, r_i, s_i]] = True
        self.edge_history.extend(dense)
        return dense

    def run_steps(self, rounds: int, chunk: Optional[int] = None) -> None:
        """Throughput mode (the reference's ``run_steps``): rounds ``0 ..
        rounds - 1`` from the current state in chunks of ``chunk`` (the
        engine's ``chunk`` by default, all at once when neither is set),
        no evaluation."""
        chunk = chunk or self.chunk or rounds
        start = 0
        while start < rounds:
            end = min(start + chunk, rounds) - 1
            self._run_chunk(start, end)
            start = end + 1

    def evaluate(self, rnd: int, edges: np.ndarray) -> RoundRecord:
        """Evaluate every node after round ``rnd`` and log the record."""
        rec = evaluate_record(self._evaluate, self.params, self.test_batch,
                              rnd, self._comm_bytes, edges,
                              isolated=self._last_isolated)
        self.log.add(rec)
        return rec

    def run(self, progress: Optional[Callable[[RoundRecord], None]] = None
            ) -> MetricsLog:
        """All ``cfg.rounds`` rounds, evaluating at each evaluation round
        (each segment run in pieces of at most ``chunk`` rounds); after
        each segment the strategy adopts the evolved graph state (where it
        has ``set_graph_state``), as the reference's engine hands it
        back."""
        for start, end in eval_boundaries(self.cfg.rounds,
                                          self.cfg.eval_every):
            s = start
            while s <= end:
                e = end if not self.chunk else min(s + self.chunk - 1, end)
                edges_np = self._run_chunk(s, e)
                s = e + 1
            if hasattr(self.strategy, "set_graph_state"):
                self.strategy.set_graph_state(self.gstate, self.sim)
            rec = self.evaluate(end, edges_np[-1])
            if progress is not None:
                progress(rec)
        return self.log
