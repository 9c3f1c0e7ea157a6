"""The sharded round engine — the port of ``repro.dlrt.compiled``'s sharded
mode (DESIGN.md §8: ``round_body_sharded``, ``round_body_sharded_net``,
``round_body_sharded_sparse``, ``sparse_mix_psum``) onto
``torch.distributed``.

One process per node-axis shard, SPMD: each rank of a
:class:`~repro_torch.launch.NodeMesh` runs the per-shard body the
reference runs under ``shard_map`` and meets the others in collectives
(NCCL for CUDA tensors, gloo for CPU tensors).  The node axis is padded
up to ``n_pad``, a multiple of the shard count, and rank r owns rows
``[r n_local, (r + 1) n_local)``:

* parameters, optimizer state, the codec's residual and (psum) replicas,
  the network ring and the batches are this rank's rows; padded rows
  repeat the last real node (edge padding), step every round, receive
  nothing and are sliced off everything a caller sees;
* the strategy's state, the ``[n, n]`` Eq.-3 cache, the controller and
  its draws, the edges and every counter are replicated at logical n:
  each rank makes the same draws and the same decisions;
* ``collective="gather"``: one ``all_gather`` a round over every leaf
  packed into one buffer, then this rank's row block of the embedded W
  (identity tail) applied to the gathered population through one grouped
  ``graph_mix`` launch; the Eq.-3 refresh runs the Gram kernel on the
  gathered logical rows.  A row block sums over the nodes in the order
  the whole contraction does, so on the CPU the trajectory is the
  single-device engine's bit for bit (the plain mixes are one sum order;
  a uniform strategy's W is ``uniform_weights_torch``, the masked plain
  mix's own quotients);
* ``collective="psum"``: each rank applies W's columns of its own nodes
  to its rows (f32 partials for every receiver, one grouped
  ``graph_mix`` launch with one W block per destination rank), then one
  ``reduce_scatter`` sums the partials over the ranks and leaves each
  rank its receivers — the reference's ``psum`` followed by its
  ``dynamic_slice``, with each rank moving only its block of the result.
  The sum over the nodes then runs rank by rank, so the bits are those
  of the single-device engine only on one rank ("f32-rounding-close"
  otherwise, as the reference says of its own); the population is
  gathered only on the rounds the refresh or the sparse controller reads
  it.

Under a codec the gather schedule gathers the wire (the codec's own
arrays, byte for byte) and rebuilds the population as ``hat +
decode(wire)`` from the replicas every rank holds at ``n_pad``; the psum
schedule keeps the replicas of this rank's rows.  The network model runs
under gather only: the ring is node-sharded and gathered once a round,
its slot 0 feeding the refresh, and this rank's ``[n_local, n_pad S]``
rows of the staleness-expanded W go through one ``graph_mix`` launch.
The sparse engine's row block and its psum partials run the CSR kernel
on the card (the block with its own rows' offset, the partials with no
self term), so one rank gives the single-device engine's bits there; on
the CPU they sum as the reference's ``jnp`` code does.

The rounds are :class:`~repro_torch.dlrt.Superstep`'s: this class
overrides only where the population comes from (``_population``,
``_view``, ``_ring``), how it is mixed (``_mix``, ``_sparse_mix``,
``_ring_rows``), the layout (``_place``, ``_pad_mask``, ``_batch``) and
evaluation.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Mapping

import numpy as np
import torch

from .. import collectives
from ..collectives import packed_all_gather
from ..compress import CompressConfig, decode_wire_tree
from ..core.mixing import uniform_weights_torch
from ..kernels import ops
from ..kernels.graph_mix import graph_mix_leaves
from ..sparse.adjacency import SparseAdjacency, pad_adjacency
from ..sparse.mix import sparse_mix_pytree, sparse_push_leaves
from .distributed import superstep_node_sharding
from .metrics import RoundRecord
from .runtime import make_round_record, resolve_engine, to_device
from .superstep import Superstep

COLLECTIVES = ("gather", "psum")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def embed_w(w: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``[..., n, n] -> [..., n_pad, n_pad]`` f32 with an identity tail:
    padded rows keep their own model and never reach a real row."""
    n = w.shape[-1]
    w = w.float()
    if n_pad == n:
        return w
    wp = torch.zeros(w.shape[:-2] + (n_pad, n_pad), dtype=torch.float32,
                     device=w.device)
    wp[..., :n, :n] = w
    tail = torch.arange(n, n_pad, device=w.device)
    wp[..., tail, tail] = 1.0
    return wp


def _rebuild(tree, it):
    if isinstance(tree, Mapping):
        return type(tree)((k, _rebuild(v, it)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


class ShardedSuperstep(Superstep):
    """:class:`~repro_torch.dlrt.Superstep` with the node axis sharded over
    ``mesh`` (see the module docstring); ``collective`` is ``"gather"`` or
    ``"psum"``.  ``params``, ``opt_state``, ``resid`` and ``hist`` are this
    rank's ``[n_local, ...]`` rows (``hat`` too under psum; under gather it
    holds every node's replica at ``n_pad``); :meth:`logical_state` gathers
    the parameters and the optimizer state at logical n on every rank.
    Every rank ends with the same log, edges, comm bytes and
    ``net_stats``.  Its refusals are the reference's: the compat gather
    mix, a codec with ``sim=False``, a network model under psum, an
    unknown collective."""

    def __init__(self, *, mesh, collective: str = "gather", params,
                 opt_state, cfg, strategy, test_batch, engine=None,
                 compress=None, device=None, **kw):
        if collective not in COLLECTIVES:
            raise ValueError(f"collective={collective!r} not in "
                             f"{COLLECTIVES}")
        eng = resolve_engine(cfg, strategy, engine)
        if eng == "sparse" and not getattr(strategy, "sparse", False) \
                and cfg.sparse_mix == "gather":
            raise ValueError(
                "compat gather-mix (dense strategy through in-scan CSR "
                "conversion) is a single-device numerics path; sharded "
                "runs use sparse_mix='exact' or a sparse-native strategy")
        spec = cfg.compress if compress is None else compress
        if spec != "auto":
            codec = CompressConfig.parse(spec)
            if codec.enabled and not codec.sim:
                raise ValueError(
                    "the sharded schedules move only the compressed wire "
                    "along the node axis, so control/similarity traffic "
                    "necessarily reads the decoded payload; "
                    "CompressConfig(sim=False) is a single-device knob")
        if cfg.net is not None and collective != "gather":
            raise ValueError("the dense network model gathers its "
                             "snapshot ring along the node axis; use "
                             f"collective='gather' (got {collective!r})")
        n = cfg.n_nodes
        self.mesh, self.collective = mesh, collective
        self.world, self.shard = superstep_node_sharding(mesh)
        self.n_pad = -(-n // self.world) * self.world
        self.n_local = self.n_pad // self.world
        self.offset = self.shard * self.n_local
        dev = mesh.device
        own = torch.arange(self.offset, self.offset + self.n_local,
                           device=dev)
        # This rank's rows as source rows (edge padding: a padded row
        # repeats the last real node) and which of them are real.
        self._src_rows = own.clamp(max=n - 1)
        self._real = own < n
        self._ctrl_every = int(getattr(strategy, "delta_r", 1) or 1)
        super().__init__(params=params, opt_state=opt_state, cfg=cfg,
                         strategy=strategy,
                         test_batch={k: v.to(dev)
                                     for k, v in test_batch.items()},
                         engine=engine, compress=compress, device=dev, **kw)
        if self.codec is not None and self.net is None \
                and collective == "gather":
            # Every rank holds every node's replica, at n_pad.
            rows = torch.arange(self.n_pad, device=dev).clamp(max=n - 1)
            self.hat = OrderedDict(
                (k, v.to(dev).float().index_select(0, rows))
                for k, v in params.items())
        if hasattr(self.batcher, "draw"):
            # This rank's rows of the index table; the dataset is shared.
            self._index = self.batcher.index.index_select(
                0, self._src_rows.to(self.batcher.index.device)).to(dev)

    # ------------------------------------------------------------------
    # Layout and collectives.
    # ------------------------------------------------------------------

    def _place(self, tree):
        """This rank's rows of a node-stacked tree (leaves ``[n, ...]``),
        on its device; other leaves (scalar counters) whole."""
        n = self.cfg.n_nodes
        return _rebuild(tree, iter(
            x.index_select(0, self._src_rows.to(x.device)).to(self.device)
            if x.dim() >= 1 and x.shape[0] == n else x.to(self.device)
            for x in _leaves(tree)))

    def gather(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's ``[n_local, ...]`` rows of each tensor (any dtype)
        as ``[n_pad, ...]``, bit for bit: one ``all_gather`` of all of them
        packed as bytes into one buffer."""
        return [g.reshape((self.n_pad,) + tuple(t.shape[1:]))
                for t, g in zip(tensors, packed_all_gather(tensors,
                                                           self.world))]

    def gather_tree(self, tree):
        """:meth:`gather` over the leaves of a tree that have this rank's
        rows on their leading axis; other leaves come back as they are."""
        leaves = _leaves(tree)
        rows = [x for x in leaves if x.dim() >= 1
                and x.shape[0] == self.n_local]
        got = iter(self.gather(rows)) if rows else iter(())
        return _rebuild(tree, iter(
            next(got) if x.dim() >= 1 and x.shape[0] == self.n_local else x
            for x in leaves))

    def _logical(self, tree):
        """The logical rows ``[:n]`` of a gathered ``[n_pad, ...]`` tree."""
        n = self.cfg.n_nodes
        return OrderedDict((k, v[:n].contiguous()) for k, v in tree.items())

    def _own(self, tree):
        """This rank's rows of an ``[n_pad, ...]`` tree."""
        a, b = self.offset, self.offset + self.n_local
        return OrderedDict((k, v[a:b]) for k, v in tree.items())

    def _gather_decoded(self, wire):
        """The population the peers hold after this round: the replicas
        plus every rank's decoded wire (gathered as the codec's arrays)."""
        arrays = [a for leaf in wire.values() for a in leaf.values()]
        got = iter(self.gather(arrays))
        full = OrderedDict((k, OrderedDict((name, next(got)) for name in w))
                           for k, w in wire.items())
        dec = decode_wire_tree(full, self.params, self.codec)
        return OrderedDict((k, self.hat[k] + v) for k, v in dec.items())

    def _embed_w(self, w: torch.Tensor) -> torch.Tensor:
        """``[n, n] -> [n_pad, n_pad]``: :func:`embed_w`."""
        return embed_w(w, self.n_pad)

    def _embed_w_stal(self, w_stal: torch.Tensor) -> torch.Tensor:
        """``[n, n, S] -> [n_pad, n_pad S]``: an identity tail at staleness
        0, so padded rows keep their own fresh snapshot."""
        n, n_pad, S = self.cfg.n_nodes, self.n_pad, self.net_S
        if n_pad == n:
            return w_stal.reshape(n, n * S)
        wp = torch.zeros((n_pad, n_pad, S), dtype=w_stal.dtype,
                         device=w_stal.device)
        wp[:n, :n] = w_stal
        tail = torch.arange(n, n_pad, device=w_stal.device)
        wp[tail, tail, 0] = 1.0
        return wp.reshape(n_pad, n_pad * S)

    def _pad_mask(self, m: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a logical ``[n]`` bool mask; padded rows
        True (they step every round)."""
        return torch.where(self._real, m[self._src_rows], True)

    def _mix_psum(self, w_pad: torch.Tensor, local, stage: Callable):
        """``W [:, own columns] @ local`` in f32 for every receiver, one
        grouped launch (one W block per destination rank), then one
        ``reduce_scatter`` of the partials: this rank's rows of ``W X``."""
        nl, world = self.n_local, self.world
        cols = w_pad[:, self.offset:self.offset + nl]
        blocks = [cols[r * nl:(r + 1) * nl].contiguous()
                  for r in range(world)]
        keys = list(local)
        xs = [local[k].reshape(nl, -1).float().contiguous() for k in keys]
        ds = [x.shape[1] for x in xs]
        per = nl * sum(ds)
        send = torch.empty(world * per, dtype=torch.float32,
                           device=self.device)
        ws, xl, outs = [], [], []
        for r in range(world):
            at = r * per
            for x, d in zip(xs, ds):
                ws.append(blocks[r])
                xl.append(x)
                outs.append(send[at:at + nl * d].view(nl, d))
                at += nl * d
        stage("mix", lambda: graph_mix_leaves(ws, xl, self.cfg.mix_chunk_d,
                                              out=outs))
        return self._reduce(send, keys, ds, local, stage)

    def _reduce(self, send: torch.Tensor, keys, ds, local, stage: Callable,
                add=None):
        """Sum the rank-major f32 partials ``send`` over the ranks into
        this rank's rows (plus ``add[k]`` where given), in each leaf's
        shape and dtype."""
        nl = self.n_local
        recv = torch.empty(nl * sum(ds), dtype=torch.float32,
                           device=self.device)
        stage("reduce", lambda: collectives.reduce_scatter_into(recv, send))
        out, at = OrderedDict(), 0
        for k, d in zip(keys, ds):
            own = recv[at:at + nl * d].view(nl, d)
            if add is not None:
                own = own + add[k]
            out[k] = own.reshape(local[k].shape).to(local[k].dtype)
            at += nl * d
        return out

    def _sparse_mix_psum(self, apad: SparseAdjacency, local,
                         stage: Callable):
        """The push schedule of the sparse engine: this rank's senders'
        contributions to every receiver (f32 partials,
        :func:`~repro_torch.sparse.mix.sparse_push_leaves`), one
        ``reduce_scatter`` down to this rank's receivers, then the self
        term."""
        off, nl, world = self.offset, self.n_local, self.world
        idx = apad.idx.long()
        mine = apad.mask & (idx >= off) & (idx < off + nl)
        local_w = torch.where(mine, apad.w, 0.0).float()
        lidx = (idx - off).clamp(0, nl - 1)
        ws_own = apad.w_self[off:off + nl].float()[:, None]
        keys = list(local)
        flats = [local[k].reshape(nl, -1).float() for k in keys]
        ds = [f.shape[1] for f in flats]
        send = torch.empty((world, nl * sum(ds)), dtype=torch.float32,
                           device=self.device)

        def partials():
            parts = sparse_push_leaves(lidx, local_w, flats,
                                       self.cfg.mix_chunk_d)
            at = 0
            for part, d in zip(parts, ds):
                send[:, at:at + nl * d] = part.reshape(world, nl * d)
                at += nl * d
        stage("mix", partials)
        add = OrderedDict((k, ws_own * f) for k, f in zip(keys, flats))
        return self._reduce(send.view(-1), keys, ds, local, stage, add=add)

    # ------------------------------------------------------------------
    # Rounds.
    # ------------------------------------------------------------------

    def _batch(self, rnd: int):
        """This rank's rows of round ``rnd``'s batch: a device stream draws
        the whole ``[n, b]`` slot table as one device does and keeps its
        rows; a host batcher's ``[n, b, ...]`` batch is edge-padded and
        sliced the same way."""
        rows = self._src_rows
        if hasattr(self.batcher, "draw"):
            take = self.batcher.slots(rnd)
            take = take.index_select(0, rows.to(take.device)).to(self.device)
            sel = self._index.gather(1, take)
            return {k: v[sel.to(v.device)].to(self.device)
                    for k, v in self.batcher.data.items()}
        host = self.batcher.next()
        keep = rows.cpu().numpy()
        return to_device({k: np.asarray(v)[keep] for k, v in host.items()},
                         self.device)

    def _population(self, stage: Callable):
        """Encode this rank's rows (under a codec) and, under gather, bring
        in the population: ``(decoded, full)``, ``decoded`` this rank's
        advanced replicas (None without a codec) and ``full`` the gathered
        ``[n_pad, ...]`` models or replicas (None under psum)."""
        gather = self.collective == "gather"
        decoded = full = None
        if self.codec is not None:
            if gather:
                wire, decoded = stage("encode", lambda: self._encode(
                    self._own(self.hat)))
                full = self.hat = stage(
                    "gather", lambda: self._gather_decoded(wire))
            else:
                decoded = self.hat = stage("encode",
                                           lambda: self._code(self.hat))
        elif gather:
            full = stage("gather", lambda: OrderedDict(zip(
                self.params, self.gather(list(self.params.values())))))
        return decoded, full

    def _view(self, ctrl, full, stage: Callable):
        """The logical population for the controller: the standing gather
        under gather, a gather of ``ctrl`` on the rounds that read it under
        psum."""
        if full is None:
            full = stage("gather", lambda: OrderedDict(zip(
                ctrl, self.gather(list(ctrl.values())))))
        return self._logical(full)

    def _sparse_view(self, rnd: int, ctrl, full, stage: Callable):
        """Under psum the controller's population is gathered only every
        ``delta_r`` rounds (it reads none in between)."""
        if full is None and rnd % self._ctrl_every:
            return None
        return super()._sparse_view(rnd, ctrl, full, stage)

    def _mix(self, edges, w, src, full, stage: Callable):
        """This rank's rows of ``W src`` with W embedded at ``n_pad`` (a
        uniform strategy's from its edges): the row block over the gathered
        population in one grouped launch, or the psum schedule."""
        w_pad = self._embed_w(uniform_weights_torch(edges)
                              if self.strategy.uniform_mixing else w)
        if full is None:
            return self._mix_psum(w_pad, src, stage)
        a = self.offset
        return stage("mix", lambda: ops.mix_pytree(
            w_pad[a:a + self.n_local], full, self.cfg.mix_chunk_d))

    def _sparse_mix(self, adj, src, full, stage: Callable):
        """This rank's receiver block of the padded adjacency over the
        gathered population, or the psum schedule."""
        apad = pad_adjacency(adj, self.n_pad)
        if full is None:
            return self._sparse_mix_psum(apad, src, stage)
        a, b = self.offset, self.offset + self.n_local
        block = SparseAdjacency(*(t[a:b] for t in apad))
        return stage("mix", lambda: sparse_mix_pytree(
            block, full, rows=a, chunk_d=self.cfg.mix_chunk_d))

    def _ring(self, stage: Callable):
        """The ring gathered once a round (after the push), and its slot 0
        for the refresh."""
        ring = stage("gather", lambda: OrderedDict(zip(
            self.hist, self.gather(list(self.hist.values())))))
        return ring, OrderedDict((k, h[:, 0]) for k, h in ring.items())

    def _ring_rows(self, w_stal: torch.Tensor) -> torch.Tensor:
        """This rank's ``[n_local, n_pad S]`` rows of the embedded
        staleness-expanded W."""
        a = self.offset
        return self._embed_w_stal(w_stal)[a:a + self.n_local]

    # ------------------------------------------------------------------
    # What a caller sees.
    # ------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, rnd: int, edges: np.ndarray) -> RoundRecord:
        """Each rank evaluates its rows; the per-node losses and metrics
        are gathered, so every rank logs the same record."""
        losses, metrics = self._evaluate(self.params, self.test_batch)
        keys = list(metrics)
        got = self.gather([losses] + [metrics[k] for k in keys])
        n = self.cfg.n_nodes
        rec = make_round_record(
            rnd, got[0][:n].cpu().numpy(),
            {k: v[:n].cpu().numpy() for k, v in zip(keys, got[1:])},
            self._comm_bytes, edges, isolated=self._last_isolated)
        self.log.add(rec)
        return rec

    def logical_state(self):
        """``(params, opt_state)`` gathered from every rank at logical n,
        the same on every rank."""
        n = self.cfg.n_nodes
        params, opt_state = self.gather_tree((self.params, self.opt_state))
        cut = lambda x: x[:n] if x.dim() >= 1 and x.shape[0] == self.n_pad \
            else x
        return (_rebuild(params, iter(cut(x) for x in _leaves(params))),
                _rebuild(opt_state, iter(cut(x)
                                         for x in _leaves(opt_state))))

    def close(self) -> None:
        """Destroy the mesh's process group if the mesh started it."""
        self.mesh.close()

