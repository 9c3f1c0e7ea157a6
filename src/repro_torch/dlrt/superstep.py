"""The single-device round engine — the port of
``repro.dlrt.compiled.CompiledSuperstep``'s ``round_body`` and
``round_body_sparse`` (no network model, no compression, no mesh, Pallas
kernels on).

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
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..sparse.adjacency import dense_to_csr
from ..sparse.mix import sparse_mix_pytree
from .metrics import MetricsLog, RoundRecord
from .runtime import (RunnerConfig, make_evaluator, make_local_step,
                      make_round_record, resolve_engine, stacked_model_bytes,
                      to_device)

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


class Superstep:
    """Runs an in-graph strategy's rounds over node-stacked parameters on
    one device (see the module docstring); ``params`` / ``opt_state`` are
    the live state, ``edge_history`` the per-round ``[n, n]`` bool edges
    (``(idx, mask)`` pairs past ``SPARSE_EDGE_DECODE_MAX`` nodes on the
    sparse path) and ``log`` the evaluation records."""

    def __init__(self, *, loss_fn: Callable, eval_fn: Callable, optimizer,
                 batcher, test_batch, strategy, cfg: RunnerConfig,
                 params, opt_state, device):
        if getattr(batcher, "n", cfg.n_nodes) != cfg.n_nodes:
            raise ValueError(f"data_stream covers {batcher.n} nodes, "
                             f"config says {cfg.n_nodes}")
        self.cfg = cfg
        self.device = device
        self.strategy = strategy
        self.engine = resolve_engine(cfg, strategy)
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
        self._model_bytes = stacked_model_bytes(params, cfg.n_nodes)
        self.gstate = strategy.init_graph_state()
        n = cfg.n_nodes
        # Sparse-native strategies never read an [n, n] similarity cache.
        self.sim = None if self.sparse_native else torch.zeros(
            (n, n), dtype=torch.float32, device=device)
        self._local_step = make_local_step(loss_fn, optimizer)
        self._evaluate = make_evaluator(eval_fn,
                                        batch_chunk=cfg.eval_batch_chunk)

    def _batch(self, rnd: int):
        if hasattr(self.batcher, "draw"):
            return self.batcher.draw(rnd)
        return to_device(self.batcher.next(), self.device)

    def round(self, rnd: int):
        """One round; returns its ``[n, n]`` bool in-edge matrix, or its
        ``(idx [n, k], mask [n, k])`` for a sparse-native strategy."""
        self.params, self.opt_state = self._local_step(
            self.params, self.opt_state, self._batch(rnd))
        if self.sparse_native:
            self.gstate, adj = self.strategy.graph_round(
                self.gstate, rnd,
                self.params if self.strategy.needs_params else None)
            self.params = sparse_mix_pytree(adj, self.params)
            return adj.idx, adj.mask
        if self.strategy.needs_sim and rnd % self.cfg.sim_every == 0:
            self.sim = ops.model_pairwise_cosine(self.params)
        self.gstate, edges, w = self.strategy.graph_round(
            self.gstate, rnd, self.sim)
        if self.compat_gather:
            adj = dense_to_csr(edges, w, max(1, self.cfg.n_nodes - 1))
            self.params = sparse_mix_pytree(adj, self.params)
        elif self.strategy.uniform_mixing:
            self.params = ops.mix_masked_pytree(edges, self.params)
        else:
            self.params = ops.mix_pytree(w, self.params)
        return edges

    def _run_chunk(self, start: int, end: int) -> np.ndarray:
        """Rounds ``[start, end]``; returns their ``[K, n, n]`` edges (the
        ``[K, n, k]`` masks past ``SPARSE_EDGE_DECODE_MAX`` nodes on the
        sparse path)."""
        if self.sparse_native:
            return self._run_sparse_chunk(start, end)
        n = self.cfg.n_nodes
        buf = torch.empty((end - start + 1, n, n), dtype=torch.bool,
                          device=self.device)
        for i, rnd in enumerate(range(start, end + 1)):
            buf[i] = self.round(rnd)
        edges_np = buf.cpu().numpy()
        self.edge_history.extend(edges_np)
        self._comm_bytes += int(edges_np.sum()) * self._model_bytes
        return edges_np

    def _run_sparse_chunk(self, start: int, end: int) -> np.ndarray:
        n, k = self.cfg.n_nodes, self.strategy.k
        shape = (end - start + 1, n, k)
        idx_buf = torch.empty(shape, dtype=torch.int64, device=self.device)
        mask_buf = torch.empty(shape, dtype=torch.bool, device=self.device)
        for i, rnd in enumerate(range(start, end + 1)):
            idx_buf[i], mask_buf[i] = self.round(rnd)
        idx_np, mask_np = idx_buf.cpu().numpy(), mask_buf.cpu().numpy()
        self._comm_bytes += int(mask_np.sum()) * self._model_bytes
        self._last_isolated = int((~mask_np[-1].any(axis=1)).sum())
        if n > SPARSE_EDGE_DECODE_MAX:
            self.edge_history.extend(zip(idx_np, mask_np))
            return mask_np
        dense = np.zeros((len(idx_np), n, n), bool)
        t_i, r_i, s_i = np.nonzero(mask_np)
        dense[t_i, r_i, idx_np[t_i, r_i, s_i]] = True
        self.edge_history.extend(dense)
        return dense

    @torch.no_grad()
    def evaluate(self, rnd: int, edges: np.ndarray) -> RoundRecord:
        """Evaluate every node after round ``rnd`` and log the record."""
        losses, metrics = self._evaluate(self.params, self.test_batch)
        rec = make_round_record(
            rnd, losses.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in metrics.items()},
            self._comm_bytes, edges, isolated=self._last_isolated)
        self.log.add(rec)
        return rec

    def run(self, progress: Optional[Callable[[RoundRecord], None]] = None
            ) -> MetricsLog:
        """All ``cfg.rounds`` rounds, evaluating at each chunk end; after
        each chunk the strategy adopts the evolved graph state (where it
        has ``set_graph_state``), as the reference's engine hands it
        back."""
        for start, end in eval_boundaries(self.cfg.rounds,
                                          self.cfg.eval_every):
            edges_np = self._run_chunk(start, end)
            if hasattr(self.strategy, "set_graph_state"):
                self.strategy.set_graph_state(self.gstate, self.sim)
            rec = self.evaluate(end, edges_np[-1])
            if progress is not None:
                progress(rec)
        return self.log
