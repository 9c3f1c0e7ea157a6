"""The Morph controller as tensor code — the port of ``repro.core.morph``.

One negotiation (:func:`update_topology`) refreshes direct Eq.-3
measurements on the current in-edges, fills in transitive Eq.-4 estimates,
picks each node's wanted senders (``k`` by Gumbel-top-k on
dissimilarity, the rest uniformly at random), matches receivers and
senders by bounded deferred acceptance, and spreads peer knowledge along
the new edges.

Randomness: a negotiation needs four ``[n, n]`` draws (:class:`MorphNoise`).
Passed in, they are used as given (the parity tests replay the
reference's ``jax.random`` draws); otherwise they come from the state's
CPU ``torch.Generator``, which therefore advances only on negotiation
rounds, as the reference's key does.  Drawing on the host keeps a run's
graph sequence the same on any device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .matching import match_dense
from .selection import (gumbel, random_injection, sample_gumbel_topk,
                        scatter_or)

TIE_NOISE = 1e-4


class MorphGraphState(NamedTuple):
    """Controller state (leading axis = node where ``[n, ...]``)."""
    known: torch.Tensor          # [n, n] bool — partial views P_i
    sim: torch.Tensor            # [n, n] f32 — latest similarity estimates
    sim_valid: torch.Tensor      # [n, n] bool — usable estimates (C_A)
    edges: torch.Tensor          # [n, n] bool — current in-edge matrix
    generator: torch.Generator   # CPU generator for the draws


class MorphNoise(NamedTuple):
    """The draws of one negotiation, each ``[n, n]`` f32 on the device."""
    select: torch.Tensor         # Gumbel, row i = node i's Eq.-5 picks
    inject: torch.Tensor         # Gumbel, row i = node i's random peers
    tie_recv: torch.Tensor       # U[0, 1e-4), receiver preference ties
    tie_send: torch.Tensor       # U[0, 1e-4), sender preference ties


def init_state(initial_adj: torch.Tensor, seed: int = 0) -> MorphGraphState:
    """Bootstrap from an ``[n, n]`` adjacency (self-loops stripped): known
    peers = current edges = the bootstrap graph, no estimates yet."""
    n = initial_adj.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=initial_adj.device)
    adj = initial_adj.bool() & ~eye
    return MorphGraphState(
        known=adj,
        sim=torch.zeros((n, n), dtype=torch.float32, device=adj.device),
        sim_valid=torch.zeros_like(adj),
        edges=adj,
        generator=torch.Generator().manual_seed(seed))


def draw_noise(generator: torch.Generator, n: int, device) -> MorphNoise:
    """One negotiation's draws from ``generator``."""
    sel = gumbel((n, n), generator, device)
    inj = gumbel((n, n), generator, device)
    ties = [(torch.rand((n, n), generator=generator) * TIE_NOISE).to(device)
            for _ in range(2)]
    return MorphNoise(sel, inj, ties[0], ties[1])


def update_topology(state: MorphGraphState, sim: torch.Tensor, k: int,
                    view_size: int, beta: float,
                    noise: Optional[MorphNoise] = None) -> MorphGraphState:
    """One Δ_r negotiation on the ``[n, n]`` Eq.-3 matrix ``sim``: returns
    the new state, whose ``edges`` (in-degree and out-degree <= ``k``) the
    round mixes over uniformly (:func:`~.mixing.uniform_weights_torch`)."""
    n = state.known.shape[0]
    dev = state.known.device
    if noise is None:
        noise = draw_noise(state.generator, n, dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    # Measurements: a node evaluates Eq. 3 on every model it receives.
    true_sim = sim.float()
    sim = torch.where(state.edges, true_sim, state.sim)
    sim_valid = state.sim_valid | state.edges

    # Transitive estimates (Eq. 4) through shared informants y.
    inf_mask = (sim_valid[:, :, None] & sim_valid.T[None, :, :]).float()
    est_num = torch.einsum("iy,iyz,yz->iz", sim, inf_mask, sim)
    est_cnt = inf_mask.sum(dim=1)
    est = est_num / est_cnt.clamp_min(1.0)
    sim = torch.where(sim_valid, sim, est)
    sim_valid = sim_valid | (est_cnt > 0)

    # Alg. 3 for every node: k diversity picks + (view_size - k) random.
    cand = sim_valid & state.known & ~eye                 # C_A
    full = state.known & ~eye                             # C
    bidx, bvalid = sample_gumbel_topk(sim, cand, k, beta, noise=noise.select)
    want = scatter_or(bidx, bvalid, n)
    r = view_size - k
    if r > 0:
        ridx, rvalid = random_injection(full & ~cand & ~want, r,
                                        noise=noise.inject)
        want = want | scatter_or(ridx, rvalid, n)

    # College-admission matching: receivers prefer dissimilar senders,
    # rejected receivers fall back to their other known peers.
    fallback = full & ~want
    recv_pref = (torch.where(cand, -sim, 0.0)
                 + torch.where(want, 2.0, 0.0)
                 + torch.where(fallback, -4.0, 0.0)
                 + noise.tie_recv)
    send_pref = recv_pref.T + noise.tie_send
    edges = match_dense(recv_pref, send_pref, want | fallback, k, k)

    # Every matched edge delivers a model: a direct measurement.
    sim = torch.where(edges, true_sim, sim)
    sim_valid = sim_valid | edges

    # Gossip discovery: receiving from j teaches i everything j knows.
    # (f32 product of 0/1 counts <= n is exact; CUDA has no int matmul.)
    reach = (edges.float() @ (state.known | eye).float()) > 0
    known = (state.known | reach) & ~eye

    return MorphGraphState(known=known, sim=sim, sim_valid=sim_valid,
                           edges=edges, generator=state.generator)
