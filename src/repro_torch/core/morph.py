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

A sweep's experiments negotiate together: :func:`update_topology` also
takes a state whose tensors carry a leading ``[E]`` axis and whose
``generator`` is a tuple of E generators (:func:`stack_states`), with a
``[E]`` axis on ``sim``, ``beta`` and ``noise``.  Each experiment gets the
bits of its own call: the operations are elementwise, sorts, or exact sums
of 0/1 counts, and the one product that sums real numbers (Eq. 4's
numerator) runs per experiment, as a batched product may add in another
order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from .matching import match_dense
from .mixing import apply_mixing, uniform_weights_torch
from .selection import (gumbel, random_injection, sample_gumbel_topk,
                        scatter_or)

TIE_NOISE = 1e-4


class MorphGraphState(NamedTuple):
    """Controller state (leading axis = node where ``[n, ...]``; a sweep's
    stacked state has ``[E, n, n]`` tensors and a tuple of E
    generators)."""
    known: torch.Tensor          # [n, n] bool — partial views P_i
    sim: torch.Tensor            # [n, n] f32 — latest similarity estimates
    sim_valid: torch.Tensor      # [n, n] bool — usable estimates (C_A)
    edges: torch.Tensor          # [n, n] bool — current in-edge matrix
    generator: Union[torch.Generator, tuple]   # CPU generator(s), draws


class MorphNoise(NamedTuple):
    """The draws of one negotiation, each ``[n, n]`` f32 on the device
    (``[E, n, n]`` for a sweep's experiments)."""
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


def stack_noise(draws: Sequence[MorphNoise]) -> MorphNoise:
    """Experiments' draws stacked on a leading ``[E]`` axis."""
    return MorphNoise(*(torch.stack(field) for field in zip(*draws)))


def stack_states(states: Sequence[MorphGraphState]) -> MorphGraphState:
    """Experiments' states stacked on a leading ``[E]`` axis; the
    generators stay each experiment's own (a tuple)."""
    return MorphGraphState(
        *(torch.stack(field) for field in list(zip(*states))[:4]),
        generator=tuple(st.generator for st in states))


def _eq4_numerator(sim: torch.Tensor, inf_mask: torch.Tensor
                   ) -> torch.Tensor:
    """``sum_y sim[i, y] inf_mask[i, y, z] sim[y, z]``, one product per
    experiment where there is an experiment axis (the solo call's own
    product, so its summation order)."""
    if sim.dim() == 2:
        return torch.einsum("iy,iyz,yz->iz", sim, inf_mask, sim)
    return torch.stack([_eq4_numerator(s, m) for s, m in zip(sim, inf_mask)])


def update_topology(state: MorphGraphState, sim: torch.Tensor, k: int,
                    view_size: int, beta,
                    noise: Optional[MorphNoise] = None) -> MorphGraphState:
    """One Δ_r negotiation on the ``[n, n]`` Eq.-3 matrix ``sim``: returns
    the new state, whose ``edges`` (in-degree and out-degree <= ``k``) the
    round mixes over uniformly (:func:`~.mixing.uniform_weights_torch`).

    A stacked state (:func:`stack_states`) negotiates E experiments at
    once: ``sim`` is ``[E, n, n]``, ``beta`` a number or one an experiment
    (``[E]``), ``noise`` stacked (:func:`stack_noise`) or drawn from each
    experiment's generator; experiment ``e`` gets its own call's bits."""
    n = state.known.shape[-1]
    dev = state.known.device
    batched = state.known.dim() == 3
    if noise is None:
        noise = stack_noise([draw_noise(g, n, dev)
                             for g in state.generator]) \
            if batched else draw_noise(state.generator, n, dev)
    if batched and isinstance(beta, torch.Tensor):
        beta = beta.to(device=dev, dtype=torch.float32)[:, None, None]
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    # Measurements: a node evaluates Eq. 3 on every model it receives.
    true_sim = sim.float()
    sim = torch.where(state.edges, true_sim, state.sim)
    sim_valid = state.sim_valid | state.edges

    # Transitive estimates (Eq. 4) through shared informants y.
    inf_mask = (sim_valid[..., :, :, None]
                & sim_valid.transpose(-1, -2)[..., None, :, :]).float()
    est_num = _eq4_numerator(sim, inf_mask)
    est_cnt = inf_mask.sum(dim=-2)
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
    send_pref = recv_pref.transpose(-1, -2) + noise.tie_send
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


def mix_round(state: MorphGraphState, stacked_params):
    """Between negotiations: uniform mixing over the current edges (Alg. 2
    keeps a node's senders for ``delta_r`` rounds)."""
    return apply_mixing(uniform_weights_torch(state.edges), stacked_params)
