"""Bounded deferred-acceptance matching on dense masks (paper §III-B) —
the port of ``repro.core.matching.match_jax``.

Receivers propose to their best fresh candidates up to ``k_in`` held
edges; senders keep their best ``k_out`` among held and new proposals and
reject the rest; repeat until nothing changes.  The reference runs the
sweeps in a ``lax.while_loop`` that stops at the fixpoint.  Here a sweep
is a handful of small tensor ops, and asking the host after every sweep
whether anything changed would stall the device each time, so sweeps run
in blocks with one host check per block: a sweep at the fixpoint changes
nothing, so the extra sweeps of the last block leave the edges exactly as
the reference's loop does.  The sweep count never exceeds the
reference's bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from .selection import NEG_INF, scatter_or, stable_topk

SWEEPS_PER_CHECK = 8


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int,
                quota: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean mask of each row's best ``k`` masked entries, ties to the
    lower index; a per-row ``quota`` ``[rows, 1]`` may lower ``k``."""
    _, idx = stable_topk(torch.where(mask, scores, NEG_INF), k)
    ok = mask.gather(-1, idx)                       # real candidates only
    if quota is not None:
        ok &= torch.arange(k, device=mask.device)[None] < quota
    return scatter_or(idx, ok, mask.shape[-1])


def match_dense(recv_scores: torch.Tensor, send_scores: torch.Tensor,
                candidate_mask: torch.Tensor, k_in: int, k_out: int,
                rounds: Optional[int] = None) -> torch.Tensor:
    """In-edge matrix ``E[i, j]`` (sender j serves receiver i) with
    in-degree <= ``k_in`` and out-degree <= ``k_out``.

    ``recv_scores[i, j]``: receiver i's preference for sender j (higher
    proposes earlier); ``send_scores[j, i]``: sender j's preference for
    receiver i; ``candidate_mask[i, j]``: i may contact j at all.
    ``rounds`` bounds the sweeps (default ``n * k_out``, the reference's
    fixpoint bound)."""
    n = recv_scores.shape[0]
    if rounds is None:
        rounds = n * max(k_out, 1)
    eye = torch.eye(n, dtype=torch.bool, device=candidate_mask.device)
    cand = candidate_mask & ~eye

    def sweep(accepted, rejected):
        avail = cand & ~accepted & ~rejected
        need = k_in - accepted.sum(dim=1, keepdim=True)
        proposals = masked_topk(recv_scores, avail, k_in, quota=need)
        pool = accepted | proposals                 # [recv, send]
        new_accepted = masked_topk(send_scores, pool.T, k_out).T
        return new_accepted, rejected | (pool & ~new_accepted)

    accepted = torch.zeros((n, n), dtype=torch.bool, device=cand.device)
    rejected = torch.zeros_like(accepted)
    done = 0
    while done < rounds:
        before = (accepted, rejected)
        block = min(SWEEPS_PER_CHECK, rounds - done)
        for _ in range(block):
            accepted, rejected = sweep(accepted, rejected)
        done += block
        changed = (accepted ^ before[0]) | (rejected ^ before[1])
        if not bool(changed.any()):
            break
    return accepted
