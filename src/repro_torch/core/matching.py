"""Deferred-acceptance matching (paper §III-B) — the port of
``repro.core.matching``: :func:`deferred_acceptance`, the host
college-admission scheme of the message-faithful protocol (a copy of the
reference's), and :func:`match_dense`, the bounded form on dense masks
(the reference's ``match_jax``).

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

:func:`match_dense` and :func:`masked_topk` also take leading batch
dimensions (a sweep's experiments): every experiment sweeps in the same
blocks, and one host check a block asks whether any of them changed.  An
experiment at its fixpoint is left exactly as it is by the extra sweeps,
so each one ends with the edges of its own call.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .selection import NEG_INF, scatter_or, stable_topk

SWEEPS_PER_CHECK = 8


def deferred_acceptance(prefs: Sequence[Sequence[int]],
                        sender_scores: np.ndarray, k_in: int,
                        k_out: int) -> np.ndarray:
    """Many-to-many deferred acceptance on the host.

    ``prefs[i]`` lists receiver i's candidate senders, best first;
    ``sender_scores[j, i]`` is how much sender j prefers serving receiver
    i (Morph: the reported dissimilarity).  A sender accepts while it
    serves fewer than ``k_out`` receivers, else evicts its least preferred
    one for a more preferred newcomer; rejected and evicted receivers move
    down their lists.  Returns the in-edge matrix ``E[i, j]`` (j serves
    i): in-degree <= ``k_in``, out-degree <= ``k_out``."""
    n = sender_scores.shape[0]
    next_choice = [0] * n                      # cursor into prefs[i]
    held: Dict[int, List[int]] = {j: [] for j in range(n)}  # sender -> rcvrs
    accepted = [0] * n                         # receiver in-degree so far
    bound = max(1, math.ceil((n - 1) / max(k_in, 1))) + k_in + 1

    for _ in range(bound * max(k_in, 1)):
        progressed = False
        for i in range(n):
            while accepted[i] < k_in and next_choice[i] < len(prefs[i]):
                j = prefs[i][next_choice[i]]
                next_choice[i] += 1
                if j == i:
                    continue
                progressed = True
                slot = held[j]
                if len(slot) < k_out:
                    slot.append(i)
                    accepted[i] += 1
                else:
                    worst = min(slot, key=lambda r: sender_scores[j, r])
                    if sender_scores[j, i] > sender_scores[j, worst]:
                        slot.remove(worst)
                        accepted[worst] -= 1
                        slot.append(i)
                        accepted[i] += 1
                # else: rejected, i moves on (loop continues)
        if not progressed:
            break

    edges = np.zeros((n, n), bool)
    for j, rcvrs in held.items():
        for i in rcvrs:
            edges[i, j] = True
    return edges


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int,
                quota: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean mask of each row's best ``k`` masked entries, ties to the
    lower index; a per-row ``quota`` ``[..., rows, 1]`` may lower ``k``.
    Leading dimensions are batch dimensions."""
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
    fixpoint bound).  Leading dimensions of the three ``[..., n, n]``
    inputs are independent problems, matched together (the module
    docstring)."""
    n = recv_scores.shape[-1]
    if rounds is None:
        rounds = n * max(k_out, 1)
    eye = torch.eye(n, dtype=torch.bool, device=candidate_mask.device)
    cand = candidate_mask & ~eye

    def sweep(accepted, rejected):
        avail = cand & ~accepted & ~rejected
        need = k_in - accepted.sum(dim=-1, keepdim=True)
        proposals = masked_topk(recv_scores, avail, k_in, quota=need)
        pool = accepted | proposals                 # [recv, send]
        new_accepted = masked_topk(send_scores, pool.transpose(-1, -2),
                                   k_out).transpose(-1, -2)
        return new_accepted, rejected | (pool & ~new_accepted)

    accepted = torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
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
