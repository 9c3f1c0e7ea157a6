"""Plain PyTorch versions of the kernels: what the wrappers run for CPU
tensors, and the oracles the kernels are held against on the card."""
from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """``X [n, D] -> X X^T [n, n]`` in f32."""
    xf = x.float()
    return xf @ xf.T


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between all rows of ``X [n, D]``; a zero row
    gives 0, not NaN (norms clamp at 1e-12)."""
    g = gram_matrix(x)
    norms = torch.sqrt(torch.diagonal(g)).clamp_min(_EPS)
    return g / (norms[:, None] * norms[None, :])


def graph_mix(w: torch.Tensor, x: torch.Tensor,
              chunk_d: Optional[int] = None) -> torch.Tensor:
    """``W [m, n] @ X [n, D] -> [m, D]`` in f32, cast to ``x.dtype``.

    Each output column is summed over the nodes in node order, each
    product rounded before its add.  A library product chooses its order
    by the shape it is given, so its columns change bits when it is given
    fewer of them; this order does not depend on the other columns, and
    ``chunk_d`` columns at a time (bounding the f32 buffers at ``O(m
    chunk_d)``, the reference's ``mix_chunk_d``) give the bits of the
    whole leaf."""
    w32 = w.float()
    d = x.shape[1]
    step = d if chunk_d is None else chunk_d
    pieces = []
    for s in range(0, max(d, 1), step):
        xs = x[:, s:s + step].float()
        acc = w32[:, :1] * xs[0]
        for j in range(1, xs.shape[0]):
            acc += w32[:, j:j + 1] * xs[j]
        pieces.append(acc)
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    return out.to(x.dtype)


def graph_mix_masked(edges: torch.Tensor, x: torch.Tensor,
                     chunk_d: Optional[int] = None) -> torch.Tensor:
    """Uniform averaging from the in-edge matrix: ``W = (E + I) / rowsum``
    then ``W @ X`` (:func:`graph_mix`)."""
    n = edges.shape[0]
    w = edges.float() + torch.eye(n, dtype=torch.float32,
                                  device=edges.device)
    w = w / w.sum(dim=1, keepdim=True)
    return graph_mix(w, x, chunk_d)


def graph_mix_sparse(idx: torch.Tensor, w: torch.Tensor,
                     w_self: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """CSR mix ``out[i] = sum_s w[i, s] x[idx[i, s]] + w_self[i] x[i]`` in
    f32, cast to ``x.dtype``: the slots in slot order and then the self
    term, each product rounded before its add, as the kernel sums."""
    xf = x.float()
    idx = idx.long()
    acc = torch.zeros_like(xf)
    for s in range(idx.shape[1]):
        acc = acc + w[:, s:s + 1].float() * xf[idx[:, s]]
    acc = acc + w_self.float()[:, None] * xf
    return acc.to(x.dtype)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """The direct S6 recurrence (``repro.kernels.ref.selective_scan_ref``),
    in f32: per step ``h = exp(dt a) h + (dt x) b`` and ``y_t = sum_s h c``.

    ``x, dt [batch, L, di]``; ``b, c [batch, L, ds]``; ``a [di, ds]``;
    ``h0 [batch, di, ds]`` -> ``(y [batch, L, di], h [batch, di, ds])``,
    both f32.  Each product is rounded before its add and ``y`` is summed
    in the CUDA kernel's order (:func:`sum_states`), so the two differ only
    where their ``exp`` does.  No ``D x`` skip term (the caller adds it)."""
    f32 = torch.float32
    x, dt, b, c, a, h = (t.to(f32) for t in (x, dt, b, c, a, h0))
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a)                 # [bt, di, ds]
        h = da * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        ys.append(sum_states(h * c[:, t, None, :]))
    return torch.stack(ys, dim=1), h


def sum_states(hc: torch.Tensor) -> torch.Tensor:
    """``y = sum_s hc[..., s]`` in the scan kernel's order: each group of 4
    consecutive states in state order (``p_q``), then the groups pairwise,
    ``(p0 + p1) + (p2 + p3)`` at 16 states, ``p0 + p1`` at 8 and ``p0`` at
    4 (a last odd group carries up unpaired)."""
    parts = []
    for g in range(0, hc.shape[-1], 4):
        p = hc[..., g]
        for s in range(g + 1, min(g + 4, hc.shape[-1])):
            p = p + hc[..., s]
        parts.append(p)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]
