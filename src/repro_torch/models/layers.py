"""Shared building blocks of the model zoo (pure functions over nested-dict
parameters), the port of ``repro.models.layers``.

Parameters keep the reference's names and layouts (``dense`` weights
``[d_in, d_out]``, so ``x @ w``), so weights carried over with
:func:`repro_torch.tree.params_from_jax` are a copy.  Initialisers draw
from an explicit ``torch.Generator`` on the target device, with the
reference's distributions (truncated normal at fan-in scale, embeddings at
0.02); they cannot give ``jax.random``'s bits.  Compute follows ``x``'s
dtype, so full configs run bf16 and the CPU tests f32.
"""
from __future__ import annotations

import math

import torch

from ..tree import flatten, tree_map


class MetaGenerator(torch.Generator):
    """The generator of an initialiser on the meta device: its ``device``
    is meta, so :func:`drawn` gives meta tensors (a shape and a dtype, no
    values, no memory) and nothing is drawn."""

    @property
    def device(self):
        return torch.device("meta")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (a
    :class:`MetaGenerator` on the meta device)."""
    if device.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def drawn(gen: torch.Generator, shape, dtype, draw):
    """``draw()``, a tensor of ``shape`` drawn with ``gen`` on its device,
    cast to ``dtype`` there (no copy where it is ``dtype`` already).  On
    the meta device ``draw`` is not called: an empty meta tensor of
    ``shape`` and ``dtype``.  Every initialiser draws through here, so
    this is the one place that decides whether to draw (the card's torch
    runs meta kernels such as ``trunc_normal_`` as slow Python refs)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return draw().to(dtype)


def stacked(make, periods: int):
    """``make()``'s tree for each of ``periods`` periods, stacked on a new
    leading period axis as each is made, so no more than the stack and one
    period's tree are alive at once (a view of the one tree when there is
    one period).  On the meta device one period is made, for its shapes."""
    first = make()
    if periods == 1:
        return tree_map(lambda leaf: leaf.unsqueeze(0), first)
    out = tree_map(lambda leaf: leaf.new_empty((periods,) + leaf.shape),
                   first)
    dst = flatten(out)
    if next(iter(dst.values())).is_meta:
        return out
    for i in range(periods):
        tree, first = (first if i == 0 else make()), None
        for path, leaf in flatten(tree).items():
            dst[path][i].copy_(leaf)
        del tree
    return out


def normal(gen: torch.Generator, shape, std: float, dtype):
    """Normal at ``std``, drawn in f32 on the generator's device and cast
    there."""
    return drawn(gen, shape, dtype, lambda: torch.randn(
        shape, generator=gen, dtype=torch.float32,
        device=gen.device).mul_(std))


def _trunc_normal(gen: torch.Generator, shape, std: float, dtype):
    """Standard normal truncated to [-2, 2], times ``std``: drawn in f32 on
    the generator's device and cast to ``dtype`` there."""
    def draw():
        w = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(std)
    return drawn(gen, shape, dtype, draw)


def _dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    """Truncated normal at ``scale / sqrt(fan_in)``."""
    return _trunc_normal(gen, shape, scale / math.sqrt(shape[0]), dtype)


def dense_params(gen, d_in: int, d_out: int, dtype, bias: bool = False,
                 scale: float = 1.0):
    p = {"w": _dense_init(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x, dtype=None):
    """``x @ w`` with ``w`` cast to ``x``'s dtype (or ``dtype``)."""
    y = x @ p["w"].to(dtype or x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def norm_params(d: int, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm or LayerNorm computed in f32, cast back to ``x.dtype``."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: SwiGLU / GELU / squared-ReLU.
# ---------------------------------------------------------------------------

def mlp_params(gen, d_model: int, d_ff: int, mlp_type: str, dtype):
    if mlp_type == "swiglu":
        return {"gate": dense_params(gen, d_model, d_ff, dtype),
                "up": dense_params(gen, d_model, d_ff, dtype),
                "down": dense_params(gen, d_ff, d_model, dtype)}
    return {"up": dense_params(gen, d_model, d_ff, dtype),
            "down": dense_params(gen, d_ff, d_model, dtype)}


def apply_mlp(p, x, mlp_type: str):
    if mlp_type == "swiglu":
        h = torch.nn.functional.silu(dense(p["gate"], x)) * dense(p["up"], x)
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = torch.nn.functional.gelu(dense(p["up"], x), approximate="tanh")
    elif mlp_type == "sqrelu":
        h = torch.square(torch.relu(dense(p["up"], x)))
    else:
        raise ValueError(mlp_type)
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# Embeddings.
# ---------------------------------------------------------------------------

def embed_params(gen, vocab: int, d_model: int, dtype):
    return {"table": _trunc_normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(p, tokens):
    return p["table"][tokens]



def unembed(p, x, tied_table=None):
    """Logits in f32: ``x @ table.T`` against a tied embedding table, else
    ``x @ p["w"]``.  The reference defines it and calls it nowhere (its
    stack's head is ``transformer._lm_logits``); nor does the port."""
    if tied_table is not None:
        return x.float() @ tied_table.float().T
    return x.float() @ p["w"].float()


def sinusoidal_positions(length: int, d_model: int,
                         device) -> torch.Tensor:
    """``[length, d_model]`` f32 sinusoidal positions: sines in the even
    columns, cosines in the odd, at ``pos / 10000 ** (2i / d_model)``.
    The reference defines it and calls it nowhere (its Whisper learns its
    positions); nor does the port."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            dim / d_model)
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe
