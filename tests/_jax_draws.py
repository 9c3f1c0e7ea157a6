"""The reference's ``jax.random`` draws, replayed as tensors for the port.

A ``torch.Generator`` cannot give ``jax.random``'s bits, so every port
function that draws also takes its draw as an argument; these helpers make
the exact draws the reference makes at the same seed, for the parity
tests to hand over.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import MorphNoise
from repro_torch.netsim import NetDraws
from repro_torch.sparse import SparseDraws


def _tensor(x):
    return torch.as_tensor(np.array(x))


def morph_draws(seed, n, count):
    """Draws of the reference Morph controller's first ``count``
    negotiations from ``PRNGKey(seed)`` (``core/morph.py``: the state key
    splits into (next, selection, two tie keys); the selection key splits
    per node, and each node's key into its Eq.-5 and random-injection
    Gumbel keys)."""
    return morph_key_draws(jax.random.PRNGKey(seed), n, count)


def morph_key_draws(key, n, count):
    """:func:`morph_draws` from the controller state's key itself (the
    train step's state holds ``split(PRNGKey(0))[1]``)."""
    gumbel = jax.vmap(lambda kk: jax.random.gumbel(kk, (n,), jnp.float32))
    draws = []
    for _ in range(count):
        key, k_sel, k_tie_r, k_tie_s = jax.random.split(key, 4)
        halves = jax.vmap(jax.random.split)(jax.random.split(k_sel, n))
        draws.append(MorphNoise(
            select=_tensor(gumbel(halves[:, 0])),
            inject=_tensor(gumbel(halves[:, 1])),
            tie_recv=_tensor(jax.random.uniform(
                k_tie_r, (n, n), jnp.float32, 0.0, 1e-4)),
            tie_send=_tensor(jax.random.uniform(
                k_tie_s, (n, n), jnp.float32, 0.0, 1e-4))))
    return draws


@functools.partial(jax.jit, static_argnums=(0, 1))
def _el_scores(seed, n, rnd):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    return jax.random.gumbel(key, (n, n), jnp.float32)


def el_draw(seed, n, rnd):
    """The reference EL-Oracle's Gumbel scores for round ``rnd``."""
    return _tensor(_el_scores(seed, n, rnd))


def stream_take(seed, rnd, sizes, batch):
    """``[n, b]`` shard slots the reference ``DeviceDataStream`` draws in
    round ``rnd`` (``fold_in(fold_in(PRNGKey(seed), rnd), node)``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    rows = [jax.random.randint(jax.random.fold_in(key, i), (batch,), 0,
                               int(size))
            for i, size in enumerate(sizes)]
    return _tensor(jnp.stack(rows))


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4))
def _sparse_draws(seed, rnd, n, k, c):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    gossip = random = None
    if c < n:
        n_gossip = (c - k) // 2
        gossip = jax.random.randint(jax.random.fold_in(key, 3),
                                    (n, n_gossip), 0, k * k)
        random = jax.random.randint(jax.random.fold_in(key, 4),
                                    (n, c - k - n_gossip), 0, n,
                                    dtype=jnp.int32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(key, 5), jnp.arange(n, dtype=jnp.uint32))
    select = jax.vmap(lambda kk: jax.random.gumbel(kk, (c,), jnp.float32))(
        keys)
    return gossip, random, select


def sparse_draws(seed, rnd, n, k, c):
    """The reference sparse strategies' draws for round ``rnd``
    (``sparse/discovery.py``: gossip picks, random peers and the per-node
    selection Gumbel noise, keyed ``fold_in(round_key(seed, rnd), 3 / 4 /
    5)``, the last folded again with the node index)."""
    gossip, random, select = _sparse_draws(seed, rnd, n, k, c)
    return SparseDraws(None if gossip is None else _tensor(gossip),
                       None if random is None else _tensor(random),
                       _tensor(select))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _net_uniform(seed, rnd, n, stream):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                rnd), stream)
    return jax.random.uniform(key, (n, n), jnp.float32)


def net_draws(seed, rnd, n, stream):
    """The reference network model's ``[n, n]`` uniforms for round ``rnd``
    on ``stream`` (``netsim/sampling.py``: ``fold_in(fold_in(PRNGKey(seed),
    rnd), stream)``)."""
    return _tensor(_net_uniform(seed, rnd, n, stream))


def net_round_draws(profile, rnd, n):
    """One round's :class:`NetDraws` as the reference draws them: jitter
    on stream 0 and model loss on stream 1, where the profile has them."""
    return NetDraws(
        net_draws(profile.seed, rnd, n, 0) if profile.jitter_s > 0 else None,
        net_draws(profile.seed, rnd, n, 1) if profile.drop_rate > 0
        else None)
