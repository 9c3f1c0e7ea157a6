"""The port's Morph controller, matching and EL draw against the
reference, with the reference's ``jax.random`` draws replayed.

Everything here is exact: the same similarity matrix and the same draws
go through the same f32 arithmetic, so edges, W and the controller state
must come out identical, not merely close.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.core.matching import _masked_topk                 # noqa: E402
from repro.core.morph import init_state as jax_init_state    # noqa: E402
from repro.core.morph import update_topology as jax_update   # noqa: E402
import repro_torch.core as tcore                             # noqa: E402

from _jax_draws import el_draw, morph_draws                  # noqa: E402


def _sims(n, count, seed):
    """A drifting sequence of clustered cosine-similarity matrices."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 16))
    x = centers[np.arange(n) % 4] + 0.5 * rng.normal(size=(n, 16))
    out = []
    for _ in range(count):
        x = x + 0.3 * rng.normal(size=x.shape)
        u = x / np.linalg.norm(x, axis=1, keepdims=True)
        out.append((u @ u.T).astype(np.float32))
    return out


@pytest.mark.parametrize("n,k,view", [(6, 2, 4), (50, 3, 5)])
def test_update_topology_identical_under_shared_draws(n, k, view):
    count = 20
    ring = np.roll(np.eye(n, dtype=bool), 1, 1) \
        | np.roll(np.eye(n, dtype=bool), -1, 1)
    jstate = jax_init_state(jax.random.PRNGKey(0), jnp.asarray(ring))
    tstate = tcore.init_state(torch.as_tensor(ring))
    step = jax.jit(lambda st, s: jax_update(
        st, None, k=k, view_size=view, beta=500.0, sim_fn=lambda _: s))
    for t, (sim, noise) in enumerate(zip(_sims(n, count, n),
                                         morph_draws(0, n, count))):
        jstate, jw = step(jstate, jnp.asarray(sim))
        tstate = tcore.update_topology(tstate, torch.as_tensor(sim), k=k,
                                       view_size=view, beta=500.0,
                                       noise=noise)
        for field in ("known", "sim_valid", "edges"):
            assert np.array_equal(np.asarray(getattr(jstate, field)),
                                  getattr(tstate, field).numpy()), \
                f"{field} diverged at negotiation {t}"
        np.testing.assert_array_equal(
            np.asarray(jw), tcore.uniform_weights_torch(tstate.edges).numpy())
        # Eq.-4 estimates: einsum contraction order may differ (f32).
        np.testing.assert_allclose(np.asarray(jstate.sim),
                                   tstate.sim.numpy(), atol=1e-6)
        assert (tstate.edges.sum(1) <= k).all()


@pytest.mark.parametrize("seed,k_out,rounds", [
    (0, 3, None), (1, 3, None), (4, 3, None), (7, 3, None), (11, 3, None),
    (1, 3, 12),          # truncated sweeps (the under-filled case)
    (4, 4, None),        # one unit of capacity slack
])
def test_match_tight_market_identical(seed, k_out, rounds):
    """``tests/test_matching.py``'s tight-market cases: n = 12, k = 3,
    complete candidate lists."""
    n, k = 12, 3
    rng = np.random.default_rng(seed)
    recv = rng.random((n, n)).astype(np.float32)
    send = rng.random((n, n)).astype(np.float32)
    cand = ~np.eye(n, dtype=bool)
    want = np.asarray(jcore.match_jax(jnp.asarray(recv), jnp.asarray(send),
                                      jnp.asarray(cand), k, k_out, rounds))
    got = tcore.match_dense(torch.as_tensor(recv), torch.as_tensor(send),
                            torch.as_tensor(cand), k, k_out, rounds).numpy()
    np.testing.assert_array_equal(got, want)


def test_stable_topk_breaks_ties_to_lower_index():
    x = torch.tensor([1.0, 3.0, 3.0, 3.0, 0.0])
    _, idx = tcore.stable_topk(x, 2)
    assert idx.tolist() == [1, 2]
    _, jidx = jax.lax.top_k(jnp.asarray([1.0, 3.0, 3.0, 3.0, 0.0]), 2)
    assert np.asarray(jidx).tolist() == idx.tolist()


def test_masked_topk_ties_identical():
    """Masked (``NEG_INF``) entries and repeated scores tie on every row;
    both sides must pick the same slots."""
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 3, (9, 9)).astype(np.float32)
    mask = rng.random((9, 9)) < 0.6
    quota = rng.integers(0, 4, (9, 1))
    want = np.asarray(_masked_topk(jnp.asarray(scores), jnp.asarray(mask), 4,
                                   quota=jnp.asarray(quota)))
    got = tcore.masked_topk(torch.as_tensor(scores), torch.as_tensor(mask), 4,
                            quota=torch.as_tensor(quota)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(6, 2), (50, 3)])
def test_epidemic_round_identical(n, k):
    ref = jcore.InGraphEpidemicStrategy(n=n, k=k, seed=5)
    port = tcore.InGraphEpidemicStrategy(n=n, k=k, seed=5, device="cpu")
    for rnd in range(4):
        _, je, jw = ref.graph_round(ref.init_graph_state(),
                                    jnp.asarray(rnd), None)
        _, te, tw = port.graph_round((), rnd, None,
                                     noise=el_draw(5, n, rnd))
        assert tw is None                   # uniform: mixed from the edges
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(
            tcore.uniform_weights_torch(te).numpy(), np.asarray(jw))


def test_own_draws_follow_the_contract():
    """Without injected draws the port draws from its own generators: a
    Morph negotiation keeps in-degree <= k, and an EL round is a pure
    function of (seed, rnd)."""
    n = 10
    morph = tcore.InGraphMorphStrategy(n=n, k=3, seed=1, device="cpu")
    sim = torch.as_tensor(_sims(n, 1, 0)[0])
    state, edges, w = morph.graph_round(morph.init_graph_state(), 0, sim)
    assert (edges.sum(1) <= 3).all() and not edges.diagonal().any()
    assert w is None and torch.equal(state.edges, edges)
    el = tcore.InGraphEpidemicStrategy(n=n, k=3, seed=2, device="cpu")
    a = el.graph_round((), 7, None)[1]
    el.graph_round((), 8, None)
    assert torch.equal(a, el.graph_round((), 7, None)[1])
    assert (a.sum(0) == 3).all()
