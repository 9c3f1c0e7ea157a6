"""The port's CSR adjacency, candidate discovery and candidate-set
similarity against ``repro.sparse``.

The adjacency conversions, the validators and candidate discovery (with
the reference's ``jax.random`` draws replayed) are integer or exact f32
work: they must agree exactly.  ``candidate_similarity`` sums over D in
another order than XLA, so it agrees within 1e-6, and it must be bitwise
invariant to ``row_chunk`` (rows are independent).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.sparse as jsp                                   # noqa: E402
import repro.sparse.discovery as jdisc                       # noqa: E402
import repro_torch.sparse as tsp                             # noqa: E402
import repro_torch.sparse.discovery as tdisc                 # noqa: E402
from repro_torch.core import uniform_weights_torch           # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import sparse_draws                          # noqa: E402


def _np(adj):
    return [np.asarray(a) for a in adj]


def _assert_same_adj(got, want):
    for name, g, w in zip(tsp.SparseAdjacency._fields, _np(got), _np(want)):
        assert g.dtype.kind == w.dtype.kind, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _random_edges(rng, n, p):
    return (rng.random((n, n)) < p) & ~np.eye(n, dtype=bool)


@pytest.mark.parametrize("n,k", [(1, 1), (6, 2), (9, 4), (17, 16)])
def test_uniform_csr_weights_matches_reference(n, k):
    rng = np.random.default_rng(n * 10 + k)
    idx = rng.integers(0, n, (n, k))
    mask = rng.random((n, k)) < 0.6
    got = tsp.uniform_csr_weights(torch.as_tensor(idx), torch.as_tensor(mask))
    want = jsp.uniform_csr_weights(jnp.asarray(idx), jnp.asarray(mask))
    _assert_same_adj(got, want)


def test_uniform_csr_weights_is_the_dense_uniform_division():
    rng = np.random.default_rng(3)
    edges = torch.as_tensor(_random_edges(rng, 12, 0.3))
    adj = tsp.dense_to_csr(edges, None, 11)
    _, w = tsp.to_dense(adj)
    assert torch.equal(w, uniform_weights_torch(edges))


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "w"])
@pytest.mark.parametrize("n,k,p", [(6, 5, 0.5), (10, 3, 0.25),
                                   (10, 2, 0.6), (33, 8, 0.1)])
def test_dense_to_csr_and_back_match_reference(n, k, p, weighted):
    """Ascending-sender slot order, overflowing rows dropping their
    highest senders (k = 2 at p = 0.6), and the dense expansion."""
    rng = np.random.default_rng(n + k)
    edges = _random_edges(rng, n, p)
    w = rng.random((n, n)).astype(np.float32) if weighted else None
    got = tsp.dense_to_csr(torch.as_tensor(edges),
                           None if w is None else torch.as_tensor(w), k)
    want = jsp.dense_to_csr(jnp.asarray(edges),
                            None if w is None else jnp.asarray(w), k)
    _assert_same_adj(got, want)
    for g, wt in zip(tsp.to_dense(got), jsp.to_dense(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
    if edges.sum(axis=1).max() <= k:
        assert np.array_equal(tsp.to_dense(got)[0].numpy(), edges)


def _valid_adj(n=7, k=3, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(np.delete(np.arange(n), i))[:k]
                    for i in range(n)])
    mask = rng.random((n, k)) < 0.7
    return jsp.uniform_csr_weights(jnp.asarray(idx), jnp.asarray(mask))


def _corrupt(kind, adj):
    idx, w, w_self, mask = (np.array(a) for a in adj)
    if kind == "range":
        idx[0, 0] = len(idx)
    elif kind == "parked":
        mask[1, 0], idx[1, 0] = False, (1 + 1) % len(idx)
    elif kind == "weight":
        mask[2, 1], idx[2, 1], w[2, 1] = False, 2, 0.5
    elif kind == "self":
        mask[3, 0], idx[3, 0] = True, 3
    elif kind == "twice":
        mask[4, :2], idx[4, 1] = True, idx[4, 0]
    elif kind == "mass":
        w_self[5] += 0.1
    return idx, w, w_self, mask


@pytest.mark.parametrize("kind", ["none", "range", "parked", "weight", "self",
                                  "twice", "mass"])
def test_validate_matches_reference(kind):
    parts = _corrupt(kind, _valid_adj())
    want = got = None
    try:
        jsp.validate(jsp.SparseAdjacency(*parts))
    except ValueError as e:
        want = str(e)
    try:
        tsp.validate(tsp.SparseAdjacency(*(torch.as_tensor(a)
                                            for a in parts)))
    except ValueError as e:
        got = str(e)
    assert got == want
    assert (want is None) == (kind == "none")


@pytest.mark.parametrize("k", [2, 4])
def test_validate_against_dense_matches_reference(k):
    n = 8
    edges = np.zeros((n, n), bool)
    edges[np.arange(n), (np.arange(n) + 3) % n] = True
    edges[0, 1:4] = True                       # in-degree 3 overflows k = 2
    jadj = jsp.dense_to_csr(jnp.asarray(edges), None, k)
    tadj = tsp.dense_to_csr(torch.as_tensor(edges), None, k)
    outcomes = []
    for fn, adj in ((jsp.validate_against_dense, jadj),
                    (tsp.validate_against_dense, tadj)):
        try:
            fn(adj, edges)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (k == 4)


def test_full_candidates_match_reference():
    for got, want in zip(tdisc.full_candidates(7), jdisc.full_candidates(7)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,c", [(16, 2, 10), (30, 3, 14), (12, 4, 5)])
def test_gossip_candidates_and_selection_match_reference(n, k, c):
    """Candidates and the Gumbel-top-k picks for a few rounds, from the
    ring and from a random sender table, with the reference's draws."""
    rng = np.random.default_rng(n + c)
    tables = [jdisc._ring_bootstrap(n, k),
              np.stack([rng.permutation(np.delete(np.arange(n), i))[:k]
                        for i in range(n)]).astype(np.int32)]
    for rnd, idx in enumerate(tables):
        draws = sparse_draws(7, rnd, n, k, c)
        want_c, want_v = jdisc.gossip_candidates(7, rnd, jnp.asarray(idx), c)
        got_c, got_v = tdisc.gossip_candidates(
            torch.as_tensor(idx).long(), c, draws.gossip, draws.random)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        sim = rng.uniform(-1, 1, (n, c)).astype(np.float32)
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(7), rnd), jdisc.STREAM_CAND_SELECT)
        want = jdisc._select_topk(key, jnp.asarray(sim), want_v, want_c, k,
                                  5.0)
        got = tdisc._select_topk(torch.as_tensor(sim), got_v, got_c, k, 5.0,
                                 draws.select)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(n, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(n, 300)).astype(np.float32),
            "c": np.zeros((n, 4), np.float32)}      # a zero leaf: cos 0
    return tree


@pytest.mark.parametrize("n,c", [(6, 6), (13, 5)])
def test_candidate_similarity_matches_reference(n, c):
    tree = _tree(n, seed=n)
    cand = np.random.default_rng(n).integers(0, n, (n, c))
    got = tsp.candidate_similarity(params_from_jax(tree),
                                   torch.as_tensor(cand))
    want = jsp.candidate_similarity(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(cand))
    assert got.dtype == torch.float32 and got.shape == (n, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("row_chunk", [1, 3, 4, 13])
def test_candidate_similarity_is_bitwise_invariant_to_row_chunk(row_chunk):
    n, c = 13, 5
    port = params_from_jax(_tree(n, seed=1))
    cand = torch.as_tensor(np.random.default_rng(2).integers(0, n, (n, c)))
    whole = tsp.candidate_similarity(port, cand)
    assert torch.equal(tsp.candidate_similarity(port, cand, row_chunk),
                       whole)
