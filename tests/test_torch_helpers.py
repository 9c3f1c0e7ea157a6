"""The reference's last four exported helpers in the port, each held to
the reference on its own tests' shapes:

* ``core.mix_round`` (``tests/test_morph_ingraph.py``): uniform mixing
  over a Morph state's current edges, within 1e-6 (the two sum the 12
  neighbours in another order), and it moves toward consensus;
* ``core.update_wanted_senders`` (``tests/test_selection.py``,
  ``tests/test_topology_properties.py``): Alg. 3's view mask from the
  reference's two Gumbel draws (split from its key as it splits them),
  identical views;
* ``sparse.renormalize_drops`` (``tests/test_sparse_adjacency.py``):
  identical masks and slot indices, weights within 1e-7, every row still
  summing to 1;
* ``models.cnn.cnn_accuracy``: the same accuracy as the reference's on
  the same parameters and images, whose logits have the same argmax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.sparse as jsparse                               # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.sparse as tsparse                         # noqa: E402
from repro.models.cnn import cnn_accuracy as jax_accuracy    # noqa: E402
from repro.models.cnn import cnn_forward as jax_forward      # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro_torch.models.cnn import cnn_accuracy, cnn_forward  # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# mix_round
# ---------------------------------------------------------------------------

def _morph_setup(n=12, deg=4, seed=0, dim=48):
    """``tests/test_morph_ingraph.py``'s set-up, one negotiation on."""
    rng = np.random.default_rng(seed)
    adj = jnp.asarray(jcore.random_regular_graph(n, deg, rng))
    state = jcore.init_state(jax.random.PRNGKey(seed), adj)
    params = {"w": jnp.asarray(rng.normal(size=(n, dim)), jnp.float32),
              "b": jnp.asarray(rng.normal(size=(n, 8)), jnp.float32)}
    state, _ = jcore.update_topology(state, params, k=3, view_size=5,
                                     beta=100.0)
    return state, params


@pytest.mark.parametrize("seed", range(3))
def test_mix_round_matches_the_reference(seed):
    state, params = _morph_setup(seed=seed)
    want = jcore.mix_round(state, params)
    port_state = tcore.init_state(_t(state.edges))
    got = tcore.mix_round(port_state, {k: _t(v) for k, v in params.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-6,
                                   rtol=0, err_msg=k)
    spread = lambda t: float((t["w"].max(0).values - t["w"].min(0).values)
                             .max())
    assert spread(got) <= spread({k: _t(v) for k, v in params.items()}) \
        + 1e-6


# ---------------------------------------------------------------------------
# update_wanted_senders
# ---------------------------------------------------------------------------

def _reference_view(key, sim, local, full, k, view_size, beta):
    """The reference's view, and the two Gumbel draws it makes (its key
    split into the diversity and the random-injection keys)."""
    view = jcore.update_wanted_senders(key, sim, local, full, k, view_size,
                                       beta)
    kb, kr = jax.random.split(key)
    n = sim.shape[0]
    noise = (jax.random.gumbel(kb, (n,), jnp.float32),
             jax.random.gumbel(kr, (n,), jnp.float32))
    return np.asarray(view), [_t(x) for x in noise]


def _port_view(sim, local, full, k, view_size, beta, noise):
    return tcore.update_wanted_senders(
        _t(sim), _t(local), _t(full), k, view_size, beta,
        select_noise=noise[0], inject_noise=noise[1]).numpy()


# (seed, n, k, extra): test_selection.py's view property at fixed draws.
SELECTION_CASES = [(0, 2, 1, 0), (1, 5, 2, 3), (2, 12, 5, 4), (3, 9, 3, 0),
                   (4, 7, 1, 4), (5, 12, 2, 2), (6, 3, 5, 1), (7, 10, 4, 4)]


@pytest.mark.parametrize("seed,n,k,extra", SELECTION_CASES)
def test_wanted_senders_view_matches_the_reference(seed, n, k, extra):
    k = min(k, n - 1)
    view_size = k + extra
    rng = np.random.default_rng(seed)
    sim = rng.uniform(-1, 1, n).astype(np.float32)
    ca = rng.random(n) < 0.5
    c = ca | (rng.random(n) < 0.5)
    want, noise = _reference_view(jax.random.PRNGKey(seed), jnp.asarray(sim),
                                  jnp.asarray(ca), jnp.asarray(c), k,
                                  view_size, 3.0)
    got = _port_view(sim, ca, c, k, view_size, 3.0, noise)
    np.testing.assert_array_equal(got, want)
    assert got.sum() <= view_size and not (got & ~c).any()


# (seed, n, k, view_size): test_topology_properties.py's sweeps.
INJECTION_CASES = [(s, 8 + s, 2, 4) for s in range(4)] + [
    (10, 6, 3, 5), (11, 16, 4, 8), (12, 5, 1, 4)]


@pytest.mark.parametrize("seed,n,k,view_size", INJECTION_CASES)
def test_random_injection_view_matches_the_reference(seed, n, k, view_size):
    rng = np.random.default_rng(seed)
    sim = np.asarray(rng.normal(size=(n,)), np.float32)
    full = rng.random(n) < 0.7
    full[0] = False
    local = full & (rng.random(n) < 0.5)
    want, noise = _reference_view(jax.random.PRNGKey(seed), jnp.asarray(sim),
                                  jnp.asarray(local), jnp.asarray(full), k,
                                  view_size, 100.0)
    got = _port_view(sim, local, full, k, view_size, 100.0, noise)
    np.testing.assert_array_equal(got, want)
    expect = min(k, int(local.sum())) + min(max(view_size - k, 0),
                                            int((full & ~local).sum()))
    assert got.sum() == expect


def test_wanted_senders_batched_rows_are_each_rows_view():
    """Leading dimensions are batch dimensions: the views of a ``[m, n]``
    stack are each row's own view."""
    rng = np.random.default_rng(9)
    m, n, k, view = 5, 10, 2, 5
    sim = torch.as_tensor(rng.uniform(-1, 1, (m, n)), dtype=torch.float32)
    local = torch.as_tensor(rng.random((m, n)) < 0.5)
    full = local | torch.as_tensor(rng.random((m, n)) < 0.5)
    sel = torch.as_tensor(rng.gumbel(size=(m, n)), dtype=torch.float32)
    inj = torch.as_tensor(rng.gumbel(size=(m, n)), dtype=torch.float32)
    got = tcore.update_wanted_senders(sim, local, full, k, view, 3.0,
                                      select_noise=sel, inject_noise=inj)
    for i in range(m):
        assert torch.equal(got[i], tcore.update_wanted_senders(
            sim[i], local[i], full[i], k, view, 3.0, select_noise=sel[i],
            inject_noise=inj[i]))


# ---------------------------------------------------------------------------
# renormalize_drops
# ---------------------------------------------------------------------------

def _random_topology(rng, n, max_deg):
    """``tests/test_sparse_adjacency.py``'s random dense topology."""
    edges = np.zeros((n, n), bool)
    for i in range(n):
        deg = int(rng.integers(0, max_deg + 1))
        others = [j for j in range(n) if j != i]
        picks = rng.choice(others, size=min(deg, len(others)),
                           replace=False)
        edges[i, picks] = True
    raw = rng.random((n, n)) * edges
    raw[np.arange(n), np.arange(n)] = rng.random(n) + 0.1
    return edges, (raw / raw.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed,n,k", [(0, 2, 1), (1, 5, 2), (2, 10, 4),
                                      (3, 7, 3), (4, 10, 1), (5, 9, 4)])
def test_renormalize_drops_matches_the_reference(seed, n, k):
    rng = np.random.default_rng(seed)
    k = min(k, n - 1)
    edges, w = _random_topology(rng, n, k)
    drop = rng.random((n, k)) < 0.5
    want = jsparse.renormalize_drops(
        jsparse.dense_to_csr(jnp.asarray(edges), jnp.asarray(w), k),
        jnp.asarray(drop))
    got = tsparse.renormalize_drops(
        tsparse.dense_to_csr(_t(edges), _t(w), k), _t(drop))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    for name in ("w", "w_self"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-7, rtol=0, err_msg=name)
    tsparse.validate(got)
    rows = got.w.double().sum(dim=1) + got.w_self.double()
    np.testing.assert_allclose(rows.numpy(), 1.0, atol=1e-5)
    assert not (got.mask.numpy() & drop).any()


# ---------------------------------------------------------------------------
# cnn_accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_cnn_accuracy_matches_the_reference(seed):
    """The reduced GN-LeNet of the sweep tests on 64 images: the same
    argmax of the logits and the same accuracy."""
    key = jax.random.PRNGKey(seed)
    params = jax_cnn_params(key, in_channels=3, num_classes=4, image_size=8,
                            width=4)
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 64).astype(np.int32)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    want = float(jax_accuracy(params, jnp.asarray(images),
                              jnp.asarray(labels)))
    got = cnn_accuracy(port, _t(images), _t(labels).long())
    np.testing.assert_array_equal(
        cnn_forward(port, _t(images)).argmax(-1).numpy(),
        np.asarray(jax_forward(params, jnp.asarray(images)).argmax(-1)))
    assert got.dtype == torch.float32 and float(got) == want
