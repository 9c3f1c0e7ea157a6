"""The port's sparse engine against the reference's, and its compat modes
and dispatch.

Reference side: ``repro.dlrt.DecentralizedRunner`` through the compiled
sparse engine with the Pallas kernels in interpret mode.  Port side:
``repro_torch.dlrt.DecentralizedRunner(engine="sparse")`` on the CPU with
the same initial parameters (``params_from_jax``), the same host batches
(``StackedBatcher`` is bit-for-bit numpy on both sides) and the
reference's ``jax.random`` draws replayed into the strategies.

Tolerances: edges, comm bytes and isolated counts identical every round;
parameters within 1e-4 after 11 rounds (the two sides sum in other
orders); record accuracy and loss within 1e-5.  Compat "exact" is bitwise
the port's dense engine; compat "gather" has the same edges and
parameters within 1e-5 (a gather sums in another order than the dense
contraction).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402

import repro.sparse as jsp                                   # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.dlrt.superstep as superstep               # noqa: E402
import repro_torch.sparse as tsp                             # noqa: E402
from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification, train_test_split)
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.dlrt import (DecentralizedRunner as JaxRunner,    # noqa: E402
                        RunnerConfig as JaxConfig)
from repro.models.cnn import cnn_loss as jax_cnn_loss        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.data import StackedBatcher                  # noqa: E402
from repro_torch.dlrt import DecentralizedRunner, RunnerConfig  # noqa: E402
from repro_torch.models import (cnn_loss, mlp_loss,          # noqa: E402
                                mlp_params)
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import sparse_draws                          # noqa: E402

ROUNDS, EVAL_EVERY, K = 11, 5, 2      # negotiations at 0, 5, 10

MODELS = {
    "mlp": (jax_mlp_params, jax_mlp_loss, mlp_loss),
    "cnn": (lambda key: jax_cnn_params(key, in_channels=3, num_classes=4,
                                       image_size=8, width=4),
            jax_cnn_loss, cnn_loss),
}


class ReplayMorph(tsp.SparseMorphStrategy):
    """Port sparse Morph fed the reference's draws."""

    def draw(self, rnd):
        return sparse_draws(self.seed, rnd, self.n, self.k, self.c)


class ReplayEpidemic(tsp.SparseEpidemicStrategy):
    """Port sparse Epidemic fed the reference's draws."""

    def draw(self, rnd):
        return sparse_draws(self.seed, rnd, self.n, self.k, self.c)


SPARSE = {
    "sparse-morph": (jsp.SparseMorphStrategy, ReplayMorph),
    "sparse-epidemic": (jsp.SparseEpidemicStrategy, ReplayEpidemic),
}


def _data(n):
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    return tr, {"images": te.images, "labels": te.labels}, parts


def _reference_and_port(model, n, make_jax, make_port):
    tr, test, parts = _data(n)
    init_fn, jax_loss, port_loss = MODELS[model]
    ref = JaxRunner(
        init_fn=init_fn, loss_fn=jax_loss, eval_fn=jax_loss,
        optimizer=jax_sgd(0.05), batcher=JaxBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=make_jax(),
        cfg=JaxConfig(n_nodes=n, rounds=ROUNDS, eval_every=EVAL_EVERY,
                      compiled=True, engine="sparse", use_pallas=True,
                      interpret=True))
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    port = DecentralizedRunner(
        init_fn=None, loss_fn=port_loss, eval_fn=port_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=make_port(),
        cfg=RunnerConfig(n_nodes=n, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         engine="sparse"),
        params=params_from_jax(init), device="cpu")
    ref.run()
    port.run()
    return ref, port


def assert_matches_reference(ref, port):
    assert len(port.edge_history) == len(ref.edge_history) == ROUNDS
    for r, (a, b) in enumerate(zip(ref.edge_history, port.edge_history)):
        assert np.array_equal(np.asarray(a), b), f"edges diverged at {r}"
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params))
    assert list(port.params) == list(want)
    for key in want:
        np.testing.assert_allclose(port.params[key].numpy(),
                                   want[key].numpy(), atol=1e-4,
                                   err_msg=key)
    assert len(port.log.records) == len(ref.log.records)
    for a, b in zip(ref.log.records, port.log.records):
        assert (a.rnd, a.comm_bytes, a.isolated) == \
            (b.rnd, b.comm_bytes, b.isolated)
        assert b.mean_accuracy == pytest.approx(a.mean_accuracy, abs=1e-5)
        assert b.mean_loss == pytest.approx(a.mean_loss, abs=1e-5)


@pytest.mark.parametrize("n", [6, 16], ids=["n6-full", "n16-gossip"])
@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sparse_engine_matches_reference_mlp(name, n):
    """n = 6: every peer is a candidate (c = min(n, 4k + 2) = n); n = 16:
    c = 10 < n, so gossip and random candidates are live."""
    make_jax, make_port = SPARSE[name]
    ref, port = _reference_and_port(
        "mlp", n, lambda: make_jax(n=n, k=K, seed=0),
        lambda: make_port(n=n, k=K, seed=0, device="cpu"))
    assert_matches_reference(ref, port)
    indeg = np.stack(port.edge_history).sum(axis=2)
    assert (indeg == K).all()


@pytest.mark.parametrize("n", [6, 16], ids=["n6-full", "n16-gossip"])
def test_second_run_continues_from_the_evolved_senders(n):
    """After a ``run()`` sparse Morph holds the senders the engine evolved
    (the last round's, not the bootstrap ring), and a second ``run()``
    starts from them as the reference's does (rounds and draws from round
    0 again)."""
    ref, port = _reference_and_port(
        "mlp", n, lambda: jsp.SparseMorphStrategy(n=n, k=K, seed=0),
        lambda: ReplayMorph(n=n, k=K, seed=0, device="cpu"))
    ring = tsp.SparseMorphStrategy(n=n, k=K, device="cpu").init_graph_state()
    for second in (False, True):
        if second:
            ref.run()
            port.run()
        assert_matches_reference(ref, port)
        idx = port.strategy.init_graph_state()
        assert np.array_equal(idx.numpy(), np.asarray(ref.strategy.idx))
        assert not torch.equal(idx, ring)
        last = np.zeros((n, n), bool)
        last[np.repeat(np.arange(n), K), idx.reshape(-1).numpy()] = True
        assert np.array_equal(last, port.edge_history[-1])


# --------------------------------------------------------------------------
# Compat mode and dispatch: the port against itself.
# --------------------------------------------------------------------------

N = 6
DENSE = {
    "morph": lambda: tcore.InGraphMorphStrategy(n=N, k=2, view_size=4,
                                                seed=0, device="cpu"),
    "static": lambda: tcore.InGraphStaticStrategy(n=N, degree=3, seed=0,
                                                  device="cpu"),
    "el-oracle": lambda: tcore.InGraphEpidemicStrategy(n=N, k=2, seed=0,
                                                       device="cpu"),
}


def _port(strategy, **cfg):
    tr, test, parts = _data(N)
    return DecentralizedRunner(
        init_fn=lambda g: mlp_params(g), loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=strategy,
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         **cfg),
        device="cpu")


@pytest.mark.parametrize("name", sorted(DENSE))
def test_compat_exact_is_bitwise_the_dense_engine(name):
    dense = _port(DENSE[name]())
    dense.run()
    sparse = _port(DENSE[name](), engine="sparse")
    sparse.run()
    for a, b in zip(dense.edge_history, sparse.edge_history):
        assert np.array_equal(a, b)
    for key in dense.params:
        assert torch.equal(dense.params[key], sparse.params[key])
    for a, b in zip(dense.log.records, sparse.log.records):
        assert (a.rnd, a.comm_bytes, a.isolated, a.mean_accuracy,
                a.mean_loss) == (b.rnd, b.comm_bytes, b.isolated,
                                 b.mean_accuracy, b.mean_loss)


@pytest.mark.parametrize("name", sorted(DENSE))
def test_compat_gather_is_close_to_the_dense_engine(name, monkeypatch):
    """Each round's edges through ``dense_to_csr(edges, w, n - 1)`` and the
    CSR mix: the same edges, parameters within 1e-5; no dense mix runs."""
    dense = _port(DENSE[name]())
    dense.run()
    for fn in ("mix_pytree", "mix_masked_pytree"):
        monkeypatch.setattr(superstep.ops, fn, None)
    gather = _port(DENSE[name](), engine="sparse", sparse_mix="gather")
    gather.run()
    assert len(gather.edge_history) == ROUNDS
    for a, b in zip(dense.edge_history, gather.edge_history):
        assert np.array_equal(a, b)
    for key in dense.params:
        np.testing.assert_allclose(gather.params[key].numpy(),
                                   dense.params[key].numpy(), atol=1e-5)
    assert [r.comm_bytes for r in dense.log.records] == \
        [r.comm_bytes for r in gather.log.records]


def test_auto_engine_follows_the_strategy():
    sparse = tsp.SparseMorphStrategy(n=N, k=2, device="cpu")
    assert _port(sparse, engine="auto").engine == "sparse"
    assert _port(DENSE["morph"](), engine="auto").engine == "dense"
    runner = _port(tsp.SparseEpidemicStrategy(n=N, k=2, device="cpu"),
                   engine="auto")
    runner.run()
    assert len(runner.edge_history) == ROUNDS


@pytest.mark.parametrize("cfg,strategy,error", [
    (dict(engine="dense"), "sparse", TypeError),
    (dict(), "sparse", TypeError),
    (dict(engine="csr"), "dense", ValueError),
    (dict(engine="sparse", sparse_mix="fast"), "dense", ValueError),
])
def test_engine_validation(cfg, strategy, error):
    make = {"sparse": lambda: tsp.SparseMorphStrategy(n=N, k=2,
                                                      device="cpu"),
            "dense": DENSE["static"]}[strategy]
    with pytest.raises(error):
        _port(make(), **cfg)


def test_compact_edge_history_past_the_decode_limit(monkeypatch):
    """Past ``SPARSE_EDGE_DECODE_MAX`` nodes the history keeps ``(idx,
    mask)`` pairs; they name the same edges as the dense decoding."""
    full = _port(tsp.SparseMorphStrategy(n=N, k=2, device="cpu"),
                 engine="sparse")
    full.run()
    monkeypatch.setattr(superstep, "SPARSE_EDGE_DECODE_MAX", N - 1)
    compact = _port(tsp.SparseMorphStrategy(n=N, k=2, device="cpu"),
                    engine="sparse")
    compact.run()
    assert len(compact.edge_history) == ROUNDS
    for dense, (idx, mask) in zip(full.edge_history, compact.edge_history):
        assert idx.shape == mask.shape == (N, 2)
        got = np.zeros((N, N), bool)
        rows = np.repeat(np.arange(N), 2).reshape(N, 2)
        got[rows[mask], idx[mask]] = True
        assert np.array_equal(got, dense)
    assert [(r.comm_bytes, r.isolated) for r in full.log.records] == \
        [(r.comm_bytes, r.isolated) for r in compact.log.records]
