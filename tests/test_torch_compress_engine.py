"""Compressed gossip through the port's engines against the reference's.

Reference side: ``repro.dlrt.DecentralizedRunner`` through the compiled
engine (``use_pallas=False``: the reference runs its codec on the XLA
paths only) with ``compress=<spec>``.  Port side:
``repro_torch.dlrt.DecentralizedRunner`` on the CPU with the same initial
parameters, the same host batches and the reference's draws replayed.

What must match: the edges every round and ``comm_bytes`` exactly (the
analytic wire bytes times the edge count); the parameters, the replicas
``hat`` and the residual ``resid`` within ``TOL``.

Tolerance.  The local steps agree only to f32 rounding, so a payload
coordinate within that distance of a rounding boundary (or of the top-k
cut) takes the neighbouring code on one side: that replica coordinate
moves by one quantization step, the residual by the same amount the other
way, and the next round sends it back.  A step is ``max|payload| / 127``
for int8, where the payload is one round's replica delta plus the
residual.  On the tiny MLP the largest payload is 0.9 (``w2``), a step
7.1e-3, but flips are rare there and every quantity stayed within 7e-4
over 11 rounds (fp8 included); ``TOL["mlp"]`` = 5e-3 is the bar the
reference sets for int8 against its own uncompressed run
(``tests/test_superstep.py``).  The reduced GN-LeNet has wide leaves whose
largest payloads are 0.32-0.38, a step of about 3e-3, and a flipped code
there also changes the next gradients, so its deviations grow to a few
steps: 5.1e-3 in ``hat`` under int8 (7.7e-3 under int8+topk0.75);
``TOL["cnn"]`` = 1e-2 is about three of its steps.  Within the port, the
codec's absence and its identities are exact.
"""
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
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
from repro_torch.compress import CompressConfig, wire_bytes_tree  # noqa: E402
from repro_torch.data import StackedBatcher                  # noqa: E402
from repro_torch.dlrt import DecentralizedRunner, RunnerConfig  # noqa: E402
from repro_torch.models import cnn_loss, mlp_loss            # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import el_draw, morph_draws, sparse_draws    # noqa: E402

N, ROUNDS, EVAL_EVERY, K = 6, 11, 5, 2   # negotiations at 0, 5, 10
TOL = {"mlp": 5e-3, "cnn": 1e-2}

MODELS = {
    "mlp": (jax_mlp_params, jax_mlp_loss, mlp_loss),
    "cnn": (lambda key: jax_cnn_params(key, in_channels=3, num_classes=4,
                                       image_size=8, width=4),
            jax_cnn_loss, cnn_loss),
}


class ReplayMorph(tcore.InGraphMorphStrategy):
    """Port Morph fed the reference's draws, one set per negotiation (two
    runs' worth)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._draws = iter(morph_draws(0, self.n, 2 * ROUNDS))

    def graph_round(self, gstate, rnd, sim, noise=None):
        if rnd % self.delta_r == 0:
            noise = next(self._draws)
        return super().graph_round(gstate, rnd, sim, noise=noise)


class ReplayEpidemic(tcore.InGraphEpidemicStrategy):
    """Port EL-Oracle fed the reference's per-round draw."""

    def graph_round(self, gstate, rnd, sim, noise=None):
        return super().graph_round(gstate, rnd, sim,
                                   noise=el_draw(self.seed, self.n, rnd))


class ReplaySparseMorph(tsp.SparseMorphStrategy):
    """Port sparse Morph fed the reference's draws."""

    def draw(self, rnd):
        return sparse_draws(self.seed, rnd, self.n, self.k, self.c)


STRATEGIES = {
    "morph": (lambda: jcore.InGraphMorphStrategy(n=N, k=K, view_size=4,
                                                 seed=0),
              lambda: ReplayMorph(n=N, k=K, view_size=4, seed=0,
                                  device="cpu")),
    "static": (lambda: jcore.InGraphStaticStrategy(n=N, degree=3, seed=0),
               lambda: tcore.InGraphStaticStrategy(n=N, degree=3, seed=0,
                                                   device="cpu")),
    "el-oracle": (lambda: jcore.InGraphEpidemicStrategy(n=N, k=K, seed=0),
                  lambda: ReplayEpidemic(n=N, k=K, seed=0, device="cpu")),
    "fully-connected": (
        lambda: jcore.InGraphFullyConnectedStrategy(n=N),
        lambda: tcore.InGraphFullyConnectedStrategy(n=N, device="cpu")),
    "sparse-morph": (lambda: jsp.SparseMorphStrategy(n=N, k=K, seed=0),
                     lambda: ReplaySparseMorph(n=N, k=K, seed=0,
                                               device="cpu")),
}


def _data():
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, N, 0.5, np.random.default_rng(0))
    return tr, {"images": te.images, "labels": te.labels}, parts


def _reference_and_port(name, spec, model="mlp", engine="dense",
                        sparse_mix="exact"):
    """The reference runner and the port's on the same set-up, not run."""
    tr, test, parts = _data()
    init_fn, jax_loss, port_loss = MODELS[model]
    make_jax, make_port = STRATEGIES[name]
    ref = JaxRunner(
        init_fn=init_fn, loss_fn=jax_loss, eval_fn=jax_loss,
        optimizer=jax_sgd(0.05), batcher=JaxBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=make_jax(),
        cfg=JaxConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                      compiled=True, engine=engine, sparse_mix=sparse_mix,
                      compress=spec))
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    port = DecentralizedRunner(
        init_fn=None, loss_fn=port_loss, eval_fn=port_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=make_port(),
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         engine=engine, sparse_mix=sparse_mix,
                         compress=spec),
        params=params_from_jax(init), device="cpu")
    return ref, port


def _tree(jax_tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))


def _close(got, want, what, tol):
    assert list(got) == list(want), what
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=tol, err_msg=f"{what} {key}")


def _run_both(ref, port):
    """Run both engines; returns them so their carries can be read."""
    ref_engine, port_engine = ref._make_engine(), port._make_engine()
    ref_engine.run()
    port_engine.run()
    return ref_engine, port_engine


def _assert_matches(ref_engine, port_engine, tol=TOL["mlp"]):
    assert len(port_engine.edge_history) == len(ref_engine.edge_history) \
        == ROUNDS
    for r, (a, b) in enumerate(zip(ref_engine.edge_history,
                                   port_engine.edge_history)):
        assert np.array_equal(np.asarray(a), b), f"edges diverged at {r}"
    _close(port_engine.params, _tree(ref_engine.params), "params", tol)
    _close(port_engine.hat, _tree(ref_engine._hat), "hat", tol)
    _close(port_engine.resid, _tree(ref_engine._resid), "resid", tol)
    want_bytes = [r.comm_bytes for r in ref_engine.log.records]
    assert [r.comm_bytes for r in port_engine.log.records] == want_bytes
    # The analytic wire bytes of one transfer, times the edges so far.
    edges = np.cumsum([int(np.asarray(e).sum())
                       for e in port_engine.edge_history])
    wire = wire_bytes_tree(port_engine.params, N, port_engine.codec)
    ends = [r.rnd for r in port_engine.log.records]
    assert want_bytes == [int(edges[e]) * wire for e in ends]
    for a, b in zip(ref_engine.log.records, port_engine.log.records):
        assert (a.rnd, a.isolated) == (b.rnd, b.isolated)


DENSE_SPECS = ("int8", "fp8", "int8+topk0.75+gamma0.5")


@pytest.mark.parametrize("spec", DENSE_SPECS)
@pytest.mark.parametrize("name", ["morph", "static", "el-oracle",
                                  "fully-connected"])
def test_dense_compressed_matches_reference(name, spec):
    ref, port = _reference_and_port(name, spec)
    _assert_matches(*_run_both(ref, port))


@pytest.mark.parametrize("spec", ["int8"])
def test_dense_compressed_cnn_matches_reference(spec):
    """Reduced GN-LeNet (ten leaves, conv and fc) under Morph."""
    ref, port = _reference_and_port("morph", spec, model="cnn")
    _assert_matches(*_run_both(ref, port), tol=TOL["cnn"])


@pytest.mark.parametrize("name,engine,sparse_mix", [
    ("sparse-morph", "sparse", "exact"),
    ("morph", "sparse", "gather")],
    ids=["sparse-native-morph", "compat-gather-morph"])
def test_sparse_compressed_matches_reference(name, engine, sparse_mix):
    ref, port = _reference_and_port(name, "int8", engine=engine,
                                    sparse_mix=sparse_mix)
    _assert_matches(*_run_both(ref, port))


def test_second_run_restarts_the_carry_as_the_reference_does():
    """Each ``run()`` builds a fresh engine: ``hat`` restarts from the
    parameters (f32) and ``resid`` from zero, on both sides, and the
    second run still matches."""
    ref, port = _reference_and_port("morph", "int8")
    for _ in range(2):
        ref_engine, port_engine = ref._make_engine(), port._make_engine()
        for key, v in port.params.items():
            assert torch.equal(port_engine.hat[key], v.float())
            assert not port_engine.resid[key].any()
        _close(port_engine.hat, _tree(ref_engine._hat), "initial hat",
               TOL["mlp"])
        ref_engine.run()
        port_engine.run()
        ref.params, ref.opt_state = ref_engine.params, ref_engine.opt_state
        port.params, port.opt_state = port_engine.params, \
            port_engine.opt_state
        _assert_matches(ref_engine, port_engine)


def _port_runner(strategy, compress, engine="dense"):
    from repro_torch.models import mlp_params
    tr, test, parts = _data()
    return DecentralizedRunner(
        init_fn=lambda g: mlp_params(g), loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=strategy,
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         engine=engine, compress=compress),
        device="cpu")


PORT_STRATEGIES = {
    "morph": lambda: tcore.InGraphMorphStrategy(n=N, k=K, seed=0,
                                                device="cpu"),
    "static": lambda: tcore.InGraphStaticStrategy(n=N, degree=3,
                                                  device="cpu"),
    "sparse-morph": lambda: tsp.SparseMorphStrategy(n=N, k=K, seed=0,
                                                    device="cpu"),
}


@pytest.mark.parametrize("name", sorted(PORT_STRATEGIES))
def test_compress_none_is_bitwise_the_uncompressed_engine(name,
                                                          monkeypatch):
    """``compress="none"`` and a disabled :class:`CompressConfig` run no
    codec operation, carry nothing, and give the bits of a run that never
    names the knob."""
    engine = "sparse" if name.startswith("sparse") else "dense"
    base = _port_runner(PORT_STRATEGIES[name](), "none", engine)
    base.cfg = RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                            engine=engine)
    base.run()

    def refuse(*a, **k):
        raise AssertionError("codec called with the codec off")
    monkeypatch.setattr(superstep, "encode_delta_payload", refuse)
    monkeypatch.setattr(superstep, "apply_consensus_correction", refuse)
    for knob in ("none", CompressConfig()):
        run = _port_runner(PORT_STRATEGIES[name](), knob, engine)
        eng = run._make_engine()
        assert eng.codec is None and eng.hat is None and eng.resid is None
        eng.run()
        for r, (a, b) in enumerate(zip(base.edge_history, eng.edge_history)):
            assert np.array_equal(a, b), f"edges diverged at round {r}"
        for key in base.params:
            assert torch.equal(base.params[key], eng.params[key]), key
        assert [r.comm_bytes for r in base.log.records] == \
            [r.comm_bytes for r in eng.log.records]


@pytest.mark.parametrize("spec", ["int8", "fp8", "int8+topk0.75"])
def test_replicas_are_the_sum_of_the_decoded_deltas(spec, monkeypatch):
    """At gamma = 1 the engine's ``hat`` is its start plus every round's
    decoded delta, summed in round order, and each round's coding step is
    exact: decoded + new residual == payload on every sent coordinate
    (all of them without top-k)."""
    steps = []
    real = superstep.encode_delta_payload

    def spy(delta, resid, cfg):
        wire, dec, new_resid = real(delta, resid, cfg)
        steps.append((delta, resid, dec, new_resid))
        return wire, dec, new_resid
    monkeypatch.setattr(superstep, "encode_delta_payload", spy)
    run = _port_runner(PORT_STRATEGIES["morph"](), spec)
    eng = run._make_engine()
    assert eng.codec.consensus_gamma == 1.0
    hat = OrderedDict((k, v.clone()) for k, v in eng.hat.items())
    eng.run()
    assert len(steps) == ROUNDS
    for delta, resid, dec, new_resid in steps:
        for key in hat:
            hat[key] = hat[key] + dec[key]
            payload = delta[key] + resid[key]
            sent = dec[key] != 0 if "topk" in spec else \
                torch.ones_like(payload, dtype=torch.bool)
            assert torch.equal((dec[key] + new_resid[key])[sent],
                               payload[sent]), key
    for key in hat:
        assert torch.equal(eng.hat[key], hat[key]), key


def test_model_bytes_and_auto_are_the_references(monkeypatch):
    """Without a codec the comm accounting charges ``cfg.model_bytes`` when
    it is set; ``compress="auto"`` resolves through the tuning cache, and
    with no entry for the shape (the CPU) it is ``"none"``, bit for bit,
    as the reference's is with no entry."""
    import repro_torch.tune as tt
    monkeypatch.delenv(tt.ENV_CACHE, raising=False)
    run = _port_runner(PORT_STRATEGIES["static"](), "none")
    run.cfg = RunnerConfig(n_nodes=N, rounds=2, eval_every=1,
                           model_bytes=1000)
    run.run()
    edges = sum(int(e.sum()) for e in run.edge_history)
    assert run.log.records[-1].comm_bytes == edges * 1000
    plain = _port_runner(PORT_STRATEGIES["static"](), "none")
    plain.run()
    run = _port_runner(PORT_STRATEGIES["static"](), "auto")
    run.run()
    assert run.resolved_knobs.compress == "none"
    assert run.resolved_knobs.source == \
        f"default:cpu|n={N}|d=1580|devices=1|net=0"
    for key in plain.params:
        assert torch.equal(run.params[key], plain.params[key])
    assert [r.comm_bytes for r in run.log.records] == \
        [r.comm_bytes for r in plain.log.records]
