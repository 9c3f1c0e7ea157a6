"""The whole port slice against the reference: dense Morph / Static /
EL-Oracle / fully-connected training on the tiny GN-LeNet.

Reference side: ``repro.dlrt.DecentralizedRunner`` through the compiled
dense engine with the Pallas kernels in interpret mode.  Port side:
``repro_torch.dlrt.DecentralizedRunner`` on the CPU with the same initial
parameters (carried over with ``params_from_jax``), the same host batches
(``StackedBatcher`` is bit-for-bit numpy on both sides) and the
reference's ``jax.random`` draws replayed into the strategies.

Tolerances: edges identical every round; parameters within 1e-4 (the bar
of ``test_pallas_kernel_path_close_to_jnp_path``: the two sides sum in
different orders); record accuracy and loss within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification, train_test_split)
from repro.data.pipeline import DeviceDataStream as JaxStream  # noqa: E402
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.dlrt import (DecentralizedRunner as JaxRunner,    # noqa: E402
                        RunnerConfig as JaxConfig)
from repro.models.cnn import cnn_loss as jax_cnn_loss        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.data import DeviceDataStream, StackedBatcher  # noqa: E402
from repro_torch.dlrt import DecentralizedRunner, RunnerConfig  # noqa: E402
from repro_torch.models import cnn_loss, cnn_params          # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import el_draw, morph_draws, stream_take     # noqa: E402

N, ROUNDS, EVAL_EVERY = 6, 11, 5      # negotiations and refreshes at 0, 5, 10
WIDTH, IMG, CLASSES = 4, 8, 4         # tiny GN-LeNet


class ReplayMorph(tcore.InGraphMorphStrategy):
    """Port Morph fed the reference's draws, one set per negotiation."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._draws = iter(morph_draws(0, self.n, ROUNDS))

    def graph_round(self, gstate, rnd, sim, noise=None):
        if rnd % self.delta_r == 0:
            noise = next(self._draws)
        return super().graph_round(gstate, rnd, sim, noise=noise)


class ReplayEpidemic(tcore.InGraphEpidemicStrategy):
    """Port EL-Oracle fed the reference's per-round draw."""

    def graph_round(self, gstate, rnd, sim, noise=None):
        return super().graph_round(gstate, rnd, sim,
                                   noise=el_draw(self.seed, self.n, rnd))


class ReplayStream(DeviceDataStream):
    """Port device stream fed the reference stream's per-round slots."""

    def draw(self, rnd, take=None):
        sizes = self.sizes.tolist()
        return super().draw(rnd, take=stream_take(self.seed, rnd, sizes,
                                                  self.batch))


STRATEGIES = {
    "morph": (lambda: jcore.InGraphMorphStrategy(n=N, k=2, view_size=4,
                                                 seed=0),
              lambda: ReplayMorph(n=N, k=2, view_size=4, seed=0,
                                  device="cpu")),
    "static": (lambda: jcore.InGraphStaticStrategy(n=N, degree=3, seed=0),
               lambda: tcore.InGraphStaticStrategy(n=N, degree=3, seed=0,
                                                   device="cpu")),
    "el-oracle": (lambda: jcore.InGraphEpidemicStrategy(n=N, k=2, seed=0),
                  lambda: ReplayEpidemic(n=N, k=2, seed=0, device="cpu")),
    "fully-connected": (
        lambda: jcore.InGraphFullyConnectedStrategy(n=N),
        lambda: tcore.InGraphFullyConnectedStrategy(n=N, device="cpu")),
}


def _data():
    ds = make_image_classification(400, num_classes=CLASSES,
                                   image_size=IMG, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, N, 0.5, np.random.default_rng(0))
    return tr, te, parts


def _reference_and_port(name, stream=False):
    """The reference runner and the port's on the same set-up, not run."""
    tr, te, parts = _data()
    test = {"images": te.images, "labels": te.labels}
    make_jax, make_torch = STRATEGIES[name]
    if stream:
        jax_batcher = JaxStream(tr, parts, 8, seed=3)
        batcher = ReplayStream(tr, parts, 8, seed=3, device="cpu")
    else:
        jax_batcher = JaxBatcher(tr, parts, 8, seed=3)
        batcher = StackedBatcher(tr, parts, 8, seed=3)
    ref = JaxRunner(
        init_fn=lambda key: jax_cnn_params(
            key, in_channels=3, num_classes=CLASSES, image_size=IMG,
            width=WIDTH),
        loss_fn=jax_cnn_loss, eval_fn=jax_cnn_loss, optimizer=jax_sgd(0.05),
        batcher=jax_batcher, test_batch=test,
        strategy=make_jax(),
        cfg=JaxConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                      compiled=True, use_pallas=True, interpret=True))
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    port = DecentralizedRunner(
        init_fn=None, loss_fn=cnn_loss, eval_fn=cnn_loss,
        optimizer=sgd(0.05),
        batcher=batcher, test_batch=test,
        strategy=make_torch(),
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY),
        params=params_from_jax(init), device="cpu")
    return ref, port


def assert_matches_reference(ref, port):
    """The last ``run()``'s edges every round, parameters and records."""
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


@pytest.mark.parametrize("name,stream", [
    (name, False) for name in sorted(STRATEGIES)] + [("morph", True)],
    ids=sorted(STRATEGIES) + ["morph-device-stream"])
def test_slice_matches_reference_compiled_pallas(name, stream):
    ref, port = _reference_and_port(name, stream)
    ref.run()
    port.run()
    assert_matches_reference(ref, port)


@pytest.mark.parametrize("stream", [False, True],
                         ids=["host-batcher", "device-stream"])
def test_second_run_continues_from_the_evolved_graph(stream):
    """After a ``run()`` Morph holds the graph state the engine evolved (the
    last round's edges, not the bootstrap ring), and a second ``run()``
    starts from it as the reference's does: rounds from 0 again, the Eq.-3
    cache refreshed at round 0, the draws continuing."""
    ref, port = _reference_and_port("morph", stream)
    ring = port.strategy.state.edges.clone()
    for _ in range(2):
        ref.run()
        port.run()
        assert_matches_reference(ref, port)
        want, got = ref.strategy.state, port.strategy.state
        assert np.array_equal(got.edges.numpy(), port.edge_history[-1])
        assert not torch.equal(got.edges, ring)
        for field in ("known", "sim_valid", "edges"):
            assert np.array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(want, field))), field
        np.testing.assert_allclose(got.sim.numpy(), np.asarray(want.sim),
                                   atol=1e-4)


def test_runner_convolutions_in_f32():
    """The local step and the evaluator run with cuDNN's TF32 cleared
    (the reference computes in f32), and the caller's flag comes back."""
    import torch.backends.cudnn as cudnn
    seen = {"loss": set(), "eval": set()}

    def loss(params, batch):
        seen["loss"].add(cudnn.allow_tf32)
        return cnn_loss(params, batch)

    def evaluate(params, batch):
        seen["eval"].add(cudnn.allow_tf32)
        return cnn_loss(params, batch)

    tr, te, parts = _data()
    before = cudnn.allow_tf32
    for caller in (True, False):
        cudnn.allow_tf32 = caller
        try:
            DecentralizedRunner(
                init_fn=lambda g: cnn_params(g, in_channels=3,
                                             num_classes=CLASSES,
                                             image_size=IMG, width=WIDTH),
                loss_fn=loss, eval_fn=evaluate, optimizer=sgd(0.05),
                batcher=StackedBatcher(tr, parts, 8, seed=3),
                test_batch={"images": te.images, "labels": te.labels},
                strategy=tcore.InGraphStaticStrategy(n=N, degree=3,
                                                     device="cpu"),
                cfg=RunnerConfig(n_nodes=N, rounds=1, eval_every=1),
                device="cpu").run()
            assert cudnn.allow_tf32 is caller
        finally:
            cudnn.allow_tf32 = before
    assert seen == {"loss": {False}, "eval": {False}}


def test_similarity_refresh_cadence(monkeypatch):
    """The engine refreshes the Eq.-3 cache on rounds ``rnd % sim_every
    == 0`` only, and only for a strategy that reads it."""
    import repro_torch.dlrt.superstep as superstep
    refreshed = []
    real = superstep.ops.model_pairwise_cosine
    monkeypatch.setattr(superstep.ops, "model_pairwise_cosine",
                        lambda p: refreshed.append(len(refreshed)) or real(p))
    tr, te, parts = _data()
    for strategy, sim_every, want in (
            (tcore.InGraphMorphStrategy(n=N, k=2, seed=0, device="cpu"),
             2, 3),
            (tcore.InGraphStaticStrategy(n=N, degree=3, device="cpu"),
             1, 0)):
        refreshed.clear()
        DecentralizedRunner(
            init_fn=lambda g: cnn_params(g, in_channels=3,
                                         num_classes=CLASSES,
                                         image_size=IMG, width=WIDTH),
            loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.05),
            batcher=StackedBatcher(tr, parts, 8, seed=3),
            test_batch={"images": te.images, "labels": te.labels},
            strategy=strategy,
            cfg=RunnerConfig(n_nodes=N, rounds=6, eval_every=5,
                             sim_every=sim_every),
            device="cpu").run()
        assert len(refreshed) == want          # rounds 0, 2, 4 for Morph
