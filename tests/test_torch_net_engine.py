"""The dense in-scan network model through the port's engine against the
reference's — the port's counterparts of ``tests/test_dense_net.py``.

Reference side: ``repro.dlrt.DecentralizedRunner`` through the compiled
dense engine (``use_pallas=False``, as the reference's own network tests
run) with ``net=repro.netsim.DenseNetwork(...)``.  Port side:
``repro_torch.dlrt.DecentralizedRunner`` on the CPU with the same initial
parameters, the same host batches, the reference's Morph and EL draws and
the reference's network draws replayed (``tests/_jax_draws.py``).  The
tiny MLP at N = 6, 11 rounds (evaluations at 0, 5, 10).

Tolerances: edges, delivered sets, ``net_stats`` and comm bytes exactly;
parameters within 1e-4 (the two sides sum the mix in other orders, as in
``tests/test_torch_runner.py``); under ``int8`` within 5e-3 (the bar of
``tests/test_torch_compress_engine.py``).  Within the port, the ideal
network against no network model is bitwise on the CPU: both plain mixes
sum over the nodes in node order from the same quotients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.netsim as jnet                                  # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.netsim as tnet                            # noqa: E402
from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification, train_test_split)
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.dlrt import (DecentralizedRunner as JaxRunner,    # noqa: E402
                        RunnerConfig as JaxConfig)
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.compress import CompressConfig, wire_bytes_tree  # noqa: E402
from repro_torch.data import StackedBatcher                  # noqa: E402
from repro_torch.dlrt import (DecentralizedRunner,           # noqa: E402
                              RunnerConfig, Superstep)
from repro_torch.models import mlp_loss                      # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import el_draw, morph_draws, net_round_draws  # noqa: E402

N, ROUNDS, EVAL_EVERY = 6, 11, 5
TOL, CODEC_TOL = 1e-4, 5e-3
NAMES = ("morph", "static", "el-oracle", "fully-connected")

# The lossy, stale profile of tests/test_dense_net.py: every delay 1.4 to
# 1.9 s, one round stale at round_s = 1.
LOSSY = dict(name="slow", base_latency_s=1.4, jitter_s=0.5, drop_rate=0.05,
             seed=7)
# Churn, crashes and stragglers on top of it.
FAULTS = dict(straggler_fraction=0.34, straggler_slowdown=2.0,
              churn_fraction=0.5, crash_fraction=0.34, mean_downtime_s=3.0,
              horizon_s=8.0, seed=2)


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


class ReplayNet(tnet.DenseNetwork):
    """Port network model fed the reference's keyed uniforms."""

    def draws(self, rnd, n, device="cuda"):
        d = net_round_draws(self.profile, rnd, n)
        return tnet.NetDraws(*(None if u is None else u.to(device)
                               for u in d))


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
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, N, 0.5, np.random.default_rng(0))
    return tr, {"images": te.images, "labels": te.labels}, parts


def _nets(profile=None, faults=None, **kw):
    """The same network model built by each package (``profile`` keyword
    arguments of ``NetworkProfile``, ``faults`` of ``FaultConfig``)."""
    profile = profile or {}
    parts = profile.pop("partitions", ())
    out = []
    for pkg, net_cls in ((jnet, jnet.DenseNetwork), (tnet, ReplayNet)):
        prof = pkg.NetworkProfile(
            partitions=tuple(pkg.Partition(**p) for p in parts), **profile)
        fm = None if faults is None else pkg.FaultModel(
            pkg.FaultConfig(**faults), N)
        out.append(net_cls(prof, faults=fm, **kw))
    return out


def _port(name, net=None, *, rounds=ROUNDS, eval_every=EVAL_EVERY,
          compress="none", engine="dense", params=None):
    tr, test, parts = _data()
    if params is None:
        ref = JaxRunner(init_fn=jax_mlp_params, loss_fn=jax_mlp_loss,
                        eval_fn=jax_mlp_loss, optimizer=jax_sgd(0.05),
                        batcher=JaxBatcher(tr, parts, 8, seed=3),
                        test_batch=test, strategy=STRATEGIES[name][0](),
                        cfg=JaxConfig(n_nodes=N, rounds=1))
        params = jax.tree_util.tree_map(np.asarray, ref.params)
    return DecentralizedRunner(
        init_fn=None, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=STRATEGIES[name][1](),
        cfg=RunnerConfig(n_nodes=N, rounds=rounds, eval_every=eval_every,
                         compress=compress, engine=engine, net=net),
        params=params_from_jax(params), device="cpu")


def _reference_and_port(name, nets, *, rounds=ROUNDS, eval_every=EVAL_EVERY,
                        compress="none"):
    """The reference runner and the port's on the same set-up, not run."""
    tr, test, parts = _data()
    ref = JaxRunner(
        init_fn=jax_mlp_params, loss_fn=jax_mlp_loss, eval_fn=jax_mlp_loss,
        optimizer=jax_sgd(0.05), batcher=JaxBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=STRATEGIES[name][0](),
        cfg=JaxConfig(n_nodes=N, rounds=rounds, eval_every=eval_every,
                      compiled=True, net=nets[0], compress=compress))
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    port = _port(name, nets[1], rounds=rounds, eval_every=eval_every,
                 compress=compress, params=init)
    return ref, port


def _tree(jax_tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))


def _close(got, want, what, tol):
    assert list(got) == list(want), what
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=tol, err_msg=f"{what} {key}")


def _assert_net_matches(ref, port, tol=TOL):
    """Edges and delivered sets every round, net_stats, comm bytes and the
    records exactly; the parameters within ``tol``."""
    assert len(port.edge_history) == len(ref.edge_history)
    for r, (a, b) in enumerate(zip(ref.edge_history, port.edge_history)):
        assert np.array_equal(np.asarray(a), b), f"edges diverged at {r}"
    assert len(port.delivered_history) == len(ref.delivered_history)
    for r, (a, b) in enumerate(zip(ref.delivered_history,
                                   port.delivered_history)):
        assert np.array_equal(np.asarray(a), b), \
            f"delivered sets diverged at {r}"
    want, got = ref.net_stats, port.net_stats
    assert set(got) == set(want)
    for key in ("delivered", "dropped", "staleness_sum"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["staleness_hist"],
                                  want["staleness_hist"])
    assert port.staleness_mean() == ref.staleness_mean()
    _close(port.params, _tree(ref.params), "params", tol)
    for a, b in zip(ref.log.records, port.log.records):
        assert (a.rnd, a.comm_bytes, a.isolated) == \
            (b.rnd, b.comm_bytes, b.isolated)


def _assert_bitwise(a, b):
    assert len(a.edge_history) == len(b.edge_history) == ROUNDS
    for r, (ea, eb) in enumerate(zip(a.edge_history, b.edge_history)):
        assert np.array_equal(ea, eb), f"edge sequence diverged at {r}"
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key]), key
    for ra, rb in zip(a.log.records, b.log.records):
        assert (ra.rnd, ra.comm_bytes, ra.isolated, ra.mean_accuracy,
                ra.mean_loss) == (rb.rnd, rb.comm_bytes, rb.isolated,
                                  rb.mean_accuracy, rb.mean_loss)


# ---------------------------------------------------------------------------
# ideal conformance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_ideal_network_is_bitwise_no_network(name):
    """An ideal network (ring depth 1, nothing dropped or delayed) gives the
    engine without one bit for bit: edges, parameters, comm bytes and
    records.  The vanilla run mixes through ``graph_mix_masked`` (uniform
    strategies) or ``graph_mix``; the network run through ``graph_mix`` on
    ``uniform_weights_torch(delivered)`` or the kept weights."""
    a = _port(name)
    a.run()
    b = _port(name, tnet.DenseNetwork(tnet.profiles.ideal()))
    b.run()
    _assert_bitwise(a, b)
    assert b.net_stats["dropped"] == 0
    assert b.net_stats["staleness_hist"].tolist() == \
        [b.net_stats["delivered"]]
    assert b.staleness_mean() == 0.0 and a.staleness_mean() == 0.0
    assert a.net_stats is None and a.delivered_history == []
    for e, d in zip(b.edge_history, b.delivered_history):
        assert np.array_equal(e, d)


# ---------------------------------------------------------------------------
# lossy and stale runs against the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults", [False, True], ids=["lossy",
                                                       "lossy+faults"])
@pytest.mark.parametrize("name", NAMES)
def test_lossy_stale_matches_reference(name, faults):
    nets = _nets(dict(LOSSY), FAULTS if faults else None)
    ref, port = _reference_and_port(name, nets)
    ref_engine, port_engine = ref._make_engine(), port._make_engine()
    ref_engine.run()
    port_engine.run()
    _assert_net_matches(ref_engine, port_engine)
    # The rings: last-step rounds exactly, snapshots within TOL.
    hist, lhist = ref_engine._netstate
    np.testing.assert_array_equal(port_engine.lhist.numpy(),
                                  np.asarray(lhist))
    _close(port_engine.hist, _tree(hist), "hist", TOL)
    assert port_engine.net_S == ref_engine._net_S == 2
    # Comm bytes are the delivered transfers only.
    assert port_engine.log.last().comm_bytes == \
        port_engine.net_stats["delivered"] * port_engine._wire_bytes
    if faults:
        assert port_engine.net_stats["dropped"] > 0


def test_runner_exposes_the_network_counters():
    nets = _nets(dict(LOSSY), FAULTS)
    ref, port = _reference_and_port("el-oracle", nets)
    ref.run()
    port.run()
    _assert_net_matches(ref, port)
    assert port.staleness_mean() == ref.staleness_mean() > 0


def test_staleness_quantization():
    """Delays quantize to floor(delay / round_s) snapshot indices; the ring
    depth follows the profile's worst case."""
    nets = _nets(dict(name="slow", base_latency_s=2.3, seed=1), round_s=1.0)
    ref, port = _reference_and_port("el-oracle", nets)
    ref.run()
    port.run()
    _assert_net_matches(ref, port)
    engine = port._make_engine()
    assert engine.net_S == 3                 # floor(2.3 / 1.0) = 2 back
    hist = port.net_stats["staleness_hist"]
    assert hist[2] > 0 and hist[0] == 0 and hist[1] == 0
    # Content staleness: 2 rounds back once the ring is warm; the first
    # two rounds deliver the initial snapshot (staleness 1 from round -1).
    assert port.staleness_mean() == pytest.approx(
        (1 + 2 * (ROUNDS - 1)) / ROUNDS)
    # Sub-round delays are absorbed by the receiver's wait: staleness 0.
    fast = _port("el-oracle", tnet.DenseNetwork(tnet.profiles.wan(),
                                                round_s=1.0))
    fast.run()
    assert fast._make_engine().net_S == 1
    assert fast.staleness_mean() == 0.0
    assert fast.net_stats["dropped"] == 0


def test_churn_freezes_nodes():
    """A crashed node stops stepping and receiving: its parameters do not
    move while it is down, and no edge to or from it is delivered."""
    fm = tnet.FaultModel(tnet.FaultConfig(churn_fraction=0.5,
                                          crash_fraction=1.0, horizon_s=4.0,
                                          seed=3), N)
    runner = _port("el-oracle", tnet.DenseNetwork(tnet.profiles.ideal(),
                                                  faults=fm), rounds=10)
    engine = runner._make_engine()
    up = fm.round_up_masks(10, 1.0)
    assert not up[-1].all()
    before = None
    for rnd in range(10):
        _, delivered, _, _ = engine.net_round(rnd)
        now = {k: v.clone() for k, v in engine.params.items()}
        for i in np.flatnonzero(~up[rnd]):
            assert not delivered[i].any() and not delivered[:, i].any()
            if before is not None:
                for k in now:
                    assert torch.equal(now[k][i], before[k][i]), (rnd, i)
        before = now
    # And the whole run against the reference's.
    ref, port = _reference_and_port(
        "el-oracle", _nets(faults=dict(churn_fraction=0.5, crash_fraction=1.0,
                                       horizon_s=4.0, seed=3)), rounds=10)
    ref.run()
    port.run()
    _assert_net_matches(ref, port)
    assert port.net_stats["dropped"] > 0


def test_chunk_invariance():
    """Other evaluation cadences cut the rounds into other chunks; the
    round-keyed draws keep the trajectory bit for bit."""
    prof = tnet.NetworkProfile(**LOSSY)
    runs = []
    for every in (3, 100):
        runner = _port("el-oracle", tnet.DenseNetwork(prof), rounds=12,
                       eval_every=every)
        runner.run()
        runs.append(runner)
    a, b = runs
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key]), key
    for da, db in zip(a.delivered_history, b.delivered_history):
        assert np.array_equal(da, db)
    assert a.net_stats["staleness_sum"] == b.net_stats["staleness_sum"]
    np.testing.assert_array_equal(a.net_stats["staleness_hist"],
                                  b.net_stats["staleness_hist"])
    assert a.log.last().comm_bytes == b.log.last().comm_bytes


def test_second_run_starts_from_fresh_rings():
    """Each ``run()`` builds a new engine: the rings start again from the
    current parameters and the round-keyed network draws replay from round
    0, as in the reference's second run; Morph continues from its evolved
    graph and draws."""
    nets = _nets(dict(LOSSY), FAULTS)
    ref, port = _reference_and_port("morph", nets)
    for _ in range(2):
        ref.run()
        port.run()
        _assert_net_matches(ref, port)


def test_round_s_not_a_power_of_two_and_a_partition_edge():
    """round_s = 0.3 (delays 4 to 6 rounds back) and a partition window
    [0.9, 1.8) whose ends are not exact in binary: the engine's f32 clock
    puts rounds 3, 4 and 5 inside it (the f64 products 4, 5 and 6)."""
    groups = (frozenset({0, 1, 2}), frozenset({3, 4, 5}))
    profile = dict(LOSSY, partitions=[dict(start=0.9, end=1.8,
                                           groups=groups)])
    nets = _nets(profile, round_s=0.3)
    ref, port = _reference_and_port("el-oracle", nets)
    ref.run()
    port.run()
    _assert_net_matches(ref, port)
    assert port._make_engine().net_S == 7
    cross = np.zeros((N, N), bool)
    cross[:3, 3:] = cross[3:, :3] = True
    for rnd, (e, d) in enumerate(zip(port.edge_history,
                                     port.delivered_history)):
        inside = rnd in (3, 4, 5)
        assert not (d & cross).any() if inside else True
        if rnd == 6:
            assert (e & cross).any() and (d & cross).any()


def test_sparse_engine_refuses_a_network_model():
    net = tnet.DenseNetwork(tnet.profiles.ideal())
    msg = "the sparse engine does not support the dense in-scan network"
    with pytest.raises(ValueError, match=msg):
        _port("static", net, engine="sparse")
    with pytest.raises(ValueError, match=msg):
        Superstep(loss_fn=mlp_loss, eval_fn=mlp_loss, optimizer=sgd(0.05),
                  batcher=None, test_batch={},
                  strategy=STRATEGIES["static"][1](),
                  cfg=RunnerConfig(n_nodes=N, rounds=1, engine="sparse",
                                   net=net),
                  params={}, opt_state={}, device="cpu")


def test_int8_under_the_lossy_network_matches_reference():
    """Under a codec the ring holds the replicas: slot 0 is the one each
    delta is coded against, so the engine keeps no separate ``hat``."""
    nets = _nets(dict(LOSSY), FAULTS)
    ref, port = _reference_and_port("morph", nets, compress="int8")
    ref_engine, port_engine = ref._make_engine(), port._make_engine()
    ref_engine.run()
    port_engine.run()
    assert port_engine.hat is None
    _assert_net_matches(ref_engine, port_engine, tol=CODEC_TOL)
    hist, lhist = ref_engine._netstate
    _close(port_engine.hist, _tree(hist), "ring", CODEC_TOL)
    _close(port_engine.resid, _tree(ref_engine._resid), "resid", CODEC_TOL)
    wire = wire_bytes_tree(port_engine.params, N,
                           CompressConfig.parse("int8"))
    assert port_engine._wire_bytes == wire
    assert port_engine.log.last().comm_bytes == \
        port_engine.net_stats["delivered"] * wire
    assert all(v.dtype == torch.float32 for v in port_engine.hist.values())


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_stage_hook_runs_the_round_unchanged(compress):
    """``net_round(rnd, stage)`` runs each stage of the round through the
    hook, in the round's order, and gives the bits of the round without
    it: a caller that times the stages times the engine's own code."""
    nets = _nets(dict(LOSSY), FAULTS)
    plain = _port("morph", nets[1], compress=compress)._make_engine()
    hooked = _port("morph", nets[1], compress=compress)._make_engine()
    seen = []

    def stage(name, fn):
        seen.append(name)
        return fn()

    for rnd in range(ROUNDS):
        a = plain.net_round(rnd)
        seen.clear()
        b = hooked.net_round(rnd, stage)
        want = ["batch", "local_step", "masks"] \
            + (["encode"] if compress != "none" else []) \
            + ["push", "similarity", "controller", "delivery_plan", "mix",
               "settle"]
        assert seen == want, rnd
        for x, y in zip(a, b):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), rnd
    for key in plain.params:
        assert torch.equal(plain.params[key], hooked.params[key]), key
    for key in plain.hist:
        assert torch.equal(plain.hist[key], hooked.hist[key]), key
    assert torch.equal(plain.lhist, hooked.lhist)
