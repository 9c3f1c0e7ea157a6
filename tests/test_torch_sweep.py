"""The sweep farm (``repro_torch.dlrt.SweepSuperstep``) against the
reference's (``repro.dlrt.SweepSuperstep``) and against the port's own
solo engine, on the CPU — the port's counterparts of
``tests/test_sweep.py``.

Reference side: ``repro.dlrt.SweepSuperstep`` on the tiny MLP and a
reduced GN-LeNet (width 4 on 8-pixel images), N = 5, 8 rounds.  Port side:
the port's sweep from the reference's initial parameters, with the
reference's draws replayed per experiment (``tests/_jax_draws.py``): each
stream's batch slots, each experiment's Morph negotiations and each
profile's network uniforms.  Tolerances: edges, delivered masks,
``net_stats`` and comm bytes exactly; parameters within 1e-4 (the two
sides sum the mix in other orders, as in ``tests/test_torch_runner.py``).

Within the port, each experiment of a sweep is bit for bit its solo
``Superstep`` run (Morph, Static, EL-Oracle, fully-connected), and the
batched controller (``update_topology``, ``match_dense``) is bit for bit E
solo calls.  The spec, ``stack_streams``, ``SweepNetwork`` and the folded
draws are compared exactly with the reference's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.netsim as jnet                                  # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.netsim as tnet                            # noqa: E402
from repro.data import (DeviceDataStream as JaxStream,       # noqa: E402
                        dirichlet_partition, make_image_classification,
                        train_test_split)
from repro.data.pipeline import stack_streams as jax_stack   # noqa: E402
from repro.dlrt import (RunnerConfig as JaxConfig,           # noqa: E402
                        SweepSpec as JaxSpec,
                        SweepSuperstep as JaxSweep)
from repro.models.cnn import cnn_loss as jax_cnn_loss        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.netsim import sampling as jsamp                   # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.core.matching import match_dense            # noqa: E402
from repro_torch.core.morph import (init_state, stack_noise,  # noqa: E402
                                    stack_states, update_topology)
from repro_torch.data import DeviceDataStream, stack_streams  # noqa: E402
from repro_torch.dlrt import (DecentralizedRunner,           # noqa: E402
                              RunnerConfig, SweepSpec, SweepSuperstep)
from repro_torch.models import (cnn_loss, cnn_params,        # noqa: E402
                                mlp_loss, mlp_params)
from repro_torch.netsim import sampling as tsamp             # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import morph_draws, net_draws, stream_take   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, ROUNDS, K = 5, 8, 2
TOL = 1e-4
CPU = torch.device("cpu")

_ds = make_image_classification(200, num_classes=4, image_size=8, seed=0)
_tr, _te = train_test_split(_ds, 0.25)
_parts = dirichlet_partition(_tr.labels, N, 0.5, np.random.default_rng(0))
_test = {"images": _te.images[:24], "labels": _te.labels[:24]}

# model name -> (reference init, reference loss, port init, port loss)
MODELS = {
    "mlp": (jax_mlp_params, jax_mlp_loss, mlp_params, mlp_loss),
    "cnn": (lambda key: jax_cnn_params(key, in_channels=3, num_classes=4,
                                       image_size=8, width=4),
            jax_cnn_loss,
            lambda g: cnn_params(g, in_channels=3, num_classes=4,
                                 image_size=8, width=4),
            cnn_loss),
}


# ---------------------------------------------------------------------------
# Replayed draws
# ---------------------------------------------------------------------------

class ReplayStream(DeviceDataStream):
    """Port stream whose slots are the reference stream's."""

    def slots(self, rnd):
        return stream_take(self.seed, rnd, self.sizes.tolist(),
                           self.batch).long()


class ReplayMorph(tcore.InGraphMorphStrategy):
    """Port Morph whose stacked rounds take each experiment's reference
    draws (``seeds``: the experiments' strategy seeds)."""

    def replay(self, seeds):
        self._draws = [iter(morph_draws(s, self.n, ROUNDS)) for s in seeds]
        return self

    def sweep_graph_round(self, gstate, rnd, sim, delta_r=None, beta=None,
                          noise=None):
        if noise is None:
            E = gstate.known.shape[0]
            drs = [self.delta_r] * E if delta_r is None else delta_r
            due = [e for e in range(E) if rnd % drs[e] == 0]
            if due:
                noise = stack_noise([next(self._draws[e]) for e in due])
        return super().sweep_graph_round(gstate, rnd, sim, delta_r=delta_r,
                                         beta=beta, noise=noise)


class ReplaySweepNet(tnet.SweepNetwork):
    """Port sweep network fed each profile's reference uniforms."""

    def draws(self, rnd, n, device="cpu"):
        return [tnet.NetDraws(net_draws(net.profile.seed, rnd, n, 0),
                              net_draws(net.profile.seed, rnd, n, 1))
                for net in self.nets]


# ---------------------------------------------------------------------------
# SweepSpec
# ---------------------------------------------------------------------------

GRIDS = [dict(seeds=[0, 1, 2], profiles=["ideal", "wan"]),
         dict(seeds=[3, 4], delta_r=[2, 5], beta=[10.0, 500.0]),
         dict(seeds=[7], profiles=["lan", "wan", "flaky-wan"],
              delta_r=[1, 3])]


@pytest.mark.parametrize("axes", GRIDS)
def test_spec_grid_and_describe_match_the_reference(axes):
    ref, port = JaxSpec.grid(**axes), SweepSpec.grid(**axes)
    assert len(port) == len(ref)
    for name in ("seeds", "profiles", "delta_r", "beta"):
        assert getattr(port, name) == getattr(ref, name)
    assert [port.describe(e) for e in range(len(port))] == \
        [ref.describe(e) for e in range(len(ref))]


def test_spec_grid_varies_seeds_fastest():
    spec = SweepSpec.grid(seeds=[0, 1, 2], profiles=["ideal", "wan"])
    assert spec.seeds == (0, 1, 2, 0, 1, 2)
    assert spec.profiles == ("ideal",) * 3 + ("wan",) * 3
    assert spec.describe(4) == {"seed": 1, "profile": "wan"}


@pytest.mark.parametrize("kw", [dict(seeds=(0, 1), delta_r=(2,)),
                                dict(seeds=(0,), profiles=("a", "b")),
                                dict(seeds=(0, 1, 2), beta=(1.0, 2.0)),
                                dict(seeds=())])
def test_spec_length_errors_match_the_reference(kw):
    with pytest.raises(ValueError) as ref:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as port:
        SweepSpec(**kw)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# stack_streams
# ---------------------------------------------------------------------------

def _streams(parts_list, batches, seeds, data=(_tr, _tr)):
    ref = [JaxStream(ds=d, parts=p, batch_size=b, seed=s)
           for d, p, b, s in zip(data, parts_list, batches, seeds)]
    port = [DeviceDataStream(d, p, b, seed=s, device="cpu")
            for d, p, b, s in zip(data, parts_list, batches, seeds)]
    return ref, port


def test_stack_streams_matches_the_reference():
    other = dirichlet_partition(_tr.labels, N, 0.1, np.random.default_rng(9))
    ref, port = _streams([_parts, other], [4, 4], [3, 11])
    r_data, r_index, r_sizes, r_seeds, r_batch = jax_stack(ref)
    p_data, p_index, p_sizes, p_seeds, p_batch = stack_streams(port)
    assert np.array_equal(p_index.numpy(), r_index)
    assert np.array_equal(p_sizes.numpy(), r_sizes)
    assert np.array_equal(p_seeds.numpy(), r_seeds)
    assert p_batch == r_batch == 4
    assert r_index.shape[2] == max(len(p) for p in _parts + other)
    for k in r_data:
        assert np.array_equal(p_data[k].numpy(), r_data[k])


def test_stack_streams_keeps_each_streams_draws():
    """Draws through the stacked tables are each stream's own."""
    other = dirichlet_partition(_tr.labels, N, 0.1, np.random.default_rng(9))
    _, port = _streams([_parts, other], [4, 4], [3, 11])
    data, index, _, _, _ = stack_streams(port)
    for e, st in enumerate(port):
        take = st.slots(5)
        sel = index[e].gather(1, take)
        for k, v in st.draw(5).items():
            assert torch.equal(data[k][sel], v)


_small = make_image_classification(120, num_classes=4, image_size=8, seed=1)
STREAM_ERRORS = {
    "batch": dict(parts_list=[_parts, _parts], batches=[4, 8]),
    "nodes": dict(parts_list=[_parts, _parts[:-1]], batches=[4, 4]),
    "data": dict(parts_list=[_parts, [np.arange(5)] * N], batches=[4, 4],
                 data=(_tr, _small)),
}


@pytest.mark.parametrize("case", sorted(STREAM_ERRORS))
def test_stack_streams_errors_match_the_reference(case):
    ref, port = _streams(seeds=[0, 1], **STREAM_ERRORS[case])
    with pytest.raises(ValueError) as r:
        jax_stack(ref)
    with pytest.raises(ValueError) as p:
        stack_streams(port)
    assert str(p.value) == str(r.value)
    with pytest.raises(ValueError, match="at least one"):
        stack_streams([])


# ---------------------------------------------------------------------------
# SweepNetwork and the folded draws
# ---------------------------------------------------------------------------

def _sweep_nets(specs, **kw):
    """One ``(reference, port)`` pair of sweep networks over profiles
    ``specs`` = [(name, n, seed)] with ``DenseNetwork`` keywords ``kw``."""
    out = []
    for pkg in (jnet, tnet):
        nets = [pkg.DenseNetwork(pkg.profiles.get_profile(name, n, seed),
                                 **kw) for name, n, seed in specs]
        out.append(pkg.SweepNetwork(nets))
    return out


NET_CASES = [([("ideal", N, 0), ("wan", N, 1), ("wan", N, 2)],
              dict(round_s=1.0)),
             ([("wan", N, 0), ("lan", N, 1)],
              dict(round_s=0.05, max_staleness=4)),
             ([("flaky-wan", N, 3), ("ideal", N, 4)], dict(round_s=0.3))]


@pytest.mark.parametrize("specs,kw", NET_CASES)
def test_sweep_network_layout_matches_the_reference(specs, kw):
    ref, port = _sweep_nets(specs, **kw)
    model_bytes = 3_200
    assert len(port) == len(ref) and port.round_s == ref.round_s
    assert port.depth(model_bytes) == ref.depth(model_bytes)
    assert np.array_equal(port.depths(model_bytes), ref.depths(model_bytes))
    for a, b in zip(port.profile_arrays(model_bytes),
                    ref.profile_arrays(model_bytes)):
        assert np.array_equal(a, b)
    for a, b in zip(port.round_masks(ROUNDS, N), ref.round_masks(ROUNDS, N)):
        assert a.shape == b.shape and np.array_equal(a, b)


def _flaky_with_faults(pkg):
    faults = pkg.FaultModel(pkg.FaultConfig(
        straggler_fraction=0.4, straggler_slowdown=2.0, churn_fraction=0.4,
        crash_fraction=0.2, mean_downtime_s=2.0, horizon_s=8.0, seed=2), N)
    return pkg.SweepNetwork([
        pkg.DenseNetwork(pkg.profiles.wan(seed=0), faults=faults),
        pkg.DenseNetwork(pkg.profiles.ideal())])


def test_sweep_network_fault_timelines_match_the_reference():
    ref, port = _flaky_with_faults(jnet), _flaky_with_faults(tnet)
    up_r, step_r = ref.round_masks(ROUNDS, N)
    up_p, step_p = port.round_masks(ROUNDS, N)
    assert np.array_equal(up_p, up_r) and np.array_equal(step_p, step_r)
    assert not up_p.all() and up_p[1].all()


def test_sweep_network_matrices_are_each_experiments_own():
    """Experiment e's staleness and drops are its own ``DenseNetwork``'s,
    the staleness clamped to its own depth (a shallower experiment in a
    deeper shared ring)."""
    nets = [tnet.DenseNetwork(tnet.profiles.wan(seed=s), round_s=0.05,
                              max_staleness=m) for s, m in ((0, 4), (1, 2))]
    nets.append(tnet.DenseNetwork(tnet.NetworkProfile(
        name="lossy", base_latency_s=0.04, jitter_s=0.05, drop_rate=0.3,
        seed=5), round_s=0.05))
    sweep = tnet.SweepNetwork(nets)
    model_bytes = 40_000
    assert sweep.depth(model_bytes) == max(sweep.depths(model_bytes))
    for rnd in (0, 3, 7):
        stal, lost = sweep.round_matrices(rnd, N, model_bytes, device=CPU)
        for e, net in enumerate(nets):
            depth = net.depth(model_bytes)
            assert torch.equal(stal[e], net.staleness_matrix(
                rnd, N, model_bytes, depth, device=CPU))
            assert torch.equal(lost[e], net.drop_mask(rnd, N, device=CPU))
            assert int(stal[e].max()) <= depth - 1


def test_sweep_network_refusals_match_the_reference():
    part = dict(start=0.0, end=1.0, groups=(frozenset({0, 1}),))
    for pkg in (jnet, tnet):
        with pytest.raises(ValueError, match="round_s"):
            pkg.SweepNetwork([pkg.DenseNetwork(pkg.profiles.ideal()),
                              pkg.DenseNetwork(pkg.profiles.ideal(),
                                               round_s=0.5)])
        walled = pkg.NetworkProfile(name="walled",
                                    partitions=(pkg.Partition(**part),))
        with pytest.raises(ValueError, match="partition"):
            pkg.SweepNetwork([pkg.DenseNetwork(walled)])
        with pytest.raises(ValueError, match="at least one"):
            pkg.SweepNetwork([])


@pytest.mark.parametrize("scale", [0.0, 0.5, 0.05])
def test_folded_draws_are_the_unfolded_ones(scale):
    """At scale 0 the folded twins give the unfolded zero paths bit for bit
    (``u * 0 == 0``, ``u < 0``), above it the same uniforms' products and
    comparisons; fed the reference's uniforms they are its folded twins'
    bits."""
    prof = tnet.NetworkProfile(name="p", jitter_s=scale, drop_rate=scale,
                               seed=4)
    for rnd in (0, 6):
        jit = tsamp.jitter_matrix_folded(4, rnd, N, scale, CPU)
        drop = tsamp.drop_matrix_folded(4, rnd, N, scale, CPU)
        assert torch.equal(jit, tsamp.jitter_matrix(prof, rnd, N, CPU))
        assert torch.equal(drop, tsamp.drop_matrix(prof, rnd, N, CPU))
        want_j = np.asarray(jsamp.jitter_matrix_folded(4, rnd, N, scale))
        want_d = np.asarray(jsamp.drop_matrix_folded(4, rnd, N, scale))
        got_j = tsamp.jitter_matrix_folded(4, rnd, N, scale, CPU,
                                           u=net_draws(4, rnd, N, 0))
        got_d = tsamp.drop_matrix_folded(4, rnd, N, scale, CPU,
                                         u=net_draws(4, rnd, N, 1))
        assert np.array_equal(got_j.numpy(), want_j)
        assert np.array_equal(got_d.numpy(), want_d)
    assert tsamp.round_key(4, 6) == tsamp.fold_seed(4, 6)


# ---------------------------------------------------------------------------
# The sweep against the reference's
# ---------------------------------------------------------------------------

def _reference(model, spec, delta_rs, nets=None):
    init, loss = MODELS[model][:2]
    cfg = JaxConfig(n_nodes=N, rounds=ROUNDS, eval_every=4, sim_every=2)
    return JaxSweep(
        spec=JaxSpec(seeds=spec.seeds, delta_r=spec.delta_r),
        init_fn=init, loss_fn=loss, eval_fn=loss, optimizer=jax_sgd(0.05),
        streams=[JaxStream(ds=_tr, parts=_parts, batch_size=4, seed=s)
                 for s in spec.seeds], test_batch=_test,
        strategies=[jcore.InGraphMorphStrategy(n=N, k=K, view_size=K + 2,
                                               seed=s, delta_r=d)
                    for s, d in zip(spec.seeds, delta_rs)],
        cfg=cfg, net=None if nets is None else jnet.SweepNetwork(nets))


def _port_sweep(model, spec, delta_rs, params, net=None, replay=True):
    loss = MODELS[model][3]
    strategies = [(ReplayMorph if replay else tcore.InGraphMorphStrategy)(
        n=N, k=K, view_size=K + 2, seed=s, delta_r=d, device="cpu")
        for s, d in zip(spec.seeds, delta_rs)]
    if replay:
        strategies[0].replay(spec.seeds)
    stream = ReplayStream if replay else DeviceDataStream
    return SweepSuperstep(
        spec=spec, loss_fn=loss, eval_fn=loss, optimizer=sgd(0.05),
        streams=[stream(_tr, _parts, 4, seed=s, device="cpu")
                 for s in spec.seeds], test_batch=_test,
        strategies=strategies,
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=4,
                         sim_every=2),
        params=params, net=net, device="cpu")


def _ref_params(ref, E):
    return [params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x[e]), ref.params)) for e in range(E)]


def _assert_matches_reference(ref, port, net=False):
    for e in range(port.E):
        assert len(port.edge_history[e]) == len(ref.edge_history[e]) \
            == ROUNDS
        for r, (a, b) in enumerate(zip(port.edge_history[e],
                                       ref.edge_history[e])):
            assert np.array_equal(a, b), f"experiment {e} round {r}"
        assert port.comm_bytes(e) == ref.comm_bytes(e)
        want = params_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x[e]), ref.params))
        for k, v in want.items():
            err = float((port.params[k][e] - v).abs().max())
            assert err <= TOL, f"experiment {e} {k}: {err}"
        if net:
            for a, b in zip(port.delivered_history[e],
                            ref.delivered_history[e]):
                assert np.array_equal(a, b)
            p, r = port.net_stats[e], ref.net_stats[e]
            assert (p["delivered"], p["dropped"], p["staleness_sum"]) == \
                (r["delivered"], r["dropped"], r["staleness_sum"])
            assert np.array_equal(p["staleness_hist"], r["staleness_hist"])
            assert port.staleness_mean(e) == ref.staleness_mean(e)


def _nets_pair(kind):
    """``(reference DenseNetworks, port SweepNetwork)`` of a case."""
    if kind == "ideal-wan-wan":
        specs, kw = [("ideal", 0), ("wan", 1), ("wan", 2)], \
            dict(round_s=1.0)
    else:           # the deep ring
        specs, kw = [("wan", 0), ("wan", 1)], \
            dict(round_s=0.05, max_staleness=4)
    ref = [jnet.DenseNetwork(jnet.profiles.get_profile(p, N, s), **kw)
           for p, s in specs]
    port = ReplaySweepNet([tnet.DenseNetwork(
        tnet.profiles.get_profile(p, N, s), **kw) for p, s in specs])
    return [s for _, s in specs], ref, port


@pytest.mark.parametrize("model", sorted(MODELS))
def test_sweep_matches_the_reference_with_a_delta_r_axis(model):
    seeds, drs = (0, 1, 2), (2, 3, 5)
    spec = SweepSpec(seeds=seeds, delta_r=drs)
    ref = _reference(model, spec, drs)
    port = _port_sweep(model, spec, drs, _ref_params(ref, len(seeds)))
    ref_logs, port_logs = ref.run(), port.run()
    _assert_matches_reference(ref, port)
    for a, b in zip(ref_logs, port_logs):
        assert [r.rnd for r in a.records] == [r.rnd for r in b.records]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kind", ["ideal-wan-wan", "deep-ring"])
def test_sweep_matches_the_reference_under_a_network(model, kind):
    seeds, ref_nets, port_net = _nets_pair(kind)
    spec = SweepSpec(seeds=tuple(seeds))
    drs = [2] * len(seeds)
    ref = _reference(model, spec, drs, ref_nets)
    port = _port_sweep(model, spec, drs, _ref_params(ref, len(seeds)),
                       net=port_net)
    assert port.net_S == ref._net_S
    ref.run()
    port.run()
    _assert_matches_reference(ref, port, net=True)


# ---------------------------------------------------------------------------
# Each experiment of a sweep is its solo run (port against port)
# ---------------------------------------------------------------------------

def _strategy(name, seed, delta_r=2):
    return {
        "morph": lambda: tcore.InGraphMorphStrategy(
            n=N, k=K, view_size=K + 2, seed=seed, delta_r=delta_r,
            device="cpu"),
        "static": lambda: tcore.InGraphStaticStrategy(n=N, degree=2,
                                                      seed=seed,
                                                      device="cpu"),
        "el-oracle": lambda: tcore.InGraphEpidemicStrategy(
            n=N, k=K, seed=seed, device="cpu"),
        "fully-connected": lambda: tcore.InGraphFullyConnectedStrategy(
            n=N, device="cpu"),
        "el-local": lambda: tcore.InGraphEpidemicLocalStrategy(
            n=N, k=K, seed=seed, device="cpu"),
    }[name]()


def _solo(name, model, seed, delta_r=2, net=None):
    init, loss = MODELS[model][2:]
    runner = DecentralizedRunner(
        init_fn=init, loss_fn=loss, eval_fn=loss, optimizer=sgd(0.05),
        batcher=DeviceDataStream(_tr, _parts, 4, seed=seed, device="cpu"),
        test_batch=_test, strategy=_strategy(name, seed, delta_r),
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=4,
                         sim_every=2, seed=seed, net=net), device="cpu")
    runner.run()
    return runner


def _sweep(name, model, spec, delta_rs=None, net=None, **kw):
    init, loss = MODELS[model][2:]
    drs = delta_rs or [2] * len(spec)
    return SweepSuperstep(
        spec=spec, init_fn=init, loss_fn=loss, eval_fn=loss,
        optimizer=sgd(0.05),
        streams=[DeviceDataStream(_tr, _parts, 4, seed=s, device="cpu")
                 for s in spec.seeds], test_batch=_test,
        strategies=[_strategy(name, s, d) for s, d in zip(spec.seeds, drs)],
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=4,
                         sim_every=2), net=net, device="cpu", **kw)


def _assert_bitwise(solo, sweep, e, net=False):
    for k, v in solo.params.items():
        assert torch.equal(v, sweep.params[k][e]), f"experiment {e} {k}"
    assert len(solo.edge_history) == len(sweep.edge_history[e]) == ROUNDS
    for a, b in zip(solo.edge_history, sweep.edge_history[e]):
        assert np.array_equal(a, b)
    assert solo._comm_bytes == sweep.comm_bytes(e)
    assert [r.mean_accuracy for r in solo.log.records] == \
        [r.mean_accuracy for r in sweep.log[e].records]
    if net:
        for a, b in zip(solo.delivered_history, sweep.delivered_history[e]):
            assert np.array_equal(a, b)
        s, w = solo.net_stats, sweep.net_stats[e]
        assert (s["delivered"], s["dropped"], s["staleness_sum"]) == \
            (w["delivered"], w["dropped"], w["staleness_sum"])
        # The sweep's histogram spans the shared ring; past the solo run's
        # depth it is empty.
        depth = len(s["staleness_hist"])
        assert np.array_equal(s["staleness_hist"],
                              w["staleness_hist"][:depth])
        assert not w["staleness_hist"][depth:].any()


@pytest.mark.parametrize("name", ["morph", "static", "el-oracle",
                                  "fully-connected", "el-local"])
def test_each_experiment_is_its_solo_run(name):
    seeds = (0, 1, 2)
    sweep = _sweep(name, "mlp", SweepSpec(seeds=seeds))
    sweep.run()
    for e, s in enumerate(seeds):
        _assert_bitwise(_solo(name, "mlp", s), sweep, e)


@pytest.mark.parametrize("delta_rs", [None, (2, 3, 5)])
def test_each_experiment_is_its_solo_run_gn_lenet(delta_rs):
    """The reduced GN-LeNet, with and without a delta_r axis: the
    ``[E n]``-stacked local step (grouped convolutions over E n groups)
    gives each experiment its solo run's bits on the CPU."""
    seeds = (0, 1, 2)
    spec = SweepSpec(seeds=seeds, delta_r=delta_rs)
    sweep = _sweep("morph", "cnn", spec, delta_rs)
    sweep.run()
    for e, s in enumerate(seeds):
        _assert_bitwise(_solo("morph", "cnn", s,
                              2 if delta_rs is None else delta_rs[e]),
                        sweep, e)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_stacked_local_step_is_each_experiments_step(model):
    """One local step of the ``[E n]`` stack against each experiment's own
    step of its n rows, from the same parameters and batch: bit for bit."""
    sweep = _sweep("morph", model, SweepSpec(seeds=(0, 1, 2, 3)))
    batch = sweep._batch(3)
    stacked, _ = sweep._step(batch)
    for e in range(sweep.E):
        own, _ = sweep._local_step(sweep.experiment_params(e),
                                   sweep._opt_state,
                                   {k: v[e] for k, v in batch.items()})
        for k, v in own.items():
            assert torch.equal(stacked[k][e * N:(e + 1) * N], v), (e, k)


@pytest.mark.parametrize("name", ["morph", "static"])
def test_each_experiment_is_its_solo_run_under_a_network(name):
    """Mixed depths (2 and 1): the shallower experiment clamps to its own
    depth in the deeper shared ring and still gets its solo bits."""
    seeds = (0, 1, 2)
    nets = [tnet.DenseNetwork(tnet.profiles.wan(seed=0), round_s=0.05,
                              max_staleness=4),
            tnet.DenseNetwork(tnet.profiles.ideal(), round_s=0.05),
            tnet.DenseNetwork(tnet.profiles.flaky_wan(N, seed=2),
                              round_s=0.05, max_staleness=2)]
    sweep = _sweep(name, "mlp", SweepSpec(seeds=seeds),
                   net=tnet.SweepNetwork(nets))
    sweep.run()
    assert sweep.net_S > min(tnet.SweepNetwork(nets).depths(
        sweep._model_bytes))
    for e, (s, net) in enumerate(zip(seeds, nets)):
        _assert_bitwise(_solo(name, "mlp", s, net=net), sweep, e, net=True)


def test_beta_axis_gives_each_experiment_its_solo_beta():
    seeds, betas = (0, 0, 1), (500.0, 2.0, 0.5)
    sweep = _sweep("morph", "mlp", SweepSpec(seeds=seeds, beta=betas))
    sweep.run()
    for e, (s, b) in enumerate(zip(seeds, betas)):
        solo = _solo("morph", "mlp", s)
        assert solo.strategy.beta == 500.0
        solo_b = DecentralizedRunner(
            init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
            optimizer=sgd(0.05),
            batcher=DeviceDataStream(_tr, _parts, 4, seed=s, device="cpu"),
            test_batch=_test, strategy=tcore.InGraphMorphStrategy(
                n=N, k=K, view_size=K + 2, seed=s, delta_r=2, beta=b,
                device="cpu"),
            cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=4,
                             sim_every=2, seed=s), device="cpu")
        solo_b.run()
        _assert_bitwise(solo_b, sweep, e)


def test_run_steps_and_chunks_keep_the_trajectory():
    spec = SweepSpec(seeds=(0, 1))
    a = _sweep("morph", "mlp", spec)
    a.run_steps(ROUNDS)
    b = _sweep("morph", "mlp", spec, chunk=3)
    b.run()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert all(np.array_equal(x, y) for x, y in
               zip(a.edge_history[1], b.edge_history[1]))
    assert [len(log.records) for log in b.log] == [3, 3]


# ---------------------------------------------------------------------------
# The batched controller
# ---------------------------------------------------------------------------

def _controller_inputs(E, n, seed):
    rng = np.random.default_rng(seed)
    recv = torch.as_tensor(rng.normal(size=(E, n, n)).astype(np.float32))
    send = torch.as_tensor(rng.normal(size=(E, n, n)).astype(np.float32))
    cand = torch.as_tensor(rng.random((E, n, n)) < np.linspace(
        0.2, 0.9, E)[:, None, None])
    return recv, send, cand


def _sweeps_to_converge(recv, send, cand, k):
    """The least sweep bound at which a solo matching reaches its final
    edges."""
    final = match_dense(recv, send, cand, k, k)
    for r in range(1, 10 ** 4):
        if torch.equal(match_dense(recv, send, cand, k, k, rounds=r), final):
            return r


def test_batched_matching_is_each_solo_call():
    E, n, k = 6, 24, 3
    recv, send, cand = _controller_inputs(E, n, 0)
    batched = match_dense(recv, send, cand, k, k)
    sweeps = [_sweeps_to_converge(recv[e], send[e], cand[e], k)
              for e in range(E)]
    assert len(set(sweeps)) > 1, sweeps    # they converge at other sweeps
    for e in range(E):
        assert torch.equal(batched[e], match_dense(recv[e], send[e],
                                                   cand[e], k, k))


def test_batched_update_topology_is_each_solo_call():
    """Two negotiations of E experiments at once (the first with a beta
    an experiment, the second from the first's estimates) against each
    experiment's own two calls, each drawing from its own generator."""
    E, n, k, view = 4, 12, 3, 5
    rng = np.random.default_rng(1)
    adjs, sims = [], []
    for e in range(E):
        adjs.append(torch.as_tensor(np.roll(np.eye(n, dtype=bool), 1, 1)
                                    | (rng.random((n, n)) < 0.1 * (e + 1))))
        sims.append(torch.as_tensor(rng.uniform(-1, 1, (n, n))
                                    .astype(np.float32)))
    betas = (500.0, 5.0, 0.5, 50.0)
    solo = []
    for adj, sim, beta, e in zip(adjs, sims, betas, range(E)):
        st = update_topology(init_state(adj, seed=e), sim, k, view, beta)
        solo.append(update_topology(st, sim, k, view, 500.0))
    stacked = stack_states([init_state(adj, seed=e)
                            for e, adj in enumerate(adjs)])
    sim = torch.stack(sims)
    got = update_topology(stacked, sim, k, view, torch.tensor(betas))
    got = update_topology(got, sim, k, view, 500.0)
    for e in range(E):
        for field in ("known", "sim", "sim_valid", "edges"):
            assert torch.equal(getattr(got, field)[e],
                               getattr(solo[e], field)), (e, field)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_refusals():
    spec = SweepSpec(seeds=(0, 1))
    with pytest.raises(ValueError, match="'exp', 'data'"):
        _sweep("morph", "mlp", spec, mesh=object())
    sparse = tcore.InGraphMorphStrategy(n=N, k=K, device="cpu")
    sparse.sparse = True
    with pytest.raises(TypeError, match="sparse"):
        SweepSuperstep(
            spec=spec, init_fn=mlp_params, loss_fn=mlp_loss,
            eval_fn=mlp_loss, optimizer=sgd(0.05),
            streams=[DeviceDataStream(_tr, _parts, 4, seed=s, device="cpu")
                     for s in spec.seeds], test_batch=_test,
            strategies=[sparse, sparse],
            cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS), device="cpu")
    mixed = [_strategy("morph", 0), _strategy("el-oracle", 1)]
    for kw, err, match in (
            (dict(strategies=mixed), TypeError, "same strategy class"),
            (dict(cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS,
                                   compress="int8")), ValueError,
             "compressed"),
            (dict(streams=[DeviceDataStream(_tr, _parts, 4,
                                            device="cpu")]), ValueError,
             "streams")):
        base = dict(spec=spec, init_fn=mlp_params, loss_fn=mlp_loss,
                    eval_fn=mlp_loss, optimizer=sgd(0.05),
                    streams=[DeviceDataStream(_tr, _parts, 4, seed=s,
                                              device="cpu")
                             for s in spec.seeds], test_batch=_test,
                    strategies=[_strategy("morph", s) for s in spec.seeds],
                    cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS),
                    device="cpu")
        base.update(kw)
        with pytest.raises(err, match=match):
            SweepSuperstep(**base)
    hp = SweepSpec(seeds=(0, 1), delta_r=(2, 3))
    with pytest.raises(TypeError, match="sweep_graph_round"):
        _sweep("static", "mlp", hp)


# ---------------------------------------------------------------------------
# The script
# ---------------------------------------------------------------------------

SMOKE = ["--seeds", "2", "--rounds", "4", "--eval-every", "2",
         "--timing-rounds", "2", "--timing-repeats", "1", "--device", "cpu"]


def test_fig14_writes_schema(tmp_path):
    """``fig14`` at smoke depth in a fresh interpreter, which must not
    have loaded JAX by the end."""
    code = ("import sys\n"
            "from repro_torch.bench import fig14\n"
            f"fig14.main({SMOKE!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", BENCH_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = json.loads((tmp_path / "BENCH_torch_fig14.json").read_text())
    assert data["schema_version"] == 1 and data["backend"] == "cpu"
    recs = {r["key"]: r for r in data["records"]}
    assert recs["acceptance/bitwise_vs_singles"]["value"] == 1
    assert recs["acceptance/trajectories"]["value"] == 4
    assert recs["meta/hlo"]["value"] == "none"
    assert not any("hlo" in r for r in data["records"])
    for name in ("morph", "static", "el-oracle"):
        for e in range(4):
            fid = recs[f"{name}/e{e}"]["fidelity"]
            assert 0.0 <= fid["accuracy"] <= 1.0
            assert fid["profile"] == ("ideal", "wan")[e // 2]
        assert f"{name}/agg_mean" in recs
    for key in ("sweep/morph_ms_per_round", "seq/morph_ms_per_round",
                "derived/speedup"):
        assert float(recs[key]["value"]) > 0
    assert recs["sweep/morph_ms_per_round"]["shape"]["sweep"] == 4
