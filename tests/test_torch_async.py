"""The event-driven runtime on the port against the reference's, and its
lockstep property.

Reference side: ``repro.netsim``'s ``EventLoop``, ``Transport`` and
``AsyncRunner`` (GN-LeNet width 8 on 8-pixel images, ``tests/
test_netsim.py``'s ``_experiment`` shape).  Port side: ``repro_torch.netsim``
on the CPU from the same initial parameters (``params_from_jax``), the same
host batches and the reference's keyed network uniforms replayed through
``draws=`` (``tests/_jax_draws.py`` ``net_draws``); in-graph Morph gets the
reference's negotiation draws.

Tolerances: the event schedule, the edges, the transport's counters, the
staleness histogram and every other counter are identical; parameters
within 1e-4 (the two sides round the local step in other orders).  Under
an ideal network the port's ``AsyncRunner`` is the port's host loop bit
for bit (DESIGN.md §4).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402

import benchmarks.common as jcommon                          # noqa: E402
import repro.core as jcore                                   # noqa: E402
import repro.netsim as jnet                                  # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.netsim as tnet                            # noqa: E402
from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification, train_test_split)
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.models.cnn import cnn_loss as jax_cnn_loss        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.bench import common                         # noqa: E402
from repro_torch.data import StackedBatcher                  # noqa: E402
from repro_torch.dlrt import (DecentralizedRunner,           # noqa: E402
                              NetMetricsLog, NetRecord, RunnerConfig)
from repro_torch.models import cnn_loss, cnn_params          # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import morph_draws, net_draws                # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


# ---------------------------------------------------------------------------
# EventLoop
# ---------------------------------------------------------------------------

def _drive_loop(pkg, until=None, max_events=None):
    """A seeded schedule with ties in time, phase and kind, handlers that
    schedule follow-ups (some at zero delay), and the clock's trace."""
    rng = np.random.default_rng(0)
    loop = pkg.EventLoop()
    for i in range(40):
        loop.schedule(float(rng.choice([0.0, 0.5, 1.0, 1.5])),
                      str(rng.choice(["a", "b"])), i,
                      phase=int(rng.integers(0, 3)))
    seen = []

    def handler(batch):
        seen.append([(e.time, e.phase, e.seq, e.kind, e.payload)
                     for e in batch])
        for e in batch:
            if e.payload is not None and e.payload % 3 == 0 \
                    and e.payload < 1000:
                loop.schedule(float(e.payload % 2) * 0.25, "c",
                              e.payload + 1000, phase=e.phase)
    loop.run(handler, until=until, max_events=max_events)
    return seen, loop.now, loop.processed, len(loop._heap)


@pytest.mark.parametrize("until,max_events", [(None, None), (1.0, None),
                                              (None, 25)],
                         ids=["drain", "until", "max-events"])
def test_event_loop_is_the_reference_loop(until, max_events):
    """The same schedule pops in the same order, in the same coalesced
    batches, to the same clock and count, whole or cut short."""
    want = _drive_loop(jnet, until, max_events)
    got = _drive_loop(tnet, until, max_events)
    assert got == want
    assert len(got[0]) < sum(len(b) for b in got[0])    # batches coalesced


def test_event_loop_refuses_the_past():
    for pkg in (jnet, tnet):
        loop = pkg.EventLoop()
        loop.schedule(1.0, "x")
        loop.run(lambda b: None)
        with pytest.raises(ValueError):
            loop.schedule_at(0.5, "y")
        ev = loop.schedule_at(1.0, "z", phase=2)
        assert (ev.time, ev.phase, ev.kind) == (1.0, 2, "z")


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

N_TR = 8
TRANSPORT_CASES = {
    "lan": (dict(name="lan", base_latency_s=2e-4, jitter_s=1e-4,
                 bandwidth_bps=10e9, seed=3), None),
    "wan": (dict(name="wan", base_latency_s=0.04, jitter_s=0.02,
                 bandwidth_bps=200e6, seed=0), None),
    "flaky-wan-partition-churn": (
        dict(name="flaky-wan", base_latency_s=0.08, jitter_s=0.06,
             bandwidth_bps=50e6, drop_rate=0.3, seed=1,
             partitions=[dict(start=1.0, end=2.0,
                              groups=(frozenset(range(4)),
                                      frozenset(range(4, 8))))]),
        dict(churn_fraction=0.25, mean_downtime_s=1.0, horizon_s=3.0,
             seed=2)),
}


def _profile(pkg, spec):
    spec = dict(spec)
    parts = spec.pop("partitions", ())
    return pkg.NetworkProfile(
        partitions=tuple(pkg.Partition(**p) for p in parts), **spec)


def _drive_transport(pkg, spec, faults):
    """Ticks every 0.25 s for 3 s; each sends a seeded mix of model and
    control messages with and without a round; deliveries are
    acknowledged.  Returns every send's outcome, every delivery and the
    final stats."""
    profile = _profile(pkg, spec)
    fm = None if faults is None else pkg.FaultModel(
        pkg.FaultConfig(**faults), N_TR)
    loop = pkg.EventLoop()
    kw = dict(draws=lambda rnd, stream: net_draws(profile.seed, rnd, N_TR,
                                                  stream)) \
        if pkg is tnet else {}
    tr = pkg.Transport(profile, loop, faults=fm, n_nodes=N_TR, **kw)
    rng = np.random.default_rng(5)
    for k in range(12):
        loop.schedule_at(0.25 * k, "tick", k, phase=0)
    log = []

    def handler(batch):
        for ev in batch:
            if ev.kind == "tick":
                for _ in range(10):
                    src, dst = (int(x) for x in rng.choice(N_TR, 2,
                                                           replace=False))
                    kind = str(rng.choice(["model", "request", "accept"]))
                    size = 379_432 if kind == "model" else 64
                    rnd = None if rng.random() < 0.3 else ev.payload // 3
                    pkt = tr.send(src, dst, kind, None, size, phase=1,
                                  rnd=rnd)
                    log.append(("send", loop.now, src, dst, kind, rnd,
                                None if pkt is None else pkt.deliver_at))
            else:
                tr.delivered(ev.payload)
                log.append(("deliver", loop.now, ev.payload.src,
                            ev.payload.dst, ev.payload.kind))
    loop.run(handler)
    return log, dataclasses.asdict(tr.stats), loop.processed


@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_is_the_reference_transport(case):
    """Sends with and without a round under LAN, WAN and a lossy WAN with
    a partition window and churn: the same delivery times, the same drops
    and the same stats field by field."""
    spec, faults = TRANSPORT_CASES[case]
    want = _drive_transport(jnet, spec, faults)
    got = _drive_transport(tnet, spec, faults)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[1]["in_flight"] == 0 and got[1]["delivered"] > 0
    if spec.get("drop_rate"):
        assert got[1]["dropped"] > 0


def test_transport_keys_by_round_on_the_cpu_generator():
    """Without replayed draws a send that names its round reads the keyed
    matrices of ``netsim.sampling`` (the dense model's draws): the same
    delay for the same (round, edge) whatever else was sent, and a
    sequential-RNG delay without a round."""
    prof = tnet.profiles.wan(seed=4)
    jit = tnet.sampling.jitter_matrix(prof, 2, N_TR, "cpu").numpy()
    for warmup in (0, 5):
        loop = tnet.EventLoop()
        tr = tnet.Transport(prof, loop, n_nodes=N_TR)
        for _ in range(warmup):
            tr.send(0, 1, "model", None, 64, rnd=7)
            tr.send(0, 1, "model", None, 64)
        pkt = tr.send(3, 5, "model", None, 1000, rnd=2)
        assert pkt.deliver_at == prof.base_latency_s + float(jit[5, 3]) \
            + prof.transfer_seconds(1000)
    seq = tnet.Transport(prof, tnet.EventLoop()).send(3, 5, "model", None,
                                                      1000)
    rng = np.random.default_rng(prof.seed)
    assert seq.deliver_at == prof.base_latency_s \
        + float(rng.uniform(0.0, prof.jitter_s)) + prof.transfer_seconds(1000)


# ---------------------------------------------------------------------------
# AsyncRunner against the reference's
# ---------------------------------------------------------------------------

def _experiment(n):
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    return tr, parts, {"images": te.images, "labels": te.labels}


class ReplayMorph(tcore.InGraphMorphStrategy):
    """Port in-graph Morph fed the reference's negotiation draws."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._draws = iter(morph_draws(0, self.n, 8))

    def graph_round(self, gstate, rnd, sim, noise=None):
        if rnd % self.delta_r == 0:
            noise = next(self._draws)
        return super().graph_round(gstate, rnd, sim, noise=noise)


def _strategies(name, n):
    """(reference strategy, port strategy) of one name."""
    k = 2
    jexp = jcommon.ExpConfig(n_nodes=n, k=k, seed=0)
    texp = common.ExpConfig(n_nodes=n, k=k, seed=0)
    if name == "ingraph-morph":
        return (jcore.InGraphMorphStrategy(n=n, k=k, view_size=4, seed=0),
                ReplayMorph(n=n, k=k, view_size=4, seed=0, device="cpu"))
    return jcommon.make_strategy(name, jexp), common.make_strategy(name,
                                                                   texp)


def _flaky(pkg, n, rounds):
    """``tests/test_netsim.py``'s ``_flaky_setup``: flaky-WAN with a
    partition at 0.3 of the horizon for 0.2 of it, stragglers and churn,
    built by ``pkg``."""
    horizon = rounds * 1.5
    profile = pkg.profiles.flaky_wan(n, partition_at=horizon * 0.3,
                                     partition_len=horizon * 0.2, seed=1)
    faults = pkg.FaultModel(pkg.FaultConfig(
        straggler_fraction=0.25, straggler_slowdown=2.0,
        churn_fraction=0.25, crash_fraction=0.0, mean_downtime_s=3.0,
        horizon_s=horizon, seed=2), n)
    return profile, faults


def _network(pkg, regime, n, rounds):
    if regime == "ideal":
        return pkg.profiles.ideal(), None
    if regime == "wan":
        return pkg.profiles.wan(), None
    return _flaky(pkg, n, rounds)


def _async_pair(name, regime, n, rounds, eval_every=4, mix_timeout_s=None):
    """The reference's ``AsyncRunner`` and the port's on the same set-up,
    not run."""
    tr, parts, test = _experiment(n)
    jstrat, tstrat = _strategies(name, n)
    jprof, jfaults = _network(jnet, regime, n, rounds)
    tprof, tfaults = _network(tnet, regime, n, rounds)
    ref = jnet.AsyncRunner(
        init_fn=lambda key: jax_cnn_params(key, in_channels=3,
                                           num_classes=4, image_size=8,
                                           width=8),
        loss_fn=jax_cnn_loss, eval_fn=jax_cnn_loss, optimizer=jax_sgd(0.05),
        batcher=JaxBatcher(tr, parts, 8, seed=3), test_batch=test,
        strategy=jstrat,
        cfg=jnet.AsyncConfig(n_nodes=n, rounds=rounds, eval_every=eval_every,
                             compute_time_s=1.0,
                             mix_timeout_s=mix_timeout_s),
        profile=jprof, faults=jfaults)
    port = tnet.AsyncRunner(
        init_fn=None, loss_fn=cnn_loss, eval_fn=cnn_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=tstrat,
        cfg=tnet.AsyncConfig(n_nodes=n, rounds=rounds,
                             eval_every=eval_every, compute_time_s=1.0,
                             mix_timeout_s=mix_timeout_s),
        profile=tprof, faults=tfaults,
        params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      ref.params)),
        device="cpu",
        draws=lambda rnd, stream: net_draws(tprof.seed, rnd, n, stream))
    return ref, port


NET_FIELDS = ("t", "rnd", "model_bytes", "control_bytes",
              "messages_in_flight", "dropped", "dead", "staleness_mean")


def assert_async_matches(ref, port):
    assert len(port.edge_history) == len(ref.edge_history) > 0
    for r, (a, b) in enumerate(zip(ref.edge_history, port.edge_history)):
        assert np.array_equal(a, b), f"edges diverged at round {r}"
    assert port.realized_indegrees == ref.realized_indegrees
    assert port.netlog.staleness_hist == ref.netlog.staleness_hist
    assert (port.late_discards, port.unavailable_sends, port.dead,
            port.truncated) == (ref.late_discards, ref.unavailable_sends,
                                ref.dead, ref.truncated)
    assert (port.loop.processed, port.loop.now) == \
        (ref.loop.processed, ref.loop.now)
    assert dataclasses.asdict(port.transport.stats) == \
        dataclasses.asdict(ref.transport.stats)
    assert len(port.netlog.records) == len(ref.netlog.records) > 0
    for a, b in zip(ref.netlog.records, port.netlog.records):
        assert [getattr(b, f) for f in NET_FIELDS] == \
            [getattr(a, f) for f in NET_FIELDS]
        assert b.mean_accuracy == pytest.approx(a.mean_accuracy, abs=TOL)
        assert b.mean_loss == pytest.approx(a.mean_loss, abs=TOL)
    for a, b in zip(ref.log.records, port.log.records):
        assert (a.rnd, a.comm_bytes, a.isolated) == \
            (b.rnd, b.comm_bytes, b.isolated)
    if hasattr(ref.strategy, "control_messages"):
        assert (port.strategy.control_messages,
                port.strategy.similarity_floats) == \
            (ref.strategy.control_messages, ref.strategy.similarity_floats)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params))
    assert list(port.params) == list(want)
    for key in want:
        np.testing.assert_allclose(port.params[key].numpy(),
                                   want[key].numpy(), atol=TOL, err_msg=key)


ASYNC_CASES = [("morph", "ideal", 6, 11), ("el-oracle", "ideal", 6, 8),
               ("static", "ideal", 6, 8), ("fully-connected", "ideal", 6, 8),
               ("ingraph-morph", "ideal", 6, 11),
               ("el-oracle", "wan", 6, 8), ("morph", "wan", 6, 11),
               ("morph", "flaky-wan", 8, 10),
               ("ingraph-morph", "flaky-wan", 6, 8)]


@pytest.mark.parametrize("name,regime,n,rounds", ASYNC_CASES,
                         ids=[f"{r}-{s}" for s, r, _, _ in ASYNC_CASES])
def test_async_runner_is_the_reference_async_runner(name, regime, n,
                                                    rounds):
    """The reference's ``AsyncRunner`` and the port's under the ideal
    network, WAN and flaky-WAN with a partition, stragglers and churn
    (mix deadline 2 s): the same events, edges, counters, staleness and
    records; parameters within 1e-4."""
    ref, port = _async_pair(name, regime, n, rounds,
                            mix_timeout_s=2.0 if regime == "flaky-wan"
                            else None)
    ref.run()
    port.run()
    assert_async_matches(ref, port)
    if regime != "ideal":
        assert port.netlog.staleness_hist != {0: sum(
            port.netlog.staleness_hist.values())}   # the network did bite
    if regime == "flaky-wan":
        assert port.transport.stats.dropped > 0


# ---------------------------------------------------------------------------
# The port's own lockstep property (DESIGN.md §4)
# ---------------------------------------------------------------------------

LOCKSTEP = ("morph", "static", "el-oracle", "fully-connected",
            "ingraph-morph")


def _port_runner(cls, name, n, rounds, **kw):
    tr, parts, test = _experiment(n)
    exp = common.ExpConfig(n_nodes=n, k=2, seed=0)
    strategy = common.make_ingraph_strategy("morph", exp, "cpu") \
        if name == "ingraph-morph" else common.make_strategy(name, exp)
    base = dict(init_fn=lambda g: cnn_params(g, in_channels=3,
                                             num_classes=4, image_size=8,
                                             width=8),
                loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.05),
                batcher=StackedBatcher(tr, parts, 8, seed=3),
                test_batch=test, strategy=strategy, device="cpu")
    if cls is DecentralizedRunner:
        return cls(cfg=RunnerConfig(n_nodes=n, rounds=rounds, eval_every=5,
                                    compiled=False), **base)
    return cls(cfg=tnet.AsyncConfig(n_nodes=n, rounds=rounds, eval_every=5,
                                    compute_time_s=1.0), **base, **kw)


@pytest.mark.parametrize("name", LOCKSTEP)
def test_ideal_async_runner_is_the_host_loop_bit_for_bit(monkeypatch, name):
    """Under the ideal network every event batch covers the population, so
    the port's ``AsyncRunner`` takes the host loop's stacked paths: the
    same edges, parameters bit for bit, the same records, one grouped mix
    a round and no per-node mix."""
    n, rounds = 6, 11                    # negotiations at 0, 5 and 10
    sync = _port_runner(DecentralizedRunner, name, n, rounds)
    sync.run()
    asyn = _port_runner(tnet.AsyncRunner, name, n, rounds,
                        profile=tnet.profiles.ideal())
    mixes = []
    real_mix = asyn._mix
    monkeypatch.setattr(asyn, "_mix", lambda e, w: mixes.append(1)
                        or real_mix(e, w))
    monkeypatch.setattr(asyn, "_mix_one", lambda i, r: pytest.fail(
        f"per-node mix of node {i} in round {r}"))
    asyn.run()
    assert len(sync.edge_history) == len(asyn.edge_history) == rounds
    for r, (a, b) in enumerate(zip(sync.edge_history, asyn.edge_history)):
        assert np.array_equal(a, b), f"edges diverged at round {r}"
    for key in sync.params:
        assert torch.equal(sync.params[key], asyn.params[key]), key
    assert len(mixes) == rounds
    assert [(r.rnd, r.mean_accuracy, r.mean_loss, r.comm_bytes, r.isolated)
            for r in asyn.log.records] == \
        [(r.rnd, r.mean_accuracy, r.mean_loss, r.comm_bytes, r.isolated)
         for r in sync.log.records]
    assert [r.t for r in asyn.netlog.records] == [1.0, 6.0, 11.0]
    if name == "morph":
        assert (sync.strategy.control_messages,
                sync.strategy.similarity_floats) == \
            (asyn.strategy.control_messages, asyn.strategy.similarity_floats)


def test_partial_compute_keeps_only_the_live_rows():
    """A compute batch short of the population steps the whole stack on
    the live nodes' batches (the others' rows on the first live node's)
    and keeps the new values in the live rows only."""
    n = 6
    runner = _port_runner(tnet.AsyncRunner, "el-oracle", n, 3)
    before = {k: v.clone() for k, v in runner.params.items()}
    ev = [tnet.Event(time=1.0, phase=0, seq=s, kind="compute",
                     payload=(i, 0)) for s, i in enumerate((1, 4))]
    runner._on_compute(ev)
    for key, v in runner.params.items():
        for i in range(n):
            same = torch.equal(v[i], before[key][i])
            assert same == (i not in (1, 4)), (key, i)
    assert runner._clean[0] is False
    assert list(runner._version) == [0, 1, 0, 0, 1, 0]
    assert runner.opt_state["count"].ndim == 0


# ---------------------------------------------------------------------------
# Ports of the reference's own async tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n,rounds", [("morph", 8, 10),
                                           ("ingraph-morph", 6, 8)])
def test_async_morph_indegree_bounded_under_churn(name, n, rounds):
    """Fixed in-degree <= k survives drops, a partition, stragglers and
    churn, for the message-faithful protocol and for in-graph Morph."""
    profile, faults = _flaky(tnet, n, rounds)
    runner = _port_runner(tnet.AsyncRunner, name, n, rounds,
                          profile=profile, faults=faults)
    runner.acfg.mix_timeout_s = 2.0
    log = runner.run()
    assert runner.edge_history, "no rounds completed"
    for edges in runner.edge_history:
        assert (tcore.in_degrees(edges) <= 2).all()
    assert max(runner.realized_indegrees) <= 2
    assert runner.transport.stats.in_flight == 0
    assert not runner.truncated
    if name == "morph":
        assert runner.transport.stats.dropped > 0
        assert log.records and log.staleness_hist


def test_async_wallclock_metrics_progress():
    """WAN latency shows in the virtual clock, the accuracy improves and
    time-to-accuracy is queryable."""
    n, rounds = 6, 8
    runner = _port_runner(tnet.AsyncRunner, "el-oracle", n, rounds,
                          profile=tnet.profiles.wan())
    runner.cfg.eval_every = 4
    runner._eval_rounds = [0, 4, rounds - 1]
    log = runner.run()
    assert len(log.records) == 3
    ts = [r.t for r in log.records]
    assert ts == sorted(ts) and ts[-1] > rounds * 1.0
    assert log.records[-1].model_bytes > 0
    first = log.records[0].mean_accuracy
    assert log.best_accuracy() >= first
    tta = log.time_to_accuracy(first)
    assert tta is not None and tta <= ts[0]
    arrays = log.as_arrays()
    assert list(arrays["t"]) == ts and len(arrays["dropped"]) == 3


@pytest.mark.parametrize("name", ["morph", "el-oracle"])
def test_total_loss_completes_every_round(name):
    """``drop_rate = 1.0``: every message lost, every round still
    completes, nothing is left in flight and no node mixes a model."""
    n, rounds = 6, 6
    runner = _port_runner(tnet.AsyncRunner, name, n, rounds,
                          profile=tnet.NetworkProfile(name="lossy",
                                                      drop_rate=1.0))
    runner.run()
    assert not runner.truncated
    assert len(runner.realized_indegrees) == n * rounds
    assert set(runner.realized_indegrees) == {0}
    assert runner.transport.stats.in_flight == 0
    assert runner.transport.stats.dropped == runner.transport.stats.sent > 0
    assert list(runner._completed) == [rounds - 1] * n


def test_net_metrics_log_is_the_reference_log():
    rows = [(1.0, 0, 0.2, 1.5, 3.0, 100, 64, 2, 0, 1, 0.0),
            (5.5, 4, 0.45, 1.2, 2.0, 600, 128, 0, 3, 0, 0.5),
            (9.0, 7, 0.4, 1.1, 1.0, 1100, 192, 1, 4, 2, 0.25)]
    from repro.dlrt.metrics import NetMetricsLog as JaxLog
    from repro.dlrt.metrics import NetRecord as JaxRecord
    ref, port = JaxLog(), NetMetricsLog()
    for row in rows:
        ref.add(JaxRecord(*row))
        port.add(NetRecord(*row))
    for age in (0, 1, 1, -1, 3):
        ref.observe_staleness(age)
        port.observe_staleness(age)
    assert port.staleness_hist == ref.staleness_hist
    assert port.staleness_mean() == ref.staleness_mean()
    for target in (0.1, 0.3, 0.45, 0.9):
        assert port.time_to_accuracy(target) == ref.time_to_accuracy(target)
    assert port.best_accuracy() == ref.best_accuracy()
    want, got = ref.as_arrays(), port.as_arrays()
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# The benchmark scripts
# ---------------------------------------------------------------------------

SMOKE = {"fig8": ["--nodes", "4", "--rounds", "3", "--device", "cpu"],
         "fig11": ["--nodes", "6", "--rounds", "4", "--device", "cpu"]}


def test_bench_scripts_write_schema(tmp_path):
    """``fig8`` and ``fig11`` at smoke depth in a fresh interpreter, which
    must not have loaded JAX by the end."""
    code = ("import sys\n"
            "from repro_torch.bench import fig8, fig11\n"
            + "".join(f"{name}.main({argv!r})\n"
                      for name, argv in SMOKE.items())
            + "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
              "             in ('jax', 'jaxlib', 'repro'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, BENCH_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = {}
    for name in SMOKE:
        data = json.loads((tmp_path / f"BENCH_torch_{name}.json")
                          .read_text())
        assert data["schema_version"] == 1 and data["backend"] == "cpu"
        assert "jax" not in data
        recs[name] = {r["key"]: r for r in data["records"]}
    fig8 = recs["fig8"]
    for profile in ("lan", "wan", "flaky-wan"):
        for strategy in ("morph", "static", "el-oracle"):
            key = f"{profile}/{strategy}"
            assert 0.0 <= fig8[f"{key}/final_acc"]["value"] <= 1.0
            assert fig8[f"{key}/virtual_s"]["value"] >= 3.0
    assert fig8["wan/morph/control_kbytes"]["value"] > 0
    assert fig8["flaky-wan/morph/dropped_msgs"]["value"] > 0
    fig11 = recs["fig11"]
    ratios = {}
    for profile in ("ideal", "wan", "flaky-wan"):
        for strategy in ("morph", "static", "el-oracle"):
            key = f"{profile}/{strategy}/n6"
            fid = fig11[f"{key}/fused_rounds_per_sec"]["fidelity"]
            assert set(fid) == {"fused_drop_frac", "async_drop_frac",
                                "fused_staleness_mean",
                                "async_staleness_mean", "fused_final_acc",
                                "async_final_acc"}
            assert "hlo" not in fig11[f"{key}/fused_rounds_per_sec"]
            ratios[key] = fig11[f"{key}/fused_over_async"]["ratio"]
            if profile == "ideal":
                assert fid["fused_drop_frac"] == fid["async_drop_frac"] == 0
                assert fid["async_staleness_mean"] == 0
    worst = min(ratios, key=ratios.get)
    assert fig11["derived/min_fused_over_async"]["value"] == \
        f"{ratios[worst]:.1f} ({worst})"
