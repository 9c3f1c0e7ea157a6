"""The port's network model (``repro_torch.netsim``) against the reference's
(``repro.netsim``) on the CPU.

Tolerance: none anywhere in this file.  The profiles, ring depths and fault
timelines are host arithmetic and numpy draws the port copies, and the
keyed matrices, fed the reference's uniforms (``tests/_jax_draws.py``
``net_draws``), are the same f32 operations, so every comparison is exact.
The reference's engine computes a round's matrices inside a jitted scan
from a traced round index, and the targets are taken from there: the
partition clock ``rnd * round_s`` is f32.  The one place the engine
differs from the reference's own eager functions is the division of the
delay by ``round_s``, which XLA turns into a reciprocal product; the port
divides (``test_staleness_divides_by_round_s``).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.netsim as jnet                                  # noqa: E402
import repro_torch.netsim as tnet                            # noqa: E402
from repro.netsim import profiles as jprof                   # noqa: E402
from repro.netsim import sampling as jsamp                   # noqa: E402
from repro_torch import fold_seed                            # noqa: E402
from repro_torch.netsim import profiles as tprof             # noqa: E402
from repro_torch.netsim import sampling as tsamp             # noqa: E402

from _jax_draws import net_draws, net_round_draws            # noqa: E402

CPU = torch.device("cpu")


def _both(kind, **kw):
    """The same profile built by each package."""
    make = {"ref": jnet.NetworkProfile, "port": tnet.NetworkProfile}
    parts = kw.pop("partitions", ())
    return tuple(make[side](partitions=tuple(
        (jnet.Partition if side == "ref" else tnet.Partition)(**p)
        for p in parts), **kw) for side in ("ref", "port"))


LOSSY = dict(name="lossy", base_latency_s=1.4, jitter_s=0.5,
             bandwidth_bps=1e8, drop_rate=0.05, seed=7)
PARTITIONED = dict(name="part", base_latency_s=0.2, jitter_s=0.3,
                   drop_rate=0.1, seed=5,
                   partitions=[dict(start=0.9, end=1.8,
                                    groups=(frozenset({0, 1, 2}),
                                            frozenset({3, 4})))])


# ---------------------------------------------------------------------------
# profiles, transfer times, ring depths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ideal", "lan", "wan", "flaky-wan"])
def test_profiles_match_reference(name):
    want = jprof.get_profile(name, 10, seed=4)
    got = tprof.get_profile(name, 10, seed=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for size in (0, 1, 94_898, 379_432, 10**9):
        assert got.transfer_seconds(size) == want.transfer_seconds(size)


def test_profile_constructors_match_reference():
    for at, length in ((None, 0.0), (3.0, 0.0), (2.5, 4.25)):
        want = jprof.flaky_wan(11, partition_at=at, partition_len=length)
        got = tprof.flaky_wan(11, partition_at=at, partition_len=length)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError) as port_err:
        tprof.get_profile("dialup", 4)
    with pytest.raises(ValueError) as ref_err:
        jprof.get_profile("dialup", 4)
    assert str(port_err.value) == str(ref_err.value)
    want = jprof.churny_faults(12, 40.0, seed=2)
    got = tprof.churny_faults(12, 40.0, seed=2)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    net_w = jprof.dense_network("wan", 8, round_s=0.5, max_staleness=3)
    net_g = tprof.dense_network("wan", 8, round_s=0.5, max_staleness=3)
    assert isinstance(net_g, tnet.DenseNetwork)
    assert dataclasses.asdict(net_g.profile) == \
        dataclasses.asdict(net_w.profile)
    assert (net_g.round_s, net_g.max_staleness) == \
        (net_w.round_s, net_w.max_staleness)


@pytest.mark.parametrize("name", ["ideal", "lan", "wan", "flaky-wan"])
@pytest.mark.parametrize("round_s", [1.0, 0.3, 0.05, 0.01])
@pytest.mark.parametrize("max_staleness", [1, 5, 8])
def test_depth_matches_reference(name, round_s, max_staleness):
    for size in (0, 83_042, 94_898, 379_432):
        want = jnet.DenseNetwork(jprof.get_profile(name, 6), round_s=round_s,
                                 max_staleness=max_staleness).depth(size)
        got = tnet.DenseNetwork(tprof.get_profile(name, 6), round_s=round_s,
                                max_staleness=max_staleness).depth(size)
        assert got == want, size


def test_depth_of_the_flaky_wan_deep_ring():
    """flaky-WAN at round_s = 0.05: the worst delay of a GN-LeNet payload
    (0.08 + 0.06 + 379,432 B at 50 Mb/s = 0.2007 s) is 4.01 slots."""
    net = tprof.dense_network("flaky-wan", 50, round_s=0.05)
    assert net.depth(379_432) == 5
    assert tprof.dense_network("wan", 50).depth(379_432) == 1


def test_dense_network_refuses_what_the_reference_refuses():
    prof = tprof.ideal()
    for kw in (dict(round_s=0.0), dict(round_s=-1.0),
               dict(max_staleness=0)):
        with pytest.raises(ValueError) as port_err:
            tnet.DenseNetwork(prof, **kw)
        with pytest.raises(ValueError) as ref_err:
            jnet.DenseNetwork(jprof.ideal(), **kw)
        assert str(port_err.value) == str(ref_err.value)
    fm = tnet.FaultModel(tnet.FaultConfig(churn_fraction=0.5,
                                          horizon_s=3.0), 4)
    with pytest.raises(ValueError, match="covers 4 nodes, engine has 5"):
        tnet.DenseNetwork(prof, faults=fm).round_masks(3, 5)


# ---------------------------------------------------------------------------
# fault timelines
# ---------------------------------------------------------------------------

FAULTS = {
    "stragglers": dict(straggler_fraction=0.5, straggler_slowdown=2.0),
    "crash": dict(churn_fraction=1.0, crash_fraction=1.0, horizon_s=5.0),
    "churn": dict(churn_fraction=0.5, mean_downtime_s=2.5, horizon_s=8.0,
                  seed=3),
    "fig11": dict(straggler_fraction=0.25, straggler_slowdown=2.0,
                  churn_fraction=0.25, crash_fraction=0.0,
                  mean_downtime_s=10 / 8, horizon_s=10.0, seed=1),
    "churny": dict(straggler_fraction=0.25, straggler_slowdown=2.5,
                   churn_fraction=0.25, crash_fraction=0.25,
                   mean_downtime_s=4.0, horizon_s=20.0, seed=9),
    "instant": dict(churn_fraction=0.5, horizon_s=6.0, seed=2),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("n", [6, 50])
@pytest.mark.parametrize("round_s", [1.0, 0.3])
def test_fault_masks_match_reference_bit_for_bit(name, n, round_s):
    want = jnet.FaultModel(jnet.FaultConfig(**FAULTS[name]), n)
    got = tnet.FaultModel(tnet.FaultConfig(**FAULTS[name]), n)
    rounds = 25
    for i in range(n):
        assert got.down_windows(i) == want.down_windows(i)
        assert got.compute_multiplier(i) == want.compute_multiplier(i)
    assert got.ever_down() == want.ever_down()
    up = got.round_up_masks(rounds, round_s)
    np.testing.assert_array_equal(up, want.round_up_masks(rounds, round_s))
    np.testing.assert_array_equal(got.round_step_masks(rounds, round_s),
                                  want.round_step_masks(rounds, round_s))
    for net_cls, prof, fm in ((jnet.DenseNetwork, jprof.ideal(), want),
                              (tnet.DenseNetwork, tprof.ideal(), got)):
        pair = net_cls(prof, round_s=round_s, faults=fm).round_masks(rounds,
                                                                     n)
        if net_cls is jnet.DenseNetwork:
            ref_up, ref_step = pair
        else:
            port_up, port_step = pair
    np.testing.assert_array_equal(port_up, ref_up)
    np.testing.assert_array_equal(port_step, ref_step)


def test_no_faults_gives_all_true_masks():
    up, step = tnet.DenseNetwork(tprof.ideal()).round_masks(4, 3)
    assert up.all() and step.all() and up.shape == step.shape == (4, 3)


# ---------------------------------------------------------------------------
# keyed matrices fed the reference's draws
# ---------------------------------------------------------------------------

def _ref_engine_matrices(ref_net, rnds, n, size, depth):
    """Staleness and drop matrices as the reference's engine makes them:
    inside a jitted scan over traced round indices."""
    def body(carry, r):
        return carry, (ref_net.staleness_matrix(r, n, size, depth),
                       ref_net.drop_mask(r, n))
    _, (stal, drop) = jax.jit(lambda rs: jax.lax.scan(body, None, rs))(
        jnp.asarray(rnds))
    return np.asarray(stal), np.asarray(drop)


@pytest.mark.parametrize("profile", ["lossy", "partitioned", "flaky-wan"])
@pytest.mark.parametrize("round_s", [1.0, 0.3, 0.05])
def test_keyed_matrices_match_reference_bit_for_bit(profile, round_s):
    n, size, rnds = 12, 94_898, list(range(0, 9))
    if profile == "flaky-wan":
        ref_p = jprof.flaky_wan(n, partition_at=1.0, partition_len=0.7,
                                seed=3)
        port_p = tprof.flaky_wan(n, partition_at=1.0, partition_len=0.7,
                                 seed=3)
    else:
        kw = dict(LOSSY if profile == "lossy" else PARTITIONED)
        ref_p, port_p = _both(profile, **kw)
    ref_net = jnet.DenseNetwork(ref_p, round_s=round_s)
    port_net = tnet.DenseNetwork(port_p, round_s=round_s)
    depth = port_net.depth(size)
    assert depth == ref_net.depth(size)
    stal, drop = _ref_engine_matrices(ref_net, rnds, n, size, depth)
    for i, rnd in enumerate(rnds):
        draws = net_round_draws(port_p, rnd, n)
        got_s = port_net.staleness_matrix(rnd, n, size, depth, draws=draws,
                                          device=CPU)
        got_d = port_net.drop_mask(rnd, n, draws=draws, device=CPU)
        assert got_s.dtype == torch.int32 and got_d.dtype == torch.bool
        np.testing.assert_array_equal(got_s.numpy(), stal[i])
        np.testing.assert_array_equal(got_d.numpy(), drop[i])
        # The eager reference functions agree too.
        jit = jsamp.jitter_matrix(ref_p, rnd, n)
        np.testing.assert_array_equal(
            tsamp.jitter_matrix(port_p, rnd, n, CPU, draws.jitter_u).numpy(),
            np.asarray(jit))
        np.testing.assert_array_equal(
            tsamp.latency_matrix(port_p, rnd, n, size, CPU,
                                 draws.jitter_u).numpy(),
            np.asarray(jsamp.latency_matrix(ref_p, rnd, n, size)))
        np.testing.assert_array_equal(
            tsamp.drop_matrix(port_p, rnd, n, CPU,
                              u=draws.drop_u).numpy(),
            np.asarray(jsamp.drop_matrix(ref_p, rnd, n)))


def test_staleness_divides_by_round_s():
    """At round_s = 0.05 edge 67 -> 277 of round 25 (seed 7, n = 300) has a
    delay of 1.5499999523 s: divided by f32(0.05) it is 30.999998 and
    floors to 30; times the reciprocal of f32(0.05) (20.0 in f32) it is 31.
    The port divides, as the reference's eager ``staleness_matrix`` does.
    The reference's engine computes the matrix under ``jax.jit``, where XLA
    turns the division by a constant into the reciprocal product: there it
    reads 31 at this edge and agrees with the port everywhere the two
    roundings floor alike (ROADMAP queue 3)."""
    n, rnd, round_s = 300, 25, 0.05
    ref_p, port_p = _both("lossy", **dict(LOSSY, bandwidth_bps=math.inf))
    ref_net = jnet.DenseNetwork(ref_p, round_s=round_s, max_staleness=64)
    port_net = tnet.DenseNetwork(port_p, round_s=round_s, max_staleness=64)
    depth = port_net.depth(1000)
    draws = net_round_draws(port_p, rnd, n)
    got = port_net.staleness_matrix(rnd, n, 1000, depth, draws=draws,
                                    device=CPU).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_net.staleness_matrix(rnd, n, 1000, depth)))
    assert got[277, 67] == 30
    lat = tsamp.latency_matrix(port_p, rnd, n, 1000, CPU, draws.jitter_u)
    recip = torch.floor(lat * torch.tensor(np.float32(1) / np.float32(0.05)))
    recip = recip.clamp(0, depth - 1).to(torch.int32).numpy()
    np.fill_diagonal(recip, 0)
    engine, _ = _ref_engine_matrices(ref_net, [rnd], n, 1000, depth)
    differ = got != recip
    assert differ.sum() == 1 and differ[277, 67]
    np.testing.assert_array_equal(engine[0][~differ], got[~differ])
    assert engine[0][277, 67] in (got[277, 67], recip[277, 67])


def test_partition_clock_is_f32_as_in_the_reference_scan():
    """round_s = 0.3 and a window [0.9, 1.8): in f32 round 3 starts at
    0.90000004 (inside) and round 6 at 1.8000001 (outside); the f64
    products 0.8999999999999999 and 1.7999999999999998 say the opposite.
    The reference's scan computes in f32, and the port follows it."""
    ref_p, port_p = _both("partitioned", **dict(PARTITIONED, drop_rate=0.0))
    ref_net = jnet.DenseNetwork(ref_p, round_s=0.3)
    port_net = tnet.DenseNetwork(port_p, round_s=0.3)
    n, rnds = 5, list(range(10))
    _, drop = _ref_engine_matrices(ref_net, rnds, n, 0, 1)
    active = [bool(drop[i].any()) for i in range(len(rnds))]
    assert active == [False] * 3 + [True] * 3 + [False] * 4
    assert 3 * 0.3 < 0.9 and 6 * 0.3 < 1.8          # f64 disagrees
    for i, rnd in enumerate(rnds):
        got = port_net.drop_mask(rnd, n, device=CPU)
        np.testing.assert_array_equal(got.numpy(), drop[i])
        t = tsamp.round_time(rnd, 0.3)
        np.testing.assert_array_equal(
            tsamp.partition_matrix(port_p, t, n, CPU).numpy(),
            np.asarray(jsamp.partition_matrix(ref_p, jnp.float32(t), n)))
    blocked = port_net.drop_mask(3, n, device=CPU)
    for a in range(n):
        for b in range(n):
            assert bool(blocked[a, b]) == port_p.partitions[0].blocks(
                float(tsamp.round_time(3, 0.3)), a, b)


def test_nodes_in_no_group_are_unreachable():
    ref_p, port_p = _both("p", partitions=[dict(
        start=0.0, end=1.0, groups=(frozenset({0, 1}), frozenset({3})))])
    got = tsamp.partition_matrix(port_p, 0.5, 5, CPU)
    want = jsamp.partition_matrix(ref_p, jnp.float32(0.5), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2].all() and got[:, 4].all() and not got[0, 1]


def test_draw_free_profiles_give_zeros():
    prof = tprof.ideal()
    net = tnet.DenseNetwork(prof)
    assert net.draws(3, 4, CPU) == tnet.NetDraws(None, None)
    assert not net.drop_mask(3, 4, device=CPU).any()
    assert not net.staleness_matrix(3, 4, 1000, 1, device=CPU).any()
    assert not tsamp.jitter_matrix(prof, 0, 4, CPU).any()


# ---------------------------------------------------------------------------
# round-keyed draws
# ---------------------------------------------------------------------------

def test_round_keyed_draws_do_not_depend_on_earlier_rounds():
    """A round's draws are a pure function of (seed, round, stream): the
    same whichever rounds were drawn before, and different across seeds,
    rounds and streams."""
    prof = tprof.flaky_wan(8, seed=4)
    net = tnet.DenseNetwork(prof, round_s=0.05)
    alone = net.draws(5, 8, CPU)
    for r in range(7):
        net.draws(r, 8, CPU)
    again = net.draws(5, 8, CPU)
    assert torch.equal(alone.jitter_u, again.jitter_u)
    assert torch.equal(alone.drop_u, again.drop_u)
    s_alone = net.staleness_matrix(5, 8, 379_432, 5, device=CPU)
    assert torch.equal(s_alone, net.staleness_matrix(
        5, 8, 379_432, 5, draws=again, device=CPU))
    draws = {(seed, rnd, stream): tsamp.uniform(seed, rnd, 8, stream, CPU)
             for seed in (0, 4) for rnd in (0, 1, 5)
             for stream in (tsamp.STREAM_JITTER, tsamp.STREAM_DROP_MODEL,
                            tsamp.STREAM_DROP_CTRL)}
    for key, u in draws.items():
        assert u.dtype == torch.float32 and 0 <= float(u.min()) \
            and float(u.max()) < 1
        for other, v in draws.items():
            assert (key == other) == torch.equal(u, v), (key, other)


def test_fold_seed_keys_every_input():
    """A CPU generator reads only the low 32 bits of its seed, so those
    depend on both inputs; seed 0 keeps the counter itself."""
    from repro_torch.core import InGraphEpidemicStrategy
    from repro_torch.data import DeviceDataStream, make_image_classification
    assert [fold_seed(0, c) for c in (0, 1, 7)] == [0, 1, 7]
    lows = {fold_seed(s, c) & 0xFFFFFFFF for s in range(4) for c in range(4)}
    assert len(lows) == 16
    nested = {fold_seed(fold_seed(s, r), k) & 0xFFFFFFFF
              for s in range(3) for r in range(3) for k in range(3)}
    assert len(nested) == 27
    # EL-Oracle draws its graph on a CPU generator: other seeds, other
    # graphs.
    graphs = [InGraphEpidemicStrategy(n=8, k=2, seed=s, device="cpu")
              .graph_round((), 0, None)[1] for s in (1, 2)]
    assert not torch.equal(*graphs)
    ds = make_image_classification(64, num_classes=4, image_size=8, seed=0)
    parts = np.array_split(np.arange(64), 4)
    batches = [DeviceDataStream(ds, parts, 4, seed=s, device="cpu").draw(0)
               for s in (3, 4)]
    assert not torch.equal(batches[0]["labels"], batches[1]["labels"]) or \
        not torch.equal(batches[0]["images"], batches[1]["images"])


def test_reference_draw_helper_is_the_reference_keying():
    key = jax.random.fold_in(jsamp.round_key(7, 3), jsamp.STREAM_DROP_MODEL)
    want = jax.random.uniform(key, (5, 5), jnp.float32)
    np.testing.assert_array_equal(net_draws(7, 3, 5, 1).numpy(),
                                  np.asarray(want))
    assert (tsamp.STREAM_JITTER, tsamp.STREAM_DROP_MODEL,
            tsamp.STREAM_DROP_CTRL) == (jsamp.STREAM_JITTER,
                                        jsamp.STREAM_DROP_MODEL,
                                        jsamp.STREAM_DROP_CTRL)
