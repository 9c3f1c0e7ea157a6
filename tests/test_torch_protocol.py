"""The message-faithful Morph protocol and its host helpers against the
reference, bit for bit.

Reference side: ``repro.core`` (plain numpy on the host).  Port side:
``repro_torch.core``'s copies, given the same numpy ``Generator`` seeds and
the same parameters (numpy arrays for the reference, the port's
``OrderedDict`` of CPU tensors for the port, in the same leaf order).
Everything compared here is exact: the host code sums the same f64 values
in the same order, so edges, W, views, histories, messages and tallies are
identical, not close.  The invariants of ``tests/test_protocol.py`` are
ported as they are.
"""
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import repro.core as jcore                                   # noqa: E402
from repro.core import protocol as jprotocol                 # noqa: E402
from repro.core import selection as jselection               # noqa: E402
from repro.core import similarity as jsim                    # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
from repro_torch.core import (MorphConfig, MorphProtocol,    # noqa: E402
                              in_degrees, is_connected, is_row_stochastic,
                              out_degrees)


def _params(rng, n, widths=(32, 7)):
    """The same node-stacked parameters twice: a numpy dict for the
    reference (keys in ``tree_leaves`` order) and the port's ordered dict
    of CPU tensors."""
    arrays = {f"l{i}": rng.normal(size=(n, d)).astype(np.float32)
              for i, d in enumerate(widths)}
    return arrays, OrderedDict((k, torch.from_numpy(v.copy()))
                               for k, v in sorted(arrays.items()))


# ---------------------------------------------------------------------------
# The host helpers, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_history_estimate_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = jsim.SimilarityHistory(depth=3), tcore.SimilarityHistory(
        depth=3)
    for _ in range(40):
        if rng.random() < 0.3:
            peer, sim = int(rng.integers(10)), float(rng.uniform(-1, 1))
            ref.observe_direct(peer, sim)
            port.observe_direct(peer, sim)
        else:
            t, y, z = (int(v) for v in rng.integers(10, size=3))
            sigma = float(rng.uniform(-1, 1))
            ref.observe_report(jsim.SimilarityReport(t, y, z, sigma))
            port.observe_report(tcore.SimilarityReport(t, y, z, sigma))
    for target in range(11):
        assert port.estimate(target) == ref.estimate(target)
    assert port.known_peers() == ref.known_peers()
    assert port.snapshot(range(11)) == ref.snapshot(range(11))


@pytest.mark.parametrize("seed", range(3))
def test_eq3_on_the_host_is_the_reference(seed):
    """``node_row`` from the port's tensors, ``pair_similarity_numpy`` and
    ``similarity_matrix_numpy`` give the reference's f64 bits."""
    rng = np.random.default_rng(seed)
    arrays, tensors = _params(rng, 6, widths=(50, 3, 129))
    arrays["l1"][2] = 0.0                          # a zero row: the eps
    tensors["l1"][2] = 0.0
    for i in range(6):
        want = jsim.node_row(arrays, i)
        got = tcore.node_row(tensors, i)
        assert all(a.dtype == np.float64 and np.array_equal(a, b)
                   for a, b in zip(want, got))
        for j in range(6):
            assert tcore.pair_similarity_numpy(
                got, tcore.node_row(tensors, j)) == \
                jsim.pair_similarity_numpy(want, jsim.node_row(arrays, j))
    assert np.array_equal(tcore.similarity_matrix_numpy(tensors),
                          jsim.similarity_matrix_numpy(arrays))
    assert np.array_equal(tcore.similarity_matrix_numpy(arrays["l0"]),
                          jsim.similarity_matrix_numpy(arrays["l0"]))
    for s1, s2 in rng.uniform(-1, 1, size=(5, 2)):
        assert tcore.angular_bound(s1, s2) == jsim.angular_bound(s1, s2)


@pytest.mark.parametrize("seed,n,k", [(0, 8, 2), (1, 16, 3), (2, 30, 4),
                                      (3, 12, 5)])
@pytest.mark.parametrize("slack", [0, 1], ids=["k_out=k", "k_out=k+1"])
def test_deferred_acceptance_is_the_reference(seed, n, k, slack):
    rng = np.random.default_rng(seed)
    prefs = [list(rng.permutation([j for j in range(n) if j != i])
                  [:int(rng.integers(k, n))]) for i in range(n)]
    scores = rng.uniform(size=(n, n))
    want = jcore.deferred_acceptance(prefs, scores, k, k + slack)
    got = tcore.deferred_acceptance(prefs, scores, k, k + slack)
    assert np.array_equal(got, want)
    assert (got.sum(axis=1) <= k).all() and (got.sum(axis=0) <= k + slack) \
        .all()


@pytest.mark.parametrize("seed", range(4))
def test_wanted_senders_host_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 20
    sim = rng.uniform(-1, 1, size=n)
    full = rng.random(n) < 0.7
    local = full & (rng.random(n) < 0.6)
    for beta in (5.0, 500.0):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(5):
            want = jselection.update_wanted_senders_host(
                a, sim, local, full, 3, 5, beta)
            got = tcore.update_wanted_senders_host(b, sim, local, full, 3,
                                                   5, beta)
            assert np.array_equal(got, want)
        assert np.array_equal(
            tcore.sample_sequential(a, sim, local, 4, beta),
            jselection.sample_sequential(b, sim, local, 4, beta))


@pytest.mark.parametrize("seed", range(3))
def test_topology_helpers_are_the_reference(seed):
    rng = np.random.default_rng(seed)
    view = rng.random((12, 12)) < 0.3
    for v in (None, view):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            want = jcore.random_out_regular(12, 3, a, v)
            got = tcore.random_out_regular(12, 3, b, v)
            assert np.array_equal(got, want)
            assert np.array_equal(tcore.out_degrees(got),
                                  jcore.out_degrees(want))
            assert tcore.comm_cost(got, 7) == jcore.comm_cost(want, 7)
    for d_s, d_r in ((2, 0), (2, 1), (3, 2)):
        assert tcore.connectivity_probability(24, d_s, d_r, 20, seed) == \
            jcore.connectivity_probability(24, d_s, d_r, 20, seed)
    ref_state = jcore.TopologyState.empty(12)
    port_state = tcore.TopologyState.empty(12)
    for e in (view, ~view, np.zeros((12, 12), bool)):
        ref_state.advance(e)
        port_state.advance(e)
    assert (port_state.round, port_state.total_transfers,
            port_state.isolation_history) == \
        (ref_state.round, ref_state.total_transfers,
         ref_state.isolation_history)


def test_host_mixing_helpers_are_the_reference():
    rng = np.random.default_rng(0)
    edges = rng.random((9, 9)) < 0.3
    stacked = {"a": rng.normal(size=(9, 4, 3)).astype(np.float32)}
    for w in (jcore.uniform_weights(edges),
              jcore.fully_connected_weights(9),
              jcore.metropolis_hastings_weights(edges | edges.T)):
        got, want = tcore.mix_numpy(w, stacked), jcore.mix_numpy(w, stacked)
        assert got["a"].dtype == np.float32
        assert np.array_equal(got["a"], want["a"])
        assert tcore.is_row_stochastic(w) == jcore.is_row_stochastic(w)
        assert tcore.is_doubly_stochastic(w) == jcore.is_doubly_stochastic(w)
    assert not tcore.is_doubly_stochastic(tcore.uniform_weights(edges))


def test_uniform_weights_in_f32_are_the_hosts_quotients():
    """The masked mix builds ``1 / d`` in f32 where the reference's host
    loop casts the f64 quotient to f32: the same value for every degree
    up to 1,001, so the masked route mixes the reference's W."""
    d = np.arange(1, 1002)
    assert np.array_equal(np.float32(1) / d.astype(np.float32),
                          (1.0 / d.astype(np.float64)).astype(np.float32))
    rng = np.random.default_rng(0)
    for n in (3, 50, 129):
        edges = rng.random((n, n)) < 0.2
        np.fill_diagonal(edges, False)
        w = torch.from_numpy(tcore.uniform_weights(edges)).float()
        assert torch.equal(tcore.uniform_weights_torch(
            torch.from_numpy(edges)), w)


# ---------------------------------------------------------------------------
# MorphProtocol against the reference's, message for message.
# ---------------------------------------------------------------------------

def _history(st):
    return (dict(st.history.direct),
            {z: [(r.t, r.reporter, r.target, r.sigma) for r in dq]
             for z, dq in sorted(st.history.reports.items())})


def assert_same_protocol(port, ref):
    assert (port.control_messages, port.similarity_floats) == \
        (ref.control_messages, ref.similarity_floats)
    assert np.array_equal(port.view_sizes(), ref.view_sizes())
    for a, b in zip(port.nodes, ref.nodes):
        assert a.known_peers == b.known_peers
        assert a.wanted == b.wanted
        assert _history(a) == _history(b)


@pytest.mark.parametrize("n,k", [(8, 2), (16, 3)])
@pytest.mark.parametrize("delta_r", [1, 5])
def test_protocol_is_the_reference(n, k, delta_r):
    """Twelve rounds, fresh parameters every round (a Δr = 1 negotiation
    reads each round's direct measurements): identical edges and W every
    round, and identical views, wanted sets, histories and tallies."""
    ref = jcore.MorphProtocol(jcore.MorphConfig(n=n, k=k, delta_r=delta_r,
                                                seed=3))
    port = MorphProtocol(MorphConfig(n=n, k=k, delta_r=delta_r, seed=3))
    rng = np.random.default_rng(7)
    for t in range(12):
        arrays, tensors = _params(rng, n)
        want = ref.round_edges(t, arrays)
        got = port.round_edges(t, tensors)
        assert np.array_equal(got[0], want[0]), f"edges at round {t}"
        assert np.array_equal(got[1], want[1]), f"W at round {t}"
        assert_same_protocol(port, ref)


def test_protocol_message_phases_are_the_reference():
    """The message-phased API with a lossy delivery: the same requests,
    accepts, rejects, edges and digests."""
    n, k = 12, 3
    ref = jcore.MorphProtocol(jcore.MorphConfig(n=n, k=k, seed=1))
    port = MorphProtocol(MorphConfig(n=n, k=k, seed=1))
    rng = np.random.default_rng(2)
    for t in range(3):
        arrays, tensors = _params(rng, n)
        ref.round_edges(t, arrays)
        port.round_edges(t, tensors)
    alive = [i for i in range(n) if i != 4]
    p_ref, p_port = ref.begin_negotiation(5, alive), \
        port.begin_negotiation(5, alive)
    assert [tuple(vars(r).values()) for r in p_port.requests] == \
        [tuple(vars(r).values()) for r in p_ref.requests]
    assert p_port.prefs == p_ref.prefs
    assert np.array_equal(p_port.sender_scores, p_ref.sender_scores)
    delivered = {(r.receiver, r.sender) for r in p_ref.requests
                 if rng.random() < 0.7}
    (e_ref, acc_ref, rej_ref), (e_port, acc_port, rej_port) = (
        ref.complete_negotiation(p_ref, delivered),
        port.complete_negotiation(p_port, delivered))
    assert np.array_equal(e_port, e_ref)
    assert [tuple(vars(m).values()) for m in acc_port + rej_port] == \
        [tuple(vars(m).values()) for m in acc_ref + rej_ref]
    for j in range(n):
        d_ref, d_port = ref.make_digest(j), port.make_digest(j)
        assert (d_port.origin, d_port.peers, d_port.reports) == \
            (d_ref.origin, d_ref.peers, d_ref.reports)
    assert_same_protocol(port, ref)


@pytest.mark.parametrize("name", ["static", "fully-connected", "el-oracle",
                                  "el-local"])
def test_host_baselines_are_the_reference(name):
    n, k = 10, 3
    view = np.random.default_rng(5).random((n, n)) < 0.4
    make = {
        "static": lambda m: m.StaticStrategy(n=n, degree=k + 1, seed=2),
        "fully-connected": lambda m: m.FullyConnectedStrategy(n=n),
        "el-oracle": lambda m: m.EpidemicStrategy(n=n, k=k, seed=2),
        "el-local": lambda m: m.EpidemicStrategy(n=n, k=k, seed=2,
                                                 oracle=False, view=view),
    }[name]
    ref, port = make(jcore), make(tcore)
    assert port.name == ref.name
    for t in range(4):
        (e_ref, w_ref), (e_port, w_port) = ref.round_edges(t), \
            port.round_edges(t)
        assert np.array_equal(e_port, e_ref) and np.array_equal(w_port, w_ref)
    assert not port.needs_params
    assert getattr(port, "uniform_mixing", False) == \
        getattr(ref, "uniform_mixing", False)


def test_ingraph_fixed_graphs_are_the_host_baselines():
    """In-graph Static and FC hand the host loop the host baselines' edges
    and W, and the engine the same values in f32."""
    for ingraph, host in (
            (tcore.InGraphStaticStrategy(n=10, degree=3, seed=4,
                                         device="cpu"),
             jcore.StaticStrategy(n=10, degree=3, seed=4)),
            (tcore.InGraphFullyConnectedStrategy(n=10, device="cpu"),
             jcore.FullyConnectedStrategy(n=10))):
        (e, w), (e_ref, w_ref) = ingraph.round_edges(0), host.round_edges(0)
        assert np.array_equal(e, e_ref) and np.array_equal(w, w_ref)
        _, edges, w32 = ingraph.graph_round((), 0, None)
        assert np.array_equal(edges.numpy(), e_ref)
        assert torch.equal(w32, torch.from_numpy(w_ref).float())


# ---------------------------------------------------------------------------
# The invariants of tests/test_protocol.py, on the port.
# ---------------------------------------------------------------------------

def _run(n=16, k=3, rounds=12, seed=0, dim=64):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(n, dim)).astype(np.float32)}
    proto = MorphProtocol(MorphConfig(n=n, k=k, seed=seed))
    edges = w = None
    for t in range(rounds):
        edges, w = proto.round_edges(t, params)
    return proto, edges, w


def test_degree_invariants():
    proto, edges, w = _run()
    assert (in_degrees(edges) <= proto.cfg.k).all()
    assert (out_degrees(edges) <= proto.cfg.k).all()
    assert is_row_stochastic(w)


@pytest.mark.parametrize("seed", range(4))
def test_stays_connected(seed):
    _, edges, _ = _run(seed=seed)
    assert is_connected(edges)


def test_gossip_discovery_expands_views():
    early = _run(rounds=1)[0].view_sizes().mean()
    late = _run(rounds=12)[0].view_sizes().mean()
    assert late > early                     # P_i grows via gossip


def test_similarity_knowledge_accumulates():
    proto, _, _ = _run(rounds=12)
    assert np.mean([len(st.history.direct) for st in proto.nodes]) \
        >= proto.cfg.k                      # measured every sender
    assert np.mean([len(st.history.reports) for st in proto.nodes]) > 0


def test_exact_overhead_tallies_two_nodes():
    """n = 2, k = 1: two requests and two accepts at rounds 0 and 5, none
    in between; reports about the receiver itself are never sent, so no
    similarity float ever flows."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(2, 16)).astype(np.float32)}
    proto = MorphProtocol(MorphConfig(n=2, k=1, delta_r=5, seed=0))
    proto.round_edges(0, params)
    assert (proto.control_messages, proto.similarity_floats) == (4, 0)
    for t in range(1, 5):
        proto.round_edges(t, params)
    assert (proto.control_messages, proto.similarity_floats) == (4, 0)
    proto.round_edges(5, params)
    assert (proto.control_messages, proto.similarity_floats) == (8, 0)


def test_overhead_accounting_formula():
    """control = sum_i |wanted_i| + |edges|; the floats of round 1 = each
    delivered transfer's sender's direct measurements but the one about
    the receiver."""
    n, k = 8, 2
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(n, 32)).astype(np.float32)}
    proto = MorphProtocol(MorphConfig(n=n, k=k, delta_r=5, seed=1))
    e0, _ = proto.round_edges(0, params)
    wanted = sum(len(st.wanted) for st in proto.nodes)
    assert proto.control_messages == wanted + int(e0.sum())
    assert proto.similarity_floats == 0
    e1, _ = proto.round_edges(1, params)
    assert (e0 == e1).all()
    expected = sum(int(e0[j].sum()) - int(e0[j, i])
                   for i in range(n) for j in np.flatnonzero(e0[i]))
    assert proto.similarity_floats == expected


def test_no_global_knowledge_leak():
    """With a disconnected bootstrap, knowledge stays within components."""
    n, k = 12, 2
    half = n // 2
    adj = np.zeros((n, n), bool)
    for comp in (list(range(0, half)), list(range(half, n))):
        for idx, a in enumerate(comp):
            b = comp[(idx + 1) % len(comp)]
            adj[a, b] = adj[b, a] = True
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(n, 32)).astype(np.float32)}
    proto = MorphProtocol(MorphConfig(n=n, k=k, seed=0), initial_adj=adj)
    for t in range(8):
        proto.round_edges(t, params)
    for st in proto.nodes:
        assert all((j < half) == (st.nid < half) for j in st.known_peers)


def test_delta_r_controls_renegotiation():
    n, k = 10, 2
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(n, 32)).astype(np.float32)}
    proto = MorphProtocol(MorphConfig(n=n, k=k, delta_r=5, seed=0))
    e0, _ = proto.round_edges(0, params)
    e1, _ = proto.round_edges(1, params)
    assert (e0 == e1).all()


def test_config_checks_are_the_reference():
    for kw in (dict(n=4, k=0), dict(n=4, k=4), dict(n=6, k=3, view_size=2),
               dict(n=6, k=3, k_out=2)):
        with pytest.raises(ValueError):
            jprotocol.MorphConfig(**kw)
        with pytest.raises(ValueError):
            MorphConfig(**kw)
    cfg = MorphConfig(n=9, k=3)
    assert (cfg.view_size, cfg.k_out) == (5, 3)
