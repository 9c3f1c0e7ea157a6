"""The sweep farm on an ``("exp", "data")`` mesh
(``SweepSuperstep(mesh=make_sweep_mesh(e, d))``): the port's counterpart of
``tests/test_sweep.py``'s mesh tests.  The reference's own multi-device
sweep cannot run under the installed jax 0.9
(``test_sweep.py::test_spawn_sweep_sharded`` fails with a
``ShardingTypeError``), so the port's ranks are held to the reference's
one-device sweep, and bit for bit to the port's own meshless sweep.

Two worlds of ``repro_torch.launch.start`` (gloo ranks on a ``file://``
store, one thread each) start together: two ranks as (2, 1) and four as
(2, 2), so n = 7 pads to 8 over ``data``.  Each runs the cases of
``tests/_sweep_mesh_cases.py`` (E = 4, 11 rounds, the tiny MLP and a
reduced GN-LeNet; Morph with a ``delta_r`` axis and Static on both
meshes, Morph under a ``SweepNetwork`` of mixed ring depths on (2, 1))
with the reference's draws replayed (batch slots, Morph noise, network
uniforms; the tiny MLP from the reference's initial parameters), and the
(2, 1) ranks also run every case without a mesh.  Meanwhile this process
runs the reference's one-device sweeps of the tiny MLP's cases (the
reduced GN-LeNet's meshless sweep is held to the reference by
``tests/test_torch_sweep.py``).  Checks:

* every rank ends with the same histories, records, counters and logical
  parameters for all four experiments;
* against the port's meshless sweep: edges, records, comm bytes and
  ``net_stats`` exactly, and the parameters bit for bit for both models
  (the row block sums over the nodes in the whole contraction's order;
  the reduced GN-LeNet's grouped convolutions over fewer nodes gave the
  same bits here, measured max |diff| 0.0, where a 1e-5 limit was
  allowed);
* against the reference's one-device sweep: edges, comm bytes, isolated
  counts, delivered masks and ``net_stats`` exactly, parameters within
  1e-4 (``tests/test_torch_sweep.py``'s ``TOL``).

In process: a 1 x 1 mesh bit for bit the meshless sweep and held to the
reference, Static to the reference's sweep on its own
``make_sweep_mesh(1, 1)`` (``tests/test_sweep.py``'s in-process mesh
test), ``make_sweep_mesh``'s three cases, the reference's
refusals with its messages, and ``sweep_runner_factory(mesh=)``.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import torch.distributed as dist                             # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.netsim as jnet                                  # noqa: E402
from repro.data import DeviceDataStream as JaxStream         # noqa: E402
from repro.dlrt import (RunnerConfig as JaxConfig,           # noqa: E402
                        SweepSpec as JaxSpec,
                        SweepSuperstep as JaxSweep)
from repro.launch.mesh import make_sweep_mesh as jax_sweep_mesh  # noqa: E402
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch import tune as tt                           # noqa: E402
from repro_torch.launch import make_sweep_mesh, start        # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

import _sweep_mesh_cases as sc                               # noqa: E402
from _jax_draws import morph_draws, net_draws, stream_take   # noqa: E402

TOL = 1e-4
# The cases held to the reference (the tiny MLP's; the reduced GN-LeNet's
# meshless sweep is held to the reference by tests/test_torch_sweep.py,
# and its ranks here to that meshless sweep bit for bit), and the one
# whose reference sweep runs on the reference's own 1 x 1 mesh (which it
# pins bit for bit to its meshless sweep, tests/test_sweep.py): the
# in-process 1 x 1 case.
REFERENCE_CASES = ("mlp-morph-dr", "mlp-morph-net", "mlp-static")
ON_MESH = "mlp-static"
# (world, mesh sizes) -> the cases its ranks run.
WORLDS = {2: ((2, 1), sorted(sc.CASES)),
          4: ((2, 2), sorted(k for k, c in sc.CASES.items()
                             if not c.get("net")))}
# The reference's initialiser jitted: the sweep vmaps it, and one
# compiled program is quicker than compiling each of its ops.
JAX_INIT = jax.jit(jax_mlp_params)


NEGOTIATIONS = -(-sc.ROUNDS // 2)        # every second round at most


def reference_draws():
    """The reference's draws for every case: each stream's batch slots,
    each Morph experiment's negotiations, each profile's uniforms."""
    tr, parts, _ = sc.data()
    sizes = [len(p) for p in parts]
    return {
        "takes": {(s, r): stream_take(s, r, sizes, sc.BATCH)
                  for s in sc.SEEDS for r in range(sc.ROUNDS)},
        "morph": {s: morph_draws(s, sc.N, NEGOTIATIONS)
                  for s in sc.SEEDS},
        "net": {p: [(net_draws(p, r, sc.N, 0), net_draws(p, r, sc.N, 1))
                    for r in range(sc.ROUNDS)]
                for p in sc.profile_seeds()},
    }


def reference_sweep(case, mesh=None):
    """The reference's one-device sweep of a tiny-MLP ``case`` (not run).
    One round a dispatch (``chunk=1``: the same trajectory) compiles one
    scan, not one per chunk length."""
    assert case["model"] == "mlp"
    tr, parts, test = sc.data()
    delta_r = case.get("delta_r")
    drs = delta_r or (2,) * len(sc.SEEDS)
    if case["strategy"] == "morph":
        strategies = [jcore.InGraphMorphStrategy(
            n=sc.N, k=sc.K, view_size=sc.K + 2, seed=s, delta_r=d)
            for s, d in zip(sc.SEEDS, drs)]
    else:
        strategies = [jcore.InGraphStaticStrategy(
            n=sc.N, degree=4, seed=sc.STATIC_SEED) for _ in sc.SEEDS]
    net = None
    if case.get("net"):
        net = jnet.SweepNetwork([
            jnet.DenseNetwork(jnet.profiles.get_profile(p, sc.N, s),
                              **sc.NET_KW)
            for p, s in zip(sc.PROFILES, sc.profile_seeds())])
    return JaxSweep(
        spec=JaxSpec(seeds=sc.SEEDS, delta_r=delta_r), init_fn=JAX_INIT,
        loss_fn=jax_mlp_loss, eval_fn=jax_mlp_loss, optimizer=jax_sgd(0.05),
        streams=[JaxStream(ds=tr, parts=parts, batch_size=sc.BATCH, seed=s)
                 for s in sc.SEEDS], test_batch=test,
        strategies=strategies,
        cfg=JaxConfig(n_nodes=sc.N, rounds=sc.ROUNDS,
                      eval_every=sc.EVAL_EVERY, sim_every=sc.SIM_EVERY),
        net=net, mesh=mesh, chunk=1)


def initial_params(ref):
    """The reference sweep's parameters (before its run: the initial
    ones), one port dict an experiment."""
    return [params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x[e]), ref.params))
        for e in range(len(sc.SEEDS))]


def reference_summary(ref):
    """The reference run as :func:`_sweep_mesh_cases.summary` gives the
    port's (the fields both have)."""
    E, last = len(sc.SEEDS), initial_params(ref)
    return {
        "edges": np.stack([np.stack([np.asarray(x) for x in h])
                           for h in ref.edge_history]),
        "delivered": np.stack([np.stack([np.asarray(x) for x in h])
                               for h in ref.delivered_history])
        if ref.net is not None else None,
        "params": {k: np.stack([p[k].numpy() for p in last])
                   for k in last[0]},
        "records": [[(r.rnd, r.comm_bytes, r.isolated) for r in log.records]
                    for log in ref.log],
        "comm_bytes": [ref.comm_bytes(e) for e in range(E)],
        "net_stats": None if ref.net_stats is None else [
            {k: (np.asarray(v).tolist() if k == "staleness_hist" else v)
             for k, v in st.items()} for st in ref.net_stats],
    }


@pytest.fixture(scope="module")
def runs():
    """Start both worlds, run the reference's sweeps meanwhile, collect:
    ``{"meshed": {world: per-rank {name: summary}}, "alone": {name:
    summary}, "reference": {name: summary}, "params": {name: initial}}``.
    """
    draws = reference_draws()
    refs = {name: reference_sweep(
        sc.CASES[name], jax_sweep_mesh(1, 1) if name == ON_MESH else None)
        for name in REFERENCE_CASES}
    params = {name: initial_params(refs[name]) if name in refs else None
              for name in sc.CASES}
    # The ranks' interpreters take the environment they start in: one
    # OpenMP thread each, as every test's fresh interpreter.
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        jobs = {w: start(sc.rank_main, w, sizes,
                         [(k, sc.CASES[k], params[k], draws) for k in names],
                         names if w == 2 else (), device="cpu", threads=1)
                for w, (sizes, names) in WORLDS.items()}
    finally:
        if omp is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = omp
    reference = {}
    for name, ref in refs.items():
        ref.run()
        reference[name] = reference_summary(ref)
    got = {w: job.join() for w, job in jobs.items()}
    alone = {}
    for _, per_rank in got[2]:
        alone.update(per_rank)
    return {"meshed": {w: [r[0] for r in out] for w, out in got.items()},
            "alone": alone, "reference": reference, "params": params,
            "draws": draws}


def assert_same(got, want):
    """Two port runs: every field exactly, parameters bit for bit."""
    np.testing.assert_array_equal(got["edges"], want["edges"])
    if want["delivered"] is not None:
        np.testing.assert_array_equal(got["delivered"], want["delivered"])
    assert list(got["params"]) == list(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    assert got["records"] == want["records"]
    assert got["comm_bytes"] == want["comm_bytes"]
    assert got["net_stats"] == want["net_stats"]


def assert_matches_reference(got, want):
    """Edges, delivered masks, comm bytes, isolated counts and network
    counters exactly; parameters within :data:`TOL`."""
    np.testing.assert_array_equal(got["edges"], want["edges"])
    if want["delivered"] is not None:
        np.testing.assert_array_equal(got["delivered"], want["delivered"])
    assert got["comm_bytes"] == want["comm_bytes"]
    assert [[r[:3] for r in log] for log in got["records"]] == \
        want["records"]
    assert got["net_stats"] == want["net_stats"]
    assert list(got["params"]) == list(want["params"])
    for k, v in want["params"].items():
        err = float(np.abs(got["params"][k] - v).max())
        assert err <= TOL, f"{k}: {err}"


CELLS = [(w, name) for w, (_, names) in WORLDS.items() for name in names]


@pytest.mark.parametrize("world,name", CELLS)
def test_ranks_agree_and_match_the_meshless_sweep(runs, world, name):
    per_rank = [r[name] for r in runs["meshed"][world]]
    assert len(per_rank) == world
    sizes = WORLDS[world][0]
    n_local = -(-sc.N // sizes[1])
    assert per_rank[0]["local"] == (len(sc.SEEDS) // sizes[0], n_local)
    for other in per_rank[1:]:
        assert_same(other, per_rank[0])
    assert_same(per_rank[0], runs["alone"][name])


@pytest.mark.parametrize("world,name", [(w, k) for w, k in CELLS
                                        if k in REFERENCE_CASES])
def test_ranks_match_the_reference(runs, world, name):
    got = runs["meshed"][world][0][name]
    want = runs["reference"][name]
    assert_matches_reference(got, want)


# ---------------------------------------------------------------------------
# In process: the 1 x 1 mesh, make_sweep_mesh, the refusals, the factory
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    mesh = make_sweep_mesh(1, 1, device="cpu")
    yield mesh
    mesh.close()
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", ["mlp-morph-dr", ON_MESH])
def test_one_by_one_mesh_is_the_meshless_sweep_and_the_reference(
        runs, one_rank_mesh, name):
    """A 1 x 1 mesh runs the per-rank body (its gathers over one rank):
    bit for bit the meshless sweep, and held to the reference's sweep
    (Static's on the reference's own ``make_sweep_mesh(1, 1)``)."""
    got = sc.run_case(sc.CASES[name], runs["params"][name], runs["draws"],
                      one_rank_mesh)
    assert got["local"] == (len(sc.SEEDS), sc.N)
    assert_same(got, runs["alone"][name])
    assert_matches_reference(got, runs["reference"][name])


def test_make_sweep_mesh_cases():
    """Sizes below 1 and more ranks than a missing or smaller group
    raise naming torchrun; a 1 x 1 mesh starts a one-rank group and its
    ``close`` destroys it, while a mesh over a given group leaves it."""
    with pytest.raises(ValueError, match=">= 1"):
        make_sweep_mesh(0, 1, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_sweep_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()
    mesh = make_sweep_mesh(1, 1, device="cpu")
    try:
        assert dict(mesh.shape) == {"exp": 1, "data": 1}
        assert mesh.coords == {"exp": 0, "data": 0}
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_sweep_mesh(2, 1, device="cpu")
        again = make_sweep_mesh(1, 1, device="cpu")
        again.close()
        assert dist.is_initialized()
    finally:
        mesh.close()
    assert not dist.is_initialized()


# The reference's three refusals, each on a mesh that has the shape to
# trip it (only ``shape`` is read before the refusal).
REFUSALS = {"exp": {"exp": 3, "data": 1}, "net": {"exp": 1, "data": 2},
            "axes": {"exp": 2}}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_match_the_reference(kind):
    mesh = types.SimpleNamespace(shape=REFUSALS[kind])
    case = sc.CASES["mlp-morph-net" if kind == "net" else "mlp-morph-dr"]
    with pytest.raises(ValueError) as ref:
        reference_sweep(case, mesh=mesh)
    with pytest.raises(ValueError) as port:
        sc.sweep(case, None, mesh=mesh)
    assert str(port.value) == str(ref.value)


def test_sweep_runner_factory_builds_a_meshed_engine(one_rank_mesh):
    """``sweep_runner_factory(mesh=)`` passes the mesh to the engine; two
    rounds on it are bit for bit the meshless factory's."""
    cand = tt.Candidate(chunk=2)
    engines = [tt.sweep_runner_factory(4, 2, device="cpu", mesh=mesh)(
        cand)._make_engine() for mesh in (one_rank_mesh, None)]
    assert engines[0].mesh is one_rank_mesh and engines[1].mesh is None
    for engine in engines:
        engine.run_steps(2)
    for k, v in engines[1].params.items():
        assert torch.equal(engines[0].params[k], v), k
    assert all(len(h) == 2 for h in engines[0].edge_history)

