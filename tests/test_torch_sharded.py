"""The sharded round engine on one rank, in process — the port's
counterparts of ``tests/test_superstep_sharded.py``'s one-device tests —
and its pieces: ``pad_adjacency``, ``sparse_mix_rows(rows=)``, the
padded layout, the mesh and the group's life, the refusals and the
tuner's ``collective`` knob.  The helpers that make and hold the
reference's runs live here and serve ``test_torch_sharded_spawn.py``
too, which holds every case on one, two and three ranks to them.

Reference side: ``repro.dlrt.DecentralizedRunner(RunnerConfig(
mesh_devices=1, collective=...))``, which runs the whole sharded program
(``shard_map``, collectives over one device), with the XLA mixing paths.
Port side: ``RunnerConfig(mesh_devices=1)`` on the CPU, which starts a
one-rank gloo group, runs :class:`repro_torch.dlrt.ShardedSuperstep` and
destroys the group; the same initial parameters and host batches, and the
reference's Morph, sparse and network draws replayed
(``tests/_jax_draws.py``).

Tolerances against the reference: edges, comm bytes, isolated counts and
network counters exactly; parameters within 1e-4 (the two sides sum the
mix in other orders, as in ``tests/test_torch_runner.py``) and within
5e-3 under ``int8`` (``tests/test_torch_compress_engine.py``'s bar: a
coordinate at a rounding edge takes the next quantization level).  The
reference's sharded GN-LeNet does not run under the installed jax 0.9
(a ``ShardingTypeError`` in its convolution's reshape, the same as
``tests/test_superstep_cnn.py::test_cnn_sharded_one_device_matches_host_loop``),
so the reduced GN-LeNet's one-rank run is held bit for bit to the port's
single-device engine, which ``tests/test_torch_runner.py`` holds to the
reference's (DESIGN.md §8: the one-device mesh is that engine's bits).

Against the port's own single-device engine, one rank is bit for bit for
the dense engine under both schedules (the gather row block is the whole
W; one rank's psum partial is the whole product, and its reduce-scatter
over one rank a copy; a uniform strategy's W is ``uniform_weights_torch``,
the masked plain mix's own quotients), and within 1e-6 for the sparse
engine (5e-3 under int8), whose row block sums the reference's way (one
fused multiply-add a slot) where the single-device CSR mix rounds each
product.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import torch.distributed as dist                             # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.sparse as jsp                                   # noqa: E402
import repro.tune as jt                                      # noqa: E402
import repro_torch.tune as tt                                # noqa: E402
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.dlrt import (DecentralizedRunner as JaxRunner,    # noqa: E402
                        RunnerConfig as JaxConfig)
from repro.models.cnn import cnn_loss as jax_cnn_loss        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.netsim import profiles as jprofiles               # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro.sparse.adjacency import pad_adjacency as jax_pad  # noqa: E402
from repro.sparse.mix import sparse_mix_rows as jax_rows     # noqa: E402
from repro_torch.dlrt import ShardedSuperstep                # noqa: E402
from repro_torch.launch import NodeMesh, make_superstep_mesh  # noqa: E402
from repro_torch.sparse import (SparseAdjacency,             # noqa: E402
                                pad_adjacency, sparse_mix_rows)
from repro_torch.tree import params_from_jax                 # noqa: E402

import _sharded_cases as sc                                  # noqa: E402
from _jax_draws import (morph_draws, net_round_draws,        # noqa: E402
                        sparse_draws)

N = 6
TOL, CODEC_TOL, SPARSE_TOL = 1e-4, 5e-3, 1e-6
NEGOTIATIONS = range(0, sc.ROUNDS, 5)      # delta_r = 5


# ---------------------------------------------------------------------------
# The reference's runs, once each.
# ---------------------------------------------------------------------------

def _jax_strategy(name, n):
    if name == "morph":
        return jcore.InGraphMorphStrategy(n=n, k=sc.K, view_size=4, seed=0)
    if name == "static":
        return jcore.InGraphStaticStrategy(n=n, degree=sc.static_degree(n),
                                           seed=0)
    if name == "fc":
        return jcore.InGraphFullyConnectedStrategy(n=n)
    return jsp.SparseMorphStrategy(n=n, k=sc.K, seed=0)


def _jax_model(model):
    if model == "mlp":
        return jax_mlp_params, jax_mlp_loss
    return (lambda key: jax_cnn_params(key, in_channels=3, num_classes=4,
                                       image_size=8, width=4), jax_cnn_loss)


def reference_run(model, name, n, *, collective="gather", compress="none",
                  net=None):
    """The reference's run of a case on a one-device mesh: ``(initial
    params as numpy, runner after its run)``.  One round a dispatch
    (``chunk=1``, the same trajectory) compiles one scan, not one per
    chunk length."""
    tr, test, parts = sc.data(n)
    init_fn, loss = _jax_model(model)
    jnet = None if net is None else jprofiles.dense_network(
        "wan", n, round_s=sc.WAN_ROUND_S)
    ref = JaxRunner(
        init_fn=init_fn, loss_fn=loss, eval_fn=loss,
        optimizer=jax_sgd(0.05), batcher=JaxBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=_jax_strategy(name, n),
        cfg=JaxConfig(n_nodes=n, rounds=sc.ROUNDS, eval_every=sc.EVAL_EVERY,
                      compiled=True, chunk=1, mesh_devices=1,
                      collective=collective, compress=compress, net=jnet,
                      engine="sparse" if name == "sparse" else "dense"))
    init = jax.tree_util.tree_map(lambda x: np.array(x), ref.params)
    ref.run()
    return init, ref


def reference_draws(n):
    """The reference's Morph, sparse and WAN draws at n nodes, as the
    port's strategies and network model take them."""
    c = sc.strategy("sparse", n).c
    net = sc.wan(n)
    return {"morph": morph_draws(0, n, len(NEGOTIATIONS)),
            "sparse": {r: sparse_draws(0, r, n, sc.K, c)
                       for r in NEGOTIATIONS},
            "net": {r: net_round_draws(net.profile, r, n)
                    for r in range(sc.ROUNDS)}}


def reference_summary(ref):
    """The reference run's edges, parameters and records, as the port's
    :func:`_sharded_cases.summary` gives them."""
    return {
        "edges": np.stack([np.asarray(e) for e in ref.edge_history]),
        "params": {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, ref.params)).items()},
        "records": [(x.rnd, x.comm_bytes, x.isolated, x.mean_accuracy)
                    for x in ref.log.records],
        "net_stats": ref.net_stats,
        "delivered": np.stack([np.asarray(e) for e in
                               ref.delivered_history])
        if ref.delivered_history else None,
    }


def assert_matches_reference(got, want, tol):
    """Edges, comm bytes, isolated counts and network counters exactly,
    parameters within ``tol`` and, where that is f32's 1e-4, accuracies
    within 1e-5 (a codec's 5e-3 moves a test prediction, as
    ``tests/test_torch_compress_engine.py`` leaves them unchecked)."""
    np.testing.assert_array_equal(got["edges"], want["edges"])
    assert list(got["params"]) == list(want["params"])
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   atol=tol, err_msg=k)
    assert [r[:3] for r in got["records"]] == \
        [r[:3] for r in want["records"]]
    for a, b in zip(got["records"], want["records"]):
        assert tol > TOL or a[3] == pytest.approx(b[3], abs=1e-5)
    if want["net_stats"] is not None:
        np.testing.assert_array_equal(got["delivered"], want["delivered"])
        for key in ("delivered", "dropped", "staleness_sum"):
            assert got["net_stats"][key] == want["net_stats"][key], key
        assert got["net_stats"]["staleness_hist"] == \
            list(want["net_stats"]["staleness_hist"])


def assert_same(got, want, atol=0.0):
    """Two port runs: edges and records exactly, parameters bit for bit
    (``atol=0``) or within ``atol``."""
    np.testing.assert_array_equal(got["edges"], want["edges"])
    for k in want["params"]:
        if atol == 0.0:
            np.testing.assert_array_equal(got["params"][k],
                                          want["params"][k], err_msg=k)
        else:
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       atol=atol, err_msg=k)
    if atol == 0.0:
        assert got["records"] == want["records"]
    else:
        assert [r[:3] for r in got["records"]] == \
            [r[:3] for r in want["records"]]
    assert got["net_stats"] == want["net_stats"]


# (model, strategy, knobs) of the one-rank runs, each against the port's
# single-device engine (the reference's runs of the same cases, on one,
# two and three ranks, are in test_torch_sharded_spawn.py).
CASES = {
    "mlp-morph-gather": ("mlp", "morph", {"collective": "gather"}),
    "mlp-morph-psum": ("mlp", "morph", {"collective": "psum"}),
    "mlp-static-gather": ("mlp", "static", {"collective": "gather"}),
    "mlp-static-psum": ("mlp", "static", {"collective": "psum"}),
    "mlp-fc-psum": ("mlp", "fc", {"collective": "psum"}),
    "mlp-sparse-gather": ("mlp", "sparse", {"collective": "gather"}),
    "mlp-sparse-psum": ("mlp", "sparse", {"collective": "psum"}),
    "mlp-sparse-int8-psum": ("mlp", "sparse", {"collective": "psum",
                                               "compress": "int8"}),
    "mlp-morph-int8-gather": ("mlp", "morph", {"collective": "gather",
                                               "compress": "int8"}),
    "mlp-morph-int8-psum": ("mlp", "morph", {"collective": "psum",
                                             "compress": "int8"}),
    "mlp-morph-wan-gather": ("mlp", "morph", {"collective": "gather",
                                              "net": "wan"}),
    "cnn-morph-gather": ("cnn", "morph", {"collective": "gather"}),
    "cnn-static-psum": ("cnn", "static", {"collective": "psum"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_is_the_single_device_engine(case):
    """One rank's sharded run bit for bit the port's single-device engine
    (sparse: within 1e-6, and 5e-3 under int8; see the module docstring),
    with the group it started destroyed after the run."""
    model, name, knobs = CASES[case]
    init = _init(N, model)
    got = sc.run_case(CASES[case], N, init, None, mesh_devices=1)
    assert not dist.is_initialized(), "the runner left its group behind"
    single = {k: v for k, v in knobs.items() if k != "collective"}
    alone = sc.run_case((model, name, single), N, init, None)
    tol = 0.0
    if name == "sparse":
        tol = CODEC_TOL if "compress" in knobs else SPARSE_TOL
    assert_same(got, alone, tol)


def test_one_rank_matches_reference_mesh():
    """Dense Morph on one rank against the reference's run on a one-device
    mesh, with the reference's draws replayed (every case on one, two and
    three ranks: test_torch_sharded_spawn.py)."""
    init, ref = reference_run("mlp", "morph", N)
    got = sc.run_case(("mlp", "morph", {}), N, init, reference_draws(N),
                      mesh_devices=1)
    assert_matches_reference(got, reference_summary(ref), TOL)


# ---------------------------------------------------------------------------
# The pieces.
# ---------------------------------------------------------------------------

def _adjacency(rng, n, k):
    idx = rng.integers(0, n, (n, k))
    mask = rng.random((n, k)) < 0.7
    idx = np.where(mask, idx, np.arange(n)[:, None])
    w = np.where(mask, rng.random((n, k)), 0.0).astype(np.float32)
    w_self = rng.random(n).astype(np.float32)
    return idx, w, w_self, mask


SHAPES = [(7, 3, 37, 8), (8, 2, 200, 9), (16, 5, 1580, 18)]


@pytest.mark.parametrize("n,k,d,n_pad", SHAPES)
def test_pad_adjacency_is_the_references(n, k, d, n_pad):
    idx, w, w_self, mask = _adjacency(np.random.default_rng(n), n, k)
    want = jax_pad(jsp.SparseAdjacency(
        jnp.asarray(idx, jnp.int32), jnp.asarray(w), jnp.asarray(w_self),
        jnp.asarray(mask)), n_pad)
    got = pad_adjacency(SparseAdjacency(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(w_self),
        torch.as_tensor(mask)), n_pad)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got.idx.dtype == torch.int64 and not got.mask[n:].any()
    assert (got.w_self[n:] == 1).all() and (got.w[n:] == 0).all()


@pytest.mark.parametrize("n,k,d,n_pad", SHAPES)
def test_sparse_mix_rows_is_the_references(n, k, d, n_pad):
    """Each rank's receiver block over the gathered population, bit for
    bit the reference's ``sparse_mix_rows(rows=)`` (its einsum adds the
    slots one fused multiply-add at a time), for both halves of the
    padded receivers, whole and 16 columns at a time."""
    rng = np.random.default_rng(n + k)
    idx, w, w_self, mask = _adjacency(rng, n, k)
    x = rng.normal(size=(n_pad, d)).astype(np.float32)
    ja = jax_pad(jsp.SparseAdjacency(
        jnp.asarray(idx, jnp.int32), jnp.asarray(w), jnp.asarray(w_self),
        jnp.asarray(mask)), n_pad)
    ta = pad_adjacency(SparseAdjacency(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(w_self),
        torch.as_tensor(mask)), n_pad)
    half = n_pad // 2
    for a, b, chunk_d in ((0, half, None), (half, n_pad, 16)):
        rows = np.arange(a, b)
        want = jax_rows(jsp.SparseAdjacency(*(t[a:b] for t in ja)),
                        jnp.asarray(x), jnp.asarray(rows, jnp.int32),
                        chunk_d)
        got = sparse_mix_rows(SparseAdjacency(*(t[a:b] for t in ta)),
                              torch.as_tensor(x), a, chunk_d)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n,k,d,n_pad", SHAPES)
def test_csr_wrapper_takes_a_block_and_push_partials(n, k, d, n_pad):
    """The CSR wrapper as a sharded engine calls it on the card, here
    through its plain version: a receiver block whose own rows start at
    ``self0`` of the gathered population is those rows of the whole mix,
    bit for bit, and the push partials (``self0=None``) are the mix with
    no self term."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(n * k)
    idx, w, w_self, mask = (torch.as_tensor(a)
                            for a in _adjacency(rng, n_pad, k))
    x = torch.as_tensor(rng.normal(size=(n_pad, d)).astype(np.float32))
    whole = ops.mix_sparse(idx, w, w_self, x, mask=mask)
    half = n_pad // 2
    got = ops.mix_sparse_leaves(idx[half:], w[half:], w_self[half:], [x],
                                mask=mask[half:], self0=half)[0]
    assert got.shape == (n_pad - half, d)
    np.testing.assert_array_equal(got.numpy(), whole[half:].numpy())
    no_self = ops.mix_sparse(idx, w, torch.zeros_like(w_self), x, mask=mask)
    push = ops.mix_sparse_leaves(idx, w, None, [x], mask=mask,
                                 self0=None)[0]
    np.testing.assert_array_equal(push.numpy(), no_self.numpy())


def _engine(n, world, rank, **knobs):
    """A sharded engine for rank ``rank`` of ``world`` (built only: the
    constructor runs no collective, so no group is needed)."""
    r = sc.runner("mlp", "static", n, _init(n), **knobs)
    mesh = NodeMesh(world, rank, torch.device("cpu"))
    return ShardedSuperstep(
        mesh=mesh, loss_fn=r._loss_fn, eval_fn=r._eval_fn, optimizer=r.opt,
        batcher=r.batcher, test_batch=r.test_batch, strategy=r.strategy,
        cfg=r.cfg, params=r.params, opt_state=r.opt_state)


def _init(n, model="mlp"):
    """Initial parameters drawn by the port (as numpy, the reference's
    layout), for the runs no reference run is held against."""
    from repro_torch.models import cnn_params, mlp_params
    from repro_torch.tree import params_to_numpy, stack
    gen = torch.Generator().manual_seed(n)
    if model == "mlp":
        return params_to_numpy(stack(mlp_params(gen) for _ in range(n)))
    return params_to_numpy(stack(
        cnn_params(gen, in_channels=3, num_classes=4, image_size=8, width=4)
        for _ in range(n)))


@pytest.mark.parametrize("n,world", [(7, 2), (8, 3), (6, 3), (4, 3)])
def test_padded_layout(n, world):
    """``embed_w`` (identity tail), ``embed_w_stal`` (identity tail at
    staleness 0), ``pad_mask`` (padded rows step) and each rank's rows
    (edge padding), as the reference builds them: padded rows keep their
    own model, and no real row takes weight from a padded one."""
    n_pad = -(-n // world) * world
    rng = np.random.default_rng(n * world)
    w = torch.as_tensor(rng.random((n, n)), dtype=torch.float32)
    w = w / w.sum(dim=1, keepdim=True)
    w_stal = torch.as_tensor(rng.random((n, n, 2)), dtype=torch.float32)
    step = torch.as_tensor(rng.random(n) < 0.5)
    for rank in range(world):
        eng = _engine(n, world, rank, net="wan")
        assert (eng.n_pad, eng.n_local, eng.offset) == \
            (n_pad, n_pad // world, rank * (n_pad // world))
        want = np.eye(n_pad, dtype=np.float32)
        want[:n, :n] = w.numpy()
        np.testing.assert_array_equal(eng._embed_w(w).numpy(), want)
        assert eng.net_S == 2
        want = np.zeros((n_pad, n_pad, 2), np.float32)
        want[:n, :n] = w_stal.numpy()
        want[np.arange(n, n_pad), np.arange(n, n_pad), 0] = 1.0
        got = eng._embed_w_stal(w_stal).numpy()
        np.testing.assert_array_equal(got, want.reshape(n_pad, 2 * n_pad))
        assert not got[:n].reshape(n, n_pad, 2)[:, n:].any()
        rows = np.arange(eng.offset, eng.offset + eng.n_local)
        want_mask = np.concatenate([step.numpy(),
                                    np.ones(n_pad - n, bool)])[rows]
        np.testing.assert_array_equal(eng._pad_mask(step).numpy(),
                                      want_mask)
        src = np.minimum(rows, n - 1)
        for k, v in eng.params.items():
            np.testing.assert_array_equal(v.numpy(),
                                          eng_full(eng)[k].numpy()[src])
        batch = eng._batch(0)
        assert next(iter(batch.values())).shape[0] == eng.n_local


def eng_full(eng):
    return params_from_jax(_init(eng.cfg.n_nodes))


# ---------------------------------------------------------------------------
# Refusals, the mesh and the group's life.
# ---------------------------------------------------------------------------

def _refusal_runner(case):
    from repro_torch.compress import CompressConfig
    init = _init(N)
    if case == "compat-gather":
        r = sc.runner("mlp", "morph", N, init, mesh_devices=1,
                      sparse_mix="gather")
        r.cfg = dataclasses.replace(r.cfg, engine="sparse")
        return r
    knobs = {"codec-sim-off": dict(compress=CompressConfig(quant="int8",
                                                           sim=False)),
             "net-psum": dict(net="wan", collective="psum"),
             "unknown-collective": dict(collective="bcast")}[case]
    return sc.runner("mlp", "morph", N, init, mesh_devices=1, **knobs)


REFUSALS = {
    "compat-gather": "compat gather-mix (dense strategy through in-scan CSR "
                     "conversion) is a single-device numerics path",
    "codec-sim-off": "CompressConfig(sim=False) is a single-device knob",
    "net-psum": "use collective='gather' (got 'psum')",
    "unknown-collective": "collective='bcast' not in ('gather', 'psum')",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_are_the_references(case):
    """The reference's four refusals, in its words; the group the runner
    started for them is destroyed."""
    r = _refusal_runner(case)
    with pytest.raises(ValueError, match=re.escape(REFUSALS[case])):
        r.run()
    assert not dist.is_initialized()


def test_host_loop_refuses_a_mesh():
    r = sc.runner("mlp", "morph", N, _init(N), mesh_devices=1,
                  compiled=False)
    with pytest.raises(TypeError, match="mesh_devices"):
        r.run()


def test_mesh_without_a_group():
    """More than one shard needs ranks started first; a CUDA mesh needs a
    card; one shard starts and closes a group of its own."""
    with pytest.raises(ValueError, match="torchrun"):
        make_superstep_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_superstep_mesh(1)
    mesh = make_superstep_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.owned) == (1, 0, True)
    assert dist.get_backend() == "gloo"
    mesh.close()
    mesh.close()
    assert not dist.is_initialized()


def test_a_given_group_is_kept_and_runs_twice(tmp_path):
    """Under a group the caller started, ``mesh_devices=0`` is its world
    size, a mismatch raises, and the runner leaves the group up; two runs
    in one process give the same bits."""
    dist.init_process_group("gloo", init_method=(tmp_path / "s").as_uri(),
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="world size"):
            make_superstep_mesh(2, device="cpu")
        init = _init(N)
        a = sc.run_case(("mlp", "morph", {}), N, init, None, mesh_devices=0)
        assert dist.is_initialized()
        b = sc.run_case(("mlp", "morph", {}), N, init, None, mesh_devices=0)
        assert_same(a, b)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The tuner's collective knob.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", [0, 3])
@pytest.mark.parametrize("devices", [2, 4])
def test_candidate_space_with_devices_is_the_references(devices, net):
    shape = dict(backend="cuda", n=16, d=1580, devices=devices, net=net)
    want = jt.candidate_space(jt.TuneShape(**shape))
    got = tt.candidate_space(tt.TuneShape(**shape))
    assert [c.label() for c in got] == [c.label() for c in want]
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]
    assert ("psum" in {c.collective for c in got}) == (net == 0)


def test_shape_and_resolution_with_a_mesh_are_the_references(tmp_path):
    """``devices`` is the mesh's world size, and ``collective="auto"``
    takes the cache entry's schedule, as the reference's does."""
    ref = jt.mlp_runner_factory(N, rounds=8)(jt.Candidate())
    port = tt.mlp_runner_factory(N, rounds=8, device="cpu")(tt.Candidate())
    for mesh in (1, 2):
        knobs = dict(mesh_devices=mesh, collective="auto")
        ref.cfg = dataclasses.replace(ref.cfg, **knobs)
        port.cfg = dataclasses.replace(port.cfg, **knobs)
        shape = tt.shape_of(port.cfg, port.params)
        assert shape.key() == jt.shape_of(ref.cfg, ref.params).key() == \
            f"cpu|n={N}|d=1580|devices={mesh}|net=0"
        cache = tt.TuningCache()
        cache.put(shape, tt.TuneEntry(collective="psum", chunk=4))
        path = tmp_path / f"c{mesh}.json"
        cache.save(path)
        want = jt.resolve_knobs(ref.cfg, ref.params,
                                cache=jt.TuningCache.load(path))
        got = tt.resolve_knobs(port.cfg, port.params,
                               cache=tt.TuningCache.load(path))
        assert (got.collective, got.chunk, got.source) == \
            (want.collective, want.chunk, want.source) == \
            ("psum", port.cfg.chunk, f"cache:{shape.key()}")


def test_auto_collective_is_bitwise_explicit(tmp_path, monkeypatch):
    init = _init(N)
    probe = sc.runner("mlp", "morph", N, init, mesh_devices=1)
    cache = tt.TuningCache()
    cache.put(tt.shape_of(probe.cfg, probe.params),
              tt.TuneEntry(collective="psum"))
    path = tmp_path / "cache.json"
    cache.save(path)
    monkeypatch.setenv(tt.ENV_CACHE, str(path))
    auto = sc.runner("mlp", "morph", N, init, mesh_devices=1,
                     collective="auto")
    auto.run()
    assert auto.resolved_knobs.collective == "psum"
    explicit = sc.run_case(("mlp", "morph", {"collective": "psum"}), N,
                           init, None, mesh_devices=1)
    assert_same(sc.summary(auto), explicit)
