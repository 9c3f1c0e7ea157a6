"""The sharded round engine over several gloo ranks: the port's
counterparts of ``tests/test_superstep_sharded.py``'s multi-device tests,
which the reference itself cannot run under the installed jax 0.9 (its
``test_spawn_multi_device_conformance`` fails with a
``ShardingTypeError``).

Three runs of ``repro_torch.launch.start`` (one process per rank, gloo
on a ``file://`` store, one thread each), started together: one, two and
three ranks over n = 7 (padded to 8 and 9 on two and three), the three
ranks also over n = 8 (padded to 9).  Meanwhile this process makes the
reference's one-device runs (``RunnerConfig(mesh_devices=1)``: its whole
sharded program on a one-device mesh).  Every case of ``CASES`` runs in
each rank through the sharded engine and, on rank 0, through the
single-device engine in the same process.  Checks:

* every rank holds the same edges, records, parameters and network
  counters;
* against the port's single-device engine, edges and records exactly
  and the parameters bit for bit under the gather schedule for the tiny
  MLP's dense engine (the row block sums over the nodes in the order the
  whole contraction does; a uniform W is the masked plain mix's own
  quotients), within 1e-5 under psum (the sum over the nodes runs rank by
  rank), 5e-3 under psum with int8 (a coordinate at a rounding edge takes
  the next quantization level; measured 1.1e-4), 1e-6 for the sparse
  engine (its row block and partials add a slot with one fused
  multiply-add, as the reference's einsum does, where the single-device
  CSR mix rounds each product) and 1e-5 for the reduced GN-LeNet, whose
  local step on fewer nodes is not the same bits on the CPU (its
  convolutions grouped over n nodes sum in another order; measured
  3e-8 a step);
* against the reference's one-device runs at n = 7 (the same initial
  parameters, batches and replayed draws), for one, two and three ranks:
  edges, comm bytes, isolated counts and network counters exactly,
  parameters within 1e-4 (5e-3 under int8; the psum runs against the
  reference's gather run, which on one device is its psum run's too);
* a ``DeviceDataStream`` run is the same bits over one, two and three
  ranks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import torch.distributed as dist                             # noqa: E402

from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402

from repro_torch.launch import start                         # noqa: E402

import _sharded_cases as sc                                  # noqa: E402
from test_torch_sharded import (CODEC_TOL, SPARSE_TOL,       # noqa: E402
                                TOL, _init, assert_matches_reference,
                                assert_same, reference_draws,
                                reference_run, reference_summary)

PSUM_TOL, CNN_TOL = 1e-5, 1e-5

# name -> (case, reference run it is held to at n = 7 (None: none),
# tolerance against the single-device engine)
CASES = {
    "morph-gather": (("mlp", "morph", {"collective": "gather"}), "morph",
                     0.0),
    "morph-psum": (("mlp", "morph", {"collective": "psum"}), "morph",
                   PSUM_TOL),
    "static-gather": (("mlp", "static", {"collective": "gather"}),
                      "static", 0.0),
    "static-psum": (("mlp", "static", {"collective": "psum"}), "static",
                    PSUM_TOL),
    "fc-gather": (("mlp", "fc", {"collective": "gather"}), "fc", 0.0),
    "fc-psum": (("mlp", "fc", {"collective": "psum"}), "fc", PSUM_TOL),
    "sparse-gather": (("mlp", "sparse", {"collective": "gather"}),
                      "sparse", SPARSE_TOL),
    "sparse-psum": (("mlp", "sparse", {"collective": "psum"}), "sparse",
                    SPARSE_TOL),
    "int8-gather": (("mlp", "morph", {"collective": "gather",
                                      "compress": "int8"}), "int8", 0.0),
    "int8-psum": (("mlp", "morph", {"collective": "psum",
                                    "compress": "int8"}), "int8",
                  CODEC_TOL),
    "wan-gather": (("mlp", "morph", {"collective": "gather",
                                     "net": "wan"}), "wan", 0.0),
    "cnn-gather": (("cnn", "morph", {"collective": "gather"}), None,
                   CNN_TOL),
    "stream-gather": (("mlp", "morph", {"collective": "gather",
                                        "stream": True}), None, 0.0),
}
# The reference's run of each kind, as reference_run takes it.
REFERENCE = {"morph": ("morph", {}), "static": ("static", {}),
             "fc": ("fc", {}), "sparse": ("sparse", {}),
             "int8": ("morph", {"compress": "int8"}),
             "wan": ("morph", {"net": "wan"})}
# Three ranks over n = 8 as well: the dense and sparse schedules.
N8_CASES = ("morph-gather", "morph-psum", "static-gather", "sparse-gather",
            "sparse-psum")
WORLDS = (1, 2, 3)
RUNS = {(1, 7): sorted(CASES), (2, 7): sorted(CASES),
        (3, 7): sorted(CASES), (3, 8): N8_CASES}


def reference_init(n):
    """The tiny MLP's initial parameters as the reference's runner draws
    them (``PRNGKey(0)`` split over the nodes), as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.vmap(jax_mlp_params)(keys))


def _batch(n, names, draws, mlp):
    params = {"mlp": mlp, "cnn": _init(n, "cnn")}
    return (n, [CASES[k][0] for k in names], params, draws)


@pytest.fixture(scope="module")
def runs():
    """Start the one-, two- and three-rank worlds, make the reference's
    runs meanwhile, then collect the ranks' results: ``({(world, n):
    per-rank results}, {kind: reference summary})``."""
    draws = {7: reference_draws(7), 8: None}
    mlp = {7: reference_init(7), 8: _init(8)}
    batches = {w: [_batch(n, RUNS[w, n], draws[n], mlp[n])
                   for (ww, n) in RUNS if ww == w] for w in WORLDS}
    jobs = {w: start(sc.rank_main, w, batches[w], device="cpu",
                     threads=1) for w in WORLDS}
    refs = {}
    for kind, (name, knobs) in REFERENCE.items():
        init, ref = reference_run("mlp", name, 7, **knobs)
        for k, v in sc.params_from_jax(init).items():
            assert np.array_equal(v.numpy(),
                                  sc.params_from_jax(mlp[7])[k].numpy())
        refs[kind] = reference_summary(ref)
    got = {w: job.join() for w, job in jobs.items()}
    out = {}
    for w in WORLDS:
        keys = [(ww, n) for (ww, n) in RUNS if ww == w]
        for key, per_batch in zip(keys, zip(*got[w])):
            out[key] = per_batch
    return out, refs


def _results(runs, world, n, name):
    """``(every rank's sharded summary, rank 0's single-device one)``."""
    out = runs[0][world, n]
    i = list(RUNS[world, n]).index(name)
    return [rank[0][i] for rank in out], out[0][1][i]


def _assert_ranks_agree(per_rank):
    first = per_rank[0]
    for other in per_rank[1:]:
        assert_same(other, first)


@pytest.mark.parametrize("world,n,name",
                         [(w, n, k) for (w, n), names in RUNS.items()
                          for k in names])
def test_ranks_match_single_device(runs, world, n, name):
    """Every rank the same; rank 0 against the single-device engine, bit
    for bit on one rank outside the sparse engine."""
    per_rank, single = _results(runs, world, n, name)
    assert len(per_rank) == world
    _assert_ranks_agree(per_rank)
    sparse = CASES[name][0][1] == "sparse"
    assert_same(per_rank[0], single,
                CASES[name][2] if world > 1 or sparse else 0.0)


@pytest.mark.parametrize("world,name",
                         [(w, k) for w in WORLDS for k in sorted(CASES)
                          if CASES[k][1] is not None])
def test_ranks_match_reference(runs, world, name):
    """The reference's one-device run of the same case at n = 7, from the
    initial parameters the ranks were given (the tiny MLP's
    ``PRNGKey(0)`` draw)."""
    case, kind, _ = CASES[name]
    per_rank, _ = _results(runs, world, 7, name)
    refs = runs[1]
    tol = CODEC_TOL if "compress" in case[2] else TOL
    assert_matches_reference(per_rank[0], refs[kind], tol)


def test_device_stream_is_the_same_over_one_two_and_three_ranks(runs):
    one, _ = _results(runs, 1, 7, "stream-gather")
    for world in (2, 3):
        per_rank, _ = _results(runs, world, 7, "stream-gather")
        assert_same(per_rank[0], one[0])
    assert not dist.is_initialized()
