"""The port's tuner (``repro_torch.tune``) against the reference's
(``repro.tune``), and the knobs it resolves.

Held here: the cache file format both ways (keys, fields, schema
invalidation, unknown fields); ``candidate_space`` by label and ``prune``
on the same scores; ``shape_of`` and ``resolve_knobs`` on one cache file;
``RunnerConfig.chunk`` bit for bit trajectory-invariant; an ``"auto"`` run
bit for bit the resolved values passed explicitly; ``engine="auto"`` and
``compress="auto"`` resolving through the cache as the reference's do (a
cache entry with ``engine="sparse"`` runs a dense strategy in compat mode,
one with ``compress="int8"`` runs the codec), each against the reference's
run with its draws replayed; and ``tune`` end to end with an injected
timer, asserting nothing on wall clock.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.tune as jt                                      # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.dlrt.superstep as superstep               # noqa: E402
import repro_torch.sparse as tsp                             # noqa: E402
import repro_torch.tune as tt                                # noqa: E402
from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification, train_test_split)
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.dlrt import (DecentralizedRunner as JaxRunner,    # noqa: E402
                        RunnerConfig as JaxConfig)
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.compress import CompressConfig              # noqa: E402
from repro_torch.data import StackedBatcher                  # noqa: E402
from repro_torch.dlrt import (DecentralizedRunner,           # noqa: E402
                              RunnerConfig, Superstep)
from repro_torch.models import mlp_loss, mlp_params          # noqa: E402
from repro_torch.netsim import DenseNetwork, profiles        # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import morph_draws                           # noqa: E402

SHAPE = dict(backend="cpu", n=6, d=1580, devices=1, net=0)
ENTRY = dict(block_d=256, collective="gather", chunk=4, use_pallas=False,
             engine="sparse", candidates=16, compress="int8",
             seconds_per_round=1e-3, tuned={"torch": "x", "survivors": 3})

N, ROUNDS, EVAL_EVERY, K = 6, 11, 5, 2   # negotiations at 0, 5, 10
TOL = 5e-3                # compressed runs (tests/test_torch_compress_engine)
PARAMS_TOL = 1e-4         # uncompressed runs against the reference


# ---------------------------------------------------------------------------
# The cache file.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    SHAPE, dict(SHAPE, backend="cuda", n=1000, net=3),
    dict(SHAPE, sweep=8)])
def test_shape_keys_are_the_references(shape):
    assert tt.TuneShape(**shape).key() == jt.TuneShape(**shape).key()


@pytest.mark.parametrize("writer,reader", [(tt, jt), (jt, tt)],
                         ids=["port-to-reference", "reference-to-port"])
def test_cache_interchange(tmp_path, writer, reader):
    """A file either package writes loads in the other with equal fields;
    the two files are the same bytes."""
    path = tmp_path / "cache.json"
    cache = writer.TuningCache()
    cache.put(writer.TuneShape(**SHAPE), writer.TuneEntry(**ENTRY))
    cache.put(writer.TuneShape(**dict(SHAPE, n=50, sweep=4)),
              writer.TuneEntry(chunk=16))
    cache.save(path)
    loaded = reader.TuningCache.load(path)
    assert len(loaded) == 2
    got = loaded.get(reader.TuneShape(**SHAPE))
    assert dataclasses.asdict(got) == ENTRY
    got = loaded.get(reader.TuneShape(**dict(SHAPE, n=50, sweep=4)))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        writer.TuneEntry(chunk=16))
    again = tmp_path / "again.json"
    loaded.save(again)
    assert again.read_bytes() == path.read_bytes()
    assert loaded.get(reader.TuneShape(**dict(SHAPE, n=7))) is None


def test_cache_schema_invalidation(tmp_path):
    path = tmp_path / "cache.json"
    cache = tt.TuningCache()
    cache.put(tt.TuneShape(**SHAPE), tt.TuneEntry(**ENTRY))
    cache.save(path)
    payload = json.loads(path.read_text())
    assert payload["schema_version"] == tt.CACHE_VERSION == jt.CACHE_VERSION
    payload["schema_version"] = tt.CACHE_VERSION + 1
    path.write_text(json.dumps(payload))
    assert len(tt.TuningCache.load(path)) == 0
    assert len(tt.TuningCache.load(tmp_path / "missing.json")) == 0
    (tmp_path / "garbage.json").write_text("{not json")
    assert len(tt.TuningCache.load(tmp_path / "garbage.json")) == 0


def test_cache_ignores_unknown_fields(tmp_path):
    path = tmp_path / "cache.json"
    cache = tt.TuningCache()
    cache.put(tt.TuneShape(**SHAPE), tt.TuneEntry(**ENTRY))
    cache.save(path)
    payload = json.loads(path.read_text())
    next(iter(payload["entries"].values()))["future_knob"] = 42
    path.write_text(json.dumps(payload))
    for pkg in (tt, jt):
        got = pkg.TuningCache.load(path).get(pkg.TuneShape(**SHAPE))
        assert dataclasses.asdict(got) == ENTRY


def test_default_cache_and_environment(tmp_path, monkeypatch):
    """The committed card cache loads, names the card it was tuned on and
    holds no CPU entry; ``REPRO_TORCH_TUNE_CACHE`` replaces it."""
    monkeypatch.delenv(tt.ENV_CACHE, raising=False)
    assert tt.ENV_CACHE == "REPRO_TORCH_TUNE_CACHE"
    assert tt.DEFAULT_CACHE_PATH.name == "cuda_default.json"
    default = tt.load_default_cache()
    assert len(default) > 0
    for key, entry in default.entries.items():
        assert key.startswith("cuda|")
        assert entry.tuned["backend"] == "cuda"
        assert "H100" in entry.tuned["card"] and entry.tuned["power_limit"]
        assert entry.seconds_per_round > 0
    path = tmp_path / "cache.json"
    cache = tt.TuningCache()
    cache.put(tt.TuneShape(**SHAPE), tt.TuneEntry(chunk=7))
    cache.save(path)
    monkeypatch.setenv(tt.ENV_CACHE, str(path))
    assert tt.load_default_cache().entries == cache.entries


# ---------------------------------------------------------------------------
# The space and the pruning.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw", [
    (SHAPE, {}),
    (dict(SHAPE, backend="cuda"), {}),
    (dict(SHAPE, net=3), {}),
    (SHAPE, dict(chunks=(2, 4), compress_options=("none", "fp8"))),
    (SHAPE, dict(include_sparse=False)),
    (SHAPE, dict(sparse_candidates=(None, 8, 32))),
], ids=["cpu", "cuda", "net", "grid", "dense-only", "candidate-sizes"])
def test_candidate_space_is_the_references(shape, kw):
    want = jt.candidate_space(jt.TuneShape(**shape), **kw)
    got = tt.candidate_space(tt.TuneShape(**shape), **kw)
    assert [c.label() for c in got] == [c.label() for c in want]
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]


def _scores(seed, count=12):
    rng = np.random.default_rng(seed)
    cands = tt.candidate_space(tt.TuneShape(**SHAPE), chunks=(2, 4))[:count]
    values = rng.uniform(1.0, 10.0, len(cands))
    if seed % 2:                  # the sparse engine far behind
        values = np.where([c.engine == "sparse" for c in cands],
                          values * 100, values)
    return cands, values


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ratio,keep", [(2.0, 8), (1.2, 2), (1.01, 1),
                                        (100.0, 20)])
def test_prune_is_the_references(seed, ratio, keep):
    cands, values = _scores(seed)
    port = {c: float(v) for c, v in zip(cands, values)}
    ref = {jt.Candidate(**dataclasses.asdict(c)): float(v)
           for c, v in zip(cands, values)}
    got = tt.prune(port, prune_ratio=ratio, keep=keep)
    want = jt.prune(ref, prune_ratio=ratio, keep=keep)
    assert [c.label() for c in got] == [c.label() for c in want]
    assert {c.engine for c in got} == {c.engine for c in cands}


# ---------------------------------------------------------------------------
# Resolution.
# ---------------------------------------------------------------------------

def _both_runners(n=N, rounds=8, **knobs):
    """The reference's and the port's tiny-MLP workload runners with the
    same knobs."""
    ref = jt.mlp_runner_factory(n, rounds=rounds)(jt.Candidate())
    port = tt.mlp_runner_factory(n, rounds=rounds,
                                 device="cpu")(tt.Candidate())
    if knobs:
        ref.cfg = dataclasses.replace(ref.cfg, **knobs)
        port.cfg = dataclasses.replace(port.cfg, **knobs)
    return ref, port


def test_shape_of_is_the_references():
    ref, port = _both_runners()
    assert tt.shape_of(port.cfg, port.params).key() == \
        jt.shape_of(ref.cfg, ref.params).key() == \
        "cpu|n=6|d=1580|devices=1|net=0"
    from repro.netsim import DenseNetwork as JaxNetwork
    from repro.netsim import profiles as jprofiles
    ref.cfg = dataclasses.replace(
        ref.cfg, net=JaxNetwork(jprofiles.wan(), round_s=0.05))
    port.cfg = dataclasses.replace(
        port.cfg, net=DenseNetwork(profiles.wan(), round_s=0.05))
    want = jt.shape_of(ref.cfg, ref.params)
    assert want.net > 1
    assert tt.shape_of(port.cfg, port.params).key() == want.key()


RESOLVE_CASES = {
    "explicit": dict(chunk=5),
    "no-entry": dict(chunk="auto", engine="auto", compress="auto"),
    "partial": dict(chunk="auto", engine="dense", compress="none"),
    "engine": dict(engine="auto"),
    "compress": dict(compress="auto", chunk=3),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_knobs_is_the_references(case, tmp_path):
    ref, port = _both_runners(**RESOLVE_CASES[case])
    shape = jt.shape_of(ref.cfg, ref.params)
    path = tmp_path / "cache.json"
    cache = tt.TuningCache()
    if case != "no-entry":
        cache.put(tt.TuneShape(**SHAPE), tt.TuneEntry(**ENTRY))
    cache.save(path)
    want = jt.resolve_knobs(ref.cfg, ref.params,
                            cache=jt.TuningCache.load(path))
    got = tt.resolve_knobs(port.cfg, port.params,
                           cache=tt.TuningCache.load(path))
    assert (got.chunk, got.engine, got.compress, got.source) == \
        (want.chunk, want.engine, want.compress, want.source)
    if case == "explicit":
        assert got.source == "explicit"
    elif case == "no-entry":
        assert got.source == f"default:{shape.key()}"
        assert (got.chunk, got.engine, got.compress) == (None, "dense",
                                                         "none")
    else:
        assert got.source == f"cache:{shape.key()}"


def test_resolution_is_a_pure_function(tmp_path):
    _, port = _both_runners(chunk="auto", engine="auto", compress="auto")
    cache = tt.TuningCache()
    cache.put(tt.TuneShape(**SHAPE), tt.TuneEntry(**ENTRY))
    a = tt.resolve_knobs(port.cfg, port.params, cache=cache)
    b = tt.resolve_knobs(port.cfg, port.params, cache=cache)
    assert a == b == tt.ResolvedKnobs(
        chunk=4, source="cache:cpu|n=6|d=1580|devices=1|net=0",
        engine="sparse", compress="int8")


def test_engine_refuses_auto_strings():
    """``"auto"`` that reaches the engine is refused, as the reference's
    ``CompiledSuperstep`` refuses it; ``CompressConfig.parse("auto")``
    with the reference's message."""
    _, port = _both_runners()
    kw = dict(loss_fn=mlp_loss, eval_fn=mlp_loss, optimizer=port.opt,
              batcher=port.batcher, test_batch={}, strategy=port.strategy,
              params=port.params, opt_state=port.opt_state, device="cpu")
    for bad in (dict(engine="auto"), dict(chunk="auto"),
                dict(compress="auto")):
        with pytest.raises(TypeError, match="auto"):
            Superstep(cfg=port.cfg, **kw, **bad)
    with pytest.raises(TypeError, match="auto"):
        Superstep(cfg=dataclasses.replace(port.cfg, engine="auto"), **kw)
    from repro.compress import CompressConfig as JaxCompress
    with pytest.raises(TypeError) as want:
        JaxCompress.parse("auto")
    with pytest.raises(TypeError) as got:
        CompressConfig.parse("auto")
    assert str(got.value) == str(want.value).replace("repro.",
                                                     "repro_torch.")


# ---------------------------------------------------------------------------
# chunk, and "auto" against explicit, bit for bit.
# ---------------------------------------------------------------------------

def _data():
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, N, 0.5, np.random.default_rng(0))
    return tr, {"images": te.images, "labels": te.labels}, parts


PORT_STRATEGIES = {
    "morph": lambda: tcore.InGraphMorphStrategy(n=N, k=K, seed=0,
                                                device="cpu"),
    "static": lambda: tcore.InGraphStaticStrategy(n=N, degree=3, seed=0,
                                                  device="cpu"),
    "sparse-morph": lambda: tsp.SparseMorphStrategy(n=N, k=K, seed=0,
                                                    device="cpu"),
}


def _port_runner(strategy, **cfg):
    tr, test, parts = _data()
    return DecentralizedRunner(
        init_fn=mlp_params, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=PORT_STRATEGIES[strategy](),
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         **cfg),
        device="cpu")


def _assert_bitwise(a, b):
    assert len(a.edge_history) == len(b.edge_history) == ROUNDS
    for x, y in zip(a.edge_history, b.edge_history):
        assert np.array_equal(x, y)
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key]), key
    assert [(r.rnd, r.mean_accuracy, r.mean_loss, r.comm_bytes, r.isolated)
            for r in a.log.records] == \
        [(r.rnd, r.mean_accuracy, r.mean_loss, r.comm_bytes, r.isolated)
         for r in b.log.records]


@pytest.mark.parametrize("strategy,cfg", [
    ("morph", {}), ("static", {}),
    ("sparse-morph", dict(engine="sparse")),
    ("morph", dict(compress="int8+topk0.5")),
    ("morph", dict(net="wan")),
], ids=["morph", "static", "sparse-morph", "morph-int8-topk", "morph-wan"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 64])
def test_chunk_is_trajectory_invariant(strategy, cfg, chunk):
    """``RunnerConfig.chunk`` splits each evaluation segment into pieces of
    at most ``chunk`` rounds; the trajectory has the same bits."""
    if cfg.get("net"):
        cfg = dict(cfg, net=DenseNetwork(profiles.wan(), round_s=0.3))
    base = _port_runner(strategy, **cfg)
    base.run()
    capped = _port_runner(strategy, chunk=chunk, **cfg)
    pieces = []
    real = superstep.Superstep._run_chunk

    def spy(self, start, end):
        pieces.append((start, end))
        return real(self, start, end)
    superstep.Superstep._run_chunk = spy
    try:
        capped.run()
    finally:
        superstep.Superstep._run_chunk = real
    assert max(e - s + 1 for s, e in pieces) <= chunk
    assert [s for s, _ in pieces] == sorted({s for s, _ in pieces})
    assert sum(e - s + 1 for s, e in pieces) == ROUNDS
    _assert_bitwise(base, capped)
    assert capped.resolved_knobs == tt.ResolvedKnobs(
        chunk=chunk, source="explicit", engine=capped.engine,
        compress=cfg.get("compress", "none"))


def test_run_steps_takes_the_engines_chunk():
    a = _port_runner("morph", chunk=4)._make_engine()
    b = _port_runner("morph")._make_engine()
    seen = []
    real = a._run_chunk
    a._run_chunk = lambda s, e: seen.append((s, e)) or real(s, e)
    a.run_steps(10)
    b.run_steps(10, 4)
    assert seen == [(0, 3), (4, 7), (8, 9)]
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key])


def _cache_file(tmp_path, **entry):
    path = tmp_path / "cache.json"
    cache = tt.TuningCache()
    cache.put(tt.TuneShape(**SHAPE), tt.TuneEntry(**entry))
    cache.save(path)
    return path


@pytest.mark.parametrize("strategy,entry", [
    ("morph", dict(chunk=3, engine="sparse", compress="int8")),
    ("morph", dict(chunk=2, engine="dense", compress="int8+topk0.5")),
    ("static", dict(chunk=4, engine="sparse")),
    ("sparse-morph", dict(chunk=3, engine="dense", compress="int8")),
], ids=["morph-compat", "morph-dense", "static-compat", "sparse-native"])
def test_auto_is_bitwise_explicit(tmp_path, monkeypatch, strategy, entry):
    """A run with every knob ``"auto"`` resolving from a cache file is bit
    for bit the run given the resolved values; a sparse-native strategy
    runs sparse whatever the entry says."""
    monkeypatch.setenv(tt.ENV_CACHE, str(_cache_file(tmp_path, **entry)))
    auto = _port_runner(strategy, chunk="auto", engine="auto",
                        compress="auto")
    auto.run()
    knobs = auto.resolved_knobs
    assert knobs.source == "cache:cpu|n=6|d=1580|devices=1|net=0"
    assert (knobs.chunk, knobs.engine, knobs.compress) == (
        entry["chunk"], entry["engine"], entry.get("compress", "none"))
    engine = "sparse" if strategy == "sparse-morph" else entry["engine"]
    assert auto.engine == engine
    explicit = _port_runner(strategy, chunk=entry["chunk"], engine=engine,
                            compress=entry.get("compress", "none"))
    explicit.run()
    _assert_bitwise(auto, explicit)


def test_auto_without_an_entry_is_the_defaults(tmp_path, monkeypatch):
    """On the CPU the committed card cache has no entry: ``"auto"`` is the
    hand-set defaults, bit for bit."""
    monkeypatch.delenv(tt.ENV_CACHE, raising=False)
    auto = _port_runner("morph", chunk="auto", engine="auto",
                        compress="auto")
    auto.run()
    assert auto.resolved_knobs.source.startswith("default:cpu|")
    plain = _port_runner("morph")
    plain.run()
    _assert_bitwise(auto, plain)


# ---------------------------------------------------------------------------
# The repair: "auto" resolves through the cache as the reference's does.
# ---------------------------------------------------------------------------

class ReplayMorph(tcore.InGraphMorphStrategy):
    """Port Morph fed the reference's draws, one set per negotiation."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._draws = iter(morph_draws(0, self.n, ROUNDS))

    def graph_round(self, gstate, rnd, sim, noise=None):
        if rnd % self.delta_r == 0:
            noise = next(self._draws)
        return super().graph_round(gstate, rnd, sim, noise=noise)


def _reference_and_port_auto(tmp_path, monkeypatch, entry, **cfg):
    """The reference's runner and the port's, dense Morph on the tiny MLP,
    with ``cfg``'s ``"auto"`` knobs resolving from one cache file."""
    path = _cache_file(tmp_path, **entry)
    monkeypatch.setenv(jt.ENV_CACHE, str(path))
    monkeypatch.setenv(tt.ENV_CACHE, str(path))
    tr, test, parts = _data()
    ref = JaxRunner(
        init_fn=jax_mlp_params, loss_fn=jax_mlp_loss, eval_fn=jax_mlp_loss,
        optimizer=jax_sgd(0.05), batcher=JaxBatcher(tr, parts, 8, seed=3),
        test_batch=test,
        strategy=jcore.InGraphMorphStrategy(n=N, k=K, view_size=4, seed=0),
        cfg=JaxConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                      compiled=True, **cfg))
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    port = DecentralizedRunner(
        init_fn=None, loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test,
        strategy=ReplayMorph(n=N, k=K, view_size=4, seed=0, device="cpu"),
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         **cfg),
        params=params_from_jax(init), device="cpu")
    return ref, port


def _tree(jax_tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))


def _assert_reference(ref_engine, port_engine, tol):
    assert len(port_engine.edge_history) == len(ref_engine.edge_history) \
        == ROUNDS
    for r, (a, b) in enumerate(zip(ref_engine.edge_history,
                                   port_engine.edge_history)):
        assert np.array_equal(np.asarray(a), b), f"edges diverged at {r}"
    want = _tree(ref_engine.params)
    for key in want:
        np.testing.assert_allclose(port_engine.params[key].numpy(),
                                   want[key].numpy(), atol=tol,
                                   err_msg=key)
    assert [r.comm_bytes for r in port_engine.log.records] == \
        [r.comm_bytes for r in ref_engine.log.records]


def test_auto_engine_entry_runs_compat_mode_as_the_reference(
        tmp_path, monkeypatch):
    """A cache entry with ``engine="sparse"`` for a dense Morph strategy
    under ``engine="auto"``: the reference runs compat mode; so does the
    port (compat gather: no dense mix runs), with the reference's edges
    and parameters within 1e-4."""
    ref, port = _reference_and_port_auto(
        tmp_path, monkeypatch, dict(engine="sparse", candidates=16),
        engine="auto", sparse_mix="gather")
    ref_engine = ref._make_engine()
    for fn in ("mix_pytree", "mix_masked_pytree"):
        monkeypatch.setattr(superstep.ops, fn, None)
    port_engine = port._make_engine()
    assert port_engine.engine == "sparse" and port_engine.compat_gather
    assert port.resolved_knobs.engine == ref.resolved_knobs.engine \
        == "sparse"
    assert port.resolved_knobs.source == ref.resolved_knobs.source
    ref_engine.run()
    port_engine.run()
    _assert_reference(ref_engine, port_engine, PARAMS_TOL)


def test_auto_compress_entry_runs_the_codec_as_the_reference(
        tmp_path, monkeypatch):
    """A cache entry with ``compress="int8"`` under ``compress="auto"``:
    both packages run the int8 codec, the port within the compressed
    runs' 5e-3 of the reference, with the same edges and wire bytes."""
    ref, port = _reference_and_port_auto(
        tmp_path, monkeypatch, dict(compress="int8"), compress="auto")
    ref_engine, port_engine = ref._make_engine(), port._make_engine()
    assert port.resolved_knobs.compress == ref.resolved_knobs.compress \
        == "int8"
    assert port_engine.codec == CompressConfig.parse("int8")
    ref_engine.run()
    port_engine.run()
    _assert_reference(ref_engine, port_engine, TOL)
    want = _tree(ref_engine._hat)
    for key in want:
        np.testing.assert_allclose(port_engine.hat[key].numpy(),
                                   want[key].numpy(), atol=TOL)


# ---------------------------------------------------------------------------
# The tuner, with an injected timer.
# ---------------------------------------------------------------------------

def _tagged_factory(factory):
    """``factory`` whose engines carry the candidate they were built for,
    so a fake timer can score them."""
    def make_runner(cand):
        runner = factory(cand)
        build = runner._make_engine

        def tagged():
            engine = build()
            engine.cand = cand
            return engine
        runner._make_engine = tagged
        return runner
    return make_runner


def test_tune_with_an_injected_timer(tmp_path):
    factory = tt.mlp_runner_factory(4, device="cpu")
    probe = factory(tt.Candidate())
    shape = tt.shape_of(probe.cfg, probe.params)
    cands = tt.candidate_space(shape, chunks=(2, 4))
    rng = np.random.default_rng(0)
    stage1 = {c: float(v) for c, v in zip(cands,
                                          rng.uniform(1, 3, len(cands)))}
    stage2 = {c: float(v) for c, v in zip(cands,
                                          rng.uniform(1, 3, len(cands)))}
    calls = []

    def timer(engine, chunk, rounds, warm_chunks):
        cand = engine.cand
        calls.append((cand, chunk, rounds, warm_chunks))
        assert engine.chunk == cand.chunk
        assert engine.engine == cand.engine
        assert (engine.codec.spec() if engine.codec else "none") == \
            cand.compress
        return (stage1 if warm_chunks == 1 else stage2)[cand]

    result = tt.tune(_tagged_factory(factory), shape=shape,
                     candidates=cands, rounds=12, probe_rounds=3,
                     prune_ratio=1.5, keep=3, timer=timer)
    probes = [c for c in calls if c[3] == 1]
    assert [c[0] for c in probes] == cands
    assert all(c[1:3] == (c[0].chunk, 3) for c in probes)
    assert result.stage1_scores == stage1
    assert result.survivors == tt.prune(stage1, prune_ratio=1.5, keep=3)
    timed = [c for c in calls if c[3] == 2]
    assert [c[0] for c in timed] == result.survivors
    assert all(c[1:3] == (c[0].chunk, 12) for c in timed)
    assert result.best == min(result.survivors, key=stage2.get)

    cache = tt.TuningCache.load(tmp_path / "missing.json")
    result = tt.tune_into(cache, _tagged_factory(factory), shape=shape,
                          candidates=cands, rounds=12, probe_rounds=3,
                          prune_ratio=1.5, keep=3, timer=timer)
    entry = cache.get(shape)
    best = result.best
    assert (entry.chunk, entry.engine, entry.candidates, entry.compress) \
        == (best.chunk, best.engine, best.candidates, best.compress)
    assert entry.seconds_per_round == stage2[best]
    assert entry.tuned == {"candidates": len(cands),
                           "survivors": len(result.survivors),
                           "backend": "cpu", "torch": torch.__version__}
    cache.save(tmp_path / "out.json")
    loaded = jt.TuningCache.load(tmp_path / "out.json")
    assert loaded.get(jt.TuneShape(**dataclasses.asdict(shape))).chunk == \
        best.chunk


def test_time_engine_warms_then_times_whole_chunks():
    runner = tt.mlp_runner_factory(4, device="cpu")(tt.Candidate(chunk=2))
    engine = runner._make_engine()
    calls = []
    real = engine.run_steps
    engine.run_steps = lambda r, c: calls.append((r, c)) or real(r, c)
    spr = tt.time_engine(engine, 2, 3)
    assert calls == [(4, 2), (4, 2)] and spr > 0
    calls.clear()
    tt.time_engine(engine, 8, 3, warm_chunks=1)
    assert calls == [(3, 3), (3, 3)]


def test_sweep_factory_tunes_chunk_only():
    factory = tt.sweep_runner_factory(4, 2, device="cpu")
    shape = tt.TuneShape(backend="cpu", n=4, d=1580, sweep=2)
    cands = [tt.Candidate(chunk=c) for c in (2, 4)]
    seen = []

    def timer(engine, chunk, rounds, warm_chunks):
        seen.append((type(engine).__name__, engine.chunk, engine.E))
        engine.run_steps(2, chunk)
        return 1.0 / chunk
    result = tt.tune(factory, shape=shape, candidates=cands, rounds=2,
                     probe_rounds=2, timer=timer)
    assert result.best.chunk == 4
    assert seen[:2] == [("SweepSuperstep", 2, 2), ("SweepSuperstep", 4, 2)]
    assert result.entry().chunk == 4


def test_cli_writes_a_cache_the_reference_reads(tmp_path):
    """``python -m repro_torch.tune`` at a smoke size on the CPU, merged
    over an existing file."""
    from repro_torch.tune.__main__ import main
    out = tmp_path / "cache.json"
    keep = tt.TuningCache()
    keep.put(tt.TuneShape(**dict(SHAPE, n=99)), tt.TuneEntry(chunk=5))
    keep.save(out)
    assert main(["--n", "4", "--device", "cpu", "--chunks", "2",
                 "--rounds", "2", "--probe-rounds", "2",
                 "--out", str(out)]) == 0
    loaded = jt.TuningCache.load(out)
    assert len(loaded) == 2
    entry = loaded.get(jt.TuneShape(backend="cpu", n=4, d=1580))
    assert entry.chunk == 2 and entry.engine in ("dense", "sparse")
    assert entry.compress in tt.DEFAULT_COMPRESS
    assert entry.tuned["candidates"] == 9 and entry.tuned["backend"] == "cpu"
    assert entry.tuned["shards"] == "dirichlet"


def test_equal_shards_build_where_the_dirichlet_split_cannot():
    """At n = 1000 no Dirichlet(0.5) split of the workload's data gives
    every node two samples, in both packages; ``shards="equal"`` builds
    the same-shaped workload on equal shards."""
    with pytest.raises(RuntimeError) as want:
        jt.mlp_runner_factory(1000)
    with pytest.raises(RuntimeError) as got:
        tt.mlp_runner_factory(1000, device="cpu")
    assert str(got.value) == str(want.value)
    runner = tt.mlp_runner_factory(1000, shards="equal",
                                   device="cpu")(tt.Candidate())
    assert tt.shape_of(runner.cfg, runner.params).key() == \
        "cpu|n=1000|d=1580|devices=1|net=0"
    sizes = [len(node.indices) for node in runner.batcher.nodes]
    assert len(sizes) == 1000 and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match="shards"):
        tt.mlp_runner_factory(8, shards="writers", device="cpu")
