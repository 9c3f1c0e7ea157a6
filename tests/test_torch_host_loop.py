"""The runner's host loop against the reference's, against the port's own
round engine, and its dispatch.

Reference side: ``repro.dlrt.DecentralizedRunner``'s per-round host loop
driving ``benchmarks/common.py``'s ``make_strategy`` strategies (the
message-faithful Morph protocol, Static, EL-Oracle, fully-connected), and
for EL-Local the reference's compiled engine with the Pallas kernels in
interpret mode.  Port side: ``repro_torch.dlrt.DecentralizedRunner`` on the
CPU from the same initial parameters (``params_from_jax``) and the same
host batches, with ``repro_torch.bench.common``'s strategies; EL-Local gets
the reference's ``jax.random`` draws replayed.

Tolerances: edges identical every round, comm bytes and isolated counts
exact; parameters, accuracy and loss within 1e-4 (the two sides sum the
local step and the mix in other orders).  The host loop against the port's
own engine is bit for bit: the same local step, the same strategy state
and the same mixing kernels.
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

import benchmarks.common as jcommon                          # noqa: E402
import repro.core as jcore                                   # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.dlrt.runtime as runtime                   # noqa: E402
from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification, train_test_split)
from repro.data.pipeline import StackedBatcher as JaxBatcher  # noqa: E402
from repro.dlrt import (DecentralizedRunner as JaxRunner,    # noqa: E402
                        MetricsLog as JaxLog, RoundRecord as JaxRecord,
                        RunnerConfig as JaxConfig)
from repro.models.cnn import cnn_loss as jax_cnn_loss        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro.models.tiny import mlp_loss as jax_mlp_loss       # noqa: E402
from repro.models.tiny import mlp_params as jax_mlp_params   # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.bench import common                         # noqa: E402
from repro_torch.data import DeviceDataStream, StackedBatcher  # noqa: E402
from repro_torch.dlrt import (DecentralizedRunner,           # noqa: E402
                              MetricsLog, RoundRecord, RunnerConfig)
from repro_torch.models import (cnn_loss, cnn_params,        # noqa: E402
                                mlp_loss, mlp_params)
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import params_from_jax                 # noqa: E402

from _jax_draws import el_draw                               # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, ROUNDS, EVAL_EVERY = 8, 11, 5     # negotiations at 0, 5 and 10
MODELS = {
    # (reference init, reference loss, port init, port loss)
    "mlp": (lambda key: jax_mlp_params(key), jax_mlp_loss,
            lambda g: mlp_params(g), mlp_loss),
    "gn-lenet": (lambda key: jax_cnn_params(key, in_channels=3,
                                            num_classes=4, image_size=8,
                                            width=4),
                 jax_cnn_loss,
                 lambda g: cnn_params(g, in_channels=3, num_classes=4,
                                      image_size=8, width=4),
                 cnn_loss),
}
TABLE1 = ("morph", "static", "el-oracle", "fully-connected")


def _data(n=N):
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    return tr, parts, {"images": te.images[:64], "labels": te.labels[:64]}


def _exp(n=N, k=2):
    """The same experiment knobs for both sides' strategy factories."""
    kw = dict(n_nodes=n, k=k, seed=0)
    return jcommon.ExpConfig(**kw), common.ExpConfig(**kw)


def _pair(model, make_ref, make_port, *, ref_cfg=None, port_cfg=None,
          n=N, rounds=ROUNDS):
    """The reference runner and the port's on the same set-up, not run."""
    jinit, jloss, _, tloss = MODELS[model]
    tr, parts, test = _data(n)
    ref = JaxRunner(
        init_fn=jinit, loss_fn=jloss, eval_fn=jloss,
        optimizer=jax_sgd(0.05), batcher=JaxBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=make_ref(),
        cfg=ref_cfg or JaxConfig(n_nodes=n, rounds=rounds,
                                 eval_every=EVAL_EVERY))
    port = DecentralizedRunner(
        init_fn=None, loss_fn=tloss, eval_fn=tloss, optimizer=sgd(0.05),
        batcher=StackedBatcher(tr, parts, 8, seed=3), test_batch=test,
        strategy=make_port(),
        cfg=port_cfg or RunnerConfig(n_nodes=n, rounds=rounds,
                                     eval_every=EVAL_EVERY),
        params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      ref.params)),
        device="cpu")
    return ref, port


def assert_matches_reference(ref, port, rounds=ROUNDS):
    assert len(port.edge_history) == len(ref.edge_history) == rounds
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
        assert b.mean_accuracy == pytest.approx(a.mean_accuracy, abs=1e-4)
        assert b.mean_loss == pytest.approx(a.mean_loss, abs=1e-4)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("name", TABLE1)
def test_host_loop_matches_the_reference_host_loop(model, name):
    """The four Table-I strategies as ``make_strategy`` builds them, through
    both host loops."""
    jexp, texp = _exp()
    ref, port = _pair(model, lambda: jcommon.make_strategy(name, jexp),
                      lambda: common.make_strategy(name, texp))
    ref.run()
    port.run()
    assert_matches_reference(ref, port)
    if name == "morph":
        a, b = port.strategy, ref.strategy
        assert (a.control_messages, a.similarity_floats) == \
            (b.control_messages, b.similarity_floats)
        assert np.array_equal(a.view_sizes(), b.view_sizes())


class ReplayELLocal(tcore.InGraphEpidemicLocalStrategy):
    """Port EL-Local fed the reference's per-round Gumbel draw (the same
    ``fold_in(PRNGKey(seed), rnd)`` scores EL-Oracle draws)."""

    def graph_round(self, gstate, rnd, sim, noise=None):
        return super().graph_round(gstate, rnd, sim,
                                   noise=el_draw(self.seed, self.n, rnd))


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["engine", "host-loop"])
def test_el_local_matches_the_reference(compiled):
    """EL-Local with the reference's draws: through the reference's
    compiled engine (Pallas in interpret mode) and the port's, or through
    both host loops; identical edges and the same evolved view."""
    n = N
    ref, port = _pair(
        "gn-lenet",
        lambda: jcore.InGraphEpidemicLocalStrategy(n=n, k=2, seed=1),
        lambda: ReplayELLocal(n=n, k=2, seed=1, device="cpu"),
        ref_cfg=JaxConfig(n_nodes=n, rounds=ROUNDS, eval_every=EVAL_EVERY,
                          compiled=compiled, use_pallas=True,
                          interpret=True),
        port_cfg=RunnerConfig(n_nodes=n, rounds=ROUNDS,
                              eval_every=EVAL_EVERY, compiled=compiled))
    ref.run()
    port.run()
    assert_matches_reference(ref, port)
    _, want_view = ref.strategy._gstate
    assert np.array_equal(port.strategy._gstate.numpy(),
                          np.asarray(want_view))
    assert port.strategy._gstate.sum() > port.strategy._view0.sum()


INGRAPH = ("morph", "static", "fully-connected", "el-oracle", "el-local")


@pytest.mark.parametrize("name,sim_every", [(name, 1) for name in INGRAPH]
                         + [("morph", 2)],
                         ids=list(INGRAPH) + ["morph-sim-every-2"])
def test_host_loop_is_the_engine_bit_for_bit(name, sim_every):
    """An in-graph strategy through its ``round_edges`` adapter gives the
    engine's edges, parameters and records bit for bit; Morph also over a
    second run, which both continue from the evolved graph."""
    _, texp = _exp()
    tr, parts, test = _data()
    runs = []
    for compiled in (True, False):
        runner = DecentralizedRunner(
            init_fn=MODELS["gn-lenet"][2], loss_fn=cnn_loss,
            eval_fn=cnn_loss, optimizer=sgd(0.05),
            batcher=StackedBatcher(tr, parts, 8, seed=3), test_batch=test,
            strategy=common.make_ingraph_strategy(name, texp, "cpu"),
            cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS,
                             eval_every=EVAL_EVERY, sim_every=sim_every,
                             compiled=compiled),
            device="cpu")
        for _ in range(2 if name == "morph" else 1):
            runner.run()
        runs.append(runner)
    engine, host = runs
    assert len(host.edge_history) == len(engine.edge_history) \
        * (2 if name == "morph" else 1)
    for r, (a, b) in enumerate(zip(engine.edge_history,
                                   host.edge_history[-ROUNDS:])):
        assert np.array_equal(a, b), f"edges differ at round {r}"
    for key in engine.params:
        assert torch.equal(engine.params[key], host.params[key]), key
    for a, b in zip(engine.log.records,
                    host.log.records[-len(engine.log.records):]):
        assert (a.rnd, a.mean_accuracy, a.mean_loss, a.isolated) == \
            (b.rnd, b.mean_accuracy, b.mean_loss, b.isolated)
    assert host.log.records[-1].comm_bytes == \
        sum(int(e.sum()) for e in host.edge_history) * \
        runtime.stacked_model_bytes(host.params, N)


# ---------------------------------------------------------------------------
# What the host loop hands the strategy, and how it mixes.
# ---------------------------------------------------------------------------

class Spy:
    """Wraps a strategy: records what each ``round_edges`` call is given."""

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def round_edges(self, rnd, stacked_params=None):
        self.seen.append(stacked_params)
        return self.inner.round_edges(rnd, stacked_params)


@pytest.mark.parametrize("name", TABLE1 + ("ingraph-morph", "el-local"))
def test_host_loop_feeds_and_mixes(monkeypatch, name):
    """A host strategy that reads the models gets a host numpy copy every
    ``sim_every`` rounds, one that does not gets none, an in-graph adapter
    the live tensors; every round is one grouped mix (the masked one for a
    uniform strategy), and only in-graph Morph takes a Gram."""
    calls = {"masked": 0, "mix": 0, "gram": 0}
    real = {"masked": runtime.ops.mix_masked_pytree,
            "mix": runtime.ops.mix_pytree,
            "gram": runtime.ops.model_pairwise_cosine}
    for key, attr in (("masked", "mix_masked_pytree"), ("mix", "mix_pytree"),
                      ("gram", "model_pairwise_cosine")):
        monkeypatch.setattr(runtime.ops, attr, lambda *a, _k=key:
                            calls.__setitem__(_k, calls[_k] + 1)
                            or real[_k](*a))
    _, texp = _exp()
    strategy = common.make_ingraph_strategy(
        name.removeprefix("ingraph-"), texp, "cpu") \
        if name in ("ingraph-morph", "el-local") \
        else common.make_strategy(name, texp)
    spy = Spy(strategy)
    tr, parts, test = _data()
    runner = DecentralizedRunner(
        init_fn=MODELS["mlp"][2], loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05), batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=spy,
        cfg=RunnerConfig(n_nodes=N, rounds=6, eval_every=5, sim_every=2,
                         compiled=False),
        device="cpu")
    runner.run()
    reads = getattr(strategy, "needs_params", True)
    for rnd, stacked in enumerate(spy.seen):
        if not reads or rnd % 2:
            assert stacked is None
        else:
            assert list(stacked) == list(runner.params)
            kind = torch.Tensor if name == "ingraph-morph" else np.ndarray
            assert all(isinstance(v, kind) for v in stacked.values())
    uniform = getattr(strategy, "uniform_mixing", False)
    assert calls == {"masked": 6 if uniform else 0,
                     "mix": 0 if uniform else 6,
                     "gram": 3 if name == "ingraph-morph" else 0}


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------

def _runner(strategy, batcher=None, **cfg):
    tr, parts, test = _data()
    return DecentralizedRunner(
        init_fn=MODELS["mlp"][2], loss_fn=mlp_loss, eval_fn=mlp_loss,
        optimizer=sgd(0.05),
        batcher=batcher or StackedBatcher(tr, parts, 8, seed=3),
        test_batch=test, strategy=strategy,
        cfg=RunnerConfig(n_nodes=N, rounds=2, eval_every=1, **cfg),
        device="cpu")


@pytest.mark.parametrize("compiled,host", [
    (None, True), (None, False), (False, True), (False, False),
    (True, False)])
def test_compiled_selects_the_path(monkeypatch, compiled, host):
    """``compiled=None`` takes the engine for an in-graph strategy and the
    host loop otherwise; True and False force one path."""
    _, texp = _exp()
    strategy = common.make_strategy("static", texp) if host \
        else common.make_ingraph_strategy("static", texp, "cpu")
    runner = _runner(strategy, compiled=compiled)
    took = []
    real_engine, real_round = runner._make_engine, runner._round
    monkeypatch.setattr(runner, "_make_engine",
                        lambda: took.append("engine") or real_engine())
    monkeypatch.setattr(runner, "_round",
                        lambda rnd: took.append("host") or real_round(rnd))
    runner.run()
    want = "engine" if compiled or (compiled is None and not host) \
        else "host"
    assert set(took) == {want}
    assert runner.cfg.compiled is compiled


def test_engine_refuses_a_host_strategy():
    _, texp = _exp()
    with pytest.raises(TypeError, match="in-graph"):
        _runner(common.make_strategy("morph", texp), compiled=True).run()


def test_host_loop_refuses_what_only_the_engine_runs():
    """The reference's four refusals: a sparse-native strategy, a network
    model, an enabled codec and a device data stream."""
    from repro_torch.netsim.profiles import dense_network
    from repro_torch.sparse import SparseMorphStrategy
    _, texp = _exp()
    static = common.make_ingraph_strategy("static", texp, "cpu")
    tr, parts, _ = _data()
    cases = [
        (dict(strategy=SparseMorphStrategy(n=N, k=2, device="cpu"),
              engine="sparse"), "sparse-native"),
        (dict(strategy=static, net=dense_network("ideal", N)), "net"),
        (dict(strategy=static, compress="int8"), "compress"),
        (dict(strategy=static, batcher=DeviceDataStream(
            tr, parts, 8, device="cpu")), "DeviceDataStream"),
    ]
    for kw, match in cases:
        with pytest.raises(TypeError, match=match):
            _runner(compiled=False, **kw).run()
    _runner(static, compiled=False, compress="none").run()


def test_metrics_helpers_are_the_reference():
    rows = [(0, 0.2, 1.5, 3.0, 100, 1), (5, 0.45, 1.2, 2.0, 600, 0),
            (10, 0.4, 1.1, 1.0, 1100, 2)]
    ref, port = JaxLog(), MetricsLog()
    for row in rows:
        ref.add(JaxRecord(*row))
        port.add(RoundRecord(*row))
    for target in (0.1, 0.3, 0.45, 0.9):
        assert port.rounds_to_accuracy(target) == \
            ref.rounds_to_accuracy(target)
        assert port.comm_to_accuracy(target) == ref.comm_to_accuracy(target)
    want, got = ref.as_arrays(), port.as_arrays()
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# The benchmark scripts.
# ---------------------------------------------------------------------------

SMOKE = {"table1": ["--rounds", "3", "--nodes", "6", "--device", "cpu"],
         "fig4": ["--rounds", "2", "--nodes", "6", "--ks", "2", "3",
                  "--device", "cpu"],
         "fig5": ["--rounds", "2", "--nodes", "6", "--betas", "5", "500",
                  "--deltas", "1", "5", "--device", "cpu"]}


def _records(path):
    data = json.loads(path.read_text())
    assert data["schema_version"] == 1
    assert data["backend"] == "cpu" and data["torch"] == torch.__version__
    assert "jax" not in data
    return {r["key"]: r for r in data["records"]}


def test_bench_scripts_write_schema(tmp_path):
    """``table1``, ``fig4`` and ``fig5`` at smoke depth in a fresh
    interpreter, which must not have loaded JAX by the end."""
    code = ("import sys\n"
            "from repro_torch.bench import table1, fig4, fig5\n"
            + "".join(f"{name}.main({argv!r})\n"
                      for name, argv in SMOKE.items())
            + "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
              "             in ('jax', 'jaxlib', 'repro'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", BENCH_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

    from repro_torch.bench import table1
    rec = _records(tmp_path / "BENCH_torch_table1.json")
    rows = {name: rec[f"{name}/acc"]["fidelity"]
            for name in table1.STRATEGIES}
    assert rec["derived/ordering"]["value"] == table1.ordering(rows)
    assert sorted(rec["derived/ordering"]["value"].split(">")) == \
        sorted(table1.STRATEGIES)
    morph, el = rows["morph"]["acc"], rows["el-oracle"]["acc"]
    assert rec["derived/morph_over_el"]["value"] == \
        float(f"{morph / max(el, 1e-9):.3f}")
    # Three rounds of n = 6 at k = 3: Morph, EL and Static move 18 models
    # a round, FC 30; GN-LeNet width 12 on 16-pixel images.
    model_bytes = 4 * sum(v.numel() for v in cnn_params(
        None, in_channels=3, num_classes=10, image_size=16,
        width=12).values())
    for name, per_round in (("fully-connected", 30), ("static", 18),
                            ("el-oracle", 18)):
        assert rows[name]["comm_gb"] == 3 * per_round * model_bytes / 1e9
    assert rows["morph"]["comm_gb"] <= 3 * 18 * model_bytes / 1e9
    assert "torch_table1,reference/morph,got=" in proc.stdout

    rec = _records(tmp_path / "BENCH_torch_fig4.json")
    for k in (2, 3):
        for name in ("fully-connected", "morph", "el-oracle"):
            assert f"{name}/k{k}" in rec
        gap = rec[f"derived/gap_to_fc_at_k{k}"]["fidelity"]
        assert gap["morph_gap_pp"] == pytest.approx(
            (rec[f"fully-connected/k{k}"]["value"]
             - rec[f"morph/k{k}"]["value"]) * 100, abs=0.1)

    rec = _records(tmp_path / "BENCH_torch_fig5.json")
    assert [k for k in rec if k.startswith(("beta/", "delta_r/"))] == \
        ["beta/5.0", "beta/500.0", "delta_r/1", "delta_r/5"]
    spread = abs(rec["delta_r/1"]["fidelity"]["best_acc"]
                 - rec["delta_r/5"]["fidelity"]["best_acc"])
    assert rec["derived/delta_r_acc_spread_pp"]["value"] == \
        float(f"{spread * 100:.2f}")


# ---------------------------------------------------------------------------
# The round's stage hook, its lazily built functions, and the divergence
# script.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLE1 + ("ingraph-morph",))
def test_round_stage_hook_is_the_round(name):
    """``_round(rnd, stage)`` runs every stage through the hook, in order,
    and gives the unstaged round's edges and parameters bit for bit."""
    _, texp = _exp()

    def make():
        strategy = common.make_ingraph_strategy("morph", texp, "cpu") \
            if name == "ingraph-morph" else common.make_strategy(name, texp)
        return _runner(strategy, compiled=False)

    plain, staged = make(), make()
    seen = []

    def stage(label, fn):
        seen.append(label)
        return fn()

    for rnd in range(6):
        del seen[:]
        assert np.array_equal(plain._round(rnd), staged._round(rnd, stage))
        reads = getattr(staged.strategy, "needs_params", True) and \
            not getattr(staged.strategy, "in_graph", False)
        assert seen == ["batch", "local_step"] \
            + (["copy_to_host"] if reads else []) + ["strategy", "mix"]
    assert all(torch.equal(plain.params[k], staged.params[k])
               for k in plain.params)
    assert plain._comm_bytes == staged._comm_bytes


def test_engine_run_builds_no_host_round_functions():
    """An engine run leaves the host loop's local step and evaluator
    unbuilt; a host-loop run builds them once."""
    _, texp = _exp()
    engine = _runner(common.make_ingraph_strategy("static", texp, "cpu"))
    engine.run()
    assert "_local_step" not in vars(engine)
    assert "_evaluate" not in vars(engine)
    host = _runner(common.make_strategy("static", texp))
    host.run()
    step = vars(host)["_local_step"]
    host._round(2)
    assert host._local_step is step and "_evaluate" in vars(host)


def test_divergence_script_on_one_device(capsys):
    """``repro_torch.bench.divergence`` with both runs on the CPU: nothing
    differs, and its JSON line says so."""
    from repro_torch.bench import divergence
    out = divergence.main(["--device", "cpu", "--rounds", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["divergence"] == json.loads(json.dumps(out))
    for name in ("morph", "fully-connected"):
        assert out[name]["rounds_with_other_edges"] == 0
        assert out[name]["params_max_abs_apart_after_round"] == \
            {1: 0.0, 3: 0.0}
    morph = out["morph"]
    assert morph["first_divergence"] is None
    assert morph["control_messages"][0] == morph["control_messages"][1] > 0
    assert morph["similarity_floats"][0] == morph["similarity_floats"][1]
