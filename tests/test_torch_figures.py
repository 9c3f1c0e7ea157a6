"""The port's figure scripts: fig2 and fig67 give the reference's rows
exactly (graph and protocol only, numpy on both sides), and fig3_curves,
fig9 and fig12 run at smoke depth in a fresh interpreter that never loads
JAX, writing the harness schema."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import repro.core as jcore                                   # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
from benchmarks import fig2_connectivity, fig67_isolation    # noqa: E402
from repro_torch.bench import fig2, fig67                    # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _rows(path):
    data = json.loads(Path(path).read_text())
    assert data["schema_version"] == 1
    return [(r["key"], r.get("value"), r.get("trials"))
            for r in data["records"]]


def _strategies(pkg, n, k):
    deg = k if (n * k) % 2 == 0 else k + 1
    return {
        "el": lambda: pkg.EpidemicStrategy(n=n, k=k, seed=0),
        "morph": lambda: pkg.MorphProtocol(pkg.MorphConfig(n=n, k=k,
                                                           seed=0)),
        "morph-slack": lambda: pkg.MorphProtocol(pkg.MorphConfig(
            n=n, k=k, k_out=k + 1, seed=0)),
        "static": lambda: pkg.StaticStrategy(n=n, degree=deg, seed=0),
    }


@pytest.mark.parametrize("n,k", [(12, 3), (20, 5), (30, 7)])
@pytest.mark.parametrize("name", ["el", "morph", "morph-slack", "static"])
def test_fig67_run_metrics_exact(name, n, k):
    params = {"w": np.random.default_rng(0).normal(size=(n, 64))
              .astype(np.float32)}
    want = fig67_isolation.run_metrics(_strategies(jcore, n, k)[name](), 8,
                                       n, k, params)
    got = fig67.run_metrics(_strategies(tcore, n, k)[name](), 8, n, k,
                            params)
    assert got == want


def test_fig67_rows_exact(tmp_path, monkeypatch):
    argv = ["--nodes", "24", "--rounds", "6", "--ks", "3", "5"]
    monkeypatch.setenv("BENCH_DIR", str(tmp_path))
    want = fig67_isolation.main(argv)
    got = fig67.main(argv)
    assert got == want
    assert _rows(tmp_path / "BENCH_torch_fig67.json") == \
        _rows(tmp_path / "BENCH_fig67.json")


def test_fig2_rows_exact(tmp_path, monkeypatch):
    argv = ["--trials", "12", "--sizes", "30", "120"]
    monkeypatch.setenv("BENCH_DIR", str(tmp_path))
    want = fig2_connectivity.main(argv)
    got = fig2.main(argv)
    assert got == want
    rows = _rows(tmp_path / "BENCH_torch_fig2.json")
    assert rows == _rows(tmp_path / "BENCH_fig2.json")
    assert rows[-1][0] == "derived/min_p_connected_at_dr2"
    assert len(rows) == 2 * 12 + 1


SMOKE = {"fig3_curves": ["--rounds", "4", "--nodes", "4", "--device", "cpu"],
         "fig9": ["--nodes", "6", "--rounds", "12", "--chunk", "4",
                  "--device", "cpu"],
         "fig12": ["--nodes", "12", "30", "--rounds", "3", "--dense-max",
                   "20", "--device", "cpu"],
         "fig2": ["--trials", "4", "--sizes", "20"],
         "fig67": ["--nodes", "12", "--rounds", "3", "--ks", "3"]}


def _records(path):
    data = json.loads(path.read_text())
    assert data["schema_version"] == 1
    assert data["backend"] == "cpu" and data["torch"] == torch.__version__
    assert "jax" not in data
    return {r["key"]: r for r in data["records"]}


def test_figure_scripts_without_jax(tmp_path):
    """fig3_curves, fig9, fig12, fig2 and fig67 at smoke depth in a fresh
    interpreter, which must not have loaded JAX or the reference by the
    end; ``"auto"`` on the CPU resolves to the hand-set defaults."""
    code = ("import sys\n"
            "from repro_torch.bench import fig3_curves, fig9, fig12, fig2, "
            "fig67\n"
            + "".join(f"{name}.main({argv!r})\n"
                      for name, argv in SMOKE.items())
            + "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
              "             in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", BENCH_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TORCH_TUNE_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    rec = _records(tmp_path / "BENCH_torch_fig3_curves.json")
    for name in ("fully-connected", "morph", "el-oracle", "static"):
        for rnd in (0, 3):
            fid = rec[f"{name}/r{rnd}"]["fidelity"]
            assert set(fid) == {"accuracy", "loss", "internode_var"}
            assert np.isfinite(fid["loss"])
    el = rec["el-oracle/r3"]["fidelity"]["internode_var"]
    morph = rec["morph/r3"]["fidelity"]["internode_var"]
    if morph > 0:
        assert rec["derived/el_var_over_morph_var"]["value"] == \
            float(f"{el / max(morph, 1e-6):.1f}")

    rec = _records(tmp_path / "BENCH_torch_fig9.json")
    for engine in ("host-protocol", "host-ingraph", "compiled",
                   "compiled-auto"):
        assert rec[f"{engine}/n6"]["rounds_per_sec"] > 0
    key = "cpu|n=6|d=1580|devices=1|net=0"
    assert rec["compiled/n6"]["knobs"]["source"] == "explicit"
    assert rec["compiled-auto/n6"]["knobs"] == {
        "chunk": None, "engine": "dense", "compress": "none",
        "source": f"default:{key}", "timed_chunk": 4}
    assert rec["compiled/n6"]["shape"] == {"backend": "cpu", "n": 6,
                                           "d": 1580, "devices": 1,
                                           "net": 0}
    for ratio in ("compiled_over_host_protocol", "compiled_over_host_ingraph",
                  "auto_over_default"):
        assert f"derived/{ratio}_n6" in rec

    rec = _records(tmp_path / "BENCH_torch_fig12.json")
    assert "throughput/dense_n12" in rec and "throughput/sparse_n12" in rec
    assert "throughput/dense_n30" not in rec          # past --dense-max
    for key in ("throughput/dense_n12", "throughput/sparse_n12",
                "throughput/sparse_n30"):
        row = rec[key]
        assert row["rounds_per_sec"] > 0 and row["rounds_per_call"] == 3
        assert row["calls"] == 4                      # warm + best of 3
        assert set(row["launches"].values()) == {0}   # plain versions
        assert "peak_memory_bytes" not in row
    assert rec["throughput/sparse_n12"]["knobs"]["engine"] == "sparse"
    assert "derived/sparse_over_dense_n12" in rec
    assert "derived/sparse_over_dense_n30" not in rec
    assert rec["derived/crossover_n"]["value"] in (12, "none")
    for prefix in ("hlo_only/", "collective/", "derived/flops_drop",
                   "derived/collective_drop"):
        assert not any(k.startswith(prefix) for k in rec)

    assert "derived/min_p_connected_at_dr2" in \
        _records(tmp_path / "BENCH_torch_fig2.json")
    assert "derived/slack_helps_isolation" in \
        _records(tmp_path / "BENCH_torch_fig67.json")


def test_fig10_without_jax(tmp_path):
    """fig10 at smoke depth (two gloo ranks, n = 8, 4 rounds) in a fresh
    interpreter that never loads JAX: one row of rounds a second over a
    padded node axis, the shape naming the mesh's two devices."""
    code = ("import sys\n"
            "from repro_torch.bench import fig10\n"
            "fig10.main(['--device', 'cpu', '--devices', '2', '--nodes', "
            "'7', '--rounds', '4', '--chunk', '2'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", BENCH_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = _records(tmp_path / "BENCH_torch_fig10.json")
    row = rec["sharded-d2/n7"]
    assert row["rounds_per_sec"] > 0 and row["rounds"] == 4
    assert row["shape"] == {"backend": "cpu", "n": 7, "d": 1580,
                            "devices": 2, "net": 0}
    assert row["knobs"]["backend"] == "gloo"
    assert set(row["launches"].values()) == {0}       # plain versions
    assert rec["per_round_ms/d2_n7"]["wall_clock_s"] > 0
    assert not any(k.startswith("derived/") for k in rec)
