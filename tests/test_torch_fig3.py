"""The fig3 contest on the port: the chunked mix's bits, the compressed
mixing math, and the port's two benchmark scripts at smoke depth.

* Chunk pin: ``tensordot_mix_leaf`` (and the mixing wrappers) give the
  same bits whatever ``chunk_d`` on the CPU, at n = 50 and at GN-LeNet's
  full-width leaf shapes, and agree with the reference's
  ``tensordot_mix_leaf`` within f32 rounding (1e-5: n = 50 products of
  unit-scale values summed in another order); a chunked runner run is
  bitwise the whole-leaf run, with and without a codec.
* ``apply_consensus_correction`` / ``apply_mixing_compressed`` against
  the reference's within 1e-5, and the gamma = 1 association exactly.
* ``python -m repro_torch.bench.fig3`` and ``...fig13`` at smoke depth on
  the CPU write schema-1 JSON with the reference's keys and the right
  acceptance arithmetic, without loading JAX, and their ``sharded/`` rows
  from two gloo ranks.
"""
import json
import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp                                      # noqa: E402

from repro.core import mixing as jmix                        # noqa: E402
from repro_torch.bench import fig3                           # noqa: E402
from repro_torch.core import mixing as tmix                  # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# GN-LeNet CIFAR-10 at width 32, per node: (leaf shape, in leaf order).
GN_LENET_SHAPES = [(32,), (5, 5, 3, 32), (64,), (5, 5, 32, 64), (10,),
                   (4096, 10), (32,), (32,), (64,), (64,)]
SMOKE = ["--nodes", "6", "--rounds", "4", "--eval-every", "2", "--width",
         "4", "--image-size", "8", "--samples", "1200", "--test-samples",
         "64", "--device", "cpu"]


def _w(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("n", [50, 7])
def test_tensordot_mix_leaf_chunked_is_bitwise(n):
    rng = np.random.default_rng(n)
    w = _w(n, n + 1)
    for shape in GN_LENET_SHAPES + [(6442,), (1025,)]:
        x = rng.normal(size=(n,) + shape).astype(np.float32)
        whole = tmix.tensordot_mix_leaf(torch.as_tensor(w),
                                        torch.as_tensor(x))
        assert whole.shape == x.shape
        d = int(np.prod(shape))
        for chunk in (333, 1024, 5000) + ((1, 7) if d <= 64 else ()):
            got = tmix.tensordot_mix_leaf(torch.as_tensor(w),
                                          torch.as_tensor(x), chunk)
            assert torch.equal(got, whole), (shape, chunk)
        want = jmix.tensordot_mix_leaf(jnp.asarray(w), jnp.asarray(x), 1024)
        np.testing.assert_allclose(whole.numpy(), np.asarray(want),
                                   atol=1e-5, err_msg=str(shape))


def test_mixing_wrappers_chunked_are_bitwise():
    """The wrappers the engine calls, with ``chunk_d``, on bf16 and f32
    leaves; the masked mix builds its W from the edges."""
    n = 50
    rng = np.random.default_rng(0)
    stacked = OrderedDict(
        (str(i), torch.as_tensor(rng.normal(size=(n,) + s)
                                 .astype(np.float32)))
        for i, s in enumerate(GN_LENET_SHAPES[:4]))
    stacked["bf16"] = torch.as_tensor(
        rng.normal(size=(n, 300)).astype(np.float32)).to(torch.bfloat16)
    w = torch.as_tensor(_w(n, 1))
    edges = torch.as_tensor(rng.random((n, n)) < 0.06)
    for chunk in (100, 1024):
        for got, want in (
                (ops.mix_pytree(w, stacked, chunk), ops.mix_pytree(w,
                                                                  stacked)),
                (ops.mix_masked_pytree(edges, stacked, chunk),
                 ops.mix_masked_pytree(edges, stacked)),
                (tmix.apply_mixing(w, stacked, chunk),
                 tmix.apply_mixing(w, stacked))):
            for key in stacked:
                assert got[key].dtype == stacked[key].dtype
                assert torch.equal(got[key], want[key]), (key, chunk)


def test_consensus_correction_matches_reference():
    n = 8
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 40)).astype(np.float32)}
    dec = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 1e-2)
           for k, v in tree.items()}
    w = _w(n, 3)
    tt = OrderedDict((k, torch.as_tensor(v)) for k, v in tree.items())
    td = OrderedDict((k, torch.as_tensor(v)) for k, v in dec.items())
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    jd = {k: jnp.asarray(v) for k, v in dec.items()}
    for gamma in (1.0, 0.5, 0.25):
        got = tmix.apply_mixing_compressed(torch.as_tensor(w), tt, td,
                                           chunk_d=16, gamma=gamma)
        want = jmix.apply_mixing_compressed(jnp.asarray(w), jt, jd,
                                            chunk_d=16, gamma=gamma)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5, err_msg=f"{k} {gamma}")
        mixed = tmix.apply_mixing(torch.as_tensor(w), td)
        corr = tmix.apply_consensus_correction(mixed, tt, td, gamma)
        for k in tree:
            if gamma == 1.0:
                assert torch.equal(corr[k], mixed[k] + (tt[k] - td[k]))
            else:
                assert torch.equal(corr[k],
                                   tt[k] + gamma * (mixed[k] - td[k]))
            assert torch.equal(corr[k], got[k])
    # An identity row gives the node's own parameters back when the
    # replicas are the parameters.
    same = tmix.apply_mixing_compressed(torch.eye(n), tt, tt)
    for k in tree:
        assert torch.equal(same[k], tt[k])


@pytest.mark.parametrize("name,compress", [
    ("morph", "none"), ("static", "none"), ("fully-connected", "none"),
    ("morph", "int8+topk0.75")])
def test_chunked_runner_run_is_bitwise(name, compress):
    args = fig3.parse_args(SMOKE)
    runs = [fig3.build(args, 6, name, mix_chunk_d=chunk, compress=compress)
            for chunk in (None, 7)]
    for runner in runs:
        runner.run()
    assert fig3.params_equal(runs[0].params, runs[1].params)
    assert all(np.array_equal(a, b) for a, b in
               zip(runs[0].edge_history, runs[1].edge_history))


def _run_scripts(bench_dir):
    """Both scripts at smoke depth in a fresh interpreter, which must not
    have loaded JAX by the end."""
    code = ("import sys\n"
            "from repro_torch.bench import fig3, fig13\n"
            f"fig3.main({SMOKE!r})\n"
            f"fig13.main({SMOKE!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", BENCH_DIR=str(bench_dir),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _records(path):
    data = json.loads(path.read_text())
    assert data["schema_version"] == 1
    assert data["backend"] == "cpu" and data["torch"] == torch.__version__
    assert "jax" not in data
    return {r["key"]: r for r in data["records"]}


def test_bench_scripts_write_schema_and_gate(tmp_path):
    out = _run_scripts(tmp_path)
    rec = _records(tmp_path / "BENCH_torch_fig3_accuracy.json")
    n = 6
    finals = {}
    for name in fig3.STRATEGIES + ("morph-sparse",):
        r = rec[f"final/{name}_n{n}"]
        finals[name] = r["fidelity"]["accuracy"]
        assert r["value"] == round(finals[name], 4)
        assert r["shape"] == {"backend": "cpu", "n": n, "d": 1466,
                              "devices": 1, "net": 0}
        assert f"reference/{name}_n{n},got=" in out
    for name in fig3.STRATEGIES:
        assert [k for k in rec if k.startswith(f"curve/{name}_n{n}/")] == \
            [f"curve/{name}_n{n}/r{r}" for r in (0, 2, 3)]
    assert rec[f"conformance/chunk_bitwise_n{n}"]["value"] == 1
    ok = finals["morph"] >= finals["static"] \
        and finals["morph"] >= finals["el-oracle"]
    assert rec[f"acceptance/morph_ge_baselines_n{n}"]["value"] == int(ok)
    for key, other in (("static", "static"), ("el", "el-oracle")):
        assert rec[f"derived/morph_minus_{key}_n{n}"]["value"] == \
            float(f"{finals['morph'] - finals[other]:.4f}")
    row = rec[f"sharded/morph_n{n}"]
    assert row["collective_bytes"] > 0 and row["rounds"] == 1
    assert row["knobs"] == {"devices": 2, "collective": "psum",
                            "mix_chunk_d": 1024}

    rec = _records(tmp_path / "BENCH_torch_fig13_compress.json")
    specs = ("none", "int8", "fp8", "int8_topk0_75", "int8_topk0_25")
    acc = {s: rec[f"final/{s}_n{n}"]["fidelity"]["accuracy"] for s in specs}
    nbytes = {s: rec[f"bytes/{s}_n{n}"]["value"] for s in specs}
    assert nbytes["int8"] == nbytes["fp8"] < nbytes["none"]
    for s in specs[1:]:
        assert rec[f"derived/bytes_ratio_{s}_n{n}"]["value"] == \
            float(f"{nbytes['none'] / nbytes[s]:.2f}")
        assert rec[f"derived/acc_delta_{s}_n{n}"]["value"] == \
            float(f"{acc[s] - acc['none']:+.4f}")
    star = "int8_topk0_75"
    assert rec[f"acceptance/bytes_ge_4x_n{n}"]["value"] == \
        int(nbytes["none"] / nbytes[star] >= 4.0)
    assert rec[f"acceptance/acc_within_2pts_n{n}"]["value"] == \
        int(acc[star] >= acc["none"] - 0.02)
    # The sharded/ rows (the scripts' default --hlo-devices 2): one round's
    # collective bytes on two gloo ranks, compressed specs below none's.
    sharded = {k: r for k, r in rec.items() if k.startswith("sharded/")}
    assert sorted(sharded) == sorted(f"sharded/{s}_n{n}" for s in specs)
    for r in sharded.values():
        assert r["collective_bytes"] > 0 and r["rounds"] == 1
        assert r["knobs"]["devices"] == 2
        assert r["knobs"]["collective"] == "gather"
    assert sharded[f"sharded/int8_n{n}"]["collective_bytes"] < \
        sharded[f"sharded/none_n{n}"]["collective_bytes"]
