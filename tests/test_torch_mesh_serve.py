"""The zoo's serve step and prefill on a device mesh
(``make_serve_step(..., mesh=...)``, ``make_prefill_step(..., mesh=...)``,
``repro_torch.dlrt.mesh_serve``) over gloo ranks on the CPU, against the
reference's serve step and prefill jitted with the dry run's shardings on
a mesh of the same layout.

The ranks run through ``repro_torch.launch.start`` (one process a rank,
one thread each): four ranks on a ``("data", "model")`` (2, 2) mesh, eight
on ``("pod", "data", "model")`` (2, 2, 2), both started together.  The
reference runs meanwhile in two fresh interpreters with eight XLA CPU
devices each (``tests/_mesh_serve_reference.py``), which save an ``.npz``
each; this process draws the parameters every rank and the reference
load, and runs the one-rank layouts.  The ranks' code is
``tests/_mesh_serve_cases.py``: reduced configs in f32, n = 4 nodes of 2
requests (Jamba's: n = 2, one node a ``pod`` rank on the cube), node i's
parameters drawn by the port, 8 tokens decoded from position 0 on both
sides.  Checks:

* ``distribute_params`` / ``distribute_cache`` then ``gather_tree``: bit
  for bit; ``init_mesh_caches``' local shapes the specs' ``shard_shape``
  and zeros; this rank's bytes the port's dry-run ``per_card_bytes`` of
  the same trees (Llama and Qwen on (2, 2), Qwen on (2, 2, 2));
* 8 decode steps against the reference's sharded jit: logits within
  1e-4, the gathered caches within 1e-5 (and 1e-5 of their size), every
  rank's logits and caches
  bit for bit rank 0's, for Llama (node_dp, head_dim over ``model``),
  Llama with ``window=4`` over a 4-slot ring, Qwen (node_fsdp, each
  node's batch over ``data``), Jamba with its experts on (2, 2, 2) (the
  Mamba states over ``model``, the MoE layers routing the node's whole
  batch), RWKV-6 (the WKV and token-shift states) and Whisper-tiny (its
  cross caches split too);
* Whisper with an odd head_dim (33) at n = 2, whose caches split over
  their KV heads instead, 4 steps against the one-device step: logits
  within 1e-5;
* the mesh prefill against the reference's sharded prefill within 1e-4
  (Llama, Qwen, Jamba with its experts on (2, 2, 2), whose MoE layers
  route the node's whole batch, RWKV-6, and Whisper with its frames
  cut to this rank's share as the tokens are), Jamba's also against the
  one-device prefill within 1e-5; on Llama and Jamba without experts the
  mesh prefill's last logits are the mesh decode's after the same 8
  tokens within 1e-5 (Jamba 2e-5: its Mamba states split over d_state),
  and 1e-5 of their size;
* the caches stay put: no collective of a decode step at 64 slots, the
  parameter gathers (stage ``gather``) left out, is as large as one
  layer's block of the k buffer, and all of them together are smaller;
* on a one-rank (1, 1) or (1, 1, 1) layout the mesh serve step and
  prefill are the one-device step's and prefill's bits;
* a ``kv_spec`` that is not ``serve_kv_spec`` raises ``ValueError``.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import torch.distributed as dist                             # noqa: E402

from repro_torch.dlrt import PartitionSpec as P, make_serve_step  # noqa: E402
from repro_torch.launch import MeshLayout, start             # noqa: E402

import _mesh_serve_cases as sc                               # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TWO_BY_TWO = {"axes": ("data", "model"), "sizes": (2, 2)}
CUBE = {"axes": ("pod", "data", "model"), "sizes": (2, 2, 2)}
BASE = {"n": 4, "b": 2, "steps": 8, "max_len": 16}
LOGIT_ATOL = 1e-4
# f32 states of size up to 4: 1e-5, and 1e-5 of their size.
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
# A Mamba state split over d_state adds y's partial sums over the ranks,
# so the mesh decode's logits move by about 1e-5 of their size at
# Jamba's 8 layers (the reference's own sharded decode moves 1.3e-5 from
# its unsharded one); the prefill reads the whole state.
PREFILL_DECODE_TOL = {"llama": dict(atol=1e-5, rtol=1e-5),
                      "jamba-dense": dict(atol=2e-5, rtol=1e-5)}
# Held to the reference's sharded jit.
CASES = {
    "llama": dict(BASE, arch="llama3.2-3b", max_len=64, prefill=True,
                  count=True, roundtrip=True, **TWO_BY_TWO),
    "llama-ring": dict(BASE, arch="llama3.2-3b", window=4, max_len=4,
                       **TWO_BY_TWO),
    "qwen": dict(BASE, arch="qwen1.5-110b", prefill=True, roundtrip=True,
                 **TWO_BY_TWO),
    "jamba-cube": dict(BASE, arch="jamba-1.5-large-398b", n=2,
                       prefill=True, single=True, **CUBE),
    "rwkv": dict(BASE, arch="rwkv6-7b", prefill=True, **TWO_BY_TWO),
    "whisper": dict(BASE, arch="whisper-tiny", prefill=True, **TWO_BY_TWO),
}
# The port's mesh alone: prefill against decode (without experts, whose
# decode has its own capacity).
PORT_CASES = {
    "jamba-dense": dict(BASE, arch="jamba-1.5-large-398b", experts=False,
                        n=2, prefill=True, **TWO_BY_TWO),
    # An odd head_dim: cache_spec puts the KV heads on model instead.
    "whisper-heads": dict(BASE, arch="whisper-tiny", head_dim=33, n=2,
                          steps=4, single=True, **TWO_BY_TWO),
    # The round trip alone on the cube.
    "qwen-cube": dict(BASE, arch="qwen1.5-110b", steps=0, roundtrip=True,
                      **CUBE),
}
ALL = dict(CASES, **PORT_CASES)
# The reference's prefills: every case that prefills (Whisper's with its
# frames).
REFERENCE_PREFILLS = tuple(k for k, c in CASES.items() if c.get("prefill"))
# The reference's cases in two interpreters, run at once (Jamba's
# compile and run are the longest).
REFERENCE_PARTS = (("jamba-cube",), tuple(k for k in CASES
                                          if k != "jamba-cube"))
WORLD8 = ("jamba-cube", "qwen-cube")
WORLD4 = tuple(k for k in ALL if k not in WORLD8)
ONE_RANK = {
    "llama-1x1": dict(BASE, arch="llama3.2-3b", prefill=True,
                      axes=("data", "model"), sizes=(1, 1)),
    "qwen-1x1x1": dict(BASE, arch="qwen1.5-110b", prefill=True,
                       axes=("pod", "data", "model"), sizes=(1, 1, 1)),
}


def one_rank(fn, *args):
    """``fn(*args)`` in this process on a one-rank gloo group, started and
    destroyed here."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=(Path(tmp) / "store")
                                .as_uri(), world_size=1, rank=0)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference's interpreters and the four- and eight-rank
    worlds, draw the parameters they load (the ranks wait for them) and
    run the one-rank layouts here meanwhile, then collect."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    # Every rank of a case, and the reference, load its parameters from
    # one draw here.
    files = {}
    for c in list(ALL.values()) + list(ONE_RANK.values()):
        files.setdefault(_params_key(c), str(tmp / f"params{len(files)}.pt"))
    drawn = lambda c: dict(c, params=files[_params_key(c)])
    refs = []
    for part in REFERENCE_PARTS:
        cases = tmp / f"cases{len(refs)}.json"
        cases.write_text(json.dumps({k: dict(
            drawn(CASES[k]), prefill=k in REFERENCE_PREFILLS) for k in part}))
        refs.append((tmp / f"ref{len(refs)}.npz", subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_mesh_serve_reference.py"),
             str(cases), str(tmp / f"ref{len(refs)}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reference = {}
    try:
        jobs = {8: start(sc.rank_main, 8, [drawn(ALL[k]) for k in WORLD8],
                         device="cpu", threads=1),
                4: start(sc.rank_main, 4, [drawn(ALL[k]) for k in WORLD4],
                         device="cpu", threads=1)}
        done = set()
        for c in [ALL[k] for k in WORLD8 + WORLD4] + list(ONE_RANK.values()):
            if _params_key(c) not in done:
                done.add(_params_key(c))
                sc.save_params(c, files[_params_key(c)])
        single = {k: (one_rank(sc.serve, drawn(c)), sc.one_device(drawn(c)))
                  for k, c in ONE_RANK.items()}
        got = {w: job.join() for w, job in jobs.items()}
        for path, proc in refs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            with np.load(path) as z:
                reference.update((k, z[k]) for k in z.files)
    finally:
        for _, proc in refs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = {k: [rank[i] for rank in got[4]] for i, k in enumerate(WORLD4)}
    ranks.update({k: [rank[i] for rank in got[8]]
                  for i, k in enumerate(WORLD8)})
    return {"ranks": ranks, "single": single, "reference": reference}


def _params_key(case):
    return (case["arch"], case.get("experts", True), case["n"],
            case.get("head_dim"))


def reference_of(runs, name, what):
    ref = runs["reference"]
    if what == "cache":
        head = f"{name}/cache/"
        return {k[len(head):]: v for k, v in ref.items()
                if k.startswith(head)}
    return ref[f"{name}/{what}"]


@pytest.mark.parametrize("name", ["llama", "qwen", "qwen-cube"])
def test_distribute_then_gather_is_the_tree(runs, name):
    for rank in runs["ranks"][name]:
        got = rank["roundtrip"]
        assert got["bitwise"] and got["shapes"] and got["zeros"], got
        assert got["bytes"] == got["dryrun_bytes"], got
        assert got["split"] > 0, got         # some cache leaves are split


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_matches_reference(runs, name):
    """The reference's sharded jit: logits 1e-4, caches 1e-5; every rank
    the same bits."""
    results = runs["ranks"][name]
    assert len(results) == np.prod(CASES[name]["sizes"])
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        assert np.array_equal(other["logits"], first["logits"]), r
        for k, v in first["cache"].items():
            assert np.array_equal(other["cache"][k], v), (r, k)
    want = reference_of(runs, name, "logits")
    assert first["logits"].shape == want.shape
    for t in range(CASES[name]["steps"]):
        np.testing.assert_allclose(first["logits"][t], want[t],
                                   atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {t}")
    cache = reference_of(runs, name, "cache")
    assert sorted(first["cache"]) == sorted(cache)
    for path, v in cache.items():
        np.testing.assert_allclose(first["cache"][path], v, err_msg=path,
                                   **CACHE_TOL)


@pytest.mark.parametrize("name", REFERENCE_PREFILLS)
def test_mesh_prefill_matches_reference(runs, name):
    results = runs["ranks"][name]
    for other in results[1:]:
        assert np.array_equal(other["prefill"], results[0]["prefill"])
    np.testing.assert_allclose(results[0]["prefill"],
                               reference_of(runs, name, "prefill"),
                               atol=LOGIT_ATOL, rtol=0)


def test_mesh_prefill_routes_the_whole_batch(runs):
    """Jamba with its experts on (2, 2, 2): each node's batch over
    ``data``, the MoE layers gathering its rows; every rank the same
    bits, and the one-device prefill within 1e-5."""
    results = runs["ranks"]["jamba-cube"]
    for other in results[1:]:
        assert np.array_equal(other["prefill"], results[0]["prefill"])
    np.testing.assert_allclose(results[0]["prefill"],
                               results[0]["single"]["prefill"], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", list(PREFILL_DECODE_TOL))
def test_mesh_prefill_is_mesh_decode(runs, name):
    got = runs["ranks"][name][0]
    np.testing.assert_allclose(got["prefill"], got["logits"][-1],
                               **PREFILL_DECODE_TOL[name])


def test_mesh_decode_with_kv_heads_split_is_one_device(runs):
    """Whisper with head_dim 33 on (2, 2): its self- and cross-attention
    caches split over their KV heads, each rank's heads attended locally
    and their outputs gathered; every rank the same bits, and the
    one-device step's logits and caches within 1e-5."""
    case = PORT_CASES["whisper-heads"]
    assert sc.serve_kv_spec(MeshLayout(case["axes"], case["sizes"]),
                            sc.config(case), case["b"]) == \
        P(None, None, "model", None)
    results = runs["ranks"]["whisper-heads"]
    for other in results[1:]:
        assert np.array_equal(other["logits"], results[0]["logits"])
    got, one = results[0], results[0]["single"]
    np.testing.assert_allclose(got["logits"], one["logits"], atol=1e-5,
                               rtol=0)
    for k, v in one["cache"].items():
        np.testing.assert_allclose(got["cache"][k], v, err_msg=k,
                                   **CACHE_TOL)


def test_decode_collectives_never_carry_a_cache_block(runs):
    """One decode step at 64 slots: every collective but the parameter
    gathers smaller than one layer's k block, and all of them too."""
    for rank in runs["ranks"]["llama"]:
        block = rank["block_bytes"]
        assert block == 2 * 64 * 4 * 32 * 4    # [b, t, kvh, hd / 2] f32
        records = rank["collectives"]
        stages = {s for s, _, _ in records}
        assert stages <= {"gather", "decode", "collect"}, stages
        assert "gather" in stages and "decode" in stages, stages
        rest = [nb for s, _, nb in records if s != "gather"]
        assert max(rest) < block and sum(rest) < block, (rest, block)


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_layout_is_the_one_device_step(runs, name):
    mesh, one = runs["single"][name]
    assert np.array_equal(mesh["logits"], one["logits"])
    assert np.array_equal(mesh["prefill"], one["prefill"])
    assert list(mesh["cache"]) == list(one["cache"])
    for k, v in one["cache"].items():
        assert np.array_equal(mesh["cache"][k], v), k


def test_wrong_kv_spec_raises():
    """A call checks ``kv_spec`` against ``serve_kv_spec`` at its own
    batch, before it reads the state."""
    cfg = sc.mc.config("llama3.2-3b")
    layout = MeshLayout(("data", "model"), (1, 1))
    assert sc.serve_kv_spec(layout, cfg, 2) == P(None, None, None, None)

    def call():
        step = make_serve_step(cfg, kv_spec=P(None, None, None, "model"),
                               mesh=layout.device_mesh("cpu"))
        with pytest.raises(ValueError, match="serve_kv_spec"):
            step(None, None, torch.zeros((1, 2, 1), dtype=torch.long), 0)
    one_rank(call)
