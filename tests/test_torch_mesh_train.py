"""The zoo's train step on a device mesh (``make_train_step(...,
mesh=...)``, ``repro_torch.dlrt.mesh_step``) over gloo ranks on the CPU,
against the reference's step jitted with ``train_state_sharding``'s
shardings on a mesh of the same layout, and against the port's one-device
step.

The ranks run through ``repro_torch.launch.start`` (one process a rank,
one thread each): four ranks on a ``("data", "model")`` (2, 2) mesh (and
four more for Jamba's cases), eight on ``("pod", "data", "model")`` (2, 2,
2), all started together.  The
reference runs meanwhile in three fresh interpreters with eight XLA CPU
devices each (``tests/_mesh_reference.py``), which save an ``.npz`` each;
this process runs the one-rank layouts.  The ranks' code is
``tests/_mesh_cases.py``: reduced configs in f32, every node's parameters
drawn by the port (``model.init_params(cfg, i)``), the same numpy-made
batches on both sides, three rounds with topology on rounds 0 and 2 (for
Jamba two topology rounds), the reference's Morph draws replayed
(``tests/_jax_draws.py`` ``morph_key_draws``).  Checks:

* ``distribute_train_state`` then ``gather_train_state``: the state bit
  for bit, every local shape the spec's ``shard_shape`` (reduced Llama,
  Qwen and DeepSeek-MoE, whose expert banks split over ``model``);
* against the reference's sharded jit: edges identical, parameters within
  1e-4, per-node losses within 1e-5 (``tests/_zoo_parity.py``'s train-step
  tolerances), for node_dp (Llama at n = 4, nodes over ``data``; at
  n = 3, the node axis replicated), node_fsdp (Qwen, batch 4 over ``data``
  with ``microbatch=2``; Qwen under a ``chain_clip`` that binds, which a
  shard-local norm would get wrong), DeepSeek-MoE on eight ranks and
  Jamba with its experts at n = 2 (node_fsdp: each node's batch of 2
  over ``data``, so its MoE layers route rows the other rank holds);
* every rank's edges, similarity estimates, losses and gathered
  parameters bit for bit rank 0's;
* against the one-device step from the same state and draws: edges
  identical, parameters within 1e-5 (the Grams' and the gradients' sums
  over ranks add in another order), every node's optimizer count advanced
  on every rank, also for Jamba with experts at batch 6 with
  ``microbatch=2`` (pieces straddling the ranks, each routed whole); on a
  one-rank (1, 1) or (1, 1, 1) layout bit for bit;
* without replayed draws the ranks negotiate the same edges;
* the launcher's ``--mesh`` branch on four ranks (the production mesh
  patched to (2, 2)): exit 0, rank 0's lines, one checkpoint, written by
  rank 0, that loads to the one-device launcher's shapes.
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

import jax                                                   # noqa: E402
import torch.distributed as dist                             # noqa: E402

from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.launch import start                         # noqa: E402

import _mesh_cases as mc                                     # noqa: E402
from _jax_draws import morph_key_draws                       # noqa: E402
from _zoo_parity import LOSS_TOL, PARAM_ATOL                 # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ONE_DEVICE_ATOL = 1e-5
TWO_BY_TWO = {"axes": ("data", "model"), "sizes": (2, 2)}
CUBE = {"axes": ("pod", "data", "model"), "sizes": (2, 2, 2)}
BASE = {"n": 4, "batch": 2, "rounds": 3, "delta_r": 2, "microbatch": None,
        "opt": "sgd"}
# Held to the reference's sharded jit and to the one-device step.
CASES = {
    "llama-n4": dict(BASE, arch="llama3.2-3b", **TWO_BY_TWO),
    "llama-n3": dict(BASE, arch="llama3.2-3b", n=3, **TWO_BY_TWO),
    "qwen-microbatch": dict(BASE, arch="qwen1.5-110b", batch=4,
                            microbatch=2, **TWO_BY_TWO),
    "qwen-clip": dict(BASE, arch="qwen1.5-110b", opt="clip", **TWO_BY_TWO),
    "deepseek-cube": dict(BASE, arch="deepseek-moe-16b", **CUBE),
    # node_fsdp with experts: the batch over data, so the MoE layers route
    # the node's whole batch across the ranks (fault F4 before).
    # Two topology rounds (the reference compiles one step).
    "jamba-experts": dict(BASE, arch="jamba-1.5-large-398b", n=2, rounds=2,
                          delta_r=1, **TWO_BY_TWO),
}
# Held to the one-device step only: microbatch pieces of 2 rows that
# straddle the two data ranks' 3 rows each.
ONE_DEVICE_CASES = {
    "jamba-microbatch": dict(CASES["jamba-experts"], batch=6, microbatch=2),
}
# The reference's cases in three interpreters, run at once.
REFERENCE_PARTS = (("llama-n4", "llama-n3", "qwen-microbatch"),
                   ("qwen-clip", "deepseek-cube"), ("jamba-experts",))
ROUNDTRIP_ARCHS = ("llama3.2-3b", "qwen1.5-110b", "deepseek-moe-16b")
LAYOUTS = {"2x2": TWO_BY_TWO, "2x2x2": CUBE}
FREE = dict(CASES["llama-n4"], noise=None, single=False)
ONE_RANK = {"llama-1x1": dict(BASE, arch="llama3.2-3b", axes=("data",
                                                              "model"),
                              sizes=(1, 1)),
            "qwen-1x1x1": dict(BASE, arch="qwen1.5-110b", batch=4,
                               microbatch=2, axes=("pod", "data", "model"),
                               sizes=(1, 1, 1))}
LAUNCH = dict(TWO_BY_TWO, argv=["--arch", "llama3.2-3b", "--reduced",
                                "--nodes", "4", "--rounds", "3", "--batch",
                                "2", "--seq", "16", "--stream-len", "2000",
                                "--delta-r", "2", "--log-every", "1",
                                "--device", "cpu", "--mesh", "single"])


def draws(n, rounds):
    """The reference state's Morph draws (its key is ``split(PRNGKey(0))
    [1]``, as ``tests/_zoo_parity.py`` ``reference_state`` gives it)."""
    _, key = jax.random.split(jax.random.PRNGKey(0))
    return morph_key_draws(key, n, rounds)


def with_draws(case):
    return dict(case, noise=draws(case["n"], case["rounds"]), single=True)


def roundtrips(layout):
    return [dict(BASE, arch=a, roundtrip=True, **LAYOUTS[layout])
            for a in ROUNDTRIP_ARCHS]


# Jamba's two cases run in a second world of four ranks, beside the first.
JAMBA_CASES = ["jamba-experts", "jamba-microbatch"]
WORLD4_CASES = [k for k in CASES if k not in JAMBA_CASES + ["deepseek-cube"]]
WORLD4 = ([with_draws(CASES[k]) for k in WORLD4_CASES] + [FREE]
          + roundtrips("2x2"))
JAMBA4 = [with_draws(dict(CASES, **ONE_DEVICE_CASES)[k]) for k in JAMBA_CASES]
WORLD8 = [with_draws(CASES["deepseek-cube"])] + roundtrips("2x2x2")


def one_rank(case):
    """``case`` in this process on a one-rank gloo group, started and
    destroyed here."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=(Path(tmp) / "store")
                                .as_uri(), world_size=1, rank=0)
        try:
            return mc.one_case(case)
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference's interpreter and the four- and eight-rank
    worlds (the four also run the launcher), run the one-rank layouts
    here meanwhile, then collect everything."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    refs = []
    for part in REFERENCE_PARTS:
        cases = tmp / f"cases{len(refs)}.json"
        cases.write_text(json.dumps({k: CASES[k] for k in part}))
        refs.append((tmp / f"ref{len(refs)}.npz", subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_mesh_reference.py"),
             str(cases), str(tmp / f"ref{len(refs)}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ckpt = tmp / "ckpt"
    launch = dict(LAUNCH, argv=LAUNCH["argv"] + ["--checkpoint-dir",
                                                 str(ckpt)])
    reference = {}
    try:
        jobs = {4: start(mc.rank_main, 4, WORLD4 + [launch], device="cpu",
                         threads=1),
                8: start(mc.rank_main, 8, WORLD8, device="cpu", threads=1),
                "jamba": start(mc.rank_main, 4, JAMBA4, device="cpu",
                               threads=1)}
        single = {k: one_rank(with_draws(c)) for k, c in ONE_RANK.items()}
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
    return {"world4": got[4], "world8": got[8], "jamba": got["jamba"],
            "single": single,
            "reference": reference, "ckpt": ckpt}


def per_rank(runs, name):
    """Every rank's result of ``CASES[name]``."""
    if name == "deepseek-cube":
        return [rank[0] for rank in runs["world8"]]
    if name in JAMBA_CASES:
        return [rank[JAMBA_CASES.index(name)] for rank in runs["jamba"]]
    i = WORLD4_CASES.index(name)
    return [rank[i] for rank in runs["world4"]]


def assert_ranks_agree(results):
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        for rnd, (a, b) in enumerate(zip(other["record"], first["record"])):
            for k in a:
                assert np.array_equal(a[k], b[k]), (r, rnd, k)
        for k, v in first["params"].items():
            assert np.array_equal(other["params"][k], v), (r, k)


@pytest.mark.parametrize("layout,arch", [(lay, a) for lay in LAYOUTS
                                         for a in ROUNDTRIP_ARCHS])
def test_distribute_then_gather_is_the_state(runs, layout, arch):
    world = runs["world4"] if layout == "2x2" else runs["world8"]
    offset = len(WORLD4) - len(ROUNDTRIP_ARCHS) if layout == "2x2" else 1
    i = offset + ROUNDTRIP_ARCHS.index(arch)
    for rank in world:
        got = rank[i]["roundtrip"]
        assert got["bitwise"] and got["shapes"], got
        assert got["split"] > 0, got          # some leaves are split


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_reference(runs, name):
    """The reference's sharded jit on the same layout: identical edges,
    losses 1e-5, parameters 1e-4; every rank the same bits."""
    results = per_rank(runs, name)
    assert len(results) == np.prod(CASES[name]["sizes"])
    assert_ranks_agree(results)
    ref = runs["reference"]
    got = results[0]
    for rnd, rec in enumerate(got["record"]):
        assert np.array_equal(rec["edges"], ref[f"{name}/round{rnd}/edges"]
                              ), rnd
        np.testing.assert_allclose(rec["per_node_loss"],
                                   ref[f"{name}/round{rnd}/per_node_loss"],
                                   err_msg=f"round {rnd}", **LOSS_TOL)
    want = {k[len(f"{name}/params/"):]: v for k, v in ref.items()
            if k.startswith(f"{name}/params/")}
    assert sorted(got["params"]) == sorted(want)
    for path, v in want.items():
        np.testing.assert_allclose(got["params"][path], v, atol=PARAM_ATOL,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("name", list(CASES) + list(ONE_DEVICE_CASES))
def test_mesh_step_matches_one_device_step(runs, name):
    results = per_rank(runs, name)
    if name in ONE_DEVICE_CASES:
        assert_ranks_agree(results)
    got, single = results[0], results[0]["single"]
    for rnd, (a, b) in enumerate(zip(got["record"], single["record"])):
        assert np.array_equal(a["edges"], b["edges"]), rnd
        np.testing.assert_allclose(a["per_node_loss"], b["per_node_loss"],
                                   err_msg=f"round {rnd}", **LOSS_TOL)
    for path, v in single["params"].items():
        np.testing.assert_allclose(got["params"][path], v,
                                   atol=ONE_DEVICE_ATOL, rtol=0,
                                   err_msg=path)
    rounds = dict(CASES, **ONE_DEVICE_CASES)[name]["rounds"]
    for rank in results:
        assert (rank["count"] == rounds).all()


def test_ranks_agree_without_replayed_draws(runs):
    """Each rank's Morph draws from its own generator, seeded alike: the
    four ranks negotiate the same edges."""
    i = WORLD4.index(FREE)
    results = [rank[i] for rank in runs["world4"]]
    assert_ranks_agree(results)
    edges = [rec["edges"] for rec in results[0]["record"]]
    assert all(e.sum(1).max() <= mc.HP["k"] for e in edges)


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_layout_is_the_one_device_step(runs, name):
    got = runs["single"][name]
    single = got["single"]
    for a, b in zip(got["record"], single["record"]):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    for path, v in single["params"].items():
        assert np.array_equal(got["params"][path], v), path


def test_cosine_from_grams_is_model_pairwise_cosine():
    """The split of Eq. 3 gives the leaf-by-leaf loop's bits on the CPU."""
    gen = torch.Generator().manual_seed(3)
    n = 6
    stacked = {f"l{i}": torch.randn((n, 3 + 41 * i), generator=gen)
               * (i + 1) for i in range(37)}
    stacked["zero"] = torch.zeros((n, 5))
    want = torch.zeros((n, n))
    for v in stacked.values():
        want += ops.pairwise_cosine(v)
    want /= len(stacked)
    grams = ops.leaf_grams(stacked)
    assert grams.shape == (len(stacked), n, n)
    assert torch.equal(ops.cosine_from_grams(grams), want)
    assert torch.equal(ops.model_pairwise_cosine(stacked), want)


def test_launcher_mesh_branch_on_four_ranks(runs):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dlrt import init_train_state
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    results = [rank[-1]["launcher"] for rank in runs["world4"]]
    assert all(code == 0 for code, _ in results)
    lines = results[0][1].splitlines()
    rounds = [ln for ln in lines if ln.startswith("round")]
    assert len(rounds) == 3 and lines[-1].startswith("done: 3 rounds")
    assert all(np.isfinite(float(ln.split("loss")[1].split()[0]))
               for ln in rounds)
    assert all(out == "" for _, out in results[1:])
    ckpt = runs["ckpt"]
    assert sorted(p.name for p in ckpt.iterdir()) == \
        ["ckpt_00000003.msgpack.zst"]
    step, tree = CheckpointManager(str(ckpt)).restore(device="cpu")
    fresh = flatten(init_train_state(mc.config("llama3.2-3b"), sgd(0.05),
                                     4, device="cpu").params)
    got = flatten(tree["params"])
    assert step == 3 and list(got) == list(fresh)
    for k, v in fresh.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
        assert torch.isfinite(got[k]).all(), k
