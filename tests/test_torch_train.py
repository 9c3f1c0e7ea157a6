"""Decentralized LM training of the model zoo (``repro_torch.dlrt.
distributed``, ``models.model.loss_fn``, ``launch.train``, the token data)
against the reference's (``repro.dlrt.distributed``, ``repro.models``,
``repro.data``), on the CPU, at reduced configs in f32.

The port takes the reference's state by copy (``train_state_from_jax``)
and the reference's Morph draws (``tests/_jax_draws.py``
``morph_key_draws`` of the state's key), and both packages see the same
numpy-made batches.  Tolerances, all f32:

* token streams and batches: identical;
* ``loss_fn``'s metrics: 1e-5 (the same f32 operations on the same
  values, in other summation orders);
* the gradients of reduced Jamba without experts (autograd through the
  plain scan against ``jax.grad`` through the reference's associative
  scan): 1e-4 of each leaf's largest gradient, plus 1e-4 relative;
* the train step against the reference's jitted step: identical edges,
  parameters within 1e-4, losses within 1e-5;
* ``make_serve_step``: the reference's logits within
  ``tests/test_torch_zoo.py``'s model tolerance (atol 1e-4, rtol 1e-3).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.configs as jconfigs                             # noqa: E402
from repro.data import make_token_stream as jstream          # noqa: E402
from repro.data.pipeline import TokenBatcher as JBatcher     # noqa: E402
from repro.dlrt import distributed as jdist                  # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro.optim import sgd as jsgd                          # noqa: E402
import repro_torch.configs as tconfigs                       # noqa: E402
from repro_torch.data import TokenBatcher, make_token_stream  # noqa: E402
from repro_torch.dlrt import distributed as tdist            # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import model as tmodel               # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import (flatten, params_from_jax,      # noqa: E402
                              train_state_from_jax, unflatten)
from _jax_draws import morph_key_draws                       # noqa: E402
from _zoo_parity import (HP, LOSS_TOL, LR, MODEL_TOL,        # noqa: E402
                         PARAM_ATOL, lm_batch)
from _zoo_parity import as_np as _np                         # noqa: E402
from _zoo_parity import compiled as _compiled                # noqa: E402
from _zoo_parity import port_params as _params               # noqa: E402
from _zoo_parity import reference_state as _reference_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAMBA = "jamba-1.5-large-398b"
DENSE = ("llama3.2-3b", "phi4-mini-3.8b", "qwen1.5-110b", "nemotron-4-340b")
# With their experts and RWKV mixers (tests/test_torch_moe.py and
# tests/test_torch_rwkv.py take them further).
ZOO = ("deepseek-moe-16b", "rwkv6-7b")


def without_experts(cfg):
    """Jamba with every MoE layer a dense SwiGLU MLP at ``d_ff``."""
    return dataclasses.replace(
        cfg, moe=None,
        pattern=tuple(dataclasses.replace(s, moe=False) for s in cfg.pattern))


def config_pair(arch):
    """The reduced config of ``arch`` in both packages (Jamba without
    experts, with 2 KV heads for its 4 query heads)."""
    if arch == JAMBA:
        return tuple(dataclasses.replace(
            without_experts(c.get_config(JAMBA)).reduced(), num_kv_heads=2)
            for c in (jconfigs, tconfigs))
    return jconfigs.get_config(arch).reduced(), \
        tconfigs.get_config(arch).reduced()


# ---------------------------------------------------------------------------
# Token data.
# ---------------------------------------------------------------------------

def test_token_stream_and_batches_are_the_references():
    toks = make_token_stream(3000, 97, seed=3, concentration=0.15)
    want = jstream(3000, 97, seed=3, concentration=0.15)
    assert toks.dtype == want.dtype and np.array_equal(toks, want)
    ours, theirs = TokenBatcher(toks, 4, 16, seed=5), \
        JBatcher(want, 4, 16, seed=5)
    for _ in range(3):
        got, ref = ours.next(), theirs.next()
        assert sorted(got) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == ref[k].dtype == np.int32
            assert np.array_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# loss_fn and its gradients.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jamba_grads():
    """Reduced Jamba without experts: the reference's loss, metrics and
    gradients on one batch (one jitted ``value_and_grad``), its
    parameters, and the batch."""
    jcfg, tcfg = config_pair(JAMBA)
    jparams = _params(tcfg, 1)
    batch = {k: v[0] for k, v in lm_batch(np.random.default_rng(1), 1, 2,
                                          16, jcfg.vocab_size).items()}
    (loss, metrics), grads = _compiled(jax.value_and_grad(
        lambda q: jmodel.loss_fn(q, jax.tree_util.tree_map(
            jnp.asarray, batch), jcfg), has_aux=True), jparams)(jparams)
    return dict(tcfg=tcfg, np_params=jax.tree_util.tree_map(np.asarray,
                                                            jparams),
                batch=batch, metrics=metrics, grads=grads)


def _metrics_close(got, want):
    assert sorted(got) == ["accuracy", "aux", "ce", "loss"]
    for k in got:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("arch", DENSE + ZOO)
def test_loss_fn_metrics_match_reference(arch):
    jcfg, tcfg = config_pair(arch)
    jparams = _params(tcfg, 2)
    batch = {k: v[0] for k, v in lm_batch(np.random.default_rng(2), 1, 2,
                                          16, jcfg.vocab_size).items()}
    _, want = jax.jit(lambda q, b: jmodel.loss_fn(q, b, jcfg))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    params = unflatten(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    _, got = tmodel.loss_fn(params, {k: torch.as_tensor(v)
                                     for k, v in batch.items()}, tcfg)
    _metrics_close(got, want)


def test_loss_fn_metrics_match_reference_jamba(jamba_grads):
    g = jamba_grads
    _, got = tmodel.loss_fn(unflatten(params_from_jax(g["np_params"])),
                            {k: torch.as_tensor(v)
                             for k, v in g["batch"].items()}, g["tcfg"])
    _metrics_close(got, g["metrics"])


def test_jamba_gradients_match_reference(jamba_grads):
    """Autograd through the plain scan (and the rest of the model) gives
    the reference's ``jax.grad``, leaf for leaf."""
    g = jamba_grads
    params = params_from_jax(g["np_params"])
    leaves = [v.requires_grad_() for v in params.values()]
    loss, _ = tmodel.loss_fn(unflatten(params),
                             {k: torch.as_tensor(v)
                              for k, v in g["batch"].items()}, g["tcfg"])
    got = torch.autograd.grad(loss, leaves)
    want = flatten(jax.tree_util.tree_map(np.asarray, g["grads"]))
    assert list(want) == list(params)
    for (path, w), t in zip(want.items(), got):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(t.numpy(), w, atol=1e-4 * scale,
                                   rtol=1e-4, err_msg=path)


# ---------------------------------------------------------------------------
# The train step against the reference's jitted step.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_steps():
    """Reduced Llama-3.2-3B in both packages, the reference's initial state
    of 4 nodes, and one jitted reference step per (microbatch, topology)
    shared by the cases."""
    jcfg, tcfg = config_pair("llama3.2-3b")
    jstate = _reference_state(_params(tcfg, 0, n=4), 4)
    cache = {}

    def step(microbatch, topology):
        key = (microbatch, topology)
        if key not in cache:
            cache[key] = jax.jit(jdist.make_train_step(
                jcfg, jsgd(LR), jdist.MorphHParams(**HP),
                microbatch=microbatch, do_topology=topology))
        return cache[key]
    return jcfg, tcfg, jstate, step


def _first_nodes(jstate, n):
    """The reference's state cut to its first ``n`` nodes."""
    if n == jstate.morph.edges.shape[0]:
        return jstate
    return _reference_state(jax.tree_util.tree_map(lambda x: x[:n],
                                                   jstate.params), n)


# (n, per-node batch, microbatch, rounds, topology rounds every, or None)
STEP_CASES = {"delta_r2": (4, 2, None, 3, 2),
              "no_topology": (4, 2, None, 2, None),
              "microbatch2": (4, 4, 2, 2, 1),
              "one_node": (1, 2, None, 2, 1)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(llama_steps, case):
    n, b, microbatch, rounds, delta_r = STEP_CASES[case]
    jcfg, tcfg, jstate, jstep = llama_steps
    jstate = _first_nodes(jstate, n)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    state = train_state_from_jax(
        host.params, host.opt_state,
        {f: getattr(host.morph, f) for f in
         ("known", "sim", "sim_valid", "edges")})
    steps = {topo: tdist.make_train_step(
        tcfg, sgd(LR), tdist.MorphHParams(**HP), microbatch=microbatch,
        do_topology=topo) for topo in (True, False)}
    draws = iter(morph_key_draws(jstate.morph.key, n, rounds))
    rng = np.random.default_rng(7)
    for rnd in range(rounds):
        batch = lm_batch(rng, n, b, 16, jcfg.vocab_size)
        topo = delta_r is not None and rnd % delta_r == 0
        jstate, jm = jstep(microbatch, topo)(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = steps[topo](state, batch,
                               noise=next(draws) if topo and n > 1 else None)
        assert np.array_equal(state.morph.edges.numpy(),
                              np.asarray(jstate.morph.edges)), rnd
        np.testing.assert_allclose(_np(m["loss"]), np.asarray(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(_np(m["per_node_loss"]),
                                   np.asarray(jm["per_node_loss"]),
                                   **LOSS_TOL)
        want = flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
        got = flatten(state.params)
        assert list(got) == list(want)
        for path in want:
            np.testing.assert_allclose(_np(got[path]), want[path],
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"round {rnd} {path}")
        assert np.array_equal(state.opt_state["count"].numpy(),
                              np.asarray(jstate.opt_state["count"]))


def test_mix_groups_bound_the_extra_memory():
    """The mix's groups: leaf order, one dtype each, closed before they
    would pass the bound, a larger leaf alone; the in-place mix gives the
    grouped mix's values."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    stacked = {"a": torch.randn((3, 10), generator=gen),
               "b": torch.randn((3, 30), generator=gen),
               "c": torch.randn((3, 4), generator=gen).bfloat16(),
               "d": torch.randn((3, 5), generator=gen),
               "e": torch.randn((3, 6), generator=gen)}
    assert ops.mix_groups(stacked, 200) == [["a"], ["b"], ["c"], ["d", "e"]]
    edges = torch.tensor([[0, 1, 0], [1, 0, 1], [0, 0, 0]], dtype=torch.bool)
    want = ops.mix_masked_pytree(edges, stacked)
    got = {k: v.clone() for k, v in stacked.items()}
    assert ops.mix_masked_in_place(edges, got, 200) == 4
    for k in stacked:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def test_serve_step_matches_reference():
    jcfg, tcfg = config_pair("llama3.2-3b")
    n, b, max_len = 3, 2, 6
    jparams = _params(tcfg, 4, n=n)
    jcache = jax.jit(jax.vmap(lambda _: jmodel.init_cache(
        jcfg, b, max_len)))(jnp.arange(n))
    jserve = jax.jit(jdist.make_serve_step(jcfg))
    params = unflatten(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jparams)))
    cache = tdist.init_node_caches(tcfg, n, b, max_len, device="cpu")
    serve = tdist.make_serve_step(tcfg)
    rng = np.random.default_rng(5)
    for pos in range(4):
        toks = rng.integers(0, jcfg.vocab_size, (n, b, 1)).astype(np.int32)
        jlogits, jcache = jserve(jparams, jcache, jnp.asarray(toks), pos)
        logits, cache = serve(params, cache, torch.as_tensor(toks).long(),
                              pos)
        assert logits.shape == (n, b, 1, jcfg.vocab_size)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   **MODEL_TOL)


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

def test_launcher_at_smoke_size_without_jax():
    """``python -m repro_torch.launch.train --reduced --device cpu`` in a
    fresh interpreter, which must not have loaded JAX or the reference."""
    code = ("import sys\n"
            "from repro_torch.launch import train\n"
            "train.main(['--arch', 'llama3.2-3b', '--reduced', '--nodes', "
            "'4', '--rounds', '4', '--batch', '2', '--seq', '16', "
            "'--stream-len', '2000', '--delta-r', '2', '--log-every', '1', "
            "'--device', 'cpu'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    rounds = [ln for ln in lines if ln.startswith("round")]
    assert len(rounds) == 4 and lines[-1].startswith("done: 4 rounds")
    for ln in rounds:
        loss = float(ln.split("loss")[1].split()[0])
        assert np.isfinite(loss)
        assert "in-deg [2..2]" in ln or "in-deg [3..3]" in ln


@pytest.mark.parametrize("argv,ranks", [(["--mesh", "single"], 256),
                                        (["--mesh", "multi"], 512)])
def test_launcher_refuses_what_is_not_ported(argv, ranks):
    """``--mesh`` without a process group of the production mesh's ranks
    raises the ``ValueError`` naming them (as ``jax.make_mesh`` fails with
    fewer devices), before it builds anything; the mesh branch itself runs
    in ``tests/test_torch_mesh_train.py``."""
    with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
        tlaunch.main(["--reduced", "--device", "cpu"] + argv)


def test_launcher_writes_a_checkpoint_that_loads(tmp_path):
    """``--checkpoint-dir`` saves ``{"params": ...}`` under step
    ``--rounds`` at the end (none at round 0), as the reference's launcher
    does; the file holds a population of the launcher's structure, shapes
    and dtypes."""
    from repro_torch.checkpoint import CheckpointManager
    d = tmp_path / "ckpt"
    assert tlaunch.main(["--reduced", "--nodes", "4", "--rounds", "3",
                         "--batch", "2", "--seq", "16", "--stream-len",
                         "2000", "--device", "cpu", "--checkpoint-dir",
                         str(d)]) == 0
    assert sorted(p.name for p in d.iterdir()) == \
        ["ckpt_00000003.msgpack.zst"]
    step, tree = CheckpointManager(str(d)).restore(device="cpu")
    assert step == 3 and list(tree) == ["params"]
    cfg = tconfigs.get_config("llama3.2-3b").reduced()
    fresh = flatten(tdist.init_train_state(cfg, sgd(0.05), 4,
                                           device="cpu").params)
    got = flatten(tree["params"])
    assert list(got) == list(fresh)
    for k, v in fresh.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
        assert torch.isfinite(got[k]).all(), k


@pytest.mark.parametrize("arch", ZOO + (JAMBA,))
def test_launcher_trains_moe_and_rwkv(arch, capsys):
    """The launcher trains reduced DeepSeek-MoE, RWKV-6 and Jamba with its
    experts (none of them refused)."""
    assert tlaunch.main(["--arch", arch, "--reduced", "--nodes", "3",
                         "--rounds", "2", "--batch", "2", "--seq", "16",
                         "--stream-len", "2000", "--log-every", "1",
                         "--device", "cpu"]) == 0
    rounds = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("round")]
    assert len(rounds) == 2
    assert all(np.isfinite(float(ln.split("loss")[1].split()[0]))
               for ln in rounds)


# ---------------------------------------------------------------------------
# Behaviour of the port alone (tests/test_system.py's two LM tests).
# ---------------------------------------------------------------------------

def test_lm_morph_superstep_learns():
    """A tiny LM population trained with the Morph train step reduces its
    loss on a learnable Markov stream."""
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-3b").reduced(),
                              vocab_size=64)
    n, b, s = 4, 8, 64
    opt = sgd(0.25)
    state = tdist.init_train_state(cfg, opt, n, device="cpu")
    step = tdist.make_train_step(cfg, opt, tdist.MorphHParams(k=2,
                                                              view_size=3))
    batchers = [TokenBatcher(make_token_stream(
        60_000, cfg.vocab_size, seed=i, concentration=0.03), b, s, seed=i)
        for i in range(n)]
    losses = []
    for _ in range(45):
        node_batches = [bt.next() for bt in batchers]
        batch = {k: np.stack([nb[k] for nb in node_batches])
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert min(losses[-5:]) < losses[0] - 0.4
    assert np.isfinite(losses).all()


def test_consensus_under_mixing():
    """Repeated Morph rounds with no learning shrink the parameters'
    spread across nodes (the paper's Fig. 3c, in parameter space)."""
    cfg = tconfigs.get_config("llama3.2-3b").reduced()
    opt = sgd(0.0)
    n = 6
    state = tdist.init_train_state(cfg, opt, n, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    for leaf in flatten(state.params).values():
        leaf += 0.1 * torch.as_tensor(rng.normal(size=leaf.shape)
                                      ).to(leaf.dtype)
    toks = np.zeros((n, 2, 16), np.int32)
    step = tdist.make_train_step(cfg, opt, tdist.MorphHParams(k=2,
                                                              view_size=3))

    def spread(s):
        return sum(float((leaf.amax(0) - leaf.amin(0)).float().sum())
                   for leaf in flatten(s.params).values())
    s0 = spread(state)
    for _ in range(5):
        state, _ = step(state, {"tokens": toks, "labels": toks})
    assert spread(state) < 0.5 * s0
