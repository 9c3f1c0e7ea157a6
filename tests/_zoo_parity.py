"""Whole-model parity checks of the port's model zoo (``repro_torch.
models``, ``repro_torch.dlrt.distributed``) against the reference's, on the
CPU at reduced configs in f32, shared by ``tests/test_torch_train.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_rwkv.py`` and
``tests/test_torch_frontends.py``.

The port takes the reference's parameters and train state by copy
(``params_from_jax``, ``train_state_from_jax``) and the reference's Morph
draws (``tests/_jax_draws.py`` ``morph_key_draws``); both packages see the
same numpy-made tokens, and with ``frontend=True`` the same numpy-made
stub-frontend inputs (:func:`frontend_inputs`).  Tolerances, all f32:

* ``forward`` logits, ``loss_fn``'s metrics (the MoE aux term included)
  and ``decode_step`` logits and caches: atol 1e-4 / rtol 1e-3,
  ``tests/test_arch_smoke.py``'s tolerance for the layers composed;
* greedy tokens: identical;
* the port's own prefill against its decode: atol 2e-4 / rtol 1e-3
  (``tests/test_arch_smoke.py``'s; MoE at ``capacity_factor`` 100 as
  there, so that no pair is dropped in either);
* gradients against ``jax.grad``: 1e-4 of each leaf's largest gradient,
  plus 1e-4 relative; a leaf whose gradient is zero in exact arithmetic
  (an attention's key bias: softmax is invariant to adding ``q . b_k`` to
  every logit of a row) holds round-off on both sides, and each side is
  held within 1e-6 of the model's largest gradient instead;
* train rounds against the reference's jitted step: identical edges,
  parameters within 1e-4, losses within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import init_state
from repro.dlrt import distributed as jdist
from repro.launch import shapes as jshapes
from repro.models import model as jmodel
from repro.optim import sgd as jsgd
from repro_torch.dlrt import distributed as tdist
from repro_torch.models import model as tmodel
from repro_torch.optim import sgd
from repro_torch.tree import (flatten, params_from_jax, params_to_numpy,
                              train_state_from_jax, unflatten)
from _jax_draws import morph_key_draws

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)
PREFILL_DECODE_TOL = dict(atol=2e-4, rtol=1e-3)
GRAD_TOL = 1e-4
LR = 0.05
HP = dict(k=2, view_size=3)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's backend
    optimizations, which take most of a small model's compile time here
    and do not change what is computed."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)


def port_params(tcfg, seed, n=None):
    """Parameters for both packages as the reference's tree of arrays:
    drawn by the port (``n`` of them node-stacked), which is quicker on
    the CPU than the reference's initialisers op by op or compiled."""
    draw = lambda i: flatten(tmodel.init_params(tcfg, seed + i,
                                                device="cpu"))
    if n is None:
        flat = draw(0)
    else:
        nodes = [draw(i) for i in range(n)]
        flat = {k: torch.stack([t[k] for t in nodes]) for k in nodes[0]}
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(flat))


def to_port(jparams):
    """The reference's parameter tree as the port's nested tree."""
    return unflatten(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams)))


def reference_state(params, n):
    """The reference's ``init_train_state`` for ``n`` nodes with these
    node-stacked parameters: ``sgd``'s per-node counts, and Morph
    bootstrapped on the bidirectional ring with the key
    ``init_train_state(PRNGKey(0), ...)`` gives it."""
    ring = jnp.zeros((1, 1), bool) if n == 1 else \
        jnp.roll(jnp.eye(n, dtype=bool), 1, 1) \
        | jnp.roll(jnp.eye(n, dtype=bool), -1, 1)
    _, key = jax.random.split(jax.random.PRNGKey(0))
    return jdist.TrainState(params, {"count": jnp.zeros((n,), jnp.int32)},
                            init_state(key, ring))


def lm_batch(rng, n, b, s, vocab):
    """Node-stacked ``[n, b, s]`` tokens and next-token labels, some
    masked with -100."""
    toks = rng.integers(0, vocab, (n, b, s + 1)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :2] = -100
    return {"tokens": toks[..., :-1], "labels": labels}


def frontend_inputs(cfg, rng, lead):
    """The stub frontend's input for a batch of leading shape ``lead``, at
    the shape ``repro.launch.shapes.input_specs`` gives it: Whisper's
    ``frames [*lead, T, d]`` or a VLM's ``patch_embeds [*lead, P, 1024]``,
    standard normal f32 (none for a text-only model)."""
    specs = jshapes.input_specs(cfg, jshapes.SHAPES["train_4k"], 1)
    return {k: rng.normal(size=tuple(lead) + v.shape[2:]).astype(np.float32)
            for k, v in specs.items() if k in ("frames", "patch_embeds")}


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(got, want, tol=MODEL_TOL, msg=""):
    np.testing.assert_allclose(as_np(got), np.asarray(want), err_msg=msg,
                               **tol)


def no_drops(cfg):
    """``cfg`` with a capacity that drops no (token, slot) pair, as
    ``tests/test_arch_smoke.py`` runs MoE's prefill against decode."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


# ---------------------------------------------------------------------------
# The checks.
# ---------------------------------------------------------------------------

def check_forward_loss_decode(jcfg, tcfg, seed, s=16, frontend=False):
    """``forward`` (logits and aux), ``loss_fn``'s metrics, ``decode_step``
    over the ``s`` tokens (logits at every step, then the cache) and
    ``greedy_generate`` against the reference; ``frontend`` adds the stub
    frontend's input to the forward and the loss."""
    jparams = port_params(tcfg, seed)
    params = to_port(jparams)
    rng = np.random.default_rng(seed)
    batch = {k: v[0] for k, v in lm_batch(rng, 1, 2, s,
                                          jcfg.vocab_size).items()}
    if frontend:
        batch.update(frontend_inputs(jcfg, rng, (2,)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    want, jaux = compiled(lambda q, b: jmodel.forward(q, b, jcfg), jparams,
                          jbatch)(jparams, jbatch)
    got, aux = tmodel.forward(params, {k: torch.as_tensor(v)
                                       for k, v in batch.items()
                                       if k != "labels"}, tcfg)
    assert got.dtype == aux.dtype == torch.float32
    close(got, want)
    close(aux, jaux, LOSS_TOL)
    _, jm = compiled(lambda q, b: jmodel.loss_fn(q, b, jcfg), jparams,
                     jbatch)(jparams, jbatch)
    _, m = tmodel.loss_fn(params, {k: torch.as_tensor(v)
                                   for k, v in batch.items()}, tcfg)
    assert sorted(m) == sorted(jm) == ["accuracy", "aux", "ce", "loss"]
    for k in m:
        close(m[k], jm[k], msg=k)
    tokens = batch["tokens"]
    jc = jmodel.init_cache(jcfg, 2, s)
    tc = tmodel.init_cache(tcfg, 2, s, device="cpu")
    jstep = compiled(lambda q, c, tok, pos: jmodel.decode_step(
        q, c, tok, pos, jcfg), jparams, jc, jnp.asarray(tokens[:, :1]),
        jnp.int32(0))
    for t in range(s):
        w, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t:t + 1]),
                      jnp.int32(t))
        g, tc = tmodel.decode_step(params, tc,
                                   torch.as_tensor(tokens[:, t:t + 1]), t,
                                   tcfg)
        close(g, w, msg=f"decode step {t}")
    jleaves = flatten(jax.tree_util.tree_map(np.asarray, jc))
    assert list(jleaves) == list(flatten(tc))
    for path, leaf in flatten(tc).items():
        close(leaf, jleaves[path], msg=path)
    prompt = tokens[:, :6]
    np.testing.assert_array_equal(
        tmodel.greedy_generate(params, tcfg, torch.as_tensor(prompt),
                               8).numpy(),
        np.asarray(jmodel.greedy_generate(jparams, jcfg,
                                          jnp.asarray(prompt), 8)))


def check_prefill_decode(tcfg, seed, s=16):
    """The port's teacher-forced forward against its own token-by-token
    decode (``tests/test_arch_smoke.py``'s check), no pair dropped."""
    cfg = no_drops(tcfg)
    params = tmodel.init_params(cfg, seed, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, s)))
    fwd, _ = tmodel.forward(params, {"tokens": tokens}, cfg)
    cache = tmodel.init_cache(cfg, 2, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tmodel.decode_step(params, cache, tokens[:, t:t + 1], t,
                                       cfg)
        outs.append(lg[:, 0])
    close(torch.stack(outs, 1), fwd.numpy(), PREFILL_DECODE_TOL)


ZERO_GRAD_ATOL = 1e-6


def check_gradients(jcfg, tcfg, seed, frontend=False, zero_grads=()):
    """Autograd through the port's ``loss_fn`` against the reference's
    ``jax.grad``, leaf for leaf (the MoE aux term included; ``frontend``
    adds the stub frontend's input).  Leaves whose paths end with one of
    ``zero_grads`` have a zero gradient in exact arithmetic: both sides
    within ``ZERO_GRAD_ATOL`` of the model's largest gradient."""
    jparams = port_params(tcfg, seed)
    rng = np.random.default_rng(seed)
    batch = {k: v[0] for k, v in lm_batch(rng, 1, 2, 16,
                                          jcfg.vocab_size).items()}
    if frontend:
        batch.update(frontend_inputs(jcfg, rng, (2,)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    (jloss, _), grads = compiled(jax.value_and_grad(
        lambda q: jmodel.loss_fn(q, jbatch, jcfg), has_aux=True),
        jparams)(jparams)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = [v.requires_grad_() for v in params.values()]
    loss, _ = tmodel.loss_fn(unflatten(params),
                             {k: torch.as_tensor(v)
                              for k, v in batch.items()}, tcfg)
    close(loss, jloss, LOSS_TOL)
    got = torch.autograd.grad(loss, leaves)
    want = flatten(jax.tree_util.tree_map(np.asarray, grads))
    assert list(want) == list(params)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for (path, w), t in zip(want.items(), got):
        if path.endswith(zero_grads):
            for side in (t.numpy(), w):
                assert float(np.abs(side).max()) <= ZERO_GRAD_ATOL * largest, \
                    path
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(t.numpy(), w, atol=GRAD_TOL * scale,
                                   rtol=GRAD_TOL, err_msg=path)


def check_train_rounds(jcfg, tcfg, n=4, rounds=3, delta_r=2, seed=0,
                       frontend=False):
    """``rounds`` rounds of the port's train step (a topology round every
    ``delta_r``, the first included) against the reference's jitted step
    with its Morph draws replayed: identical edges, losses within 1e-5,
    parameters within 1e-4.  ``frontend`` adds the stub frontend's input
    to every node's batch."""
    jstate = reference_state(port_params(tcfg, seed, n=n), n)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    state = train_state_from_jax(
        host.params, host.opt_state,
        {f: getattr(host.morph, f) for f in
         ("known", "sim", "sim_valid", "edges")})
    rng = np.random.default_rng(seed + 7)
    batches = [lm_batch(rng, n, 2, 16, jcfg.vocab_size)
               for _ in range(rounds)]
    if frontend:
        for batch in batches:
            batch.update(frontend_inputs(jcfg, rng, (n, 2)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batches[0])
    jsteps = {topo: compiled(jdist.make_train_step(
        jcfg, jsgd(LR), jdist.MorphHParams(**HP), do_topology=topo),
        jstate, jbatch) for topo in (True, False)}
    steps = {topo: tdist.make_train_step(
        tcfg, sgd(LR), tdist.MorphHParams(**HP), do_topology=topo)
        for topo in (True, False)}
    draws = iter(morph_key_draws(jstate.morph.key, n, rounds))
    for rnd, batch in enumerate(batches):
        topo = rnd % delta_r == 0
        jstate, jm = jsteps[topo](
            jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = steps[topo](state, batch,
                               noise=next(draws) if topo else None)
        assert np.array_equal(state.morph.edges.numpy(),
                              np.asarray(jstate.morph.edges)), rnd
        for k in ("loss", "per_node_loss"):
            close(m[k], jm[k], LOSS_TOL, msg=f"round {rnd} {k}")
        want = flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
        got = flatten(state.params)
        assert list(got) == list(want)
        for path in want:
            np.testing.assert_allclose(as_np(got[path]), want[path],
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"round {rnd} {path}")
