"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``), on the CPU.

Both packages get the same numpy-made parameters and gradients (a small
tree of f32 leaves, some cast to bf16 where a test says so) and take three
updates.
Tolerances: the updates, moments and parameters within 1e-6 relative to
the largest value of each leaf (atol 1e-6 x max|want|, rtol 1e-6): both
take the same f32 operations in the same order, and differ only where
XLA's and PyTorch's ``cos``, ``pow``, ``sqrt`` or a sum over a leaf round
a last bit apart; a bf16 leaf after ``apply_updates`` within one bf16
ulp (2^-7 of its value).  Counts are equal.
"""
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp                                      # noqa: E402

import repro.optim as jopt                                   # noqa: E402
import repro_torch.optim as topt                             # noqa: E402

REL = 1e-6
BF16_ULP = 2.0 ** -7


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return OrderedDict([
        ("a", (rng.normal(size=(5, 7)) * scale).astype(np.float32)),
        ("b", (rng.normal(size=(7,)) * scale).astype(np.float32)),
        ("c", (rng.normal(size=(3, 4)) * scale).astype(np.float32)),
    ])


def _jax(tree, bf16=()):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _torch(tree, bf16=()):
    return OrderedDict((k, torch.as_tensor(v).to(
        torch.bfloat16 if k in bf16 else torch.float32))
        for k, v in tree.items())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=REL,
                               err_msg=what)


SCHEDULES = {
    "constant": (lambda m: m.constant(0.3)),
    "cosine_decay": (lambda m: m.cosine_decay(0.5, 7, floor=0.05)),
    "linear_warmup_cosine": (lambda m: m.linear_warmup_cosine(
        0.5, 3, 11, floor=0.01)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    jfn, tfn = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for count in range(0, 14):
        want = jfn(jnp.asarray(count, jnp.int32))
        got = tfn(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, want, f"{name} at {count}")


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd-nesterov": lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
    "sgd-weight-decay-schedule": lambda m: m.sgd(
        m.cosine_decay(0.2, 5), momentum=0.5, weight_decay=0.01),
    "adamw": lambda m: m.adamw(0.01),
    "adamw-weight-decay-schedule": lambda m: m.adamw(
        m.linear_warmup_cosine(0.02, 2, 6), weight_decay=0.1),
    "clip-sgd": lambda m: m.chain_clip(m.sgd(0.1, momentum=0.9), 0.5),
    "clip-adamw": lambda m: m.chain_clip(m.adamw(0.01), 1.0),
}


def _state_leaves(state):
    """``(name, array)`` of every entry of an optimizer state, moments leaf
    by leaf."""
    for key in sorted(state):
        value = state[key]
        if isinstance(value, dict):
            for leaf in sorted(value):
                yield f"{key}.{leaf}", value[leaf]
        else:
            yield key, value


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_reference(name):
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    params = _tree(0)
    jp, tp = _jax(params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _tree(10 + step, scale=2.0)
        jupd, js = jo.update(_jax(grads), js, jp)
        tupd, ts = to.update(_torch(grads), ts, tp)
        for k in params:
            _close(tupd[k], jupd[k], f"{name} step {step} update {k}")
        jl, tl = dict(_state_leaves(js)), dict(_state_leaves(ts))
        assert sorted(jl) == sorted(tl)
        assert int(tl["count"]) == int(jl["count"]) == step + 1
        for key in jl:
            _close(tl[key], jl[key], f"{name} step {step} state {key}")
        jp = jopt.apply_updates(jp, jupd)
        tp = topt.apply_updates(tp, tupd)
        for k in params:
            _close(tp[k], jp[k], f"{name} step {step} params {k}")


def test_global_norm_matches_reference():
    tree = _tree(3, scale=3.0)
    _close(topt.global_norm(_torch(tree, bf16=("c",))),
           jopt.global_norm(_jax(tree, bf16=("c",))), "global_norm")


def test_apply_updates_bf16_within_one_ulp():
    """A bf16 leaf: ``p + u`` in f32, rounded back to bf16, as the
    reference rounds it (one bf16 ulp at most where the two f32 sums sit
    on either side of a rounding edge)."""
    params, upd = _tree(4), _tree(5, scale=0.01)
    jp = jopt.apply_updates(_jax(params, bf16=("a", "b")), _jax(upd))
    tp = topt.apply_updates(_torch(params, bf16=("a", "b")), _torch(upd))
    for k in params:
        assert tp[k].dtype == (torch.bfloat16 if k in "ab"
                               else torch.float32)
        want = _np(jp[k])
        np.testing.assert_allclose(_np(tp[k]), want, atol=0,
                                   rtol=BF16_ULP if k in "ab" else 0)


def test_clip_scales_bf16_gradients_like_the_reference():
    """``chain_clip`` scales in f32 and casts each gradient back to its
    dtype before the inner optimizer sees it."""
    grads = _tree(6, scale=5.0)
    jo, to = jopt.chain_clip(jopt.sgd(1.0), 0.5), \
        topt.chain_clip(topt.sgd(1.0), 0.5)
    params = _tree(7)
    jupd, _ = jo.update(_jax(grads, bf16=("b",)),
                        jo.init(_jax(params)), _jax(params))
    tupd, _ = to.update(_torch(grads, bf16=("b",)),
                        to.init(_torch(params)), _torch(params))
    for k in grads:
        np.testing.assert_allclose(
            _np(tupd[k]), _np(jupd[k]), atol=0,
            rtol=BF16_ULP if k == "b" else REL)


def test_sgd_on_node_stacked_leaves_keeps_the_momentum_free_path():
    """``sgd(lr)`` as the round engines call it: node-stacked leaves, a
    scalar count, ``-lr * g`` in f32."""
    opt = topt.sgd(0.05)
    params = _torch(_tree(8))
    grads = _torch(_tree(9))
    state = opt.init(params)
    assert set(state) == {"count"} and state["count"].shape == ()
    upd, state = opt.update(grads, state, params)
    assert int(state["count"]) == 1
    for k in params:
        torch.testing.assert_close(upd[k], -0.05 * grads[k], atol=0, rtol=0)
