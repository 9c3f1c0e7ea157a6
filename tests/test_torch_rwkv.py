"""The port's RWKV-6 mixer (``repro_torch.models.rwkv``) and the RWKV-6
model of its zoo against the reference's (``repro.models.rwkv``,
``repro.models``), on the CPU: reduced RWKV-6 7B (one block, d_model 256,
4 WKV heads of head_dim 64, chunks of 16 tokens), f32.

The port takes the reference's parameters by copy (``params_from_jax``)
and both packages see the same numpy-made inputs.  Tolerances: the modules
(the group norm, ddlerp, the r/k/v/g/w projections, one WKV chunk, the
time and channel mixes, and their decode steps) within 1e-5 absolute and
1e-5 relative, the same f32 operations in other summation orders; the
whole model as ``tests/_zoo_parity.py`` states.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.configs as jconfigs                             # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro.models import rwkv as jrwkv                       # noqa: E402
import repro_torch.configs as tconfigs                       # noqa: E402
from repro_torch.dlrt import distributed as tdist            # noqa: E402
from repro_torch.models import rwkv as trwkv                 # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import (flatten, params_from_jax,      # noqa: E402
                              unflatten)
import _zoo_parity as zoo                                    # noqa: E402

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "rwkv6-7b"


def config_pair(**changes):
    return tuple(dataclasses.replace(c.get_config(ARCH).reduced(), **changes)
                 for c in (jconfigs, tconfigs))


@pytest.fixture(scope="module")
def block():
    """The reference's reduced block (its time mix and channel mix), with
    the zero-initialised ddlerp mus and bias drawn so they matter, in both
    packages."""
    jcfg, tcfg = config_pair()
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                jparams["body"][0])
    rng = np.random.default_rng(0)
    mix, cm = jp["mixer"], jp["mlp"]
    for tree, key in ((mix, "mu_base"), (mix, "mu"), (cm, "mu_k"),
                      (cm, "mu_r")):
        tree[key] = rng.uniform(0, 1, tree[key].shape).astype(np.float32)
    mix["ln_x"]["bias"] = rng.normal(size=mix["ln_x"]["bias"].shape
                                     ).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=unflatten(params_from_jax(jp)))


def _acts(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=MODULE_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# The pieces.
# ---------------------------------------------------------------------------

def test_group_norm():
    """Population variance (ddof 0), eps 1e-5, computed in f32."""
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(size=(256,)).astype(np.float32),
         "bias": rng.normal(size=(256,)).astype(np.float32)}
    x = _acts((2, 5, 256), 2, 3.0)
    got = trwkv._group_norm({k: _t(v) for k, v in p.items()}, _t(x), 4)
    _close(got, jrwkv._group_norm(p, jnp.asarray(x), 4))


def test_ddlerp_and_projections(block):
    jp, tp = block["jp"]["mixer"], block["tp"]["mixer"]
    x = _acts((2, 8, block["jcfg"].d_model), 3)
    prev = _acts((2, 8, block["jcfg"].d_model), 4)
    _close(trwkv._ddlerp(tp, _t(x), _t(prev)),
           jrwkv._ddlerp(jp, jnp.asarray(x), jnp.asarray(prev)))
    got = trwkv._rkvgw(tp, _t(x), _t(prev), block["tcfg"])
    want = jrwkv._rkvgw(jp, jnp.asarray(x), jnp.asarray(prev),
                        block["jcfg"])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("chunks", [1, 3])
def test_chunk_wkv_with_a_carried_state(chunks):
    """``_chunk_wkv`` from a nonzero state, chained over ``chunks`` chunks
    of 16 tokens, with log-decays ``-exp(N(-2, 1))``: the model's own
    ``w0`` of -2, spread wider than its initial ``w2`` spreads it.  (The
    two packages' cumulative log-decays differ in their last bits, as
    torch's CPU ``cumsum`` does not add in sequence as ``jnp.cumsum`` does,
    and ``exp`` makes that a relative error of ``|cum|`` ulps.)"""
    b, L, h, hd = 2, 16, 4, 8
    r, k, v = (_acts((chunks, b, L, h, hd), seed) for seed in (5, 6, 7))
    log_w = -np.exp(_acts((chunks, b, L, h, hd), 8) - 2.0)
    u = _acts((h, hd), 9)
    s_j = jnp.asarray(_acts((b, h, hd, hd), 10))
    s_t = _t(np.asarray(s_j))
    for c in range(chunks):
        want, s_j = jrwkv._chunk_wkv(*(jnp.asarray(a[c])
                                       for a in (r, k, v, log_w)),
                                     jnp.asarray(u), s_j)
        got, s_t = trwkv._chunk_wkv(*(_t(a[c]) for a in (r, k, v, log_w)),
                                    _t(u), s_t)
        _close(got, want)
        _close(s_t, s_j)


@pytest.mark.parametrize("seq", [16, 48])
def test_time_and_channel_mix(block, seq):
    """One chunk and three: the mixes and their final states."""
    jp, tp = block["jp"], block["tp"]
    x = _acts((2, seq, block["jcfg"].d_model), 11)
    got, state = trwkv.apply_rwkv_time_mix(tp["mixer"], _t(x),
                                           block["tcfg"])
    want, jstate = jrwkv.apply_rwkv_time_mix(jp["mixer"], jnp.asarray(x),
                                             block["jcfg"])
    _close(got, want)
    _close(state["s"], jstate["s"])
    _close(state["last"], jstate["last"])
    got, last = trwkv.apply_channel_mix(tp["mlp"], _t(x))
    want, jlast = jrwkv.apply_channel_mix(jp["mlp"], jnp.asarray(x))
    _close(got, want)
    _close(last, jlast)


def test_sequence_not_a_multiple_of_the_chunk_is_refused(block):
    x = _t(_acts((2, 40, block["jcfg"].d_model), 12))
    with pytest.raises(ValueError, match="chunk"):
        trwkv.apply_rwkv_time_mix(block["tp"]["mixer"], x, block["tcfg"])


def test_decode_steps(block):
    """Six one-token steps of the time and channel mixes from the zero
    state, the state updated in place."""
    jp, tp = block["jp"], block["tp"]
    jcfg, tcfg = block["jcfg"], block["tcfg"]
    js = jrwkv.init_rwkv_state(jcfg, 2, jnp.float32)
    ts = trwkv.init_rwkv_state(tcfg, 2, torch.float32, "cpu")
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    xs = _acts((6, 2, 1, jcfg.d_model), 13)
    for t in range(6):
        want, jnew = jrwkv.decode_rwkv_time_mix(
            jp["mixer"], jnp.asarray(xs[t]), jcfg,
            {"s": js["s"], "last_tm": js["last_tm"]})
        js = dict(js, **jnew)
        got, out = trwkv.decode_rwkv_time_mix(tp["mixer"], _t(xs[t]), tcfg,
                                              ts)
        assert out is ts
        _close(got, want)
        want, js["last_cm"] = jrwkv.decode_channel_mix(
            jp["mlp"], jnp.asarray(xs[t]), js["last_cm"])
        got, last = trwkv.decode_channel_mix(tp["mlp"], _t(xs[t]),
                                             ts["last_cm"])
        ts["last_cm"].copy_(last)
        _close(got, want)
        for k in ts:
            _close(ts[k], js[k])
    assert {k: v.data_ptr() for k, v in ts.items()} == ptrs


def test_prefill_state_carries_on(block):
    """A prefill's final state and last token carried into the next
    chunk (``last_token``, ``state``) give the forward over both, as in the
    reference, and a decode step from that state gives its first
    output."""
    jp, tp = block["jp"]["mixer"], block["tp"]["mixer"]
    jcfg, tcfg = block["jcfg"], block["tcfg"]
    x = _acts((2, 32, tcfg.d_model), 14)
    full, _ = trwkv.apply_rwkv_time_mix(tp, _t(x), tcfg)
    _, st = trwkv.apply_rwkv_time_mix(tp, _t(x[:, :16]), tcfg)
    got, _ = trwkv.apply_rwkv_time_mix(tp, _t(x[:, 16:]), tcfg,
                                       last_token=st["last"], state=st)
    _, jst = jrwkv.apply_rwkv_time_mix(jp, jnp.asarray(x[:, :16]), jcfg)
    want, _ = jrwkv.apply_rwkv_time_mix(jp, jnp.asarray(x[:, 16:]), jcfg,
                                        last_token=jst["last"], state=jst)
    _close(got, want)
    _close(got, full[:, 16:])
    ts = {"s": st["s"].clone(), "last_tm": st["last"].clone()}
    step, _ = trwkv.decode_rwkv_time_mix(tp, _t(x[:, 16:17]), tcfg, ts)
    _close(step, got[:, :1])


# ---------------------------------------------------------------------------
# The whole model.
# ---------------------------------------------------------------------------

def test_forward_loss_decode_match_reference():
    zoo.check_forward_loss_decode(*config_pair(), seed=3)


def test_prefill_decode_equivalence():
    zoo.check_prefill_decode(config_pair()[1], seed=4)


def test_gradients_match_reference():
    zoo.check_gradients(*config_pair(), seed=5)


def test_train_rounds_match_reference():
    zoo.check_train_rounds(*config_pair())


def test_bf16_train_round_groups_the_f32_leaves():
    """In a bf16 model ``w0`` and ``u`` stay f32 leaves: a topology round
    takes Eq. 3 over both dtypes and mixes them, and they stay f32."""
    _, tcfg = config_pair(param_dtype="bfloat16", compute_dtype="bfloat16")
    n = 4
    state = tdist.init_train_state(tcfg, sgd(0.05), n, device="cpu")
    params = flatten(state.params)
    f32 = sorted(k for k, v in params.items() if v.dtype == torch.float32)
    assert f32 == ["body.0.mixer.u", "body.0.mixer.w0"]
    before = {k: params[k].clone() for k in f32}
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                             (n, 2, 17)).astype(np.int32)
    step = tdist.make_train_step(tcfg, sgd(0.05),
                                 tdist.MorphHParams(k=2, view_size=3))
    state, m = step(state, {"tokens": toks[..., :-1],
                            "labels": toks[..., 1:]})
    assert np.isfinite(float(m["loss"]))
    after = flatten(state.params)
    assert int(state.morph.sim_valid.sum()) > 0
    for k in f32:
        assert after[k].dtype == torch.float32
        assert not torch.equal(after[k], before[k]), k
