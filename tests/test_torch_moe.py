"""The port's MoE MLP (``repro_torch.models.moe``) and the MoE models of
its zoo against the reference's (``repro.models.moe``, ``repro.models``),
on the CPU: reduced DeepSeek-MoE-16B (one attention layer with 4 routed
experts top-2 and a shared expert) and reduced Jamba-1.5-Large with its
experts (7 Mamba layers and one attention layer, 4 of them MoE at 4
experts top-2), f32.

The port takes the reference's parameters by copy (``params_from_jax``)
and both packages see the same numpy-made inputs.  Tolerances: ``apply_moe``
(y and the aux term) within 1e-5, the same f32 operations in other
summation orders, with the keep mask (which pairs fit their expert's
capacity) identical; the whole models as ``tests/_zoo_parity.py`` states.
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
from repro.models import moe as jmoe                         # noqa: E402
import repro_torch.configs as tconfigs                       # noqa: E402
from repro_torch.models import moe as tmoe                   # noqa: E402
from repro_torch.tree import params_from_jax, unflatten      # noqa: E402
import _zoo_parity as zoo                                    # noqa: E402

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
DEEPSEEK, JAMBA = "deepseek-moe-16b", "jamba-1.5-large-398b"
ARCHS = (DEEPSEEK, JAMBA)


def config_pair(arch, **moe):
    """The reduced config of ``arch`` (with its experts) in both packages,
    its ``MoEConfig`` changed by ``moe``."""
    return tuple(dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, **moe))
        for c in (jconfigs.get_config(arch).reduced(),
                  tconfigs.get_config(arch).reduced()))


@pytest.fixture(scope="module", params=ARCHS)
def moe_block(request):
    """One MoE layer of the reference's reduced model, in both packages."""
    jcfg, _ = config_pair(request.param)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    i = next(k for k, s in enumerate(jcfg.pattern) if s.moe)
    jp = jax.tree_util.tree_map(lambda v: np.asarray(v[0]),
                                jparams["body"][i]["mlp"])
    return request.param, jp, unflatten(params_from_jax(jp))


def _acts(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def reference_keep(jp, x, jcfg):
    """The reference's keep mask ``[T, K]``, by its own steps
    (``repro/models/moe.py``: softmax, ``lax.top_k``, cumulative rank)."""
    m = jcfg.moe
    T = x.shape[0] * x.shape[1]
    logits = (jnp.asarray(x).reshape(T, -1)
              @ jnp.asarray(jp["router"]["w"])).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), m.top_k)
    flat = idx.reshape(-1)
    rank = jnp.take_along_axis(
        jnp.cumsum(jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32), 0)
        - 1, flat[:, None], axis=1)[:, 0]
    return np.asarray(idx), np.asarray(rank < tmoe.capacity(jcfg, T)
                                       ).reshape(T, m.top_k)


def port_keep(tp, x, tcfg):
    """The port's experts and keep mask ``[T, K]``."""
    xf = x.reshape(-1, x.shape[-1])
    _, _, experts = tmoe._route(tp, xf, tcfg)
    _, _, keep = tmoe._dispatch(xf, experts,
                                tmoe.capacity(tcfg, xf.shape[0]),
                                tcfg.moe.num_experts)
    return experts.numpy(), keep.numpy()


def _apply_both(jp, tp, x, jcfg, tcfg):
    want, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.apply_moe(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODULE_TOL)
    assert aux.dtype == torch.float32 and got.dtype == torch.float32


# ---------------------------------------------------------------------------
# apply_moe.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1.25, 0.5, 100.0])
def test_apply_moe_matches_reference(moe_block, factor):
    """y and aux within 1e-5 and the same keep mask, at the published
    capacity factor, at 0.5 (pairs dropped) and at 100 (none dropped)."""
    arch, jp, tp = moe_block
    jcfg, tcfg = config_pair(arch, capacity_factor=factor)
    x = _acts((2, 24, jcfg.d_model), 1)
    _apply_both(jp, tp, x, jcfg, tcfg)
    want_idx, want_keep = reference_keep(jp, x, jcfg)
    got_idx, got_keep = port_keep(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_keep, want_keep)
    dropped = int((~got_keep).sum())
    if factor == 0.5:
        assert dropped > 0
    if factor == 100.0:
        assert dropped == 0


def test_zero_router_picks_the_lowest_experts(moe_block):
    """A zero router makes every expert's probability equal: the top-k
    goes to experts 0 .. K-1, as ``lax.top_k`` breaks ties."""
    arch, jp, tp = moe_block
    jcfg, tcfg = config_pair(arch)
    jp = dict(jp, router={"w": np.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = _acts((2, 8, jcfg.d_model), 2)
    _apply_both(jp, tp, x, jcfg, tcfg)
    experts, keep = port_keep(tp, torch.as_tensor(x), tcfg)
    K = tcfg.moe.top_k
    np.testing.assert_array_equal(experts, np.tile(np.arange(K), (16, 1)))
    np.testing.assert_array_equal(keep, reference_keep(jp, x, jcfg)[1])


def test_decode_shaped_call_has_capacity_one(moe_block):
    """A decode step calls the MoE on ``[b, 1, d]``, so T = b and the
    capacity is the call's own: at 4 requests and a factor of 0.5, C = 1
    and colliding pairs are dropped, as in the reference."""
    arch, jp, tp = moe_block
    jcfg, tcfg = config_pair(arch, capacity_factor=0.5)
    assert tmoe.capacity(tcfg, 4) == 1
    x = _acts((4, 1, jcfg.d_model), 3)
    _apply_both(jp, tp, x, jcfg, tcfg)
    _, keep = port_keep(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(keep, reference_keep(jp, x, jcfg)[1])
    assert keep.sum() <= tcfg.moe.num_experts and not keep.all()


def test_expert_banks_drawn_per_expert():
    """Each expert's ``[d_in, d_out]`` is drawn at fan-in ``d_in`` (not
    ``E``): the bank's spread is that of a ``[d_in, d_out]`` dense layer."""
    _, tcfg = config_pair(DEEPSEEK)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_params(gen, tcfg, torch.float32)
    d, ff = tcfg.d_model, tcfg.moe.d_ff_expert
    E = tcfg.moe.num_experts
    assert p["up"].shape == p["gate"].shape == (E, d, ff)
    assert p["down"].shape == (E, ff, d)
    # a standard normal truncated to [-2, 2] has std 0.8796
    for name, fan_in in (("up", d), ("down", ff)):
        std = float(p[name].std()) * np.sqrt(fan_in)
        assert abs(std - 0.8796) < 0.02, (name, std)
    assert p["shared"]["up"]["w"].shape == (d, tcfg.moe.num_shared * ff)


# ---------------------------------------------------------------------------
# Whole models.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_decode_match_reference(arch):
    zoo.check_forward_loss_decode(*config_pair(arch), seed=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equivalence(arch):
    zoo.check_prefill_decode(config_pair(arch)[1], seed=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    zoo.check_gradients(*config_pair(arch), seed=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_rounds_match_reference(arch):
    zoo.check_train_rounds(*config_pair(arch))
