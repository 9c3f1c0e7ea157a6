"""The port's model zoo (``repro_torch.models``) against the reference's
(``repro.models``), on the CPU, on Jamba-1.5-Large ``.reduced()`` without
experts (one period of 7 Mamba layers and one attention layer, d_model 256,
f32) with 2 KV heads for its 4 query heads, so that grouped-query attention
repeats heads as the published 64 / 8 do; also on two periods of it, and
on reduced Llama-3.2-3B for RoPE and tied embeddings.  DeepSeek-MoE-16B's,
RWKV-6's, Whisper-tiny's, Pixtral-12B's and Llama-4-Scout's configurations
and parameter counts are pinned here too (their modules:
``tests/test_torch_moe.py``, ``tests/test_torch_rwkv.py``,
``tests/test_torch_frontends.py``).

The port takes the reference's parameters by copy
(``params_from_jax``), and both packages see the same numpy-made inputs.
Tolerances, all f32:

* modules (norm, MLP, attention, the flash path, decode attention, Mamba
  and its decode step): atol 1e-5 with rtol 1e-5, the same f32 operations
  on the same values, taken in other summation orders (matmul blocking;
  the associative scan against the port's sequential one);
* the whole model (``forward`` full and ``last_only``, ``decode_step``):
  atol 1e-4 / rtol 1e-3, ``tests/test_arch_smoke.py``'s tolerance for the
  same eight layers composed;
* greedy tokens: identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.configs as jconfigs                             # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import layers as jlayers                   # noqa: E402
from repro.models import mamba as jmamba                     # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
import repro_torch.configs as tconfigs                       # noqa: E402
from repro_torch.kernels import selective_scan               # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import layers as tlayers             # noqa: E402
from repro_torch.models import mamba as tmamba               # noqa: E402
from repro_torch.models import model as tmodel               # noqa: E402
from repro_torch.tree import (flatten, params_from_jax,      # noqa: E402
                              params_to_numpy, unflatten)

ARCH = "jamba-1.5-large-398b"
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)


def without_experts(cfg):
    """Jamba with every MoE layer a dense SwiGLU MLP at ``d_ff``."""
    return dataclasses.replace(
        cfg, moe=None,
        pattern=tuple(dataclasses.replace(s, moe=False) for s in cfg.pattern))


def jamba_pair(**changes):
    """Reduced Jamba without experts, with 2 KV heads, in both packages."""
    return tuple(dataclasses.replace(
        without_experts(c.get_config(ARCH)).reduced(), num_kv_heads=2,
        **changes) for c in (jconfigs, tconfigs))


def port_config(jcfg):
    """The port's ``ArchConfig`` with a reference config's fields (for the
    architectures the port does not register)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["pattern"] = tuple(tconfigs.BlockSpec(s.mixer, s.moe)
                              for s in jcfg.pattern)
    fields["prefix"] = tuple(tconfigs.BlockSpec(s.mixer, s.moe)
                             for s in jcfg.prefix)
    return tconfigs.ArchConfig(**fields)


def both_params(jcfg, seed):
    """The reference's parameters for ``jcfg`` and the same in the port."""
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, np_params, unflatten(params_from_jax(np_params))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def zoo():
    """The reduced configs of both packages, the reference's parameters
    and the same parameters in the port."""
    jcfg, tcfg = jamba_pair()
    jparams, np_params, tparams = both_params(jcfg, 0)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, np_params=np_params,
                tparams=tparams, tokens=tokens.astype(np.int32))


def _block(zoo, mixer):
    """Period 0 of the first pattern position with ``mixer``, in both."""
    i = next(k for k, s in enumerate(zoo["jcfg"].pattern)
             if s.mixer == mixer)
    jblk = jax.tree_util.tree_map(lambda v: v[0], zoo["jparams"]["body"][i])
    return jblk, unflatten(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jblk)))


def _acts(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs and parameter trees.
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("deepseek-moe-16b", "rwkv6-7b", "whisper-tiny", "pixtral-12b",
             "llama4-scout-17b-a16e")


@pytest.mark.parametrize("variant", ["published", "without-experts",
                                     "reduced"] + [
    a + suffix for a in ZOO_ARCHS for suffix in ("", "-reduced")])
def test_config_matches_reference(variant):
    arch = variant.removesuffix("-reduced") if variant.startswith(
        ZOO_ARCHS) else ARCH
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if variant in ("without-experts", "reduced"):
        j, t = without_experts(j), without_experts(t)
    if variant.endswith("reduced"):
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_periods == j.num_periods
    assert t.param_count() == j.param_count()
    assert arch in tconfigs.list_configs()


# The parameters a model has beyond ArchConfig.param_count(), which is
# analytic: DeepSeek-MoE's final norm; RWKV-6's final LayerNorm (2 d), and
# in each block the 325 d it leaves out (the ddlerp mus and LoRA, the decay
# LoRA, u, the group norm and the two LayerNorms' biases) with its channel
# mix taken at 3.5 d wide where the model has d_ff.  Whisper: each
# LayerNorm's bias (d a norm: two norms a block, encoder and decoder), the
# cross-attention's norm taken at d where it is a LayerNorm of 2 d, the
# frame projector (d x d and its bias), the encoder's and the decoder's
# final LayerNorms.  The two VLMs: the final norm and the patch projector
# (1024 x d and its bias).
BEYOND_ANALYTIC = {
    "deepseek-moe-16b": lambda c: c.d_model,
    "rwkv6-7b": lambda c: 2 * c.d_model + c.num_layers * (
        325 * c.d_model + 2 * c.d_model * (c.d_ff - int(3.5 * c.d_model))),
    "whisper-tiny": lambda c: (3 * c.num_layers + 2 * c.encoder.num_layers
                               + c.d_model + 5) * c.d_model,
    "pixtral-12b": lambda c: (1024 + 2) * c.d_model,
    "llama4-scout-17b-a16e": lambda c: (1024 + 2) * c.d_model}
# ArchConfig.param_count() of the published configurations.
PUBLISHED_COUNT = {"deepseek-moe-16b": 16_879_566_848,
                   "rwkv6-7b": 7_534_411_776,
                   "whisper-tiny": 37_200_768,
                   "pixtral-12b": 12_247_777_280,
                   "llama4-scout-17b-a16e": 107_769_856_000}


@pytest.mark.parametrize("arch", sorted(PUBLISHED_COUNT))
@pytest.mark.parametrize("variant", ["published", "reduced"])
def test_moe_and_rwkv_param_count_pinned(arch, variant):
    """The reference's parameter tree holds ``param_count()`` plus what it
    leaves out (the published one counted from its abstract shapes); at
    the reduced config the port draws a tree of the same leaves, shapes,
    dtypes and count."""
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if variant == "published":
        assert t.param_count() == PUBLISHED_COUNT[arch]
    else:
        j, t = j.reduced(), t.reduced()
    shapes = flatten(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), j)))
    count = sum(int(np.prod(v.shape)) for v in shapes.values())
    assert count == t.param_count() + BEYOND_ANALYTIC[arch](t)
    if variant == "reduced":
        mine = flatten(tmodel.init_params(t, 0, device="cpu"))
        assert list(mine) == list(shapes)
        for k, v in shapes.items():
            assert tuple(mine[k].shape) == v.shape, k
            assert str(mine[k].dtype).removeprefix("torch.") == \
                str(v.dtype), k
        assert tmodel.param_count(mine) == count


def test_params_tree_order_and_roundtrip(zoo):
    port = params_from_jax(zoo["np_params"])
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(
                 zoo["np_params"])[0]]
    assert list(port) == paths
    assert "body.0.mixer.in_proj.w" in port and "body.4.mixer.q.w" in port
    back = params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(zoo["np_params"])
    for a, b in zip(jax.tree_util.tree_leaves(zoo["np_params"]),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert list(flatten(zoo["tparams"])) == paths


def test_param_shapes_dtypes_and_count_match_reference(zoo):
    cfg = zoo["tcfg"]
    mine = flatten(tmodel.init_params(cfg, 0, device="cpu"))
    ref = flatten(zoo["np_params"])
    assert list(mine) == list(ref)
    for k in ref:
        assert tuple(mine[k].shape) == ref[k].shape, k
        assert str(mine[k].dtype).removeprefix("torch.") == \
            str(ref[k].dtype), k
    count = tmodel.param_count(zoo["tparams"])
    assert count == jmodel.param_count(zoo["jparams"])
    assert tmodel.param_bytes(zoo["tparams"]) == \
        jmodel.param_bytes(zoo["jparams"])
    # ArchConfig.param_count() is analytic and leaves out each Mamba
    # layer's conv_b and dt_proj.b ([d_inner] each) and the final norm.
    di = cfg.ssm.expand * cfg.d_model
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.num_periods
    assert count == cfg.param_count() + n_mamba * 2 * di + cfg.d_model


# ---------------------------------------------------------------------------
# Layers and attention.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(size=(48,)).astype(np.float32),
         "bias": rng.normal(size=(48,)).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    x = _acts((2, 5, 48), 2, 3.0)
    got = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(got, jlayers.apply_norm(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "sqrelu"])
def test_apply_mlp(mlp_type):
    p = jax.tree_util.tree_map(np.asarray, jlayers.mlp_params(
        jax.random.PRNGKey(3), 64, 96, mlp_type, jnp.float32))
    x = _acts((2, 7, 64), 4)
    got = tlayers.apply_mlp(unflatten(params_from_jax(p)), _t(x), mlp_type)
    _close(got, jlayers.apply_mlp(p, jnp.asarray(x), mlp_type))


@pytest.mark.parametrize("s,window", [(16, None), (16, 5), (256, None),
                                      (256, 100), (2048, None)])
def test_self_attention(zoo, s, window):
    """s = 16 and 256 take the masked softmax (``_sdpa``), s = 2048 the
    chunked branch (chunks of 1024), as in the reference."""
    jblk, tblk = _block(zoo, "attn")
    x = _acts((2, s, zoo["jcfg"].d_model), 5)
    pos = np.broadcast_to(np.arange(s), (2, s))
    got = tattn.self_attention(tblk["mixer"], _t(x), zoo["tcfg"],
                               positions=_t(pos), window=window)
    want = jattn.self_attention(jblk["mixer"], jnp.asarray(x), zoo["jcfg"],
                                positions=jnp.asarray(pos), window=window)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 100])
def test_flash_attention_small_chunks(window):
    """The chunked path at s = 256 in chunks of 64, with the same q, k, v
    and positions in both packages."""
    b, s, h, hd = 2, 256, 4, 32
    q, k, v = (_acts((b, s, h, hd), seed) for seed in (6, 7, 8))
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    got = tattn._flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                 window, hd, q_chunk=64, kv_chunk=64)
    want = jattn._flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                  window, hd, q_chunk=64, kv_chunk=64)
    _close(got, want)
    full = tattn._sdpa(_t(q), _t(k), _t(v), tattn.causal_mask(
        _t(pos), _t(pos), window)[:, None], hd)
    _close(got, full.numpy())


@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_decode_self_attention(zoo, mode):
    """Twelve one-token steps: a linear cache of 12, or a ring of 5 slots
    with a window of 5 (wrapping twice)."""
    jblk, tblk = _block(zoo, "attn")
    cfg_j, cfg_t = zoo["jcfg"], zoo["tcfg"]
    window, max_len = (None, 12) if mode == "linear" else (5, 5)
    jc = jattn.init_cache(cfg_j, 2, max_len, jnp.float32)
    tc = tattn.init_cache(cfg_t, 2, max_len, torch.float32, "cpu")
    xs = _acts((12, 2, 1, cfg_j.d_model), 9)
    for t in range(12):
        want, jc = jattn.decode_self_attention(jblk["mixer"],
                                               jnp.asarray(xs[t]), cfg_j,
                                               jc, jnp.int32(t),
                                               window=window)
        ptrs = {k: v.data_ptr() for k, v in tc.items()}
        got, new = tattn.decode_self_attention(tblk["mixer"], _t(xs[t]),
                                               cfg_t, tc, t, window=window)
        assert new is tc                        # written in place, no copy
        assert {k: v.data_ptr() for k, v in tc.items()} == ptrs
        _close(got, want)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def test_decode_self_attention_in_blocks(zoo, monkeypatch):
    """Decode reads a cache of 12 slots in blocks of 5 (the last one
    ragged) and still gives the reference's output."""
    monkeypatch.setattr(tattn, "DECODE_BLOCK", 5)
    jblk, tblk = _block(zoo, "attn")
    cfg_j, cfg_t = zoo["jcfg"], zoo["tcfg"]
    jc = jattn.init_cache(cfg_j, 2, 12, jnp.float32)
    tc = tattn.init_cache(cfg_t, 2, 12, torch.float32, "cpu")
    xs = _acts((12, 2, 1, cfg_j.d_model), 12)
    for t in range(12):
        want, jc = jattn.decode_self_attention(jblk["mixer"],
                                               jnp.asarray(xs[t]), cfg_j,
                                               jc, jnp.int32(t))
        got, tc = tattn.decode_self_attention(tblk["mixer"], _t(xs[t]),
                                              cfg_t, tc, t)
        _close(got, want)


# ---------------------------------------------------------------------------
# Mamba.
# ---------------------------------------------------------------------------

def test_apply_mamba_matches_associative_scan(zoo):
    """The port's one scan over the sequence against the reference's
    chunked associative scan (chunk 16, so 48 tokens are three chunks)."""
    jblk, tblk = _block(zoo, "mamba")
    x = _acts((2, 48, zoo["jcfg"].d_model), 10)
    before = selective_scan.launches
    got = tmamba.apply_mamba(tblk["mixer"], _t(x), zoo["tcfg"])
    assert selective_scan.launches == before     # CPU: the plain version
    _close(got, jmamba.apply_mamba(jblk["mixer"], jnp.asarray(x),
                                   zoo["jcfg"]))
    with pytest.raises(ValueError, match="chunk"):
        tmamba.apply_mamba(tblk["mixer"], _t(x[:, :40]), zoo["tcfg"])


def test_decode_mamba(zoo):
    jblk, tblk = _block(zoo, "mamba")
    cfg_j, cfg_t = zoo["jcfg"], zoo["tcfg"]
    js = jmamba.init_mamba_state(cfg_j, 2, jnp.float32)
    ts = tmamba.init_mamba_state(cfg_t, 2, torch.float32, "cpu")
    xs = _acts((6, 2, 1, cfg_j.d_model), 11)
    for t in range(6):
        want, js = jmamba.decode_mamba(jblk["mixer"], jnp.asarray(xs[t]),
                                       cfg_j, js)
        got, ts = tmamba.decode_mamba(tblk["mixer"], _t(xs[t]), cfg_t, ts)
        _close(got, want)
        _close(ts["h"], js["h"])
        _close(ts["conv"], js["conv"])


def test_softplus_is_logaddexp():
    x = torch.tensor([-50.0, -1.0, 0.0, 3.0, 19.0, 21.0, 60.0])
    np.testing.assert_array_equal(
        tmamba._softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))))


# ---------------------------------------------------------------------------
# The whole model.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_reference(zoo, last_only):
    tokens = zoo["tokens"]
    want, jaux = jmodel.forward(zoo["jparams"],
                                {"tokens": jnp.asarray(tokens)}, zoo["jcfg"],
                                last_only=last_only)
    got, aux = tmodel.forward(zoo["tparams"], {"tokens": _t(tokens)},
                              zoo["tcfg"], last_only=last_only)
    assert got.dtype == torch.float32
    assert got.shape == (2, 1 if last_only else 32, zoo["jcfg"].vocab_size)
    _close(got, want, MODEL_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_decode_step_matches_reference(zoo):
    tokens = zoo["tokens"]
    jc = jmodel.init_cache(zoo["jcfg"], 2, 8)
    tc = tmodel.init_cache(zoo["tcfg"], 2, 8, device="cpu")
    for t in range(8):
        want, jc = jmodel.decode_step(zoo["jparams"], jc,
                                      jnp.asarray(tokens[:, t:t + 1]),
                                      jnp.int32(t), zoo["jcfg"])
        got, tc = tmodel.decode_step(zoo["tparams"], tc,
                                     _t(tokens[:, t:t + 1]), t, zoo["tcfg"])
        _close(got, want, MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    flatten(tc).values()):
        _close(b, a, MODEL_TOL)


def test_decode_step_updates_cache_in_place(zoo):
    """A step writes each block's new state into the cache it was given
    (the period-stacked leaves included) and returns that cache."""
    tokens = _t(zoo["tokens"][:, :1])
    cache = tmodel.init_cache(zoo["tcfg"], 2, 8, device="cpu")
    leaves = flatten(cache)
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    _, out = tmodel.decode_step(zoo["tparams"], cache, tokens, 0,
                                zoo["tcfg"])
    assert out is cache
    assert {k: v.data_ptr() for k, v in flatten(out).items()} == ptrs
    assert all(bool(leaf.abs().sum() > 0) for leaf in leaves.values())


def test_greedy_generate_tokens_identical(zoo):
    prompt = zoo["tokens"][:, :6]
    want = jmodel.greedy_generate(zoo["jparams"], zoo["jcfg"],
                                  jnp.asarray(prompt), 8)
    got = tmodel.greedy_generate(zoo["tparams"], zoo["tcfg"], _t(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_equivalence(zoo):
    """The port's teacher-forced forward equals its token-by-token decode
    (``tests/test_arch_smoke.py``'s check, port only)."""
    cfg = zoo["tcfg"]
    tokens = _t(zoo["tokens"][:, :16])
    fwd, _ = tmodel.forward(zoo["tparams"], {"tokens": tokens}, cfg)
    cache = tmodel.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = tmodel.decode_step(zoo["tparams"], cache,
                                       tokens[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               atol=2e-4, rtol=1e-3)


def _forward_and_decode(jcfg, tcfg, seed, steps):
    """Forward logits and ``steps`` decode steps, reference and port."""
    jparams, _, tparams = both_params(jcfg, seed)
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    got, _ = tmodel.forward(tparams, {"tokens": _t(tokens)}, tcfg)
    _close(got, want, MODEL_TOL)
    jc = jmodel.init_cache(jcfg, 2, steps)
    tc = tmodel.init_cache(tcfg, 2, steps, device="cpu")
    for t in range(steps):
        want, jc = jmodel.decode_step(jparams, jc,
                                      jnp.asarray(tokens[:, t:t + 1]),
                                      jnp.int32(t), jcfg)
        got, tc = tmodel.decode_step(tparams, tc, _t(tokens[:, t:t + 1]), t,
                                     tcfg)
        _close(got, want, MODEL_TOL)


def test_two_periods_match_reference():
    """Two stacked periods: the port indexes and restacks the period axis
    of the parameters and the cache."""
    jcfg, tcfg = jamba_pair(num_layers=16)
    assert tcfg.num_periods == 2
    _forward_and_decode(jcfg, tcfg, seed=2, steps=4)


def test_rope_and_tied_embeddings_match_reference():
    """Reduced Llama-3.2-3B: RoPE attention, tied embeddings, no Mamba."""
    jcfg = jconfigs.get_config("llama3.2-3b").reduced()
    assert jcfg.tie_embeddings and jcfg.rope_theta is not None
    _forward_and_decode(jcfg, port_config(jcfg), seed=3, steps=4)
