"""The port's encoder-decoder and stub-frontend models (``repro_torch.
models``: Whisper's encoder, cross-attention and learned positions, the
audio and vision projectors; ``repro_torch.launch.shapes``) against the
reference's (``repro.models``, ``repro.launch.shapes``), on the CPU at the
reduced configs in f32: Whisper-tiny (2 encoder layers over 16 frames, one
decoder layer, d_model 256), Pixtral-12B (one layer, 4 patch embeddings
1024 wide) and Llama-4-Scout (one MoE layer, 4 experts top-1 and a shared
expert, 4 patch embeddings).

The port takes the reference's parameters by copy (``params_from_jax``)
and both packages see the same numpy-made inputs.  Tolerances: the
modules (``sinusoidal_positions``, ``unembed``, ``cross_attention``,
``_encode`` and ``_embed_inputs`` in f32) within 1e-5 absolute and 1e-5
relative, the same f32 operations in other summation orders;
``_embed_inputs`` in bf16 within one bf16 ulp of the value (the f32
projection's sums, in other orders, may round to neighbouring bf16
values); the whole models as ``tests/_zoo_parity.py`` states.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.configs as jconfigs                             # noqa: E402
from repro.launch import shapes as jshapes                   # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import layers as jlayers                   # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro.models import transformer as jtransformer         # noqa: E402
import repro_torch.configs as tconfigs                       # noqa: E402
from repro_torch.launch import shapes as tshapes             # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import layers as tlayers             # noqa: E402
from repro_torch.models import model as tmodel               # noqa: E402
from repro_torch.models import transformer as ttransformer   # noqa: E402
from repro_torch.tree import (flatten, params_from_jax,      # noqa: E402
                              params_to_numpy, unflatten)
import _zoo_parity as zoo                                    # noqa: E402

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = 2.0 ** -7
WHISPER, PIXTRAL, SCOUT = ("whisper-tiny", "pixtral-12b",
                           "llama4-scout-17b-a16e")
ARCHS = (WHISPER, PIXTRAL, SCOUT)


def config_pair(arch, **changes):
    """The reduced config of ``arch`` in both packages."""
    return tuple(dataclasses.replace(c.get_config(arch).reduced(), **changes)
                 for c in (jconfigs, tconfigs))


def both(tcfg, seed=0):
    """Parameters drawn by the port, as the reference's tree and the
    port's."""
    jparams = zoo.port_params(tcfg, seed)
    return jparams, zoo.to_port(jparams)


def _acts(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(zoo.as_np(got), np.asarray(want, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# Configs, parameter trees and shapes.
# ---------------------------------------------------------------------------

def test_every_assigned_name_resolves():
    """The port registers the reference's ten assigned architectures."""
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    for name in tconfigs.ASSIGNED:
        assert tconfigs.get_config(name).name == name
    assert set(tconfigs.ASSIGNED) <= set(tconfigs.list_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_the_new_subtrees(arch):
    """The reference's tree (``encoder.blocks``, ``cross``, ``norm_cross``,
    ``pos_embed``, ``frontend_proj``) carries over leaf for leaf in
    ``jax.tree_util``'s order, which is the order Eq. 3 groups leaves in,
    and back; the port draws the same leaves, shapes and dtypes."""
    jcfg, tcfg = config_pair(arch)
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    np_tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    port = params_from_jax(np_tree)
    with_path = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path) for path, _ in with_path]
    assert list(port) == paths
    for (_, want), got in zip(with_path, port.values()):
        np.testing.assert_array_equal(got.numpy(), want)
    want_keys = {WHISPER: ("encoder.blocks.1.mixer.q.b", "encoder.pos",
                           "encoder.final_norm.bias", "body.0.cross.o.w",
                           "body.0.norm_cross.scale", "pos_embed",
                           "frontend_proj.b"),
                 PIXTRAL: ("frontend_proj.w", "frontend_proj.b"),
                 SCOUT: ("frontend_proj.w", "body.0.mlp.router.w",
                         "body.0.mlp.shared.up.w")}[arch]
    for key in want_keys:
        assert any(p == key or p.startswith(key + ".") for p in port), key
    back = params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(np_tree)
    mine = flatten(tmodel.init_params(tcfg, 0, device="cpu"))
    assert list(mine) == paths
    for (_, want), got in zip(with_path, mine.values()):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_shapes_match_reference(arch, shape):
    """``shape_config`` (single and multi pod), ``skip_reason``,
    ``_dec_len``, ``input_specs`` and ``cache_len`` give the reference's
    answers; ``input_specs``' pairs are its ShapeDtypeStructs' shapes and
    dtypes."""
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.TRAIN_MICROBATCH == jshapes.TRAIN_MICROBATCH
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jspec, tspec = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    assert tshapes.skip_reason(tcfg, tspec) == \
        jshapes.skip_reason(jcfg, jspec)
    for multi in (False, True):
        jc, jn, jw, jmeta = jshapes.shape_config(jcfg, jspec,
                                                 multi_pod=multi)
        tc, tn, tw, tmeta = tshapes.shape_config(tcfg, tspec,
                                                 multi_pod=multi)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tn, tw, tmeta) == (jn, jw, jmeta)
        assert tshapes._dec_len(tc, tspec.seq_len) == \
            jshapes._dec_len(jc, jspec.seq_len)
        want = jshapes.input_specs(jc, jspec, jn)
        got = tshapes.input_specs(tc, tspec, tn)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(v.dtype), k
        assert tshapes.cache_len(tc, tspec, tw) == \
            jshapes.cache_len(jc, jspec, jw)


def test_input_specs_shape_the_frontend_inputs():
    """At the published configs: Whisper's ``frames`` ``[n, b, 1500, 384]``
    beside 448 decoder tokens, Pixtral's ``patch_embeds`` ``[n, b, 256,
    1024]`` beside the text's 3,840 tokens."""
    spec = tshapes.SHAPES["train_4k"]
    whisper = tshapes.input_specs(tconfigs.get_config(WHISPER), spec, 16)
    assert whisper["tokens"].shape == (16, 16, 448)
    assert whisper["frames"] == ((16, 16, 1500, 384), torch.float32)
    pixtral = tshapes.input_specs(tconfigs.get_config(PIXTRAL), spec, 16)
    assert pixtral["tokens"].shape == (16, 16, 4096 - 256)
    assert pixtral["patch_embeds"] == ((16, 16, 256, 1024), torch.float32)


@pytest.mark.parametrize("arch", ARCHS + ("llama3.2-3b",))
def test_frontend_inputs_follow_input_specs(arch):
    """``frontend_inputs`` draws each stub input behind the given leading
    shape at ``input_specs``' shape and dtype; a text-only model gets
    none."""
    cfg = tconfigs.get_config(arch).reduced()
    want = {k: v for k, v in tshapes.input_specs(
        cfg, tshapes.SHAPES["train_4k"], 1).items()
        if k not in ("tokens", "labels")}
    got = tshapes.frontend_inputs(cfg, (3, 2),
                                  torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: ((3, 2) + v.shape[2:], v.dtype) for k, v in want.items()}
    assert (not got) == (arch == "llama3.2-3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_width_follows_the_config_not_its_name(arch):
    """Under another name, the audio stub's projector stays ``d_model``
    wide and the vision stub's 1024 wide, and ``long_500k`` is skipped
    for the encoder-decoder alone."""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              name="renamed")
    proj = tmodel.init_params(cfg, 0, device="cpu")["frontend_proj"]["w"]
    assert proj.shape == ((cfg.d_model if arch == WHISPER else 1024),
                          cfg.d_model)
    skipped = tshapes.skip_reason(cfg, tshapes.SHAPES["long_500k"])
    assert (skipped is not None) == (arch == WHISPER)


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,d", [(16, 8), (64, 256), (448, 384)])
def test_sinusoidal_positions(length, d):
    _close(tlayers.sinusoidal_positions(length, d, "cpu"),
           jlayers.sinusoidal_positions(length, d))


@pytest.mark.parametrize("tied", [False, True])
def test_unembed(tied):
    x = _acts((2, 5, 32), 0)
    table = _acts((32, 40), 1)
    if tied:
        want = jlayers.unembed({}, jnp.asarray(x), jnp.asarray(table.T))
        got = tlayers.unembed({}, torch.as_tensor(x),
                              torch.as_tensor(table.T))
    else:
        want = jlayers.unembed({"w": jnp.asarray(table)}, jnp.asarray(x))
        got = tlayers.unembed({"w": torch.as_tensor(table)},
                              torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 40)
    _close(got, want)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_cross_attention(kv_heads):
    """Whisper's decoder block's cross-attention (with 2 KV heads also, so
    that grouped heads repeat), queries over 7 positions against 16."""
    jcfg, tcfg = config_pair(WHISPER, num_kv_heads=kv_heads)
    jparams, tparams = both(tcfg)
    jp = jax.tree_util.tree_map(lambda v: v[0], jparams["body"][0]["cross"])
    tp = ttransformer._index(tparams["body"][0]["cross"], 0)
    x, memory = _acts((2, 7, jcfg.d_model), 2), _acts((2, 16, jcfg.d_model),
                                                      3)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(memory),
                                 jcfg)
    got = tattn.cross_attention(tp, torch.as_tensor(x),
                                torch.as_tensor(memory), tcfg)
    _close(got, want)


def test_encode():
    """The encoder over 16 frames: projector, learned positions, two
    non-causal blocks, final norm."""
    jcfg, tcfg = config_pair(WHISPER)
    jparams, tparams = both(tcfg, seed=1)
    frames = _acts((2, jcfg.encoder.seq_len, jcfg.d_model), 4)
    want = jtransformer._encode(jparams, jnp.asarray(frames), jcfg)
    got = ttransformer._encode(tparams, torch.as_tensor(frames), tcfg)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_with_patches(dtype):
    """Pixtral's patch projection runs in ``patch_embeds``' dtype (f32 as
    fed) and is cast to the embedding's dtype afterwards: in bf16 the
    reference's order, within one bf16 ulp."""
    jcfg, tcfg = config_pair(PIXTRAL, param_dtype=dtype, compute_dtype=dtype)
    jparams, tparams = both(config_pair(PIXTRAL)[1], seed=2)
    jparams = jax.tree_util.tree_map(lambda v: v.astype(dtype), jparams)
    tparams = unflatten({k: v.to(getattr(torch, dtype))
                         for k, v in flatten(tparams).items()})
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    patches = rng.normal(size=(2, jcfg.frontend_tokens, 1024)).astype(
        np.float32)
    want, jpos = jtransformer._embed_inputs(
        jparams, {"tokens": jnp.asarray(tokens),
                  "patch_embeds": jnp.asarray(patches)}, jcfg)
    got, pos = ttransformer._embed_inputs(
        tparams, {"tokens": torch.as_tensor(tokens),
                  "patch_embeds": torch.as_tensor(patches)}, tcfg)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == dtype
    assert got.shape == (2, jcfg.frontend_tokens + 6, jcfg.d_model)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got, want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                                   atol=0)


def test_loss_fn_pads_labels_for_patches():
    """With P patch positions before the text, the logits are P longer
    than the labels: the loss is the reference's, and it is the cross
    entropy of the text positions alone."""
    jcfg, tcfg = config_pair(PIXTRAL)
    jparams, tparams = both(tcfg, seed=3)
    rng = np.random.default_rng(6)
    batch = {k: v[0] for k, v in zoo.lm_batch(rng, 1, 2, 8,
                                              jcfg.vocab_size).items()}
    batch.update(zoo.frontend_inputs(jcfg, rng, (2,)))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, jm = jmodel.loss_fn(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                           batch), jcfg)
    _, m = tmodel.loss_fn(tparams, tbatch, tcfg)
    for k in m:
        zoo.close(m[k], jm[k], zoo.LOSS_TOL, msg=k)
    logits, _ = tmodel.forward(tparams, tbatch, tcfg)
    P = jcfg.frontend_tokens
    assert logits.shape[1] == P + 8
    text = logits[:, P:].reshape(-1, logits.shape[-1])
    labels = tbatch["labels"].reshape(-1).long()
    ce = torch.nn.functional.cross_entropy(text, labels, ignore_index=-100)
    zoo.close(m["ce"], ce.detach().numpy(), zoo.LOSS_TOL)


def test_decode_clamps_learned_positions():
    """Whisper's 448 learned positions: a decode step at ``pos = 500``
    reads row 447, as the reference's ``dynamic_slice_in_dim`` clamps
    (plain indexing would raise)."""
    jcfg, tcfg = config_pair(WHISPER, max_position=448)
    jparams, tparams = both(tcfg, seed=4)
    assert tparams["pos_embed"].shape[0] == 448
    tokens = np.array([[3], [5]], np.int32)
    jc = jmodel.init_cache(jcfg, 2, 501)
    want, _ = jmodel.decode_step(jparams, jc, jnp.asarray(tokens),
                                 jnp.int32(500), jcfg)
    got, _ = tmodel.decode_step(tparams, tmodel.init_cache(
        tcfg, 2, 501, device="cpu"), torch.as_tensor(tokens), 500, tcfg)
    zoo.close(got, want)
    moved = dict(tparams, pos_embed=tparams["pos_embed"].clone())
    moved["pos_embed"][447] += 1.0
    other, _ = tmodel.decode_step(moved, tmodel.init_cache(
        tcfg, 2, 501, device="cpu"), torch.as_tensor(tokens), 500, tcfg)
    assert not torch.equal(other, got)


def test_whisper_decode_does_not_see_frames():
    """Decode's cross-attention reads zero ``cross_k``/``cross_v`` caches,
    as in the reference: the forward depends on ``frames``, decode's logits
    do not, and they are bit for bit those of the model with its
    cross-attention taken out."""
    jcfg, tcfg = config_pair(WHISPER)
    _, tparams = both(tcfg, seed=5)
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (2, 6)))
    fwd = [tmodel.forward(tparams, {"tokens": tokens, "frames":
                                    torch.as_tensor(zoo.frontend_inputs(
                                        tcfg, rng, (2,))["frames"])},
                          tcfg)[0] for _ in range(2)]
    assert not torch.allclose(fwd[0], fwd[1])
    cache = tmodel.init_cache(tcfg, 2, 6, device="cpu")
    assert float(cache["body"][0]["cross_k"].abs().max()) == 0.0
    plain = {k: v for k, v in tparams.items()}
    plain["body"] = tuple({k: v for k, v in blk.items()
                           if k not in ("cross", "norm_cross")}
                          for blk in tparams["body"])
    plain_cache = tmodel.init_cache(dataclasses.replace(tcfg, encoder=None),
                                    2, 6, device="cpu")
    for t in range(6):
        got, cache = tmodel.decode_step(tparams, cache, tokens[:, t:t + 1],
                                        t, tcfg)
        want, plain_cache = tmodel.decode_step(
            plain, plain_cache, tokens[:, t:t + 1], t, tcfg)
        assert torch.equal(got, want), t


# ---------------------------------------------------------------------------
# Whole models.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_decode_match_reference(arch):
    zoo.check_forward_loss_decode(*config_pair(arch), seed=3, frontend=True)


@pytest.mark.parametrize("arch", [PIXTRAL, SCOUT])
def test_text_only_prefill_decode_equivalence(arch):
    """A VLM fed text alone, as the launcher feeds it: the port's prefill
    against its own decode (Llama-4-Scout dropping no pair)."""
    zoo.check_prefill_decode(config_pair(arch)[1], seed=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    """Whisper's key biases (QKV bias, self- and cross-attention) have a
    zero gradient in exact arithmetic: held to the model's largest."""
    zero = (".mixer.k.b", ".cross.k.b") if arch == WHISPER else ()
    zoo.check_gradients(*config_pair(arch), seed=5, frontend=True,
                        zero_grads=zero)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_rounds_match_reference(arch):
    """Whisper's batches carry ``frames``, the VLMs' ``patch_embeds``."""
    zoo.check_train_rounds(*config_pair(arch), frontend=True)


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [PIXTRAL, SCOUT])
def test_launcher_trains_vlms_text_only(arch, capsys):
    assert tlaunch.main(["--arch", arch, "--reduced", "--nodes", "3",
                         "--rounds", "2", "--batch", "2", "--seq", "16",
                         "--stream-len", "2000", "--log-every", "1",
                         "--device", "cpu"]) == 0
    rounds = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("round")]
    assert len(rounds) == 2
    assert all(np.isfinite(float(ln.split("loss")[1].split()[0]))
               for ln in rounds)


def test_launcher_refuses_whisper():
    """Token streams give no ``frames``: the launcher says so (the
    reference's raises a ``KeyError`` inside its forward)."""
    with pytest.raises(ValueError, match="'frames'"):
        tlaunch.main(["--arch", WHISPER, "--reduced", "--device", "cpu"])
