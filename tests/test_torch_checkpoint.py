"""Checkpoints of the port (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU.

* The port's MessagePack codec gives ``msgpack.packb``'s bytes for the
  same object (hypothesis-drawn trees, every length form at its edges, and
  the reference's ``_encode`` payloads), and reads them back as
  ``msgpack.unpackb(strict_map_key=False)`` does.
* For the same tree the port's file is the reference's, byte for byte,
  under zstd (``zstandard`` imports here) and under zlib (both packages'
  ``zstandard`` set to None, as on a machine without it).
* Each package loads the other's files: a reduced zoo population in bf16
  and f32 comes back bit for bit.
* The reference's own checkpoint tests (``tests/test_substrates.py``),
  replayed against the port.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
from hypothesis import given, settings                       # noqa: E402
from hypothesis import strategies as st                      # noqa: E402

import repro.checkpoint.checkpoint as jckpt                  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,       # noqa: E402
                                    load_pytree, save_pytree)
from repro_torch.checkpoint import checkpoint as tckpt       # noqa: E402
from repro_torch.checkpoint import msgpack as codec          # noqa: E402
from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.models import model as tmodel               # noqa: E402
from repro_torch.tree import flatten, unflatten              # noqa: E402

# ---------------------------------------------------------------------------
# The codec.
# ---------------------------------------------------------------------------

_SCALARS = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_KEYS = st.text() | st.integers(min_value=-(1 << 63),
                                max_value=(1 << 64) - 1)
_TREES = st.recursive(
    _SCALARS,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(_KEYS, inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_TREES)
def test_codec_matches_msgpack_on_drawn_trees(obj):
    want = msgpack.packb(obj)
    assert codec.packb(obj) == want
    assert codec.unpackb(want) == msgpack.unpackb(want,
                                                  strict_map_key=False)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535,
                               65536, 70000])
def test_codec_length_forms_at_their_edges(n):
    """fixstr/str8/16/32, bin8/16/32, fixarray/array16/32, fixmap/map16/32
    each side of its limit."""
    for obj in ("é" * (n // 2) + "a" * (n % 2), "a" * n, b"\x00" * n,
                list(range(n)), {i: None for i in range(n)}):
        want = msgpack.packb(obj)
        assert codec.packb(obj) == want
        assert codec.unpackb(want) == msgpack.unpackb(
            want, strict_map_key=False)


@pytest.mark.parametrize("x", [0, 127, 128, 255, 256, 65535, 65536,
                               (1 << 32) - 1, 1 << 32, (1 << 64) - 1, -1,
                               -32, -33, -128, -129, -32768, -32769,
                               -(1 << 31), -(1 << 31) - 1, -(1 << 63)])
def test_codec_int_forms(x):
    assert codec.packb(x) == msgpack.packb(x)
    assert codec.unpackb(codec.packb(x)) == x


def test_codec_refuses_what_the_format_cannot_hold():
    for x in (1 << 64, -(1 << 63) - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(x)
        with pytest.raises(OverflowError):
            codec.packb(x)
    # A bin, str, array or map of 2^32 bytes or items (too large to make
    # here): the length check the packer runs on each.
    for what in ("bin", "str", "array", "map"):
        with pytest.raises(ValueError, match="at most"):
            codec._header(1 << 32, 0, 0, (0xC4, 0xC5, 0xC6), [], what)
    with pytest.raises(TypeError):
        codec.packb(object())
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(b"abc")[:-1])


def test_codec_reads_non_string_map_keys_and_float32():
    obj = {1: "a", -5: [None, True], 2.5: b"x", None: {}, False: 0}
    want = msgpack.packb(obj)
    assert codec.packb(obj) == want
    assert codec.unpackb(want) == obj
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert codec.unpackb(f32) == 1.5


# ---------------------------------------------------------------------------
# Files: the same bytes, and each package reads the other's.
# ---------------------------------------------------------------------------

def _bf16_bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def _pair():
    """One tree for each package: the reference's as jax and numpy values,
    the port's as torch tensors and numpy, the same values; dict keys out
    of order at every level."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    bf = jnp.asarray(w, jnp.bfloat16)
    ints = np.arange(7, dtype=np.int64)
    mask = rng.random((2, 3)) > 0.5
    jtree = {"zeta": {"w": jnp.asarray(w), "b16": bf, "i": ints},
             "alpha": (jnp.zeros(2), [jnp.float32(3.5), np.int32(4)]),
             "meta": {"step": 7, "name": "x", "flag": True, "none": None,
                      "lr": 0.05},
             "mask": jnp.asarray(mask)}
    tbf = torch.from_numpy(_bf16_bits(bf).view(np.int16).copy()).view(
        torch.bfloat16)
    ttree = {"zeta": {"w": torch.from_numpy(w), "b16": tbf,
                      "i": torch.from_numpy(ints)},
             "alpha": (torch.zeros(2), [np.float32(3.5), np.int32(4)]),
             "meta": {"step": 7, "name": "x", "flag": True, "none": None,
                      "lr": 0.05},
             "mask": torch.from_numpy(mask)}
    return jtree, ttree


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_reference_payloads_pack_alike():
    jtree, _ = _pair()
    payload = jckpt._encode(jax.device_get(jtree))
    assert codec.packb(payload) == msgpack.packb(payload)


@pytest.mark.parametrize("zstd", [True, False], ids=["zstd", "zlib"])
def test_port_file_is_the_reference_file(zstd, tmp_path, monkeypatch):
    jtree, ttree = _pair()
    if not zstd:
        monkeypatch.setattr(tckpt, "zstandard", None)
        monkeypatch.setattr(jckpt, "zstandard", None)
    jckpt.save_pytree(str(tmp_path / "ref.msgpack.zst"), jtree)
    save_pytree(str(tmp_path / "port.msgpack.zst"), ttree)
    ref, port = (_read(tmp_path / f) for f in ("ref.msgpack.zst",
                                                "port.msgpack.zst"))
    # zstd's magic bytes, or zlib's header byte (deflate, 32 KiB window).
    head = b"\x28\xb5\x2f\xfd" if zstd else b"\x78"
    assert port[:len(head)] == head
    assert tckpt.compressor() == ("zstd" if zstd else "zlib")
    assert port == ref


def test_zlib_file_loads_in_the_reference(tmp_path, monkeypatch):
    """The port without ``zstandard`` (the card's machine) writes zlib,
    which the reference (with ``zstandard``) reads by its magic bytes."""
    _, ttree = _pair()
    monkeypatch.setattr(tckpt, "zstandard", None)
    path = str(tmp_path / "c.msgpack.zst")
    save_pytree(path, ttree)
    assert _read(path)[:4] != b"\x28\xb5\x2f\xfd"
    back = jckpt.load_pytree(path)
    assert back["meta"] == ttree["meta"]
    np.testing.assert_array_equal(back["zeta"]["w"], ttree["zeta"]["w"])
    assert jnp.asarray(back["zeta"]["b16"]).dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        _bf16_bits(back["zeta"]["b16"]),
        ttree["zeta"]["b16"].view(torch.int16).numpy().view(np.uint16))
    assert isinstance(back["alpha"], tuple)
    assert isinstance(back["alpha"][1], list)
    # And the port reads its own zlib file.
    mine = load_pytree(path, device="cpu")
    assert torch.equal(mine["zeta"]["b16"], ttree["zeta"]["b16"])


def test_port_loads_the_reference_file(tmp_path):
    jtree, ttree = _pair()
    path = str(tmp_path / "ref.msgpack.zst")
    jckpt.save_pytree(path, jtree)
    back = load_pytree(path, device="cpu")
    assert back["meta"] == ttree["meta"]
    assert back["zeta"]["b16"].dtype == torch.bfloat16
    assert torch.equal(back["zeta"]["b16"], ttree["zeta"]["b16"])
    assert torch.equal(back["zeta"]["w"], ttree["zeta"]["w"])
    assert back["zeta"]["i"].dtype == torch.int64
    assert back["mask"].dtype == torch.bool
    assert isinstance(back["alpha"], tuple)
    assert back["alpha"][1][0].shape == () and \
        back["alpha"][1][0].dtype == torch.float32


def _population(arch, dtype, n=3):
    """A reduced population, node-stacked, for both packages: the
    reference's tree of jax arrays and the port's tree of tensors, the
    same bits (drawn by the port, which is quicker on the CPU)."""
    tcfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    nodes = [flatten(tmodel.init_params(tcfg, i, device="cpu"))
             for i in range(n)]
    port = {k: torch.stack([t[k] for t in nodes]) for k in nodes[0]}

    def as_jax(t):
        if t.dtype == torch.bfloat16:
            return jax.lax.bitcast_convert_type(
                jnp.asarray(t.view(torch.int16).numpy().view(np.uint16)),
                jnp.bfloat16)
        return jnp.asarray(t.numpy())
    ref = jax.tree_util.tree_map(as_jax, unflatten(port))
    return ref, unflatten(port)


def _same_bits(jtree, ttree):
    """Every leaf of the reference's tree has the port's leaf's dtype,
    shape and bits, in the same structure."""
    jflat = flatten(jtree)
    tflat = flatten(ttree)
    assert list(jflat) == list(tflat)
    for k, j in jflat.items():
        t = tflat[k]
        if t.dtype == torch.bfloat16:
            assert str(jnp.asarray(j).dtype) == "bfloat16", k
            np.testing.assert_array_equal(
                _bf16_bits(j), t.view(torch.int16).numpy().view(np.uint16),
                err_msg=k)
        else:
            assert np.asarray(j).dtype == t.numpy().dtype, k
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "whisper-tiny"])
def test_populations_cross_both_ways(arch, dtype, tmp_path):
    jparams, tparams = _population(arch, dtype)
    ref_path = str(tmp_path / "ref.msgpack.zst")
    port_path = str(tmp_path / "port.msgpack.zst")
    jckpt.save_pytree(ref_path, {"params": jparams})
    save_pytree(port_path, {"params": tparams})
    assert _read(ref_path) == _read(port_path)
    # The reference's file in the port, the port's in the reference.
    _same_bits(jparams, load_pytree(ref_path, device="cpu")["params"])
    _same_bits(jckpt.load_pytree(port_path)["params"], tparams)


# ---------------------------------------------------------------------------
# The reference's checkpoint tests, against the port.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip():
    tree = {"params": {"w": torch.ones((3, 4), dtype=torch.bfloat16),
                       "b": np.arange(5, dtype=np.int64)},
            "nested": (torch.zeros(2), [np.float32(3.5)]),
            "meta": {"step": 7, "name": "x", "flag": True}}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.msgpack.zst")
        save_pytree(path, tree)
        back = load_pytree(path, device="cpu")
    assert back["meta"] == {"step": 7, "name": "x", "flag": True}
    assert back["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["params"]["b"].numpy(),
                                  np.arange(5))
    assert isinstance(back["nested"], tuple)


def test_manager_retention_and_restore():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        for s in (10, 20, 30, 40):
            cm.save(s, {"v": torch.full((2,), float(s))})
        assert cm.steps() == [30, 40]
        assert sorted(os.listdir(d)) == ["ckpt_00000030.msgpack.zst",
                                         "ckpt_00000040.msgpack.zst"]
        step, tree = cm.restore(device="cpu")
        assert step == 40 and float(tree["v"][0]) == 40.0
        step, tree = cm.restore(30, device="cpu")
        assert step == 30 and float(tree["v"][0]) == 30.0


def test_restore_of_an_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(device="cpu")


def test_save_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves the last good file in place and no file
    under the checkpoint's name."""
    path = str(tmp_path / "c.msgpack.zst")
    save_pytree(path, {"v": torch.ones(2)})
    before = _read(path)

    def broken(payload, level):
        raise OSError("disk full")
    monkeypatch.setattr(tckpt, "_compress", broken)
    with pytest.raises(OSError):
        save_pytree(path, {"v": torch.zeros(2)})
    assert _read(path) == before
    monkeypatch.undo()
    save_pytree(str(tmp_path / "new.msgpack.zst"), {"v": torch.zeros(2)})
    assert not (tmp_path / "new.msgpack.zst.tmp").exists()


def test_unknown_leaf_type_raises(tmp_path):
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_pytree(str(tmp_path / "c"), {"g": torch.Generator()})
