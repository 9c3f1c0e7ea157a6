"""The port's gossip codec (``repro_torch.compress``) against the
reference's (``repro.compress``), bit for bit on the CPU.

Both sides get the same numpy inputs; every wire tensor (codes, scales,
indices, raw values), every decoded payload and every residual must have
the same dtype and the same bits.  The reference's codec runs op by op,
as its own tests call it: under ``jax.jit`` XLA rewrites the division by
the constant qmax into a product with its reciprocal, so some scales and
residuals of the reference's compiled engine differ from its own codec in
a last bit (``tests/test_torch_compress_engine.py`` holds the port to
that engine within its tolerance).  Inputs stay in f32's normal range
(zeros, or magnitudes of 1e-3 and up): XLA's CPU flushes f32 subnormals
to zero and PyTorch does not, so a subnormal payload or scale would be
a backend difference, not a codec one (``repro/compress/codec.py``'s
docstring).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402

from repro.compress import codec as jc                       # noqa: E402
from repro_torch.compress import codec as tc                 # noqa: E402

SPECS = ("int8", "fp8", "topk0.25", "int8+topk0.75", "fp8+topk0.5")
CONFIGS = [(spec, tc.CompressConfig.parse(spec),
            jc.CompressConfig.parse(spec)) for spec in SPECS] + [
    ("int8+topk0.5-no-feedback",
     tc.CompressConfig(quant="int8", topk_frac=0.5, error_feedback=False),
     jc.CompressConfig(quant="int8", topk_frac=0.5, error_feedback=False))]
IDS = [c[0] for c in CONFIGS]
# GN-LeNet CIFAR-10 at width 32: its ten leaves' widths per node, in leaf
# order; conv2.w (51,200) is past the int16 index range.
GN_LENET_LEAVES = (32, 2400, 64, 51200, 10, 40960, 32, 32, 64, 64)


def _bits(x):
    """A wire or payload array as comparable numpy bits (fp8 as bytes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.float8_e4m3fn:
        return x.view(np.uint8)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x


def _same(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype, f"{what}: {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: {g.shape} != {w.shape}"
    assert np.array_equal(g, w), f"{what}: bits differ"


def _rows(rows, d, seed, kind="normal"):
    """``[rows, d]`` f32 in the normal range: Gaussian rows, a zero row,
    and a row scaled down to 1e-3; ``kind="ties"`` gives small integers,
    so magnitudes tie at the top-k cut and at the row maximum."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(-4, 5, size=(rows, d)).astype(np.float32)
    else:
        x = rng.normal(size=(rows, d)).astype(np.float32)
        x[-1] *= np.float32(1e-3)
    x[0] = 0.0
    return x


def _assert_wire(tw, jw, what):
    assert sorted(tw) == sorted(jw), what
    for key in jw:
        _same(tw[key], jw[key], f"{what} {key}")


@pytest.mark.parametrize("spec,tcfg,jcfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("rows,d,kind", [
    (6, 100, "normal"), (5, 7, "normal"), (8, 300, "ties"),
    (3, 40000, "normal"), (3, 40000, "ties")],
    ids=["6x100", "5x7", "ties-8x300", "int32-idx", "int32-idx-ties"])
def test_encode_and_decode_leaf_bitwise(spec, tcfg, jcfg, rows, d, kind):
    x = _rows(rows, d, rows * d, kind)
    tw = tc.encode_leaf(torch.as_tensor(x), tcfg)
    jw = jc.encode_leaf(jnp.asarray(x), jcfg)
    _assert_wire(tw, jw, spec)
    if "idx" in tw:
        assert tw["idx"].dtype == (torch.int16 if d <= tc.INT16_MAX_D
                                   else torch.int32)
    _same(tc.decode_leaf(tw, d, tcfg), jc.decode_leaf(jw, d, jcfg), spec)
    _same(tc.roundtrip_leaf(torch.as_tensor(x), tcfg),
          jc.roundtrip_leaf(jnp.asarray(x), jcfg), spec)


def _tree(n, seed, bf16=False):
    """Node-stacked leaves (sorted keys, the reference's leaf order): a
    conv-like leaf, a wider one, a bias, and a bf16 leaf when asked (the
    int32 index path is :func:`test_encode_and_decode_leaf_bitwise`'s)."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(n, 3, 4, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 2000)).astype(np.float32),
            "c": rng.normal(size=(n, 10)).astype(np.float32) * 1e-2}
    tree["c"][0] = 0.0
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.as_tensor(v) for k, v in tree.items()}
    if bf16:
        v = rng.normal(size=(n, 64)).astype(np.float32)
        jtree["d"] = jnp.asarray(v).astype(jnp.bfloat16)
        ttree["d"] = torch.as_tensor(v).to(torch.bfloat16)
    return ttree, jtree


@pytest.mark.parametrize("delta", [False, True],
                         ids=["encode_payload", "encode_delta_payload"])
@pytest.mark.parametrize("spec,tcfg,jcfg", CONFIGS, ids=IDS)
def test_payload_steps_bitwise(spec, tcfg, jcfg, delta):
    """Two error-feedback steps over a tree with a bf16 leaf: the wire,
    the decoded payloads and the residual carried from step to step."""
    t_step = tc.encode_delta_payload if delta else tc.encode_payload
    j_step = jc.encode_delta_payload if delta else jc.encode_payload
    ttree, jtree = _tree(4, 0, bf16=True)
    tres, jres = tc.zero_residual(ttree), jc.zero_residual(jtree)
    for step in range(2):
        ttree, jtree = _tree(4, step + 1, bf16=True)
        twire, tdec, tres = t_step(ttree, tres, tcfg)
        jwire, jdec, jres = j_step(jtree, jres, jcfg)
        for key in jtree:
            _assert_wire(twire[key], jwire[key], f"{spec} {key}")
            _same(tdec[key], jdec[key], f"{spec} decoded {key}")
            _same(tres[key], jres[key], f"{spec} residual {key}")
        for key, v in jc.decode_wire_tree(jwire, jtree, jcfg).items():
            _same(tc.decode_wire_tree(twire, ttree, tcfg)[key], v, key)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantizer_edges_bitwise(quant):
    """Values that land on the quantizers' edges: exact halves for int8's
    half-to-even rounding, the row maximum at exactly qmax, and fp8
    quotients a hair above 448 (``max / (max / 448)`` need not be 448),
    which must become 448, not NaN."""
    rng = np.random.default_rng(3)
    rows = [np.linspace(-1.0, 1.0, 255, dtype=np.float32),
            (np.arange(-127, 128, dtype=np.float32) + 0.5) / 127.5]
    for m in rng.uniform(0.1, 10.0, size=40).astype(np.float32):
        rows.append((rng.uniform(-1, 1, size=255).astype(np.float32)
                     * m).astype(np.float32))
        rows[-1][0] = m
    x = np.stack(rows)
    cfg = tc.CompressConfig.parse(quant)
    tw = tc.encode_leaf(torch.as_tensor(x), cfg)
    jw = jc.encode_leaf(jnp.asarray(x), jc.CompressConfig.parse(quant))
    _assert_wire(tw, jw, quant)
    q = tw["q"].float()
    assert torch.isfinite(q).all()
    top = tc.INT8_MAX if quant == "int8" else tc.FP8_MAX
    assert bool((q.abs().amax(dim=1) == top).all())
    over = (torch.as_tensor(x) / tw["scale"][:, None]).abs().amax(dim=1)
    if quant == "fp8":
        assert bool((over > tc.FP8_MAX).any()), "no quotient past 448 here"


def test_config_parse_spec_and_gamma():
    specs = ["none", "", "int8", "fp8", "topk", "topk0.1", "int8+topk0.25",
             "fp8+topk0.5+gamma0.3", "gamma0.5", " int8 + topk0.75 ",
             "none+int8"]
    for spec in specs:
        t, j = tc.CompressConfig.parse(spec), jc.CompressConfig.parse(spec)
        assert (t.quant, t.topk_frac, t.error_feedback, t.sim, t.gamma) == \
            (j.quant, j.topk_frac, j.error_feedback, j.sim, j.gamma), spec
        assert t.spec() == j.spec(), spec
        assert t.enabled == j.enabled, spec
        assert t.consensus_gamma == j.consensus_gamma, spec
        assert tc.CompressConfig.parse(t.spec()) == t
    assert tc.CompressConfig.parse(None) == tc.CompressConfig()
    cfg = tc.CompressConfig(quant="fp8")
    assert tc.CompressConfig.parse(cfg) is cfg


@pytest.mark.parametrize("bad,kind", [
    ("int8+fp8", ValueError), ("topk0.1+topk0.2", ValueError),
    ("gamma0.1+gamma0.2", ValueError), ("int4", ValueError),
    ("topk0", ValueError), ("topk1.5", ValueError), ("gamma0", ValueError),
    ("gamma2", ValueError), (3, TypeError), ("auto", TypeError)])
def test_config_rejects_as_the_reference_does(bad, kind):
    with pytest.raises(kind) as want:
        jc.CompressConfig.parse(bad)
    with pytest.raises(kind) as got:
        tc.CompressConfig.parse(bad)
    if bad == "auto":
        assert "auto" in str(got.value) and "tuner" in str(got.value)
    else:
        assert str(got.value) == str(want.value)
    for kw in (dict(quant="int4"), dict(topk_frac=0.0),
               dict(gamma=1.5)):
        with pytest.raises(ValueError) as want:
            jc.CompressConfig(**kw)
        with pytest.raises(ValueError) as got:
            tc.CompressConfig(**kw)
        assert str(got.value) == str(want.value)


def test_wire_bytes_match_over_gn_lenet():
    """``leaf_wire_bytes`` per leaf and ``wire_bytes_tree`` over
    GN-LeNet's full-width leaves at n = 3, for every spec."""
    n = 3
    ttree = {f"{i:02d}": torch.zeros((n, d))
             for i, d in enumerate(GN_LENET_LEAVES)}
    jtree = {k: jnp.zeros((n, v.shape[1])) for k, v in ttree.items()}
    for spec in ("none",) + SPECS + ("int8+topk0.1", "topk0.01", "topk1"):
        t, j = tc.CompressConfig.parse(spec), jc.CompressConfig.parse(spec)
        for d in GN_LENET_LEAVES:
            assert tc.leaf_wire_bytes(d, t) == jc.leaf_wire_bytes(d, j)
        assert tc.wire_bytes_tree(ttree, n, t) == \
            jc.wire_bytes_tree(jtree, n, j), spec
    assert tc.topk_k(7, 0.01) == jc.topk_k(7, 0.01) == 1
