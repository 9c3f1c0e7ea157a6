"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; they are held
to ``repro.kernels.ops`` in interpret mode at ``tests/test_kernels.py``'s
shapes and tolerances (f32 / bf16): cosine 5e-5 / 5e-2, mix 1e-4·√n /
0.15, masked mix 1e-4 / 5e-2.  ``tests/test_torch_cuda.py`` holds the
CUDA kernels to the same plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import apply_mixing as jax_apply_mixing      # noqa: E402
from repro.core import similarity as jsim                    # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro.models.cnn import cnn_params as jax_cnn_params    # noqa: E402
from repro_torch.core import apply_mixing                    # noqa: E402
from repro_torch.core import similarity as tsim              # noqa: E402
from repro_torch.kernels import (graph_mix, graph_mix_masked,  # noqa: E402
                                 ops)
from repro_torch.tree import params_from_jax                 # noqa: E402

SHAPES = [(4, 64), (8, 1000), (16, 8192), (33, 300), (16, 8192 + 7),
          (7, 129), (50, 1000)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype):
    """The same values as a torch and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.as_tensor(a).to(tdt), jnp.asarray(a).astype(jdt)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pairwise_cosine_matches_pallas(n, d, dtype):
    x_t, x_j = _pair(np.random.default_rng(n + d).normal(size=(n, d))
                     .astype(np.float32), dtype)
    got = ops.pairwise_cosine(x_t).numpy()
    want = np.asarray(jops.pairwise_cosine(x_j, interpret=True))
    atol = 5e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=atol)


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_graph_mix_matches_pallas(n, d, dtype):
    rng = np.random.default_rng(n * 7 + d)
    x_t, x_j = _pair(rng.normal(size=(n, d)).astype(np.float32), dtype)
    logits = rng.normal(size=(n, n))
    w = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype(np.float32)
    got = graph_mix(torch.as_tensor(w), x_t)
    want = jops.mix(jnp.asarray(w), x_j, interpret=True)
    assert got.dtype == x_t.dtype
    atol = 1e-4 * np.sqrt(n) if dtype == "float32" else 0.15
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)


@pytest.mark.parametrize("m,n,d", [(1, 8, 512), (3, 10, 300), (6, 6, 129)])
def test_graph_mix_rectangular(m, n, d):
    rng = np.random.default_rng(m * 31 + n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random((m, n)).astype(np.float32)
    got = graph_mix(torch.as_tensor(w), torch.as_tensor(x)).numpy()
    want = np.asarray(jops.mix(jnp.asarray(w), jnp.asarray(x),
                               interpret=True))
    assert got.shape == (m, d)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n,d", [(8, 512), (16, 2048), (7, 129), (33, 300),
                                 (50, 1000), (16, 8192 + 7)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_graph_mix_masked_matches_pallas(n, d, dtype):
    rng = np.random.default_rng(5 + n)
    x_t, x_j = _pair(rng.normal(size=(n, d)).astype(np.float32), dtype)
    edges = rng.random((n, n)) < 0.3
    edges[0] = False                         # a node with no in-edges
    got = graph_mix_masked(torch.as_tensor(edges), x_t)
    want = jops.mix_masked(jnp.asarray(edges), x_j, interpret=True)
    atol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)
    np.testing.assert_array_equal(_f32(got)[0], _f32(x_t)[0])


def _gn_lenet(n, seed=0, perturb=True):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    tree = jax.vmap(lambda k: jax_cnn_params(k))(keys)        # full width
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if perturb:                       # non-degenerate biases and GN leaves
        rng = np.random.default_rng(seed)
        tree = jax.tree_util.tree_map(
            lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(x.dtype),
            tree)
    return tree


@pytest.mark.parametrize("perturb", [True, False])
def test_model_pairwise_cosine_gn_lenet(perturb):
    """Eq. 3 on full-width GN-LeNet parameters; at initialization the
    zero biases must give 0, not NaN."""
    tree = _gn_lenet(4, perturb=perturb)
    port = params_from_jax(tree)
    got = ops.model_pairwise_cosine(port).numpy()
    want = np.asarray(jops.model_pairwise_cosine(
        jax.tree_util.tree_map(jnp.asarray, tree), interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(
        got, np.asarray(jsim.pairwise_model_similarity(tree)), atol=5e-5)


def test_plain_similarity_matches_reference():
    """Eq. 3 in plain PyTorch: one pair, one leaf, and all pairs."""
    tree = _gn_lenet(3, seed=2)
    port = params_from_jax(tree)
    one = lambda t, i: {k: v[i] for k, v in t.items()}
    pair = lambda t, i: jax.tree_util.tree_map(lambda x: x[i], t)
    np.testing.assert_allclose(
        float(tsim.model_similarity(one(port, 0), one(port, 1))),
        float(jsim.model_similarity(pair(tree, 0), pair(tree, 1))),
        atol=1e-6)
    np.testing.assert_allclose(
        float(tsim.layer_cosine(port["fc.w"][1], port["fc.w"][2])),
        float(jsim.layer_cosine(tree["fc"]["w"][1], tree["fc"]["w"][2])),
        atol=1e-6)
    np.testing.assert_allclose(
        tsim.pairwise_model_similarity(port).numpy(),
        np.asarray(jsim.pairwise_model_similarity(tree)), atol=1e-6)


def test_mix_pytrees_match_reference_and_plain_mixing():
    rng = np.random.default_rng(8)
    n = 6
    tree = {"a": rng.normal(size=(n, 9, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 17)).astype(np.float32)}
    port = params_from_jax(tree)
    edges = (rng.random((n, n)) < 0.4) & ~np.eye(n, dtype=bool)
    w = rng.random((n, n)).astype(np.float32)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    cases = [
        (ops.mix_masked_pytree(torch.as_tensor(edges), port),
         jops.mix_masked_pytree(jnp.asarray(edges), jtree, interpret=True)),
        (ops.mix_pytree(torch.as_tensor(w), port),
         jops.mix_pytree(jnp.asarray(w), jtree, interpret=True)),
        (apply_mixing(torch.as_tensor(w), port),
         jax_apply_mixing(jnp.asarray(w), jtree)),
    ]
    for got, want in cases:
        assert list(got) == ["a", "b"]
        for key in tree:
            assert got[key].shape == tree[key].shape
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-5)
