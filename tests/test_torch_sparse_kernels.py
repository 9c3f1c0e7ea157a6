"""The CSR graph-mix wrapper's plain version against the reference's
Pallas kernel (``repro.kernels.ops.mix_sparse`` in interpret mode), over
``tests/test_kernels.py``'s sweep: n % 8 != 0, odd D, k from barely
sparse to fig12's k = 8, f32 and bf16.

Tolerance: ``1e-4 * sqrt(k + 1)`` absolute for f32 (k + 1 f32 products
summed in another order); bf16 inputs convert to f32 exactly and both
sides sum in f32, so bf16 keeps that atol and adds one bf16 ulp of the
value (``rtol`` 2^-7) for the rounding of the output to bf16.
``tests/test_torch_cuda.py`` holds the CUDA kernel to the same plain
version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.kernels import ops as jops                        # noqa: E402
from repro.sparse import SparseAdjacency as JaxAdjacency     # noqa: E402
from repro.sparse import sparse_mix_pytree as jax_mix_pytree  # noqa: E402
from repro_torch.kernels import graph_mix_sparse, ops, ref   # noqa: E402
from repro_torch.sparse import (SparseAdjacency,          # noqa: E402
                                sparse_mix_pytree, sparse_mix_rows)
from repro_torch.tree import params_from_jax                 # noqa: E402

SHAPES = [(8, 256), (33, 300), (7, 129), (50, 1000), (16, 8192 + 7)]
CASES = [(n, d, k) for n, d in SHAPES for k in (2, 3, 8) if k < n]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0 ** -7


def _random_csr(seed, n, k):
    """k distinct non-self senders per row, random weights."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(np.delete(np.arange(n), i))[:k]
                    for i in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    w_self = rng.random(n).astype(np.float32)
    return idx, w, w_self


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tol(k, dtype):
    return 1e-4 * np.sqrt(k + 1), (0.0 if dtype == "float32" else BF16_ULP)


@pytest.mark.parametrize("n,d,k", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mix_sparse_matches_pallas(n, d, k, dtype):
    idx, w, w_self = _random_csr(n * 13 + d + k, n, k)
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(d + k).normal(size=(n, d)).astype(np.float32)
    xt = torch.as_tensor(x).to(tdt)
    want = jops.mix_sparse(jnp.asarray(idx), jnp.asarray(w),
                           jnp.asarray(w_self), jnp.asarray(x).astype(jdt),
                           interpret=True)
    atol, rtol = _tol(k, dtype)
    for got in (ops.mix_sparse(*map(torch.as_tensor, (idx, w, w_self)), xt),
                ref.graph_mix_sparse(*map(torch.as_tensor, (idx, w, w_self)),
                                     xt)):
        assert got.dtype == tdt and got.shape == (n, d)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mix_sparse_mask_parks_invalid_slots(dtype):
    """Masked slots contribute nothing, whatever idx and w carry there;
    a row with no valid slot keeps w_self times its own model."""
    n, d, k = 9, 64, 3
    tdt, jdt = DTYPES[dtype]
    idx, w, w_self = _random_csr(3, n, k)
    mask = np.random.default_rng(4).random((n, k)) < 0.5
    mask[0] = False
    trash_idx = np.where(mask, idx, n - 1).astype(np.int32)
    trash_w = np.where(mask, w, 7.5).astype(np.float32)
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    want = jops.mix_sparse(jnp.asarray(trash_idx), jnp.asarray(trash_w),
                           jnp.asarray(w_self), jnp.asarray(x).astype(jdt),
                           mask=jnp.asarray(mask), interpret=True)
    xt = torch.as_tensor(x).to(tdt)
    got = ops.mix_sparse(torch.as_tensor(trash_idx), torch.as_tensor(trash_w),
                         torch.as_tensor(w_self), xt,
                         mask=torch.as_tensor(mask))
    atol, rtol = _tol(k, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)
    np.testing.assert_array_equal(
        _f32(got)[0], _f32((w_self[0] * xt[0].float()).to(tdt)))


def test_sparse_mix_pytree_matches_reference():
    """The engine's leaf-wise mix keeps shapes, dtypes and leaf order."""
    n, k = 10, 3
    idx, w, w_self = _random_csr(11, n, k)
    mask = np.ones((n, k), bool)
    mask[2, 1] = False
    rng = np.random.default_rng(12)
    tree = {"a": rng.normal(size=(n, 9, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 17)).astype(np.float32)}
    jadj = JaxAdjacency(idx=jnp.asarray(idx), w=jnp.asarray(w),
                        w_self=jnp.asarray(w_self), mask=jnp.asarray(mask))
    adj = SparseAdjacency(*(torch.as_tensor(a).clone()
                            for a in (idx, w, w_self, mask)))
    adj = adj._replace(idx=adj.idx.long())
    want = jax_mix_pytree(jadj, jax.tree_util.tree_map(jnp.asarray, tree))
    got = sparse_mix_pytree(adj, params_from_jax(tree))
    assert list(got) == ["a", "b"]
    for key in tree:
        assert got[key].shape == tree[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)
    np.testing.assert_array_equal(
        sparse_mix_rows(adj, params_from_jax(tree)["b"]).numpy(),
        got["b"].numpy())


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs its plain version and counts no
    launch."""
    idx, w, w_self = map(torch.as_tensor, _random_csr(1, 6, 2))
    x = torch.randn(6, 40)
    before = graph_mix_sparse.launches
    assert torch.equal(graph_mix_sparse(idx, w, w_self, x),
                       ref.graph_mix_sparse(idx, w, w_self, x))
    assert graph_mix_sparse.launches == before

