"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip (the
plain versions are held to the reference in ``test_torch_kernels.py``).
On the card:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.
The file imports no JAX, so it runs where only PyTorch is installed.
Absolute tolerances are ``tests/test_kernels.py``'s f32 ones: cosine
5e-5, mix 1e-4·√n, masked mix 1e-4; the raw Gram matrix within 2e-6·D
(f32 sums of D products in other orders).  bf16 inputs convert to f32
exactly and both sides sum in f32, so bf16 keeps those; the mixes round
their f32 sums to bf16, so they also allow one bf16 ulp of the value
(``rtol`` 2^-7).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (graph_mix, graph_mix_masked,  # noqa: E402
                                 gram_matrix, ops, ref)

SHAPES = [(4, 64), (8, 1000), (16, 8192), (33, 300), (16, 8192 + 7),
          (7, 129), (50, 1000), (50, 51200), (50, 10), (100, 4099),
          (128, 300)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (test_torch_kernels.py tests the plain versions)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernels_match_plain(cuda_device, n, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    tdt = DTYPES[dtype]
    x = torch.randn((n, d), generator=gen, device=cuda_device).to(tdt)
    w = torch.rand((n, n), generator=gen, device=cuda_device)
    edges = torch.rand((n, n), generator=gen, device=cuda_device) < 0.3
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7    # one bf16 ulp
    before = (gram_matrix.launches, graph_mix.launches,
              graph_mix_masked.launches)
    # f32 sums of d products taken in other orders: error grows with d.
    torch.testing.assert_close(gram_matrix(x), ref.gram_matrix(x),
                               atol=2e-6 * d, rtol=1e-5)
    torch.testing.assert_close(ops.pairwise_cosine(x),
                               ref.pairwise_cosine(x), atol=5e-5, rtol=0)
    torch.testing.assert_close(graph_mix(w, x).float(),
                               ref.graph_mix(w, x).float(),
                               atol=1e-4 * n ** 0.5, rtol=rtol)
    torch.testing.assert_close(graph_mix_masked(edges, x).float(),
                               ref.graph_mix_masked(edges, x).float(),
                               atol=1e-4, rtol=rtol)
    torch.cuda.synchronize()
    after = (gram_matrix.launches, graph_mix.launches,
             graph_mix_masked.launches)
    assert [b - a for a, b in zip(before, after)] == [2, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(1, 8, 512), (3, 10, 300), (77, 128, 129)])
def test_cuda_graph_mix_rectangular(cuda_device, m, n, d):
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + d)
    x = torch.randn((n, d), generator=gen, device=cuda_device)
    w = torch.rand((m, n), generator=gen, device=cuda_device)
    got = graph_mix(w, x)
    assert got.shape == (m, d)
    torch.testing.assert_close(got, ref.graph_mix(w, x),
                               atol=1e-4 * n ** 0.5, rtol=0)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn((129, 64), device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        graph_mix_masked(torch.zeros((129, 129), dtype=torch.bool,
                                     device=cuda_device), x)
    with pytest.raises(ValueError, match="contiguous"):
        gram_matrix(torch.randn((64, 8), device=cuda_device).T)
    with pytest.raises(ValueError, match="dtype"):
        gram_matrix(x.double())
