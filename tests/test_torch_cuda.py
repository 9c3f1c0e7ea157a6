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
(``rtol`` 2^-7).  The CSR mix keeps ``tests/test_kernels.py``'s sparse
tolerance, 1e-4·√(k+1), with the same bf16 ulp.  The selective scan keeps
``tests/test_kernels.py``'s f32 atol of 1e-5 and adds an rtol of 1e-5:
kernel and plain version round the same products and sums in the same
order, so they can differ only where their ``exp`` does, and a one-ulp
``exp`` difference moves ``h`` (and ``y``, which grows with L where
``dt a`` is near 0) relatively; bf16 inputs convert to f32 exactly and the
outputs are f32, so bf16 keeps the same tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (graph_mix, graph_mix_leaves,  # noqa: E402
                                 graph_mix_masked, graph_mix_masked_leaves,
                                 graph_mix_sparse, graph_mix_sparse_leaves,
                                 gram_matrices, gram_matrix, ops, ref,
                                 selective_scan)

# n = 129, 200 and 1000 take the dense mixes' tiled route (W past 128).
SHAPES = [(4, 64), (8, 1000), (16, 8192), (33, 300), (16, 8192 + 7),
          (7, 129), (50, 1000), (50, 51200), (50, 10), (100, 4099),
          (128, 300), (129, 129), (200, 1000), (1000, 4099)]
SPARSE_SHAPES = [(8, 256), (33, 300), (7, 129), (50, 1000), (16, 8192 + 7)]
SPARSE_CASES = [(n, d, k) for n, d in SPARSE_SHAPES for k in (2, 3, 8)
                if k < n] + [(1000, 51200, 3)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Grouped calls: GN-LeNet's ten leaf widths at the paper's n = 50, ragged
# widths, and past one Gram tile and the small mix route (n = 129; GN-LeNet
# on the tiled route at n = 129, 200 and 1000).
GN_LENET = [32, 2400, 64, 51200, 10, 40960, 32, 32, 64, 64]
GROUPED = {"gn_lenet_n50": (50, GN_LENET),
           "ragged_n7": (7, [1, 10, 129, 8199]),
           "n100": (100, [64, 2400, 10]), "n129": (129, [64, 129, 2400]),
           "gn_lenet_n129": (129, GN_LENET), "gn_lenet_n200": (200, GN_LENET),
           "gn_lenet_n1000": (1000, GN_LENET)}
# (batch, L, d_inner, d_state): tests/test_kernels.py's four, a ragged
# d_inner (bf16 rows of 200 bytes, not 16-byte aligned), one step, an L
# that is no multiple of the kernel's 32-step tile, and a width past one
# block of channels; then d_inner no multiple of a block's channels (128
# at d_state 16, 256 at 8 and 4) at each d_state, an odd d_inner (bf16
# rows not even 4-byte aligned) with b and c rows of 8 bytes starting off
# 16-byte boundaries, one step at d_state 8 and 16, and L = 65 (two full
# tiles and one step).
SCAN_SHAPES = [(2, 16, 64, 8), (1, 32, 128, 16), (3, 8, 96, 4),
               (2, 64, 256, 16), (2, 16, 100, 8), (2, 1, 64, 16),
               (1, 37, 96, 16), (2, 100, 1000, 16),
               (3, 33, 37, 4), (2, 96, 1000, 4), (1, 65, 300, 8),
               (2, 1, 200, 8), (3, 1, 7, 16), (5, 7, 100, 16)]
# dtypes of (x, dt, b and c): all f32, all bf16, and apply_mamba's bf16
# serving mix (x, b, c bf16; dt f32).
SCAN_TYPES = {"f32": ("float32",) * 3, "bf16": ("bfloat16",) * 3,
              "serving": ("bfloat16", "float32", "bfloat16")}


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
@pytest.mark.parametrize("case", sorted(GROUPED))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_grouped_calls_are_the_per_leaf_calls(cuda_device, case, dtype):
    n, ds = GROUPED[case]
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    xs = [torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype]) for d in ds]
    w = torch.rand((n, n), generator=gen, device=cuda_device)
    edges = torch.rand((n, n), generator=gen, device=cuda_device) < 0.1
    before = (gram_matrix.launches, graph_mix.launches,
              graph_mix_masked.launches)
    g = gram_matrices(xs)
    ys = graph_mix_leaves(w, xs)
    zs = graph_mix_masked_leaves(edges, xs)
    torch.cuda.synchronize()
    # One launch a call, on the tiled route past 128 nodes too.
    assert (gram_matrix.launches - before[0], graph_mix.launches - before[1],
            graph_mix_masked.launches - before[2]) == (1, 1, 1)
    again = (graph_mix_leaves(w, xs), graph_mix_masked_leaves(edges, xs))
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    for i, x in enumerate(xs):
        assert torch.equal(g[i], gram_matrix(x))
        assert torch.equal(ys[i], graph_mix(w, x))
        assert torch.equal(zs[i], graph_mix_masked(edges, x))
        assert torch.equal(ys[i], again[0][i])
        assert torch.equal(zs[i], again[1][i])
        torch.testing.assert_close(g[i], ref.gram_matrix(x),
                                   atol=2e-6 * x.shape[1], rtol=1e-5)
        torch.testing.assert_close(ys[i].float(), ref.graph_mix(w, x).float(),
                                   atol=1e-4 * n ** 0.5, rtol=rtol)
        torch.testing.assert_close(zs[i].float(),
                                   ref.graph_mix_masked(edges, x).float(),
                                   atol=1e-4, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 100, 129])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_gram_gives_the_same_bits_twice(cuda_device, n, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    xs = [torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype]) for d in (51200, 2400, 10)]
    first, second = gram_matrices(xs), gram_matrices(xs)
    assert torch.equal(first, second)
    assert torch.equal(first, first.transpose(1, 2))     # mirrored tiles
    stacked = {str(i): x for i, x in enumerate(xs)}
    assert torch.equal(ops.model_pairwise_cosine(stacked),
                       ops.model_pairwise_cosine(stacked))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 129])
@pytest.mark.parametrize("d", [10, 2400, 51200])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_gram_past_one_tile(cuda_device, n, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n * d)
    x = torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype])
    torch.testing.assert_close(gram_matrix(x), ref.gram_matrix(x),
                               atol=2e-6 * d, rtol=1e-5)
    torch.testing.assert_close(ops.pairwise_cosine(x),
                               ref.pairwise_cosine(x), atol=5e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_parameter_dict_ops_at_the_gn_lenet_leaves(cuda_device, dtype):
    """The grouped paths of ``ops`` against the plain versions leaf by
    leaf, and the grouped cosine against the card's leaf-by-leaf loop."""
    n = 50
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    stacked = {f"leaf{i}": torch.randn((n, d), generator=gen,
                                       device=cuda_device).to(DTYPES[dtype])
               for i, d in enumerate(GN_LENET)}
    w = torch.softmax(torch.randn((n, n), generator=gen,
                                  device=cuda_device), 1)
    edges = torch.rand((n, n), generator=gen, device=cuda_device) < 3.0 / n
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    mixed = ops.mix_pytree(w, stacked)
    averaged = ops.mix_masked_pytree(edges, stacked)
    for k, x in stacked.items():
        torch.testing.assert_close(mixed[k].float(),
                                   ref.graph_mix(w, x).float(),
                                   atol=1e-4 * n ** 0.5, rtol=rtol)
        torch.testing.assert_close(averaged[k].float(),
                                   ref.graph_mix_masked(edges, x).float(),
                                   atol=1e-4, rtol=rtol)
    loop = torch.zeros((n, n), device=cuda_device)
    for x in stacked.values():
        loop += ops.pairwise_cosine(x)
    assert torch.equal(ops.model_pairwise_cosine(stacked),
                       loop / len(stacked))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SPARSE_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_graph_mix_sparse_matches_plain(cuda_device, n, d, k, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n + d + k)
    x = torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype])
    # k distinct non-self senders per row; some slots invalid (parked).
    scores = torch.rand((n, n), generator=gen, device=cuda_device)
    scores.fill_diagonal_(-1.0)
    idx = scores.topk(k, dim=1).indices
    w = torch.rand((n, k), generator=gen, device=cuda_device)
    w_self = torch.rand((n,), generator=gen, device=cuda_device)
    mask = torch.rand((n, k), generator=gen, device=cuda_device) < 0.9
    before = graph_mix_sparse.launches
    got = ops.mix_sparse(idx, w, w_self, x, mask=mask)
    rows = torch.arange(n, device=cuda_device)[:, None]
    want = ref.graph_mix_sparse(torch.where(mask, idx, rows),
                                torch.where(mask, w, 0.0), w_self, x)
    torch.cuda.synchronize()
    assert graph_mix_sparse.launches == before + 1
    assert got.dtype == x.dtype
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(),
                               atol=1e-4 * (k + 1) ** 0.5, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,invalid", [(50, 3, 0.0), (50, 49, 0.3),
                                         (1000, 3, 0.0), (1000, 999, 0.3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_grouped_csr_is_the_per_leaf_calls_and_plain(cuda_device, n, k,
                                                          invalid, dtype):
    """One grouped CSR call over GN-LeNet's leaves is one launch, and each
    leaf is the per-leaf call and the plain version bit for bit, the same
    bits twice (invalid slots parked on their own row)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + k)
    xs = [torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype]) for d in GN_LENET]
    scores = torch.rand((n, n), generator=gen, device=cuda_device)
    scores.fill_diagonal_(-1.0)
    idx = scores.topk(k, dim=1).indices
    w = torch.rand((n, k), generator=gen, device=cuda_device)
    w_self = torch.rand((n,), generator=gen, device=cuda_device)
    mask = torch.rand((n, k), generator=gen, device=cuda_device) >= invalid
    rows = torch.arange(n, device=cuda_device)[:, None]
    parked = (torch.where(mask, idx, rows).to(torch.int32).contiguous(),
              torch.where(mask, w, 0.0).contiguous(), w_self)
    before = graph_mix_sparse.launches
    ys = graph_mix_sparse_leaves(*parked, xs)
    torch.cuda.synchronize()
    assert graph_mix_sparse.launches == before + 1
    again = graph_mix_sparse_leaves(*parked, xs)
    for y, y2, x in zip(ys, again, xs):
        assert y.dtype == x.dtype
        assert torch.equal(y, ref.graph_mix_sparse(*parked, x))
        assert torch.equal(y, graph_mix_sparse(*parked, x))
        assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,half", [(50, 25), (1000, 500), (7, 3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_csr_block_and_push_partials_are_plain(cuda_device, n, half,
                                                     dtype):
    """The CSR kernel as a sharded engine calls it: a receiver block whose
    own rows start at ``self0`` of the gathered population is those rows
    of the whole mix and the plain version bit for bit; the push partials
    (every receiver over one rank's senders, no self term) are the plain
    version bit for bit; one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + half)
    xs = [torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype]) for d in GN_LENET]
    scores = torch.rand((n, n), generator=gen, device=cuda_device)
    scores.fill_diagonal_(-1.0)
    idx = scores.topk(3, dim=1).indices.to(torch.int32)
    w = torch.rand((n, 3), generator=gen, device=cuda_device)
    w_self = torch.rand((n,), generator=gen, device=cuda_device)
    whole = graph_mix_sparse_leaves(idx, w, w_self, xs)
    block = (idx[half:].contiguous(), w[half:].contiguous(),
             w_self[half:].contiguous())
    before = graph_mix_sparse.launches
    ys = graph_mix_sparse_leaves(*block, xs, self0=half)
    push = (idx.remainder(half).contiguous(), w)
    parts = graph_mix_sparse_leaves(*push, None, [x[:half] for x in xs],
                                    self0=None)
    assert graph_mix_sparse.launches == before + 2
    for x, y, full, part in zip(xs, ys, whole, parts):
        assert y.shape == (n - half, x.shape[1]) and part.shape == x.shape
        assert torch.equal(y, full[half:])
        assert torch.equal(y, ref.graph_mix_sparse(*block, x, half))
        assert torch.equal(part, ref.graph_mix_sparse(*push, None, x[:half],
                                                      None))
    with pytest.raises(ValueError, match="self0"):
        graph_mix_sparse_leaves(*block, xs, self0=half + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(1, 8, 512), (3, 10, 300), (77, 128, 129),
                                   (129, 200, 300), (1000, 130, 64),
                                   (5, 1000, 2400)])
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
    # 129 nodes: once refused, now the tiled route, held to the plain mix.
    edges = torch.rand((129, 129), device=cuda_device) < 0.05
    torch.testing.assert_close(graph_mix_masked(edges, x),
                               ref.graph_mix_masked(edges, x),
                               atol=1e-4, rtol=0)
    idx = torch.zeros((129, 2), dtype=torch.int64, device=cuda_device)
    w = torch.zeros((129, 2), device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        graph_mix_sparse(idx, w, w[:, 0].contiguous(), x)
    with pytest.raises(ValueError, match="contiguous"):
        gram_matrix(torch.randn((64, 8), device=cuda_device).T)
    with pytest.raises(ValueError, match="dtype"):
        gram_matrix(x.double())


def scan_inputs(dev, gen, bt, L, di, ds, types=("float32",) * 3):
    """x, dt (post-softplus), b, c, a = -exp(.), h0 on the card."""
    tx, tdt, tbc = (DTYPES[t] for t in types)
    x = torch.randn((bt, L, di), generator=gen, device=dev).to(tx)
    dt = torch.nn.functional.softplus(torch.randn(
        (bt, L, di), generator=gen, device=dev)).to(tdt)
    b = (torch.randn((bt, L, ds), generator=gen, device=dev) * 0.5).to(tbc)
    c = (torch.randn((bt, L, ds), generator=gen, device=dev) * 0.5).to(tbc)
    a = -torch.exp(torch.randn((di, ds), generator=gen, device=dev) * 0.3)
    h0 = torch.randn((bt, di, ds), generator=gen, device=dev) * 0.1
    return x, dt, b, c, a, h0


@pytest.mark.cuda
@pytest.mark.parametrize("bt,L,di,ds", SCAN_SHAPES)
@pytest.mark.parametrize("types", sorted(SCAN_TYPES))
def test_cuda_selective_scan_matches_plain(cuda_device, bt, L, di, ds,
                                           types):
    gen = torch.Generator(device=cuda_device).manual_seed(bt * L + di)
    args = scan_inputs(cuda_device, gen, bt, L, di, ds, SCAN_TYPES[types])
    before = selective_scan.launches
    y, h = selective_scan(*args)
    yr, hr = ref.selective_scan(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_selective_scan_chunk_chaining(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x, dt, b, c, a, h0 = scan_inputs(cuda_device, gen, 2, 96, 300, 16)
    y, h = selective_scan(x, dt, b, c, a, h0)
    cut = 37
    y1, h1 = selective_scan(*(t[:, :cut].contiguous() for t in (x, dt, b, c)),
                            a, h0)
    y2, h2 = selective_scan(*(t[:, cut:].contiguous() for t in (x, dt, b, c)),
                            a, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(h2, h, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [4, 8, 16])
@pytest.mark.parametrize("types", sorted(SCAN_TYPES))
def test_cuda_selective_scan_takes_unaligned_inputs(cuda_device, ds, types):
    """x, dt, b, c, a and h0 each one element past a 16-byte boundary (a
    contiguous view into a larger buffer): the kernel takes its 4-byte and
    plain loads and its scalar state loads, with the same results."""
    gen = torch.Generator(device=cuda_device).manual_seed(ds)
    args = scan_inputs(cuda_device, gen, 2, 40, 96, ds, SCAN_TYPES[types])

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    moved = [shifted(t) for t in args]
    assert all(t.data_ptr() % 16 != 0 for t in moved)
    y, h = selective_scan(*moved)
    yr, hr = ref.selective_scan(*args)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hr, atol=1e-5, rtol=1e-5)
    y0, h0 = selective_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.cuda
def test_cuda_selective_scan_refuses_what_the_kernel_does_not_take(
        cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, dt, b, c, a, h0 = scan_inputs(cuda_device, gen, 2, 8, 64, 16)
    with pytest.raises(ValueError, match="d_state"):
        selective_scan(x, dt, torch.cat([b, b], -1), torch.cat([c, c], -1),
                       torch.cat([a, a], -1), torch.cat([h0, h0], -1))
    with pytest.raises(ValueError, match="dtype"):
        selective_scan(x, dt, b, c.bfloat16(), a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(x.transpose(0, 1).contiguous().transpose(0, 1), dt,
                       b, c, a, h0)


@pytest.mark.cuda
def test_cuda_runner_computes_convolutions_in_f32_whatever_the_flags(
        cuda_device):
    """GN-LeNet (full width, 8 nodes, 3 rounds) through the runner gives the
    same parameters, bit for bit, with cuDNN's TF32 flag at torch's default
    (on) as with it cleared: the runner clears it around its local step
    and evaluator.  Deterministic cuDNN algorithms in both runs, so the
    two runs can agree bit for bit."""
    from repro_torch.core import InGraphStaticStrategy
    from repro_torch.data import (StackedBatcher, dirichlet_partition,
                                  make_image_classification,
                                  train_test_split)
    from repro_torch.dlrt import DecentralizedRunner, RunnerConfig
    from repro_torch.models import cnn_loss, cnn_params
    from repro_torch.optim import sgd
    import numpy as np

    cudnn = torch.backends.cudnn
    ds = make_image_classification(400, num_classes=10, image_size=32,
                                   channels=3, seed=0)
    tr, te = train_test_split(ds, 0.2, seed=0)
    parts = dirichlet_partition(tr.labels, 8, 0.5, np.random.default_rng(0))

    def run(allow_tf32):
        before = (cudnn.allow_tf32, cudnn.deterministic)
        cudnn.allow_tf32, cudnn.deterministic = allow_tf32, True
        try:
            runner = DecentralizedRunner(
                init_fn=lambda g: cnn_params(g, in_channels=3,
                                             num_classes=10, image_size=32,
                                             width=32),
                loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.05),
                batcher=StackedBatcher(tr, parts, 8, seed=3),
                test_batch={"images": te.images, "labels": te.labels},
                strategy=InGraphStaticStrategy(n=8, degree=3,
                                               device=cuda_device),
                cfg=RunnerConfig(n_nodes=8, rounds=3, eval_every=2),
                device=cuda_device)
            runner.run()
            assert cudnn.allow_tf32 is allow_tf32
            return runner
        finally:
            cudnn.allow_tf32, cudnn.deterministic = before

    default, cleared = run(True), run(False)
    for key in default.params:
        assert torch.equal(default.params[key], cleared.params[key]), key
    for a, b in zip(default.log.records, cleared.log.records):
        assert (a.mean_accuracy, a.mean_loss) == (b.mean_accuracy,
                                                  b.mean_loss)


CODEC_SPECS = ("int8", "fp8", "topk0.25", "int8+topk0.75", "fp8+topk0.5",
               "int8+topk0.5-no-feedback")


def _codec_config(spec):
    from repro_torch.compress import CompressConfig
    if spec.endswith("-no-feedback"):
        cfg = CompressConfig.parse(spec.removesuffix("-no-feedback"))
        return CompressConfig(quant=cfg.quant, topk_frac=cfg.topk_frac,
                              error_feedback=False)
    return CompressConfig.parse(spec)


def _codec_tree(n, seed):
    """GN-LeNet's ten full-width leaves at ``n`` nodes (f32, on the CPU):
    Gaussian rows, a zero row, a row of small integers (magnitudes tie at
    the top-k cut and at the row maximum), and a row whose largest value
    sits where ``max / (max / 448)`` lands a hair above 448."""
    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for i, d in enumerate(GN_LENET):
        x = torch.randn((n, d), generator=gen)
        x[0] = 0.0
        x[1] = torch.randint(-4, 5, (d,), generator=gen).float()
        x[2] = torch.rand((d,), generator=gen) * 2 - 1
        x[2, 0] = 4.848870754241943  # max / (max / 448) > 448 in f32
        tree[f"{i:02d}"] = x
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 1000])
@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_cuda_codec_is_the_cpu_codec(cuda_device, spec, n):
    """Two difference-coded error-feedback steps over GN-LeNet's
    full-width leaves (conv2 past the int16 index range): every wire
    tensor, decoded payload and residual on the card has the bits of the
    CPU's, fp8 codes at +-448 and top-k's tie order included."""
    from repro_torch.compress import encode_delta_payload, zero_residual
    cfg = _codec_config(spec)
    cpu = _codec_tree(n, 0)
    card = {k: v.to(cuda_device) for k, v in cpu.items()}
    r_cpu, r_card = zero_residual(cpu), zero_residual(card)
    for step in range(2):
        if step:
            cpu = {k: v * 0.5 for k, v in cpu.items()}
            card = {k: v * 0.5 for k, v in card.items()}
        w_cpu, d_cpu, r_cpu = encode_delta_payload(cpu, r_cpu, cfg)
        w_card, d_card, r_card = encode_delta_payload(card, r_card, cfg)
        for key in cpu:
            for field, want in w_cpu[key].items():
                got = w_card[key][field].cpu()
                assert got.dtype == want.dtype, (key, field)
                if got.dtype == torch.float8_e4m3fn:
                    got, want = got.view(torch.uint8), want.view(torch.uint8)
                assert torch.equal(got, want), (key, field, step)
            assert torch.equal(d_card[key].cpu(), d_cpu[key]), (key, step)
            assert torch.equal(r_card[key].cpu(), r_cpu[key]), (key, step)
            if cfg.quant == "fp8" and step == 0:
                # Row 2's quotient past 448 became 448, not NaN.
                q = w_card[key]["q"].float()
                assert torch.isfinite(q).all()
                assert float(q[2].abs().max()) == 448.0, key


@pytest.mark.cuda
@pytest.mark.parametrize("name,spec", [("morph", "int8+topk0.75"),
                                       ("static", "int8"),
                                       ("sparse-morph", "int8+topk0.75")])
def test_cuda_compressed_round_launches_one_grouped_kernel(cuda_device, name,
                                                           spec):
    """A compressed round of reduced GN-LeNet at n = 8: the Eq.-3 refresh on
    the replicas is one grouped Gram launch and the mix one grouped launch
    (masked for Morph, dense for Static, CSR for sparse Morph)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import InGraphMorphStrategy, InGraphStaticStrategy
    from repro_torch.data import (StackedBatcher, dirichlet_partition,
                                  make_image_classification,
                                  train_test_split)
    from repro_torch.dlrt import DecentralizedRunner, RunnerConfig
    from repro_torch.models import cnn_loss, cnn_params
    from repro_torch.optim import sgd
    from repro_torch.sparse import SparseMorphStrategy

    n = 8
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    strategy = {"morph": lambda: InGraphMorphStrategy(n=n, k=3, seed=0,
                                                      device=cuda_device),
                "static": lambda: InGraphStaticStrategy(n=n, degree=3,
                                                        device=cuda_device),
                "sparse-morph": lambda: SparseMorphStrategy(
                    n=n, k=3, seed=0, device=cuda_device)}[name]()
    runner = DecentralizedRunner(
        init_fn=lambda g: cnn_params(g, in_channels=3, num_classes=4,
                                     image_size=8, width=4),
        loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.05),
        batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch={"images": te.images, "labels": te.labels},
        strategy=strategy,
        cfg=RunnerConfig(n_nodes=n, rounds=2, eval_every=1,
                         engine="sparse" if name == "sparse-morph"
                         else "dense", compress=spec),
        device=cuda_device)
    eng = runner._make_engine()
    for rnd in range(2):
        kernels.reset_launches()
        eng.round(rnd)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in kernels.KERNELS}
        want = dict.fromkeys(got, 0)
        want.update({"morph": dict(gram_matrix=1, graph_mix_masked=1),
                     "static": dict(graph_mix=1),
                     "sparse-morph": dict(graph_mix_sparse=1)}[name])
        assert got == want, (rnd, got)


def _flaky_partitioned(n, round_s):
    from repro_torch.netsim import DenseNetwork, profiles
    return DenseNetwork(profiles.flaky_wan(n, partition_at=0.1,
                                           partition_len=0.3),
                        round_s=round_s)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flaky-wan-n50", "boundary-n300"])
def test_cuda_net_matrices_are_the_cpu_matrices(cuda_device, case):
    """The network model's keyed staleness and drop matrices on the card
    are the CPU's bit for bit: the uniforms are the same CPU draws, and the
    delay is divided by an f32 tensor (a division by a host number is a
    reciprocal product on the card).  ``boundary-n300`` holds the edge
    (121 -> 264 in round 25 of the keyed draws) whose delay, 1.6999999285
    s at round_s = 0.05, is 33 slots by division and 34 by the reciprocal
    product."""
    from repro_torch.netsim import DenseNetwork, NetworkProfile
    if case == "flaky-wan-n50":
        net, n, rnds, size = _flaky_partitioned(50, 0.05), 50, range(12), \
            379_432
    else:
        net = DenseNetwork(NetworkProfile(name="lossy", base_latency_s=1.4,
                                          jitter_s=0.5, drop_rate=0.05,
                                          seed=7),
                           round_s=0.05, max_staleness=64)
        n, rnds, size = 300, (25,), 1000
    depth = net.depth(size)
    for rnd in rnds:
        cpu = net.staleness_matrix(rnd, n, size, depth, device="cpu")
        card = net.staleness_matrix(rnd, n, size, depth, device=cuda_device)
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu), rnd
        assert torch.equal(net.drop_mask(rnd, n, device=cuda_device).cpu(),
                           net.drop_mask(rnd, n, device="cpu")), rnd
    if case == "boundary-n300":
        assert int(cpu[264, 121]) == 33


def _tiny_net_runner(device, name, net, compress="none"):
    import numpy as np

    from repro_torch.core import (InGraphEpidemicStrategy,
                                  InGraphMorphStrategy, InGraphStaticStrategy)
    from repro_torch.data import (StackedBatcher, dirichlet_partition,
                                  make_image_classification,
                                  train_test_split)
    from repro_torch.dlrt import DecentralizedRunner, RunnerConfig
    from repro_torch.models import cnn_loss, cnn_params
    from repro_torch.optim import sgd
    n = 8
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    strategy = {"morph": lambda: InGraphMorphStrategy(n=n, k=3, seed=0,
                                                      device=device),
                "static": lambda: InGraphStaticStrategy(n=n, degree=3,
                                                        device=device),
                "el-oracle": lambda: InGraphEpidemicStrategy(
                    n=n, k=3, seed=0, device=device)}[name]()
    return DecentralizedRunner(
        init_fn=lambda g: cnn_params(g, in_channels=3, num_classes=4,
                                     image_size=8, width=4),
        loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.05),
        batcher=StackedBatcher(tr, parts, 8, seed=3),
        test_batch={"images": te.images, "labels": te.labels},
        strategy=strategy,
        cfg=RunnerConfig(n_nodes=n, rounds=11, eval_every=5, net=net,
                         compress=compress),
        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morph", "static", "el-oracle"])
def test_cuda_net_round_launches_one_grouped_mix(cuda_device, name):
    """A round under the network model (reduced GN-LeNet, n = 8, flaky-WAN
    at round_s = 0.05 with a partition window, ring depth 3): one grouped
    ``graph_mix`` launch over the ``[8, 24]`` staleness-expanded weights,
    one Gram launch for Morph, no masked mix."""
    from repro_torch import kernels
    eng = _tiny_net_runner(cuda_device, name,
                           _flaky_partitioned(8, 0.05))._make_engine()
    assert eng.net_S == 3
    for rnd in range(3):
        kernels.reset_launches()
        eng.round(rnd)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in kernels.KERNELS}
        want = dict.fromkeys(got, 0)
        want["graph_mix"] = 1
        if name == "morph":
            want["gram_matrix"] = 1
        assert got == want, (rnd, got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morph", "static", "el-oracle"])
def test_cuda_net_run_is_the_cpu_run(cuda_device, name):
    """Reduced GN-LeNet under flaky-WAN at round_s = 0.05 with a partition
    window (stale deliveries up to 2 rounds back): the card's run has the
    CPU's edges, delivered sets and network counters, and its parameters
    within 1e-4."""
    import numpy as np
    runs = [_tiny_net_runner(d, name, _flaky_partitioned(8, 0.05))
            for d in (cuda_device, "cpu")]
    for r in runs:
        r.run()
    card, cpu = runs
    for a, b in zip(card.edge_history + card.delivered_history,
                    cpu.edge_history + cpu.delivered_history):
        assert np.array_equal(a, b)
    for key in ("delivered", "dropped", "staleness_sum"):
        assert card.net_stats[key] == cpu.net_stats[key], key
    assert card.net_stats["staleness_hist"].tolist() == \
        cpu.net_stats["staleness_hist"].tolist()
    assert card.staleness_mean() > 0
    for key in cpu.params:
        err = float((card.params[key].cpu() - cpu.params[key]).abs().max())
        assert err <= 1e-4, (key, err)


@pytest.mark.cuda
def test_cuda_uniform_net_mix_is_the_masked_mix(cuda_device):
    """The depth-1 ring's mix of a uniform strategy, ``graph_mix`` on
    ``uniform_weights_torch(edges)``, against ``graph_mix_masked`` on the
    edges, over GN-LeNet's full-width leaves at n = 50: the same
    quotients, summed in the same order, give the same bits."""
    from repro_torch.core.mixing import uniform_weights_torch
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    n = 50
    xs = [torch.randn((n, d), generator=gen, device=cuda_device)
          for d in GN_LENET]
    edges = torch.rand((n, n), generator=gen, device=cuda_device) < 3.0 / n
    edges.fill_diagonal_(False)
    edges[0] = False
    masked = graph_mix_masked_leaves(edges, xs)
    general = graph_mix_leaves(uniform_weights_torch(edges), xs)
    for a, b in zip(masked, general):
        assert torch.equal(a, b)


HOST_TABLE1 = ("morph", "static", "el-oracle", "fully-connected")


def _host_experiment(n, **kw):
    from repro_torch.bench import common
    return common.ExpConfig(n_nodes=n, rounds=11, eval_every=5, k=2,
                            image_size=8, width=4, n_samples=400,
                            num_classes=4, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", HOST_TABLE1)
def test_cuda_host_loop_is_the_cpu_host_loop(cuda_device, name):
    """A tiny host-loop run of each Table-I strategy on the card and on the
    CPU: identical edges every round (and, for the message-faithful Morph
    protocol, identical tallies and views), parameters within 1e-5."""
    from repro_torch.bench import common
    import numpy as np
    cfg = _host_experiment(6)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        runner = common.build_experiment(common.make_strategy(name, cfg),
                                         cfg, dev)
        runner.run()
        runs.append(runner)
    card, cpu = runs
    for a, b in zip(card.edge_history, cpu.edge_history):
        assert np.array_equal(a, b)
    if name == "morph":
        for a, b in ((card.strategy.control_messages,
                      cpu.strategy.control_messages),
                     (card.strategy.similarity_floats,
                      cpu.strategy.similarity_floats)):
            assert a == b
        assert card.strategy.view_sizes().tolist() == \
            cpu.strategy.view_sizes().tolist()
    for key in cpu.params:
        err = float((card.params[key].cpu() - cpu.params[key]).abs().max())
        assert err <= 1e-5, (key, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", HOST_TABLE1)
def test_cuda_host_loop_launches_one_grouped_mix_a_round(cuda_device, name):
    """Every host-loop round mixes every leaf in one grouped launch: the
    masked kernel for a uniform strategy, graph_mix for Static and FC; the
    protocol measures on the host, so no Gram launch."""
    from repro_torch import kernels
    from repro_torch.bench import common
    cfg = _host_experiment(8)
    runner = common.build_experiment(common.make_strategy(name, cfg), cfg,
                                     cuda_device)
    kernels.reset_launches()
    runner.run()
    got = {k.__name__: k.launches for k in kernels.KERNELS}
    want = dict.fromkeys(got, 0)
    uniform = name in ("morph", "el-oracle")
    want["graph_mix_masked" if uniform else "graph_mix"] = cfg.rounds
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morph", "el-local"])
def test_cuda_host_loop_is_the_engine_bit_for_bit(cuda_device, name):
    """In-graph Morph and EL-Local through the host loop's ``round_edges``
    adapters give the engine's edges and parameters bit for bit on the card
    (GN-LeNet width 8 on 16-pixel images, 16 nodes, deterministic
    cuDNN)."""
    from repro_torch.bench import common
    import numpy as np
    cfg = _host_experiment(16, delta_r=5)
    cfg.image_size, cfg.width, cfg.n_samples = 16, 8, 1600
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        runs = []
        for compiled in (True, False):
            runner = common.build_experiment(
                common.make_ingraph_strategy(name, cfg, cuda_device), cfg,
                cuda_device, compiled=compiled)
            runner.run()
            runs.append(runner)
    finally:
        cudnn.deterministic = before
    engine, host = runs
    assert len(host.edge_history) == cfg.rounds
    for a, b in zip(engine.edge_history, host.edge_history):
        assert np.array_equal(a, b)
    for key in engine.params:
        assert torch.equal(engine.params[key], host.params[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", HOST_TABLE1)
def test_cuda_ideal_async_runner_is_the_host_loop(cuda_device, name):
    """A tiny ``AsyncRunner`` run on the ideal network takes the host
    loop's stacked paths on the card: the card's host loop's edges and
    parameters bit for bit (deterministic cuDNN), one grouped mix launch a
    round (the masked kernel for a uniform strategy) and no Gram."""
    from repro_torch import kernels
    from repro_torch.bench import common, fig8
    from repro_torch.netsim import profiles
    import numpy as np
    cfg = _host_experiment(8)
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        host = common.build_experiment(common.make_strategy(name, cfg), cfg,
                                       cuda_device, compiled=False)
        host.run()
        asyn = fig8.build_async(common.make_strategy(name, cfg), cfg,
                                cuda_device, profile=profiles.ideal(),
                                mix_timeout_s=None)
        kernels.reset_launches()
        asyn.run()
        got = {k.__name__: k.launches for k in kernels.KERNELS}
    finally:
        cudnn.deterministic = before
    assert len(asyn.edge_history) == cfg.rounds
    for a, b in zip(host.edge_history, asyn.edge_history):
        assert np.array_equal(a, b)
    for key in host.params:
        assert torch.equal(host.params[key], asyn.params[key]), key
    want = dict.fromkeys(got, 0)
    uniform = name in ("morph", "el-oracle")
    want["graph_mix_masked" if uniform else "graph_mix"] = cfg.rounds
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morph", "el-oracle"])
def test_cuda_wan_async_run_is_the_cpu_run(cuda_device, name):
    """A tiny ``AsyncRunner`` run under WAN (deliveries spread, nodes step
    alone, per-node host mixes) on the card and on the CPU: the same
    events, edges, transport counters and staleness histogram, parameters
    within 1e-5."""
    from repro_torch.bench import common, fig8
    from repro_torch.netsim import profiles
    import dataclasses
    import numpy as np
    cfg = _host_experiment(6)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        runner = fig8.build_async(common.make_strategy(name, cfg), cfg, dev,
                                  profile=profiles.wan())
        runner.run()
        runs.append(runner)
    card, cpu = runs
    assert len(card.edge_history) == len(cpu.edge_history) == cfg.rounds
    for a, b in zip(card.edge_history, cpu.edge_history):
        assert np.array_equal(a, b)
    assert card.netlog.staleness_hist == cpu.netlog.staleness_hist
    assert sum(k != 0 for k in cpu.netlog.staleness_hist) > 0
    assert dataclasses.asdict(card.transport.stats) == \
        dataclasses.asdict(cpu.transport.stats)
    assert (card.loop.processed, card.realized_indegrees) == \
        (cpu.loop.processed, cpu.realized_indegrees)
    for key in cpu.params:
        err = float((card.params[key].cpu() - cpu.params[key]).abs().max())
        assert err <= 1e-5, (key, err)


# ---------------------------------------------------------------------------
# The sweep farm: one W per leaf
# ---------------------------------------------------------------------------

SWEEP_MIX = [(50, 3), (50, 8), (200, 3), (1000, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,E", SWEEP_MIX)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_sweep_per_row_w_is_the_one_w_launches(cuda_device, n, E,
                                                    dtype):
    """E experiments' GN-LeNet leaves in one grouped call, each row with
    its experiment's W (or E), bit for bit E one-W calls of the same
    leaves, on the small route (n = 50) and the tiled one (200, 1000), in
    ceil(E L / MAX_LEAVES) launches."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.graph_mix")
    gen = torch.Generator(device=cuda_device).manual_seed(n + E)
    xs = [[torch.randn((n, d), generator=gen, device=cuda_device).to(
        DTYPES[dtype]) for d in GN_LENET] for _ in range(E)]
    ws = torch.rand((E, n, n), generator=gen, device=cuda_device)
    es = torch.rand((E, n, n), generator=gen, device=cuda_device) < 3.0 / n
    L = len(GN_LENET)
    flat = [x for row in xs for x in row]
    before = (graph_mix.launches, graph_mix_masked.launches)
    ys = graph_mix_leaves([ws[e] for e in range(E) for _ in GN_LENET], flat)
    zs = graph_mix_masked_leaves([es[e] for e in range(E) for _ in GN_LENET],
                                 flat)
    torch.cuda.synchronize()
    launches = -(-E * L // gm.MAX_LEAVES)
    assert (graph_mix.launches - before[0],
            graph_mix_masked.launches - before[1]) == (launches, launches)
    for e in range(E):
        one_w = graph_mix_leaves(ws[e], xs[e])
        one_e = graph_mix_masked_leaves(es[e], xs[e])
        for i in range(L):
            assert torch.equal(ys[e * L + i], one_w[i]), (e, i)
            assert torch.equal(zs[e * L + i], one_e[i]), (e, i)


@pytest.mark.cuda
def test_cuda_sweep_ops_are_each_experiments_own(cuda_device):
    """Over an ``[E, 50, ...]`` stack of GN-LeNet's leaves the sweep's Eq.-3
    matrices and mixes are each experiment's own calls bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    E, n = 5, 50
    stacked = {str(i): torch.randn((E, n, d), generator=gen,
                                   device=cuda_device)
               for i, d in enumerate(GN_LENET)}
    w = torch.softmax(torch.randn((E, n, n), generator=gen,
                                  device=cuda_device), -1)
    e = torch.rand((E, n, n), generator=gen, device=cuda_device) < 0.06
    sim = ops.model_pairwise_cosine(stacked, experiments=True)
    mixed, masked = ops.mix_pytree(w, stacked), \
        ops.mix_masked_pytree(e, stacked)
    for x in range(E):
        one = {k: v[x].contiguous() for k, v in stacked.items()}
        assert torch.equal(sim[x], ops.model_pairwise_cosine(one))
        for k, v in ops.mix_pytree(w[x], one).items():
            assert torch.equal(mixed[k][x], v)
        for k, v in ops.mix_masked_pytree(e[x], one).items():
            assert torch.equal(masked[k][x], v)


def _tiny_sweep(device, name, model, seeds, net=None, **kw):
    import numpy as np
    from repro_torch.bench import common
    from repro_torch.data import (DeviceDataStream, dirichlet_partition,
                                  make_image_classification,
                                  train_test_split)
    from repro_torch.dlrt import RunnerConfig, SweepSpec, SweepSuperstep
    from repro_torch.models import cnn_loss, cnn_params, mlp_loss, mlp_params
    from repro_torch.optim import sgd
    n = 6
    ds = make_image_classification(300, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    init, loss = (mlp_params, mlp_loss) if model == "mlp" else (
        lambda g: cnn_params(g, in_channels=3, num_classes=4, image_size=8,
                             width=4), cnn_loss)
    from repro_torch import fold_seed

    class HostSlots(DeviceDataStream):
        """Slots keyed on a CPU generator: the same batches on any
        device (a stream's own generator lives on its device)."""

        def slots(self, rnd):
            gen = torch.Generator().manual_seed(fold_seed(self.seed, rnd))
            sizes = self.sizes.cpu()[:, None]
            u = torch.rand((self.n, self.batch), generator=gen)
            return torch.minimum((u * sizes).long(), sizes - 1).to(device)

    spec = SweepSpec(seeds=seeds)
    return SweepSuperstep(
        spec=spec, init_fn=init, loss_fn=loss, eval_fn=loss,
        optimizer=sgd(0.05),
        streams=[HostSlots(tr, parts, 4, seed=s, device=device)
                 for s in seeds],
        test_batch={"images": te.images[:32], "labels": te.labels[:32]},
        strategies=[common.make_ingraph_strategy(name, common.ExpConfig(
            n_nodes=n, k=2, seed=s), device) for s in seeds],
        cfg=RunnerConfig(n_nodes=n, rounds=11, eval_every=5),
        net=net, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morph", "static", "el-oracle"])
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_cuda_sweep_run_is_the_cpu_run(cuda_device, name, model):
    """A tiny sweep (E = 3, n = 6, 11 rounds) on the card and on the CPU:
    identical edges, comm bytes, parameters within 1e-5."""
    import numpy as np
    runs = [_tiny_sweep(d, name, model, (0, 1, 2))
            for d in (cuda_device, "cpu")]
    for r in runs:
        r.run()
    card, cpu = runs
    for e in range(3):
        assert all(np.array_equal(a, b) for a, b in
                   zip(card.edge_history[e], cpu.edge_history[e]))
        assert card.comm_bytes(e) == cpu.comm_bytes(e)
    for k in cpu.params:
        err = float((card.params[k].cpu() - cpu.params[k]).abs().max())
        assert err <= 1e-5, (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_cuda_stacked_step_is_each_experiments_step(cuda_device, model):
    """With deterministic cuDNN, one local step of the ``[E n]`` stack is
    each experiment's own step of its n rows, bit for bit (the grouped
    convolutions over E n groups keep each experiment's bits)."""
    torch.backends.cudnn.deterministic = True
    try:
        sweep = _tiny_sweep(cuda_device, "morph", model, (0, 1, 2))
        batch = sweep._batch(2)
        stacked, _ = sweep._step(batch)
        n = sweep.cfg.n_nodes
        for e in range(sweep.E):
            own, _ = sweep._local_step(sweep.experiment_params(e),
                                       sweep._opt_state,
                                       {k: v[e] for k, v in batch.items()})
            for k, v in own.items():
                assert torch.equal(stacked[k][e * n:(e + 1) * n], v), (e, k)
    finally:
        torch.backends.cudnn.deterministic = False


# The tuner's knobs on the card (``chip_smoke.py`` phase 15).

@pytest.mark.cuda
@pytest.mark.parametrize("entry", [
    dict(chunk=4, engine="sparse", compress="int8"),
    dict(chunk=3, engine="dense", compress="int8+topk0.5")])
def test_cuda_tune_auto_is_the_explicit_run(cuda_device, tmp_path,
                                            monkeypatch, entry):
    """A runner whose knobs are ``"auto"`` resolves them from a cache entry
    for its card shape and is bit for bit the runner given the values."""
    import dataclasses
    import numpy as np
    from repro_torch import tune as tt
    factory = tt.mlp_runner_factory(16, rounds=12, device=cuda_device)
    probe = factory(tt.Candidate())
    shape = tt.shape_of(probe.cfg, probe.params)
    assert shape.key() == "cuda|n=16|d=1580|devices=1|net=0"
    cache = tt.TuningCache()
    cache.put(shape, tt.TuneEntry(**entry))
    cache.save(tmp_path / "cache.json")

    def run(**knobs):
        runner = factory(tt.Candidate())
        runner.cfg = dataclasses.replace(runner.cfg, eval_every=5, **knobs)
        runner.run()
        return runner

    monkeypatch.setenv(tt.ENV_CACHE, str(tmp_path / "cache.json"))
    auto = run(chunk="auto", engine="auto", compress="auto")
    monkeypatch.delenv(tt.ENV_CACHE)
    explicit = run(**entry)
    assert auto.resolved_knobs.source == f"cache:{shape.key()}"
    assert auto.resolved_knobs.engine == entry["engine"]
    for k in auto.params:
        assert torch.equal(auto.params[k], explicit.params[k]), k
    assert all(np.array_equal(a, b) for a, b in
               zip(auto.edge_history, explicit.edge_history))
    assert [r.comm_bytes for r in auto.log.records] == \
        [r.comm_bytes for r in explicit.log.records]


@pytest.mark.cuda
def test_cuda_tune_sparse_engine_past_the_decode_limit(cuda_device):
    """fig12's sparse row past ``SPARSE_EDGE_DECODE_MAX`` nodes: the edge
    history keeps ``(idx, mask)`` pairs, one CSR launch a round, and a
    chunked run (``RunnerConfig.chunk``) gives the same bits."""
    import dataclasses
    import numpy as np
    from repro_torch.bench import fig12
    from repro_torch.dlrt.superstep import SPARSE_EDGE_DECODE_MAX
    n, rounds = SPARSE_EDGE_DECODE_MAX + 904, 6
    runs = []
    for chunk in (None, 4):
        runner = fig12.build(n, 3, "sparse", rounds, cuda_device)
        runner.cfg = dataclasses.replace(runner.cfg, chunk=chunk,
                                         eval_every=3)
        before = graph_mix_sparse.launches
        runner.run()
        assert graph_mix_sparse.launches - before == rounds
        runs.append(runner)
    whole, chunked = runs
    assert len(whole.edge_history) == rounds
    for (i1, m1), (i2, m2) in zip(whole.edge_history, chunked.edge_history):
        assert i1.shape == m1.shape == (n, 3)
        assert np.array_equal(i1, i2) and np.array_equal(m1, m2)
    for k in whole.params:
        assert torch.isfinite(whole.params[k]).all()
        assert torch.equal(whole.params[k], chunked.params[k]), k
    rec = whole.log.records[-1]
    idx, mask = whole.edge_history[-1]
    assert rec.isolated == int((~mask.any(axis=1)).sum())
    assert [r.comm_bytes for r in whole.log.records] == \
        [r.comm_bytes for r in chunked.log.records]


# The sharded superstep on the card (``chip_smoke.py`` phase 16): one NCCL
# rank, the mesh's own group.

@pytest.mark.cuda
@pytest.mark.parametrize("collective", ["gather", "psum"])
@pytest.mark.parametrize("name", ["morph", "static"])
def test_cuda_one_rank_sharded_run_is_the_run_without_a_mesh(
        cuda_device, name, collective):
    """``RunnerConfig(mesh_devices=1)`` on the card starts a one-rank NCCL
    group, runs the sharded engine through one grouped ``graph_mix``
    launch a round (and one Gram launch a refresh round for Morph) and
    destroys the group; against the same run without a mesh the edges are
    identical and the parameters bit for bit (Static's W reaches the same
    kernel both ways; Morph's masked and general mixes sum alike)."""
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch import tune as tt
    from repro_torch.kernels import reset_launches
    rounds = 12
    factory = tt.mlp_runner_factory(16, rounds=rounds, device=cuda_device)
    runs, counts = [], []
    for mesh in (None, 1):
        runner = factory(tt.Candidate())
        if name == "static":
            from repro_torch.core import InGraphStaticStrategy
            runner.strategy = InGraphStaticStrategy(n=16, degree=3, seed=0,
                                                    device=cuda_device)
        runner.cfg = dataclasses.replace(runner.cfg, eval_every=5,
                                         mesh_devices=mesh,
                                         collective=collective)
        reset_launches()
        runner.run()
        counts.append((gram_matrix.launches, graph_mix.launches,
                       graph_mix_masked.launches))
        runs.append(runner)
    assert not dist.is_initialized()
    plain, sharded = runs
    refreshes = sum(1 for r in range(rounds) if r % 5 == 0)
    gram = refreshes if name == "morph" else 0
    assert counts[1] == (gram, rounds, 0)
    assert all(np.array_equal(a, b) for a, b in
               zip(plain.edge_history, sharded.edge_history))
    for k in plain.params:
        assert torch.equal(plain.params[k], sharded.params[k]), k
    assert [r.comm_bytes for r in plain.log.records] == \
        [r.comm_bytes for r in sharded.log.records]


# The zoo's train step on a device mesh (``chip_smoke.py`` phase 21) at
# reduced widths: ``tests/_mesh_cases.py`` on the card.

MESH_BASE = {"n": 4, "batch": 2, "rounds": 3, "delta_r": 2,
             "microbatch": None, "opt": "sgd", "noise": None,
             "single": True, "device": "cuda"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,axes", [
    ("llama3.2-3b", ("data", "model")),
    ("jamba-1.5-large-398b", ("pod", "data", "model"))])
def test_cuda_mesh_step_on_one_rank_is_the_one_device_step(cuda_device,
                                                           arch, axes):
    """Reduced Llama (node_dp) and Jamba without experts (node_fsdp, the
    scan and its backward kernel inside) on a one-rank NCCL mesh, every
    axis of size 1: against the one-device step from the same state,
    losses, edges and parameters bit for bit and every kernel launched as
    often (the Gram and the masked mix among them)."""
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch.distributed as dist
    import _mesh_cases as mc
    case = dict(MESH_BASE, arch=arch, axes=axes, sizes=(1,) * len(axes),
                experts=False)
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=(Path(tmp) / "store")
                                .as_uri(), world_size=1, rank=0)
        try:
            got = mc.one_case(case)
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = False
    single = got["single"]
    for a, b in zip(got["record"], single["record"]):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    for k, v in single["params"].items():
        assert np.array_equal(got["params"][k], v), k
    assert got["launches"] == single["launches"]
    assert got["launches"]["gram_matrix"] and \
        got["launches"]["graph_mix_masked"]
    if arch.startswith("jamba"):
        assert got["launches"]["selective_scan_bwd"]


@pytest.mark.cuda
def test_cuda_mesh_step_on_four_ranks(cuda_device):
    """Reduced Llama at n = 4 on a (2, 2) mesh of four NCCL ranks (one a
    card): every rank the same edges and parameters; against the
    one-device step, edges identical and parameters within 1e-5."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one rank a card")
    import numpy as np
    import _mesh_cases as mc
    from repro_torch.launch import start
    case = dict(MESH_BASE, arch="llama3.2-3b", axes=("data", "model"),
                sizes=(2, 2))
    results = [r[0] for r in start(mc.rank_main, 4, [case]).join()]
    for other in results[1:]:
        for a, b in zip(other["record"], results[0]["record"]):
            for k in a:
                assert np.array_equal(a[k], b[k]), k
    got, single = results[0], results[0]["single"]
    for a, b in zip(got["record"], single["record"]):
        assert np.array_equal(a["edges"], b["edges"])
    for k, v in single["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


# The sweep farm on an ("exp", "data") mesh (``chip_smoke.py`` phase 23 runs
# the 1 x 1 mesh): ``tests/_sweep_mesh_cases.py`` on four NCCL ranks.
SWEEP_MESH_WORLDS = {(4, 1): ("mlp-morph-net", "cnn-morph-dr"),
                     (2, 2): ("cnn-morph-dr", "cnn-static", "mlp-morph-dr"),
                     (1, 4): ("cnn-static", "mlp-morph-dr")}


@pytest.mark.cuda
def test_cuda_sweep_mesh_on_four_ranks(cuda_device):
    """The sweep on four NCCL ranks (one a card) as (4, 1) under a network
    and as (2, 2) and (1, 4) without one, the tiny MLP and the reduced
    GN-LeNet, deterministic cuDNN: every rank the same; against the
    meshless sweep on card 0, edges, comm bytes and network counters
    identical, parameters and records bit for bit where only the
    experiments split (each experiment's stacked step keeps its bits,
    phase 14(a)), parameters within 1e-5 where the nodes split over
    ``data`` (grouped convolutions over fewer nodes)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one rank a card")
    import numpy as np
    import _sweep_mesh_cases as sc
    from repro_torch.launch import start
    torch.backends.cudnn.deterministic = True
    try:
        alone = {name: sc.run_case(sc.CASES[name], None, None,
                                   device=cuda_device)
                 for name in sorted({k for v in SWEEP_MESH_WORLDS.values()
                                     for k in v})}
        for sizes, names in SWEEP_MESH_WORLDS.items():
            jobs = [(k, sc.CASES[k], None, None) for k in names]
            per_rank = [r[0] for r in start(sc.rank_main, 4, sizes, jobs,
                                             (), "cuda").join()]
            for name in names:
                got, want = per_rank[0][name], alone[name]
                for other in per_rank[1:]:
                    np.testing.assert_array_equal(other[name]["edges"],
                                                  got["edges"])
                    for k, v in got["params"].items():
                        assert np.array_equal(other[name]["params"][k], v)
                    assert other[name]["records"] == got["records"]
                np.testing.assert_array_equal(got["edges"], want["edges"])
                assert got["comm_bytes"] == want["comm_bytes"]
                assert got["net_stats"] == want["net_stats"]
                tol = 0.0 if sizes[1] == 1 else 1e-5
                for k, v in want["params"].items():
                    np.testing.assert_allclose(got["params"][k], v, atol=tol,
                                               rtol=0, err_msg=(sizes, k))
                if tol == 0.0:
                    assert got["records"] == want["records"], (sizes, name)
                else:
                    assert [[r[:3] for r in log] for log in got["records"]] \
                        == [[r[:3] for r in log]
                            for log in want["records"]], (sizes, name)
    finally:
        torch.backends.cudnn.deterministic = False


# The zoo's serve step and prefill on a device mesh (``chip_smoke.py``
# phase 22) at reduced widths: ``tests/_mesh_serve_cases.py`` on the card,
# 16 tokens decoded from position 0 and prefilled, 4 requests a node.

SERVE_MESH_BASE = {"n": 2, "b": 4, "steps": 16, "max_len": 16,
                   "prefill": True, "device": "cuda"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,axes", [
    ("llama3.2-3b", ("data", "model")),
    ("jamba-1.5-large-398b", ("pod", "data", "model"))])
def test_cuda_serve_mesh_on_one_rank_is_the_one_device_step(cuda_device,
                                                            arch, axes):
    """Reduced Llama (node_dp) and Jamba without experts (node_fsdp, the
    scan inside its prefill) on a one-rank NCCL mesh, every axis of size
    1: the mesh serve step's logits and caches and the mesh prefill bit
    for bit the one-device step's and prefill's, every kernel launched as
    often (Jamba's prefill: one scan launch a Mamba layer a node)."""
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch.distributed as dist
    import _mesh_serve_cases as sc
    case = dict(SERVE_MESH_BASE, arch=arch, axes=axes,
                sizes=(1,) * len(axes), experts=False)
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=(Path(tmp) / "store")
                                .as_uri(), world_size=1, rank=0)
        try:
            got = sc.serve(case)
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = False
    one = sc.one_device(case)
    assert np.array_equal(got["logits"], one["logits"])
    assert np.array_equal(got["prefill"], one["prefill"])
    for k, v in one["cache"].items():
        assert np.array_equal(got["cache"][k], v), k
    assert got["launches"] == one["launches"]
    assert got["prefill_launches"] == one["prefill_launches"]
    cfg = sc.config(case)
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.num_periods
    assert got["prefill_launches"]["selective_scan"] == case["n"] * mamba


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b"])
def test_cuda_serve_mesh_on_four_ranks(cuda_device, arch):
    """Reduced Llama (node_dp, head_dim over ``model``) and Jamba with its
    experts (node_fsdp, each node's batch over ``data``) at n = 2 on a
    (2, 2) mesh of four NCCL ranks (one a card): every rank the same
    logits; against the one-device step, logits and prefill within 1e-4."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one rank a card")
    import numpy as np
    import _mesh_serve_cases as sc
    from repro_torch.launch import start
    case = dict(SERVE_MESH_BASE, arch=arch, axes=("data", "model"),
                sizes=(2, 2), single=True)
    results = [r[0] for r in start(sc.rank_main, 4, [case]).join()]
    for other in results[1:]:
        assert np.array_equal(other["logits"], results[0]["logits"])
    got, single = results[0], results[0]["single"]
    np.testing.assert_allclose(got["logits"], single["logits"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got["prefill"], single["prefill"],
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_fig10_refuses_more_ranks_than_cards(cuda_device, capsys):
    """NCCL takes one rank a card: fig10 stops before starting a child,
    with the reference's error line and status 3."""
    from repro_torch.bench import fig10
    have = torch.cuda.device_count()
    with pytest.raises(SystemExit) as stop:
        fig10.main(["--devices", "1", str(have + 1), "--nodes", "8",
                    "--rounds", "2", "--chunk", "2"])
    assert stop.value.code == 3
    assert f"fig10_error,need_{have + 1}_devices,have_{have}" in \
        capsys.readouterr().err


# ---------------------------------------------------------------------------
# The scan's backward and the model zoo's train step.
# ---------------------------------------------------------------------------

# The backward kernel against autograd through the plain scan: each
# gradient within 1e-4 of its largest magnitude plus 1e-4 relative.  The
# two differ where their exp does (as the forward) and in the order of
# their sums: over the d_state states (dx, ddt), over the channels (db,
# dc: up to 16,384 terms), over batch and time (da); gradients in bf16 (the
# inputs' type) may also round one bf16 ulp apart.
SCAN_BWD_TOL = 1e-4
BF16_ULP = 2.0 ** -7
SCAN_GRADS = ("dx", "ddt", "db", "dc", "da", "dh0")


def assert_scan_grads_close(got, want):
    for name, g, w in zip(SCAN_GRADS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        rtol = SCAN_BWD_TOL + (BF16_ULP if g.dtype == torch.bfloat16
                               else 0.0)
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=SCAN_BWD_TOL * scale, rtol=rtol,
                                   msg=name)


# The backward's own edges: L of one step, one 8-step window, one past
# it, one short of, at and one past the forward's 32-step tile, two
# windows; d_inner 1, and one past a block's channels (64 at d_state 16,
# 128 at 8, 256 at 4); then whole blocks at d_state 4 with an odd L over
# two batches, whose second batch's b and c rows (8 bytes each in bf16)
# start 8 bytes off a 16-byte boundary while x's rows are aligned.
SCAN_BWD_SHAPES = [(1, 1, 64, 16), (2, 8, 64, 16), (1, 9, 64, 16),
                   (2, 31, 64, 16), (1, 32, 64, 16), (2, 33, 64, 16),
                   (1, 16, 64, 16), (2, 33, 1, 16), (1, 9, 1, 4),
                   (2, 17, 65, 16), (1, 9, 129, 8), (1, 9, 257, 4),
                   (2, 9, 256, 4), (2, 33, 512, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("bt,L,di,ds", SCAN_SHAPES + SCAN_BWD_SHAPES)
@pytest.mark.parametrize("types", sorted(SCAN_TYPES))
def test_cuda_selective_scan_backward_matches_plain(cuda_device, bt, L, di,
                                                    ds, types):
    from repro_torch.kernels import selective_scan_bwd
    from repro_torch.kernels.selective_scan import _forward
    gen = torch.Generator(device=cuda_device).manual_seed(bt * L + di + 1)
    args = scan_inputs(cuda_device, gen, bt, L, di, ds, SCAN_TYPES[types])
    _, _, tiles = _forward(*args, keep_tiles=True)
    dy = torch.randn((bt, L, di), generator=gen, device=cuda_device)
    dh = torch.randn((bt, di, ds), generator=gen, device=cuda_device) * 0.1
    for last in (dh, None):
        before = selective_scan_bwd.launches
        got = selective_scan_bwd(*args, dy, last, tiles)
        want = ref.selective_scan_bwd(*args, dy, last)
        torch.cuda.synchronize()
        assert selective_scan_bwd.launches == before + 1
        assert_scan_grads_close(got, want)
        again = selective_scan_bwd(*args, dy, last, tiles)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_scan_autograd_takes_the_backward_kernel(cuda_device):
    """Autograd through ``selective_scan`` on the card: one forward launch
    keeping the tile states and one backward launch, the kernel's
    gradients."""
    from repro_torch.kernels import selective_scan_bwd
    from repro_torch.kernels.selective_scan import _forward
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    args = scan_inputs(cuda_device, gen, 2, 70, 300, 16,
                       SCAN_TYPES["serving"])
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    dy = torch.randn((2, 70, 300), generator=gen, device=cuda_device)
    fwd, bwd = selective_scan.launches, selective_scan_bwd.launches
    y, _ = selective_scan(*leaves, args[5])
    y.backward(dy)
    assert (selective_scan.launches - fwd,
            selective_scan_bwd.launches - bwd) == (1, 1)
    _, _, tiles = _forward(*args, keep_tiles=True)
    want = selective_scan_bwd(*args, dy, None, tiles)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def _train_config(arch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(
            cfg, moe=None, pattern=tuple(dataclasses.replace(s, moe=False)
                                         for s in cfg.pattern))
    return cfg.reduced()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-1.5-large-398b"])
def test_cuda_train_round_is_the_cpu_round(cuda_device, arch):
    """One reduced train round with a topology negotiation from the same
    state on the card and on the CPU: identical edges, parameters within
    1e-4; on the card one Gram launch per 32 leaves, one masked-mix launch
    per 64 (the leaves are one group), and one scan and one scan backward
    per Mamba layer and node."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.dlrt import (MorphHParams, init_train_state,
                                  make_train_step, train_state_to)
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    cfg = _train_config(arch)
    n = 4
    cpu = init_train_state(cfg, sgd(0.05), n, seed=3, device="cpu")
    card = train_state_to(cpu, cuda_device)
    step = make_train_step(cfg, sgd(0.05), MorphHParams(k=2, view_size=3))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (n, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    cpu, m_cpu = step(cpu, batch)
    kernels.reset_launches()
    card, m_card = step(card, batch)
    torch.cuda.synchronize()
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.num_periods
    got = {k.__name__: k.launches for k in kernels.KERNELS}
    want = dict.fromkeys(got, 0)
    leaves = len(flatten(cpu.params))
    want.update(gram_matrix=-(-leaves // 32),
                graph_mix_masked=-(-leaves // 64),
                selective_scan=n * mamba, selective_scan_bwd=n * mamba)
    assert got == want
    assert torch.equal(card.morph.edges.cpu(), cpu.morph.edges)
    torch.testing.assert_close(m_card["per_node_loss"].cpu(),
                               m_cpu["per_node_loss"], atol=1e-5, rtol=1e-5)
    want_p = flatten(cpu.params)
    for k, v in flatten(card.params).items():
        torch.testing.assert_close(v.cpu(), want_p[k], atol=1e-4, rtol=0,
                                   msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_cuda_moe_and_rwkv_are_the_cpu(cuda_device, arch):
    """Reduced DeepSeek-MoE, RWKV-6 and Jamba with its experts (f32) from
    one set of parameters on the card and on the CPU: logits and the MoE
    aux term within 1e-4, 8 greedy tokens identical; then one train round
    with a topology negotiation from one state: identical edges,
    parameters within 1e-4, one Gram launch per 32 leaves and one
    masked-mix launch per 64, and Jamba's scans."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.dlrt import (MorphHParams, init_train_state,
                                  make_train_step, train_state_to)
    from repro_torch.models import model
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten, tree_map
    cfg = get_config(arch).reduced()
    cpu_p = model.init_params(cfg, 4, device="cpu")
    card_p = tree_map(lambda t: t.to(cuda_device), cpu_p)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(4))
    want, want_aux = model.forward(cpu_p, {"tokens": tokens}, cfg)
    got, aux = model.forward(card_p, {"tokens": tokens.to(cuda_device)}, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-4, rtol=0)
    assert torch.equal(
        model.greedy_generate(card_p, cfg, tokens[:, :8].to(cuda_device),
                              8).cpu(),
        model.greedy_generate(cpu_p, cfg, tokens[:, :8], 8))
    n = 4
    cpu = init_train_state(cfg, sgd(0.05), n, seed=3, device="cpu")
    card = train_state_to(cpu, cuda_device)
    step = make_train_step(cfg, sgd(0.05), MorphHParams(k=2, view_size=3))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (n, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    cpu, _ = step(cpu, batch)
    kernels.reset_launches()
    card, _ = step(card, batch)
    torch.cuda.synchronize()
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.num_periods
    got = {k.__name__: k.launches for k in kernels.KERNELS}
    leaves = len(flatten(cpu.params))
    want = dict(dict.fromkeys(got, 0), gram_matrix=-(-leaves // 32),
                graph_mix_masked=-(-leaves // 64),
                selective_scan=n * mamba, selective_scan_bwd=n * mamba)
    assert got == want
    assert torch.equal(card.morph.edges.cpu(), cpu.morph.edges)
    want_p = flatten(cpu.params)
    for k, v in flatten(card.params).items():
        torch.testing.assert_close(v.cpu(), want_p[k], atol=1e-4, rtol=0,
                                   msg=k)


@pytest.mark.cuda
def test_cuda_eq3_over_leaves_of_two_dtypes(cuda_device):
    """A bf16 model's f32 leaves (Mamba's ``A_log`` and ``D``): Eq. 3 takes
    one grouped Gram launch per dtype and gives the CPU's leaf-by-leaf
    mean within the cosine's tolerance."""
    gen = torch.Generator().manual_seed(12)
    stacked = {"a": torch.randn((8, 1000), generator=gen).bfloat16(),
               "b": torch.randn((8, 64), generator=gen),
               "c": torch.randn((8, 4099), generator=gen).bfloat16()}
    want = ops.model_pairwise_cosine(stacked)
    before = gram_matrix.launches
    got = ops.model_pairwise_cosine({k: v.to(cuda_device)
                                     for k, v in stacked.items()})
    torch.cuda.synchronize()
    assert gram_matrix.launches == before + 2
    torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_cuda_frontends_are_the_cpu(cuda_device, arch):
    """Reduced Whisper (its encoder over 16 frames) and Pixtral (4 patch
    embeddings before the text), f32, from one set of parameters on the
    card and on the CPU: logits within 1e-4 and 8 greedy tokens
    identical."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import frontend_inputs
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    cpu_p = model.init_params(cfg, 6, device="cpu")
    card_p = tree_map(lambda t: t.to(cuda_device), cpu_p)
    gen = torch.Generator().manual_seed(6)
    batch = dict(frontend_inputs(cfg, (2,), gen),
                 tokens=torch.randint(0, cfg.vocab_size, (2, 32),
                                      generator=gen))
    want, _ = model.forward(cpu_p, batch, cfg)
    got, _ = model.forward(card_p, {k: v.to(cuda_device)
                                    for k, v in batch.items()}, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    prompt = batch["tokens"][:, :8]
    assert torch.equal(
        model.greedy_generate(card_p, cfg, prompt.to(cuda_device), 8).cpu(),
        model.greedy_generate(cpu_p, cfg, prompt, 8))


@pytest.mark.cuda
def test_cuda_whisper_train_round_launches_gram_and_mix(cuda_device):
    """One train round of reduced Whisper (f32, n = 4) with its ``frames``
    and a topology negotiation, from one state on the card and on the
    CPU: one Gram launch per 32 leaves and one masked-mix launch per 64,
    nothing else; identical edges, parameters within 1e-4."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.dlrt import (MorphHParams, init_train_state,
                                  make_train_step, train_state_to)
    from repro_torch.launch.shapes import frontend_inputs
    from repro_torch.optim import sgd
    from repro_torch.tree import flatten
    cfg = get_config("whisper-tiny").reduced()
    n = 4
    cpu = init_train_state(cfg, sgd(0.05), n, seed=7, device="cpu")
    card = train_state_to(cpu, cuda_device)
    step = make_train_step(cfg, sgd(0.05), MorphHParams(k=2, view_size=3))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (n, 2, 33)).astype(np.int32)
    batch = dict(frontend_inputs(cfg, (n, 2), torch.Generator()
                                  .manual_seed(7)),
                 tokens=toks[..., :-1], labels=toks[..., 1:])
    cpu, _ = step(cpu, batch)
    kernels.reset_launches()
    card, _ = step(card, batch)
    torch.cuda.synchronize()
    got = {k.__name__: k.launches for k in kernels.KERNELS}
    leaves = len(flatten(cpu.params))
    assert got == dict(dict.fromkeys(got, 0), gram_matrix=-(-leaves // 32),
                       graph_mix_masked=-(-leaves // 64))
    assert torch.equal(card.morph.edges.cpu(), cpu.morph.edges)
    want_p = flatten(cpu.params)
    for k, v in flatten(card.params).items():
        torch.testing.assert_close(v.cpu(), want_p[k], atol=1e-4, rtol=0,
                                   msg=k)
