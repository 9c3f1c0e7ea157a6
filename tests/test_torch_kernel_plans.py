"""Launch planning of the grouped graph-mix, CSR-mix and Gram kernels, on
the CPU.

A grouped call numbers the work of every leaf in one launch.  These tests
hold the pure-Python plans (``plan_mix``, ``plan_tiled``, ``plan_sparse``,
``plan_gram``) to what the kernels rely on: every column of every leaf is
mixed exactly once (every row too past 128 nodes, every receiver in the
CSR mix), the tiled route's row tiles of a column stripe and the CSR
mix's receiver groups of a stripe come one after another, every Gram tile
``i <= j`` is computed exactly once and its splits cover D exactly once,
and a leaf's plan does not depend on the other leaves of the call (so a
grouped call gives each leaf the bits of a call of its own).  They also
check the tables the wrappers hand to the C functions, with the library
faked, and that the CPU forms of the grouped wrappers are the per-leaf
plain versions, bit for bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import (  # noqa: E402
    cuda, graph_mix, graph_mix_leaves, graph_mix_masked,
    graph_mix_masked_leaves, graph_mix_sparse, graph_mix_sparse_leaves,
    gram_matrices, gram_matrix, ops, ref)
from repro_torch.kernels import pairwise_cosine as pc  # noqa: E402

# The package's ``graph_mix`` and ``graph_mix_sparse`` are the wrappers;
# their modules hold the plans.
gm_mod = importlib.import_module("repro_torch.kernels.graph_mix")
gs_mod = importlib.import_module("repro_torch.kernels.graph_mix_sparse")

# GN-LeNet CIFAR-10 at width 32: its ten leaves' widths per node.
GN_LENET = [32, 2400, 64, 51200, 10, 40960, 32, 32, 64, 64]
RAGGED = [1, 10, 129, 8199]
LEAF_SETS = {"gn_lenet": GN_LENET, "ragged": RAGGED,
             "mixed": [0, 129, 1, 64, 65, 8199, 0]}
NODES = [7, 50, 100, 129]
SMS = [132, 114, 8]
# Rows (m) of the tiled route: past 128, one row tile, several, ragged.
TILED_ROWS = [129, 200, 1000]
# CSR populations and element sizes (f32, bf16).
SPARSE_NODES = [7, 50, 1000]
ITEMSIZES = [4, 2]


def _cover(spans, d):
    """How often each of D's columns is covered by ``spans``."""
    seen = np.zeros(d, dtype=int)
    for begin, end in spans:
        assert 0 <= begin <= end <= d
        seen[begin:end] += 1
    return seen


@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_mix_items_cover_every_column_once(leaves):
    ds = LEAF_SETS[leaves]
    firsts = gm_mod.plan_mix(ds)
    spans = {i: [] for i in range(len(ds))}
    for leaf, c0, c1 in gm_mod.mix_items(ds, firsts):
        assert c1 > c0 and c0 % gm_mod.COLS == 0
        spans[leaf].append((c0, c1))
    for i, d in enumerate(ds):
        assert (_cover(spans[i], d) == 1).all()


@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_mix_plan_of_a_leaf_does_not_depend_on_the_others(leaves):
    ds = LEAF_SETS[leaves]
    firsts = gm_mod.plan_mix(ds)
    for i, d in enumerate(ds):
        alone = list(gm_mod.mix_items([d], gm_mod.plan_mix([d])))
        grouped = [(c0, c1) for leaf, c0, c1 in gm_mod.mix_items(ds, firsts)
                   if leaf == i]
        assert grouped == [(c0, c1) for _, c0, c1 in alone]


@pytest.mark.parametrize("m", TILED_ROWS)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_tiled_items_cover_every_row_and_column_once(leaves, m):
    ds = LEAF_SETS[leaves]
    firsts = gm_mod.plan_tiled(m, ds)
    seen = [np.zeros((m, d), dtype=int) for d in ds]
    for leaf, r0, r1, c0, c1 in gm_mod.tiled_items(m, ds, firsts):
        assert r1 > r0 and c1 > c0
        assert r0 % gm_mod.TILE == 0 and c0 % gm_mod.TILE == 0
        seen[leaf][r0:r1, c0:c1] += 1
    for cover in seen:
        assert (cover == 1).all()


@pytest.mark.parametrize("m", TILED_ROWS)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_tiled_items_run_the_row_tiles_of_a_stripe_together(leaves, m):
    """Leaf after leaf, stripe after stripe, and inside a stripe its row
    tiles in row order: the items of one stripe are consecutive."""
    ds = LEAF_SETS[leaves]
    order = [(leaf, c0, r0) for leaf, r0, _, c0, _ in
             gm_mod.tiled_items(m, ds, gm_mod.plan_tiled(m, ds))]
    assert order == sorted(order)
    row_tiles = -(-m // gm_mod.TILE)
    for at in range(0, len(order), row_tiles):
        stripe = order[at:at + row_tiles]
        assert len({(leaf, c0) for leaf, c0, _ in stripe}) == 1
        assert [r0 for _, _, r0 in stripe] == \
            [t * gm_mod.TILE for t in range(row_tiles)]


@pytest.mark.parametrize("m", TILED_ROWS)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_tiled_plan_of_a_leaf_does_not_depend_on_the_others(leaves, m):
    ds = LEAF_SETS[leaves]
    firsts = gm_mod.plan_tiled(m, ds)
    grouped = list(gm_mod.tiled_items(m, ds, firsts))
    for i, d in enumerate(ds):
        alone = [item[1:] for item in
                 gm_mod.tiled_items(m, [d], gm_mod.plan_tiled(m, [d]))]
        assert [item[1:] for item in grouped if item[0] == i] == alone


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", SPARSE_NODES)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_sparse_items_cover_every_receiver_and_column_once(leaves, n,
                                                           itemsize):
    ds = LEAF_SETS[leaves]
    firsts = gs_mod.plan_sparse(n, ds, itemsize)
    width = gs_mod.stripe_cols(itemsize)
    assert width * itemsize == 32 * 16
    seen = [np.zeros((n, d), dtype=int) for d in ds]
    for leaf, c0, c1, r0, r1 in gs_mod.sparse_items(n, ds, firsts,
                                                    itemsize):
        assert c1 > c0 and c0 % width == 0
        assert 0 < r1 - r0 <= gs_mod.RECEIVERS
        seen[leaf][r0:r1, c0:c1] += 1
    for cover in seen:
        assert (cover == 1).all()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", SPARSE_NODES)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_sparse_items_come_in_stripe_order(leaves, n, itemsize):
    """Every receiver group of a stripe comes before the next stripe: the
    items are sorted by (leaf, stripe, receiver), and each stripe's run
    of items holds all n receivers."""
    ds = LEAF_SETS[leaves]
    items = list(gs_mod.sparse_items(n, ds, gs_mod.plan_sparse(
        n, ds, itemsize), itemsize))
    order = [(leaf, c0, r0) for leaf, c0, _, r0, _ in items]
    assert order == sorted(order)
    groups = -(-n // gs_mod.RECEIVERS)
    for at in range(0, len(items), groups):
        stripe = items[at:at + groups]
        assert len({(leaf, c0) for leaf, c0, _, _, _ in stripe}) == 1
        assert sum(r1 - r0 for _, _, _, r0, r1 in stripe) == n


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", SPARSE_NODES)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_sparse_plan_of_a_leaf_does_not_depend_on_the_others(leaves, n,
                                                             itemsize):
    ds = LEAF_SETS[leaves]
    grouped = list(gs_mod.sparse_items(
        n, ds, gs_mod.plan_sparse(n, ds, itemsize), itemsize))
    for i, d in enumerate(ds):
        alone = [item[1:] for item in gs_mod.sparse_items(
            n, [d], gs_mod.plan_sparse(n, [d], itemsize), itemsize)]
        assert [item[1:] for item in grouped if item[0] == i] == alone


@pytest.mark.parametrize("n", NODES)
def test_gram_tiles_upper_triangle_once(n):
    t = -(-n // pc.TILE)
    tiles = pc.gram_tiles(n)
    assert len(tiles) == len(set(tiles)) == t * (t + 1) // 2
    assert all(0 <= i <= j < t for i, j in tiles)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_gram_splits_cover_d_once(leaves, n, sms):
    for d in LEAF_SETS[leaves]:
        clusters, split_len = pc.leaf_split(n, d, sms)
        assert clusters >= 1 and split_len % pc.DEPTH == 0
        splits = pc.gram_splits(d, clusters, split_len)
        assert len(splits) == clusters * pc.CLUSTER
        assert (_cover(splits, d) == 1).all()
        # Splits follow each other in D order; only trailing ones are empty.
        ends = [end for _, end in splits]
        assert ends == sorted(ends) and splits[0][0] == 0
        # About one block per SM for the leaf's tiles, never fewer than one
        # cluster per tile.
        blocks = clusters * pc.CLUSTER * len(pc.gram_tiles(n))
        assert clusters == 1 or blocks <= sms


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("leaves", sorted(LEAF_SETS))
def test_gram_plan_of_a_leaf_does_not_depend_on_the_others(leaves, n, sms):
    ds = LEAF_SETS[leaves]
    plans, scratch, tickets = pc.plan_gram(n, ds, sms)
    tiles = len(pc.gram_tiles(n))
    clusters = scratch_at = ticket_at = 0
    for d, p in zip(ds, plans):
        (alone,), alone_scratch, alone_tickets = pc.plan_gram(n, [d], sms)
        assert (p.d, p.clusters, p.split_len) == \
            (alone.d, alone.clusters, alone.split_len)
        # Each leaf's clusters, sums and tickets follow the last leaf's.
        assert (p.cluster0, p.scratch0, p.ticket0) == \
            (clusters, scratch_at, ticket_at)
        clusters += tiles * p.clusters
        scratch_at += alone_scratch
        ticket_at += alone_tickets
    assert (scratch, tickets) == (scratch_at, ticket_at)


class _FakeLibrary:
    """Records each C call's arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.fixture
def fake_cuda(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda, "library", lambda *a: lib)
    monkeypatch.setattr(cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(cuda, "sm_count", lambda device: 132)
    return lib


def _table(arg, count, width):
    return np.array(list(arg)).reshape(count, width)


def test_grouped_mix_is_one_launch_with_the_planned_table(fake_cuda):
    n, ds = 50, GN_LENET
    xs = [torch.empty((n, d), device="meta") for d in ds]
    w = torch.empty((n, n), device="meta")
    e = torch.empty((n, n), dtype=torch.bool, device="meta")
    before = (graph_mix.launches, graph_mix_masked.launches)
    ys = graph_mix_leaves(w, xs)
    zs = graph_mix_masked_leaves(e, xs)
    assert [tuple(y.shape) for y in ys + zs] == [(n, d) for d in ds] * 2
    assert (graph_mix.launches - before[0],
            graph_mix_masked.launches - before[1]) == (1, 1)
    (fn1, args1), (fn2, args2) = fake_cuda.calls
    assert (fn1, fn2) == ("graph_mix_f32", "graph_mix_masked_f32")
    assert args1[1:5] == (len(ds), n, n, 132)
    assert args2[1:4] == (len(ds), n, 132)
    for args, src in ((args1, w), (args2, e)):
        table = _table(args[0], len(ds), 5)
        # A solo call names its one W (or E) on every row.
        assert table[:, 0].tolist() == [src.data_ptr()] * len(ds)
        assert table[:, 3].tolist() == ds
        assert table[:, 4].tolist() == gm_mod.plan_mix(ds)


@pytest.mark.parametrize("n", TILED_ROWS)
def test_grouped_mix_past_128_nodes_counts_a_launch_per_leaf(fake_cuda, n):
    """Past 128 nodes (the tiled route) a grouped call is one launch over
    every leaf too, counted once, with the tiled route's plan in its
    table; the name is from when that route launched once per leaf."""
    ds = GN_LENET + [0]
    xs = [torch.empty((n, d), device="meta") for d in ds]
    w = torch.empty((n, n), device="meta")
    e = torch.empty((n, n), dtype=torch.bool, device="meta")
    before = (graph_mix.launches, graph_mix_masked.launches)
    graph_mix_leaves(w, xs)
    graph_mix_masked_leaves(e, xs)
    assert (graph_mix.launches - before[0],
            graph_mix_masked.launches - before[1]) == (1, 1)
    (fn1, args1), (fn2, args2) = fake_cuda.calls
    assert (fn1, fn2) == ("graph_mix_f32", "graph_mix_masked_f32")
    assert args1[1:4] == (len(ds), n, n) and args2[1:3] == (len(ds), n)
    for args in (args1, args2):
        table = _table(args[0], len(ds), 5)
        assert table[:, 3].tolist() == ds
        assert table[:, 4].tolist() == gm_mod.plan_tiled(n, ds)


@pytest.mark.parametrize("n", [50, 200])
def test_grouped_mix_rows_carry_each_leafs_w(fake_cuda, n):
    """Given one W (or E) per leaf, each row of the C table names its
    leaf's own; the rest of the table is the one-W call's."""
    ds = GN_LENET[:4]
    xs = [torch.empty((n, d), device="meta") for d in ds]
    ws = [torch.empty((n, n)) for _ in ds]
    es = [torch.empty((n, n), dtype=torch.bool) for _ in ds]
    graph_mix_leaves(ws, xs)
    graph_mix_masked_leaves(es, xs)
    plan = gm_mod.plan_tiled(n, ds) if n > gm_mod.SMALL_NODES \
        else gm_mod.plan_mix(ds)
    for (_, args), mats in zip(fake_cuda.calls, (ws, es)):
        table = _table(args[0], len(ds), 5)
        assert table[:, 0].tolist() == [m.data_ptr() for m in mats]
        assert table[:, 3].tolist() == ds
        assert table[:, 4].tolist() == plan
    with pytest.raises(ValueError, match="3 matrices for 4 leaves"):
        graph_mix_leaves(ws[:3], xs)


@pytest.mark.parametrize("E", [3, 8])
def test_sweep_mix_is_one_launch_per_max_leaves(fake_cuda, E):
    """A sweep's ``[E, n, ...]`` stack mixes every leaf of every
    experiment in ceil(E L / MAX_LEAVES) launches, experiment e's rows
    naming its own W (or E) and writing into its slice of the outputs."""
    n, ds = 50, GN_LENET
    stacked = {str(i): torch.empty((E, n, d), device="meta")
               for i, d in enumerate(ds)}
    w = torch.rand((E, n, n))
    e = torch.rand((E, n, n)) < 0.2
    before = (graph_mix.launches, graph_mix_masked.launches)
    mixed = ops.mix_pytree(w, stacked)
    masked = ops.mix_masked_pytree(e, stacked)
    assert all(tuple(mixed[k].shape) == tuple(masked[k].shape)
               == tuple(v.shape) for k, v in stacked.items())
    L = len(ds)
    launches = -(-E * L // gm_mod.MAX_LEAVES)
    assert (graph_mix.launches - before[0],
            graph_mix_masked.launches - before[1]) == (launches, launches)
    assert len(fake_cuda.calls) == 2 * launches
    for calls, mats in ((fake_cuda.calls[:launches], w),
                        (fake_cuda.calls[launches:], e)):
        rows = np.concatenate([_table(args[0], args[1], 5)
                               for _, args in calls])
        want = [mats[x].data_ptr() for x in range(E) for _ in ds]
        assert rows[:, 0].tolist() == want
        assert rows[:, 3].tolist() == ds * E
        # Each launch plans its own leaves.
        at = 0
        for _, args in calls:
            widths = rows[at:at + args[1], 3].tolist()
            assert rows[at:at + args[1], 4].tolist() == \
                gm_mod.plan_mix(widths)
            at += args[1]


def test_sweep_similarity_is_one_gram_launch_per_max_leaves(fake_cuda):
    E, n, ds = 8, 50, GN_LENET
    stacked = {str(i): torch.empty((E, n, d), device="meta")
               for i, d in enumerate(ds)}
    before = gram_matrix.launches
    sim = ops.model_pairwise_cosine(stacked, experiments=True)
    assert tuple(sim.shape) == (E, n, n)
    assert gram_matrix.launches - before == -(-E * len(ds) // pc.MAX_LEAVES)


def test_grouped_mix_of_empty_leaves_launches_nothing(fake_cuda):
    xs = [torch.empty((200, 0), device="meta")] * 3
    before = graph_mix.launches
    ys = graph_mix_leaves(torch.empty((200, 200), device="meta"), xs)
    assert [tuple(y.shape) for y in ys] == [(200, 0)] * 3
    assert graph_mix.launches == before
    assert len(fake_cuda.calls) == 1     # the C side finds no item


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [50, 1000])
def test_grouped_csr_is_one_launch_with_the_planned_table(fake_cuda, n,
                                                          dtype):
    ds, k = GN_LENET, 3
    xs = [torch.empty((n, d), dtype=getattr(torch, dtype), device="meta")
          for d in ds]
    idx = torch.empty((n, k), dtype=torch.int32, device="meta")
    w = torch.empty((n, k), device="meta")
    w_self = torch.empty((n,), device="meta")
    before = graph_mix_sparse.launches
    ys = graph_mix_sparse_leaves(idx, w, w_self, xs)
    assert [(tuple(y.shape), y.dtype) for y in ys] == \
        [((n, d), xs[0].dtype) for d in ds]
    assert graph_mix_sparse.launches - before == 1
    ((fn, args),) = fake_cuda.calls
    suffix = "f32" if dtype == "float32" else "bf16"
    assert fn == f"graph_mix_sparse_{suffix}"
    assert args[4:9] == (len(ds), n, k, 0, 132)
    table = _table(args[3], len(ds), 4)
    assert table[:, 2].tolist() == ds
    assert table[:, 3].tolist() == gs_mod.plan_sparse(
        n, ds, xs[0].element_size())


@pytest.mark.parametrize("self0", [None, 0, 7])
def test_csr_block_and_push_partials_pass_their_own_rows(fake_cuda, self0):
    """A receiver block over a larger population gives the kernel its own
    rows' offset and ``[n, D]`` outputs planned over its n receivers;
    push partials (``self0=None``) give -1 and no ``w_self``; a block
    that runs past the population is refused."""
    n, m, k = 9, 16, 2
    xs = [torch.empty((m, d), device="meta") for d in (64, 10)]
    idx = torch.empty((n, k), dtype=torch.int32, device="meta")
    w = torch.empty((n, k), device="meta")
    w_self = None if self0 is None else torch.empty((n,), device="meta")
    ys = graph_mix_sparse_leaves(idx, w, w_self, xs, self0=self0)
    assert [tuple(y.shape) for y in ys] == [(n, 64), (n, 10)]
    ((_, args),) = fake_cuda.calls
    assert args[4:9] == (2, n, k, -1 if self0 is None else self0, 132)
    assert (args[2] is None) == (self0 is None)
    table = _table(args[3], 2, 4)
    assert table[:, 3].tolist() == gs_mod.plan_sparse(n, [64, 10], 4)
    with pytest.raises(ValueError, match="self0"):
        graph_mix_sparse_leaves(idx, w, torch.empty((n,), device="meta"),
                                xs, self0=m - n + 1)


def test_grouped_csr_splits_past_max_leaves(fake_cuda):
    n, k = 9, 2
    xs = [torch.empty((n, 64), device="meta")] * (gs_mod.MAX_LEAVES + 3)
    idx = torch.empty((n, k), dtype=torch.int32, device="meta")
    w = torch.empty((n, k), device="meta")
    before = graph_mix_sparse.launches
    graph_mix_sparse_leaves(idx, w, torch.empty((n,), device="meta"), xs)
    assert graph_mix_sparse.launches - before == 2
    assert [args[4] for _, args in fake_cuda.calls] == [gs_mod.MAX_LEAVES,
                                                        3]


def test_sparse_parameter_dict_mix_is_one_grouped_call(fake_cuda):
    n, k = 50, 3
    stacked = {f"leaf{i}": torch.empty((n, d), device="meta")
               for i, d in enumerate(GN_LENET)}
    stacked["conv"] = torch.empty((n, 4, 3, 5), device="meta")
    idx = torch.empty((n, k), dtype=torch.int64, device="meta")
    w = torch.empty((n, k), device="meta")
    before = graph_mix_sparse.launches
    mixed = ops.mix_sparse_pytree(idx, w, torch.empty((n,), device="meta"),
                                  stacked)
    assert graph_mix_sparse.launches - before == 1
    assert {k: v.shape for k, v in mixed.items()} == \
        {k: v.shape for k, v in stacked.items()}
    ((fn, args),) = fake_cuda.calls
    table = _table(args[3], len(stacked), 4)
    assert table[:, 2].tolist() == GN_LENET + [60]


def test_grouped_gram_is_one_launch_with_the_planned_table(fake_cuda):
    n, ds = 50, GN_LENET
    xs = [torch.empty((n, d), device="meta") for d in ds]
    before = gram_matrix.launches
    g = gram_matrices(xs)
    assert tuple(g.shape) == (len(ds), n, n) and g.dtype == torch.float32
    assert gram_matrix.launches - before == 1
    ((fn, args),) = fake_cuda.calls
    assert fn == "gram_f32" and args[1:3] == (len(ds), n)
    plans, _, _ = pc.plan_gram(n, ds, 132)
    table = _table(args[0], len(ds), 7)
    assert table[:, 1:].tolist() == [list(p) for p in plans]


def test_grouped_gram_splits_past_max_leaves(fake_cuda):
    xs = [torch.empty((9, 64), device="meta")] * (pc.MAX_LEAVES + 3)
    before = gram_matrix.launches
    gram_matrices(xs)
    assert gram_matrix.launches - before == 2
    assert [args[1] for _, args in fake_cuda.calls] == [pc.MAX_LEAVES, 3]


def test_grouped_wrappers_refuse_mixed_dtypes(fake_cuda):
    xs = [torch.empty((5, 8), device="meta"),
          torch.empty((5, 8), dtype=torch.bfloat16, device="meta")]
    with pytest.raises(ValueError, match="one dtype"):
        gram_matrices(xs)
    with pytest.raises(ValueError, match="one dtype"):
        graph_mix_leaves(torch.empty((5, 5), device="meta"), xs)


def _leaves(n, ds, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
            .to(dtype) for d in ds]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ds", [(7, RAGGED), (20, GN_LENET[:4])])
def test_cpu_grouped_forms_are_the_per_leaf_plain_versions(n, ds, dtype):
    xs = _leaves(n, ds, getattr(torch, dtype), n)
    rng = np.random.default_rng(n + 1)
    w = torch.as_tensor(rng.random((n, n)).astype(np.float32))
    e = torch.as_tensor(rng.random((n, n)) < 0.3)
    for got, want in zip(graph_mix_leaves(w, xs), xs):
        assert torch.equal(got, ref.graph_mix(w, want))
    for got, want in zip(graph_mix_masked_leaves(e, xs), xs):
        assert torch.equal(got, ref.graph_mix_masked(e, want))
    g = gram_matrices(xs)
    assert tuple(g.shape) == (len(ds), n, n)
    for got, x in zip(g, xs):
        assert torch.equal(got, ref.gram_matrix(x))


@pytest.mark.parametrize("n,ds", [(7, RAGGED), (20, GN_LENET[:4])])
def test_cpu_sweep_forms_are_each_experiments_own(n, ds):
    """Over an ``[E, n, ...]`` stack the parameter-dict ops give each
    experiment the bits of its own call (and so of the plain versions)."""
    E = 3
    rng = np.random.default_rng(n)
    stacked = {str(i): torch.as_tensor(rng.normal(size=(E, n, d))
                                       .astype(np.float32))
               for i, d in enumerate(ds)}
    w = torch.softmax(torch.as_tensor(rng.normal(size=(E, n, n))
                                      .astype(np.float32)), -1)
    e = torch.as_tensor(rng.random((E, n, n)) < 0.3)
    mixed = ops.mix_pytree(w, stacked)
    masked = ops.mix_masked_pytree(e, stacked)
    sim = ops.model_pairwise_cosine(stacked, experiments=True)
    for x in range(E):
        one = {k: v[x] for k, v in stacked.items()}
        assert torch.equal(sim[x], ops.model_pairwise_cosine(one))
        for k, v in ops.mix_pytree(w[x], one).items():
            assert torch.equal(mixed[k][x], v)
            assert torch.equal(v, ref.graph_mix(w[x], one[k]))
        for k, v in ops.mix_masked_pytree(e[x], one).items():
            assert torch.equal(masked[k][x], v)
            assert torch.equal(v, ref.graph_mix_masked(e[x], one[k]))
    # The CPU form writes into given outputs as the kernel does.
    xs = [v[0] for v in stacked.values()]
    outs = [torch.empty((n, d)) for d in ds]
    got = graph_mix_leaves(w[0], xs, out=outs)
    assert all(g is o and torch.equal(o, ref.graph_mix(w[0], x))
               for g, o, x in zip(got, outs, xs))


def _csr(n, k, seed, invalid=0.0):
    """Slots of k distinct non-self senders per receiver, weights, and a
    mask with a share ``invalid`` of invalid slots."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                    for i in range(n)])
    w = rng.random((n, k)).astype(np.float32)
    w_self = rng.random(n).astype(np.float32)
    mask = rng.random((n, k)) >= invalid
    return (torch.as_tensor(idx), torch.as_tensor(w),
            torch.as_tensor(w_self), torch.as_tensor(mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,invalid", [(7, 3, 0.0), (20, 19, 0.3),
                                         (50, 3, 0.1)])
def test_cpu_grouped_csr_is_the_per_leaf_plain_version(n, k, invalid,
                                                       dtype):
    xs = _leaves(n, RAGGED + GN_LENET[:4], getattr(torch, dtype), n + k)
    idx, w, w_self, mask = _csr(n, k, n * k, invalid)
    rows = torch.arange(n)[:, None]
    parked = (torch.where(mask, idx, rows).to(torch.int32),
              torch.where(mask, w, 0.0), w_self)
    for got, x in zip(graph_mix_sparse_leaves(*parked, xs), xs):
        assert got.dtype == x.dtype
        assert torch.equal(got, ref.graph_mix_sparse(*parked, x))
        assert torch.equal(got, graph_mix_sparse(*parked, x))
    stacked = {str(i): x for i, x in enumerate(xs)}
    mixed = ops.mix_sparse_pytree(idx, w, w_self, stacked, mask=mask)
    for key, x in stacked.items():
        assert torch.equal(mixed[key], ops.mix_sparse(idx, w, w_self, x,
                                                      mask=mask))
        assert torch.equal(mixed[key], ref.graph_mix_sparse(*parked, x))


def test_cpu_parameter_dict_ops_keep_the_leaf_by_leaf_bits():
    n = 9
    stacked = dict(zip("abcd", _leaves(n, [3, 40, 1, 129], torch.float32,
                                       5)))
    stacked = {k: v.reshape((n, -1, 1)) if k == "b" else v
               for k, v in stacked.items()}
    want = torch.zeros((n, n))
    for v in stacked.values():
        want += ref.pairwise_cosine(v.reshape(n, -1))
    assert torch.equal(ops.model_pairwise_cosine(stacked),
                       want / len(stacked))
    w = torch.softmax(torch.as_tensor(
        np.random.default_rng(0).normal(size=(n, n)).astype(np.float32)), 1)
    mixed = ops.mix_pytree(w, stacked)
    for k, v in stacked.items():
        assert mixed[k].shape == v.shape
        assert torch.equal(mixed[k], ref.graph_mix(w, v.reshape(n, -1))
                           .reshape(v.shape))
