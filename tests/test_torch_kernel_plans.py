"""Launch planning of the grouped graph-mix and Gram kernels, on the CPU.

A grouped call numbers the work of every leaf in one launch.  These tests
hold the pure-Python plans (``plan_mix``, ``plan_gram``) to what the
kernels rely on: every column of every leaf is mixed exactly once, every
Gram tile ``i <= j`` is computed exactly once and its splits cover D
exactly once, and a leaf's plan does not depend on the other leaves of the
call (so a grouped call gives each leaf the bits of a call of its own).
They also check the tables the wrappers hand to the C functions, with the
library faked, and that the CPU forms of the grouped wrappers are the
per-leaf plain versions, bit for bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    cuda, graph_mix, graph_mix_leaves, graph_mix_masked,
    graph_mix_masked_leaves, gram_matrices, gram_matrix, ops, ref)
from repro_torch.kernels import pairwise_cosine as pc  # noqa: E402

# The package's ``graph_mix`` is the wrapper; its module holds the plan.
gm_mod = importlib.import_module("repro_torch.kernels.graph_mix")

# GN-LeNet CIFAR-10 at width 32: its ten leaves' widths per node.
GN_LENET = [32, 2400, 64, 51200, 10, 40960, 32, 32, 64, 64]
RAGGED = [1, 10, 129, 8199]
LEAF_SETS = {"gn_lenet": GN_LENET, "ragged": RAGGED,
             "mixed": [0, 129, 1, 64, 65, 8199, 0]}
NODES = [7, 50, 100, 129]
SMS = [132, 114, 8]


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
    assert args1[2:6] == (len(ds), n, n, 132)
    assert args2[2:5] == (len(ds), n, 132)
    for args in (args1, args2):
        table = _table(args[1], len(ds), 4)
        assert table[:, 2].tolist() == ds
        assert table[:, 3].tolist() == gm_mod.plan_mix(ds)


def test_grouped_mix_past_128_nodes_counts_a_launch_per_leaf(fake_cuda):
    xs = [torch.empty((200, d), device="meta") for d in (64, 0, 10)]
    w = torch.empty((200, 200), device="meta")
    before = graph_mix.launches
    graph_mix_leaves(w, xs)
    assert graph_mix.launches - before == 2        # the D = 0 leaf: none
    assert len(fake_cuda.calls) == 1


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
