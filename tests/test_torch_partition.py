"""The port's partition functions are the reference's bit for bit: the same
numpy ``Generator`` state gives the same node index arrays, the same label
distributions and the same heterogeneity, and the same refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import repro.data as jdata                                   # noqa: E402
import repro_torch.data as tdata                             # noqa: E402


def _writer_dataset(seed):
    return jdata.make_image_classification(600, num_classes=10, image_size=8,
                                           writers=24, seed=seed)


@pytest.mark.parametrize("n_nodes,seed", [(1, 0), (5, 1), (8, 2), (24, 3)])
def test_by_writer_partition_exact(n_nodes, seed):
    ds = _writer_dataset(seed)
    ref = jdata.by_writer_partition(ds.writer_ids, n_nodes,
                                    np.random.default_rng(seed))
    port = tdata.by_writer_partition(ds.writer_ids, n_nodes,
                                     np.random.default_rng(seed))
    assert len(port) == len(ref) == n_nodes
    for r, p in zip(ref, port):
        assert p.dtype == r.dtype == np.int64
        np.testing.assert_array_equal(p, r)


def test_by_writer_partition_leaves_the_generator_where_the_reference_does():
    ds = _writer_dataset(4)
    g_ref, g_port = np.random.default_rng(9), np.random.default_rng(9)
    jdata.by_writer_partition(ds.writer_ids, 6, g_ref)
    tdata.by_writer_partition(ds.writer_ids, 6, g_port)
    np.testing.assert_array_equal(g_ref.random(8), g_port.random(8))


def test_by_writer_partition_refuses_as_the_reference_does():
    ids = np.zeros(10, np.int64)
    with pytest.raises(ValueError) as want:
        jdata.by_writer_partition(ids, 3, np.random.default_rng(0))
    with pytest.raises(ValueError) as got:
        tdata.by_writer_partition(ids, 3, np.random.default_rng(0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("alpha,n_nodes,num_classes", [
    (0.1, 8, 10), (0.5, 4, 5), (100.0, 10, 10)])
def test_label_distributions_and_heterogeneity_exact(alpha, n_nodes,
                                                      num_classes):
    ds = jdata.make_image_classification(1500, num_classes=num_classes,
                                         image_size=8, seed=1)
    parts = tdata.dirichlet_partition(ds.labels, n_nodes, alpha,
                                      np.random.default_rng(3))
    ref = jdata.label_distributions(ds.labels, parts, num_classes)
    port = tdata.label_distributions(ds.labels, parts, num_classes)
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)
    assert tdata.heterogeneity(ds.labels, parts, num_classes) == \
        jdata.heterogeneity(ds.labels, parts, num_classes)


def test_label_distributions_of_an_empty_node_exact():
    labels = np.array([0, 1, 1, 2], np.int64)
    parts = [np.array([0, 1], np.int64), np.array([], np.int64),
             np.array([2, 3], np.int64)]
    np.testing.assert_array_equal(tdata.label_distributions(labels, parts, 4),
                                  jdata.label_distributions(labels, parts, 4))
    assert tdata.heterogeneity(labels, parts, 4) == \
        jdata.heterogeneity(labels, parts, 4)


def test_by_writer_heterogeneity_exact():
    ds = _writer_dataset(5)
    parts = tdata.by_writer_partition(ds.writer_ids, 6,
                                      np.random.default_rng(5))
    assert tdata.heterogeneity(ds.labels, parts, 10) == \
        jdata.heterogeneity(ds.labels, parts, 10)
