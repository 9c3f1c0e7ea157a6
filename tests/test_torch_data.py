"""The port's numpy data and graph substrate is the reference's bit for bit,
and its device stream gives the reference's batches when handed the
reference's draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
import repro.data as jdata                                   # noqa: E402
import repro.dlrt.metrics as jmetrics                        # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
import repro_torch.data as tdata                             # noqa: E402
import repro_torch.dlrt.metrics as tmetrics                  # noqa: E402

from _jax_draws import stream_take                           # noqa: E402


def _equal_datasets(a, b):
    for field in ("images", "labels", "writer_ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("kw", [
    dict(n_samples=300, seed=0),
    dict(n_samples=200, num_classes=62, image_size=28, channels=1,
         writers=5, noise=3.0, seed=4),
])
def test_synthetic_and_split_exact(kw):
    ref = jdata.make_image_classification(**kw)
    port = tdata.make_image_classification(**kw)
    _equal_datasets(ref, port)
    for r, p in zip(jdata.train_test_split(ref, 0.2, seed=1),
                    tdata.train_test_split(port, 0.2, seed=1)):
        _equal_datasets(r, p)


@pytest.mark.parametrize("n,alpha", [(6, 0.5), (50, 0.1)])
def test_dirichlet_partition_exact(n, alpha):
    labels = jdata.make_image_classification(2000, seed=2).labels
    ref = jdata.dirichlet_partition(labels, n, alpha,
                                    np.random.default_rng(7))
    port = tdata.dirichlet_partition(labels, n, alpha,
                                     np.random.default_rng(7))
    assert len(ref) == len(port) == n
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)


def test_stacked_batcher_exact():
    ds = jdata.make_image_classification(300, seed=1)
    parts = jdata.dirichlet_partition(ds.labels, 5, 0.5,
                                      np.random.default_rng(0))
    ref = jdata.StackedBatcher(ds, parts, 8, seed=3)
    port = tdata.StackedBatcher(ds, parts, 8, seed=3)
    for _ in range(40):                     # crosses several epochs
        a, b = ref.next(), port.next()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("n,degree,connected", [(6, 3, False), (50, 3, True),
                                                 (50, 4, False)])
def test_topology_exact(n, degree, connected):
    ref = jcore.random_regular_graph(n, degree, np.random.default_rng(9),
                                     connected=connected)
    port = tcore.random_regular_graph(n, degree, np.random.default_rng(9),
                                      connected=connected)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(tcore.metropolis_hastings_weights(port),
                                  jcore.metropolis_hastings_weights(ref))
    np.testing.assert_array_equal(tcore.fully_connected(n),
                                  jcore.fully_connected(n))
    edges = ref & (np.random.default_rng(1).random((n, n)) < 0.5)
    np.testing.assert_array_equal(tcore.isolated_nodes(edges),
                                  jcore.isolated_nodes(edges))
    np.testing.assert_array_equal(tcore.in_degrees(edges),
                                  jcore.in_degrees(edges))
    np.testing.assert_array_equal(tcore.uniform_weights(edges),
                                  jcore.uniform_weights(edges))
    np.testing.assert_array_equal(
        tcore.uniform_weights_torch(torch.as_tensor(edges)).numpy(),
        np.asarray(jcore.uniform_weights_jax(jnp.asarray(edges))))


def test_metrics_exact():
    acc = np.random.default_rng(0).random(7).astype(np.float32)
    assert tmetrics.internode_variance(acc) \
        == jmetrics.internode_variance(acc)


def test_device_stream_replays_reference_batches():
    ds = jdata.make_image_classification(500, seed=0)
    tr, _ = jdata.train_test_split(ds, 0.2)
    parts = jdata.dirichlet_partition(tr.labels, 6, 0.1,
                                      np.random.default_rng(0))
    ref = jdata.DeviceDataStream(tr, parts, 8, seed=3)
    port = tdata.DeviceDataStream(tr, parts, 8, seed=3, device="cpu")
    args = ({k: jnp.asarray(v) for k, v in ref.data.items()},
            jnp.asarray(ref.index), jnp.asarray(ref.sizes),
            jnp.arange(6, dtype=jnp.int32))
    for rnd in (0, 1, 17):
        want = ref.draw(*args, jnp.asarray(rnd))
        got = port.draw(rnd, take=stream_take(3, rnd, ref.sizes, 8))
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_device_stream_own_draws():
    """Without ``take`` the stream samples each node's own shard, as a
    pure function of (seed, round)."""
    ds = jdata.make_image_classification(300, seed=0)
    parts = jdata.dirichlet_partition(ds.labels, 4, 0.1,
                                      np.random.default_rng(1))
    stream = tdata.DeviceDataStream(ds, parts, 16, seed=2, device="cpu")
    a = stream.draw(5)
    stream.draw(6)
    b = stream.draw(5)
    assert a["images"].shape == (4, 16, 32, 32, 3)
    assert torch.equal(a["labels"], b["labels"])
    for i, part in enumerate(parts):
        assert set(a["labels"][i].tolist()) <= set(ds.labels[part].tolist())
