"""GN-LeNet, its gradients and one local SGD step: the port against the
reference from the same parameters (carried over with ``params_from_jax``)
and the same host batch.  f32 throughout; atol 1e-5 (convolutions and
reductions sum in other orders on the two sides)."""
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.data import (dirichlet_partition,                 # noqa: E402
                        make_image_classification)
from repro.data.pipeline import StackedBatcher               # noqa: E402
from repro.dlrt.runtime import make_evaluator as jax_evaluator  # noqa: E402
from repro.dlrt.runtime import make_local_step as jax_local_step  # noqa: E402
from repro.models import cnn as jcnn                         # noqa: E402
from repro.optim import sgd as jax_sgd                       # noqa: E402
from repro_torch.dlrt.runtime import (make_evaluator,        # noqa: E402
                                      make_local_step, to_device)
from repro_torch.models import cnn_forward, cnn_loss, cnn_params  # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.tree import (params_from_jax,               # noqa: E402
                              params_to_numpy)

ATOL = 1e-5
TINY = dict(in_channels=3, num_classes=4, image_size=8, width=4)
FULL = dict(in_channels=3, num_classes=10, image_size=32, width=32)


def _jax_params(key, cfg):
    return jax.tree_util.tree_map(np.asarray, jcnn.cnn_params(key, **cfg))


def _batch(cfg, n_nodes, seed=0):
    ds = make_image_classification(200, num_classes=cfg["num_classes"],
                                   image_size=cfg["image_size"], seed=seed)
    parts = dirichlet_partition(ds.labels, n_nodes, 0.5,
                                np.random.default_rng(seed))
    return StackedBatcher(ds, parts, 8, seed=3).next()


def test_tree_order_and_roundtrip():
    tree = _jax_params(jax.random.PRNGKey(0), FULL)
    port = params_from_jax(tree)
    paths = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(port) == [p.replace("/", ".") for p in paths]
    assert list(port) == ["conv1.b", "conv1.w", "conv2.b", "conv2.w",
                          "fc.b", "fc.w", "gn1.bias", "gn1.scale",
                          "gn2.bias", "gn2.scale"]
    assert sum(v.numel() for v in port.values()) == 94858
    back = params_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    shapes = {k: v.shape for k, v in cnn_params(None, **FULL).items()}
    assert shapes == {k: v.shape for k, v in port.items()}


@pytest.mark.parametrize("cfg", [TINY, FULL], ids=["tiny", "full"])
def test_forward_matches(cfg):
    tree = _jax_params(jax.random.PRNGKey(1), cfg)
    images = _batch(cfg, 1)["images"][0]
    want = np.asarray(jax.jit(jcnn.cnn_forward)(tree, jnp.asarray(images)))
    got = cnn_forward(params_from_jax(tree), torch.as_tensor(images))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_loss_and_gradients_match():
    tree = _jax_params(jax.random.PRNGKey(2), TINY)
    b = {k: v[0] for k, v in _batch(TINY, 1).items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jcnn.cnn_loss, has_aux=True))(tree, {k: jnp.asarray(v)
                                            for k, v in b.items()})
    p = params_from_jax(tree)
    tb = to_device(b, "cpu")
    loss, aux = cnn_loss(p, tb)
    grads = torch.func.grad(lambda q: cnn_loss(q, tb)[0])(dict(p))
    assert float(loss) == pytest.approx(float(jloss), abs=ATOL)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for key in want:
        np.testing.assert_allclose(grads[key].numpy(), want[key].numpy(),
                                   atol=ATOL, err_msg=key)


def test_one_local_sgd_step_matches():
    n = 3
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    stacked = jax.tree_util.tree_map(
        np.asarray, jax.vmap(lambda k: jcnn.cnn_params(k, **TINY))(keys))
    batch = _batch(TINY, n)
    opt = jax_sgd(0.05)
    jstate = jax.vmap(opt.init)(stacked)
    jparams, _ = jax.jit(jax_local_step(jcnn.cnn_loss, opt))(
        stacked, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    p = params_from_jax(stacked)
    topt = sgd(0.05)
    tparams, tstate = make_local_step(cnn_loss, topt)(
        p, topt.init(p), to_device(batch, "cpu"))
    assert isinstance(tparams, OrderedDict) and list(tparams) == list(p)
    assert int(tstate["count"]) == 1
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for key in want:
        np.testing.assert_allclose(tparams[key].numpy(), want[key].numpy(),
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("chunk", [None, 64, 37])
def test_evaluator_matches(chunk):
    """Every node on a shared test batch, whole or in sample chunks (the
    chunk means recombine by sample count, so within f32 rounding)."""
    n = 3
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    stacked = jax.tree_util.tree_map(
        np.asarray, jax.vmap(lambda k: jcnn.cnn_params(k, **TINY))(keys))
    ds = make_image_classification(150, num_classes=4, image_size=8, seed=5)
    test = {"images": ds.images, "labels": ds.labels}
    jl, jm = jax.jit(jax_evaluator(jcnn.cnn_loss, batch_chunk=chunk))(
        stacked, {k: jnp.asarray(v) for k, v in test.items()})
    with torch.no_grad():
        tl, tm = make_evaluator(cnn_loss, batch_chunk=chunk)(
            params_from_jax(stacked), to_device(test, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tm["accuracy"].numpy(),
                               np.asarray(jm["accuracy"]), atol=ATOL)
