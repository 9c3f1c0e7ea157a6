"""The port's sparse engine against the reference's on the tiny GN-LeNet
(width 4, 8 x 8 images, n = 6), for both sparse-native strategies; the
set-up and tolerances are ``test_torch_sparse_engine.py``'s."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_sparse_engine import (K, SPARSE,             # noqa: E402
                                      _reference_and_port,
                                      assert_matches_reference)


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sparse_engine_matches_reference_gn_lenet(name):
    n = 6
    make_jax, make_port = SPARSE[name]
    ref, port = _reference_and_port(
        "cnn", n, lambda: make_jax(n=n, k=K, seed=0),
        lambda: make_port(n=n, k=K, seed=0, device="cpu"))
    assert_matches_reference(ref, port)
