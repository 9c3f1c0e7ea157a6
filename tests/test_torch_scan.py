"""The port's selective scan against the reference's, on the CPU.

For CPU tensors :func:`repro_torch.kernels.selective_scan` runs its plain
version (the direct recurrence); it is held to the reference's Pallas
kernel in interpret mode and to ``repro.kernels.ref.selective_scan_ref``
at ``tests/test_kernels.py``'s shapes, a ragged ``d_inner``, ``L = 1`` and
``L = 37``, with f32 and bf16 inputs, within ``test_kernels.py``'s atol of
1e-5: every side computes in f32 from the same values (bf16 converts to
f32 exactly) and differs only in the order of the ``y`` sum over states.
``tests/test_torch_cuda.py`` holds the CUDA kernel to the plain version on
the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp                                      # noqa: E402

from repro.kernels import ref as jref                        # noqa: E402
from repro.kernels.selective_scan import \
    selective_scan as jax_selective_scan                     # noqa: E402
from repro_torch.kernels import selective_scan               # noqa: E402

# (batch, L, d_inner, d_state, Pallas d_inner block): test_kernels.py's
# four, a ragged d_inner (no block of 32 divides 100, so Pallas takes it
# whole), one step, and an L that is no multiple of the CUDA tile.
SHAPES = [(2, 16, 64, 8, 32), (1, 32, 128, 16, 128), (3, 8, 96, 4, 32),
          (2, 64, 256, 16, 64), (2, 16, 100, 8, 100), (2, 1, 64, 16, 64),
          (1, 37, 96, 16, 32)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def scan_inputs(bt, L, di, ds, seed, h0_scale=0.1):
    """x, dt (post-softplus), b, c, a = -exp(.), h0 as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(bt, L, di)).astype(f)
    dt = np.logaddexp(rng.normal(size=(bt, L, di)), 0).astype(f)
    b = (rng.normal(size=(bt, L, ds)) * 0.5).astype(f)
    c = (rng.normal(size=(bt, L, ds)) * 0.5).astype(f)
    a = (-np.exp(rng.normal(size=(di, ds)) * 0.3)).astype(f)
    h0 = (rng.normal(size=(bt, di, ds)) * h0_scale).astype(f)
    return x, dt, b, c, a, h0


def _both(arrays, dtype):
    """The four sequence inputs in ``dtype``, ``a`` and ``h0`` in f32, as
    torch tensors and as jax arrays holding the same values."""
    tdt, jdt = DTYPES[dtype]
    t = [torch.as_tensor(v).to(tdt) for v in arrays[:4]] \
        + [torch.as_tensor(v) for v in arrays[4:]]
    j = [jnp.asarray(v).astype(jdt) for v in arrays[:4]] \
        + [jnp.asarray(v) for v in arrays[4:]]
    return t, j


@pytest.mark.parametrize("bt,L,di,ds,blk", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_scan_matches_pallas_and_reference(bt, L, di, ds, blk, dtype):
    t, j = _both(scan_inputs(bt, L, di, ds, seed=bt * L + di), dtype)
    before = selective_scan.launches
    y, h = selective_scan(*t)
    assert selective_scan.launches == before        # CPU: no kernel launch
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (bt, L, di) and h.shape == (bt, di, ds)
    yp, hp = jax_selective_scan(*j, di_block=blk, interpret=True)
    yr, hr = jref.selective_scan_ref(*j)
    for got, want in ((y, yp), (h, hp), (y, yr), (h, hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_scan_chunk_chaining():
    """Two halves chained through h equal one call over the whole
    sequence, and the reference's."""
    bt, L, di, ds = 2, 32, 64, 8
    arrays = scan_inputs(bt, L, di, ds, seed=9)
    (x, dt, b, c, a, h0), j = _both(arrays, "float32")
    y_full, h_full = selective_scan(x, dt, b, c, a, h0)
    half = L // 2
    y1, h1 = selective_scan(x[:, :half], dt[:, :half], b[:, :half],
                            c[:, :half], a, h0)
    y2, h2 = selective_scan(x[:, half:], dt[:, half:], b[:, half:],
                            c[:, half:], a, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5)
    yr, hr = jref.selective_scan_ref(*j)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(hr), atol=1e-5)


@pytest.mark.parametrize("ds", [16, 8, 4])
def test_plain_scan_sums_y_in_the_kernels_order(ds):
    """The plain version's ``y`` is, bit for bit, the CUDA kernel's sum:
    each group of 4 states in state order (``p_q``), then ``(p0 + p1) +
    (p2 + p3)`` at 16 states, ``p0 + p1`` at 8 and ``p0`` at 4; its ``h``
    is the recurrence with each product rounded before its add."""
    x, dt, b, c, a, h0 = (torch.as_tensor(v)
                          for v in scan_inputs(2, 9, 24, ds, seed=ds))
    y, h = selective_scan(x, dt, b, c, a, h0)
    hs = h0
    for t in range(x.shape[1]):
        hs = torch.exp(dt[:, t, :, None] * a) * hs \
            + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        hc = hs * c[:, t, None, :]
        p = [((hc[..., 4 * q] + hc[..., 4 * q + 1]) + hc[..., 4 * q + 2])
             + hc[..., 4 * q + 3] for q in range(ds // 4)]
        want = {16: lambda: (p[0] + p[1]) + (p[2] + p[3]),
                8: lambda: p[0] + p[1], 4: lambda: p[0]}[ds]()
        assert torch.equal(y[:, t], want), t
    assert torch.equal(h, hs)
