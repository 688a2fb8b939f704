"""Port parity: the port's SSD scan (the wrapper on CPU tensors, which takes
the plain version) against the JAX package's Pallas kernel ``ssd_scan``
through ``repro.kernels.ops.ssd_scan`` (interpret mode on the CPU) and its
jnp oracle ``repro.kernels.ref.ssd_scan_ref``, on the same seeded numpy
inputs; and the port's ``ssd_chunked`` (y and final state, from a non-zero
initial state) against JAX's.

Tolerance: fp32 atol = rtol = 2e-4, the JAX package's own for its kernel
(tests/test_ssd_kernel.py): the frameworks contract the chunk products in
different orders. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(seed, b, l, h, p, n):
    """x, dA (negative log-decays), B, C as the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dA = -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32)
    Bm = (rng.standard_normal((b, l, h, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, l, h, n)) * 0.5).astype(np.float32)
    return x, dA, Bm, Cm


def _port(fn, arrs, chunk):
    return fn(*(torch.from_numpy(a) for a in arrs), chunk=chunk).numpy()


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 16, 2, 8, 4, 4), (2, 32, 3, 16, 8, 8), (1, 24, 1, 32, 16, 8),
    (2, 20, 2, 8, 8, 8),                 # the JAX kernel test's four shapes
    (2, 20, 8, 32, 16, 8),               # the mamba2-780m smoke shape
    (1, 13, 2, 8, 4, 4), (2, 27, 3, 16, 8, 8),   # l not a multiple of chunk
])
def test_plain_matches_jax_kernel_and_oracle(b, l, h, p, n, chunk):
    arrs = _inputs(b * 1000 + l, b, l, h, p, n)
    got = _port(ss.ssd_scan, arrs, chunk)
    via_ops = _port(ops.ssd_scan, arrs, chunk)
    j = [jnp.asarray(a) for a in arrs]
    kern = np.asarray(jax_ops.ssd_scan(*j, chunk=chunk))
    want = np.asarray(jax_ref.ssd_scan_ref(*j, chunk=chunk))
    assert got.shape == (b, l, h, p) and got.dtype == np.float32
    np.testing.assert_array_equal(via_ops, got)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_state_carries_across_chunks():
    """The JAX kernel test's impulse: one input at t = 0 decays
    geometrically through every chunk boundary, and the port gives JAX's
    response."""
    b, l, h, p, n = 1, 32, 1, 4, 4
    x = np.zeros((b, l, h, p), np.float32)
    x[0, 0, 0, :] = 1.0
    dA = np.full((b, l, h), -0.05, np.float32)
    Bm = np.full((b, l, h, n), 0.5, np.float32)
    Cm = np.full((b, l, h, n), 0.5, np.float32)
    y = _port(ss.ssd_scan, (x, dA, Bm, Cm), 8)
    want = np.asarray(jax_ops.ssd_scan(*(jnp.asarray(a) for a in (x, dA, Bm, Cm)),
                                       chunk=8))
    np.testing.assert_allclose(y, want, **TOL)
    resp = y[0, :, 0, 0]
    assert resp[9] > 0 and resp[17] > 0 and resp[31] > 0
    assert resp[9] > resp[17] > resp[31]


def test_group_broadcast_view_matches_copy():
    """The model hands B and C as a stride-0 view over heads; the plain
    version gives the same as on a materialised copy."""
    x, dA, Bm, Cm = _inputs(5, 2, 19, 4, 8, 8)
    B1 = torch.from_numpy(Bm[:, :, :1]).expand(2, 19, 4, 8)
    args = (torch.from_numpy(x), torch.from_numpy(dA))
    view = ss.ssd_scan(*args, B1, torch.from_numpy(Cm), chunk=8)
    copy = ss.ssd_scan(*args, B1.contiguous(), torch.from_numpy(Cm), chunk=8)
    np.testing.assert_array_equal(view.numpy(), copy.numpy())


@pytest.mark.parametrize("l,chunk", [(16, 4), (19, 8), (40, 8)])
def test_ssd_chunked_with_init_state_matches_jax(l, chunk):
    b, h, p, n = 2, 3, 8, 4
    x, dA, Bm, Cm = _inputs(l + chunk, b, l, h, p, n)
    init = np.random.default_rng(9).standard_normal((b, h, p, n)).astype(np.float32)
    y, final = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dA, Bm, Cm)),
                               chunk, torch.from_numpy(init))
    jy, jfinal = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dA, Bm, Cm)),
                                     chunk, jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)


def test_segsum_is_minus_inf_above_the_diagonal():
    a = torch.from_numpy(np.random.default_rng(1).uniform(-1, 0, (2, 6)).astype(np.float32))
    got = ssm._segsum(a).numpy()
    want = np.asarray(jax_ssm._segsum(jnp.asarray(a.numpy())))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **TOL)


def test_kernel_wrapper_refuses_a_non_cuda_device():
    x, dA, Bm, Cm = (torch.from_numpy(a).to("meta") for a in _inputs(0, 1, 8, 1, 4, 4))
    with pytest.raises(ValueError, match="device"):
        ss.ssd_scan(x, dA, Bm, Cm, chunk=4)

