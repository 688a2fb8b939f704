"""Port parity: the port's paged attention (plain PyTorch version, the path
a CPU tensor takes) against the JAX package's jnp oracle
``repro.models.attention.attn_paged`` and its Pallas kernel
``paged_flash_attention`` in interpret mode, on the same seeded numpy
inputs. fp32 throughout; tolerance atol=rtol=1e-5 (the two frameworks sum
the scores and the weighted values in different orders). The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_flash_attention as jax_kernel  # noqa: E402
from repro.models.attention import attn_paged as jax_attn_paged  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.attention import attn_paged, attention_paged  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B, Q, H, Kv, BS, MB=6, D=16, index=(5, 11, 0)):
    """Seeded inputs: rows 0 and 1 own disjoint blocks, row 2 sits on the
    NULL block 0 (a frozen/empty serving slot)."""
    rng = np.random.default_rng(seed)
    NB = 2 * MB + 2
    q = rng.standard_normal((B, Q, H, D)).astype(np.float32)
    k = rng.standard_normal((NB, BS, Kv, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, Kv, D)).astype(np.float32)
    table = np.zeros((B, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    table[0] = perm[:MB]
    table[1] = perm[MB:2 * MB]
    idx = np.asarray(index[:B], np.int32)
    return q, k, v, table, idx


def _port(q, k, v, table, idx, **kw):
    return attn_paged(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(table),
                      torch.from_numpy(np.asarray(idx)), **kw).numpy()


def _jax(fn, q, k, v, table, idx, **kw):
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(table), jnp.asarray(idx), **kw))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("Q", [1, 4, 13])
@pytest.mark.parametrize("H,Kv", [(4, 2), (4, 4), (8, 2)])
@pytest.mark.parametrize("BS", [4, 8])
def test_plain_matches_jax_oracle_and_kernel(BS, H, Kv, Q, window):
    q, k, v, table, idx = _case(BS * 100 + H * 10 + Kv + Q, 3, Q, H, Kv, BS)
    got = _port(q, k, v, table, idx, window=window)
    want = _jax(jax_attn_paged, q, k, v, table, idx, window=window)
    np.testing.assert_allclose(got, want, **TOL)
    kern = _jax(jax_kernel, q, k, v, table, idx, window=window, interpret=True)
    np.testing.assert_allclose(got, kern, **TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_scalar_index(window):
    q, k, v, table, _ = _case(7, 2, 4, 4, 2, 4)
    idx = np.asarray(9, np.int32)
    got = _port(q, k, v, table, idx, window=window)
    want = _jax(jax_attn_paged, q, k, v, table, idx, window=window)
    np.testing.assert_allclose(got, want, **TOL)
    kern = _jax(jax_kernel, q, k, v, table, idx, window=window, interpret=True)
    np.testing.assert_allclose(got, kern, **TOL)


@pytest.mark.parametrize("max_live", [6, 9, 30])
def test_max_live_cap(max_live):
    """An explicit live bound truncates the block scan exactly as the
    oracle and the Pallas kernel do (including a cap below some rows'
    own index + Q)."""
    q, k, v, table, idx = _case(11, 3, 3, 8, 2, 4, index=(5, 11, 2))
    got = _port(q, k, v, table, idx, max_live=max_live)
    want = _jax(jax_attn_paged, q, k, v, table, idx, max_live=max_live)
    np.testing.assert_allclose(got, want, **TOL)
    kern = _jax(jax_kernel, q, k, v, table, idx, max_live=max_live,
                interpret=True)
    np.testing.assert_allclose(got, kern, **TOL)


def test_cpu_call_takes_plain_version_without_launching():
    q, k, v, table, idx = _case(3, 3, 4, 4, 2, 8)
    args = [torch.from_numpy(a) for a in (q, k, v, table, idx)]
    before = pa.paged_flash_attention.launches
    direct = pa.paged_flash_attention(*args, window=5).numpy()
    via_model = attention_paged(*args, window=5).numpy()
    assert pa.paged_flash_attention.launches == before == 0
    want = _port(q, k, v, table, idx, window=5)
    np.testing.assert_array_equal(direct, want)
    np.testing.assert_array_equal(via_model, want)


def test_model_dispatch_keeps_the_explicit_scale_on_cpu():
    q, k, v, table, idx = _case(5, 3, 1, 4, 2, 4)
    got = attention_paged(*[torch.from_numpy(a) for a in (q, k, v, table, idx)],
                          scale=0.3).numpy()
    want = _jax(jax_attn_paged, q, k, v, table, idx, scale=0.3)
    np.testing.assert_allclose(got, want, **TOL)
