"""Port parity for the ring KV cache: every ``kv_cache`` function bit for
bit against ``repro.cache.kv_cache`` (0-dim and [B] index, Q = 1, Q > 1,
Q >= W, fp32 and int8 buffers), the ``RING`` cache ops against JAX's, the
dense forward's identity-view read of a ring (the paged read over
[B * W / 16, 16, Kv, D]) against JAX's concat attention over
``slot_positions`` and against ``attn_tree_ring``, and the refusal of calls
the view cannot read (W not a multiple of the page, Q > W on a ring that
holds every position, a call that would evict a key inside the window;
windowed rings that wrap are held in tests/test_torch_windowed_ring.py).

Buffers moved by the cache functions compare exactly; attention outputs
compare at fp32 atol = rtol = 1e-5 (an online softmax over pages against
JAX's one-pass softmax sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.cache import kv_cache as jax_kv  # noqa: E402
from repro.cache import ops as jax_ops  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core.tree import chain_tree as jax_chain_tree  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.cache import kv_cache, paged_kv  # noqa: E402
from repro_torch.cache import ops as cache_ops  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.tree import chain_tree  # noqa: E402
from repro_torch.models import attention, dense  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ATT_TOL = dict(atol=1e-5, rtol=1e-5)
B, Kv, D = 3, 2, 8


def _buffers(seed, W, dtype="float32", L=None):
    rng = np.random.default_rng(seed)
    shape = ((L,) if L else ()) + (B, W, Kv, D)
    if dtype == "int8":
        return {n: rng.integers(-128, 128, shape).astype(np.int8) for n in "kv"}
    return {n: rng.standard_normal(shape).astype(np.float32) for n in "kv"}


def _new(seed, Q):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, Q, Kv, D)).astype(np.float32) for _ in "kv"]


def _index(kind, base):
    """A 0-dim index or a [B] index around ``base``."""
    if kind == "scalar":
        return np.int32(base)
    return np.asarray([base, base + 3, max(base - 2, 0)], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("W", [8, 16])
@pytest.mark.parametrize("new_len", [0, 1, 3])
@pytest.mark.parametrize("kind,base", [("scalar", 0), ("scalar", 5),
                                       ("scalar", 13), ("rows", 4),
                                       ("rows", 11)])
def test_slot_positions_match_jax(W, new_len, kind, base):
    idx = _index(kind, base)
    got = kv_cache.slot_positions(W, _t(idx), new_len)
    want = jax_kv.slot_positions(W, jnp.asarray(idx), new_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_buffer_len_and_init_cache_match_jax():
    for max_len, window in ((20, None), (20, 8), (6, 8)):
        assert kv_cache.buffer_len(max_len, window) == jax_kv.buffer_len(max_len, window)
        c = kv_cache.init_cache(2, B, max_len, Kv, D, window=window,
                                dtype=torch.float32, device="cpu")
        j = jax_kv.init_cache(2, B, max_len, Kv, D, window=window,
                              dtype=jnp.float32)
        for n in ("k", "v", "index"):
            assert tuple(c[n].shape) == j[n].shape
            np.testing.assert_array_equal(c[n].numpy(), np.asarray(j[n]))
        assert c["index"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("Q,kind,base", [
    (1, "scalar", 2), (1, "scalar", 6), (1, "rows", 1), (1, "rows", 9),
    (3, "scalar", 2), (3, "scalar", 6), (3, "rows", 1), (3, "rows", 9),
    (8, "scalar", 2), (11, "scalar", 6)])
def test_write_matches_jax_bit_exact(dtype, Q, kind, base):
    """W = 8, so Q = 8 and 11 take the Q >= W branch (the last W tokens
    kept), with a 0-dim index as JAX's branch takes it (it scatters a [B]
    index there through one shared slot list)."""
    W = 8
    buf = _buffers(0, W, dtype)
    k_new, v_new = _new(1, Q)
    idx = _index(kind, base)
    kb, vb = _t(buf["k"]), _t(buf["v"])
    got = kv_cache.write(kb, vb, _t(k_new), _t(v_new), _t(idx))
    assert got[0] is kb and got[1] is vb                    # in place
    want = jax_kv.write(jnp.asarray(buf["k"]), jnp.asarray(buf["v"]),
                        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("Q", [1, 4])
@pytest.mark.parametrize("kind,base", [("scalar", 3), ("scalar", 10),
                                       ("rows", 5)])
def test_extend_matches_jax_bit_exact(dtype, Q, kind, base):
    W = 8
    buf = _buffers(2, W, dtype)
    k_new, v_new = _new(3, Q)
    idx = _index(kind, base)
    got = kv_cache.extend({n: _t(a) for n, a in buf.items()}, _t(k_new),
                          _t(v_new), _t(idx))
    want = jax_kv.extend({n: jnp.asarray(a) for n, a in buf.items()},
                         jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(idx))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for n in "kv":
        np.testing.assert_array_equal(got[3][n].numpy(), np.asarray(want[3][n]))


@pytest.mark.parametrize("accepted", [np.int32(7), np.asarray([2, 9, 4], np.int32)])
def test_rollback_matches_jax(accepted):
    c = kv_cache.init_cache(1, B, 16, Kv, D, dtype=torch.float32, device="cpu")
    j = jax_kv.init_cache(1, B, 16, Kv, D, dtype=jnp.float32)
    got = kv_cache.rollback(c, _t(accepted))
    want = jax_kv.rollback(j, jnp.asarray(accepted))
    np.testing.assert_array_equal(got["index"].numpy(), np.asarray(want["index"]))
    assert got["index"].dtype == torch.int32 and got["k"] is c["k"]


@pytest.mark.parametrize("W", [8, 32])
def test_compact_positions_matches_jax_bit_exact(W):
    """A W=2 depth-3 tree's winner moves (src >= dst, overlapping), and on
    W = 8 positions past the buffer that resolve mod W."""
    buf = _buffers(4, W, L=2)
    length = np.asarray([4, 6, 5], np.int32)
    cs = np.asarray(jax_chain_tree(2, 3).chain_slots)
    winner = np.asarray([1, 0, 1])
    src = (length - 1)[:, None] + cs[winner]
    dst = length[:, None] + np.arange(3, dtype=np.int32)
    cache = {n: _t(a) for n, a in buf.items()}
    got = kv_cache.compact_positions(cache, _t(src), _t(dst))
    want = jax_kv.compact_positions({n: jnp.asarray(a) for n, a in buf.items()},
                                    jnp.asarray(src), jnp.asarray(dst))
    for n in "kv":
        assert got[n] is cache[n]                           # in place
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    cfg = registry.smoke_config("llama3.2-1b")
    return jax_build(jcfg), build_model(cfg), cfg


def test_ring_ops_match_jax(models):
    jm, m, cfg = models
    c = cache_ops.RING.init(m, B, max_len=21, spec_slack=5, device="cpu")
    j = jax_ops.RING.init(jm, B, max_len=21, spec_slack=5)
    # the port rounds W up to a multiple of the view's page; JAX keeps 21
    assert tuple(c["k"].shape) == (cfg.num_layers, B, 32, cfg.num_kv_heads,
                                   cfg.head_dim)
    assert j["k"].shape[2] == 21 and c["k"].dtype == torch.float32
    assert cache_ops.ops_for(c) is cache_ops.RING and cache_ops.RING.kind == "ring"
    assert cache_ops.ops_for(None) is cache_ops.RING
    paged = m.init_paged_cache(2, 8, 4, 4, device="cpu")
    assert cache_ops.ops_for(paged) is cache_ops.PAGED
    assert cache_ops.RING.live_bound(torch.tensor([3, 5])) is None
    # write = JAX's new layer cache; rollback, compact as kv_cache's
    W = 16
    buf = _buffers(5, W)
    k_new, v_new = _new(6, 3)
    lc = {n: _t(a) for n, a in buf.items()}
    got = cache_ops.RING.write(lc, _t(k_new), _t(v_new), torch.tensor(4))
    want = jax_ops.RING.write({n: jnp.asarray(a) for n, a in buf.items()},
                              jnp.asarray(k_new), jnp.asarray(v_new), 4)[3]
    assert got is lc
    for n in "kv":
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    rb = cache_ops.RING.rollback({**c, "index": torch.tensor(9)}, torch.tensor(6))
    assert int(rb["index"]) == 6


def _ring_and_new(seed, W, index, Q, H, dtype):
    """A ring layer [B, W, Kv, D] holding stale garbage everywhere (JAX's
    concat masks old slots >= index by position; the view by causality),
    new K/V and queries for Q tokens."""
    buf = _buffers(seed, W, dtype)
    k_new, v_new = _new(seed + 1, Q)
    q = np.random.default_rng(seed + 2).standard_normal((B, Q, H, D)).astype(np.float32)
    return buf, k_new, v_new, q


@pytest.mark.parametrize("dtype,Q", [("float32", 1), ("float32", 5),
                                     ("float32", 16), ("int8", 1), ("int8", 5),
                                     ("int8", 16)])
@pytest.mark.parametrize("kind,base", [("scalar", 0), ("scalar", 9),
                                       ("rows", 4), ("rows", 13)])
def test_identity_view_read_matches_jax_concat(dtype, Q, kind, base):
    """Write first, then the paged read over the ring's identity view ==
    JAX's attention over [old buffer ++ new] at ``slot_positions``. On an
    int8 ring JAX reads a Q = 1 call from the written (quantized) buffer
    and a Q > 1 call's own tokens unquantized from its concat; the port's
    read takes them from ``dense.ring_fresh``, which gives the call's K/V
    at Q > 1 on an int8 ring and nothing otherwise."""
    W, H = 32, 4
    idx = _index(kind, base)
    buf, k_new, v_new, q = _ring_and_new(7, W, idx, Q, H, dtype)
    jq = jnp.asarray(q)
    k_all, v_all, kv_pos, _ = jax_kv.extend(
        {n: jnp.asarray(a) for n, a in buf.items()}, jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(idx))
    q_pos = jnp.asarray(idx)[..., None] + jnp.arange(Q, dtype=jnp.int32)
    want = jax_attn.attention(jq, k_all, v_all, q_pos, kv_pos)
    lc = cache_ops.RING.write({n: _t(a) for n, a in buf.items()}, _t(k_new),
                              _t(v_new), _t(idx))
    table = dense.ring_view_table(B, W, "cpu")
    fresh = dense.ring_fresh(lc, _t(k_new), _t(v_new))
    assert (fresh is not None) == (dtype == "int8" and Q > 1)
    got = attention.attention_paged(_t(q), dense.ring_view(lc["k"]),
                                    dense.ring_view(lc["v"]), table, _t(idx),
                                    fresh=fresh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def test_ring_view_is_a_view_with_the_identity_table():
    W = 32
    buf = torch.arange(B * W * Kv * D, dtype=torch.float32).reshape(B, W, Kv, D)
    pool = dense.ring_view(buf)
    assert pool.data_ptr() == buf.data_ptr() and tuple(pool.shape) == (B * 2, 16, Kv, D)
    table = dense.ring_view_table(B, W, "cpu")
    assert table.dtype == torch.int32 and table.tolist() == [[0, 1], [2, 3], [4, 5]]
    pos = torch.arange(W)
    for b in range(B):       # slot p of row b = page table[b, p // 16], offset p % 16
        np.testing.assert_array_equal(
            pool[table[b, pos // 16].long(), pos % 16].numpy(), buf[b].numpy())


@pytest.mark.parametrize("width,depth", [(2, 3), (1, 4), (3, 2)])
@pytest.mark.parametrize("kind,base", [("scalar", 6), ("rows", 3)])
def test_tree_ring_read_matches_jax(width, depth, kind, base):
    """``attn_tree_ring`` == JAX's, and the tree read over the identity
    view == both (the span written at index..index+span-1)."""
    W, H = 32, 4
    tree = chain_tree(width, depth)
    jtree = jax_chain_tree(width, depth)
    assert np.array_equal(tree.bits, jtree.bits)
    S = tree.span
    idx = _index(kind, base)
    buf, k_new, v_new, q = _ring_and_new(11, W, idx, S, H, "float32")
    jbuf = jax_kv.write(jnp.asarray(buf["k"]), jnp.asarray(buf["v"]),
                        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(idx))
    want = jax_attn.attn_tree_ring(jnp.asarray(q), jbuf[0], jbuf[1],
                                   jnp.asarray(idx), jnp.asarray(jtree.depths),
                                   jnp.asarray(jtree.bits))
    lc = cache_ops.RING.write({n: _t(a) for n, a in buf.items()}, _t(k_new),
                              _t(v_new), _t(idx))
    plain = attention.attn_tree_ring(_t(q), lc["k"], lc["v"], _t(idx),
                                     tree.depths, tree.bits)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **ATT_TOL)
    view = attention.attention_tree(_t(q), dense.ring_view(lc["k"]),
                                    dense.ring_view(lc["v"]),
                                    dense.ring_view_table(B, W, "cpu"), _t(idx),
                                    tree.depths, tree.bits)
    np.testing.assert_allclose(view.numpy(), np.asarray(want), **ATT_TOL)


def test_rings_the_view_cannot_read_raise(models):
    _, m, cfg = models
    params = m.init(0, "cpu")
    toks = torch.zeros((1, 3), dtype=torch.int32)
    windowed = build_model(cfg.replace(sliding_window=8))
    # a windowed ring is sized window + slack, rounded up to the page, and
    # keeps how many positions its table reaches
    wring = windowed.init_cache(1, 40, spec_slack=6, device="cpu")
    assert wring["k"].shape[2] == 16 and wring["positions"] == 48
    _, wring, _ = windowed.apply(params, toks, wring)
    _, wring, _ = windowed.apply(params, torch.zeros((1, 9), dtype=torch.int32),
                                 wring)               # 9 = 16 - 8 + 1 at 3
    with pytest.raises(ValueError, match="evict"):    # 10 tokens at 12
        windowed.apply(params, torch.zeros((1, 10), dtype=torch.int32), wring)
    ring = kv_cache.init_cache(cfg.num_layers, 1, 40, cfg.num_kv_heads,
                               cfg.head_dim, window=16, dtype=torch.float32,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="wrap"):       # Q > W
        m.apply(params, torch.zeros((1, 17), dtype=torch.int32), ring)
    odd = kv_cache.init_cache(cfg.num_layers, 1, 20, cfg.num_kv_heads,
                              cfg.head_dim, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        m.apply(params, toks, odd)
    # Model.init_cache rounds the length up to the page
    assert m.init_cache(1, 20, device="cpu")["k"].shape[2] == 32
    assert not paged_kv.is_paged(ring)
