"""Port parity for windowed ring KV caches that wrap, against ``repro``:
the read itself (the engines over such rings are in
tests/test_torch_windowed_engines.py).

A windowed dense config's ring holds window + slack slots (JAX's
``Model._kv_window``; the port rounds it up to the 16-slot page) and wraps.
The port writes a call's tokens first and reads the ring through the paged
kernel's plain version over a table over positions (``models.dense``); a
prefill from index 0 longer than the ring runs windowed causal attention
over its own tokens. Held here:

* JAX's ``test_spec_slack_protects_window`` replayed on the port, and a
  longer version whose ring wraps twice; without the slack the same calls
  raise;
* the wrap-aware read against ``kv_cache.extend`` + dense attention, and
  the bf16 kernel's chunk walk (``kernels.ref.paged_split_ref``), where
  the chunks wholly before the window are all masked;
* a prefill longer than the ring (the ``llama3.2-1b`` smoke with
  ``sliding_window=16``), logits against JAX's;
* a call that would evict an in-window key raises.

Logits compare at fp32 atol=1e-4, rtol=1e-5, attention at 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread, windowed_pair  # noqa: E402
from repro.cache import kv_cache as jax_kv  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import dense as jax_dense  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import kv_cache  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention, dense  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

WINDOW = 16
GAMMA = 4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
ATT_TOL = dict(atol=1e-5, rtol=1e-5)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return windowed_pair(WINDOW)


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


# ------------------------------------------------------- the slack, replayed
def _slack_cfgs():
    kw = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=1, d_ff=64, vocab_size=31, dtype="float32",
              param_dtype="float32")
    return JaxConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("window", [4, 16])
def test_spec_slack_protects_window(window):
    """JAX's test (``tests/test_attention_cache.py``) on the port, with the
    window it uses (4: the port's page-rounded ring never wraps on its 12
    tokens) and with 16 over 80 tokens, where the ring of 16 + gamma + 1
    slots (32) wraps twice: prefill, then rounds that extend gamma + 1
    tokens and keep one, each checked against the no-cache pass."""
    jcfg, cfg = _slack_cfgs()
    jcfg, cfg = (c.replace(sliding_window=window) for c in (jcfg, cfg))
    jp = jax_dense.init(jcfg, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg, _to_np(jp), "cpu")
    n = 12 if window == 4 else 80
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, n), 0, 31))
    m = build_model(cfg)
    full, _, _ = m.apply(pt, torch.from_numpy(toks))
    gamma = 3
    cache = m.init_cache(1, n, spec_slack=gamma + 1, device="cpu")
    _, cache, _ = m.apply(pt, torch.from_numpy(toks[:, :6]), cache)
    pos = 6
    while pos + gamma + 1 <= n:
        _, c2, _ = m.apply(pt, torch.from_numpy(toks[:, pos:pos + gamma + 1]),
                           cache)
        c2 = kv_cache.rollback(c2, pos + 1)
        lg, cache, _ = m.apply(pt, torch.from_numpy(toks[:, pos + 1:pos + 2]), c2)
        np.testing.assert_allclose(lg[0, 0].numpy(), full[0, pos + 1].numpy(),
                                   **LOGIT_TOL)
        pos += 2
    if window == 16:
        assert cache["k"].shape[2] == 32 and pos > 2 * 32
        # without the slack the ring is the window itself, and the rounds'
        # extend would evict keys still inside it
        bare = m.init_cache(1, n, spec_slack=0, device="cpu")
        assert bare["k"].shape[2] == window
        _, bare, _ = m.apply(pt, torch.from_numpy(toks[:, :window]), bare)
        with pytest.raises(ValueError, match="evict"):
            m.apply(pt, torch.from_numpy(toks[:, window:window + gamma + 1]),
                    bare)


# --------------------------------------------------------- the read itself
def _ring_after(W, window, index, q_len, seed, B=2, Kv=2, D=64, H=4):
    """A [B, W] ring holding positions up to index - 1 (rows written from 0),
    then q_len new tokens: (q, k_new, v_new, ring buffers before the write)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.as_tensor(index, dtype=torch.int32)
    hist = int(idx.max())
    kb = torch.zeros((B, W, Kv, D))
    vb = torch.zeros((B, W, Kv, D))
    k_all = torch.randn((B, hist, Kv, D), generator=g)
    v_all = torch.randn((B, hist, Kv, D), generator=g)
    for b in range(B):
        n = int(idx[b]) if idx.ndim else hist
        kv_cache.write(kb[b:b + 1], vb[b:b + 1], k_all[b:b + 1, :n],
                       v_all[b:b + 1, :n], 0)
    q = torch.randn((B, q_len, H, D), generator=g)
    k_new = torch.randn((B, q_len, Kv, D), generator=g)
    v_new = torch.randn((B, q_len, Kv, D), generator=g)
    return q, k_new, v_new, kb, vb


@pytest.mark.parametrize("index", [70, (70, 45)], ids=["shared", "per_row"])
@pytest.mark.parametrize("q_len", [1, 5])
def test_wrap_aware_read_equals_extend_and_dense_attention(index, q_len):
    """Ring of 32 slots, window 16, rows past two wraps: writing first and
    reading through the table over positions gives what JAX's concat read
    over ``slot_positions`` gives, and so does the bf16 kernel's chunk walk
    (8-key chunks here, so most chunks lie wholly before the window and
    are all masked: their partials combine to nothing)."""
    W, positions = 32, 80
    q, k_new, v_new, kb, vb = _ring_after(W, WINDOW, index, q_len, seed=q_len)
    idx = torch.as_tensor(index, dtype=torch.int32)
    k_cat, v_cat, kv_pos, _ = kv_cache.extend({"k": kb.clone(), "v": vb.clone()},
                                              k_new, v_new, idx)
    q_pos = (idx[..., None] if idx.ndim else idx) + torch.arange(q_len)
    want = attention.attention(q, k_cat, v_cat, q_pos.to(torch.int32), kv_pos,
                               window=WINDOW)
    jk, jv, jpos, _ = jax_kv.extend({"k": jnp.asarray(kb.numpy()),
                                     "v": jnp.asarray(vb.numpy())},
                                    jnp.asarray(k_new.numpy()),
                                    jnp.asarray(v_new.numpy()),
                                    jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(kv_pos.numpy(), np.asarray(jpos))
    kv_cache.write(kb, vb, k_new, v_new, idx)
    table = dense.ring_view_table(q.shape[0], W, "cpu", positions)
    got = attention.attention_paged(q, dense.ring_view(kb), dense.ring_view(vb),
                                    table, idx, window=WINDOW)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATT_TOL)
    split = ref.paged_split_ref(q, dense.ring_view(kb), dense.ring_view(vb),
                                table, idx, window=WINDOW, chunk=8)
    np.testing.assert_allclose(split.numpy(), want.numpy(), **ATT_TOL)
    # the identity view (the table PR 20 read rings through) reads the
    # wrapped slots as old positions
    ident = dense.ring_view_table(q.shape[0], W, "cpu")
    stale = attention.attention_paged(q, dense.ring_view(kb), dense.ring_view(vb),
                                      ident, idx, window=WINDOW)
    assert not np.allclose(stale.numpy(), want.numpy(), **ATT_TOL)


def test_prefill_longer_than_the_ring_matches_jax(pair):
    """A 40-token prefill into a 32-slot ring, then single steps and a
    5-token extend: logits equal JAX's (on its 22-slot ring) and the
    no-cache pass's, and the ring keeps the last 32 positions."""
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    toks = _prompts(2, 52, seed=3)
    jc = jt.init_cache(2, 60, spec_slack=GAMMA + 2)
    tc = mt.init_cache(2, 60, spec_slack=GAMMA + 2, device="cpu")
    assert tc["k"].shape[2] == 32 and jc["k"].shape[2] == WINDOW + GAMMA + 2
    full, _, _ = mt.apply(pt, torch.from_numpy(toks))
    for sl in (slice(0, 40), slice(40, 41), slice(41, 42), slice(42, 47)):
        want, jc, _ = jt.apply(jpt, jnp.asarray(toks[:, sl]), jc)
        got, tc, _ = mt.apply(pt, torch.from_numpy(toks[:, sl]), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        np.testing.assert_allclose(got.numpy(), full[:, sl].numpy(), **LOGIT_TOL)
    assert int(tc["index"]) == 47


def test_a_call_that_would_evict_an_in_window_key_raises(pair):
    mt, _, pt, _ = pair["torch"]
    cache = mt.init_cache(1, 100, spec_slack=GAMMA + 2, device="cpu")
    assert cache["k"].shape[2] == 32 and cache["positions"] == 112
    toks = torch.from_numpy(_prompts(1, 60, seed=5))
    _, cache, _ = mt.apply(pt, toks[:, :20], cache)
    # 17 = 32 - 16 + 1 tokens are exact from any index
    _, cache, _ = mt.apply(pt, toks[:, 20:37], cache)
    with pytest.raises(ValueError, match="evict"):
        mt.apply(pt, toks[:, 37:55], cache)
    with pytest.raises(ValueError, match="evict"):      # no flash at index > 0
        mt.apply(pt, toks[:, :40], cache)
