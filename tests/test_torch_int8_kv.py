"""int8 KV caches in the port against ``repro`` on the CPU.

JAX stores an int8 cache as round(x / KV_INT8_SCALE) clamped to
[-128, 127] and reads it dequantized (``kv_cache._to_buf_dtype`` /
``_from_buf``). A Q = 1 call reads the written, quantized buffer; a Q > 1
call on a ring reads [dequantized old buffer ++ its own K/V unquantized]
(``kv_cache.extend``); a paged pool is read quantized at every Q. The port
writes first and reads the ring through the paged reader, with the call's
own K/V overlaid as ``fresh`` (``models.dense.ring_fresh``). Held here:

* a windowed int8 ring that has wrapped: the read with ``fresh`` against
  JAX's concat, and the bf16 kernels' split walk (``ref.paged_split_ref``);
* ``Model.apply`` over int8 rings against JAX's ``m.apply`` on
  ``init_cache(dtype=int8)`` for the dense, MoE, VLM (text) and
  encoder-decoder smoke configs (a prefill, a verify of gamma + 1, a
  decode, and for the dense family a chain_tree(2, 4) span), logits and
  the int8 cache bytes; over an int8 paged cache likewise;
* greedy generation over an int8 ring agrees with the float cache (JAX's
  ``test_int8_kv_cache_generation_agrees``) and equals JAX's tokens;
* ``paged_split_ref`` over an int8 pool, with and without ``fresh``, bit
  for bit the float split over the dequantized pool with ``fresh`` written
  in (the kernel's exactness, emulated), and within the bf16 tolerance of
  ``attn_paged``;
* ``attn_block`` passes ``fresh`` exactly for an int8 ring at Q > 1;
* what the kernel wrappers accept on the card (int8 pools, ``fresh``) and
  the kernel's scale against ``KV_INT8_SCALE``.

Tolerances: logits at fp32 atol 1e-4, rtol 1e-5; attention at 1e-5; the
split walk in bf16 at chip_smoke's 1e-2 + 1e-2 |x|; the int8 cache bytes
exactly (the K/V the two sides quantize differ by far less than a step of
0.05, and none of these seeds puts one at a rounding boundary)."""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.cache import kv_cache as jax_kv  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core.tree import chain_tree as jax_chain_tree  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import kv_cache  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.engine import autoregressive_generate  # noqa: E402
from repro_torch.core.tree import chain_tree  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention, dense  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
ATT_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FAMILIES = {"dense": "llama3.2-1b", "moe": "mixtral-8x7b",
            "vlm": "internvl2-26b", "encdec": "whisper-large-v3"}
B, MAX_LEN = 2, 32
PROMPT, GAMMA = 12, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# --------------------------------------------------- the read, a wrapped ring
@jax.jit
def _jax_concat_read(k_buf, v_buf, k_new, v_new, index, q):
    """JAX's ring read of a call: attention over [old buffer ++ new] at
    ``slot_positions`` (``kv_cache.extend``), window 16."""
    k_all, v_all, kv_pos, _ = jax_kv.extend({"k": k_buf, "v": v_buf}, k_new,
                                            v_new, index)
    q_pos = index[..., None] + jnp.arange(q.shape[1], dtype=jnp.int32)
    return jax_attn.attention(q, k_all, v_all, q_pos, kv_pos, window=16)


@pytest.mark.parametrize("index", [70, (70, 45)], ids=["shared", "per_row"])
@pytest.mark.parametrize("q_len", [1, 5, 16])
def test_wrapped_int8_ring_read_matches_jax_concat(index, q_len):
    """An int8 ring of 32 slots, window 16, rows past two wraps: the write,
    then the read through the table over positions with ``ring_fresh``'s
    K/V == JAX's concat read over ``slot_positions`` (the old buffer
    dequantized, the call's K/V unquantized at Q > 1), and so does the
    split walk (8-key chunks). Q 16 is the most a 32-slot ring takes
    without evicting a key inside the window (W - window + 1 = 17)."""
    W, window, positions, Kv, D, H, nb = 32, 16, 96, 2, 8, 4, 2
    rng = np.random.default_rng(q_len)
    buf = {n: _int8(rng, (nb, W, Kv, D)) for n in "kv"}
    k_new, v_new = (rng.standard_normal((nb, q_len, Kv, D)).astype(np.float32)
                    for _ in "kv")
    q = rng.standard_normal((nb, q_len, H, D)).astype(np.float32)
    idx = np.asarray(index, np.int32)
    want = np.asarray(_jax_concat_read(buf["k"], buf["v"], k_new, v_new, idx, q))
    lc = {n: _t(a) for n, a in buf.items()}
    fresh = dense.ring_fresh(lc, _t(k_new), _t(v_new))
    assert (fresh is None) == (q_len == 1)
    kv_cache.write(lc["k"], lc["v"], _t(k_new), _t(v_new), _t(idx))
    table = dense.ring_view_table(nb, W, "cpu", positions)
    kp, vp = dense.ring_view(lc["k"]), dense.ring_view(lc["v"])
    got = attention.attention_paged(_t(q), kp, vp, table, _t(idx),
                                    window=window, fresh=fresh)
    np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)
    split = ref.paged_split_ref(_t(q), kp, vp, table, _t(idx), window=window,
                                chunk=8, fresh=fresh)
    np.testing.assert_allclose(split.numpy(), want, **ATT_TOL)


# ------------------------------------------------------ Model.apply over rings
def _family(family, seed=3):
    """JAX's and the port's smoke model of ``family`` on one set of seeded
    numpy weights of JAX's tree (every leaf of these families is a norm
    ``scale``, set to 1, an embedding ``table``, normal, or a weight ``w``,
    normal over sqrt(fan_in)): made in numpy, they skip JAX's init."""
    jcfg = jax_registry.smoke_config(FAMILIES[family])
    cfg = registry.smoke_config(FAMILIES[family])
    jm, m = jax_build(jcfg), build_model(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        std = 1.0 if name == "table" else s.shape[-2] ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    return jm, m, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_numpy(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def families():
    return {f: _family(f) for f in FAMILIES}


def _jax_kv(jcache, name):
    """JAX's int8 K or V as the port's flat [L, B, W, Kv, D]: a MoE cache's
    block kinds interleaved in forward order (layer i * per + j is JAX's
    ``dense{j}[i]``, the last kind ``moe[i]``)."""
    if "blocks" not in jcache:
        return np.asarray(jcache[name])
    blocks = jcache["blocks"]
    kinds = sorted(k for k in blocks if k != "moe") + ["moe"]
    stacks = [np.asarray(blocks[k][name]) for k in kinds]
    return np.stack(stacks, axis=1).reshape((-1,) + stacks[0].shape[1:])


def _check_bytes(tcache, jcache, n_pos):
    """The port's int8 K/V at positions 0..n_pos-1 equal JAX's (neither
    ring has wrapped)."""
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.int8
        np.testing.assert_array_equal(tcache[name][:, :, :n_pos].numpy(),
                                      _jax_kv(jcache, name)[:, :, :n_pos])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_apply_over_int8_rings_matches_jax(families, family):
    """A prefill of 12, a verify of gamma + 1, a decode step and (dense) a
    chain_tree(2, 4) span over int8 rings from ``init_cache(dtype=int8)``:
    logits against JAX's at each step, the int8 bytes at the end."""
    jm, m, jp, tp = families[family]
    cfg = m.cfg
    rng = np.random.default_rng(17)
    jc = jm.init_cache(B, MAX_LEN, dtype=jnp.int8)
    tc = m.init_cache(B, MAX_LEN, dtype=torch.int8, device="cpu")
    assert tc["k"].dtype == torch.int8
    jkw, tkw = {}, {}
    if family == "encdec":
        frames = rng.standard_normal(m.extra_inputs(B)["frames"][0]).astype(np.float32)
        jkw, tkw = {"frames": jnp.asarray(frames)}, {"frames": _t(frames)}
    japply = jax.jit(jm.apply, static_argnames=("logits_slice",))
    tree = chain_tree(2, 4)
    jtree = jax_chain_tree(2, 4)
    steps = [(PROMPT, None), (GAMMA + 1, None), (1, "last")]
    if family == "dense":
        steps.append((tree.span, "tree"))
    n = 0
    for Q, how in steps:
        toks = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
        extra_j, extra_t = dict(jkw), dict(tkw)
        if how == "tree":
            extra_j["tree"] = (jnp.asarray(jtree.depths), jnp.asarray(jtree.bits))
            extra_t["tree"] = (tree.depths, tree.bits)
        sl = "last" if how == "last" else None
        jl, jc, jaux = japply(jp, jnp.asarray(toks), jc, logits_slice=sl, **extra_j)
        tl, tc, taux = m.apply(tp, _t(toks), tc, logits_slice=sl, **extra_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        if family == "encdec":          # the cross K/V from the first call on
            jkw, tkw = {"cross": jaux["cross"]}, {"cross": taux["cross"]}
        n += Q
        assert int(tc["index"]) == int(jc["index"]) == n
    _check_bytes(tc, jc, n)


def test_apply_over_an_int8_paged_cache_matches_jax(families):
    """The dense smoke over ``init_paged_cache(dtype=int8)`` with one table:
    a ragged prefill, a verify of gamma + 1 and a decode step, each read
    quantized as JAX reads a pool; logits and pool bytes."""
    jm, m, jp, tp = families["dense"]
    NB, BS, MB = 24, 4, 8
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        table[b] = np.arange(1 + b * MB, 1 + (b + 1) * MB)
    jc = {**jm.init_paged_cache(B, NB, BS, MB, dtype=jnp.int8),
          "block_table": jnp.asarray(table)}
    tc = {**m.init_paged_cache(B, NB, BS, MB, dtype=torch.int8, device="cpu"),
          "block_table": _t(table)}
    japply = jax.jit(jm.apply, static_argnames=("logits_slice",))
    rng = np.random.default_rng(23)
    for Q in (7, GAMMA + 1, 1):
        toks = rng.integers(0, m.cfg.vocab_size, (B, Q)).astype(np.int32)
        jl, jc, _ = japply(jp, jnp.asarray(toks), jc)
        tl, tc, _ = m.apply(tp, _t(toks), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def test_int8_ring_generation_agrees_with_the_float_cache(families):
    """JAX's ``test_int8_kv_cache_generation_agrees`` on the port: greedy
    decoding of 10 tokens after a 5-token prompt over an int8 ring agrees
    with float-cache AR on at least 9, and gives JAX's int8 tokens."""
    jm, m, jp, tp = families["dense"]
    prompt = np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (1, 5)).astype(np.int32)
    want = autoregressive_generate(m, tp, _t(prompt), 10, use_cache=True)
    toks, jtoks = [], []
    cache = m.init_cache(1, 20, spec_slack=2, dtype=torch.int8, device="cpu")
    jcache = jm.init_cache(1, 20, spec_slack=2, dtype=jnp.int8)
    japply = jax.jit(jm.apply, static_argnames=("logits_slice",))
    t, jt_ = _t(prompt), jnp.asarray(prompt)
    for _ in range(10):
        lg, cache, _ = m.apply(tp, t, cache, logits_slice="last")
        jlg, jcache, _ = japply(jp, jt_, jcache, logits_slice="last")
        toks.append(int(torch.argmax(lg[0, -1])))
        jtoks.append(int(jnp.argmax(jlg[0, -1])))
        t, jt_ = _t([[toks[-1]]]), jnp.asarray([[jtoks[-1]]])
    assert toks == jtoks
    agree = np.mean(np.asarray(toks) == want[0, 5:15].numpy())
    assert agree >= 0.9, (toks, want[0, 5:15])


# ----------------------------------------------- the kernels' split, emulated
def _split_case(dtype, Q, seed=5):
    """An int8 pool, a table with distinct blocks per row, ragged indices,
    q and fresh K/V of ``dtype``, and the float pool the kernel's exactness
    names: ``_from_buf`` of the int8 pool with fresh written at
    index..index+Q-1 through the table."""
    NB, BS, Kv, D, H, MB = 40, 16, 2, 32, 4, 6
    rng = np.random.default_rng(seed)
    idx = np.asarray([37, 70, 11], np.int32)
    nb = idx.size
    table = (1 + rng.permutation(NB - 1)[:nb * MB]).reshape(nb, MB).astype(np.int32)
    pool = {n: _t(_int8(rng, (NB, BS, Kv, D))) for n in "kv"}
    q = _t(rng.standard_normal((nb, Q, H, D)).astype(np.float32)).to(dtype)
    fresh = tuple(_t(rng.standard_normal((nb, Q, Kv, D)).astype(np.float32)).to(dtype)
                  for _ in "kv")
    written = {n: kv_cache._from_buf(pool[n], dtype).clone() for n in "kv"}
    for b in range(nb):
        for i in range(Q):
            p = int(idx[b]) + i
            blk = int(table[b, p // BS])
            for n, f in zip("kv", fresh):
                written[n][blk, p % BS] = f[b, i]
    return q, pool, fresh, written, _t(table), _t(idx)


@pytest.mark.parametrize("tree", [False, True], ids=["causal", "tree"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_split_ref_over_an_int8_pool_is_the_float_split(dtype, tree):
    """``paged_split_ref`` over an int8 pool (Q 5, with and without fresh;
    chain_tree(2, 4) with fresh) == the float split over the dequantized
    pool (fresh written in), bit for bit, in both p modes; and within the
    bf16 tolerance of the plain readers."""
    shape = chain_tree(2, 4)
    Q = shape.span if tree else GAMMA + 1
    q, pool, fresh, written, table, idx = _split_case(dtype, Q)
    kw = dict(depths=shape.depths, bits=shape.bits) if tree else {}
    tol = BF16_TOL if dtype == torch.bfloat16 else ATT_TOL
    for p_bf16 in (True, False):
        got = ref.paged_split_ref(q, pool["k"], pool["v"], table, idx, chunk=16,
                                  p_bf16=p_bf16, fresh=fresh, **kw)
        want = ref.paged_split_ref(q, written["k"], written["v"], table, idx,
                                   chunk=16, p_bf16=p_bf16, **kw)
        assert torch.equal(got, want)
    if tree:
        plain = attention.attn_tree(q, pool["k"], pool["v"], table, idx,
                                    shape.depths, shape.bits, fresh=fresh)
    else:
        plain = attention.attn_paged(q, pool["k"], pool["v"], table, idx,
                                     fresh=fresh)
        bare = ref.paged_split_ref(q, pool["k"], pool["v"], table, idx, chunk=16)
        deq = {n: kv_cache._from_buf(pool[n], dtype) for n in "kv"}
        assert torch.equal(bare, ref.paged_split_ref(q, deq["k"], deq["v"],
                                                     table, idx, chunk=16))
        np.testing.assert_allclose(
            bare.float().numpy(),
            attention.attn_paged(q, pool["k"], pool["v"], table, idx).float().numpy(),
            **tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **tol)


# --------------------------------------------------------- where fresh is given
def test_attn_block_passes_fresh_only_for_an_int8_ring_above_q1(families,
                                                               monkeypatch):
    """Spying the dense readers: ``fresh`` is the call's K/V exactly on an
    int8 ring at Q > 1 (a prefill, a verify, a tree span), never at Q = 1,
    on a float ring or on an int8 paged pool."""
    _, m, _, tp = families["dense"]
    seen = []

    def spy(real):
        def read(*a, fresh=None, **kw):
            seen.append(fresh is not None and fresh[0].shape[1] == a[0].shape[1])
            return real(*a, fresh=fresh, **kw)
        return read
    monkeypatch.setattr(dense, "attention_paged", spy(dense.attention_paged))
    monkeypatch.setattr(dense, "attention_tree", spy(dense.attention_tree))
    L = m.cfg.num_layers
    tree = chain_tree(2, 4)

    def run(cache, Q, **kw):
        seen.clear()
        toks = torch.zeros((1, Q), dtype=torch.int32)
        _, cache, _ = m.apply(tp, toks, cache, **kw)
        assert len(seen) == L
        return cache, set(seen)
    ring = m.init_cache(1, MAX_LEN, dtype=torch.int8, device="cpu")
    ring, got = run(ring, 6)
    assert got == {True}
    ring, got = run(ring, 1)
    assert got == {False}
    ring, got = run(ring, tree.span, tree=(tree.depths, tree.bits))
    assert got == {True}
    _, got = run(m.init_cache(1, MAX_LEN, device="cpu"), 6)
    assert got == {False}
    paged = {**m.init_paged_cache(1, 8, 4, 4, dtype=torch.int8, device="cpu"),
             "block_table": torch.arange(1, 5, dtype=torch.int32)[None]}
    _, got = run(paged, 6)
    assert got == {False}


# ----------------------------------------------------- the wrappers on the card
class _OnCard:
    """What the wrappers' checks read of a CUDA tensor, without a card."""

    def __init__(self, *shape, dtype=torch.bfloat16, contiguous=True):
        self.shape, self.dtype, self._c = shape, dtype, contiguous
        self.device = torch.device("cuda", 0)

    def is_contiguous(self):
        return self._c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrappers_take_an_int8_pool_and_fresh_over_it_only(dtype):
    """Paged and tree checks take an int8 pool under an fp32 or bf16 q; the
    flash kernel's do not; ``fresh`` only over an int8 pool, in q's dtype
    and device, contiguous, [B, Q, Kv, D]."""
    from repro_torch.kernels import tree_attention as ta
    q = _OnCard(2, 5, 8, 64, dtype=dtype)
    pool = _OnCard(16, 16, 2, 64, dtype=torch.int8)
    assert pa.check_args("paged attention", q, pool, pool, None, None,
                         int8_pool=True) is None
    assert pa.check_args("tree attention", q, pool, pool, None, None,
                         head_dims=ta.TREE_HEAD_DIMS, int8_pool=True) is None
    with pytest.raises(TypeError, match="int8"):
        pa.check_args("flash attention", q, pool, pool, None, None)
    with pytest.raises(TypeError, match="or int8"):
        pa.check_args("paged attention", q, _OnCard(16, 16, 2, 64, dtype=torch.float16),
                      pool, None, None, int8_pool=True)
    fresh = _OnCard(2, 5, 2, 64, dtype=dtype)
    assert pa.check_fresh("paged attention", q, pool, (fresh, fresh)) is None
    assert pa.check_fresh("paged attention", q, pool, None) is None
    with pytest.raises(TypeError, match="only over an int8 pool"):
        pa.check_fresh("paged attention", q, _OnCard(16, 16, 2, 64, dtype=dtype),
                       (fresh, fresh))
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for bad, err in ((_OnCard(2, 5, 2, 64, dtype=other), TypeError),
                     (_OnCard(2, 4, 2, 64, dtype=dtype), ValueError),
                     (_OnCard(2, 5, 2, 64, dtype=dtype, contiguous=False), ValueError)):
        with pytest.raises(err):
            pa.check_fresh("paged attention", q, pool, (fresh, bad))


def test_the_kernel_dequantizes_by_kv_int8_scale():
    """``paged_attention.cu``'s scale is ``KV_INT8_SCALE``'s fp32 value,
    which ``_from_buf`` multiplies by in fp32; JAX's is the same."""
    src = (pathlib.Path(pa.__file__).parent.parent / "csrc"
           / "paged_attention.cu").read_text()
    scale = re.search(r"kKvInt8Scale = ([0-9.e-]+)f;", src).group(1)
    assert np.float32(scale) == np.float32(kv_cache.KV_INT8_SCALE) \
        == np.float32(jax_kv.KV_INT8_SCALE)
    x = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    np.testing.assert_array_equal(
        kv_cache._from_buf(x, torch.float32).numpy(),
        x.numpy().astype(np.float32) * np.float32(scale))
