"""Port parity for the hybrid family (RecurrentGemma: RG-LRU units and local
attention) against ``repro.models.hybrid`` on the ``recurrentgemma-2b``
smoke config (fp32, 5 layers = one (rec, rec, attn) block + 2 tail rec
units, local window 16): ``rglru`` at Q = 1 (JAX's fused step) and Q > 1
(the port's log-step scan against ``lax.associative_scan``), from a zero
and a nonzero state, with trails; ``rec_unit`` with the conv cache and
trails; a windowed ``attn_unit`` over a ring that wraps; the no-cache
forward, a cached prefill + decode, and a verify with ``want_trail`` +
``rollback``; ``init``'s fixed ``lam``; and the bridge for layouts with
and without a tail. Caches are compared through the mapping of JAX's
nested cache (``blocks["u{j}_{kind}"]`` stacked over blocks, then
``tail``) onto the port's flat stacks in forward order.

Logits and unit outputs are held to fp32 atol = 1e-4, rtol = 1e-5 (XLA
and PyTorch sum the projections in other orders, and the scan associates
its products in another order); the scan alone to 1e-5."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.cache import kv_cache as jax_kv_cache  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import hybrid as jax_hybrid  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import dense, hybrid  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = dict(atol=1e-4, rtol=1e-5)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
SLACK = 6                     # gamma 4 + 2, the engines' ring slack


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    return (jax_registry.smoke_config(ARCH).replace(**kw),
            registry.smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    jm = jax_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # JAX's forward jitted (eager JAX is slow): one compile per call shape
    japply = jax.jit(jm.apply, static_argnames=("want_trail", "logits_slice"))
    return {"jax": (jm, jp), "japply": japply,
            "torch": (build_model(cfg), params_from_numpy(cfg, _to_np(jp), "cpu")),
            "cfg": (jcfg, cfg)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(jcache, cfg):
    """JAX's nested hybrid cache as the port's flat leaves: state/conv
    (and trails) stacked over the rec units, k/v over the attn units, in
    forward order."""
    n_blocks, pat, tail = jax_hybrid.layout(cfg)
    units = [(jcache["blocks"][f"u{j}_{kind}"], i, kind)
             for i in range(n_blocks) for j, kind in enumerate(pat)]
    units += [(uc, None, kind) for uc, kind in zip(jcache["tail"], tail)]
    out = {}
    for uc, i, kind in units:
        for name, leaf in uc.items():
            leaf = np.asarray(leaf if i is None else leaf[i])
            out.setdefault(name, []).append(leaf)
    return {k: np.stack(v) for k, v in out.items()}


def _check_rec_leaves(cache, jcache, cfg, names=("state", "conv")):
    flat = _flat(jcache, cfg)
    for name in names:
        np.testing.assert_allclose(cache[name].numpy(), flat[name], **TOL)


def _check_ring(cache, jcache, cfg, last, span):
    """The K/V of positions last - span .. last - 1 in both rings: each
    ring holds position p at slot p mod its own length."""
    flat = _flat(jcache, cfg)
    for name in ("k", "v"):
        W, Wj = cache[name].shape[2], flat[name].shape[2]
        pos = np.arange(last - span, last)
        np.testing.assert_allclose(cache[name].numpy()[:, :, pos % W],
                                   flat[name][:, :, pos % Wj], **TOL)


def _tokens(n, length, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, length)).astype(np.int32)


# ------------------------------------------------------------- config, init
def test_registry_holds_the_hybrid_config_equal_to_jaxs():
    for fn in ("config", "drafter_config", "smoke_config"):
        got = getattr(registry, fn)(ARCH)
        want = getattr(jax_registry, fn)(ARCH)
        assert got.family == "hybrid" and got.name == want.name
        assert got.block_pattern == want.block_pattern
        assert (got.lru_width, got.local_window, got.head_dim) == \
            (want.lru_width, want.local_window, want.head_dim)
    t, d = registry.config(ARCH), registry.drafter_config(ARCH)
    assert hybrid.kinds(t) == ("rec", "rec", "attn") * 8 + ("rec", "rec")
    assert hybrid.n_attn(t) == 8 and hybrid.n_attn(d) == 2
    assert (t.head_dim, d.head_dim, t.num_kv_heads, d.num_kv_heads) == (256, 256, 1, 1)


def test_init_lam_is_jaxs_and_fp32_under_bf16(model):
    """``lam`` is the fixed fp32 decay init (griffin practice) whatever the
    param dtype (JAX's is fp32 at any dtype); the port's is JAX's to 4e-6
    relative (torch and XLA each compute linspace on their own, and expm1
    of a small -log(0.999) / 8 magnifies the last bit), the other leaves
    take the config's dtype and JAX's shapes."""
    _, cfg = _configs(dtype="bfloat16", param_dtype="bfloat16")
    jp = model["jax"][1]
    p = build_model(cfg).init(0, "cpu")
    jlam = np.asarray(jp["blocks"]["u0_rec"]["mix"]["lam"][0])
    lam = p["layers"][0]["mix"]["lam"]
    assert lam.dtype == torch.float32 and jlam.dtype == np.float32
    np.testing.assert_allclose(lam.numpy(), jlam, rtol=1e-5, atol=0)
    assert p["layers"][0]["mix"]["gate_r"]["w"].dtype == torch.bfloat16
    flat_jax = [jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][k])
                for k in ("u0_rec", "u1_rec", "u2_attn")] + list(jp["tail"])
    for lp, jlp in zip(p["layers"], flat_jax, strict=True):
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jlp)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), lp,
                                      is_leaf=torch.is_tensor) == shapes


@pytest.mark.parametrize("layers", [5, 6, 4])
def test_bridge_maps_blocks_and_tail_in_forward_order(layers):
    """5 layers: one block + a tail of two rec units; 6: two blocks, no
    tail; 4: one block + one. The port's unit i holds JAX's block leaf or
    tail unit that runs i-th, ``lam`` stays fp32 under bf16."""
    jcfg, cfg = _configs(num_layers=layers, dtype="bfloat16",
                         param_dtype="bfloat16")
    jp = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(2))
    p = params_from_numpy(cfg, _to_np(jp), "cpu")
    n_blocks, pat, tail = jax_hybrid.layout(jcfg)
    assert ("tail" in jp) == bool(tail)
    want = [(jp["blocks"][f"u{j}_{kind}"], i) for i in range(n_blocks)
            for j, kind in enumerate(pat)]
    want += [(u, None) for u in jp.get("tail", [])]
    assert len(p["layers"]) == layers
    for lp, (jlp, i) in zip(p["layers"], want, strict=True):
        leaves = jax.tree_util.tree_leaves_with_path(jlp)
        for path, leaf in leaves:
            got = lp
            for key in path:
                got = got[key.key]
            leaf = np.asarray(leaf if i is None else leaf[i], np.float32)
            np.testing.assert_array_equal(got.float().numpy(), leaf)
            assert got.dtype == (torch.float32 if path[-1].key == "lam"
                                 else torch.bfloat16)
    assert p["embed"]["table_f32"].dtype == torch.float32
    with pytest.raises(ValueError, match="blocks"):
        params_from_numpy(cfg.replace(num_layers=layers + 3), _to_np(jp), "cpu")


def test_full_width_pair_is_the_registered_one():
    """The registered pair's unit shapes (built on the meta device)."""
    t, d = registry.config(ARCH), registry.drafter_config(ARCH)
    p = hybrid.init(d.replace(num_layers=3), torch.Generator().manual_seed(0), "meta")
    rec, att = p["layers"][0]["mix"], p["layers"][2]["mix"]
    assert tuple(rec["gate_r"]["w"].shape) == (1024, 1024)
    assert tuple(att["q"]["w"].shape) == (1024, 4 * 256)
    assert tuple(att["k"]["w"].shape) == (1024, 256)
    assert (t.num_layers, t.d_model, t.lru_width, t.vocab_size) == (26, 2560, 2560, 256000)


# ------------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("want_trail", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("Q", [1, 5, 13])
def test_rglru_matches_jax(model, Q, with_state, want_trail):
    jp = model["jax"][1]["blocks"]["u0_rec"]["mix"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jp)
    p = model["torch"][1]["layers"][0]["mix"]
    rng = np.random.default_rng(Q * 10 + with_state)
    u = rng.standard_normal((2, Q, 128)).astype(np.float32)
    state = rng.standard_normal((2, 128)).astype(np.float32) if with_state else None
    y, final, trail = hybrid.rglru(p, _t(u), None if state is None else _t(state),
                                   want_trail)
    jy, jfinal, jtrail = jax_hybrid.rglru(
        jp, jnp.asarray(u), None if state is None else jnp.asarray(state), want_trail)
    assert y.dtype == final.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **SCAN_TOL)
    assert (trail is None) == (jtrail is None) == (not want_trail)
    if want_trail:
        np.testing.assert_allclose(trail.numpy(), np.asarray(jtrail), **SCAN_TOL)


def test_scan_rows_do_not_depend_on_the_length(model):
    """Position t of the log-step scan is a function of positions 0..t
    only: the rows a T = 128 call shares with a T = 134 call are
    bit-equal (the no-cache buffer's rows do not change with T)."""
    p = model["torch"][1]["layers"][0]["mix"]
    u = _t(np.random.default_rng(5).standard_normal((2, 134, 128)).astype(np.float32))
    long, _, _ = hybrid.rglru(p, u, None, False)
    short, _, _ = hybrid.rglru(p, u[:, :128], None, False)
    assert torch.equal(long[:, :128], short)


@pytest.mark.parametrize("want_trail", [False, True])
@pytest.mark.parametrize("Q", [1, 5])
def test_rec_unit_with_conv_cache_and_trails_matches_jax(model, Q, want_trail):
    jcfg, cfg = model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"][1]["blocks"]["u1_rec"])
    p = model["torch"][1]["layers"][1]
    rng = np.random.default_rng(Q)
    x = rng.standard_normal((2, Q, 128)).astype(np.float32)
    lc = {"state": rng.standard_normal((2, 128)).astype(np.float32),
          "conv": rng.standard_normal((2, 3, 128)).astype(np.float32)}
    out, new = hybrid.rec_unit(cfg, p, _t(x), {k: _t(v) for k, v in lc.items()},
                               want_trail)
    jout, jnew = jax_hybrid.rec_unit(jcfg, jp, jnp.asarray(x),
                                     {k: jnp.asarray(v) for k, v in lc.items()},
                                     want_trail)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert set(new) == set(jnew)
    for k in new:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), **TOL)
    no_cache, _ = hybrid.rec_unit(cfg, p, _t(x), None, False)
    jno, _ = jax_hybrid.rec_unit(jcfg, jp, jnp.asarray(x), None, False)
    np.testing.assert_allclose(no_cache.numpy(), np.asarray(jno), **TOL)


def test_windowed_attn_unit_over_a_wrapping_ring_matches_jax(model):
    """The attention unit (window 16) over a ring that wraps: a 20-token
    prefill, then calls of 5, 1 and 5 tokens up to position 51, past the
    port's 32-slot ring and JAX's 22-slot one. Each call's output is
    JAX's; the last 16 positions' K/V are JAX's."""
    jcfg, cfg = model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"][1]["blocks"]["u2_attn"])
    p = model["torch"][1]["layers"][2]
    max_len = 64
    ring = build_model(cfg)._ring(1, 2, max_len, cfg.local_window + SLACK,
                                  torch.float32, "cpu")
    Wj = jax_kv_cache.buffer_len(max_len, jcfg.local_window + SLACK)
    junit = jax.jit(functools.partial(jax_hybrid.attn_unit, jcfg))
    jring = {n: jnp.zeros((2, Wj, 1, 64), jnp.float32) for n in "kv"}
    assert (ring["k"].shape[2], Wj, ring["positions"]) == (32, 22, 64)
    rng = np.random.default_rng(9)
    index = 0
    for Q in (20, 5, 1, 5, 5, 5, 5, 5):
        x = rng.standard_normal((2, Q, 128)).astype(np.float32)
        ring["index"] = torch.tensor(index, dtype=torch.int32)
        mode, table = dense.ring_read(cfg.local_window, ring, Q)
        q_pos = ring["index"] + torch.arange(Q, dtype=torch.int32)
        ps = dense.Pass(q_pos, ring["index"], table, None, None, mode)
        out = hybrid.attn_unit(cfg, p, _t(x), dense.layer_cache(ring, 0), ps)
        jidx = jnp.asarray(index, jnp.int32)
        jout, jring = junit(jp, jnp.asarray(x), jidx +
                            jnp.arange(Q, dtype=jnp.int32), jring, jidx)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        index += Q
    assert index == 51 and index > max(ring["k"].shape[2], Wj)
    pos = np.arange(index - 16, index)
    for n in "kv":
        np.testing.assert_allclose(ring[n][0].numpy()[:, pos % 32],
                                   np.asarray(jring[n])[:, pos % Wj], **TOL)


# ------------------------------------------------------------------- forward
@pytest.mark.parametrize("T", [9, 40])
def test_nocache_forward_matches_jax(model, T):
    jp, japply = model["jax"][1], model["japply"]
    m, p = model["torch"]
    toks = _tokens(2, T, seed=T)
    logits, cache, aux = m.apply(p, _t(toks))
    jlogits, _, _ = japply(jp, jnp.asarray(toks))
    assert cache is None and aux == {} and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_cached_prefill_and_decode_match_jax(model):
    """A 24-token prefill, then 20 decode steps: every step's logits, the
    recurrent caches and the ring (the last window of positions) are
    JAX's; the port's ring is 32 slots (16 + 6 rounded up to the page),
    JAX's 22, and both wrap."""
    (jm, jp), japply = model["jax"], model["japply"]
    m, p = model["torch"]
    jcfg, cfg = model["cfg"]
    toks = _tokens(2, 44, seed=4)
    cache = m.init_cache(2, 64, SLACK, device="cpu")
    jcache = jm.init_cache(2, 64, SLACK, jnp.float32)
    assert set(cache) == {"state", "conv", "k", "v", "index", "positions"}
    assert tuple(cache["state"].shape) == (4, 2, 128)
    assert tuple(cache["conv"].shape) == (4, 2, 3, 128)
    assert tuple(cache["k"].shape) == (1, 2, 32, 1, 64)
    logits, cache, _ = m.apply(p, _t(toks[:, :24]), cache)
    jlogits, jcache, _ = japply(jp, jnp.asarray(toks[:, :24]), jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for t in range(24, 44):
        logits, cache, _ = m.apply(p, _t(toks[:, t:t + 1]), cache,
                                   logits_slice="last")
        jlogits, jcache, _ = japply(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                                    logits_slice="last")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert int(cache["index"]) == int(jcache["index"]) == 44
    _check_rec_leaves(cache, jcache, jcfg)
    _check_ring(cache, jcache, jcfg, 44, cfg.local_window)


@pytest.mark.parametrize("accepted", [0, 2, 5])
def test_verify_with_trails_and_rollback_match_jax(model, accepted):
    """A 12-token prefill, a Q = 5 verify with ``want_trail``, a rollback to
    index 12 + accepted, then two decode steps: the trails, the rolled-back
    caches and the next logits are JAX's."""
    (jm, jp), japply = model["jax"], model["japply"]
    m, p = model["torch"]
    jcfg, _ = model["cfg"]
    toks = _tokens(2, 19, seed=accepted)
    cache = m.init_cache(2, 32, SLACK, device="cpu")
    jcache = jm.init_cache(2, 32, SLACK, jnp.float32)
    _, cache, _ = m.apply(p, _t(toks[:, :12]), cache)
    _, jcache, _ = japply(jp, jnp.asarray(toks[:, :12]), jcache)
    logits, cache, _ = m.apply(p, _t(toks[:, 12:17]), cache, want_trail=True)
    jlogits, jcache, _ = japply(jp, jnp.asarray(toks[:, 12:17]), jcache,
                                want_trail=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _check_rec_leaves(cache, jcache, jcfg, ("state", "conv", "state_trail",
                                            "conv_trail"))
    acc = torch.tensor(12 + accepted, dtype=torch.int32)
    cache = m.rollback(cache, acc, 5)
    jcache = jm.rollback(jcache, jnp.asarray(12 + accepted, jnp.int32), 5)
    assert set(cache) == {"state", "conv", "k", "v", "index"}
    assert int(cache["index"]) == int(jcache["index"]) == 12 + accepted
    _check_rec_leaves(cache, jcache, jcfg)
    nxt = 12 + accepted
    for t in range(nxt, nxt + 2):
        logits, cache, _ = m.apply(p, _t(toks[:, t:t + 1]), cache)
        jlogits, jcache, _ = japply(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_state_cache_keeps_the_activation_dtype_as_jax():
    """Under bf16 the state, conv and ring caches and the trails are bf16,
    as JAX's are; the rollback selects the trail's entry unchanged."""
    jcfg, cfg = _configs(dtype="bfloat16", param_dtype="bfloat16")
    m = build_model(cfg)
    cache = m.init_cache(2, 16, device="cpu")
    flat = _flat(jax_build(jcfg).init_cache(2, 16), jcfg)
    for name in ("state", "conv", "k", "v"):
        assert cache[name].dtype == torch.bfloat16
        assert str(flat[name].dtype) == "bfloat16"
        assert tuple(cache[name].shape)[:2] == flat[name].shape[:2]
    p = m.init(0, "cpu")
    _, new, _ = m.apply(p, _t(_tokens(2, 5, seed=2)), cache, want_trail=True)
    assert new["state"].dtype == new["state_trail"].dtype == torch.bfloat16
    rolled = m.rollback(new, torch.tensor(3, dtype=torch.int32), 5)
    assert torch.equal(rolled["state"], new["state_trail"][:, :, 2])
    assert torch.equal(rolled["conv"], new["conv_trail"][:, :, 2])


def test_hybrid_has_no_paged_cache_and_no_tree_pass(model):
    m, p = model["torch"]
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        m.init_paged_cache(2, 8, 4, 4, device="cpu")
    cache = m.init_cache(1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        m.apply(p, _t(_tokens(1, 3, 0)), cache,
                tree=(np.zeros(3, np.int32), np.ones(3, np.int32)))
