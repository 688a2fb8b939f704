"""Port parity for the MoE family's whole models (``repro_torch.models.
moe`` through ``models.model``) against ``repro``, at smoke width, fp32.

On ``mixtral-smoke`` (E 4, top-2, window 16) and ``llama4-smoke`` with two
blocks (E 4, top-1, a shared expert, ``moe_every`` 2), from one JAX init
through the bridge (``_serving_parity.moe_pair``): the registry, JAX's
layer count (a one-layer llama4 drafter has no block), the bridge's
forward order against the port's own init, the layer-by-layer int8 init
equal to ``quantize_for_serving(init)``, fake-quant stacked per block
kind, and no-cache, paged and ring logits and aux losses, with KV compared
through the layer mapping (the port's layer i·moe_every + j is JAX's
``dense{j}[i]``, or ``moe[i]`` for the last j). Logits at atol=1e-4,
rtol=1e-5. The MoE MLP itself is in tests/test_torch_moe.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import moe_pair, one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.quant import int8 as jax_q8  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.quant import int8 as q8  # noqa: E402

ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
_JITTED = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _japply(jt, *args):
    """JAX's apply, jitted per model (eager JAX ops are slow)."""
    if id(jt) not in _JITTED:
        _JITTED[id(jt)] = (jt, jax.jit(jt.apply))
    return _JITTED[id(jt)][1](*args)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    blocks = 2 if request.param != "mixtral-8x7b" else None
    return moe_pair(request.param, blocks=blocks)


def test_configs_are_registered():
    for arch in ARCHS:
        for fn in ("config", "drafter_config", "smoke_config"):
            cfg = getattr(registry, fn)(arch)
            assert cfg.family == "moe"
            build_model(cfg)                        # no longer raises
    mx = registry.config("mixtral-8x7b")
    assert (mx.num_experts, mx.num_experts_per_tok, mx.sliding_window) == \
        (8, 2, 4096)
    assert round(mx.param_count() / 1e9, 2) == 46.70
    assert round(mx.active_param_count() / 1e9, 2) == 12.88
    l4 = registry.config("llama4-maverick-400b-a17b")
    assert (l4.moe_every, l4.num_shared_experts) == (2, 1)
    assert round(l4.param_count() / 1e9, 1) == 397.7


def test_layer_count_is_jaxs():
    """``num_layers // moe_every`` blocks: llama4-smoke's one-layer smoke
    drafter (``launch.cli_args.build_pair``) has no block at all."""
    cfg = registry.smoke_config("llama4-maverick-400b-a17b").replace(
        num_layers=1, name="draft")
    jcfg = jax_registry.smoke_config("llama4-maverick-400b-a17b").replace(
        num_layers=1, name="draft")
    m = build_model(cfg)
    p = m.init(0, "cpu")
    assert p["layers"] == [] and moe.n_layers(cfg) == 0
    assert m.init_cache(2, 16, device="cpu")["k"].shape[0] == 0
    toks = np.random.default_rng(0).integers(0, 512, (2, 5)).astype(np.int32)
    jt = jax_build(jcfg)
    jpt = jt.init(jax.random.PRNGKey(1))
    pt = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jpt), "cpu")
    want, _, jaux = _japply(jt, jpt, jnp.asarray(toks))
    got, _, aux = m.apply(pt, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert np.isnan(float(jaux["load_balance"])) and np.isnan(
        float(aux["load_balance"]))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype))


def test_bridge_takes_jaxs_tree_in_forward_order(pair):
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    cfg = mt.cfg
    assert _shapes(pt) == _shapes(mt.init(0, "cpu"))
    m = max(cfg.moe_every, 1)
    for l, lp in enumerate(pt["layers"]):
        i, j = divmod(l, m)
        kind = "moe" if j == m - 1 else f"dense{j}"
        assert ("moe" in lp) == (kind == "moe")
        np.testing.assert_array_equal(
            lp["attn"]["q"]["w"].numpy(),
            np.asarray(jpt["layers"][kind]["attn"]["q"]["w"])[i])
        if kind == "moe":
            np.testing.assert_array_equal(
                lp["moe"]["experts"]["down"]["w"].numpy(),
                np.asarray(jpt["layers"]["moe"]["moe"]["experts"]["down"]["w"])[i])


def test_layer_by_layer_quantized_init_equals_quantized_init(pair):
    mt = pair["torch"][0]
    want = q8.quantize_for_serving(mt.init(3, "cpu"))
    got = q8.init_for_serving(mt, 3, "cpu")
    assert _shapes(got) == _shapes(want)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    lp = got["layers"][-1]["moe"]["experts"]["gate"]
    assert lp["w_q"].dtype == torch.int8
    assert tuple(lp["scale"].shape) == (mt.cfg.num_experts, mt.cfg.d_ff)


def test_nocache_logits_and_aux_match_jax(pair):
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    toks = np.random.default_rng(1).integers(0, 512, (2, 21)).astype(np.int32)
    want, _, jaux = _japply(jt, jpt, jnp.asarray(toks))
    got, cache, aux = mt.apply(pt, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)


def _jax_layer_kv(jc, cfg, name):
    """JAX's cache leaves by block kind, as the port's [L, ...] stack."""
    m = max(cfg.moe_every, 1)
    kinds = [f"dense{j}" for j in range(m - 1)] + ["moe"]
    blocks = jc["blocks"]
    n = np.asarray(blocks["moe"][name]).shape[0]
    return np.stack([np.asarray(blocks[k][name])[i]
                     for i in range(n) for k in kinds])


def test_paged_logits_and_kv_match_jax(pair):
    """A ragged prefill, a Q=4 verify-shaped step and a Q=1 step on paged
    caches; the pools compared through the layer mapping."""
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    cfg = mt.cfg
    B, NB, BS, MB = 3, 24, 4, 8
    table = np.zeros((B, MB), np.int32)
    for b in range(B - 1):
        table[b] = np.arange(1 + b * MB, 1 + (b + 1) * MB)
    jc = {**jt.init_paged_cache(B, NB, BS, MB, dtype=jnp.float32),
          "block_table": jnp.asarray(table)}
    tc = {**mt.init_paged_cache(B, NB, BS, MB, device="cpu"),
          "block_table": torch.from_numpy(table)}
    rng = np.random.default_rng(2)
    for Q, roll in ((7, [5, 7, 2]), (4, [6, 9, 2]), (1, None)):
        toks = rng.integers(0, 512, (B, Q)).astype(np.int32)
        want, jc, _ = _japply(jt, jpt, jnp.asarray(toks), jc)
        got, tc, _ = mt.apply(pt, torch.from_numpy(toks), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       _jax_layer_kv(jc, cfg, name),
                                       atol=1e-5, rtol=1e-5)
        if roll is not None:
            idx = np.asarray(roll, np.int32)
            jc = {**jc, "index": jnp.asarray(idx)}
            tc = {**tc, "index": torch.from_numpy(idx)}


def test_ring_logits_and_kv_match_jax(pair):
    """Ring caches for 48 positions: 34 tokens through a mixtral-smoke
    ring (window 16: 24 slots in JAX, 32 in the port, so it wraps), then
    single steps; KV compared at the positions both rings hold."""
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    cfg = mt.cfg
    B = 2
    jc = jt.init_cache(B, 48)
    tc = mt.init_cache(B, 48, device="cpu")
    toks = np.random.default_rng(3).integers(0, 512, (B, 40)).astype(np.int32)
    for s, e in ((0, 30), (30, 34), (34, 35), (35, 36)):
        want, jc, _ = _japply(jt, jpt, jnp.asarray(toks[:, s:e]), jc)
        got, tc, _ = mt.apply(pt, torch.from_numpy(toks[:, s:e]), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    n = int(np.asarray(jc["index"]))
    Wj, Wt = np.asarray(jc["blocks"]["moe"]["k"]).shape[2], tc["k"].shape[2]
    keep = min(Wj, Wt, n)
    pos = np.arange(n - keep, n)
    for name in ("k", "v"):
        want = _jax_layer_kv(jc, cfg, name)[:, :, pos % Wj]
        np.testing.assert_allclose(tc[name][:, :, pos % Wt].numpy(), want,
                                   atol=1e-5, rtol=1e-5)
    if cfg.sliding_window:
        assert n > Wt                                  # the ring wrapped


def test_fake_quant_stacks_each_block_kind_as_jax_does(pair):
    """``quantize_params`` (the paper's QDQ treatment) scales each column
    over its JAX stack: for llama4-smoke the dense layers together and the
    MoE layers together, experts included."""
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    want = params_from_numpy(mt.cfg, jax.tree_util.tree_map(
        np.asarray, jax_q8.quantize_params(jpt)), "cpu")
    got = q8.quantize_params(pt)
    assert _shapes(got) == _shapes(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
