"""Port parity for the MoE MLP (``repro_torch.models.moe.moe_mlp``) against
``repro.models.moe``, at smoke width, fp32.

On ``mixtral-smoke`` (E 4, top-2) and ``llama4-smoke`` (E 4, top-1, a
shared expert) MLP weights from JAX's ``init_moe_mlp``: routing, gates,
output and aux losses, with JAX's capacity drops (a skewed router at
B·S = 300), tied router probabilities and int8 experts
(``quantize_for_serving``'s [E, N] scales); act-quant reaches the router
and the shared expert and not the routed experts; and JAX's padded last
prefill chunk, which takes capacity the port's true-length chunk does not.
Inputs come from numpy seeds. Outputs at atol=rtol=1e-5. The whole models
are in tests/test_torch_moe_model.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.quant import int8 as jax_q8  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.quant import int8 as q8  # noqa: E402

ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _mlp(arch, seed=0, skew=None, tie=False):
    """JAX's ``init_moe_mlp`` params for the arch's smoke config, and the
    same as torch tensors. ``skew`` adds to the router's expert-0 column;
    ``tie`` makes expert 2's router column expert 1's. Skewed tests feed
    inputs of mean 1, so the skew adds ~skew·d to expert 0's logit."""
    cfg = registry.smoke_config(arch)
    jcfg = jax_registry.smoke_config(arch)
    jp = jax.tree_util.tree_map(np.asarray, jax_moe.init_moe_mlp(
        jax.random.PRNGKey(seed), jcfg))
    w = np.array(jp["router"]["w"])
    if skew is not None:
        w[:, 0] += skew
    if tie:
        w[:, 2] = w[:, 1]
    jp = {**jp, "router": {"w": w}}
    return cfg, jcfg, jp, _to_torch(jp)


def _x(shape, seed, mean=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + mean).astype(np.float32)


# JAX's MoE MLP, jitted (eager JAX ops are slow); cfg is static
_jax_mlp = jax.jit(jax_moe.moe_mlp, static_argnums=0)


@jax.jit
def _jax_top(router, xt):
    logits = JL.linear(router, xt).astype(jnp.float32)
    return jax.nn.softmax(logits, axis=-1)


def _jax_routing(jcfg, jp, x):
    """JAX's own routing steps (``repro.models.moe.moe_mlp``, lines
    77-103): top-k experts, renormalised gates and the within-capacity
    mask [G, g, K, E]."""
    B, S, D = x.shape
    T = B * S
    g = jax_moe.group_shape(T)
    E, K = jcfg.num_experts, jcfg.num_experts_per_tok
    cap = g if g * K <= 512 else max(1, int(g * K / E * 1.25))
    xt = jnp.asarray(x).reshape(T // g, g, D)
    probs = _jax_top(jp["router"], xt)
    top_p, top_e = jax.lax.top_k(probs, K)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    assign = jax.nn.one_hot(top_e, E, dtype=jnp.int32)
    flat = assign.reshape(T // g, g * K, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(T // g, g, K, E)
    within = (pos < cap) & (assign > 0)
    return (np.asarray(top_p), np.asarray(top_e), np.asarray(within),
            np.asarray(assign))


def _check_mlp(cfg, jcfg, jp, tp, x):
    """moe_mlp's routing, gates, output and aux against JAX's."""
    jy, jaux = _jax_mlp(jcfg, jp, jnp.asarray(x))
    y, aux = moe.moe_mlp(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    top_p, top_e, within, assign = _jax_routing(jcfg, jp, x)
    B, S, D = x.shape
    g = moe.group_shape(B * S)
    _, _, p_top_p, p_top_e = moe.route(cfg, tp, torch.from_numpy(x).reshape(
        -1, g, D))
    np.testing.assert_array_equal(p_top_e.numpy(), top_e)
    np.testing.assert_allclose(p_top_p.numpy(), top_p, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(
        moe.dispatch(p_top_e, cfg.num_experts, moe.capacity(cfg, g)).numpy(),
        within)
    return within, assign


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_jax(arch):
    cfg, jcfg, jp, tp = _mlp(arch)
    within, assign = _check_mlp(cfg, jcfg, jp, tp, _x((2, 13, cfg.d_model), 1))
    assert within.sum() == assign.sum()                     # dropless
    assert ("shared" in tp) == (arch != "mixtral-8x7b")


def test_capacity_drops_the_pairs_jax_drops():
    """B·S = 300: one group of 300 (not a multiple of 128), g·K = 600 >
    512, so each expert takes cap = int(300·2/4·1.25) = 187 pairs. A router
    skewed toward expert 0 sends it every token (~150 pairs per expert
    otherwise, which would drop nothing): JAX drops its pairs past slot
    187, and the port drops the same ones, gates not renormalised."""
    cfg, jcfg, jp, tp = _mlp("mixtral-8x7b", seed=2, skew=0.1)
    assert moe.group_shape(300) == 300 and moe.capacity(cfg, 300) == 187
    within, assign = _check_mlp(cfg, jcfg, jp, tp,
                                _x((2, 150, cfg.d_model), 3, mean=1.0))
    per_expert = assign.sum(axis=(0, 1, 2))
    assert per_expert[0] > 187
    assert assign.sum() - within.sum() == per_expert[0] - 187 > 0


def test_tied_router_probabilities_pick_the_lower_expert():
    """Experts 1 and 2 share a router column: wherever they tie for the
    last top-k place, ``jax.lax.top_k`` (and the port's stable sort) takes
    expert 1."""
    cfg, jcfg, jp, tp = _mlp("mixtral-8x7b", seed=4, tie=True)
    x = _x((3, 40, cfg.d_model), 5)
    _check_mlp(cfg, jcfg, jp, tp, x)
    _, top_e, _, _ = _jax_routing(jcfg, jp, x)
    picks = top_e.reshape(-1, 2)
    has1, has2 = (picks == 1).any(-1), (picks == 2).any(-1)
    assert (has1 & ~has2).any()          # the tie decided the selection
    assert not (has2 & ~has1).any()      # and never for the higher index


def test_zero_router_ties_every_expert():
    cfg, jcfg, jp, tp = _mlp("llama4-maverick-400b-a17b", seed=6)
    jp = {**jp, "router": {"w": np.zeros_like(jp["router"]["w"])}}
    tp = {**tp, "router": {"w": torch.zeros_like(tp["router"]["w"])}}
    _check_mlp(cfg, jcfg, jp, tp, _x((2, 7, cfg.d_model), 7))
    _, top_e, _, _ = _jax_routing(jcfg, jp, _x((2, 7, cfg.d_model), 7))
    assert (top_e == 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_experts_match_jax(arch):
    """``quantize_for_serving`` gives each stacked expert weight [E, K, N]
    per-expert, per-column scales [E, N], as JAX's; the experts dequantize
    in the activation dtype."""
    cfg, jcfg, jp, tp = _mlp(arch, seed=8)
    jq = jax.tree_util.tree_map(np.asarray, jax_q8.quantize_for_serving(
        jax.tree_util.tree_map(jnp.asarray, jp)))
    tq = q8.quantize_for_serving(tp)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    for name, n in (("gate", f), ("up", f), ("down", d)):
        got, want = tq["experts"][name], jq["experts"][name]
        assert tuple(got["scale"].shape) == (E, n)
        np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
        np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    _check_mlp(cfg, jcfg, jq, tq, _x((2, 9, cfg.d_model), 9))


@pytest.mark.parametrize("arch", ARCHS)
def test_act_quant_reaches_router_and_shared_expert_only(arch, monkeypatch):
    """Under ``act_quant`` on int8 weights the router and the shared expert
    go through the int8 matmul (JAX: fake-quantized x on dequantized
    weights) and the routed experts dequantize with x as it is (JAX's
    einsums skip ``layers.linear``)."""
    cfg, jcfg, jp, tp = _mlp(arch, seed=10)
    jq = jax_q8.quantize_for_serving(jax.tree_util.tree_map(jnp.asarray, jp))
    tq = q8.quantize_for_serving(tp)
    x = _x((2, 9, cfg.d_model), 11)
    calls = []
    real = ops.quantized_matmul

    def spy(x_q, w_q, sx, sw, **kw):
        calls.append(tuple(w_q.shape))
        return real(x_q, w_q, sx, sw, **kw)
    monkeypatch.setattr(ops, "quantized_matmul", spy)
    with jax_q8.act_quant(True, static_scale=0.05):
        jy, _ = jax_moe.moe_mlp(jcfg, jq, jnp.asarray(x))   # eager: the hook
    with q8.act_quant(True, static_scale=0.05):
        y, _ = moe.moe_mlp(cfg, tq, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    d, E, fs = cfg.d_model, cfg.num_experts, cfg.num_shared_experts * cfg.d_ff
    want = [(d, E)] + ([(d, fs), (d, fs), (fs, d)] if fs else [])
    assert calls == want


# ------------------------------------------------------- padded prefill chunks
def test_servers_default_chunk_is_dropless():
    """A prefill chunk or bucketed prefill of at most 256 tokens (the
    servers' largest default bucket and default chunk) routes every pair
    at top-2 (g·K <= 512), so JAX's padded last chunk and the port's
    true-length one route the real tokens alike."""
    cfg, jcfg, jp, tp = _mlp("mixtral-8x7b", seed=12, skew=0.1)
    x = _x((1, 256, cfg.d_model), 13, mean=1.0)
    x[:, 200:] = 0.0                                  # JAX's padding rows
    jy, _ = _jax_mlp(jcfg, jp, jnp.asarray(x))
    y, _ = moe.moe_mlp(cfg, tp, torch.from_numpy(x[:, :200].copy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :200], atol=1e-5,
                               rtol=1e-5)


def test_padded_last_chunk_takes_capacity_the_true_length_chunk_does_not():
    """At a chunk C with C·K > 512 the difference shows (ROADMAP,
    deliberate differences): JAX pads the last chunk to C = 300 tokens, so
    its one group takes cap 187 pairs per expert and drops the real pairs
    past it; the port runs the 230 real tokens, g·K = 460 <= 512, dropless."""
    cfg, jcfg, jp, tp = _mlp("mixtral-8x7b", seed=12, skew=0.1)
    x = _x((1, 300, cfg.d_model), 14, mean=1.0)
    x[:, 230:] = 0.0
    within, assign = _check_mlp(cfg, jcfg, jp, tp, x)
    dropped = (assign > 0) & ~within
    real_drops = dropped[:, :230].sum()
    assert real_drops > 0
    jy, _ = _jax_mlp(jcfg, jp, jnp.asarray(x))
    y, _ = moe.moe_mlp(cfg, tp, torch.from_numpy(x[:, :230].copy()))
    assert moe.capacity(cfg, moe.group_shape(230)) == 230
    rows_apart = np.abs(y.numpy() - np.asarray(jy)[:, :230]).max(-1) > 1e-3
    assert rows_apart.any()
    dropped_rows = dropped[:, :230].any((-1, -2)).ravel()
    np.testing.assert_array_equal(rows_apart.ravel(), dropped_rows)
