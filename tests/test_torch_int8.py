"""Port parity for the paper's w8a8 path (§III-C): the quantization
primitives, the fake-quant and serving weight transforms, the activation
hook, the plain int8 matmul, ``layers.linear`` on int8 weights, and no-cache
speculative decoding of the ``llama3.2-1b`` smoke pair under w8a8, against
``repro`` on the same seeded numpy inputs.

Tolerances: int8 values, scales and int32 accumulators are compared
exactly (the same fp32 divisions and round-half-to-even on both sides);
the matmul's rescaled output to 1e-5 (the same fp32 products); ``linear``
to fp32 1e-5 and bf16 2e-2, because the port computes what the TPU kernel
computes, ``(q_x @ w_q) * sx * scale``, where JAX's ``layers.linear``
multiplies the dequantized operands ``(q_x * sx) @ (w_q * scale)`` — the
same up to fp32 rounding, and apart by the operands' bf16 roundings in
bf16. Tokens are compared exactly. The CUDA kernel is held against the
plain version bit for bit on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.quant import int8 as jq8  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.quant import int8 as q8  # noqa: E402

MATMUL_SHAPES = [(8, 64, 32), (128, 128, 128), (37, 200, 150), (256, 384, 128),
                 (1, 128, 257)]       # JAX's kernel sweep (tests/test_kernels.py)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("axis", [-1, 0, None])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_array_and_fake_quant_match_jax(axis, bits):
    w = (np.random.default_rng(bits).standard_normal((3, 16, 24)) * 0.1).astype(np.float32)
    q, s = q8.quantize_array(_t(w), axis=axis, bits=bits)
    jq, js = jq8.quantize_array(jnp.asarray(w), axis=axis, bits=bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q8.dequantize(q, s).numpy(),
                                  np.asarray(jq8.dequantize(jq, js)))
    np.testing.assert_array_equal(q8.fake_quant(_t(w), axis, bits).numpy(),
                                  np.asarray(jq8.fake_quant(jnp.asarray(w), axis, bits)))


def _smoke_trees(arch):
    jcfg = jax_registry.smoke_config(arch)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = registry.smoke_config(arch)
    return cfg, jp, params_from_numpy(cfg, _to_np(jp), "cpu")


def _assert_tree_equal(port, jax_tree, stacked=False, i=None):
    if isinstance(port, list):
        for i, lp in enumerate(port):
            _assert_tree_equal(lp, jax_tree, stacked=True, i=i)
        return
    if isinstance(port, dict):
        for k, v in port.items():
            if k == "table_f32":
                continue
            _assert_tree_equal(v, jax_tree[k], stacked, i)
        return
    want = np.asarray(jax_tree)[i] if stacked else np.asarray(jax_tree)
    assert str(port.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(_np(port), want.astype(np.float32)
                                  if want.dtype != np.int8 else want)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_shares_scales_across_layers_as_jax(arch, bits):
    """JAX quantizes a stacked [L, K, N] weight with one scale per output
    channel for all layers; the port's per-layer weights quantize together
    to the same values."""
    _, jp, p = _smoke_trees(arch)
    got = q8.quantize_params(p, bits=bits)
    want = jq8.quantize_params(jp, bits=bits)
    _assert_tree_equal(got, want)
    if arch == "llama3.2-1b":
        w0 = p["layers"][0]["attn"]["q"]["w"]
        assert not torch.equal(got["layers"][0]["attn"]["q"]["w"], w0)
        # a per-layer scale would differ from the shared one
        alone = q8.fake_quant(w0, axis=-1, bits=bits)
        assert not torch.equal(got["layers"][0]["attn"]["q"]["w"], alone)
    assert torch.equal(got["final_norm"]["scale"], p["final_norm"]["scale"])


def test_quantize_params_predicate_sees_jax_paths():
    _, jp, p = _smoke_trees("llama3.2-1b")
    seen, jseen = [], []

    def pred(log):
        def f(path, leaf):
            log.append((path, tuple(leaf.shape)))
            return path.endswith("mlp/up/w")
        return f
    got = q8.quantize_params(p, predicate=pred(seen))
    jq8.quantize_params(jp, predicate=pred(jseen))
    assert sorted(seen) == sorted(jseen)
    assert torch.equal(got["layers"][1]["attn"]["q"]["w"], p["layers"][1]["attn"]["q"]["w"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
def test_quantize_for_serving_matches_jax(arch):
    _, jp, p = _smoke_trees(arch)
    got = q8.quantize_for_serving(p)
    want = jq8.quantize_for_serving(jp)
    _assert_tree_equal(got, want)
    def first_proj(tree):
        lp = tree["layers"][0]
        return lp["attn"]["q"] if arch == "llama3.2-1b" else lp["in_proj"]
    proj = first_proj(got)
    assert set(proj) == {"w_q", "scale"} and proj["w_q"].dtype == torch.int8
    assert proj["scale"].shape == (proj["w_q"].shape[1],)
    assert set(first_proj(p)) == {"w"}          # the input tree is untouched


# --------------------------------------------------------- activation quant
def test_act_quant_restores_its_state():
    before = dict(q8._ACT_QUANT)
    with q8.act_quant(enabled=True, bits=4, static_scale=0.5):
        assert q8.act_quant_enabled() and q8._ACT_QUANT["bits"] == 4
        with q8.act_quant(enabled=False):
            assert not q8.act_quant_enabled()
        assert q8._ACT_QUANT == {"enabled": True, "bits": 4, "static_scale": 0.5}
    assert q8._ACT_QUANT == before
    with pytest.raises(RuntimeError):
        with q8.act_quant(bits=6):
            raise RuntimeError("boom")
    assert q8._ACT_QUANT == before


@pytest.mark.parametrize("bits,static", [(8, None), (8, 0.013), (4, None), (4, 0.2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maybe_quant_act_matches_jax(bits, static, dtype):
    x = np.random.default_rng(bits).standard_normal((3, 5, 16)).astype(np.float32)
    xt = _t(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    assert q8.maybe_quant_act(xt) is xt
    with q8.act_quant(bits=bits, static_scale=static), \
            jq8.act_quant(bits=bits, static_scale=static):
        got = q8.maybe_quant_act(xt)
        want = jq8.maybe_quant_act(xj)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_calibrate_act_scale_matches_jax():
    samples = [np.random.default_rng(i).standard_normal((4, 7)).astype(np.float32)
               for i in range(3)]
    got = q8.calibrate_act_scale([_t(s) for s in samples], percentile=99.0)
    assert got == jq8.calibrate_act_scale(samples, percentile=99.0)


# ------------------------------------------------------------- int8 matmul
def _matmul_inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w_q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    sw = rng.uniform(1e-3, 1e-2, (N,)).astype(np.float32)
    sx = np.float32(max(np.abs(x).max() / 127.0, 1e-12))
    x_q = np.clip(np.round(x / sx), -128, 127).astype(np.int8)
    return x, x_q, w_q, sx, sw


@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_plain_int8_matmul_matches_jax(M, K, N):
    x, x_q, w_q, sx, sw = _matmul_inputs(M, K, N)
    # the int32 accumulators, exactly (|acc| < 2**24, so fp32 holds them)
    acc = im.int8_matmul(_t(x_q), _t(w_q), torch.tensor(1.0), torch.ones(N),
                         out_dtype=torch.float32)
    jacc = jax.lax.dot_general(jnp.asarray(x_q), jnp.asarray(w_q),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).astype(np.float32))
    got = ops.quantized_matmul(_t(x_q), _t(w_q), torch.tensor(sx), _t(sw),
                               out_dtype=torch.float32)
    want = jax_ref.int8_matmul_ref(jnp.asarray(x_q), jnp.asarray(w_q),
                                   jnp.float32(sx), jnp.asarray(sw), jnp.float32)
    kern = jax_ops.quantized_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                    jnp.asarray(sw), out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quantized_matmul_lead_dims_and_dtype(out_dtype):
    _, x_q, w_q, sx, sw = _matmul_inputs(10, 96, 40, seed=3)
    dt = getattr(torch, out_dtype)
    flat = ops.quantized_matmul(_t(x_q), _t(w_q), torch.tensor(sx), _t(sw), out_dtype=dt)
    lead = ops.quantized_matmul(_t(x_q).reshape(2, 5, 96), _t(w_q), torch.tensor(sx),
                                _t(sw), out_dtype=dt)
    assert flat.dtype == dt and lead.shape == (2, 5, 40)
    assert torch.equal(lead.reshape(10, 40), flat)
    want = jax_ref.int8_matmul_ref(jnp.asarray(x_q), jnp.asarray(w_q), jnp.float32(sx),
                                   jnp.asarray(sw), getattr(jnp, out_dtype))
    np.testing.assert_array_equal(_np(flat), np.asarray(want, np.float32))


H100_SMS = 132   # streaming multiprocessors of an H100 SXM
# the main path's eight projections at M = 2 x 134 (3B q/o, k/v, gate/up,
# down, then 1B), then ragged and other shapes
SPLIT_SHAPES = [(268, 3072, 3072), (268, 3072, 1024), (268, 3072, 8192),
                (268, 8192, 3072), (268, 2048, 2048), (268, 2048, 512),
                (268, 2048, 8192), (268, 8192, 2048), (37, 200, 150),
                (1, 128, 257), (1, 3072, 8192), (5, 1000, 300)]


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_split_k_sums_are_bit_equal_to_the_unsplit_product(M, K, N, out_dtype):
    """The kernel's split-K path adds the int32 partial products of the
    plan's K ranges in split order, then applies the epilogue: that equals
    the plain version bit for bit (int32 sums are exact)."""
    rng = np.random.default_rng(M * 31 + K + N)
    x_q = _t(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w_q = _t(rng.integers(-128, 128, (K, N)).astype(np.int8))
    sx = torch.tensor(0.0123, dtype=torch.float32)
    sw = _t(rng.uniform(1e-3, 1e-2, (N,)).astype(np.float32))
    p = im.plan(M, K, N, H100_SMS)
    acc = torch.zeros((M, N), dtype=torch.int32)
    for z in range(p.splits):
        lo, hi = (s * im.BK for s in p.k_range(z))
        # exact in float64 (|sum| < 2**53), faster than an int32 product here
        acc += (x_q[:, lo:hi].double() @ w_q[lo:hi].double()).to(torch.int32)
    got = (acc.float() * sx * sw[None, :]).to(out_dtype)
    assert torch.equal(got, im.plain(x_q, w_q, sx, sw, out_dtype))


@pytest.mark.parametrize("M,K,N,splits", [
    (268, 3072, 3072, 3), (268, 3072, 1024, 6), (268, 3072, 8192, 1),
    (268, 8192, 3072, 3), (268, 2048, 2048, 3), (268, 2048, 512, 11),
    (268, 2048, 8192, 1), (268, 8192, 2048, 5)])
def test_plan_splits_k_on_the_thin_main_path_grids(M, K, N, splits):
    """The main path's projections: three 96-row tiles; K split until the
    blocks cover the 132 SMs (the down and k/v projections, 3B and 1B
    q/o), the 8192-deep down projections and 3B q/o further, toward two
    blocks per SM; the wide gate/up grids unsplit."""
    p = im.plan(M, K, N, H100_SMS)
    assert (p.m_tiles, p.splits) == (3, splits)
    assert p.m_tiles * p.n_tiles * p.splits >= H100_SMS


def test_plan_covers_every_tile_and_k_step_once():
    """Over ragged shapes: the tiles cover [0, M) x [0, N) exactly once,
    the splits' K ranges partition the K steps with none empty, and K is
    split only while the blocks leave SMs idle."""
    hyp = pytest.importorskip("hypothesis")   # requirements-test.txt
    st = hyp.strategies

    @hyp.settings(max_examples=300, deadline=None)
    @hyp.given(M=st.integers(1, 3000), K=st.integers(0, 40000),
               N=st.integers(1, 20000), sms=st.sampled_from([H100_SMS, 114, 16]))
    def check(M, K, N, sms):
        _check_int8_plan(M, K, N, sms)

    check()


@pytest.mark.parametrize("M,K,N,sms", [
    (1, 3072, 16782, H100_SMS),     # 1 x 132 tiles
    (192, 4096, 7296, 114),         # 2 x 57 tiles
    (96, 2048, 2048, 16)])          # 1 x 16 tiles
def test_plan_does_not_split_when_the_tiles_fill_every_sm(M, K, N, sms):
    """At exactly one output tile per SM the blocks already cover the card:
    one split, whatever the depth of K."""
    p = im.plan(M, K, N, sms)
    assert p.m_tiles * p.n_tiles == sms
    assert p.splits == 1
    _check_int8_plan(M, K, N, sms)


def _check_int8_plan(M, K, N, sms):
    p = im.plan(M, K, N, sms)
    assert (p.m_tiles - 1) * im.BM < M <= p.m_tiles * im.BM
    assert (p.n_tiles - 1) * im.BN < N <= p.n_tiles * im.BN
    assert p.k_steps * im.BK >= K > (p.k_steps - 1) * im.BK
    ranges = [p.k_range(z) for z in range(p.splits)]
    steps = [s for lo, hi in ranges for s in range(lo, hi)]
    assert steps == list(range(p.k_steps))
    assert all(hi > lo for lo, hi in ranges) or (p.k_steps == 0 and p.splits == 1)
    tiles = p.m_tiles * p.n_tiles
    wave = -(-sms // tiles)               # splits for one block per SM
    if tiles >= sms or p.k_steps <= 1:
        assert p.splits == 1
    else:                                 # at least a wave, at most two
        assert p.splits >= min(wave, p.k_steps)
        assert p.splits <= wave or (tiles * p.splits <= 2 * sms and
                                    p.k_steps // (p.splits - 1) >= im.MIN_SPLIT_STEPS)


def test_kernel_wrapper_refuses_a_non_cuda_device():
    _, x_q, w_q, sx, sw = _matmul_inputs(4, 32, 8)
    with pytest.raises(ValueError, match="device"):
        im.int8_matmul(_t(x_q).to("meta"), _t(w_q).to("meta"),
                       torch.tensor(sx).to("meta"), _t(sw).to("meta"))


# ------------------------------------------------------------------ linear
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("static", [None, 0.02])
def test_w8a8_linear_matches_jax(dtype, tol, static):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.125).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p = q8.quantize_for_serving({"w": _t(w).to(tdt)})
    jp = jq8.quantize_for_serving({"w": jnp.asarray(w, jdt)})
    xt, xj = _t(x).to(tdt), jnp.asarray(x, jdt)
    with q8.act_quant(static_scale=static), jq8.act_quant(static_scale=static):
        got = layers.linear(p, xt)
        want = jax_layers.linear(jp, xj)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)
    # w8a16 (no act-quant): dequantize, then x @ w, as JAX
    np.testing.assert_allclose(_np(layers.linear(p, xt)),
                               np.asarray(jax_layers.linear(jp, xj), np.float32),
                               atol=tol, rtol=tol)
    # float weights under act-quant: fake-quant x, then x @ w (Fig. 5 study)
    with q8.act_quant(static_scale=static), jq8.act_quant(static_scale=static):
        fq = layers.linear({"w": _t(w).to(tdt)}, xt)
        jfq = jax_layers.linear({"w": jnp.asarray(w, jdt)}, xj)
    np.testing.assert_allclose(_np(fq), np.asarray(jfq, np.float32), atol=tol, rtol=tol)


def test_w8a8_linear_routes_through_quantized_matmul(monkeypatch):
    calls = []
    real = ops.quantized_matmul

    def spy(*a, **kw):
        calls.append((a[0].dtype, kw["out_dtype"]))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "quantized_matmul", spy)
    p = q8.quantize_for_serving({"w": torch.randn(16, 8)})
    layers.linear(p, torch.randn(3, 16))
    assert calls == []
    with q8.act_quant():
        layers.linear(p, torch.randn(3, 16))
    assert calls == [(torch.int8, torch.float32)]
    with q8.act_quant(bits=16), pytest.raises(ValueError, match="8 bits"):
        layers.linear(p, torch.randn(3, 16))


# ------------------------------------------------------- speculative decoding
@pytest.fixture(scope="module")
def w8a8_pair():
    """The llama3.2-1b smoke pair that disagrees in some rounds (drafter =
    the target's first L-1 layers, embedding std d**-0.5), both models
    through quantize_for_serving."""
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    jcfg = jcfg.replace(embed_init_scale=jcfg.d_model ** -0.5)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1], jpt["layers"])}
    cfg = registry.smoke_config("llama3.2-1b").replace(embed_init_scale=jcfg.d_model ** -0.5)
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    pt = params_from_numpy(cfg, _to_np(jpt), "cpu")
    pd = params_from_numpy(cfg_d, _to_np(jpd), "cpu")
    return {"jax": (jt, jd, jq8.quantize_for_serving(jpt), jq8.quantize_for_serving(jpd)),
            "torch": (build_model(cfg), build_model(cfg_d), q8.quantize_for_serving(pt),
                      q8.quantize_for_serving(pd))}


def test_bridge_carries_a_serving_tree(w8a8_pair):
    jt, _, jpt, _ = w8a8_pair["jax"]
    cfg = registry.smoke_config("llama3.2-1b").replace(
        embed_init_scale=jt.cfg.d_model ** -0.5)
    p = params_from_numpy(cfg, _to_np(jpt), "cpu")
    _assert_tree_equal(p, jpt)
    assert p["layers"][0]["mlp"]["up"]["w_q"].dtype == torch.int8


@pytest.mark.parametrize("policy", ["linear", "multi"])
def test_w8a8_spec_tokens_match_jax_dynamic_scale(w8a8_pair, policy):
    jt, jd, jpt, jpd = w8a8_pair["jax"]
    mt, md, pt, pd = w8a8_pair["torch"]
    prompt = np.random.default_rng(2).integers(0, 512, (2, 6)).astype(np.int32)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=4, use_cache=False, draft_policy=policy, draft_k=2))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=4, draft_policy=policy,
                                                        draft_k=2))
    with q8.act_quant(), jq8.act_quant():
        want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), 12)
        got, st = eng.generate(pt, pd, prompt, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (st["rounds"], st["accepted"]) == (int(jst["rounds"]), int(jst["accepted"]))


@pytest.mark.parametrize("policy", ["linear", "multi"])
def test_w8a8_spec_equals_ar_under_a_static_scale(w8a8_pair, policy):
    """A static scale makes each row's quantization independent of the
    other rows and positions, so speculation is exact again."""
    mt, md, pt, pd = w8a8_pair["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=4, draft_policy=policy,
                                                        draft_k=2))
    partial = 0
    for seed in range(3):
        prompt = np.random.default_rng(seed).integers(0, 512, (2, 8)).astype(np.int32)
        with q8.act_quant(static_scale=0.05):
            got, st = eng.generate(pt, pd, prompt, 16)
            ar = engine.autoregressive_generate(mt, pt, prompt, 16)
        np.testing.assert_array_equal(got[:, :24].numpy(), ar.numpy())
        partial += st["accepted"] < st["drafted"]
    assert partial
