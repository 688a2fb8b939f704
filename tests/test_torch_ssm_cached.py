"""Port parity for the cached Mamba-2 (ssm) path against ``repro`` on the
``mamba2-780m`` smoke config: ``ssd_sequential`` (y, final state, trail),
the cached causal conv, the cached ``ssm_mix`` with and without trails
(sequential at Q <= 16, the chunked scan from the cached state above),
``rollback`` through the trails, ``ssd_chunked`` and the kernel's plain
version from an initial state with the final state, the kernel's
decomposition (``ssd_split_ref``) with both, the cached forward over a
prefill and decode steps, and the cached ``SpecEngine`` with the stateful
drafter: JAX's tokens, equal to cached AR.

Logits and scan outputs are held to fp32 atol = rtol = 1e-4 (XLA and
PyTorch sum the projections and the chunked scan in different orders);
tokens and counts are compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import ref, ssd_scan as ss  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "mamba2-780m"
TOL = dict(atol=1e-4, rtol=1e-4)
GAMMA = 4


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _pair(split):
    jcfg = jax_registry.smoke_config(ARCH)
    cfg = registry.smoke_config(ARCH)
    if split:
        jcfg = jcfg.replace(embed_init_scale=jcfg.d_model ** -0.5)
        cfg = cfg.replace(embed_init_scale=jcfg.d_model ** -0.5)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = ({**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                    jpt["layers"])}
           if split else jd.init(jax.random.PRNGKey(7)))
    return {"jax": (jt, jd, jpt, jpd), "cfg": (jcfg, cfg),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, _to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, _to_np(jpd), "cpu"))}


@pytest.fixture(scope="module")
def engine_pair():
    return _pair(split=False)


@pytest.fixture(scope="module")
def split_pair():
    return _pair(split=True)


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


def _scan_inputs(seed, b, l, h, p, n, shared=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dA = -(0.05 + 0.4 * rng.random((b, l, h))).astype(np.float32)
    hb = 1 if shared else h
    Bm = np.broadcast_to(rng.standard_normal((b, l, hb, n)), (b, l, h, n)).astype(np.float32)
    Cm = np.broadcast_to(rng.standard_normal((b, l, hb, n)), (b, l, h, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dA, Bm, Cm, init


@pytest.mark.parametrize("l", [1, 5, 17])
def test_ssd_sequential_matches_jax(l):
    x, dA, Bm, Cm, init = _scan_inputs(0, 2, l, 4, 8, 16)
    got = ssm.ssd_sequential(*(torch.from_numpy(a) for a in (x, dA, Bm, Cm, init)))
    want = jax_ssm.ssd_sequential(*(jnp.asarray(a) for a in (x, dA, Bm, Cm, init)))
    for g, w in zip(got, want):                 # y, final state, trail
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert tuple(got[2].shape) == (2, l, 4, 8, 16)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("l", [3, 8, 21])
def test_ssd_chunked_from_a_state_matches_jax(l, chunk):
    """The port's ``ssd_chunked`` with an initial state == JAX's (y and the
    final state), and the kernel's plain version and its decomposition
    (``ssd_split_ref``, the kernel's items and carry) give the same."""
    x, dA, Bm, Cm, init = _scan_inputs(1, 2, l, 4, 8, 16)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, dA, Bm, Cm)]
    y, fin = ssm.ssd_chunked(*args, chunk, torch.from_numpy(init))
    jy, jfin = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dA, Bm, Cm)),
                                   chunk, jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), atol=1e-5, rtol=1e-5)
    py, pfin = ss.ssd_scan(*args, chunk=chunk, init_state=torch.from_numpy(init))
    assert torch.equal(py, y) and torch.equal(pfin, fin)
    Bv = torch.from_numpy(Bm[:, :, :1]).expand(2, l, 4, 16)    # stride-0 heads
    Cv = torch.from_numpy(Cm[:, :, :1]).expand(2, l, 4, 16)
    sy = ref.ssd_split_ref(args[0], args[1], Bv, Cv, chunk=chunk)
    wy = ss.ssd_scan(args[0], args[1], Bv, Cv, chunk=chunk)
    np.testing.assert_allclose(sy.numpy(), wy.numpy(), atol=1e-5, rtol=1e-5)
    sy, sfin = ref.ssd_split_ref(args[0], args[1], Bv, Cv, chunk=chunk,
                                 init_state=torch.from_numpy(init))
    wy, wfin = ss.ssd_scan(args[0], args[1], Bv, Cv, chunk=chunk,
                           init_state=torch.from_numpy(init))
    np.testing.assert_allclose(sy.numpy(), wy.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sfin.numpy(), wfin.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("l", [6, 63, 127, 128, 129, 134, 256, 300, 384, 500])
def test_plan_with_states_covers_what_the_carry_needs(l, state):
    """A call from a zero state plans what it did before the option
    existed; a call from a given state adds the last chunk's state items
    (its final state) and carries into chunk 0, so every chunk's rows get
    a carry block."""
    b, h, p, n, chunk = 2, 48, 64, 128, 128
    pl = ss.plan(b, l, h, p, n, chunk, 132, state=state)
    base = ss.plan(b, l, h, p, n, chunk, 132)
    nc = -(-l // chunk)
    nsc = ss.state_chunks(nc, state)
    assert nsc == (nc if state else nc - 1)
    assert pl.state_blocks == b * h * nsc * 2
    assert pl.workspace == b * h * nsc * n * p
    assert {c for _, _, c, _ in ss.state_items(pl, b, h, n, state)} == set(range(nsc))
    first = 0 if state else 1
    rows = max([min(chunk, l - c * chunk) for c in range(first, nc)], default=0)
    assert pl.carry_blocks == b * h * -(-rows // ss.CARRY_ROWS)
    assert pl.y_blocks == base.y_blocks
    if state:
        assert pl.carry_blocks > 0
    else:
        assert pl == base


@pytest.mark.parametrize("Q", [1, 3, 9])
def test_cached_causal_conv_matches_jax(Q):
    rng = np.random.default_rng(4)
    xBC = rng.standard_normal((2, Q, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32)
    out, tail = ssm._causal_conv(*(torch.from_numpy(a) for a in (xBC, w, b, cache)))
    jout, jtail = jax_ssm._causal_conv(*(jnp.asarray(a) for a in (xBC, w, b, cache)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def _layer_cache(cfg, seed, B=2):
    rng = np.random.default_rng(seed)
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"state": rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                          cfg.ssm_state)).astype(np.float32) * 0.3,
            "conv": rng.standard_normal((B, cfg.ssm_conv - 1, ch)).astype(np.float32)}


@pytest.mark.parametrize("Q,want_trail", [(1, False), (5, True), (5, False),
                                          (20, False), (20, True)])
def test_cached_ssm_mix_matches_jax(engine_pair, Q, want_trail):
    """Q <= 16 or a trail: the sequential scan; Q = 20 without a trail: the
    chunked scan from the cached state, the final state from the scan."""
    jcfg, cfg = engine_pair["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], engine_pair["jax"][2]["layers"])
    p = engine_pair["torch"][2]["layers"][0]
    x = np.random.default_rng(5).standard_normal((2, Q, cfg.d_model)).astype(np.float32)
    lc = _layer_cache(cfg, 6)
    out, new = ssm.ssm_mix(cfg, p, torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in lc.items()}, want_trail)
    jout, jnew = jax_ssm.ssm_mix(jcfg, jp, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in lc.items()}, want_trail)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert set(new) == set(jnew)
    for k in new:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), **TOL,
                                   err_msg=k)


def test_rollback_through_the_trails_matches_jax(engine_pair):
    """A verify-shaped extend (Q = 5 with trails) from a prefilled cache,
    then rollback to every accepted index the round can commit."""
    jm, m = engine_pair["jax"][0], engine_pair["torch"][0]
    jp, p = engine_pair["jax"][2], engine_pair["torch"][2]
    toks = _prompts(2, 14, seed=7)
    jc = jm.init_cache(2, 40)
    tc = m.init_cache(2, 40, device="cpu")
    _, jc, _ = jm.apply(jp, jnp.asarray(toks[:, :9]), jc)
    _, tc, _ = m.apply(p, torch.from_numpy(toks[:, :9]), tc)
    _, jc, _ = jm.apply(jp, jnp.asarray(toks[:, 9:]), jc, want_trail=True)
    _, tc, _ = m.apply(p, torch.from_numpy(toks[:, 9:]), tc, want_trail=True)
    for accepted in range(9, 15):
        want = jm.rollback(jc, jnp.asarray(accepted, jnp.int32), 5)
        got = m.rollback(tc, torch.tensor(accepted, dtype=torch.int32), 5)
        assert set(got) == set(want) == {"state", "conv", "index"}
        for k in ("state", "conv"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
        assert int(got["index"]) == accepted


@pytest.mark.parametrize("prefill", [6, 21])
def test_cached_forward_logits_match_jax(engine_pair, prefill):
    """Prefill (sequential at 6 tokens, chunked from the zero state at 21),
    then single-token steps: logits and the state after each."""
    jm, m = engine_pair["jax"][0], engine_pair["torch"][0]
    jp, p = engine_pair["jax"][2], engine_pair["torch"][2]
    toks = _prompts(2, prefill + 3, seed=prefill)
    jc = jm.init_cache(2, 40)
    tc = m.init_cache(2, 40, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    for lo, hi in ((0, prefill), (prefill, prefill + 1), (prefill + 1, prefill + 3)):
        want, jc, _ = jm.apply(jp, jnp.asarray(toks[:, lo:hi]), jc)
        got, tc, _ = m.apply(p, torch.from_numpy(toks[:, lo:hi]), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]), **TOL)
        assert int(tc["index"]) == int(jc["index"]) == hi


def test_state_cache_keeps_the_activation_dtype_as_jax():
    """Under a bf16 config the state and conv caches, and the trails, are
    bf16 as JAX's are (``Model.init_cache`` and ``ssm_mix`` there); the
    rollback selects the trail's entry unchanged."""
    cfg = registry.smoke_config(ARCH).replace(dtype="bfloat16",
                                              param_dtype="bfloat16")
    m = build_model(cfg)
    cache = m.init_cache(2, 16, device="cpu")
    jcache = jax_build(jax_registry.smoke_config(ARCH).replace(
        dtype="bfloat16", param_dtype="bfloat16")).init_cache(2, 16)
    for name in ("state", "conv"):
        assert str(cache[name].dtype) == f"torch.{jcache[name].dtype}"
        assert tuple(cache[name].shape) == jcache[name].shape
    assert cache["state"].dtype == cache["conv"].dtype == torch.bfloat16
    p = m.init(0, "cpu")
    toks = torch.from_numpy(_prompts(2, 5, seed=2))
    _, new, _ = m.apply(p, toks, cache, want_trail=True)
    assert new["state"].dtype == new["state_trail"].dtype == torch.bfloat16
    rolled = m.rollback(new, torch.tensor(3, dtype=torch.int32), 5)
    assert rolled["state"].dtype == torch.bfloat16
    assert torch.equal(rolled["state"], new["state_trail"][:, :, 2])


@pytest.mark.parametrize("P", [6, 21])
@pytest.mark.parametrize("which", ["engine_pair", "split_pair"])
def test_cached_spec_engine_matches_jax_and_ar(request, which, P):
    """The stateful drafter path (gamma + 1 draft steps, snapshot rollback)
    and the target's trail rollback: JAX's tokens and counts, == cached AR
    == JAX's cached AR. B = 1 on the disagreeing pair, so rounds commit
    what the single row accepts."""
    pair = request.getfixturevalue(which)
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(1 if which == "split_pair" else 2, P, seed=3)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy="modular"))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), 14)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    assert eng._spec.d_stateful
    got, st = eng.generate(pt, pd, prompt, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted"):
        assert st[k] == int(jst[k]), k
    ar = engine.autoregressive_generate(mt, pt, prompt, 14, use_cache=True)
    np.testing.assert_array_equal(got[:, :P + 14].numpy(), ar.numpy())
    jar = jax_engine.autoregressive_generate(jt, jpt, jnp.asarray(prompt), 14,
                                             use_cache=True)
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))
    if which == "split_pair":
        assert 0 < st["accepted"] < st["drafted"]


def test_cli_serves_mamba2_cached_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "7", "--prompt-len", "5", "--use-cache"]
    spec, s = serve.main(argv + ["--speculative", "--batch", "2", "--gamma", "3"])
    ar, _ = serve.main(argv)
    out = capsys.readouterr().out
    assert "cache=True" in out and "AR served 3 x 7 tokens" in out
    assert spec.shape == ar.shape == (3, 12) and s["waves"] == 2
    nocache, _ = serve.main(argv[:-1])
    np.testing.assert_array_equal(ar, nocache)
