"""Port parity for the Mamba-2 (ssm) family with no cache (the cached
path is ``test_torch_ssm_cached.py``): the weight
bridge, the causal conv, the no-cache forward, ``SpecEngine(use_cache=
False)`` (linear and multi-draft) and the ``launch.serve`` CLI, against
``repro`` on the ``mamba2-780m`` smoke config.

Two pairs: JAX's engine-test pair (target from PRNGKey(0), drafter from
PRNGKey(7) with one layer fewer) and a pair that disagrees — the drafter is
the target's own first layer and the embedding is drawn at std d**-0.5 —
so rounds accept part of their drafts. Logits are held to fp32 atol = rtol
= 1e-4 (XLA and PyTorch sum the projections and the chunked scan in
different orders); tokens and counts are compared exactly."""
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
from repro_torch.launch import cli_args, serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "mamba2-780m"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
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
    if split:
        jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                       jpt["layers"])}
    else:
        jpd = jd.init(jax.random.PRNGKey(7))
    return {"jax": (jt, jd, jpt, jpd),
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


def test_config_matches_jax():
    for pick in ("config", "drafter_config", "smoke_config"):
        cfg = getattr(registry, pick)(ARCH)
        jcfg = getattr(jax_registry, pick)(ARCH)
        for f in ("num_layers", "d_model", "vocab_size", "ssm_state",
                  "ssm_head_dim", "ssm_expand", "ssm_groups", "ssm_conv",
                  "ssm_chunk", "d_inner", "ssm_heads", "tie_embeddings",
                  "dtype", "param_dtype"):
            assert getattr(cfg, f) == getattr(jcfg, f), (pick, f)


def test_bridge_keeps_fp32_leaves_under_a_bf16_config():
    """A_log, D and dt_bias are fp32 in JAX whatever the param dtype;
    rounding them to bf16 would change the decay. Every leaf keeps its
    JAX dtype and value, and the layers are unstacked."""
    jcfg = jax_registry.smoke_config(ARCH).replace(param_dtype="bfloat16",
                                                    dtype="bfloat16")
    cfg = registry.smoke_config(ARCH).replace(param_dtype="bfloat16",
                                              dtype="bfloat16")
    tree = _to_np(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    p = params_from_numpy(cfg, tree, "cpu")
    assert len(p["layers"]) == cfg.num_layers
    for i, lp in enumerate(p["layers"]):
        assert set(lp) == set(tree["layers"])
        for k in ("A_log", "D", "dt_bias"):
            assert lp[k].dtype == torch.float32
            np.testing.assert_array_equal(lp[k].numpy(), tree["layers"][k][i])
        for k in ("conv_w", "conv_b"):
            assert lp[k].dtype == torch.bfloat16
        assert lp["in_proj"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(lp["conv_w"].float().numpy(),
                                      tree["layers"]["conv_w"][i].astype(np.float32))
    assert p["embed"]["table"].dtype == torch.bfloat16
    assert p["embed"]["table_f32"].dtype == torch.float32


def test_init_matches_jax_structure_and_fixed_params():
    """The port's own init: same tree (per layer), same shapes and dtypes;
    D and dt_bias equal JAX's bit for bit, A_log = log(linspace(1, 16, H))
    to one fp32 rounding (the two linspace/log implementations differ in
    the last bit)."""
    for dt in ("float32", "bfloat16"):
        cfg = registry.smoke_config(ARCH).replace(param_dtype=dt)
        jcfg = jax_registry.smoke_config(ARCH).replace(param_dtype=dt)
        p = build_model(cfg).init(0, "cpu")
        jp = _to_np(jax_build(jcfg).init(jax.random.PRNGKey(0)))
        assert len(p["layers"]) == cfg.num_layers
        for lp in p["layers"]:
            flat = {k: v for k, v in lp.items() if not isinstance(v, dict)}
            for k, v in flat.items():
                assert tuple(v.shape) == jp["layers"][k].shape[1:], k
                assert str(v.dtype).replace("torch.", "") == str(jp["layers"][k].dtype), k
            np.testing.assert_array_equal(lp["D"].numpy(), jp["layers"]["D"][0])
            np.testing.assert_array_equal(lp["dt_bias"].numpy(), jp["layers"]["dt_bias"][0])
            np.testing.assert_allclose(lp["A_log"].numpy(), jp["layers"]["A_log"][0],
                                       rtol=3e-7, atol=0)
            for k in ("in_proj", "out_proj"):
                assert tuple(lp[k]["w"].shape) == jp["layers"][k]["w"].shape[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(4)
    xBC = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    tdt = getattr(torch, dtype)
    out, tail = ssm._causal_conv(*(torch.from_numpy(a).to(tdt) for a in (xBC, w, b)))
    jout, jtail = jax_ssm._causal_conv(*(jnp.asarray(a, getattr(jnp, dtype))
                                         for a in (xBC, w, b)), None)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(jout, np.float32))
    np.testing.assert_array_equal(tail.float().numpy(), np.asarray(jtail, np.float32))
    # with a conv cache (the cached path): the cache's K-1 rows lead the window
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32)
    out, tail = ssm._causal_conv(*(torch.from_numpy(a).to(tdt)
                                   for a in (xBC, w, b, cache)))
    jout, jtail = jax_ssm._causal_conv(*(jnp.asarray(a, getattr(jnp, dtype))
                                         for a in (xBC, w, b, cache)))
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(jout, np.float32))
    np.testing.assert_array_equal(tail.float().numpy(), np.asarray(jtail, np.float32))


@pytest.mark.parametrize("which", [0, 1], ids=["target", "drafter"])
@pytest.mark.parametrize("length", [5, 19])
def test_nocache_forward_logits_match_jax(engine_pair, which, length):
    jm, jp = engine_pair["jax"][which], engine_pair["jax"][2 + which]
    m, p = engine_pair["torch"][which], engine_pair["torch"][2 + which]
    toks = _prompts(2, length, seed=length)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks))
    got, cache, aux = m.apply(p, torch.from_numpy(toks))
    assert jcache is None and cache is None and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    last, _, _ = m.apply(p, torch.from_numpy(toks), logits_slice="last")
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), **LOGIT_TOL)


def test_rows_do_not_see_later_positions(engine_pair):
    """Causality, which spec == AR rests on: a row's logits do not change
    when later positions change or the buffer grows past a chunk."""
    m, p = engine_pair["torch"][0], engine_pair["torch"][2]
    toks = _prompts(2, 21, seed=8)
    full, _, _ = m.apply(p, torch.from_numpy(toks))
    other = toks.copy()
    other[:, 13:] = (other[:, 13:] + 1) % 512
    cut, _, _ = m.apply(p, torch.from_numpy(other))
    np.testing.assert_allclose(cut[:, :13].numpy(), full[:, :13].numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("policy", ["linear", "multi"])
@pytest.mark.parametrize("which", ["engine_pair", "split_pair"])
def test_spec_engine_matches_jax_and_ar(request, which, policy):
    pair = request.getfixturevalue(which)
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(2, 6, seed=1)
    new = 14
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=False, draft_policy=policy, draft_k=2))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), new)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, draft_policy=policy, draft_k=2))
    got, st = eng.generate(pt, pd, prompt, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted"):
        assert st[k] == int(jst[k]), k
    ar = engine.autoregressive_generate(mt, pt, prompt, new)
    np.testing.assert_array_equal(got[:, :6 + new].numpy(), ar.numpy())
    jar = jax_engine.autoregressive_generate(jt, jpt, jnp.asarray(prompt), new)
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))
    if which == "split_pair":
        assert 0 < st["accepted"] < st["drafted"]


def test_cli_serves_mamba2_smoke_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "7", "--prompt-len", "5"]
    spec, s = serve.main(argv + ["--speculative", "--batch", "2", "--gamma", "3"])
    ar, s_ar = serve.main(argv)
    out = capsys.readouterr().out
    assert "speculative served 3 requests, 21 tokens" in out
    assert "AR served 3 x 7 tokens" in out
    assert spec.shape == ar.shape == (3, 12) and s["waves"] == 2
    mt, md, pt, pd, _ = cli_args.build_pair(ARCH, True, "cpu")
    again, _ = serve.serve(mt, md, pt, pd, spec[:, :5], 7, gamma=0, batch=2)
    np.testing.assert_array_equal(again, spec)


def test_full_width_pair_is_the_registered_one():
    """Without --smoke the pair is mamba2-780m with its registered drafter
    (built here on the meta device: shapes only)."""
    mod = registry.get(ARCH)
    t, d = mod.config(), mod.drafter_config()
    assert (t.num_layers, t.d_model, t.ssm_heads, t.ssm_head_dim, t.ssm_state,
            t.ssm_chunk, t.vocab_size) == (48, 1536, 48, 64, 128, 128, 50280)
    assert (d.num_layers, d.d_model, d.ssm_heads) == (12, 768, 24)
    p = ssm.init(d.replace(num_layers=1), torch.Generator().manual_seed(0), "meta")
    assert tuple(p["layers"][0]["in_proj"]["w"].shape) == (768, 2 * 1536 + 2 * 128 + 24)


def test_cached_paths_raise_for_ssm(engine_pair):
    """The cached ssm pass runs (state and conv caches; it raised until the
    cached path was ported) and its last logits equal the no-cache pass's;
    the ssm family has no paged cache (as in JAX) and no tree pass."""
    m, p = engine_pair["torch"][0], engine_pair["torch"][2]
    toks = torch.from_numpy(_prompts(1, 3, seed=2))
    cache = m.init_cache(1, 8, device="cpu")
    logits, new, _ = m.apply(p, toks, cache)
    assert int(new["index"]) == 3 and set(new) == {"state", "conv", "index"}
    full, _, _ = m.apply(p, toks)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        m.init_paged_cache(2, 8, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        m.apply(p, toks, tree=(np.zeros(3, np.int32), np.zeros(3, np.int32)))
