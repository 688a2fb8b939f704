"""Port parity for the dense-family configs ported with the windowed rings:
Granite 3.0 2B, DeepSeek-Coder 33B and Llama 3 405B (``repro_torch.
configs``), against ``repro``.

Their registry entries equal JAX's field for field (the planner's tests
cover the counts and plans). Here, at smoke width, on each of
``granite-smoke`` (tied embeddings, GQA 2) and ``deepseek-smoke`` (an
untied head, GQA 4, head_dim 32): the bridge takes JAX's params (the same
tree as the port's own init, and no-cache logits equal JAX's), and
``PagedSpecServer`` and the cached ``SpecEngine`` give JAX's tokens and
counts, equal to AR. The pair is the smoke target and a drafter of its
first layer (embedding std d**-0.5), so rounds accept part of their
drafts. fp32; logits at atol=1e-4, rtol=1e-5, tokens exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import PagedSpecServer as JaxServer  # noqa: E402
from repro.serving import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.watchdog import RoundWatchdog as JaxWatchdog  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (PagedSpecServer, RoundWatchdog,  # noqa: E402
                                 SchedulerConfig, ServeRequest)

ARCHS = ("granite-3-2b", "deepseek-coder-33b")
GAMMA = 3
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
SERVE = dict(max_batch=2, block_size=4, num_blocks=64, max_blocks_per_row=12,
             gamma_max=4, prefill_buckets=(8, 16))
REQS = [(7, 10), (12, 8), (5, 12)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _pair(arch):
    jcfg = jax_registry.smoke_config(arch)
    scale = jcfg.d_model ** -0.5
    jcfg = jcfg.replace(embed_init_scale=scale)
    cfg = registry.smoke_config(arch).replace(embed_init_scale=scale)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                   jpt["layers"])}
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, _to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, _to_np(jpd), "cpu"))}


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, P).astype(np.int32), new) for P, new in REQS]


@pytest.fixture(scope="module")
def runs():
    """Per arch: the pair, and JAX's served tokens, counts and cached
    SpecEngine run."""
    out = {}
    for i, arch in enumerate(ARCHS):
        pair = _pair(arch)
        jt, jd, jpt, jpd = pair["jax"]
        srv = JaxServer(jt, jd, jpt, jpd, JaxSchedulerConfig(**SERVE),
                        gamma=GAMMA,
                        watchdog=JaxWatchdog(slow_factor=float("inf")))
        for rid, (p, new) in enumerate(_requests(i)):
            srv.submit(JaxRequest(rid, p, new))
        served = {r.rid: np.asarray(r.tokens) for r in srv.run()}
        prompt = np.random.default_rng(10 + i).integers(0, 512, (2, 9)).astype(np.int32)
        jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
            gamma=GAMMA, use_cache=True, strategy="modular"))
        out[arch] = {"pair": pair, "served": served,
                     "rounds": srv.total_rounds, "prompt": prompt,
                     "spec": jeng.generate(jpt, jpd, jnp.asarray(prompt), 16)}
    return out


def test_registry_holds_the_dense_configs():
    for arch in ARCHS + ("llama3-405b",):
        assert arch in registry.ARCHS
        cfg = registry.config(arch)
        assert cfg.family == "dense" and cfg == registry.get(arch).config()
    assert registry.config("granite-3-2b").tie_embeddings
    assert registry.config("granite-3-2b").vocab_size == 49155
    ds = registry.config("deepseek-coder-33b")
    assert (ds.num_heads, ds.num_kv_heads, ds.d_model) == (56, 8, 7168)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_takes_the_configs_params(runs, arch):
    pair = runs[arch]["pair"]
    jt, _, jpt, _ = pair["jax"]
    mt, _, pt, _ = pair["torch"]
    own = mt.init(0, "cpu")
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype)), tree)
    assert shapes({k: v for k, v in pt.items() if k != "layers"}) == \
        shapes({k: v for k, v in own.items() if k != "layers"})
    assert [shapes(lp) for lp in pt["layers"]] == \
        [shapes(lp) for lp in own["layers"]]
    assert ("lm_head" in pt) == (not mt.cfg.tie_embeddings)
    toks = np.random.default_rng(1).integers(0, 512, (2, 13)).astype(np.int32)
    want, _, _ = jt.apply(jpt, jnp.asarray(toks))
    got, _, _ = mt.apply(pt, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_server_matches_jax_and_ar(runs, arch):
    r = runs[arch]
    mt, md, pt, pd = r["pair"]["torch"]
    reqs = _requests(ARCHS.index(arch))

    def serve(gamma):
        srv = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(**SERVE),
                              gamma=gamma, device="cpu",
                              watchdog=RoundWatchdog(slow_factor=float("inf")))
        for rid, (p, new) in enumerate(reqs):
            srv.submit(ServeRequest(rid, p, new))
        return srv, {q.rid: np.asarray(q.tokens) for q in srv.run()}
    srv, got = serve(GAMMA)
    _, ar = serve(0)
    assert sorted(got) == sorted(r["served"]) == [0, 1, 2]
    for rid in got:
        np.testing.assert_array_equal(got[rid], r["served"][rid])
        np.testing.assert_array_equal(got[rid], ar[rid])
    assert srv.total_rounds == r["rounds"]
    s = srv.metrics.summary()
    assert 0 < s["alpha_hat"] < 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_spec_engine_matches_jax_and_ar(runs, arch):
    r = runs[arch]
    mt, md, pt, pd = r["pair"]["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    toks, stats = eng.generate(pt, pd, r["prompt"], 16)
    want, jst = r["spec"]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted", "tokens_generated"):
        assert stats[k] == int(jst[k]), k
    ar = engine.autoregressive_generate(mt, pt, r["prompt"], 16, use_cache=True)
    np.testing.assert_array_equal(toks[:, :9 + 16].numpy(), ar.numpy())
