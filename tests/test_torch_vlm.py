"""The VLM family in the port against ``repro``'s, on the ``internvl2-26b``
smoke config (fp32, 2 layers, 8 vision tokens of width ``VIT_DIM``; the
drafter is the target's first layer with its embedding, projector and
head, weights bridged from JAX's). Patches are seeded numpy stand-ins for
the stub vision front end, one set per role.

Covered: the projector and ``gelu_mlp`` (tanh gelu, JAX's default);
no-cache logits with patches (text positions only) and the cached
prefill's KV and index (the vision prefix in the ring, t_off = 8); the
no-cache and cached ``SpecEngine`` == JAX's engine == AR with patches, at
P = 5 and P = 1 (the vision prefix prefilled with no text); no-cache
multi-draft; sampled rounds under ``JaxKey``; ``BatchedSpecEngine`` and
``PagedSpecServer`` taking the VLM text-only at ``num_vision_tokens=0``,
as JAX's own tests run them; ``Session.generate`` passing extras through;
placed rounds refusing extras; the serve CLI serving text-only.

Tolerances: logits and KV at fp32 atol 1e-4, rtol 1e-5; tokens and
round counts exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_keys import JaxKey  # noqa: E402
from _serving_parity import lockstep, one_torch_thread, servers  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import batched_engine as jax_batched  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import vlm as jax_vlm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import placement as placement_mod  # noqa: E402
from repro_torch.api.plan import PlacementPlan, SubmeshSpec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import batched_engine, engine, rounds  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "internvl2-26b"
GAMMA = 3
NEW = 12
TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _make_pair(num_vision_tokens=None):
    jcfg, cfg = jax_registry.smoke_config(ARCH), registry.smoke_config(ARCH)
    if num_vision_tokens is not None:
        jcfg = jcfg.replace(num_vision_tokens=num_vision_tokens)
        cfg = cfg.replace(num_vision_tokens=num_vision_tokens)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jax.jit(jt.init)(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                   jpt["layers"])}
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu")),
            "vocab": cfg.vocab_size}


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


def _prompts(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _extras(pair, seed, B=2):
    """One seeded patch set per role, from each model's ``extra_inputs``
    (numpy, then torch and jnp views of the same numbers)."""
    rng = np.random.default_rng(seed)
    out = {}
    for role, m in (("t", pair["torch"][0]), ("d", pair["torch"][1])):
        shapes = m.extra_inputs(B)
        out[role] = {k: rng.standard_normal(s).astype(np.float32)
                     for k, (s, _) in shapes.items()}
    torch_ex = {r: {k: torch.from_numpy(v) for k, v in e.items()}
                for r, e in out.items()}
    jax_ex = {r: {k: jnp.asarray(v) for k, v in e.items()}
              for r, e in out.items()}
    return torch_ex, jax_ex


def _check_counts(st, jst):
    for k in ("rounds", "accepted", "drafted"):
        assert st[k] == int(jst[k]), k


def test_extra_inputs_and_cache_len_are_jaxs(pair):
    mt = pair["torch"][0]
    jt = pair["jax"][0]
    (shape, dtype), = mt.extra_inputs(3).values()
    jspec = jt.extra_inputs(3)["patches"]
    assert list(mt.extra_inputs(3)) == ["patches"]
    assert vlm.VIT_DIM == jax_vlm.VIT_DIM == 3200
    assert shape == jspec.shape == (3, 8, 3200)
    assert dtype == torch.float32
    assert mt.cache_len(20) == jt.cache_len(20) == 28


def test_projector_and_gelu_mlp_match_jax(pair):
    """The projector (rmsnorm, fc1, tanh gelu, fc2) and ``gelu_mlp`` on
    the same weights and inputs; ``L.gelu`` is ``jax.nn.gelu``'s default
    (the tanh form), which the erf form would miss by ~1e-3."""
    mt, _, pt, _ = pair["torch"]
    jt, _, jpt, _ = pair["jax"]
    rng = np.random.default_rng(0)
    patches = rng.standard_normal((2, 8, vlm.VIT_DIM)).astype(np.float32)
    got = vlm.project(mt.cfg, pt, torch.from_numpy(patches))
    want = jax_vlm.project(jt.cfg, jpt, jnp.asarray(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), **TOL)
    p = {"up": {"w": rng.standard_normal((64, 96)).astype(np.float32) / 8},
         "down": {"w": rng.standard_normal((96, 64)).astype(np.float32) / 10}}
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    np.testing.assert_allclose(
        L.gelu_mlp(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.gelu_mlp(p, jnp.asarray(x))), **TOL)


def test_nocache_logits_are_the_text_positions(pair):
    """A no-cache pass with patches returns [B, T, V] logits for the text
    (JAX's positions n_vis.., here computed after the vision prefix), and
    for the last position with ``logits_slice="last"``; without patches it
    is the dense forward."""
    mt, _, pt, _ = pair["torch"]
    jt, _, jpt, _ = pair["jax"]
    toks = _prompts((2, 7), 1)
    ex, jex = _extras(pair, 2)
    got, cache, aux = mt.apply(pt, torch.from_numpy(toks), **ex["t"])
    want, _, _ = jt.apply(jpt, jnp.asarray(toks), **jex["t"])
    assert got.shape == (2, 7, 512) and cache is None and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last, _, _ = mt.apply(pt, torch.from_numpy(toks), logits_slice="last",
                          **ex["t"])
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(), **TOL)
    plain, _, _ = mt.apply(pt, torch.from_numpy(toks))
    jplain, _, _ = jt.apply(jpt, jnp.asarray(toks))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), **TOL)
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-2


@pytest.mark.parametrize("P", [5, 1])
def test_cached_prefill_holds_the_vision_prefix(pair, P):
    """The cached prefill over patches + prompt[:, :-1] leaves the ring's
    index at 8 + P - 1 with JAX's KV in every written slot (P = 1: the
    vision prefix alone), the engine's t_off/d_off are 8, the decode
    extras drop the patches, and a decode step after it gives JAX's
    logits."""
    mt, md, pt, pd = pair["torch"]
    jt, jd, jpt, jpd = pair["jax"]
    prompt = _prompts((2, P), 3)
    ex, jex = _extras(pair, 4)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    max_len = P + NEW + GAMMA + 2
    st = eng.prefill(pt, pd, prompt, max_len, ex["t"], ex["d"])
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True))
    js = jeng.prefill(jpt, jpd, jnp.asarray(prompt), max_len, jex["t"], jex["d"])
    n = 8 + P - 1
    for c, jc in ((st.tcache, js.tcache), (st.dcache, js.dcache)):
        assert int(c["index"]) == int(jc["index"]) == n
        for leaf in ("k", "v"):
            np.testing.assert_allclose(c[leaf][:, :, :n].numpy(),
                                       np.asarray(jc[leaf])[:, :, :n], **TOL)
    assert int(st.t_off) == int(js.t_off) == 8
    assert int(st.d_off) == int(js.d_off) == 8
    assert st.extras_t is None and st.extras_d is None
    assert js.extras_t is None and js.extras_d is None
    step = torch.from_numpy(prompt[:, -1:])
    got, _, _ = mt.apply(pt, step, st.tcache, logits_slice="last")
    want, _, _ = jt.apply(jpt, jnp.asarray(prompt[:, -1:]), js.tcache,
                          logits_slice="last")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_generate(pair, prompt, jex, **kw):
    jt, jd, jpt, jpd = pair["jax"]
    key = kw.pop("key", None)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, strategy="modular", **kw))
    return jeng.generate(jpt, jpd, jnp.asarray(prompt), NEW, key=key,
                         extras_t=dict(jex["t"]), extras_d=dict(jex["d"]))


@pytest.mark.parametrize("P", [5, 1])
@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_spec_engine_with_patches_matches_jax_and_ar(pair, use_cache, P):
    """JAX's ``test_engine`` settings (gamma 3, B = 2, 10+ new tokens) on
    seeded patches, and a one-token prompt: tokens and counts are JAX's,
    and == the port's AR of the same mode == JAX's AR."""
    mt, md, pt, pd = pair["torch"]
    jt, _, jpt, _ = pair["jax"]
    prompt = _prompts((2, P), 5 + P)
    ex, jex = _extras(pair, 6 + P)
    want, jst = _jax_generate(pair, prompt, jex, use_cache=use_cache)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=use_cache))
    got, st = eng.generate(pt, pd, prompt, NEW, extras_t=ex["t"],
                           extras_d=ex["d"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW, extras=ex["t"],
                                        use_cache=use_cache)
    np.testing.assert_array_equal(got[:, :P + NEW].numpy(), ar.numpy())
    jar = jax_engine.autoregressive_generate(jt, jpt, jnp.asarray(prompt), NEW,
                                             extras=dict(jex["t"]),
                                             use_cache=use_cache)
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))


def test_partial_accepts_on_the_cached_path(pair):
    """A longer cached run where some rounds commit part of their draft,
    so the rollbacks by index + t_off are exercised; JAX's tokens and
    counts, == AR."""
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts((2, 9), 21)
    ex, jex = _extras(pair, 22)
    jt, jd, jpt, jpd = pair["jax"]
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy="modular"))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), 24,
                              extras_t=dict(jex["t"]), extras_d=dict(jex["d"]))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    got, st = eng.generate(pt, pd, prompt, 24, extras_t=ex["t"],
                           extras_d=ex["d"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)
    assert 0 < st["accepted"] < st["drafted"]
    ar = engine.autoregressive_generate(mt, pt, prompt, 24, extras=ex["t"],
                                        use_cache=True)
    np.testing.assert_array_equal(got[:, :9 + 24].numpy(), ar.numpy())


def test_multi_draft_nocache_with_patches_matches_jax(pair):
    """k = 2 candidate chains, the patches repeated along the batch for
    the stacked candidates (drafter and verify)."""
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts((2, 6), 8)
    ex, jex = _extras(pair, 9)
    want, jst = _jax_generate(pair, prompt, jex, draft_policy="multi",
                              draft_k=2)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, draft_policy="multi", draft_k=2))
    got, st = eng.generate(pt, pd, prompt, NEW, extras_t=ex["t"],
                           extras_d=ex["d"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)


@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_sampled_rounds_replay_jax_under_jax_keys(pair, use_cache):
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts((1, 6), 10)
    ex, jex = _extras(pair, 11, B=1)
    want, jst = _jax_generate(pair, prompt, jex, use_cache=use_cache,
                              greedy=False, key=jax.random.PRNGKey(3))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, greedy=False, use_cache=use_cache))
    got, st = eng.generate(pt, pd, prompt, NEW, key=JaxKey(jax.random.PRNGKey(3)),
                           extras_t=ex["t"], extras_d=ex["d"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)


@pytest.fixture(scope="module")
def text_pair():
    """The pair at ``num_vision_tokens=0``, as JAX's per-row and paged
    tests build it."""
    return _make_pair(num_vision_tokens=0)


def test_batched_engine_runs_the_vlm_text_only(text_pair):
    mt, md, pt, pd = text_pair["torch"]
    jt, jd, jpt, jpd = text_pair["jax"]
    assert "vlm" in batched_engine.KV_FAMILIES
    prompt = _prompts((4, 6), 12)
    jeng = jax_batched.BatchedSpecEngine(jt, jd,
                                         jax_batched.BatchedEngineConfig(gamma=GAMMA))
    want, jlen, _ = jeng.generate(jpt, jpd, jnp.asarray(prompt), NEW)
    eng = batched_engine.BatchedSpecEngine(
        mt, md, batched_engine.BatchedEngineConfig(gamma=GAMMA))
    got, lengths, _ = eng.generate(pt, pd, prompt, NEW)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(got[:, :6 + NEW].numpy(),
                                  np.asarray(want)[:, :6 + NEW])
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW)
    np.testing.assert_array_equal(got[:, :6 + NEW].numpy(), ar.numpy())


def test_paged_server_runs_the_vlm_text_only_in_lockstep_with_jax(text_pair):
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(0, 512, P).astype(np.int32), new)
            for P, new in ((5, 8), (9, 6), (6, 4), (7, 9))]
    port, ref = servers(text_pair, GAMMA)
    _, got, want = lockstep(port, ref, reqs)
    mt, _, pt, _ = text_pair["torch"]
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for i, (p, new) in enumerate(reqs):
        np.testing.assert_array_equal(got[i], want[i])
        ar = engine.autoregressive_generate(mt, pt, p[None], new)
        np.testing.assert_array_equal(got[i], ar[0].numpy())


@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_session_passes_extras_to_the_engine_backend(pair, use_cache):
    """A B = 2 plan pinned to the monolithic strategy runs the engine
    backend in both Sessions; the patches pass through ``generate`` to the
    speculative path and to the AR path (gamma forced to 0), with JAX's
    tokens."""
    kw = dict(batch_size=2, prompt_lens=(5,), max_new=NEW, use_cache=use_cache,
              cost_coefficient=0.2, adaptive_gamma=False, strategy="monolithic")
    plan = api.Planner(api.DeploymentSpec(**kw)).plan()
    jplan = japi.Planner(japi.DeploymentSpec(**kw)).plan()
    assert plan.to_json() == jplan.to_json()
    prompt = _prompts((2, 5), 14)
    ex, jex = _extras(pair, 15)
    for gamma in (plan.gamma.gamma, 0):
        p = dataclasses.replace(
            plan, gamma=dataclasses.replace(plan.gamma, gamma=gamma))
        jp = dataclasses.replace(
            jplan, gamma=dataclasses.replace(jplan.gamma, gamma=gamma))
        sess = api.Session(*pair["torch"], p, device="cpu")
        jsess = japi.Session(*pair["jax"], jp)
        assert sess.backend_name == jsess.backend_name == "engine"
        toks, st = sess.generate(prompt, NEW, extras_t=ex["t"], extras_d=ex["d"])
        jtoks, jst = jsess.generate(jnp.asarray(prompt), NEW,
                                    extras_t=dict(jex["t"]),
                                    extras_d=dict(jex["d"]))
        np.testing.assert_array_equal(np.asarray(toks), np.asarray(jtoks))
        assert st["speculative"] == (gamma > 0)
        for k in ("rounds", "accepted", "drafted", "tokens_generated"):
            assert st[k] == int(jst[k]), (gamma, k)


def test_adaptive_session_with_patches_equals_ar(pair):
    """The adaptive path prefills with the extras once and runs every
    candidate gamma's round on that state: greedy tokens == AR."""
    plan = api.Planner(api.DeploymentSpec(
        batch_size=2, prompt_lens=(5,), max_new=NEW, use_cache=True,
        cost_coefficient=0.2, adaptive_gamma=True, strategy="monolithic")).plan()
    assert plan.gamma.adaptive and plan.gamma.candidates
    sess = api.Session(*pair["torch"], plan, device="cpu")
    prompt = _prompts((2, 5), 16)
    ex, _ = _extras(pair, 17)
    toks, st = sess.generate(prompt, NEW, extras_t=ex["t"], extras_d=ex["d"])
    mt, _, pt, _ = pair["torch"]
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW, extras=ex["t"],
                                        use_cache=True)
    np.testing.assert_array_equal(toks[:, :5 + NEW].numpy(), ar.numpy())
    assert st["gamma_trace"]


def test_placed_rounds_refuse_extras(pair):
    """Placed rounds do not carry modality extras (JAX's ``place_state``
    message). A cached VLM keeps none past its prefill (the patches are
    consumed there), so it runs placed, as in JAX, shifting the drafter's
    rollback by d_off: tokens == AR."""
    mt, md, pt, pd = pair["torch"]
    pm = placement_mod.lower(
        PlacementPlan(drafter=SubmeshSpec("d1", ("dx",), (1,)),
                      target=SubmeshSpec("t1", ("tx",), (1,))),
        [torch.device("cpu")] * 2)
    assert pm.heterogeneous
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True),
                            placement=pm)
    prompt = _prompts((2, 5), 18)
    ex, _ = _extras(pair, 19)
    st = eng.prefill(pt, pd, prompt, 5 + NEW + GAMMA + 2, ex["t"], ex["d"])
    with pytest.raises(NotImplementedError, match="modality extras"):
        rounds.place_state(st._replace(extras_t={"cross": {}}), pm, mt, md)
    with pytest.raises(NotImplementedError, match="modality extras"):
        eng._placed_round(pt, pd, st._replace(extras_d={"patches": ex["d"]["patches"]}))
    got, _ = eng.generate(pt, pd, prompt, NEW, extras_t=ex["t"], extras_d=ex["d"])
    assert eng.placement_note == "" and eng.placement is pm
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW, extras=ex["t"],
                                        use_cache=True)
    np.testing.assert_array_equal(got[:, :5 + NEW].numpy(), ar.numpy())


def test_serve_cli_serves_the_vlm_text_only(capsys):
    """``launch.serve --arch internvl2-26b --smoke --speculative``: 8
    requests of 24 new tokens served text-only, as JAX's CLI serves them
    (192 tokens)."""
    toks, s = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--speculative"])
    assert toks.shape[0] == 8 and s["generated"] == 192
    assert "speculative served 8 requests, 192 tokens" in capsys.readouterr().out
