"""The encoder-decoder family in the port against ``repro``'s, on the
``whisper-large-v3`` smoke config (fp32, 2 encoder and 2 decoder layers,
16 frames; embedding std 0.1, so the pair's rounds accept part of their
drafts; the drafter is the target's encoder and first decoder layer,
weights bridged from JAX's). Frames are seeded numpy stand-ins for the
stub audio front end, one set per role.

Covered: ``sinusoid``, ``encode`` and ``cross_kv`` (the port keeps JAX's
stacked [L_dec, B, T_enc, Kv, D] cross K/V; the layers are lists);
no-cache logits from frames or from precomputed cross K/V, and JAX's
``ValueError`` without either; the cached prefill's KV and index and a
decode step on the kept cross K/V; the no-cache and cached ``SpecEngine``
== JAX's engine == AR with frames, at P = 4 and P = 1 (the encoder runs
with no text to prefill); no-cache multi-draft; sampled rounds under
``JaxKey``; ``Session.generate`` passing extras through; placed engines
keeping the unplaced path while the cross K/V rides the state; the paths
that need a paged cache refusing the family; the serve CLI raising JAX's
``ValueError``.

Tolerances: activations, logits and KV at fp32 atol 1e-4, rtol 1e-5
(the sinusoid at 1500 positions: atol 3e-4, see its test); tokens and
round counts exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_keys import JaxKey  # noqa: E402
from _serving_parity import one_torch_thread  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import placement as placement_mod  # noqa: E402
from repro_torch.api.plan import PlacementPlan, SubmeshSpec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import batched_engine, engine, rounds  # noqa: E402
from repro_torch.launch import serve, serve_paged  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import PagedSpecServer, SchedulerConfig  # noqa: E402

ARCH = "whisper-large-v3"
GAMMA = 3
NEW = 12
TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_registry.smoke_config(ARCH).replace(embed_init_scale=0.1)
    cfg = registry.smoke_config(ARCH).replace(embed_init_scale=0.1)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jax.jit(jt.init)(jax.random.PRNGKey(0))
    jpd = {**jpt, "dec_layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                       jpt["dec_layers"])}
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


def _prompts(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _extras(pair, seed, B=2):
    """One seeded frame set per role, from each model's ``extra_inputs``
    (numpy, then torch and jnp views of the same numbers)."""
    rng = np.random.default_rng(seed)
    out = {}
    for role, m in (("t", pair["torch"][0]), ("d", pair["torch"][1])):
        out[role] = {k: rng.standard_normal(s).astype(np.float32)
                     for k, (s, _) in m.extra_inputs(B).items()}
    return ({r: {k: torch.from_numpy(v) for k, v in e.items()}
             for r, e in out.items()},
            {r: {k: jnp.asarray(v) for k, v in e.items()}
             for r, e in out.items()})


def _check_counts(st, jst):
    for k in ("rounds", "accepted", "drafted"):
        assert st[k] == int(jst[k]), k


def test_sinusoid_is_jaxs():
    """fp32 sin/cos table with JAX's half - 1 denominator, at the smoke
    width (TOL) and at Whisper large-v3's 1500 frames x 1280. There torch's
    and XLA's fp32 ``exp`` differ by one ulp (6e-8) on a few frequencies,
    which position 1499 turns into angles ~1e-4 apart: the frequencies are
    held within 1e-7 and the table within atol 3e-4."""
    for T, d, tol in ((16, 128, TOL), (1500, 1280, dict(atol=3e-4, rtol=0))):
        pos = np.arange(T, dtype=np.int32)
        got = encdec.sinusoid(torch.from_numpy(pos), d)
        want = jax_encdec.sinusoid(jnp.asarray(pos), d)
        assert got.dtype == torch.float32 and got.shape == (T, d)
        np.testing.assert_allclose(got[1, :d // 2].numpy(),
                                   np.asarray(want)[1, :d // 2], atol=1e-7,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    pos = np.arange(12, dtype=np.int32).reshape(2, 6)        # per-row positions
    np.testing.assert_allclose(encdec.sinusoid(torch.from_numpy(pos), 64).numpy(),
                               np.asarray(jax_encdec.sinusoid(jnp.asarray(pos), 64)),
                               **TOL)


def test_encode_and_cross_kv_are_jaxs(pair):
    mt, _, pt, _ = pair["torch"]
    jt, _, jpt, _ = pair["jax"]
    ex, jex = _extras(pair, 0)
    enc = encdec.encode(mt.cfg, pt, ex["t"]["frames"])
    jenc = jax_encdec.encode(jt.cfg, jpt, jex["t"]["frames"])
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    cross = encdec.cross_kv(mt.cfg, pt, enc)
    jcross = jax_encdec.cross_kv(jt.cfg, jpt, jenc)
    for leaf in ("k", "v"):
        assert cross[leaf].shape == jcross[leaf].shape == (2, 2, 16, 4, 32)
        np.testing.assert_allclose(cross[leaf].numpy(), np.asarray(jcross[leaf]),
                                   **TOL)
    got = mt.encode(pt, ex["t"]["frames"])
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(got[leaf].numpy(), cross[leaf].numpy())


def test_nocache_logits_from_frames_or_cross(pair):
    """The decoder's full pass from frames returns the cross K/V as aux;
    the same pass on that cross gives the same logits; neither raises
    JAX's ``ValueError``."""
    mt, _, pt, _ = pair["torch"]
    jt, _, jpt, _ = pair["jax"]
    toks = _prompts((2, 7), 1)
    ex, jex = _extras(pair, 2)
    got, cache, aux = mt.apply(pt, torch.from_numpy(toks), **ex["t"])
    want, _, jaux = jt.apply(jpt, jnp.asarray(toks), **jex["t"])
    assert got.shape == (2, 7, 512) and cache is None and list(aux) == ["cross"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    again, _, aux2 = mt.apply(pt, torch.from_numpy(toks), cross=aux["cross"])
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    assert aux2["cross"] is aux["cross"]
    last, _, _ = mt.apply(pt, torch.from_numpy(toks), logits_slice="last",
                          cross=aux["cross"])
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(), **TOL)
    with pytest.raises(ValueError, match="encdec needs frames or precomputed cross KV"):
        mt.apply(pt, torch.from_numpy(toks))
    with pytest.raises(ValueError, match="encdec needs frames or precomputed cross KV"):
        jt.apply(jpt, jnp.asarray(toks))


@pytest.mark.parametrize("P", [4, 1])
def test_cached_prefill_keeps_the_cross_kv(pair, P):
    """The engine's cached prefill: the unwindowed decoder ring at index P
    - 1 with JAX's KV, offsets 0, the frames dropped and the cross K/V
    (JAX's) kept as each role's decode extra; then a decode step on it."""
    mt, md, pt, pd = pair["torch"]
    jt, jd, jpt, jpd = pair["jax"]
    prompt = _prompts((2, P), 3)
    ex, jex = _extras(pair, 4)
    max_len = P + NEW + GAMMA + 2
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    st = eng.prefill(pt, pd, prompt, max_len, ex["t"], ex["d"])
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True))
    js = jeng.prefill(jpt, jpd, jnp.asarray(prompt), max_len, jex["t"], jex["d"])
    assert "positions" not in st.tcache
    for c, jc in ((st.tcache, js.tcache), (st.dcache, js.dcache)):
        assert int(c["index"]) == int(jc["index"]) == P - 1
        for leaf in ("k", "v"):
            np.testing.assert_allclose(c[leaf][:, :, :P - 1].numpy(),
                                       np.asarray(jc[leaf])[:, :, :P - 1], **TOL)
    assert int(st.t_off) == int(js.t_off) == 0
    for ours, theirs in ((st.extras_t, js.extras_t), (st.extras_d, js.extras_d)):
        assert list(ours) == list(theirs) == ["cross"]
        for leaf in ("k", "v"):
            np.testing.assert_allclose(ours["cross"][leaf].numpy(),
                                       np.asarray(theirs["cross"][leaf]), **TOL)
    step = torch.from_numpy(prompt[:, -1:])
    got, _, _ = mt.apply(pt, step, st.tcache, logits_slice="last", **st.extras_t)
    want, _, _ = jt.apply(jpt, jnp.asarray(prompt[:, -1:]), js.tcache,
                          logits_slice="last", **js.extras_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_generate(pair, prompt, jex, new=NEW, **kw):
    jt, jd, jpt, jpd = pair["jax"]
    key = kw.pop("key", None)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, strategy="modular", **kw))
    return jeng.generate(jpt, jpd, jnp.asarray(prompt), new, key=key,
                         extras_t=dict(jex["t"]), extras_d=dict(jex["d"]))


@pytest.mark.parametrize("P", [4, 1])
@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_spec_engine_with_frames_matches_jax_and_ar(pair, use_cache, P):
    """No cache, every forward encodes its frames again (JAX's semantics);
    cached, the prefill encodes them once and the rounds run on the cross
    K/V. Tokens and counts are JAX's, some round commits part of its
    draft, and tokens == the port's AR == JAX's AR."""
    mt, md, pt, pd = pair["torch"]
    jt, _, jpt, _ = pair["jax"]
    prompt = _prompts((2, P), 5 + P)
    ex, jex = _extras(pair, 6 + P)
    want, jst = _jax_generate(pair, prompt, jex, new=16, use_cache=use_cache)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=use_cache))
    got, st = eng.generate(pt, pd, prompt, 16, extras_t=ex["t"],
                           extras_d=ex["d"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)
    assert 0 < st["accepted"] < st["drafted"]
    ar = engine.autoregressive_generate(mt, pt, prompt, 16, extras=ex["t"],
                                        use_cache=use_cache)
    np.testing.assert_array_equal(got[:, :P + 16].numpy(), ar.numpy())
    jar = jax_engine.autoregressive_generate(jt, jpt, jnp.asarray(prompt), 16,
                                             extras=dict(jex["t"]),
                                             use_cache=use_cache)
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))


def test_nocache_passes_reencode_the_frames(pair, monkeypatch):
    """No cache: each drafter and target pass encodes its frames again
    (JAX keeps no cross K/V there); cached: each model encodes once, in
    its prefill."""
    mt, md, pt, pd = pair["torch"]
    calls = []
    real = encdec.encode

    def spy(cfg, params, frames):
        calls.append(cfg.name)
        return real(cfg, params, frames)
    monkeypatch.setattr(encdec, "encode", spy)
    prompt = _prompts((2, 4), 7)
    ex, _ = _extras(pair, 8)
    for use_cache in (False, True):
        calls.clear()
        eng = engine.SpecEngine(mt, md, engine.EngineConfig(
            gamma=GAMMA, use_cache=use_cache))
        _, st = eng.generate(pt, pd, prompt, NEW, extras_t=ex["t"],
                             extras_d=ex["d"])
        want = ({"draft": GAMMA * st["rounds"], mt.cfg.name: st["rounds"]}
                if not use_cache else {"draft": 1, mt.cfg.name: 1})
        assert {n: calls.count(n) for n in set(calls)} == want


def test_multi_draft_nocache_with_frames_matches_jax(pair):
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts((2, 5), 9)
    ex, jex = _extras(pair, 10)
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
    prompt = _prompts((1, 5), 11)
    ex, jex = _extras(pair, 12, B=1)
    want, jst = _jax_generate(pair, prompt, jex, use_cache=use_cache,
                              greedy=False, key=jax.random.PRNGKey(4))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, greedy=False, use_cache=use_cache))
    got, st = eng.generate(pt, pd, prompt, NEW, key=JaxKey(jax.random.PRNGKey(4)),
                           extras_t=ex["t"], extras_d=ex["d"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)


@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_session_passes_extras_to_the_engine_backend(pair, use_cache):
    """A batched plan on the encoder-decoder runs the engine backend in
    both Sessions (per-row rollback needs the KV families); the frames
    pass through ``generate`` to the speculative path and to the AR path
    (gamma forced to 0), with JAX's tokens."""
    kw = dict(batch_size=2, prompt_lens=(4,), max_new=NEW, use_cache=use_cache,
              cost_coefficient=0.2, adaptive_gamma=False)
    plan = api.Planner(api.DeploymentSpec(**kw)).plan()
    jplan = japi.Planner(japi.DeploymentSpec(**kw)).plan()
    assert plan.to_json() == jplan.to_json()
    prompt = _prompts((2, 4), 13)
    ex, jex = _extras(pair, 14)
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
        for k in ("rounds", "accepted", "drafted", "tokens_generated"):
            assert st[k] == int(jst[k]), (gamma, k)


def test_placed_engine_keeps_the_unplaced_path_with_cross(pair):
    """The cached encoder-decoder keeps its cross K/V as a decode extra,
    which placed rounds do not carry (JAX's ``place_state`` message): a
    placed engine runs unplaced, says so, and still gives AR's tokens."""
    mt, md, pt, pd = pair["torch"]
    pm = placement_mod.lower(
        PlacementPlan(drafter=SubmeshSpec("d1", ("dx",), (1,)),
                      target=SubmeshSpec("t1", ("tx",), (1,))),
        [torch.device("cpu")] * 2)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True),
                            placement=pm)
    prompt = _prompts((2, 4), 15)
    ex, _ = _extras(pair, 16)
    st = eng.prefill(pt, pd, prompt, 4 + NEW + GAMMA + 2, ex["t"], ex["d"])
    with pytest.raises(NotImplementedError, match="modality extras"):
        rounds.place_state(st, pm, mt, md)
    with pytest.raises(NotImplementedError, match="modality extras"):
        eng._placed_round(pt, pd, st)
    got, _ = eng.generate(pt, pd, prompt, NEW, extras_t=ex["t"], extras_d=ex["d"])
    assert eng.placement_note == "modality extras are single-mesh"
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW, extras=ex["t"],
                                        use_cache=True)
    np.testing.assert_array_equal(got[:, :4 + NEW].numpy(), ar.numpy())


def test_paged_paths_refuse_the_family_as_in_jax(pair):
    """No paged cache for the encoder-decoder (JAX's ``init_paged_cache``
    raises too); the per-row engine, the paged server and its CLI take the
    KV families only."""
    mt, md, pt, pd = pair["torch"]
    jt = pair["jax"][0]
    with pytest.raises(ValueError, match="paged KV cache unsupported for family 'encdec'"):
        mt.init_paged_cache(2, 16, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        jt.init_paged_cache(2, 16, 4, 4)
    assert "encdec" not in batched_engine.KV_FAMILIES
    with pytest.raises(ValueError, match="KV-cache families"):
        batched_engine.BatchedSpecEngine(mt, md, batched_engine.BatchedEngineConfig())
    with pytest.raises(ValueError, match="KV-cache families"):
        PagedSpecServer(mt, md, pt, pd, SchedulerConfig(), device="cpu")
    with pytest.raises(SystemExit, match="family 'encdec'"):
        serve_paged.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "2"])


def test_serve_cli_raises_jaxs_error_without_frames():
    """``launch.serve --arch whisper-large-v3 --smoke --speculative``
    serves no frames, so its first forward raises JAX's ``ValueError``, as
    ``repro.launch.serve`` does."""
    with pytest.raises(ValueError, match="encdec needs frames or precomputed cross KV"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--speculative", "--requests", "2", "--batch", "2"])
