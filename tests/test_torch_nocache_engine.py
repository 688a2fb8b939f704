"""Port parity for the paper's no-cache speculative engine: the no-cache
forward, the no-cache draft policies (linear and multi-draft), the
recompute verify, the ``batch_min`` commit, ``SpecEngine(use_cache=False)``
and no-cache ``autoregressive_generate``, against ``repro`` on the
``llama3.2-1b`` smoke pair.

Two pairs: the goldens' pair (target from PRNGKey(0), drafter from
PRNGKey(7) with one layer fewer, as tests/goldens/gen_goldens.py builds
it), whose drafter agrees with the target, and a pair that disagrees — the
drafter is the target's own first L-1 layers and the embedding is drawn at
std d**-0.5 — so rounds accept part of their drafts and multi-draft rounds
are won by a candidate other than 0. Logits are held to fp32 atol=1e-4,
rtol=1e-5 (XLA and PyTorch sum the matmuls in different orders); drafts,
tokens, lengths and counts are compared exactly."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import engine, rounds  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

PARITY = json.loads((pathlib.Path(__file__).parent / "goldens"
                     / "rounds_parity.json").read_text())
GAMMA = PARITY["meta"]["gamma"]
MAX_NEW = PARITY["meta"]["max_new"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def golden_pair():
    jcfg_t = jax_registry.smoke_config("llama3.2-1b")
    jcfg_d = jcfg_t.replace(num_layers=jcfg_t.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg_t), jax_build(jcfg_d)
    jpt, jpd = jt.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(7))
    cfg_t = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg_t.replace(num_layers=cfg_t.num_layers - 1, name="draft")
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg_t), build_model(cfg_d),
                      params_from_numpy(cfg_t, _to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, _to_np(jpd), "cpu"))}


@pytest.fixture(scope="module")
def split_pair():
    """The drafter is the target's first L-1 layers (shared embedding and
    head), embedding std d**-0.5: the pair disagrees in some rounds."""
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    jcfg = jcfg.replace(embed_init_scale=jcfg.d_model ** -0.5)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                   jpt["layers"])}
    cfg = registry.smoke_config("llama3.2-1b").replace(
        embed_init_scale=jcfg.d_model ** -0.5)
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, _to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, _to_np(jpd), "cpu"))}


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


@pytest.mark.parametrize("which", [0, 1], ids=["target", "drafter"])
def test_nocache_forward_logits_match_jax(golden_pair, which):
    jm, jp = golden_pair["jax"][which], golden_pair["jax"][2 + which]
    m, p = golden_pair["torch"][which], golden_pair["torch"][2 + which]
    toks = _prompts(2, 19, seed=3)
    want, jcache, _ = jm.apply(jp, jnp.asarray(toks))
    got, cache, aux = m.apply(p, torch.from_numpy(toks))
    assert jcache is None and cache is None and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("policy", ["linear", "multi"])
def test_rounds_match_jax_phase_by_phase(split_pair, policy):
    """Five no-cache rounds from one prompt batch: every phase's output —
    drafts and candidate buffers, the recompute verify's acceptance and its
    commit base (the winning candidate for multi-draft), and the batch_min
    commit — equals JAX's exactly, through partial accepts and (multi)
    rounds won by candidate 1."""
    jt, jd, jpt, jpd = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompt = _prompts(2, 6, seed=0)
    max_len = 6 + 12 + GAMMA + 2
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=False, strategy="modular",
        draft_policy=policy, draft_k=2))
    jspec = jeng._spec(False)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, draft_policy=policy, draft_k=2))
    js = jeng.prefill(jpt, jpd, jnp.asarray(prompt), max_len)
    s = eng.prefill(pt, pd, prompt, max_len)
    partial = not_first = 0
    for _ in range(5):
        jdo = jax_rounds.draft_phase(jd, jpd, js, jspec)
        d = rounds.draft_phase(md, pd, s, eng._spec)
        np.testing.assert_array_equal(d.drafts.numpy(), np.asarray(jdo.drafts))
        np.testing.assert_array_equal(d.cand_tokens.numpy(),
                                      np.asarray(jdo.cand_tokens))
        jv = jax_rounds.verify_phase(jt, jpt, js, jdo, jspec)
        v = rounds.verify_phase(mt, pt, s, d, eng._spec)
        for name in ("n_accepted", "out_tokens", "n_emitted"):
            np.testing.assert_array_equal(getattr(v.res, name).numpy(),
                                          np.asarray(getattr(jv.res, name)))
        np.testing.assert_array_equal(v.base_tokens.numpy(),
                                      np.asarray(jv.base_tokens))
        js = jax_rounds.commit_phase(jt, js, jdo, jv, jspec)
        s = rounds.commit_phase(mt, s, d, v, eng._spec)
        np.testing.assert_array_equal(s.tokens.numpy(), np.asarray(js.tokens))
        for name in ("length", "n_rounds", "n_accepted", "n_drafted"):
            assert getattr(s, name).ndim == 0
            assert int(getattr(s, name)) == int(getattr(js, name)), name
        partial += int(((v.res.n_accepted > 0)
                        & (v.res.n_accepted < GAMMA)).sum())
        not_first += int((v.base_tokens != d.cand_tokens[:, 0]).any(1).sum())
    assert partial > 0
    assert (not_first > 0) == (policy == "multi")


@pytest.mark.parametrize("strategy", ["modular", "monolithic"])
def test_spec_engine_replays_the_nocache_golden(golden_pair, strategy):
    """tests/goldens/rounds_parity.json::single_greedy_nocache token for
    token, with the same rounds and accepted counts."""
    mt, md, pt, pd = golden_pair["torch"]
    gold = PARITY["single_greedy_nocache"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, use_cache=False, strategy=strategy))
    toks, stats = eng.generate(pt, pd, _prompts(2, 6, seed=0), MAX_NEW)
    assert toks.numpy().tolist() == gold["tokens"]
    assert stats["rounds"] == gold["rounds"]
    assert stats["accepted"] == gold["accepted"]


@pytest.mark.parametrize("policy", ["linear", "multi"])
def test_spec_equals_ar_equals_jax_ar(split_pair, policy):
    jt, _, jpt, _ = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompt = _prompts(2, 7, seed=1)
    want = np.asarray(jax_engine.autoregressive_generate(
        jt, jpt, jnp.asarray(prompt), 12, use_cache=False))
    ar = engine.autoregressive_generate(mt, pt, prompt, 12)
    np.testing.assert_array_equal(ar.numpy(), want)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=4, draft_policy=policy, draft_k=2))
    toks, stats = eng.generate(pt, pd, prompt, 12)
    np.testing.assert_array_equal(toks[:, :7 + 12].numpy(), want)
    assert stats["tokens_generated"] >= 12
    assert 0 < stats["accepted"] < stats["drafted"]


@pytest.mark.parametrize("commit,use_cache,policy", [
    ("batch_min", False, "linear"), ("batch_min", False, "multi"),
    ("per_row", False, "linear"), ("per_row", False, "multi"),
    ("batch_min", False, "tree"), ("per_row", True, "multi"),
    ("batch_min", True, "multi"), ("per_row", True, "linear"),
    ("per_row", True, "tree"), ("sometimes", False, "linear")])
def test_round_spec_rejections_match_jax(commit, use_cache, policy):
    """Each combination is accepted by both or rejected by both with the
    same ValueError."""
    def make(mod):
        return mod.RoundSpec(gamma=GAMMA, commit=commit, use_cache=use_cache,
                             policy=mod.make_policy(policy, 2))
    try:
        make(jax_rounds)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make(rounds)
        assert str(got.value) == str(e)
    else:
        make(rounds)


def test_unported_modes_raise(split_pair):
    """The cached modes run since the ring cache is ported (cached batch_min
    rounds, ``SpecEngine(use_cache=True)``, cached AR, which equals the
    no-cache AR); an unknown strategy and a 1-candidate multi-draft still
    raise."""
    mt, md, pt, pd = split_pair["torch"]
    assert rounds.RoundSpec(gamma=GAMMA, commit="batch_min",
                            use_cache=True).use_cache
    prompt = _prompts(1, 4, 0)
    toks, _ = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, use_cache=True)).generate(pt, pd, prompt, 6)
    cached = engine.autoregressive_generate(mt, pt, prompt, 6, use_cache=True)
    np.testing.assert_array_equal(toks[:, :10].numpy(), cached.numpy())
    np.testing.assert_array_equal(
        cached.numpy(), engine.autoregressive_generate(mt, pt, prompt, 6).numpy())
    with pytest.raises(ValueError, match="strategy"):
        engine.SpecEngine(mt, md, engine.EngineConfig(strategy="fused"))
    with pytest.raises(ValueError, match="k >= 2"):
        rounds.make_policy("multi", 1)
