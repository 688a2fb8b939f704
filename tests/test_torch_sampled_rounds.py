"""Port parity for speculative sampling on every engine path where JAX
has it: the sampled cached and no-cache ``SpecEngine`` (linear, ring tree,
and the stateful Mamba-2 drafter), sampled ``autoregressive_generate``
with and without a cache, sampled ``BatchedSpecEngine.generate``, sampled
``PagedTreeRound`` and ``TracedRound``.

Under a ``JaxKey`` (tests/_jax_keys.py: ``jax.random``'s draws behind the
port's key protocol) the port splits where JAX splits, so it replays the
three sampled goldens (tests/goldens/rounds_parity.json
``single_sampled_nocache``/``single_sampled_cached``,
tests/goldens/tree_rounds.json ``tree_sampled_w2``) and JAX's tokens and
counts on a pair whose drafter disagrees with the target (the target's
first L-1 layers, embedding std d**-0.5), phase by phase for the cached
round. Tokens and counts are compared exactly. With the port's own
``TorchKey``: one seed gives one sequence of tokens, and a drafter that
is the target accepts at least 0.9 of its drafts in the no-cache mode
(the cached mode accepts less, in JAX as in the port: a finding about
the reference pinned below). Greedy keeps the argmax kernel's wrapper,
sampled rounds never call it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_keys import JaxKey  # noqa: E402
from test_torch_cached_engine import (GAMMA, MAX_NEW, PARITY, TREE,  # noqa: E402
                                      _make_pair, _prompts)
from test_torch_tree_rounds import _states as paged_states  # noqa: E402
from repro.core import batched_engine as jax_batched  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro_torch.core import batched_engine, engine, rounds  # noqa: E402
from repro_torch.kernels import spec_verify  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.sampling.keys import TorchKey  # noqa: E402

KEY = 11                     # the goldens' key seed
NEW = 16                     # new tokens on the disagreeing pair
T = 0.9                      # a temperature other than 1 on some paths


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden_pair():
    return _make_pair(split=False)


@pytest.fixture(scope="module")
def split_pair():
    return _make_pair(split=True)


def _jkey(seed=KEY):
    return jax.random.PRNGKey(seed)


# ----------------------------------------------------------------- goldens
@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_spec_engine_replays_the_sampled_golden(golden_pair, use_cache):
    mt, md, pt, pd = golden_pair["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, greedy=False, temperature=1.0, use_cache=use_cache,
        strategy="modular"))
    toks, stats = eng.generate(pt, pd, _prompts(2, 6, seed=0), MAX_NEW,
                               key=JaxKey(_jkey()))
    g = PARITY[f"single_sampled_{'cached' if use_cache else 'nocache'}"]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(g["tokens"]))
    assert (stats["rounds"], stats["accepted"]) == (g["rounds"], g["accepted"])


def test_ring_tree_engine_replays_the_sampled_tree_golden(golden_pair):
    meta = TREE["meta"]
    mt, md, pt, pd = golden_pair["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=meta["gamma"], greedy=False, temperature=1.0, use_cache=True,
        strategy="modular", draft_policy="tree", draft_k=meta["width"]))
    toks, stats = eng.generate(pt, pd, _prompts(2, 6, seed=meta["prompt_seed"]),
                               meta["max_new"], key=JaxKey(_jkey(meta["key_seed"])))
    g = TREE[f"tree_sampled_w{meta['width']}"]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(g["tokens"]))
    assert stats["rounds"] == g["rounds"]


# ------------------------------------------ engines vs JAX, disagreeing pair
ENGINES = {"linear_nocache": dict(use_cache=False),
           "linear_cached": dict(use_cache=True, temperature=T),
           "tree_cached": dict(use_cache=True, draft_policy="tree", draft_k=2)}


@pytest.fixture(scope="module")
def jax_runs(split_pair):
    """JAX's sampled runs on the disagreeing pair, once each: the three
    SpecEngine variants and AR with and without a cache."""
    jt, jd, jpt, jpd = split_pair["jax"]
    prompt = _prompts(2, 7, seed=6)
    out = {"prompt": prompt}
    for name, kw in ENGINES.items():
        jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
            gamma=GAMMA, greedy=False, strategy="modular", **kw))
        out[name] = jeng.generate(jpt, jpd, jnp.asarray(prompt), NEW,
                                  key=_jkey())
    for use_cache in (False, True):
        out[f"ar_{use_cache}"] = np.asarray(jax_engine.autoregressive_generate(
            jt, jpt, jnp.asarray(prompt), NEW, greedy=False, temperature=T,
            key=_jkey(3), use_cache=use_cache))
    return out


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_sampled_spec_engine_matches_jax(split_pair, jax_runs, name, traced,
                                         monkeypatch):
    """JAX's tokens and counts; the argmax kernel's wrapper (its plain
    version on the CPU) is never called."""
    mt, md, pt, pd = split_pair["torch"]
    kw = ENGINES[name]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, greedy=False, strategy="modular", **kw),
        tracer=Tracer(enabled=True) if traced else None)
    calls, real = [], spec_verify.plain
    monkeypatch.setattr(spec_verify, "plain",
                        lambda *a: calls.append(1) or real(*a))
    toks, stats = eng.generate(pt, pd, jax_runs["prompt"], NEW,
                               key=JaxKey(_jkey()))
    want, jst = jax_runs[name]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted", "tokens_generated"):
        assert stats[k] == int(jst[k]), k
    assert 0 < stats["accepted"] < stats["drafted"]
    assert not calls


@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_sampled_ar_matches_jax(split_pair, jax_runs, use_cache):
    mt, _, pt, _ = split_pair["torch"]
    got = engine.autoregressive_generate(
        mt, pt, jax_runs["prompt"], NEW, greedy=False, temperature=T,
        key=JaxKey(_jkey(3)), use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), jax_runs[f"ar_{use_cache}"])
    # sampled, not the argmax: the greedy continuation differs somewhere
    greedy = engine.autoregressive_generate(mt, pt, jax_runs["prompt"], NEW,
                                            use_cache=use_cache)
    assert not torch.equal(got, greedy)


def test_sampled_cached_round_phase_by_phase(split_pair):
    """The sampled cached batch_min round for six rounds against JAX's:
    drafts and their drafter logits, the verify's acceptance, then the
    committed state (the key it carries replays JAX's next split)."""
    jt, jd, jpt, jpd = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompt = _prompts(1, 7, seed=2)
    max_len = 7 + 30 + GAMMA + 2
    kw = dict(gamma=GAMMA, greedy=False, temperature=T, use_cache=True)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(**kw))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(**kw))
    jdraft, jverify, jcommit = map(jax.jit, jax_rounds.phase_fns(
        jt, jd, jeng._spec(True)))
    js = jeng.prefill(jpt, jpd, jnp.asarray(prompt), max_len, key=_jkey(5))
    ts = eng.prefill(pt, pd, prompt, max_len, key=JaxKey(_jkey(5)))
    partial = 0
    for r in range(6):
        jdo = jdraft(jpd, js)
        tdo = rounds.draft_phase(md, pd, ts, eng._spec)
        np.testing.assert_array_equal(tdo.drafts.numpy(), np.asarray(jdo.drafts))
        np.testing.assert_allclose(tdo.q_logits.numpy(), np.asarray(jdo.q_logits),
                                   atol=1e-4, rtol=1e-4)
        jv = jverify(jpt, js, jdo)
        tv = rounds.verify_phase(mt, pt, ts, tdo, eng._spec)
        for name in tv.res._fields:
            np.testing.assert_array_equal(getattr(tv.res, name).numpy(),
                                          np.asarray(getattr(jv.res, name)),
                                          err_msg=f"round {r} {name}")
        js = jcommit(js, jdo, jv)
        ts = rounds.commit_phase(mt, ts, tdo, tv, eng._spec)
        np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
        np.testing.assert_array_equal(np.asarray(ts.key.key), np.asarray(js.key))
        partial += 0 < int(tv.res.n_accepted.min()) < GAMMA
    assert partial


@pytest.mark.parametrize("policy", ["linear", "tree"])
def test_sampled_batched_generate_matches_jax(split_pair, policy):
    jt, jd, jpt, jpd = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompts = _prompts(3, 6, seed=8)
    kw = dict(gamma=GAMMA, greedy=False, draft_policy=policy, draft_k=2)
    jeng = jax_batched.BatchedSpecEngine(jt, jd, jax_batched.BatchedEngineConfig(**kw))
    want, _, wst = jeng.generate(jpt, jpd, jnp.asarray(prompts), 12, key=_jkey())
    eng = batched_engine.BatchedSpecEngine(mt, md, batched_engine.BatchedEngineConfig(**kw))
    toks, lengths, st = eng.generate(pt, pd, prompts, 12, key=JaxKey(_jkey()))
    # a row past its budget keeps drafting: only the budget is defined
    np.testing.assert_array_equal(toks[:, :6 + 12].numpy(),
                                  np.asarray(want)[:, :6 + 12])
    assert st["rounds"] == wst["rounds"]
    assert (lengths.numpy() >= 6 + 12).all()


def test_sampled_paged_tree_round_matches_ring_and_jax(split_pair):
    """Sampled ``PagedTreeRound`` (CoW forks) commits what the sampled
    ring tree round commits on the same key, and what JAX's paged round
    commits, with the four allocators' censuses balanced every round."""
    jt, jd, jpt, jpd = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompts = list(_prompts(3, 7, seed=4))
    (js, jat, jad), (ts, at, ad) = paged_states(split_pair, prompts)
    js = js._replace(key=_jkey(7))
    ts = ts._replace(key=JaxKey(_jkey(7)))
    jspec = jax_rounds.RoundSpec(gamma=GAMMA, greedy=False, commit="per_row",
                                 policy=jax_rounds.make_policy("tree", 2),
                                 fused_verify=False)
    spec = rounds.RoundSpec(gamma=GAMMA, greedy=False,
                            policy=rounds.make_policy("tree", 2))
    jrnd = jax_rounds.PagedTreeRound(jt, jd, jspec, jat, jad)
    rnd = rounds.PagedTreeRound(mt, md, spec, at, ad)
    ring = _ring_state(split_pair, ts.tokens, 7, JaxKey(_jkey(7)), spec)
    winners = 0
    for _ in range(4):
        js = jrnd(jpt, jpd, js)
        ts = rnd(pt, pd, ts)
        ring = rounds.spec_round(mt, md, pt, pd, ring, spec)
        for name in ("tokens", "length", "n_accepted"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          getattr(ring, name).numpy(), err_msg=name)
        assert at.audit() == jat.audit() and ad.audit() == jad.audit()
        winners += int(rnd.last_winner.max())
    assert winners > 0


def _ring_state(pair, tokens, L, key, spec):
    """A per-row ring state over ``tokens`` [B, T] with every row's first
    L tokens committed (both rings prefilled with L - 1)."""
    mt, md, pt, pd = pair["torch"]
    B, Tb = tokens.shape
    tcache, dcache, _, _ = engine.prefill_rings(
        mt, md, pt, pd, tokens[:, :L], Tb, engine.ring_slack(GAMMA, spec.policy),
        GAMMA)
    idx = torch.full((B,), L - 1, dtype=torch.int32)
    return rounds.RoundState(
        tokens=tokens.clone(), length=torch.full((B,), L, dtype=torch.int32),
        dcache={**dcache, "index": idx}, tcache={**tcache, "index": idx.clone()},
        key=key, active=torch.ones((B,), dtype=torch.bool),
        n_rounds=torch.zeros((), dtype=torch.int32),
        n_accepted=torch.zeros((B,), dtype=torch.int32),
        n_drafted=torch.zeros((), dtype=torch.int32))


def test_sampled_traced_round_commits_what_spec_round_commits(split_pair):
    mt, md, pt, pd = split_pair["torch"]
    spec = rounds.RoundSpec(gamma=GAMMA, greedy=False,
                            policy=rounds.make_policy("tree", 2))
    tokens = torch.from_numpy(np.pad(_prompts(2, 7, seed=9), ((0, 0), (0, 40))))
    a = _ring_state(split_pair, tokens, 7, TorchKey(2), spec)
    b = _ring_state(split_pair, tokens, 7, TorchKey(2), spec)
    traced = rounds.TracedRound(mt, md, spec, Tracer(enabled=True))
    for _ in range(3):
        a = traced(pt, pd, a)
        b = rounds.spec_round(mt, md, pt, pd, b, spec)
        torch.testing.assert_close(a.tokens, b.tokens, rtol=0, atol=0)
        assert a.key.seed == b.key.seed


# ------------------------------------------------ Mamba-2, stateful drafter
def test_sampled_cached_mamba2_engine_matches_jax():
    """The stateful drafter splits once per draft step, gamma + 1 of them
    (fp32 smoke pair whose drafter is the target's first layer)."""
    from test_torch_ssm_cached import _pair
    pair = _pair(split=True)
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(1, 21, seed=3)
    kw = dict(gamma=GAMMA, greedy=False, use_cache=True)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        strategy="modular", **kw))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), 14, key=_jkey())
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(**kw))
    assert eng._spec.d_stateful
    got, st = eng.generate(pt, pd, prompt, 14, key=JaxKey(_jkey()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted"):
        assert st[k] == int(jst[k]), k
    assert 0 < st["accepted"] < st["drafted"]


# ------------------------------------------------------- the port's own key
def test_torch_key_same_seed_same_tokens(split_pair):
    mt, md, pt, pd = split_pair["torch"]
    prompt = _prompts(2, 7, seed=6)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, greedy=False, use_cache=True))
    a, sa = eng.generate(pt, pd, prompt, NEW, key=TorchKey(1))
    b, sb = eng.generate(pt, pd, prompt, NEW, key=TorchKey(1))
    c, _ = eng.generate(pt, pd, prompt, NEW, key=TorchKey(2))
    d, _ = eng.generate(pt, pd, prompt, NEW)                # TorchKey(0)
    e, _ = eng.generate(pt, pd, prompt, NEW, key=TorchKey(0))
    assert torch.equal(a, b) and sa == sb and torch.equal(d, e)
    assert not torch.equal(a, c)


def test_a_drafter_equal_to_the_target_accepts_nearly_everything(split_pair):
    """p == q up to the float order of two passes: every draft is accepted
    but for a rare draw at the boundary (no-cache, the paper's mode)."""
    mt, _, pt, _ = split_pair["torch"]
    eng = engine.SpecEngine(mt, mt, engine.EngineConfig(
        gamma=GAMMA, greedy=False))
    _, st = eng.generate(pt, pt, _prompts(1, 7, seed=1), 24, key=TorchKey(7))
    assert st["alpha_hat"] >= 0.9, st


def test_jax_cached_drafter_lacks_the_last_draft_after_a_full_accept(split_pair):
    """A finding about the reference, kept by the port: a cached linear
    round's KV drafter consumes t_last and d_1..d_{G-1}, never d_G, yet
    after a full accept its cache is rolled to the new length, so d_G's
    slot holds no KV and the next round drafts from a cache with a hole.
    With the target drafting for itself JAX's cached engine therefore
    accepts less than its no-cache engine, which accepts everything; the
    port replays JAX's cached run exactly."""
    jt, _, jpt, _ = split_pair["jax"]
    mt, _, pt, _ = split_pair["torch"]
    prompt = _prompts(1, 7, seed=1)
    stats = {}
    for use_cache in (False, True):
        jeng = jax_engine.SpecEngine(jt, jt, jax_engine.EngineConfig(
            gamma=GAMMA, greedy=False, use_cache=use_cache, strategy="modular"))
        stats[use_cache] = jeng.generate(jpt, jpt, jnp.asarray(prompt), 24,
                                         key=_jkey(7))
    assert stats[False][1]["alpha_hat"] == 1.0
    assert stats[True][1]["alpha_hat"] < 1.0
    eng = engine.SpecEngine(mt, mt, engine.EngineConfig(
        gamma=GAMMA, greedy=False, use_cache=True))
    toks, st = eng.generate(pt, pt, prompt, 24, key=JaxKey(_jkey(7)))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(stats[True][0]))
    assert st["accepted"] == stats[True][1]["accepted"]


def test_multi_draft_stays_greedy_with_jax_message():
    with pytest.raises(ValueError) as want:
        jax_rounds.RoundSpec(gamma=GAMMA, greedy=False, use_cache=False,
                             policy=jax_rounds.make_policy("multi", 2))
    with pytest.raises(ValueError) as got:
        rounds.RoundSpec(gamma=GAMMA, greedy=False, use_cache=False,
                         commit="batch_min", policy=rounds.make_policy("multi", 2))
    assert str(got.value) == str(want.value)
