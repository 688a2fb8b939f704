"""Port parity for the cached engines on the ring KV cache: the cached
dense forward (prefill, decode steps, a Q > 1 extend, a tree pass), the
cached ``batch_min`` round phase by phase, ``SpecEngine(use_cache=True)``
(linear and ring-tree rounds, both strategies, traced and untraced),
``BatchedSpecEngine.generate`` and cached ``autoregressive_generate``,
against ``repro`` on the ``llama3.2-1b`` smoke pair.

Two pairs, as in ``test_torch_nocache_engine.py``: the goldens' pair
(tests/goldens/gen_goldens.py), whose drafter agrees with the target, and
a pair that disagrees (the drafter is the target's first L-1 layers, the
embedding drawn at std d**-0.5), so rounds accept part of their drafts and
tree rounds are won by chains other than 0. Logits are held to fp32
atol=1e-4, rtol=1e-5; drafts, tokens, lengths, indices and counts are
compared exactly. The port's rings are longer than JAX's (rounded up to a
multiple of 16, plus a tree's span), so ring contents compare on the
committed positions."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import batched_engine as jax_batched  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro.core.tree import chain_tree as jax_chain_tree  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import batched_engine, engine, rounds  # noqa: E402
from repro_torch.core.tree import chain_tree  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

GOLD = pathlib.Path(__file__).parent / "goldens"
PARITY = json.loads((GOLD / "rounds_parity.json").read_text())
TREE = json.loads((GOLD / "tree_rounds.json").read_text())
GAMMA = PARITY["meta"]["gamma"]
MAX_NEW = PARITY["meta"]["max_new"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _make_pair(split):
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    cfg = registry.smoke_config("llama3.2-1b")
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
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, _to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, _to_np(jpd), "cpu"))}


@pytest.fixture(scope="module")
def golden_pair():
    return _make_pair(split=False)


@pytest.fixture(scope="module")
def split_pair():
    return _make_pair(split=True)


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


# ------------------------------------------------------------ the forward
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_cached_forward_logits_match_jax(split_pair, per_row):
    """Prefill 7 tokens, three single-token steps, a 4-token extend and a
    chain_tree(2, 3) pass: logits and the index after each, and the written
    KV on every position both rings hold."""
    jt, _, jpt, _ = split_pair["jax"]
    mt, _, pt, _ = split_pair["torch"]
    B = 3
    toks = _prompts(B, 16, seed=4)
    jc = jt.init_cache(B, 40)
    tc = mt.init_cache(B, 40, device="cpu")
    steps = [toks[:, :7], toks[:, 7:8], toks[:, 8:9], toks[:, 9:10], toks[:, 10:14]]
    for i, chunk in enumerate(steps):
        if per_row and i == 1:
            idx = np.asarray([7, 5, 6], np.int32)
            jc = {**jc, "index": jnp.asarray(idx)}
            tc = {**tc, "index": torch.from_numpy(idx)}
        want, jc, _ = jt.apply(jpt, jnp.asarray(chunk), jc)
        got, tc, _ = mt.apply(pt, torch.from_numpy(chunk), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    tree, jtree = chain_tree(2, 3), jax_chain_tree(2, 3)
    span = _prompts(B, tree.span, seed=5)
    want, jc, _ = jt.apply(jpt, jnp.asarray(span), jc,
                           tree=(jnp.asarray(jtree.depths), jnp.asarray(jtree.bits)))
    got, tc, _ = mt.apply(pt, torch.from_numpy(span), tc,
                          tree=(tree.depths, tree.bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    n = int(np.asarray(jc["index"]).min())
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, :, :n].numpy(),
                                   np.asarray(jc[name])[:, :, :n], atol=1e-5,
                                   rtol=1e-5)


# ------------------------------------------------------ the cached round
def _compare_state(ts, js, tag):
    np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens),
                                  err_msg=tag)
    for name in ("length", "n_rounds", "n_accepted", "n_drafted"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=f"{tag} {name}")
    for c in ("tcache", "dcache"):
        tcache, jcache = getattr(ts, c), getattr(js, c)
        np.testing.assert_array_equal(tcache["index"].numpy(),
                                      np.asarray(jcache["index"]), err_msg=tag)
        n = int(np.asarray(jcache["index"]).min())
        np.testing.assert_allclose(tcache["k"][:, :, :n].numpy(),
                                   np.asarray(jcache["k"])[:, :, :n],
                                   atol=1e-5, rtol=1e-5, err_msg=f"{tag} {c}")


@pytest.mark.parametrize("policy", ["linear", "tree"])
def test_cached_batch_min_round_phase_by_phase(split_pair, policy):
    """The cached batch_min round of ``SpecEngine(use_cache=True)``, phase
    by phase for six rounds against JAX's on the pair that disagrees:
    drafts, the verify's acceptance (and tree winners), then the committed
    tokens, lengths, counters, both cache indices and the committed KV."""
    jt, jd, jpt, jpd = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompt = _prompts(1, 7, seed=2)
    max_len = 7 + 30 + GAMMA + 2
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, draft_policy=policy, draft_k=2))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, use_cache=True, draft_policy=policy, draft_k=2))
    jspec = jeng._spec(True)
    js = jeng.prefill(jpt, jpd, jnp.asarray(prompt), max_len)
    ts = eng.prefill(pt, pd, prompt, max_len)
    _compare_state(ts, js, "prefill")
    partial = 0
    for r in range(6):
        jdo = jax_rounds.draft_phase(jd, jpd, js, jspec)
        tdo = rounds.draft_phase(md, pd, ts, eng._spec)
        np.testing.assert_array_equal(tdo.drafts.numpy(), np.asarray(jdo.drafts))
        jv = jax_rounds.verify_phase(jt, jpt, js, jdo, jspec)
        tv = rounds.verify_phase(mt, pt, ts, tdo, eng._spec)
        for name in tv.res._fields:
            np.testing.assert_array_equal(getattr(tv.res, name).numpy(),
                                          np.asarray(getattr(jv.res, name)),
                                          err_msg=f"round {r} {name}")
        js = jax_rounds.commit_phase(jt, js, jdo, jv, jspec)
        ts = rounds.commit_phase(mt, ts, tdo, tv, eng._spec)
        _compare_state(ts, js, f"round {r}")
        partial += 0 < int(tv.res.n_accepted.min()) < GAMMA
    assert partial


# ----------------------------------------------------------------- goldens
@pytest.mark.parametrize("strategy", ["monolithic", "modular"])
def test_spec_engine_replays_the_cached_golden(golden_pair, strategy):
    mt, md, pt, pd = golden_pair["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy=strategy))
    toks, stats = eng.generate(pt, pd, _prompts(2, 6, seed=0), MAX_NEW)
    g = PARITY["single_greedy_cached"]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(g["tokens"]))
    assert (stats["rounds"], stats["accepted"]) == (g["rounds"], g["accepted"])


def test_batched_generate_replays_the_per_row_ring_golden(golden_pair):
    mt, md, pt, pd = golden_pair["torch"]
    eng = batched_engine.BatchedSpecEngine(
        mt, md, batched_engine.BatchedEngineConfig(gamma=GAMMA))
    toks, lengths, _ = eng.generate(pt, pd, _prompts(4, 6, seed=1), MAX_NEW)
    g = PARITY["per_row_greedy_ring"]
    np.testing.assert_array_equal(toks[:, :6 + MAX_NEW].numpy(),
                                  np.asarray(g["tokens"]))
    assert (lengths.numpy() >= np.asarray(g["lengths"])).all()


def test_ring_tree_engine_replays_the_tree_golden(golden_pair):
    meta = TREE["meta"]
    mt, md, pt, pd = golden_pair["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=meta["gamma"], use_cache=True, strategy="modular",
        draft_policy="tree", draft_k=meta["width"]))
    prompt = _prompts(2, 6, seed=meta["prompt_seed"])
    toks, stats = eng.generate(pt, pd, prompt, meta["max_new"])
    g = TREE["tree_greedy_w2"]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(g["tokens"]))
    assert (stats["rounds"], stats["accepted"]) == (g["rounds"], g["accepted"])


# -------------------------------------------------- engines vs JAX and AR
@pytest.fixture(scope="module")
def jax_split_runs(split_pair):
    """JAX's cached SpecEngine tokens/stats on the disagreeing pair (one
    run per policy; every port variant is held to the same run) and JAX's
    cached AR."""
    jt, jd, jpt, jpd = split_pair["jax"]
    prompt = _prompts(1, 7, seed=6)
    out = {"prompt": prompt}
    for policy in ("linear", "tree"):
        jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
            gamma=GAMMA, use_cache=True, strategy="modular",
            draft_policy=policy, draft_k=2))
        out[policy] = jeng.generate(jpt, jpd, jnp.asarray(prompt), 20)
    out["ar"] = np.asarray(jax_engine.autoregressive_generate(
        jt, jpt, jnp.asarray(prompt), 20, use_cache=True))
    return out


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("strategy", ["monolithic", "modular"])
@pytest.mark.parametrize("policy", ["linear", "tree"])
def test_cached_spec_engine_matches_jax_and_ar(split_pair, jax_split_runs,
                                               policy, strategy, traced):
    mt, md, pt, pd = split_pair["torch"]
    prompt = jax_split_runs["prompt"]
    tracer = Tracer(enabled=True) if traced else None
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy=strategy, draft_policy=policy,
        draft_k=2), tracer=tracer)
    toks, stats = eng.generate(pt, pd, prompt, 20)
    want, jst = jax_split_runs[policy]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted", "tokens_generated"):
        assert stats[k] == int(jst[k]), k
    np.testing.assert_array_equal(toks[:, :7 + 20].numpy(), jax_split_runs["ar"])
    assert 0 < stats["accepted"] < stats["drafted"]
    if traced:
        names = {s.name for s in tracer.spans()}
        assert names == ({"draft", "verify", "commit"} if strategy == "modular"
                         else {"generate"})


def test_cached_ar_matches_jax_and_the_nocache_ar(split_pair, jax_split_runs):
    mt, _, pt, _ = split_pair["torch"]
    prompt = jax_split_runs["prompt"]
    cached = engine.autoregressive_generate(mt, pt, prompt, 20, use_cache=True)
    nocache = engine.autoregressive_generate(mt, pt, prompt, 20)
    np.testing.assert_array_equal(cached.numpy(), jax_split_runs["ar"])
    np.testing.assert_array_equal(cached.numpy(), nocache.numpy())
    # B = 2 on the goldens' pair as well
    jt, _, jpt, _ = split_pair["jax"]
    p2 = _prompts(2, 5, seed=9)
    want = jax_engine.autoregressive_generate(jt, jpt, jnp.asarray(p2), 9,
                                              use_cache=True)
    got = engine.autoregressive_generate(mt, pt, p2, 9, use_cache=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", ["linear", "tree"])
def test_batched_generate_matches_jax(split_pair, policy):
    """Per-row rounds on the ring: rows commit different lengths each
    round; tokens, lengths and rounds equal JAX's, and each row its own AR
    continuation."""
    jt, jd, jpt, jpd = split_pair["jax"]
    mt, md, pt, pd = split_pair["torch"]
    prompts = _prompts(3, 6, seed=8)
    jeng = jax_batched.BatchedSpecEngine(jt, jd, jax_batched.BatchedEngineConfig(
        gamma=GAMMA, draft_policy=policy, draft_k=2))
    want, wlen, wst = jeng.generate(jpt, jpd, jnp.asarray(prompts), 14)
    eng = batched_engine.BatchedSpecEngine(mt, md, batched_engine.BatchedEngineConfig(
        gamma=GAMMA, draft_policy=policy, draft_k=2))
    toks, lengths, st = eng.generate(pt, pd, prompts, 14)
    # a row past its budget keeps drafting and may commit past the buffer,
    # where JAX reads a fill value: only the budget's tokens are defined
    np.testing.assert_array_equal(toks[:, :6 + 14].numpy(),
                                  np.asarray(want)[:, :6 + 14])
    assert st["rounds"] == wst["rounds"]
    assert (lengths.numpy() >= 6 + 14).all() and (np.asarray(wlen) >= 6 + 14).all()
    ar = engine.autoregressive_generate(mt, pt, prompts, 14, use_cache=True)
    np.testing.assert_array_equal(toks[:, :6 + 14].numpy(), ar.numpy())


@pytest.mark.parametrize("batched", [False, True], ids=["single", "per_row"])
def test_width1_ring_tree_is_linear(split_pair, batched):
    """A width-1 ring tree round (one chain, tree-attention verify,
    identity compaction, no replication) commits what the linear round
    commits."""
    mt, md, pt, pd = split_pair["torch"]
    prompts = _prompts(2, 6, seed=3)
    out = []
    for policy in ("linear", "tree"):
        if batched:
            eng = batched_engine.BatchedSpecEngine(mt, md, batched_engine.BatchedEngineConfig(
                gamma=GAMMA, draft_policy=policy, draft_k=1))
            toks, lengths, st = eng.generate(pt, pd, prompts, 12)
            out.append((toks[:, :6 + 12].numpy(), st["rounds"]))
        else:
            eng = engine.SpecEngine(mt, md, engine.EngineConfig(
                gamma=GAMMA, use_cache=True, draft_policy=policy, draft_k=1))
            toks, st = eng.generate(pt, pd, prompts, 12)
            out.append((toks.numpy(), st))
    for a, b in zip(*out):
        np.testing.assert_equal(a, b)


def test_ring_replication_round_trips():
    """``_take_branch`` inverts ``_replicate_rows`` on a ring (per-row and
    shared index); a paged cache is refused (PagedTreeRound forks it)."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 3, 16, 2, 4)).astype(np.float32))
    for index in (torch.tensor(5, dtype=torch.int32),
                  torch.tensor([4, 6, 5], dtype=torch.int32)):
        cache = {"k": k, "v": k + 1, "index": index}
        rep = rounds._replicate_rows(cache, 2)
        assert tuple(rep["k"].shape) == (2, 6, 16, 2, 4)
        back = rounds._take_branch(rep, torch.tensor([1, 0, 1]), 2)
        for n in ("k", "v", "index"):
            np.testing.assert_array_equal(back[n].numpy(), cache[n].numpy())
    with pytest.raises(NotImplementedError, match="PagedTreeRound"):
        rounds._replicate_rows({**cache, "block_table": torch.zeros(3, 4)}, 2)


@pytest.mark.parametrize("d_stateful,commit,use_cache,policy", [
    (True, "batch_min", True, "linear"), (True, "per_row", True, "linear"),
    (True, "batch_min", False, "linear"), (True, "batch_min", True, "tree"),
    (False, "batch_min", True, "tree"), (False, "batch_min", True, "linear")])
def test_round_spec_state_rules_match_jax(d_stateful, commit, use_cache, policy):
    """Cached batch_min rounds are accepted; a stateful drafter needs the
    cached batch_min path and a linear policy, with JAX's messages."""
    def make(mod):
        return mod.RoundSpec(gamma=GAMMA, commit=commit, use_cache=use_cache,
                             d_stateful=d_stateful,
                             policy=mod.make_policy(policy, 2))
    try:
        make(jax_rounds)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make(rounds)
        assert str(got.value) == str(e)
    else:
        assert make(rounds).d_stateful == d_stateful
