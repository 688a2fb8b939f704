"""Port parity for the MoE family on every KV serving path, against
``repro``, at smoke width, fp32, tokens exactly.

On the ``mixtral-smoke`` pair (window 16, so rings wrap; E 4, top-2) and
the ``llama4-smoke`` pair (two blocks of a dense and an MoE layer, a shared
expert, top-1), each with a drafter that is the target's first block
(``_serving_parity.moe_pair``): ``PagedSpecServer``
bucketed and chunked at chunk 8 with the prefix pool, in lockstep with
JAX's server (tokens, rounds and acceptance JAX's; tokens AR's),
``BatchedSpecEngine.generate``, the cached and the no-cache
``SpecEngine``, the continuous server and ``Session``'s backend choice.
Where JAX's rings hold 22 slots and the port's 32 (window 16) the budget's
tokens are compared; at window 26 both hold 32 and rounds and acceptance
are JAX's too (the drafter's hole, ROADMAP). Cached w8a8 is in
tests/test_torch_w8a8_cached.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _serving_parity import (lockstep, moe_pair,  # noqa: E402
                             one_torch_thread, same_metrics, serve_port,
                             servers)
from repro import api as japi  # noqa: E402
from repro.core import batched_engine as jax_batched  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.launch.continuous import ContinuousSpecServer as JaxCont  # noqa: E402
from repro.launch.continuous import StreamRequest as JaxStream  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import batched_engine, engine  # noqa: E402
from repro_torch.launch.continuous import (ContinuousSpecServer,  # noqa: E402
                                           StreamRequest)

GAMMA = 4
P, NEW = 20, 24            # 43 positions: past a 32-slot ring
REQS = [(7, 10), (12, 8), (5, 12)]
STATS = ("rounds", "accepted", "drafted", "tokens_generated")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def mixtral():
    return moe_pair("mixtral-8x7b")


@pytest.fixture(scope="module")
def llama4():
    return moe_pair("llama4-maverick-400b-a17b", blocks=2)


def _prompts(n, length, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, length)).astype(
        np.int32)


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, p).astype(np.int32), new) for p, new in REQS]


def _same(got, want, n=None):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, :n], want[:, :n])


# ------------------------------------------------------------- paged server
@pytest.mark.parametrize("arch,chunk", [("mixtral", None), ("llama4", 8)])
def test_paged_server_matches_jax_and_ar(arch, chunk, request):
    """Bucketed, or chunked at 8 with the prefix pool; stepped in lockstep
    with JAX's server (step infos, allocator, free list), then its counts
    and tokens, which equal AR's."""
    pair = request.getfixturevalue(arch)
    reqs = _requests(1)
    cfg = {} if chunk is None else dict(prefill_chunk=chunk, prefix_cache=True)
    port, ref = servers(pair, 3, **cfg)
    _, got, want = lockstep(port, ref, reqs)
    same_metrics(port, ref)
    assert port.total_rounds == ref.total_rounds
    _, ar = serve_port(pair, reqs, 0, **cfg)
    assert sorted(got) == sorted(want) == sorted(ar) == [0, 1, 2]
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(got[rid], ar[rid])
    s = port.metrics.summary()
    assert 0 < s["alpha_hat"] < 1
    if chunk:
        assert s["chunks_per_prefill"] > 1


# ---------------------------------------------------------- the ring engines
@pytest.fixture(scope="module")
def jax_runs(mixtral, llama4):
    """JAX's tokens on each engine path (one run each)."""
    jt, jd, jpt, jpd = mixtral["jax"]
    out = {"prompt": _prompts(2, P, 3), "prompts": _prompts(3, P, 4)}
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy="modular"))
    out["cached"] = jeng.generate(jpt, jpd, jnp.asarray(out["prompt"]), NEW)
    jb = jax_batched.BatchedSpecEngine(jt, jd, jax_batched.BatchedEngineConfig(
        gamma=GAMMA))
    out["batched"] = jb.generate(jpt, jpd, jnp.asarray(out["prompts"]), NEW)
    srv = JaxCont(jt, jd, jpt, jpd, batch=2, prompt_len=P, max_new=NEW,
                  gamma=GAMMA)
    for i, p in enumerate(_prompts(3, P, 5)):
        srv.submit(JaxStream(i, p))
    out["continuous"] = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    jt, jd, jpt, jpd = llama4["jax"]
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=False, strategy="modular"))
    out["nocache"] = jeng.generate(jpt, jpd, jnp.asarray(out["prompt"]), 16)
    return out


def test_cached_spec_engine_wraps_its_rings_with_jaxs_tokens(mixtral, jax_runs):
    mt, md, pt, pd = mixtral["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    toks, stats = eng.generate(pt, pd, jax_runs["prompt"], NEW)
    want, _ = jax_runs["cached"]
    _same(toks, want, P + NEW)
    ar = engine.autoregressive_generate(mt, pt, jax_runs["prompt"], NEW,
                                        use_cache=True)
    _same(toks, ar, P + NEW)
    assert 0 < stats["accepted"] < stats["drafted"]
    assert mt.init_cache(2, P + NEW, GAMMA + 2, device="cpu")["k"].shape[2] \
        == 32 < P + NEW                                  # the ring wraps


def test_rings_of_one_length_give_jaxs_rounds_and_acceptance():
    """Window 26: JAX's ring (26 + γ + 2) and the port's hold 32 slots."""
    pair = moe_pair("mixtral-8x7b", window=26)
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(1, 28, 6)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy="modular"))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), 20)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    toks, stats = eng.generate(pt, pd, prompt, 20)
    _same(toks, want)
    for k in STATS:
        assert stats[k] == int(jst[k]), k
    assert 0 < stats["accepted"] < stats["drafted"]


def test_batched_generate_matches_jax_and_ar(mixtral, jax_runs):
    mt, md, pt, pd = mixtral["torch"]
    eng = batched_engine.BatchedSpecEngine(
        mt, md, batched_engine.BatchedEngineConfig(gamma=GAMMA))
    toks, _, _ = eng.generate(pt, pd, jax_runs["prompts"], NEW)
    want, _, _ = jax_runs["batched"]
    _same(toks, want, P + NEW)
    ar = engine.autoregressive_generate(mt, pt, jax_runs["prompts"], NEW,
                                        use_cache=True)
    _same(toks, ar, P + NEW)


def test_continuous_server_matches_jax(mixtral, jax_runs):
    mt, md, pt, pd = mixtral["torch"]
    srv = ContinuousSpecServer(mt, md, pt, pd, batch=2, prompt_len=P,
                               max_new=NEW, gamma=GAMMA)
    for i, p in enumerate(_prompts(3, P, 5)):
        srv.submit(StreamRequest(i, p))
    done = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    want = jax_runs["continuous"]
    assert sorted(done) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(done[rid], want[rid], err_msg=f"rid {rid}")


def test_nocache_spec_engine_matches_jax_and_ar(llama4, jax_runs):
    mt, md, pt, pd = llama4["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA))
    toks, stats = eng.generate(pt, pd, jax_runs["prompt"], 16)
    want, jst = jax_runs["nocache"]
    _same(toks, want)
    for k in STATS:
        assert stats[k] == int(jst[k]), k
    _same(toks, engine.autoregressive_generate(mt, pt, jax_runs["prompt"], 16))
    assert 0 < stats["accepted"] < stats["drafted"]


def _plans(**kw):
    kw.update(cost_coefficient=0.2, adaptive_gamma=False)
    plans = (api.Planner(api.DeploymentSpec(**kw)).plan(),
             japi.Planner(japi.DeploymentSpec(**kw)).plan())
    return tuple(dataclasses.replace(p, gamma=dataclasses.replace(p.gamma,
                                                                   gamma=3))
                 for p in plans)


def test_session_serves_moe_pairs_on_the_kv_backends(llama4):
    """``Session`` picks JAX's backend for an MoE pair: per-row for a fixed
    batch, paged for ragged streams; the per-row batch gives AR's tokens."""
    for kw, name in ((dict(batch_size=2, prompt_lens=(6,), max_new=8),
                      "per_row"),
                     (dict(batch_size=2, prompt_lens=(5, 9), max_new=(6, 4),
                           streaming=True), "paged")):
        plan, jplan = _plans(**kw)
        sess = api.Session(*llama4["torch"], plan, device="cpu", max_batch=2)
        jsess = japi.Session(*llama4["jax"], jplan, max_batch=2)
        assert sess.backend_name == jsess.backend_name == name
    plan, _ = _plans(batch_size=2, prompt_lens=(6,), max_new=8)
    sess = api.Session(*llama4["torch"], plan, device="cpu", max_batch=2)
    prompts = _prompts(2, 6, 8)
    toks, _, _ = sess.generate_batch(prompts, 8)
    mt, _, pt, _ = llama4["torch"]
    _same(toks, engine.autoregressive_generate(mt, pt, prompts, 8,
                                               use_cache=True), 14)
