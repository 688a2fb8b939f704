"""Port parity for the cached engines over windowed rings that wrap,
against ``repro`` (the read itself is held in
tests/test_torch_windowed_ring.py).

On the ``llama3.2-1b`` smoke pair with ``sliding_window=16`` every
engine's ring holds 32 slots (window + slack, rounded up to the page):
the cached ``SpecEngine`` (linear and ring tree), cached AR,
``BatchedSpecEngine.generate`` and ``ContinuousSpecServer`` give JAX's
tokens over generations that wrap their rings at least twice, each
prefill longer than the ring runs windowed causal attention over its own
tokens, and every round's ring read is decided from shapes (the
``ring_calls`` fixture). With a window of 26 both packages' rings hold 32
slots and the rounds and acceptances are JAX's too. Tokens compare
exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread, windowed_pair  # noqa: E402
from repro.core import batched_engine as jax_batched  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.launch.continuous import ContinuousSpecServer as JaxServer  # noqa: E402
from repro.launch.continuous import StreamRequest as JaxRequest  # noqa: E402
from repro_torch.core import batched_engine, engine  # noqa: E402
from repro_torch.launch.continuous import (ContinuousSpecServer,  # noqa: E402
                                           StreamRequest)
from repro_torch.models import dense  # noqa: E402

WINDOW = 16
GAMMA = 4
P, NEW = 36, 40            # prefill 35 > the 32-slot ring; ends past 2 wraps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return windowed_pair(WINDOW)


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


# --------------------------------------------------------------- the engines
@pytest.fixture(scope="module")
def jax_runs(pair):
    """JAX's tokens on each engine path (one run each)."""
    jt, jd, jpt, jpd = pair["jax"]
    prompt = _prompts(1, P, seed=6)
    out = {"prompt": prompt}
    for policy in ("linear", "tree"):
        jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
            gamma=GAMMA, use_cache=True, strategy="modular",
            draft_policy=policy, draft_k=2))
        out[policy] = jeng.generate(jpt, jpd, jnp.asarray(prompt), NEW)
    out["ar"] = np.asarray(jax_engine.autoregressive_generate(
        jt, jpt, jnp.asarray(prompt), NEW, use_cache=True))
    prompts = _prompts(3, P, seed=8)
    jeng = jax_batched.BatchedSpecEngine(jt, jd, jax_batched.BatchedEngineConfig(
        gamma=GAMMA))
    out["batched"] = jeng.generate(jpt, jpd, jnp.asarray(prompts), NEW)
    srv = JaxServer(jt, jd, jpt, jpd, batch=2, prompt_len=P, max_new=40,
                    gamma=GAMMA)
    for i, p in enumerate(_prompts(3, P, seed=9)):
        srv.submit(JaxRequest(i, p))
    out["continuous"] = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    return out


@pytest.fixture
def ring_calls(monkeypatch):
    """Every ring read of the test: (Q, W, index before the call, mode)."""
    seen = []
    real = dense.ring_read

    def spy(cfg, cache, Q, tree=None):
        out = real(cfg, cache, Q, tree)
        seen.append((Q, cache["k"].shape[2], int(cache["index"].max()), out[0]))
        return out
    monkeypatch.setattr(dense, "ring_read", spy)
    return seen


def _rings_wrapped_twice_and_rounds_from_shapes(seen, last_position):
    assert last_position > 2 * 32
    for Q, W, first, mode in seen:
        assert W == 32
        # a round fits the slack (decided from shapes, no host read); only
        # a prefill from index 0 is longer, and it is exact
        assert Q <= W - WINDOW + 1 or first == 0, (Q, first)
        assert mode == ("flash" if Q > W else "write")
    assert any(mode == "flash" for *_, mode in seen)


@pytest.mark.parametrize("policy", ["linear", "tree"])
def test_cached_spec_engine_matches_jax(pair, jax_runs, ring_calls, policy):
    mt, md, pt, pd = pair["torch"]
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, use_cache=True, draft_policy=policy, draft_k=2))
    toks, stats = eng.generate(pt, pd, jax_runs["prompt"], NEW)
    want, jst = jax_runs[policy]
    # the budget's tokens: see the next test for the rounds and lengths
    np.testing.assert_array_equal(toks[:, :P + NEW].numpy(),
                                  np.asarray(want)[:, :P + NEW])
    assert 0 < stats["accepted"] < stats["drafted"]
    np.testing.assert_array_equal(toks[:, :P + NEW].numpy(), jax_runs["ar"])
    _rings_wrapped_twice_and_rounds_from_shapes(ring_calls, P + NEW)


def test_rings_of_one_length_give_jaxs_rounds_and_acceptance(ring_calls):
    """After a fully accepted round the cached drafter's ring has a hole at
    the last draft's position (a finding about the reference, kept by the
    port), and a windowed ring hands the drafter whatever its slot last
    held: what that is depends on the ring's length. With the window at 16,
    JAX's rings hold 22 slots and the port's 32, so the drafts, and with
    them the rounds and the final length, may differ (the budget's tokens
    never do: the target verifies). At a window of 26 both rings hold 32
    slots, and the rounds, acceptances and tokens are JAX's."""
    pair = windowed_pair(26)
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(1, 28, seed=6)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=True, strategy="modular"))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), NEW)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    toks, stats = eng.generate(pt, pd, prompt, NEW)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    for k in ("rounds", "accepted", "drafted", "tokens_generated"):
        assert stats[k] == int(jst[k]), k
    assert 0 < stats["accepted"] < stats["drafted"]
    assert {W for _, W, _, _ in ring_calls} == {32}
    assert max(first + Q for Q, _, first, _ in ring_calls) > 2 * 32


def test_cached_ar_matches_jax_and_the_nocache_ar(pair, jax_runs, ring_calls):
    mt, _, pt, _ = pair["torch"]
    got = engine.autoregressive_generate(mt, pt, jax_runs["prompt"], NEW,
                                         use_cache=True)
    np.testing.assert_array_equal(got.numpy(), jax_runs["ar"])
    nocache = engine.autoregressive_generate(mt, pt, jax_runs["prompt"], NEW)
    np.testing.assert_array_equal(got.numpy(), nocache.numpy())
    _rings_wrapped_twice_and_rounds_from_shapes(ring_calls, P + NEW)


def test_batched_generate_matches_jax(pair, jax_runs, ring_calls):
    mt, md, pt, pd = pair["torch"]
    eng = batched_engine.BatchedSpecEngine(
        mt, md, batched_engine.BatchedEngineConfig(gamma=GAMMA))
    prompts = _prompts(3, P, seed=8)
    toks, _, _ = eng.generate(pt, pd, prompts, NEW)
    want, _, _ = jax_runs["batched"]
    np.testing.assert_array_equal(toks[:, :P + NEW].numpy(),
                                  np.asarray(want)[:, :P + NEW])
    ar = engine.autoregressive_generate(mt, pt, prompts, NEW, use_cache=True)
    np.testing.assert_array_equal(toks[:, :P + NEW].numpy(), ar.numpy())
    _rings_wrapped_twice_and_rounds_from_shapes(ring_calls, P + NEW)


def test_continuous_server_matches_jax(pair, jax_runs, ring_calls):
    mt, md, pt, pd = pair["torch"]
    srv = ContinuousSpecServer(mt, md, pt, pd, batch=2, prompt_len=P,
                               max_new=40, gamma=GAMMA)
    for i, p in enumerate(_prompts(3, P, seed=9)):
        srv.submit(StreamRequest(i, p))
    done = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    want = jax_runs["continuous"]
    assert sorted(done) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(done[rid], want[rid], err_msg=f"rid {rid}")
    _rings_wrapped_twice_and_rounds_from_shapes(ring_calls, P + 40)
