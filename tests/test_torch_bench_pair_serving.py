"""The repo's own trained pair (``benchmarks/common.py``; the recipe and its
training are ``test_torch_bench_pair.py``) served greedily on every path the
JAX benches run, from JAX's init at the recipe's geometry (the target 8 / 4
heads of 48, the drafter 4 / 2 of 48), against ``repro`` on the CPU: the
no-cache ``SpecEngine``, the cached one on the ring, cached tree rounds
(chain_tree(2, 4)) and ``PagedSpecServer`` in lockstep with JAX's. Tokens
and counts are compared exactly, to JAX's and to AR's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _serving_parity import (bench_pair, lockstep, one_torch_thread,  # noqa: E402
                             same_tokens, serve_port, servers)
from repro.core import engine as jax_engine  # noqa: E402
from repro_torch.core import engine  # noqa: E402

GAMMA, NEW = 4, 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return bench_pair()


def _prompts(n, length, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, length)).astype(np.int32)


@pytest.mark.parametrize("path", ["nocache", "cached", "tree"])
def test_engines_match_jax_and_ar(pair, path):
    """Two prompts of 7 tokens, 10 new, greedy: the no-cache engine
    (gamma 4), the cached engine on the ring (gamma 4) and cached tree
    rounds (width 2, depth 4); tokens and round counts equal JAX's, tokens
    equal AR's (no-cache AR for the no-cache engine, cached AR else)."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(2, 7, seed=3)
    kw = dict(gamma=GAMMA, use_cache=path != "nocache", strategy="modular",
              draft_policy="tree" if path == "tree" else "linear", draft_k=2)
    want, jst = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(**kw)).generate(
        jpt, jpd, jnp.asarray(prompt), NEW)
    toks, st = engine.SpecEngine(mt, md, engine.EngineConfig(**kw)).generate(
        pt, pd, prompt, NEW)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    assert (st["rounds"], st["accepted"]) == (int(jst["rounds"]), int(jst["accepted"]))
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW,
                                        use_cache=path != "nocache")
    np.testing.assert_array_equal(toks[:, :7 + NEW].numpy(), ar.numpy())


def test_paged_server_matches_jax_in_lockstep(pair):
    """``PagedSpecServer`` with gamma pinned to 4 beside JAX's on three
    requests (block size 4): step infos and allocators equal after every
    step, tokens equal JAX's and the port's AR rounds'."""
    reqs = [(p, n) for p, n in zip(
        (_prompts(1, 5, 7)[0], _prompts(1, 9, 8)[0], _prompts(1, 12, 9)[0]),
        (NEW, 6, 8))]
    port, ref = servers(pair, GAMMA)
    _, got, want = lockstep(port, ref, reqs)
    same_tokens(got, want)
    same_tokens(got, serve_port(pair, reqs, 0)[1])
