"""The port's engines on the hybrid family against ``repro``'s, on the
``recurrentgemma-2b`` smoke pair (fp32; the drafter is the target's first
L-1 = 4 units: one (rec, rec, attn) block and one tail rec unit, weights
bridged from JAX's): ``SpecEngine`` in the paper's no-cache mode (linear
and multi-draft rounds) and cached (ring KV in the attention units, state
and conv caches in the RG-LRU units, a stateful hybrid drafter), greedy at
B = 2; a windowed ring that wraps (local window 16: the port's ring is 32
slots, 16 + 6 rounded up to the page, JAX's 22), with a prefill longer
than the ring (the flash route); one sampled cached serve under
``JaxKey``; ``Session`` choosing the engine backend; ``launch.serve``;
and the paths that need KV families refusing the hybrid, as in JAX.

Tokens, rounds and acceptance counts are compared exactly. The stateful
drafter restores its state from its own step snapshots and never reads a
ring slot it did not write (no cached-drafter hole), so rounds hold even
where the port's ring is longer than JAX's."""
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
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import batched_engine, engine, rounds  # noqa: E402
from repro_torch.launch import cli_args, serve, serve_async, serve_paged  # noqa: E402
from repro_torch.models import dense  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "recurrentgemma-2b"
GAMMA = 4
NEW = 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    """The smoke target and a drafter made of its first 4 units."""
    jcfg, cfg = jax_registry.smoke_config(ARCH), registry.smoke_config(ARCH)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jax.jit(jt.init)(jax.random.PRNGKey(0))
    jpd = {**jpt, "tail": jpt["tail"][:1]}
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu")),
            "vocab": cfg.vocab_size}


def _prompts(pair, shape, seed):
    return np.random.default_rng(seed).integers(
        0, pair["vocab"], shape).astype(np.int32)


def _jax_run(pair, prompt, use_cache, policy="linear"):
    jt, jd, jpt, jpd = pair["jax"]
    # JAX's modular strategy: the same rounds as its monolithic loop, with
    # jitted phases instead of one large compile
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=use_cache, draft_policy=policy, draft_k=2,
        strategy="modular"))
    return jeng.generate(jpt, jpd, jnp.asarray(prompt), NEW)


def _check_counts(st, jst):
    for k in ("rounds", "accepted", "drafted"):
        assert st[k] == int(jst[k]), k


@pytest.mark.parametrize("policy", ["linear", "multi"])
def test_nocache_spec_engine_matches_jax_and_ar(pair, policy):
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(pair, (2, 24), 3)
    want, jst = _jax_run(pair, prompt, False, policy)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(
        gamma=GAMMA, draft_policy=policy, draft_k=2))
    assert not eng._spec.d_stateful        # no-cache drafting keeps no state
    got, st = eng.generate(pt, pd, prompt, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)
    assert 0 < st["accepted"] and (policy == "multi" or st["accepted"] < st["drafted"])
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW)
    np.testing.assert_array_equal(got[:, :24 + NEW].numpy(), ar.numpy())
    jt, _, jpt, _ = pair["jax"]
    jar = jax_engine.autoregressive_generate(jt, jpt, jnp.asarray(prompt), NEW)
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))


@pytest.mark.parametrize("P", [24, 40])
def test_cached_spec_engine_over_wrapping_rings_matches_jax_and_ar(
        pair, P, monkeypatch):
    """The stateful hybrid drafter (gamma + 1 draft steps, snapshot
    rollback) and the target's trail rollback over windowed rings that
    wrap: every ring is 32 slots for 64 or more positions (the engine's
    and cached AR's), rounds are decided from shapes (Q <= W - window +
    1), and the prefill of P - 1 tokens writes the ring (P = 24) or,
    longer than it, runs windowed flash attention over its own tokens (P =
    40, where every round accepts its whole draft; P = 24 rolls back part
    of some). Tokens and counts are JAX's, == cached AR (JAX's engine ==
    its own cached AR is JAX's test)."""
    seen = []
    real = dense.ring_read

    def spy(window, cache, Q, tree=None):
        out = real(window, cache, Q, tree)
        seen.append((window, Q, cache["k"].shape[2], cache.get("positions"),
                     int(cache["index"].max()), out[0]))
        return out
    monkeypatch.setattr(dense, "ring_read", spy)
    mt, md, pt, pd = pair["torch"]
    prompt = _prompts(pair, (2, P), 3)
    want, jst = _jax_run(pair, prompt, True)
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA,
                                                        use_cache=True))
    assert eng._spec.d_stateful
    got, st = eng.generate(pt, pd, prompt, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)
    assert 0 < st["accepted"] and (P == 40 or st["accepted"] < st["drafted"])
    ar = engine.autoregressive_generate(mt, pt, prompt, NEW, use_cache=True)
    np.testing.assert_array_equal(got[:, :P + NEW].numpy(), ar.numpy())

    window = mt.cfg.local_window
    assert {(w, W) for w, _, W, _, _, _ in seen} == {(window, 32)}
    assert max(first + Q for _, Q, _, _, first, _ in seen) > 32
    for _, Q, W, positions, first, mode in seen:
        assert positions > W
        assert Q <= W - window + 1 or first == 0
        assert mode == ("flash" if Q > W else "write")
    assert any(mode == "flash" for *_, mode in seen) == (P - 1 > 32)


def test_sampled_cached_engine_replays_jax_under_jax_keys(pair):
    """Speculative sampling with the stateful hybrid drafter: the port,
    drawing JAX's bits and splitting where JAX splits, replays JAX's
    tokens and counts."""
    mt, md, pt, pd = pair["torch"]
    jt, jd, jpt, jpd = pair["jax"]
    prompt = _prompts(pair, (1, 21), 5)
    kw = dict(gamma=GAMMA, greedy=False, use_cache=True)
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        strategy="modular", **kw))
    want, jst = jeng.generate(jpt, jpd, jnp.asarray(prompt), 14,
                              key=jax.random.PRNGKey(11))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(**kw))
    got, st = eng.generate(pt, pd, prompt, 14, key=JaxKey(jax.random.PRNGKey(11)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_counts(st, jst)


@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_session_falls_back_to_the_engine_backend_as_jax(pair, use_cache):
    """A batched plan on the hybrid pair: both Sessions run the engine
    backend (per-row rollback needs KV families) and serve the same
    tokens and counts."""
    kw = dict(batch_size=2, prompt_lens=(24,), max_new=NEW, use_cache=use_cache,
              cost_coefficient=0.2, adaptive_gamma=False)
    plan = api.Planner(api.DeploymentSpec(**kw)).plan()
    jplan = japi.Planner(japi.DeploymentSpec(**kw)).plan()
    assert plan.to_json() == jplan.to_json() and plan.batching != "single"
    sess = api.Session(*pair["torch"], plan, device="cpu")
    jsess = japi.Session(*pair["jax"], jplan)
    assert sess.backend_name == jsess.backend_name == "engine"
    prompt = _prompts(pair, (2, 24), 7)
    toks, stats = sess.generate(prompt, NEW)
    jtoks, jstats = jsess.generate(jnp.asarray(prompt), NEW)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(jtoks))
    for k in ("rounds", "accepted", "drafted", "tokens_generated"):
        assert stats[k] == int(jstats[k]), k


@pytest.mark.parametrize("use_cache", [False, True], ids=["nocache", "cached"])
def test_launch_serve_on_the_smoke_pair_equals_ar(use_cache, capsys):
    """``launch.serve`` builds the hybrid pair and serves it through the
    Session's engine backend; spec == AR in both modes, and the CLI prints
    its line."""
    mt, md, pt, pd, cfg = cli_args.build_pair(ARCH, True, "cpu")
    assert (mt.cfg.family, md.cfg.num_layers) == ("hybrid", 4)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (4, 20)).astype(np.int32)
    spec, s = serve.serve(mt, md, pt, pd, prompts, 12, gamma=GAMMA, batch=2,
                          use_cache=use_cache)
    ar, _ = serve.serve(mt, md, pt, pd, prompts, 12, gamma=0, batch=2,
                        use_cache=use_cache)
    np.testing.assert_array_equal(spec, ar)
    assert s["waves"] == 2 and s["rounds"] > 0
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "7", "--prompt-len", "5", "--speculative",
            "--batch", "2", "--gamma", "3"] + (["--use-cache"] if use_cache else [])
    out, _ = serve.main(argv)
    assert out.shape == (3, 12)
    assert f"cache={use_cache}, backend=engine" in capsys.readouterr().out


def test_kv_family_paths_refuse_the_hybrid_as_in_jax(pair):
    """The per-row engine, the paged server's CLI and the front end's CLI
    refuse the hybrid family (KV-cache families only), tree rounds need a
    KV drafter, and placed rounds a KV-family drafter."""
    mt, md, pt, pd = pair["torch"]
    with pytest.raises(ValueError, match="KV-cache families"):
        batched_engine.BatchedSpecEngine(mt, md, batched_engine.BatchedEngineConfig())
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2"]
    for cli in (serve_paged, serve_async):
        with pytest.raises(SystemExit, match="family 'hybrid'"):
            cli.main(argv)
    with pytest.raises(ValueError, match="tree drafting needs a KV-family drafter"):
        engine.SpecEngine(mt, md, engine.EngineConfig(
            gamma=GAMMA, use_cache=True, draft_policy="tree", draft_k=2))
    with pytest.raises(ValueError, match="placed rounds need KV-family drafters"):
        rounds.PlacedRound(mt, md, rounds.RoundSpec(
            gamma=GAMMA, use_cache=True, commit="batch_min", d_stateful=True),
            None)
