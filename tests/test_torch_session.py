"""The port's Session facade against ``repro.api.Session`` on bridged smoke
weights, backend by backend (the counterparts of
``tests/test_api_plan.py``'s facade tests): the engine backend (single
stream, the AR fallback, the adaptive loop), the per-row, continuous and
paged backends, ``serve_async``; and both serving CLIs plan through the
Planner.

The pair is the ``llama3.2-1b`` smoke target with a drafter made of its
first L-1 layers (the embedding drawn at std d**-0.5), so rounds accept
part of their drafts and the adaptive gamma moves. Tokens, round counts,
gamma traces and acceptance estimates are compared exactly.
"""
import asyncio
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import one_torch_thread  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.api import backends as jax_backends  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core.engine import autoregressive_generate as jax_ar  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.engine import EngineConfig, SpecEngine  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serving import PagedSpecServer, ServeRequest  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "llama3.2-1b"
RAGGED = [(5, 6), (9, 10), (6, 4), (11, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_registry.smoke_config(ARCH)
    jcfg = jcfg.replace(embed_init_scale=jcfg.d_model ** -0.5)
    cfg = registry.smoke_config(ARCH).replace(
        embed_init_scale=jcfg.d_model ** -0.5)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                   jpt["layers"])}
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu")),
            "vocab": cfg.vocab_size}


def _plans(**kw):
    kw.setdefault("cost_coefficient", 0.2)
    kw.setdefault("adaptive_gamma", False)
    return (api.Planner(api.DeploymentSpec(**kw)).plan(),
            japi.Planner(japi.DeploymentSpec(**kw)).plan())


def _force(plans, g):
    return tuple(dataclasses.replace(p, gamma=dataclasses.replace(p.gamma, gamma=g))
                 for p in plans)


def _sessions(pair, plans, **kw):
    """The port's Session (on the CPU) and JAX's on the same plan."""
    plan, jplan = plans
    assert plan.to_json() == jplan.to_json()
    return (api.Session(*pair["torch"], plan, device="cpu", **kw),
            japi.Session(*pair["jax"], jplan, **kw))


def _prompts(pair, shape, seed):
    return np.random.default_rng(seed).integers(
        0, pair["vocab"], shape).astype(np.int32)


# ------------------------------------------------------- engine backend
def test_session_single_matches_jax(pair):
    prompt = _prompts(pair, (1, 6), 0)
    sess, jsess = _sessions(pair, _force(_plans(batch_size=1, prompt_lens=(6,),
                                                max_new=10), 3))
    assert sess.backend_name == jsess.backend_name == "engine"
    toks, stats = sess.generate(prompt, 10)
    jtoks, jstats = jsess.generate(jnp.asarray(prompt), 10)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for k in ("rounds", "accepted", "drafted", "tokens_generated",
              "speculative"):
        assert stats[k] == jstats[k], k
    assert 0 < stats["accepted"] < stats["drafted"]
    assert sess.alpha_hat == jsess.alpha_hat is not None


def test_session_ar_fallback_matches_jax(pair):
    prompt = _prompts(pair, (1, 6), 4)
    sess, jsess = _sessions(pair, _plans(batch_size=1, prompt_lens=(6,),
                                         max_new=8, cost_coefficient=1.5))
    assert sess.plan.gamma.gamma == 0
    toks, stats = sess.generate(prompt, 8)
    jtoks, jstats = jsess.generate(jnp.asarray(prompt), 8)
    assert stats == {**jstats, "alpha_hat": stats["alpha_hat"]}
    assert stats["speculative"] is False and np.isnan(stats["alpha_hat"])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "nocache"])
def test_session_adaptive_matches_jax(pair, use_cache):
    """The adaptive loop: every round of a candidate gamma runs on the state
    the largest candidate prefilled; the gamma trace, the tokens and the
    acceptance EMA equal JAX's."""
    prompt = _prompts(pair, (1, 6), 5)
    sess, jsess = _sessions(pair, _plans(batch_size=1, prompt_lens=(6,),
                                         max_new=16, adaptive_gamma=True,
                                         use_cache=use_cache))
    assert sess.plan.gamma.adaptive and len(sess.plan.gamma.candidates) > 1
    toks, stats = sess.generate(prompt, 16)
    jtoks, jstats = jsess.generate(jnp.asarray(prompt), 16)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert stats == jstats
    assert len(set(stats["gamma_trace"])) > 1
    assert sess.alpha_hat == jsess.alpha_hat
    ar = jax_ar(pair["jax"][0], pair["jax"][2], jnp.asarray(prompt), 16)
    np.testing.assert_array_equal(toks.numpy()[:, :22], np.asarray(ar))


def test_session_serves_requests_like_jax(pair):
    """``Session.serve`` groups requests by shape and serves each group in
    batches of ``max_batch`` (tuples or ServeRequests)."""
    prompts = _prompts(pair, (5, 7), 9)
    sess, jsess = _sessions(pair, _force(_plans(batch_size=1, prompt_lens=(7,),
                                                max_new=6), 2), max_batch=2)
    reqs = [(i, prompts[i][:5 + i // 4], 6 - i // 4) for i in range(5)]
    done = {r.rid: r.tokens for r in sess.serve(reqs)}
    want = {r.rid: r.tokens for r in jsess.serve(reqs)}
    assert sorted(done) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(done[rid], np.asarray(want[rid]))
    assert sess.request(prompts[0], rid=3).max_new == 6


# -------------------------------------------------------- per-row backend
def test_session_per_row_matches_jax(pair):
    prompts = _prompts(pair, (3, 6), 1)
    sess, jsess = _sessions(pair, _force(_plans(batch_size=3, prompt_lens=(6,),
                                                max_new=8), 3))
    assert sess.backend_name == jsess.backend_name == "per_row"
    toks, lengths, stats = sess.generate_batch(prompts, 8)
    jtoks, jlengths, jstats = jsess.generate_batch(jnp.asarray(prompts), 8)
    np.testing.assert_array_equal(toks.numpy()[:, :14], np.asarray(jtoks)[:, :14])
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    assert (stats["rounds"], stats["alpha_hat"]) == \
        (jstats["rounds"], jstats["alpha_hat"])
    assert sess.alpha_hat == jsess.alpha_hat is not None
    first, _ = sess.generate(prompts, 8)
    assert first.shape[1] == int(lengths.min())


# ---------------------------------------------------------- paged backend
def _ragged(pair, seed=3):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, pair["vocab"], P).astype(np.int32), new)
            for i, (P, new) in enumerate(RAGGED)]


@pytest.mark.parametrize("gamma", [3, None], ids=["pinned", "adaptive"])
def test_session_paged_matches_jax(pair, gamma):
    plans = _plans(batch_size=2, prompt_lens=tuple(P for P, _ in RAGGED),
                   max_new=tuple(n for _, n in RAGGED), streaming=True,
                   adaptive_gamma=gamma is None)
    if gamma is not None:
        plans = _force(plans, gamma)
    sess, jsess = _sessions(pair, plans, max_batch=2)
    assert sess.plan.cache.kind == "paged" and sess.plan.cache.block_size == 8
    assert sess.backend_name == jsess.backend_name == "paged"
    reqs = _ragged(pair)
    done = {r.rid: r.tokens for r in sess.serve(
        [ServeRequest(i, p, n) for i, p, n in reqs])}
    want = {r.rid: r.tokens for r in jsess.serve(
        [JaxRequest(i, p, n) for i, p, n in reqs])}
    assert sorted(done) == sorted(want) == list(range(len(RAGGED)))
    for rid in want:
        np.testing.assert_array_equal(done[rid], np.asarray(want[rid]))
    srv = sess.backend.server
    assert srv.scfg.block_size == 8 and srv.total_rounds > 0
    assert sess.alpha_hat == srv.metrics.alpha_hat() is not None
    tel = sess.telemetry()
    assert tel["events"] is srv.events and tel["metrics"] is srv.metrics
    # generate_batch through the pool: the same tokens as AR
    prompts = _prompts(pair, (2, 5), 8)
    toks, lens, stats = sess.generate_batch(prompts, 6)
    assert lens.tolist() == [11, 11] and stats["speculative"]
    ar = jax_ar(pair["jax"][0], pair["jax"][2], jnp.asarray(prompts), 6,
                use_cache=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ar))


# --------------------------------------- the continuous backend, serve_async
def test_infeasible_streaming_plan_serves_ar_not_spec(pair):
    """gamma*=0 means AR: the ring-continuous plan goes to the continuous
    backend, whose AR branch serves JAX's tokens (JAX's Session serves the
    same plan the same way); the same plan pinned monolithic goes to the
    engine backend, which serves them too."""
    kw = dict(batch_size=2, prompt_lens=(6,), max_new=6, streaming=True,
              alpha=0.3, cost_coefficient=0.5, adaptive_gamma=None)
    plan, jplan = _plans(**kw)
    assert plan.to_json() == jplan.to_json()
    assert plan.gamma.gamma == 0 and not plan.gamma.adaptive
    assert not plan.speculative
    prompts = _prompts(pair, (3, 6), 6)
    jsess = japi.Session(*pair["jax"], jplan, max_batch=2)
    want = {r.rid: r.tokens for r in jsess.serve(
        [JaxRequest(i, prompts[i], 6) for i in range(3)])}
    sess = api.Session(*pair["torch"], plan, max_batch=2, device="cpu")
    assert sess.backend_name == jsess.backend_name == "continuous"
    done = sess.serve([ServeRequest(i, prompts[i], 6) for i in range(3)])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    for r in done:
        np.testing.assert_array_equal(r.tokens, np.asarray(want[r.rid]))
    assert sess.backend.controller.gamma() == 0 and sess.alpha_hat is None
    mono, _ = _plans(**kw, strategy="monolithic")
    sess = api.Session(*pair["torch"], mono, max_batch=2, device="cpu")
    assert sess.backend_name == "engine"
    done = sess.serve([ServeRequest(i, prompts[i], 6) for i in range(3)])
    for r in done:
        np.testing.assert_array_equal(r.tokens, np.asarray(want[r.rid]))


def test_pinned_knobs_fall_back_to_engine_backend(pair):
    for kw in (dict(strategy="monolithic"), dict(use_cache=False),
               dict(greedy=False)):
        plan, jplan = _plans(batch_size=4, prompt_lens=(6,), max_new=8, **kw)
        sess = api.Session(*pair["torch"], plan, device="cpu")
        assert sess.backend_name == "engine" == \
            japi.Session(*pair["jax"], jplan).backend_name


def test_continuous_plan_and_serve_async_raise(pair):
    """The ring-continuous plan serves JAX's tokens through the continuous
    backend (with its acceptance fed to the controller as JAX feeds it);
    ``serve_async`` on a paged plan returns an un-started front end that
    streams the server's tokens; on a single-batch plan it raises JAX's
    ValueError."""
    plans = _plans(batch_size=2, prompt_lens=(6,), max_new=6, streaming=True)
    plan, jplan = plans
    assert plan.batching == "continuous" and plan.cache.kind == "ring"
    assert plan.speculative
    sess, jsess = _sessions(pair, plans)
    assert sess.backend_name == jsess.backend_name == "continuous"
    prompts = _prompts(pair, (5, 6), 9)
    done = {r.rid: r.tokens for r in sess.serve(
        [ServeRequest(i, prompts[i], 6) for i in range(5)])}
    want = {r.rid: np.asarray(r.tokens) for r in jsess.serve(
        [JaxRequest(i, prompts[i], 6) for i in range(5)])}
    assert sorted(done) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(done[rid], want[rid])
    assert sess.alpha_hat == pytest.approx(jsess.alpha_hat)
    toks, lens, stats = sess.generate_batch(prompts[:2], 4)
    assert lens.tolist() == [10, 10] and stats["speculative"]
    paged, _ = _plans(batch_size=2, prompt_lens=(5, 9), max_new=(4, 6),
                      streaming=True)
    sess = api.Session(*pair["torch"], paged, device="cpu")
    front = sess.serve_async(max_stream_queue=2)
    assert front.server is sess.backend.server and front._task is None

    async def go():
        async with front:
            stream = await front.submit(prompts[0], 4)
            return await asyncio.wait_for(
                asyncio.gather(*[_collect(stream)]), timeout=60)
    got, = asyncio.run(go())
    np.testing.assert_array_equal(got, done[0][6:10])
    single, jsingle = _plans(batch_size=1)
    with pytest.raises(ValueError) as got:
        api.Session(*pair["torch"], single, device="cpu").serve_async()
    with pytest.raises(ValueError) as want:
        japi.Session(*pair["jax"], jsingle).serve_async()
    assert str(got.value) == str(want.value)


async def _collect(stream):
    return [t async for t in stream]


def test_session_device_and_placement(pair):
    plan, _ = _plans(batch_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.Session(*pair["torch"], plan)
    sess = api.Session(*pair["torch"], plan, device="cpu")
    assert sess.device == torch.device("cpu")
    assert not sess.placement.heterogeneous
    assert sess.placement.describe() == \
        japi.Session(*pair["jax"], _plans(batch_size=1)[1]).placement.describe()
    hetero, jhetero = (mod.Planner(mod.DeploymentSpec(
        explore_placement=True, cost_coefficient=0.3, alpha=0.85,
        drafter_submeshes=(mod.SubmeshSpec("d1"), mod.SubmeshSpec("d2", ("dx",), (2,))),
        target_submeshes=(mod.SubmeshSpec("t6", ("tx",), (6,)),),
        submesh_t_draft={"d1": 0.002, "d2": 0.0013},
        submesh_t_target={"t6": 0.0035})).plan() for mod in (api, japi))
    assert hetero.placement.heterogeneous
    placed = api.Session(*pair["torch"], hetero, device="cpu")
    jplaced = japi.Session(*pair["jax"], jhetero)
    assert not placed.placement.heterogeneous
    assert placed.placement.note.startswith("degenerate fallback: ")
    assert placed.describe().splitlines()[:2] == \
        jplaced.describe().splitlines()[:2]


def test_serve_ar_helper_matches_jax(pair):
    """The continuous backend's AR helper."""
    plan, jplan = _plans(batch_size=2, cost_coefficient=1.5)
    prompts = _prompts(pair, (2, 6), 11)

    class Shell:
        def __init__(self, target, params_t, plan):
            self.target, self.params_t, self.plan = target, params_t, plan
    got = backends._serve_ar(Shell(pair["torch"][0], pair["torch"][2], plan),
                             [ServeRequest(i, prompts[i], 5) for i in range(2)])
    want = jax_backends._serve_ar(Shell(pair["jax"][0], pair["jax"][2], jplan),
                                  [JaxRequest(i, prompts[i], 5) for i in range(2)])
    for r, j in zip(got, want):
        np.testing.assert_array_equal(r.tokens, np.asarray(j.tokens))


# -------------------------------------------------------------------- CLIs
def _env():
    return {**os.environ,
            "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")])}


def test_serve_cli_plans_and_serves_the_engines_tokens(capsys):
    """``launch.serve`` prints the plan's gamma (the planner's Eq. (1) at
    alpha 0.9, c 0.3) and serves the tokens of ``SpecEngine.generate`` on
    the same prompts, wave by wave."""
    from repro_torch.launch import cli_args, serve
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--speculative",
            "--requests", "3", "--batch", "2", "--prompt-len", "5",
            "--max-new", "7", "--alpha", "0.9", "--cost-coefficient", "0.3"]
    toks, s = serve.main(argv)
    gamma = api.Planner(api.DeploymentSpec(
        batch_size=2, prompt_lens=(5,), max_new=7, alpha=0.9,
        cost_coefficient=0.3, adaptive_gamma=False)).plan().gamma.gamma
    out = capsys.readouterr().out
    assert f"gamma={gamma}, strategy=monolithic" in out and "backend=engine" in out
    assert s["gamma"] == gamma
    mt, md, pt, pd, _ = cli_args.build_pair(ARCH, True, "cpu")
    eng = SpecEngine(mt, md, EngineConfig(gamma=gamma))
    keys = serve.TorchKey(0).split(2)
    for w, i in enumerate((0, 2)):
        want, _ = eng.generate(pt, pd, toks[i:i + 2, :5], 7, key=keys[w])
        np.testing.assert_array_equal(toks[i:i + 2], want[:, :12].numpy())


def test_serve_paged_cli_plans_and_serves_the_servers_tokens(capsys,
                                                             monkeypatch):
    """``launch.serve_paged`` prints the plan's pinned gamma and serves the
    tokens of a ``PagedSpecServer`` built from the same plan's geometry.
    Both servers get a watchdog that cannot trip: it reads the host clock,
    and a round slowed by other processes must not change the round
    count."""
    from repro_torch.launch import cli_args, serve_paged
    from repro_torch.serving import paged_server
    from repro_torch.serving.watchdog import RoundWatchdog
    monkeypatch.setattr(paged_server, "RoundWatchdog",
                        lambda: RoundWatchdog(slow_factor=float("inf")))
    srv = serve_paged.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "5", "--gamma", "2",
                            "--block-size", "16", "--num-blocks", "64"])
    out = capsys.readouterr().out
    assert "paged-served 5 ragged requests" in out and "gamma=2 [forced]" in out
    assert (srv.scfg.block_size, srv.scfg.num_blocks) == (16, 64)
    mt, md, pt, pd, cfg = cli_args.build_pair(ARCH, True, "cpu")
    reqs = serve_paged.synthetic_requests(np.random.default_rng(0), 5,
                                          cfg.vocab_size)
    ref = PagedSpecServer(mt, md, pt, pd, srv.scfg, gamma=2, device="cpu")
    for r in reqs:
        ref.submit(r)
    want = {r.rid: r.tokens for r in ref.run()}
    for r in srv.done:
        np.testing.assert_array_equal(r.tokens, want[r.rid])
    assert srv.total_rounds == ref.total_rounds


def test_serve_paged_cli_subprocess_plans_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_paged", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "3", "--alpha", "0.7",
         "--cost-coefficient", "0.4", "--overcommit", "1.5"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "paged-served 3 ragged requests" in proc.stdout
    assert "[cost-model]" in proc.stdout


def test_telemetry_reports_a_traced_paged_session(pair, tmp_path, capsys):
    from repro_torch.launch import cli_args
    plan, _ = _force(_plans(batch_size=2, prompt_lens=(5, 9), max_new=(6, 4),
                            streaming=True), 3)
    sess = api.Session(*pair["torch"], plan, tracer=Tracer(), device="cpu")
    sess.serve(_ragged(pair)[:2])
    path = tmp_path / "trace.json"
    cli_args.report_telemetry(sess, type("Args", (), {"trace_out": str(path)}))
    out = capsys.readouterr().out
    assert f"spans -> {path}" in out and path.exists()
    assert sess.telemetry()["tracer"] is sess.tracer
