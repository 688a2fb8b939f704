"""Port parity of traced execution: ``rounds.TracedRound``, the traced
paged server (round events, KV traffic, the drift monitor and the
measured-c gamma loop), the traced no-cache ``SpecEngine`` and the CLIs'
``--trace-out``, against ``repro``.

  * TracedRound commits what ``spec_round`` commits and what JAX's
    TracedRound commits (a linear gamma-3 paged round, a no-cache
    ``batch_min`` round), with the same spans.
  * The traced paged server gives the untraced tokens, leaf phases cover
    0.9-1.02 of the serve span, one event per round, alpha parity with the
    metrics, a calibrated drift monitor with 0 < c < 2 (the JAX suite's
    ``test_traced_paged_serving_end_to_end``, on the port).
  * Lockstep: the port's traced server and ``repro.serving.PagedSpecServer``
    on one scripted clock (two instances of one seeded script, so a clock
    read either side lacks shifts every later time) with gamma unpinned,
    bucketed and at chunk 8 with the prefix pool. After every step: the
    step-info, gamma, every RoundEvent field but ``t_wall``,
    ``drift.to_dict()`` and ``kv_traffic()`` are equal, so the measured-c
    gamma decision is JAX's.
  * The no-cache engine traced, monolithic and modular: the untraced
    tokens and JAX's spans.
  * The CLIs with ``--trace-out``: the paged one writes draft / verify /
    commit / serve spans (the check of JAX's CI step "Trace export smoke");
    the no-cache one writes the spans JAX's no-cache CLI writes.

Every input comes from a numpy seed; the pairs' weights from one JAX init,
bridged through numpy. The server tests run with one torch thread."""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _serving_parity import (BASE, STEP_KEYS, build_pair,  # noqa: E402
                             one_torch_thread, pool_whole, same_tokens,
                             shared_prefix_trace)
from repro import obs as jax_obs  # noqa: E402
from repro.cache import paged_kv as jax_paged_kv  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro.serving import PagedSpecServer as JaxServer  # noqa: E402
from repro.serving import SchedulerConfig as JaxConfig  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.watchdog import RoundWatchdog  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.cache import paged_kv  # noqa: E402
from repro_torch.core import cost_model, engine, rounds  # noqa: E402
from repro_torch.serving import (PagedSpecServer, SchedulerConfig,  # noqa: E402
                                 ServeRequest)

GAMMA = 3
BASE_C = SchedulerConfig().cost_coefficient    # the prior c


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def e2e_pair():
    return make_e2e_pair()


def make_e2e_pair():
    """The JAX suite's end-to-end pair: the ``llama3.2-1b`` smoke target
    (JAX init, key 0) and a one-layer-shorter drafter (key 7), bridged."""
    from repro.configs import registry as jax_registry
    from repro.models.model import build_model as jax_build
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    jd_cfg = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    jpt = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jpd = jax_build(jd_cfg).init(jax.random.PRNGKey(7))
    cfg = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jax_build(jcfg), jax_build(jd_cfg), jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


class ScriptedClock:
    """Advances by a different, seeded amount at every read (0.5-5 ms, so
    measured c wanders and the gamma decision moves); two instances of one
    seed return one sequence."""

    def __init__(self, seed):
        self._inc = np.random.default_rng(seed).uniform(5e-4, 5e-3, 1 << 14)
        self._k = 0
        self.t = 0.0

    def __call__(self) -> float:
        self.t += float(self._inc[self._k])
        self._k += 1
        return self.t


def _spans(tracer):
    return [(s.name, s.depth, s.tags) for s in tracer.spans()]


# ------------------------------------------------------------- TracedRound
def _paged_states(pair, self_draft):
    """One prefilled paged state per package (3 rows, one inactive); with
    ``self_draft`` the target drafts for itself (every draft accepted)."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    if self_draft:
        jd, jpd, md, pd = jt, jpt, mt, pt
    B, NB, BS, MB, T = 3, 32, 4, 8, 28
    prompts, active = (5, 8, 6), np.array([True, False, True])
    rng = np.random.default_rng(5)   # a partial accept in round 2
    tokens = np.zeros((B, T), np.int32)
    for b, P in enumerate(prompts):
        tokens[b, :P] = rng.integers(0, 512, P)
    table = np.arange(1, 1 + B * MB, dtype=np.int32).reshape(B, MB)
    length = np.asarray(prompts, np.int32)

    def jax_cache(m, p):
        c = {**m.init_paged_cache(B, NB, BS, MB, dtype=jnp.float32),
             "block_table": jnp.asarray(table)}
        _, c, _ = m.apply(p, jnp.asarray(tokens[:, :max(prompts) - 1]), c)
        return jax_paged_kv.rollback(c, jnp.asarray(length - 1))

    def port_cache(m, p):
        c = {**m.init_paged_cache(B, NB, BS, MB, device="cpu"),
             "block_table": torch.from_numpy(table)}
        _, c, _ = m.apply(p, torch.from_numpy(tokens[:, :max(prompts) - 1]), c)
        return paged_kv.rollback(c, torch.from_numpy(length - 1))

    def port_state():
        return rounds.RoundState(
            tokens=torch.from_numpy(tokens.copy()),
            length=torch.from_numpy(length.copy()),
            dcache=port_cache(md, pd), tcache=port_cache(mt, pt),
            active=torch.from_numpy(active), n_rounds=torch.zeros((), dtype=torch.int32),
            n_accepted=torch.zeros((B,), dtype=torch.int32),
            n_drafted=torch.zeros((), dtype=torch.int32))

    js = jax_rounds.RoundState(
        tokens=jnp.asarray(tokens), length=jnp.asarray(length),
        dcache=jax_cache(jd, jpd), tcache=jax_cache(jt, jpt),
        active=jnp.asarray(active), n_rounds=jnp.zeros((), jnp.int32),
        n_accepted=jnp.zeros((B,), jnp.int32),
        n_drafted=jnp.zeros((), jnp.int32))
    return js, port_state


def _same_state(a, b, js):
    for name in ("tokens", "length", "n_accepted", "n_rounds", "n_drafted"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), err_msg=name)
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["smoke_drafter", "target_drafts"])
def test_traced_round_commits_what_spec_round_and_jax_commit(pair, self_draft):
    """Four linear gamma-3 rounds: the traced port round == the untraced
    port round == JAX's TracedRound, with the spans JAX's emits; rounds
    with rejected drafts (a partial accept among them) and, with the
    target drafting, with every draft accepted."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    if self_draft:
        jd, jpd, md, pd = jt, jpt, mt, pt
    js, port_state = _paged_states(pair, self_draft)
    jspec = jax_rounds.RoundSpec(gamma=GAMMA, commit="per_row")
    spec = rounds.RoundSpec(gamma=GAMMA)
    jtr = jax_obs.Tracer(clock=ScriptedClock(0))
    tr = obs.Tracer(clock=ScriptedClock(0))
    jround = jax_rounds.TracedRound(jt, jd, jspec, jtr, role="x")
    traced = rounds.TracedRound(mt, md, spec, tr, role="x")
    a, b = port_state(), port_state()
    partial = full = 0
    for k in range(4):
        js = jround(jpt, jpd, js, round=k)
        a = traced(pt, pd, a, round=k)
        n_before = b.n_accepted.clone()
        b = rounds.spec_round(mt, md, pt, pd, b, spec)
        _same_state(a, b, js)
        assert traced.last_phase_times == jround.last_phase_times
        assert set(traced.last_phase_times) == {"draft", "verify", "commit"}
        step = (b.n_accepted - n_before)[b.active]
        partial += int(((step > 0) & (step < GAMMA)).sum())
        full += int((step == GAMMA).sum())
    assert _spans(tr) == _spans(jtr)
    assert [s.name for s in tr.spans()] == ["draft", "verify", "commit"] * 4
    # caller tags override the round's own, as in JAX
    assert all(s.tags["role"] == "x" and "phase" in s.tags for s in tr.spans())
    assert (full > 0) if self_draft else (partial > 0)


def test_traced_round_commits_what_a_nocache_round_commits(pair):
    """A no-cache ``batch_min`` round (the paper's mode) through
    TracedRound: the same state as ``spec_round`` and JAX's TracedRound."""
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = np.random.default_rng(2).integers(0, 512, (2, 6)).astype(np.int32)
    max_len = 6 + 12 + GAMMA + 2
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=False, strategy="modular"))
    eng = engine.SpecEngine(mt, md, engine.EngineConfig(gamma=GAMMA))
    jtr = jax_obs.Tracer(clock=ScriptedClock(1))
    tr = obs.Tracer(clock=ScriptedClock(1))
    jround = jax_rounds.TracedRound(jt, jd, jeng._spec(False), jtr)
    traced = rounds.TracedRound(mt, md, eng._spec, tr)
    js = jeng.prefill(jpt, jpd, jnp.asarray(prompt), max_len)
    a = eng.prefill(pt, pd, prompt, max_len)
    b = eng.prefill(pt, pd, prompt, max_len)
    for k in range(3):
        js = jround(jpt, jpd, js, round=k)
        a = traced(pt, pd, a, round=k)
        b = eng.round(pt, pd, b)
        _same_state(a, b, js)
    assert _spans(tr) == _spans(jtr)


# ------------------------------------------------------ traced paged server
RAGGED = [(5, 8), (9, 12), (6, 4), (13, 10), (7, 6), (4, 9), (11, 5)]
SCFG = dict(max_batch=3, block_size=4, num_blocks=64, max_blocks_per_row=12,
            gamma_max=6, prefill_buckets=(8, 16))


def _wave(seed):
    return [(np.random.default_rng(seed + i).integers(0, 512, P)
             .astype(np.int32), new) for i, (P, new) in enumerate(RAGGED)]


def _serve(pair, reqs, tracer=None, **cfg):
    mt, md, pt, pd = pair["torch"]
    srv = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(**{**SCFG, **cfg}),
                          tracer=tracer, device="cpu")
    for i, (p, new) in enumerate(reqs):
        srv.submit(ServeRequest(i, p, new))
    return srv, {r.rid: np.asarray(r.tokens) for r in srv.run()}


def test_traced_paged_serving_end_to_end(e2e_pair, tmp_path):
    """The JAX suite's acceptance bar, on the port: a traced paged run
    exports a Chrome trace whose leaf phases cover the serve span (0.9 to
    1.02 after a warm-up run), records one event per round, calibrates the
    drift monitor and gives EXACTLY the untraced tokens."""
    tracer = obs.Tracer()
    _serve(e2e_pair, _wave(0), tracer)                 # warm-up
    tracer.clear()
    traced, got = _serve(e2e_pair, _wave(100), tracer)
    assert sorted(got) == list(range(len(RAGGED)))
    untraced, want = _serve(e2e_pair, _wave(100))
    same_tokens(got, want)
    assert untraced.events.n_rounds == untraced.total_rounds
    assert all(e.t_draft is None for e in untraced.events.events())

    totals = tracer.phase_totals()
    leaf = sum(v for k, v in totals.items() if k != "serve")
    serve = tracer.total(name="serve")
    assert serve > 0
    assert 0.9 * serve <= leaf <= 1.02 * serve, (leaf, serve, totals)
    for phase in ("draft", "verify", "commit", "prefill"):
        assert tracer.count(phase=phase) > 0, phase

    path = tmp_path / "trace.json"
    tracer.export(str(path))
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"draft", "verify", "commit", "serve"} <= names

    events = traced.events.events()
    assert len(events) == traced.total_rounds == traced.metrics.n_rounds
    spec_evs = [e for e in events if e.gamma > 0]
    assert spec_evs and all(e.t_draft is not None and e.t_verify is not None
                            and e.t_commit is not None for e in spec_evs)
    assert traced.events.alpha_hat() == pytest.approx(
        traced.metrics.alpha_hat())
    assert traced.drift is not None and traced.drift.calibrated
    ev = traced.drift.evidence()
    assert ev is not None and 0 < ev["c"] < 2.0
    assert ev["c"] == pytest.approx(cost_model.cost_coefficient(
        ev["t_draft"], ev["t_target"]))
    pool_whole(traced)


def _servers(pair, seed, alpha, **cfg):
    """The port's traced server and JAX's, gamma unpinned, each tracer on
    its own instance of one scripted clock; JAX's watchdog cannot trip."""
    mt, md, pt, pd = pair["torch"]
    jt, jd, jpt, jpd = pair["jax"]
    cfg = {**BASE, **cfg}
    port = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(**cfg), alpha=alpha,
                           tracer=obs.Tracer(clock=ScriptedClock(seed)),
                           device="cpu")
    ref = JaxServer(jt, jd, jpt, jpd, JaxConfig(**cfg), alpha=alpha,
                    tracer=jax_obs.Tracer(clock=ScriptedClock(seed)),
                    watchdog=RoundWatchdog(slow_factor=float("inf")))
    return port, ref


def _same_event(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    da.pop("t_wall")
    db.pop("t_wall")
    assert da == db


@pytest.mark.parametrize("alpha", [None, 0.7], ids=["alpha_measured",
                                                    "alpha_0.7"])
@pytest.mark.parametrize("cfg", [{}, {"prefill_chunk": 8, "prefix_cache": True}],
                         ids=["bucketed", "chunk8_prefix"])
def test_traced_server_steps_in_lockstep_with_jax(e2e_pair, cfg, alpha):
    """The pair accepts every draft (alpha 1, where Eq. (1) takes gamma_max
    for any c < 1), so the second case pins alpha at 0.7, where each
    measured c picks its own gamma: there the measured c must move gamma
    off the prior's choice."""
    reqs = shared_prefix_trace(n=10)
    port, ref = _servers(e2e_pair, 3, alpha, **cfg)
    for i, (p, new) in enumerate(reqs):
        port.submit(ServeRequest(i, p, new))
        ref.submit(JaxRequest(i, p, new))
    gammas, k = [], 0
    while True:
        a, b = port.step(), ref.step()
        assert (a is None) == (b is None), k
        if a is None:
            break
        assert {key: a[key] for key in STEP_KEYS} == \
            {key: b[key] for key in STEP_KEYS}, k
        assert port.gamma == ref.gamma, k
        if a["round"] is not None:
            gammas.append(port.gamma)
        pe, re = port.events.events(), ref.events.events()
        assert len(pe) == len(re), k
        if pe:
            _same_event(pe[-1], re[-1])
        assert (port.drift is None) == (ref.drift is None), k
        if port.drift is not None:
            assert port.drift.to_dict() == ref.drift.to_dict(), k
        assert port.kv_traffic() == ref.kv_traffic(), k
        assert port.tracer.clock.t == ref.tracer.clock.t, k
        k += 1
    same_tokens({r.rid: np.asarray(r.tokens) for r in port.done},
                {r.rid: np.asarray(r.tokens) for r in ref.done})
    assert port.events.alpha_hat() == ref.events.alpha_hat()
    assert port.events.phase_means() == ref.events.phase_means()
    assert [_spans_key(s) for s in port.tracer.spans()] == \
        [_spans_key(s) for s in ref.tracer.spans()]
    # the loop closed: the drift monitor's measured c decided some gammas
    assert port.drift.calibrated and port._measured_c() is not None
    assert len(set(gammas)) > 1, gammas
    if alpha is not None:
        prior = cost_model.optimal_gamma(alpha, BASE_C, BASE["gamma_max"])[0]
        assert gammas[0] == prior and set(gammas) != {prior}, gammas
    if cfg:
        assert any(e.prefill_chunks for e in port.events.events())
        assert any(e.t_prefill is not None for e in port.events.events())
    pool_whole(port)


def _spans_key(s):
    return (s.name, s.t0, s.t1, s.depth, s.tags)


# ------------------------------------------------------- no-cache engine
@pytest.mark.parametrize("strategy", ["monolithic", "modular"])
def test_traced_nocache_engine_gives_the_untraced_tokens(pair, strategy):
    jt, jd, jpt, jpd = pair["jax"]
    mt, md, pt, pd = pair["torch"]
    prompt = np.random.default_rng(5).integers(0, 512, (2, 7)).astype(np.int32)
    tr = obs.Tracer(clock=ScriptedClock(2))
    jtr = jax_obs.Tracer(clock=ScriptedClock(2))
    cfg = engine.EngineConfig(gamma=GAMMA, strategy=strategy)
    got, s_got = engine.SpecEngine(mt, md, cfg, tracer=tr).generate(
        pt, pd, prompt, 12)
    want, s_want = engine.SpecEngine(mt, md, cfg).generate(pt, pd, prompt, 12)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert s_got == s_want
    jeng = jax_engine.SpecEngine(jt, jd, jax_engine.EngineConfig(
        gamma=GAMMA, use_cache=False, strategy=strategy), tracer=jtr)
    jtoks, _ = jeng.generate(jpt, jpd, jnp.asarray(prompt), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
    names = [s.name for s in tr.spans()]
    if strategy == "monolithic":
        assert names == ["generate"]
        assert tr.spans()[0].tags == {"phase": "round", "role": "target",
                                      "strategy": "monolithic"}
    else:
        assert names == ["draft", "verify", "commit"] * s_got["rounds"]
        assert [s.tags["round"] for s in tr.spans()] == \
            [k for k in range(s_got["rounds"]) for _ in range(3)]
    # the span program (and so every clock read) is JAX's
    assert [_spans_key(s) for s in tr.spans()] == \
        [_spans_key(s) for s in jtr.spans()]


# ------------------------------------------------------------------- CLIs
def _span_names(path):
    doc = json.loads(path.read_text())
    return [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]


def test_paged_cli_writes_the_trace(tmp_path, capsys):
    from repro_torch.launch import serve_paged
    path = tmp_path / "trace.json"
    srv = serve_paged.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                            "cpu", "--requests", "6", "--trace-out",
                            str(path)])
    names = set(_span_names(path))
    assert {"draft", "verify", "commit", "serve"} <= names, names
    out = capsys.readouterr().out
    assert f"spans -> {path}" in out
    assert srv.tracer.enabled and srv.drift is not None
    if srv.drift.evidence():
        assert "drift: measured c=" in out
    # without the flag nothing is traced
    quiet = serve_paged.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                              "cpu", "--requests", "2"])
    assert not quiet.tracer.enabled and quiet.tracer.spans() == []
    assert "spans ->" not in capsys.readouterr().out


def test_nocache_cli_writes_the_trace_jax_writes(tmp_path, capsys,
                                                 monkeypatch):
    """``serve --speculative --strategy modular --trace-out``: the
    draft/verify/commit spans of every round, the span names JAX's no-cache
    CLI writes (neither wraps the serve in a span). The CLIs draw their own
    weights (torch's and jax's generators differ), so the round counts may
    differ."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--arch", "llama3.2-1b", "--smoke", "--speculative", "--strategy",
            "modular", "--requests", "4", "--batch", "2"]
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    _, s = serve.main(argv + ["--device", "cpu", "--trace-out",
                              str(port_path)])
    # JAX's CLI reads sys.argv
    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--trace-out",
                                      str(ref_path)])
    jax_serve.main()
    got, want = _span_names(port_path), _span_names(ref_path)
    assert got == ["draft", "verify", "commit"] * s["rounds"]
    assert want == ["draft", "verify", "commit"] * (len(want) // 3)
    assert f"spans -> {port_path}" in capsys.readouterr().out
