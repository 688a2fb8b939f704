"""Port parity of the observability layer (``repro_torch.obs`` and the
cost-model terms it prices rounds with) against ``repro.obs``.

Four contracts, each on the same inputs in both packages:
  * Tracer — the same span program on a scripted clock gives equal spans,
    per-phase totals, total/count queries and Chrome-trace documents; a
    disabled tracer hands out one shared null span and records nothing;
    the ring buffer keeps the newest ``capacity`` spans;
  * RoundEventLog — the same RoundEvent sequence gives the same alpha EMA,
    acceptance histogram, phase means and JSONL lines (and the port's log
    reproduces the port's ServingMetrics alpha);
  * DriftMonitor — one observation sequence (hypothesis-drawn, components
    missing at random) gives equal report(), alerts(), evidence() and
    to_dict() to relative 1e-12, and the port passes the JAX suite's drift
    scenarios (tests/test_obs.py) on its own;
  * cost model — ``round_time`` and ``cost_coefficient`` equal JAX's."""
import dataclasses
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import obs as jax_obs  # noqa: E402
from repro.core import cost_model as jax_cost  # noqa: E402
from repro.serving import ServingMetrics as JaxMetrics  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.serving.metrics import ServingMetrics  # noqa: E402


class ScriptedClock:
    """A clock that advances by a different, seeded amount at every read;
    two instances with one seed return the same sequence."""

    def __init__(self, seed, lo=1e-4, hi=5e-3):
        self._inc = np.random.default_rng(seed).uniform(lo, hi, 4096)
        self._k = 0
        self.t = 100.0

    def __call__(self) -> float:
        self.t += float(self._inc[self._k % len(self._inc)])
        self._k += 1
        return self.t


def same_floats(a, b, rel=1e-12, path="$"):
    """Equal structure; floats within ``rel`` of each other, all else
    equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            same_floats(a[k], b[k], rel, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_floats(x, y, rel, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float), (path, a, b)
        assert a == b or b == pytest.approx(a, rel=rel, abs=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------- tracer
def _span_program(tracer, seed):
    """A random nest of spans with random tags, the same for every tracer
    given one seed: depth up to 3, some spans tagged with phase/role."""
    rng = np.random.default_rng(seed)
    phases = ("draft", "verify", "commit", "prefill", None)
    roles = ("drafter", "target", None)

    def body(depth):
        for i in range(int(rng.integers(1, 4))):
            tags = {"round": int(rng.integers(0, 9))}
            phase, role = phases[rng.integers(5)], roles[rng.integers(3)]
            if phase is not None:
                tags["phase"] = phase
            if role is not None:
                tags["role"] = role
            if rng.random() < 0.3:
                tags["note"] = None           # dropped on export
            with tracer.span(f"s{depth}.{i}", **tags):
                if depth < 3 and rng.random() < 0.5:
                    body(depth + 1)

    with tracer.span("serve", phase="serve"):
        body(0)


@pytest.mark.parametrize("seed", range(5))
def test_same_span_program_gives_the_same_trace(seed):
    port = obs.Tracer(clock=ScriptedClock(seed))
    ref = jax_obs.Tracer(clock=ScriptedClock(seed))
    _span_program(port, seed)
    _span_program(ref, seed)
    got, want = port.spans(), ref.spans()
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert (a.name, a.t0, a.t1, a.depth, a.thread, a.tags) == \
            (b.name, b.t0, b.t1, b.depth, b.thread, b.tags)
        assert a.duration == b.duration
    assert port.phase_totals() == ref.phase_totals()
    for match in ({}, {"phase": "draft"}, {"role": "target"},
                  {"name": "serve"}, {"phase": "verify", "role": "drafter"}):
        assert port.total(**match) == ref.total(**match), match
        assert port.count(**match) == ref.count(**match), match
    assert port.to_chrome_trace() == ref.to_chrome_trace()


def read(path):
    with open(path) as f:
        return f.read()


def test_export_writes_the_same_document(tmp_path):
    port = obs.Tracer(clock=ScriptedClock(9))
    ref = jax_obs.Tracer(clock=ScriptedClock(9))
    for tr in (port, ref):
        _span_program(tr, 9)
    a = json.loads(read(port.export(str(tmp_path / "port.json"))))
    b = json.loads(read(ref.export(str(tmp_path / "ref.json"))))
    assert a == b
    names = {e["name"] for e in a["traceEvents"] if e["ph"] == "X"}
    assert "serve" in names


def test_disabled_tracer_is_a_shared_null_span():
    tr = obs.Tracer(enabled=False)
    s1, s2 = tr.span("a", phase="draft"), tr.span("b", role="host")
    assert s1 is s2
    with s1:
        pass
    assert s1.duration == 0.0
    assert tr.spans() == [] and tr.count() == 0 and tr.phase_totals() == {}
    assert not obs.NULL_TRACER.enabled
    with obs.NULL_TRACER.span("x"):
        pass
    assert obs.NULL_TRACER.spans() == []
    # the disabled tracer never reads its clock
    reads = []
    quiet = obs.Tracer(enabled=False, clock=lambda: reads.append(1) or 0.0)
    with quiet.span("x"):
        pass
    assert reads == []


def test_ring_buffer_keeps_the_newest_spans():
    port = obs.Tracer(clock=ScriptedClock(1), capacity=4)
    ref = jax_obs.Tracer(clock=ScriptedClock(1), capacity=4)
    for tr in (port, ref):
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
    assert [s.name for s in port.spans()] == ["s6", "s7", "s8", "s9"]
    assert [(s.t0, s.t1) for s in port.spans()] == \
        [(s.t0, s.t1) for s in ref.spans()]
    port.clear()
    assert port.spans() == []


# ---------------------------------------------------------------- round events
def _events(seed, n=40, B=4):
    """(kwargs of RoundEvent, per-row accepted, gamma, active, rids) for a
    random round sequence: AR rounds, gamma past gamma_max, missing phase
    times, inactive rows."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        gamma = int(rng.integers(0, 9))
        acc = (rng.integers(0, gamma + 1, B) if gamma > 0
               else np.zeros(B, np.int64))
        active = rng.random(B) < 0.8
        active[0] = True
        rids = [10 + b if live else None for b, live in enumerate(active)]
        live_acc = tuple(int(a) for a, live in zip(acc, active) if live)
        traced = rng.random() < 0.7 and gamma > 0

        def t():
            return float(rng.uniform(1e-4, 1e-2))
        kw = dict(round=k, gamma=gamma, n_active=len(live_acc),
                  accepted=live_acc, emitted=sum(live_acc) + len(live_acc),
                  t_round=t(), t_draft=t() if traced else None,
                  t_verify=t() if traced else None,
                  t_commit=t() if traced else None,
                  blocks_read=int(rng.integers(0, 99)),
                  blocks_written=int(rng.integers(0, 9)),
                  rids=tuple(r for r in rids if r is not None),
                  t_wall=1000.0 + k, queue_depth=int(rng.integers(0, 5)),
                  n_preempted=int(rng.integers(0, 2)),
                  prefill_tokens=int(rng.integers(0, 9)),
                  prefill_chunks=int(rng.integers(0, 2)),
                  t_prefill=t() if rng.random() < 0.4 else None,
                  prefix_hit_rate=(float(rng.random()) if rng.random() < 0.5
                                   else None))
        out.append((kw, acc, gamma, active, rids))
    return out


def test_round_event_has_jaxs_fields_in_jaxs_order():
    assert [f.name for f in dataclasses.fields(obs.RoundEvent)] == \
        [f.name for f in dataclasses.fields(jax_obs.RoundEvent)]
    assert [f.default for f in dataclasses.fields(obs.RoundEvent)] == \
        [f.default for f in dataclasses.fields(jax_obs.RoundEvent)]


@pytest.mark.parametrize("seed", range(3))
def test_same_events_give_the_same_log(seed):
    sp, sr = io.StringIO(), io.StringIO()
    port = obs.RoundEventLog(alpha_ema=0.9, stream=sp)
    ref = jax_obs.RoundEventLog(alpha_ema=0.9)
    ref.stream_to(sr)
    metrics = ServingMetrics(gamma_max=6, alpha_ema=0.9, now=lambda: 0.0)
    jmetrics = JaxMetrics(gamma_max=6, alpha_ema=0.9, now=lambda: 0.0)
    for kw, acc, gamma, active, rids in _events(seed):
        a, b = obs.RoundEvent(**kw), jax_obs.RoundEvent(**kw)
        assert a.alpha_round == b.alpha_round
        assert a.to_json() == b.to_json()
        port.record(a)
        ref.record(b)
        metrics.record_round(acc, gamma, active=active, rids=rids)
        jmetrics.record_round(acc, gamma, active=active, rids=rids)
    assert port.alpha_hat() is not None
    assert port.alpha_hat() == ref.alpha_hat() == metrics.alpha_hat() \
        == jmetrics.alpha_hat()
    for gmax in (4, 6, 8):
        np.testing.assert_array_equal(port.accept_hist(gmax),
                                      ref.accept_hist(gmax))
    np.testing.assert_array_equal(port.accept_hist(6), metrics.accept_hist)
    assert port.phase_means() == ref.phase_means()
    assert {"t_round", "t_draft", "t_prefill"} <= set(port.phase_means())
    assert (port.n_rounds, port.n_spec_rounds, port.total_emitted) == \
        (ref.n_rounds, ref.n_spec_rounds, ref.total_emitted)
    assert sp.getvalue() == sr.getvalue()
    assert len(sp.getvalue().splitlines()) == port.n_rounds


def test_to_jsonl_and_capacity(tmp_path):
    port = obs.RoundEventLog(capacity=5)
    ref = jax_obs.RoundEventLog(capacity=5)
    for kw, *_ in _events(7, n=12):
        port.record(obs.RoundEvent(**kw))
        ref.record(jax_obs.RoundEvent(**kw))
    assert [e.round for e in port.events()] == [7, 8, 9, 10, 11]
    a = read(port.to_jsonl(str(tmp_path / "p.jsonl")))
    b = read(ref.to_jsonl(str(tmp_path / "r.jsonl")))
    assert a == b and len(a.splitlines()) == 5
    assert json.loads(a.splitlines()[0])["round"] == 7


# ----------------------------------------------------------------------- drift
_COMPONENTS = ("t_round", "t_draft", "t_verify", "t_commit", "t_handoff",
               "t_prefill")
_time = st.floats(min_value=1e-5, max_value=0.5, allow_nan=False)
_obs = st.fixed_dictionaries(
    {k: st.one_of(st.none(), _time) for k in _COMPONENTS},
    optional={"gamma": st.integers(0, 9)})
_cfg = st.builds(jax_obs.DriftConfig,
                 ema=st.floats(0.0, 0.99), tol=st.floats(0.01, 1.0),
                 warmup_rounds=st.integers(0, 3),
                 calibration_rounds=st.integers(1, 4),
                 min_samples=st.integers(1, 5),
                 min_abs=st.sampled_from([0.0, 1e-4]))


def _both(gamma, c, cfg=None, **kw):
    port_cfg = (obs.DriftConfig(**dataclasses.asdict(cfg))
                if cfg is not None else None)
    return (obs.DriftMonitor(gamma, c, cfg=port_cfg, **kw),
            jax_obs.DriftMonitor(gamma, c, cfg=cfg, **kw))


def _same_monitor(port, ref):
    assert port.calibrated == ref.calibrated
    same_floats(port.report(), ref.report())
    same_floats(port.evidence(), ref.evidence())
    same_floats(port.to_dict(), ref.to_dict())
    assert len(port.alerts()) == len(ref.alerts())


@settings(max_examples=60, deadline=None)
@given(gamma=st.integers(0, 8), c=st.floats(0.01, 2.0), cfg=_cfg,
       h=st.sampled_from([cost_model.DISPATCH_OVERHEAD_DEFAULT, 0.3, 1.5]),
       overlap=st.booleans(), seq=st.lists(_obs, min_size=0, max_size=14))
def test_drift_monitor_matches_jax_on_any_sequence(gamma, c, cfg, h, overlap,
                                                    seq):
    port, ref = _both(gamma, c, cfg, dispatch_overhead=h, overlap=overlap)
    for o in seq:
        port.observe(**o)
        ref.observe(**o)
        _same_monitor(port, ref)
    for comp in ("draft", "verify", "round", "commit", "prefill"):
        a, b = port.predicted_units(comp), ref.predicted_units(comp)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, rel=1e-12)


_CFG = dict(ema=0.9, tol=0.2, warmup_rounds=0, calibration_rounds=2,
            min_samples=3)
_UNIT = 0.01                               # clean t_target: 10 ms


def _clean_round(gamma=4, c=0.25):
    h = cost_model.DISPATCH_OVERHEAD_DEFAULT
    return dict(t_draft=gamma * c * _UNIT, t_verify=_UNIT, t_commit=1e-3,
                t_round=cost_model.round_time(gamma, c, h) * _UNIT)


def test_drift_flags_injected_verify_slowdown():
    port, ref = _both(4, 0.25, jax_obs.DriftConfig(**_CFG))
    for mon in (port, ref):
        for _ in range(2):
            mon.observe(**_clean_round())
        assert mon.calibrated and mon.unit == pytest.approx(_UNIT)
        slow = _clean_round()
        slow["t_verify"] = 2 * _UNIT
        slow["t_round"] += _UNIT
        for _ in range(4):
            mon.observe(**slow)
    rep = port.report()
    assert rep["verify"]["flagged"] and not rep["draft"]["flagged"]
    assert rep["verify"]["rel_err"] == pytest.approx(1.0, abs=0.05)
    assert any("verify" in m and "+100%" in m for m in port.alerts())
    assert port.alerts() == ref.alerts()
    _same_monitor(port, ref)


def test_drift_quiet_when_model_holds():
    port, ref = _both(4, 0.25, jax_obs.DriftConfig(**_CFG))
    for mon in (port, ref):
        for _ in range(10):
            mon.observe(**_clean_round())
    assert port.calibrated and port.alerts() == []
    for comp, r in port.report().items():
        assert not r["flagged"] and abs(r["rel_err"]) < 0.05, comp
    _same_monitor(port, ref)


def test_drift_unit_survives_warmup_priced_calibration():
    cfg = jax_obs.DriftConfig(ema=0.9, tol=0.2, warmup_rounds=1,
                              calibration_rounds=3)
    port, ref = _both(4, 0.25, cfg)
    for mon in (port, ref):
        mon.observe(t_verify=50 * _UNIT, t_draft=50 * _UNIT)   # dropped
        mon.observe(t_verify=20 * _UNIT, t_draft=_UNIT)
        mon.observe(t_verify=_UNIT, t_draft=_UNIT)
        mon.observe(t_verify=_UNIT, t_draft=_UNIT)
    assert port.calibrated and port.unit == pytest.approx(_UNIT)
    for mon in (port, ref):
        mon.observe(t_verify=0.8 * _UNIT)
    assert port.unit == pytest.approx(0.8 * _UNIT)     # refines down...
    for mon in (port, ref):
        mon.observe(t_verify=3 * _UNIT)
    assert port.unit == pytest.approx(0.8 * _UNIT)     # ...never up
    _same_monitor(port, ref)


def test_drift_evidence_measures_c():
    """The evidence half of the JAX suite's re-planning scenario (its
    ``respec_from_drift``/``Planner`` half waits for the planner facade):
    drafting at twice the planned c shows as measured c = 0.5."""
    port, ref = _both(4, 0.25, jax_obs.DriftConfig(**_CFG))
    assert port.evidence() is None
    for mon in (port, ref):
        for _ in range(6):
            mon.observe(t_draft=4 * 0.5 * _UNIT, t_verify=_UNIT,
                        t_round=(4 * 0.5 + 1.05) * _UNIT)
    ev = port.evidence()
    assert ev["c"] == pytest.approx(0.5, rel=0.05)
    assert ev["t_target"] == pytest.approx(_UNIT)
    assert ev["dispatch_overhead"] == pytest.approx(0.05, abs=1e-9)
    _same_monitor(port, ref)


# ------------------------------------------------------------------ cost model
def test_round_time_and_cost_coefficient_match_jax():
    assert cost_model.DISPATCH_OVERHEAD_DEFAULT == \
        jax_cost.DISPATCH_OVERHEAD_DEFAULT
    for gamma in range(0, 9):
        for c in (0.0, 0.05, 0.25, 0.6, 1.3):
            for h in (0.0, 0.05, 0.9, 1.0, 2.5):
                for overlap in (False, True):
                    assert cost_model.round_time(gamma, c, h, overlap) == \
                        jax_cost.round_time(gamma, c, h, overlap)
            assert cost_model.round_time(gamma, c) == \
                jax_cost.round_time(gamma, c)
    for t_d, t_t in ((1e-3, 4e-3), (0.7, 0.3), (5, 2)):
        assert cost_model.cost_coefficient(t_d, t_t) == \
            jax_cost.cost_coefficient(t_d, t_t)
    assert math.isclose(cost_model.cost_coefficient(1, 4), 0.25)
