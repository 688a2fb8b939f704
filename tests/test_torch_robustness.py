"""Port parity for the paged server's robustness layer: the seeded fault
plan (``repro_torch.serving.faults``), the straggler watchdog
(``serving.watchdog``) and degradation to AR, against ``repro``.

The fault scenarios of ``tests/test_robustness.py`` (the seeded chaos run,
the drafter fault, the watchdog trip, the corrupt output) run here with
the port's ``PagedSpecServer`` and JAX's stepped together
(``tests/_serving_parity.py::lockstep``: step-info, allocator tables and
free lists after every step) on the same bridged weights, each server's
tracer reading its own instance of one seeded ``ScriptedClock`` (so both
watchdogs see the same round times). After the drain they must agree on
tokens, ``metrics.degradations`` (round and reason), round counts,
failed rids with their reasons, every event's ``degraded`` and
``fault_delay``, and the audit. One difference is deliberate and shown
here: the port degrades only on a ``DrafterFault`` and on the watchdog's
trip; any other exception in the round propagates out of ``step()``,
where JAX degrades."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import build_pair, lockstep, one_torch_thread  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving import PagedSpecServer as JaxServer  # noqa: E402
from repro.serving import RoundWatchdog as JaxWatchdog  # noqa: E402
from repro.serving import SchedulerConfig as JaxConfig  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.serving import (NO_FAULTS, DrafterFault, FaultPlan,  # noqa: E402
                                 PagedSpecServer, RoundWatchdog,
                                 SchedulerConfig, ServeRequest)

RAGGED = [(5, 12), (7, 10), (6, 11), (8, 9), (5, 12)]
OVERCOMMIT = dict(max_batch=3, block_size=4, num_blocks=16, max_blocks_per_row=8,
                  gamma_max=4, prefill_buckets=(8, 16, 32), overcommit=2.0)
PLAIN = dict(max_batch=2, block_size=4, num_blocks=64, max_blocks_per_row=12,
             gamma_max=4, prefill_buckets=(8, 16))


class ScriptedClock:
    """Advances by a seeded amount (0.5-5 ms) at every read; two instances
    of one seed return one sequence."""

    def __init__(self, seed):
        self._inc = np.random.default_rng(seed).uniform(5e-4, 5e-3, 1 << 14)
        self._k = 0
        self.t = 0.0

    def __call__(self) -> float:
        self.t += float(self._inc[self._k])
        self._k += 1
        return self.t


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _jax_plan(plan):
    return JaxFaultPlan(**{k: getattr(plan, k) for k in
                           ("delay_rounds", "drafter_fail_rounds",
                            "corrupt_rounds", "pool_deltas", "seed")})


def _trace(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, P).astype(np.int32), new) for P, new in shapes]


def _servers(pair, cfg, gamma=None, faults=None, watchdog=None, clock_seed=0):
    """The port's server and JAX's on one config, fault plan and watchdog
    setting, each tracer (disabled) reading its own ScriptedClock."""
    mt, md, pt, pd = pair["torch"]
    jt, jd, jpt, jpd = pair["jax"]
    wd = watchdog or {}
    port = PagedSpecServer(
        mt, md, pt, pd, SchedulerConfig(**cfg), gamma=gamma, device="cpu",
        faults=faults, watchdog=RoundWatchdog(**wd),
        tracer=obs.Tracer(enabled=False, clock=ScriptedClock(clock_seed)))
    ref = JaxServer(
        jt, jd, jpt, jpd, JaxConfig(**cfg), gamma=gamma,
        faults=None if faults is None else _jax_plan(faults),
        watchdog=JaxWatchdog(**wd),
        tracer=jax_obs.Tracer(enabled=False, clock=ScriptedClock(clock_seed)))
    return port, ref


def _same_outcome(port, ref, got, want):
    """Everything the two servers must agree on after the drain."""
    assert sorted(got) == sorted(want)
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")
    assert port.metrics.degradations == ref.metrics.degradations
    assert (port.metrics.n_rounds, port.metrics.n_spec_rounds) == \
        (ref.metrics.n_rounds, ref.metrics.n_spec_rounds)
    assert [(r.rid, r.failed) for r in port.metrics.failed] == \
        [(r.rid, r.failed) for r in ref.metrics.failed]
    assert [(e.round, e.gamma, e.degraded, e.fault_delay)
            for e in port.events.events()] == \
        [(e.round, e.gamma, e.degraded, e.fault_delay)
         for e in ref.events.events()]
    assert port.total_steps == ref.total_steps
    sp, sr = port.metrics.summary(), ref.metrics.summary()
    for key in ("requests_completed", "requests_failed", "n_preemptions",
                "degradations", "rounds", "spec_rounds"):
        assert sp[key] == sr[key], key
    assert port.alloc.audit() == ref.alloc.audit()


def _pool_whole(srv):
    srv.alloc.release_seized()
    assert srv.alloc.audit() == {"free": srv.scfg.num_blocks - 1, "live": 0,
                                 "cached": 0, "seized": 0}


def _all_terminal(srv, n):
    s = srv.metrics.summary()
    assert (s["requests_completed"] + s["requests_cancelled"]
            + s["requests_expired"] + s["requests_failed"]
            + s["requests_rejected"]) == n
    assert not srv.metrics.requests
    assert not srv.sched.queue and all(r is None for r in srv._slots)


# ------------------------------------------------------------ the fault plan
@pytest.mark.parametrize("seed", [0, 1, 5, 17, 123])
@pytest.mark.parametrize("rates", [
    {}, dict(p_delay=0.2, delay_s=0.05, p_drafter=0.15, p_seize=0.2,
             max_seize=3),
    dict(horizon=64, p_corrupt=0.1, p_seize=0.0),
    dict(horizon=32, p_delay=0.0, p_drafter=0.0, p_seize=0.5, max_seize=1)])
def test_seeded_fault_plan_equals_jax(seed, rates):
    got = FaultPlan.seeded(seed, **rates)
    want = JaxFaultPlan.seeded(seed, **rates)
    for name in ("delay_rounds", "drafter_fail_rounds", "corrupt_rounds",
                 "pool_deltas", "seed"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.describe() == want.describe() and got.empty == want.empty
    for r in range(-1, rates.get("horizon", 256) + 6):
        assert (got.round_delay(r), got.drafter_fails(r), got.corrupts(r),
                got.pool_delta(r)) == (want.round_delay(r), want.drafter_fails(r),
                                       want.corrupts(r), want.pool_delta(r))
    assert NO_FAULTS.empty and NO_FAULTS.describe() == "no faults"
    assert issubclass(DrafterFault, RuntimeError)


@pytest.mark.parametrize("kw", [{}, dict(slow_factor=3.0, patience=2, min_rounds=2),
                                dict(slow_factor=2.0, patience=1, ema=0.5,
                                     min_rounds=1)])
def test_watchdog_observe_equals_jax(kw):
    """Seeded round times with straggler bursts: every return value and
    every field after every observation, across resets."""
    rng = np.random.default_rng(11)
    times = rng.uniform(0.01, 0.02, 200)
    times[rng.random(200) < 0.15] *= rng.uniform(2, 12)
    wd, jwd = RoundWatchdog(**kw), JaxWatchdog(**kw)
    fields = ("baseline", "n_healthy", "breaches", "tripped", "n_trips")
    trips = 0
    for i, t in enumerate(times):
        if i and i % 50 == 0:
            wd.reset()
            jwd.reset()
        got, want = wd.observe(float(t)), jwd.observe(float(t))
        assert got == want, i
        trips += got
        assert [getattr(wd, f) for f in fields] == [getattr(jwd, f) for f in fields]
    assert trips > 0


# ---------------------------------------------------------------- chaos
def test_seeded_chaos_run_in_lockstep_with_jax(pair):
    """The chaos run: seeded delays, drafter failures and pool seizures on
    the overcommitted server. Every request finishes with the fault-free
    run's tokens and the pool whole, and the port matches JAX step by
    step. Gamma is pinned: on this pair the cost model turns to AR after
    the first round, and the drafter faults would never be consulted."""
    plan = FaultPlan.seeded(5, horizon=256, p_delay=0.2, delay_s=0.05,
                            p_drafter=0.15, p_seize=0.2, max_seize=3)
    reqs = _trace(RAGGED, seed=4)
    port, ref = _servers(pair, OVERCOMMIT, gamma=2, faults=plan)
    _, got, want = lockstep(port, ref, reqs)
    _same_outcome(port, ref, got, want)
    fault_steps = (set(plan.delay_rounds) | set(plan.drafter_fail_rounds)
                   | set(plan.pool_deltas))
    assert any(s < port.total_steps for s in fault_steps)
    reasons = [why for _, why in port.metrics.degradations]
    assert any("injected drafter failure" in why for why in reasons)
    assert any(e.fault_delay > 0 for e in port.events.events())
    _all_terminal(port, len(reqs))
    assert port.metrics.summary()["requests_completed"] == len(reqs)
    _pool_whole(port)
    clean, _ = _servers(pair, OVERCOMMIT, gamma=2)
    for i, (p, new) in enumerate(reqs):
        clean.submit(ServeRequest(i, p, new))
    ref_tokens = {r.rid: r.tokens for r in clean.run()}
    for rid, toks in got.items():
        np.testing.assert_array_equal(toks, ref_tokens[rid])


def test_drafter_fault_degrades_batch_to_ar_in_lockstep(pair):
    plan = FaultPlan(drafter_fail_rounds=frozenset({1}))
    port, ref = _servers(pair, PLAIN, gamma=2, faults=plan)
    _, got, want = lockstep(port, ref, _trace([(6, 10), (9, 12)], seed=1))
    _same_outcome(port, ref, got, want)
    reasons = [why for _, why in port.metrics.degradations]
    assert reasons == ["spec round failed: injected drafter failure at step 1"]
    assert port.metrics.n_rounds > port.metrics.n_spec_rounds
    assert [e.degraded for e in port.events.events()][:3] == [False, True, True]
    _pool_whole(port)


def test_watchdog_trips_on_straggling_rounds_in_lockstep(pair):
    """Virtual delays inflate t_round past the watchdog's threshold: the
    batch degrades with the watchdog's reason, in the round JAX's does."""
    plan = FaultPlan(delay_rounds={4: 30.0, 5: 30.0, 6: 30.0})
    port, ref = _servers(pair, {**PLAIN, "max_batch": 1}, gamma=2, faults=plan,
                         watchdog=dict(slow_factor=3.0, patience=2,
                                       min_rounds=2))
    _, got, want = lockstep(port, ref, _trace([(6, 24)], seed=2))
    _same_outcome(port, ref, got, want)
    assert port.metrics.degradations == [
        (6, "watchdog: straggling speculative rounds")]
    assert port.watchdog.n_trips == 1
    assert port.metrics.n_rounds > port.metrics.n_spec_rounds
    _pool_whole(port)


def test_corrupt_output_fails_request_cleanly_in_lockstep(pair):
    """The output guard: a poisoned committed token fails its request with
    the reason recorded, the neighbours complete with the clean tokens."""
    plan = FaultPlan(corrupt_rounds=frozenset({1, 2}))
    reqs = _trace([(6, 12), (9, 12), (5, 10)], seed=3)
    port, ref = _servers(pair, PLAIN, gamma=2, faults=plan)
    _, got, want = lockstep(port, ref, reqs)
    _same_outcome(port, ref, got, want)
    assert len(port.metrics.failed) >= 1
    for rec in port.metrics.failed:
        assert "corrupt token id" in rec.failed
    _all_terminal(port, len(reqs))
    assert len(got) == len(reqs) - len(port.metrics.failed)
    clean, _ = _servers(pair, PLAIN, gamma=2)
    for i, (p, new) in enumerate(reqs):
        clean.submit(ServeRequest(i, p, new))
    clean_tokens = {r.rid: r.tokens for r in clean.run()}
    for rid, toks in got.items():
        np.testing.assert_array_equal(toks, clean_tokens[rid])
    _pool_whole(port)


# ------------------------------------------------ the deliberate difference
def test_other_round_failures_raise_where_jax_degrades(pair):
    """A RuntimeError in the speculative round (a failing kernel) raises
    from the port's ``step()`` and degrades nothing; JAX's server turns the
    same failure into an AR batch."""
    port, ref = _servers(pair, PLAIN, gamma=2)
    reqs = _trace([(6, 10)], seed=1)
    for i, (p, new) in enumerate(reqs):
        port.submit(ServeRequest(i, p, new))
        ref.submit(JaxRequest(i, p, new))

    def boom(*args, **kw):
        raise RuntimeError("kernel launch failed")
    eng = port._engine(2)
    eng.round = boom
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port.step()
    assert port.metrics.degradations == [] and not port._degraded
    jeng = ref._engine(2)
    jeng._round_jit = boom
    ref.step()
    assert ref.metrics.degradations == [
        (0, "spec round failed: kernel launch failed")]
