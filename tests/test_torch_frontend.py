"""The port's streaming front end (``repro_torch.serving.frontend``) and the
metrics it reads, against ``repro.serving.frontend`` and JAX's metrics:
traces bit-equal to JAX's, the request records under ``ManualClock``
(queue wait, decode rate, TTFT, deadline outcome, per-request acceptance
histograms), ``AsyncSpecServer`` against JAX AR and against JAX's
``AsyncSpecServer`` on bridged weights (streams, cancellation with the
freed row re-admitted and the pool whole, backpressure, replay,
reject-at-submit, the true arrival stamp), a failing step ending every
stream with its error, ``Session.serve_async`` and the CLI on the CPU.

The asyncio tests are plain functions around ``asyncio.run`` (no
pytest-asyncio), and every await of a stream or of ``aclose`` is bounded
by ``asyncio.wait_for``, so a hang fails the test instead of stalling the
suite. The pair is the split pair of ``tests/_serving_parity.py``; both
servers run with gamma pinned and a watchdog that cannot trip.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import (build_pair, one_torch_thread,  # noqa: E402
                             pool_whole, servers)
from repro.core.engine import autoregressive_generate as jax_ar  # noqa: E402
from repro.obs.clock import ManualClock as JaxClock  # noqa: E402
from repro.serving import ServingMetrics as JaxMetrics  # noqa: E402
from repro.serving.frontend import AsyncSpecServer as JaxFront  # noqa: E402
from repro.serving.frontend import traffic as jax_traffic  # noqa: E402
from repro_torch.cache.paged_kv import BlockAllocator  # noqa: E402
from repro_torch.core.engine import autoregressive_generate  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.obs.clock import ManualClock  # noqa: E402
from repro_torch.serving import (AsyncSpecServer, Scheduler,  # noqa: E402
                                 SchedulerConfig, ServeRequest,
                                 ServingMetrics, StreamEvent)
from repro_torch.serving.frontend import (bursty_trace, poisson_trace,  # noqa: E402
                                          replay, shared_prefix_trace)

TIMEOUT = 60.0       # seconds any one await may take before the test fails
GAMMA = 3
JOBS = [(5, 8), (9, 6), (6, 4)]      # (prompt length, max_new)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _jobs(seed, shape=JOBS, vocab=512):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, P).astype(np.int32), new)
            for P, new in shape]


def _ar(pair, prompt, new):
    """The port's cached greedy AR continuation (new tokens only)."""
    mt, _, pt, _ = pair["torch"]
    return autoregressive_generate(mt, pt, prompt[None], new,
                                   use_cache=True)[0, len(prompt):].numpy()


def _bounded(coro):
    return asyncio.wait_for(coro, timeout=TIMEOUT)


async def _drain(stream):
    return [ev async for ev in stream]


async def _streams(front_cls, srv, jobs, **kw):
    """Submit every job before the stepper first runs, then drain all
    streams; returns each job's StreamEvents."""
    async with front_cls(srv, **kw) as front:
        streams = [await front.submit(p, new, events=True) for p, new in jobs]
        return await _bounded(asyncio.gather(*(_drain(s) for s in streams)))


# ------------------------------------------------------------------- traces
TRACES = {"poisson": (poisson_trace, jax_traffic.poisson_trace, {}),
          "bursty": (bursty_trace, jax_traffic.bursty_trace,
                     dict(on_s=0.3, off_s=0.7)),
          "shared_prefix": (shared_prefix_trace,
                            jax_traffic.shared_prefix_trace,
                            dict(prefix_len=12))}


@pytest.mark.parametrize("seed", [0, 9, 123])
@pytest.mark.parametrize("kind", sorted(TRACES))
def test_traces_are_bit_equal_to_jax(kind, seed):
    port, ref, kw = TRACES[kind]
    a = port(40, 6.0, 1000, seed=seed, slo_base_s=0.5, slo_per_token_s=0.02,
             **kw)
    b = ref(40, 6.0, 1000, seed=seed, slo_base_s=0.5, slo_per_token_s=0.02,
            **kw)
    assert len(a) == len(b) == 40
    for x, y in zip(a, b):
        assert (x.rid, x.arrival_s, x.max_new, x.deadline_s) == \
            (y.rid, y.arrival_s, y.max_new, y.deadline_s)
        assert x.prompt.dtype == y.prompt.dtype == np.int32
        np.testing.assert_array_equal(x.prompt, y.prompt)
    assert poisson_trace(3, 1.0, 9, seed=seed)[0].deadline_s is None


def test_traffic_traces_deterministic():
    a = poisson_trace(16, 4.0, 256, seed=9, slo_base_s=1.0,
                      slo_per_token_s=0.1)
    b = poisson_trace(16, 4.0, 256, seed=9, slo_base_s=1.0,
                      slo_per_token_s=0.1)
    assert [t.arrival_s for t in a] == [t.arrival_s for t in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.max_new == y.max_new
        assert x.deadline_s == pytest.approx(1.0 + 0.1 * x.max_new)
    c = poisson_trace(16, 4.0, 256, seed=10)
    assert [t.arrival_s for t in a] != [t.arrival_s for t in c]


def test_poisson_trace_rate():
    trace = poisson_trace(4000, 8.0, 256, seed=0)
    gaps = np.diff([t.arrival_s for t in trace])
    assert np.mean(gaps) == pytest.approx(1 / 8.0, rel=0.1)
    assert trace[0].arrival_s == 0.0


def test_bursty_trace_has_off_gaps():
    trace = bursty_trace(400, 50.0, 256, seed=0, on_s=0.5, off_s=2.0)
    gaps = np.diff([t.arrival_s for t in trace])
    assert len(gaps[gaps >= 2.0]) >= 3
    assert np.mean(gaps[gaps < 2.0]) == pytest.approx(1 / 50.0, rel=0.25)


def test_shared_prefix_trace_shares_its_system_prompt():
    trace = shared_prefix_trace(6, 5.0, 300, seed=4, prefix_len=10)
    for t in trace:
        np.testing.assert_array_equal(t.prompt[:10], trace[0].prompt[:10])
        assert 12 <= len(t.prompt) <= 18


# ------------------------------------------------------------------ metrics
def _metrics_script(m, clk):
    """One sequence of metrics calls (``clk`` advanced between them)."""
    m.submit(0, prompt_len=4, max_new=8, deadline=10.0)
    clk.advance(1.0)
    m.start(0)                  # queue-wait = 1s
    m.record_round([2, 0, 3], gamma=3, active=[True, False, True],
                   rids=[0, None, 1])
    clk.advance(0.5)
    m.first_token(0)            # ttft = 1.5s
    clk.advance(0.2)
    m.first_token(0)            # idempotent
    m.record_round([3, 1], gamma=3, rids=[0, 1])
    m.record_round([1, 1], gamma=0, rids=[0, 1])     # AR: no histogram
    clk.advance(1.3)
    m.complete(0, 6)            # completed at 3.0 <= 10.0
    m.submit(1, prompt_len=4, max_new=8, deadline=3.5, submitted=2.0)
    m.start(1)
    clk.advance(5.0)
    m.complete(1)               # 8.0 > 3.5
    m.submit(2, prompt_len=3, max_new=5)
    m.start(2)
    clk.advance(1.0)
    m.cancel(2, n_generated=3)


def test_metrics_under_manual_clock_equal_jax():
    port, ref = (ServingMetrics(gamma_max=4, now=ManualClock()),
                 JaxMetrics(gamma_max=4, now=JaxClock()))
    _metrics_script(port, port.now)
    _metrics_script(ref, ref.now)
    fields = ("rid", "submitted", "started", "completed", "n_rounds",
              "n_generated", "queue_wait", "ttft", "deadline_met",
              "decode_tps", "latency", "cancelled")
    for got, want in ((port.completed, ref.completed),
                      (port.cancelled, ref.cancelled)):
        assert [{f: getattr(r, f) for f in fields} for r in got] == \
            [{f: getattr(r, f) for f in fields} for r in want]
    assert sorted(port.row_hists) == sorted(ref.row_hists) == [0, 1]
    for rid in ref.row_hists:
        np.testing.assert_array_equal(port.row_hists[rid], ref.row_hists[rid])
    sp, sr = port.summary(), ref.summary()
    np.testing.assert_array_equal(sp.pop("accept_hist"), sr.pop("accept_hist"))
    sp.pop("prefill_chunks")        # the port's extra key
    assert sp == sr
    rec0 = port.completed[0]
    assert rec0.queue_wait == pytest.approx(1.0)
    assert rec0.ttft == pytest.approx(1.5)
    assert rec0.decode_tps == pytest.approx(6 / 2.0)
    assert port.completed[1].queue_wait == pytest.approx(1.0)
    assert port.row_hists[1].tolist() == [0, 1, 0, 1, 0]


def test_scheduler_submit_stamps_the_true_arrival():
    cfg = SchedulerConfig(max_batch=2, block_size=4, num_blocks=64,
                          max_blocks_per_row=12, gamma_max=4)
    clk = ManualClock(100.0)
    m = ServingMetrics(now=clk)
    sched = Scheduler(cfg, BlockAllocator(cfg.num_blocks, cfg.block_size,
                                          cfg.max_blocks_per_row,
                                          cfg.max_batch), m)
    clk.advance(5.0)   # the scheduler sees the request 5 s after arrival
    sched.submit(ServeRequest(0, np.arange(4), 4), submitted=100.0)
    assert m.requests[0].submitted == 100.0
    sched.try_admit(0)
    assert m.requests[0].queue_wait == pytest.approx(5.0)


# ---------------------------------------------------------------- streaming
def test_collecting_streams_adds_one_pull_and_no_launch(pair, monkeypatch):
    """The same traffic with ``collect_streams`` off and on: the same
    tokens and kernel calls (paged attention and the argmax, counted at
    their plain versions), and the streaming run pulls to the host exactly
    once more per round in which a row committed a token."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import spec_verify as sv
    calls = {"paged": 0, "argmax": 0, "pull": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(pa, "plain", counting("paged", pa.plain))
    monkeypatch.setattr(sv, "plain", counting("argmax", sv.plain))
    monkeypatch.setattr(torch.Tensor, "cpu",
                        counting("pull", torch.Tensor.cpu))
    runs = {}
    for collect in (False, True):
        for k in calls:
            calls[k] = 0
        port, _ = servers(pair, GAMMA)
        port.collect_streams = collect
        for i, (p, new) in enumerate(_jobs(6)):
            port.submit(ServeRequest(i, p, new))
        infos = []
        while (info := port.step()) is not None:
            infos.append(info)
        runs[collect] = (dict(calls), infos,
                         {r.rid: r.tokens for r in port.done})
    (off, infos_off, toks_off), (on, infos_on, toks_on) = runs[False], runs[True]
    assert all(i["streams"] == {} for i in infos_off)
    emitting = sum(bool(i["streams"]) for i in infos_on)
    assert emitting > 0
    assert on["pull"] == off["pull"] + emitting
    assert (on["paged"], on["argmax"]) == (off["paged"], off["argmax"]) != (0, 0)
    for rid in toks_off:
        np.testing.assert_array_equal(toks_on[rid], toks_off[rid])


@pytest.fixture(scope="module")
def jax_stream(pair):
    """JAX's front end on JOBS, and JAX's AR for each job."""
    _, ref = servers(pair, GAMMA)
    jobs = _jobs(0)
    evs = asyncio.run(_streams(JaxFront, ref, jobs))
    jt, _, jpt, _ = pair["jax"]
    ar = [np.asarray(jax_ar(jt, jpt, p[None], new, use_cache=True))[0, len(p):]
          for p, new in jobs]
    return evs, ar


def test_stream_matches_sync_and_jax(pair, jax_stream):
    """Streamed tokens equal JAX AR and the synchronous server's tokens;
    token for token the stream events (token, round) equal JAX's front
    end's, and every round id is a logged RoundEvent."""
    port, _ = servers(pair, GAMMA)
    jobs = _jobs(0)
    results = asyncio.run(_streams(AsyncSpecServer, port, jobs))
    want_evs, want_ar = jax_stream
    for (prompt, new), evs, jevs, ar in zip(jobs, results, want_evs, want_ar):
        assert all(isinstance(e, StreamEvent) for e in evs)
        assert [(e.token, e.round) for e in evs] == \
            [(e.token, e.round) for e in jevs]
        np.testing.assert_array_equal([e.token for e in evs], ar)
    assert {e.round for evs in results for e in evs} <= \
        {ev.round for ev in port.events.events()}
    sync, _ = servers(pair, GAMMA)
    for i, (p, new) in enumerate(jobs):
        sync.submit(ServeRequest(i, p, new))
    for r in sync.run():
        np.testing.assert_array_equal(r.tokens[len(jobs[r.rid][0]):],
                                      [e.token for e in results[r.rid]])
    s = port.metrics.summary()
    assert s["requests_completed"] == len(jobs) and s["p50_ttft_s"] is not None
    assert sorted(port.metrics.row_hists) == [0, 1, 2]
    pool_whole(port)


def test_cancel_mid_generation_frees_blocks_and_readmits(pair):
    """Dropping a stream after 2 tokens releases its row: the queued request
    is admitted into it and completes exactly, and the pool is whole."""
    port, _ = servers(pair, GAMMA, max_batch=1)   # B waits for A's row
    (pa, _), (pb, _) = _jobs(1, [(6, 24), (5, 6)])

    async def go():
        async with AsyncSpecServer(port) as front:
            sa = await front.submit(pa, 24)
            sb = await front.submit(pb, 6)
            got_a = []
            async for tok in sa:
                got_a.append(tok)
                if len(got_a) >= 2:
                    break
            await sa.aclose()          # cancel A mid-generation
            return got_a, await _bounded(_drain(sb))

    got_a, got_b = asyncio.run(_bounded(go()))
    assert len(got_a) >= 2
    np.testing.assert_array_equal(got_a, _ar(pair, pa, 24)[:len(got_a)])
    np.testing.assert_array_equal(got_b, _ar(pair, pb, 6))
    s = port.metrics.summary()
    assert s["requests_cancelled"] == 1 and s["requests_completed"] == 1
    assert port.metrics.cancelled[0].rid == 0
    assert 2 <= port.metrics.cancelled[0].n_generated < 24
    pool_whole(port)


def test_backpressure_bounded_stream_queue(pair):
    """max_stream_queue=1: a slow consumer stalls the stepper yet receives
    every token in order."""
    port, _ = servers(pair, GAMMA)
    (prompt, _), = _jobs(2, [(5, 10)])

    async def go():
        async with AsyncSpecServer(port, max_stream_queue=1) as front:
            s = await front.submit(prompt, 10)
            got = []
            async for tok in s:
                got.append(tok)
                await asyncio.sleep(0.01)   # slow consumer
            return got

    got = asyncio.run(_bounded(go()))
    np.testing.assert_array_equal(got, _ar(pair, prompt, 10))


def test_replay_poisson_trace_end_to_end(pair):
    port, _ = servers(pair, GAMMA)
    trace = poisson_trace(4, 50.0, 512, seed=3, prompt_lens=(4, 8),
                          max_news=(3, 6), slo_base_s=120.0)

    async def go():
        async with AsyncSpecServer(port) as front:
            return await replay(front, trace)

    records = asyncio.run(_bounded(go()))
    assert [r["rid"] for r in records] == [t.rid for t in trace]
    for r, t in zip(records, trace):
        assert r["n_tokens"] == t.max_new
        np.testing.assert_array_equal(r["tokens"], _ar(pair, t.prompt,
                                                       t.max_new))
        assert r["ttft_s"] is not None and r["ttft_s"] >= 0
        assert r["deadline_met"] is True
        assert r["rounds"]


def test_submit_rejects_never_fitting_demand(pair):
    port, _ = servers(pair, GAMMA)

    async def go():
        async with AsyncSpecServer(port) as front:
            with pytest.raises(ValueError, match="exceeds per-row capacity"):
                await front.submit(np.zeros(8, np.int64), 10_000)
            s = await front.submit(np.arange(5), 3)
            return await _bounded(_drain(s))

    assert len(asyncio.run(_bounded(go()))) == 3
    assert port.metrics.summary()["requests_rejected"] == 1
    assert "exceeds per-row capacity" in port.metrics.rejected[0][1]
    assert not port.sched.queue


def test_front_end_stamps_the_true_arrival(pair):
    """The record carries the front end's submit stamp, not the later time
    the stepper hands the request to the scheduler."""
    clk = ManualClock(100.0)
    port, _ = servers(pair, GAMMA, now=clk)
    (prompt, _), = _jobs(3, [(5, 4)])

    async def go():
        async with AsyncSpecServer(port, now=clk) as front:
            s = await front.submit(prompt, 4)
            clk.advance(5.0)           # before the stepper has run
            return await _bounded(_drain(s))

    assert len(asyncio.run(_bounded(go()))) == 4
    rec, = port.metrics.completed
    assert rec.submitted == 100.0 and rec.started == 105.0
    assert rec.queue_wait == 5.0


@pytest.mark.parametrize("max_stream_queue", [1, 64])
def test_failing_step_ends_every_stream_with_its_error(pair, max_stream_queue):
    """A step that raises (a failing kernel propagates out of the port's
    ``step()``) ends every open stream with that exception within the
    timeout, refuses new submissions with it, and ``aclose`` re-raises
    it; the server is not stepped again. With one-slot queues the streams
    end by the error flag (the queue may be full), else by the sentinel."""
    port, _ = servers(pair, GAMMA)
    real, calls = port.step, []

    def step():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("paged attention kernel failed (injected)")
        return real()
    port.step = step
    jobs = _jobs(4)

    async def go():
        front = await AsyncSpecServer(port, max_stream_queue=max_stream_queue
                                      ).start()
        streams = [await front.submit(p, new) for p, new in jobs]

        async def consume(s):
            got = []
            try:
                async for tok in s:
                    got.append(tok)
            except RuntimeError as e:
                return got, str(e)
            return got, None
        out = await _bounded(asyncio.gather(*(consume(s) for s in streams)))
        with pytest.raises(RuntimeError, match="injected"):
            await front.submit(jobs[0][0], 2)
        with pytest.raises(RuntimeError, match="injected"):
            await _bounded(front.aclose())
        return out

    out = asyncio.run(_bounded(go()))
    assert len(calls) == 3
    for (prompt, new), (got, err) in zip(jobs, out):
        assert err == "paged attention kernel failed (injected)"
        assert len(got) < new
        np.testing.assert_array_equal(got, _ar(pair, prompt, new)[:len(got)])
    assert any(got for got, _ in out)


# ------------------------------------------------------------ session + CLI
def test_session_serve_async_streams_the_plans_tokens(pair):
    from repro_torch import api
    mt, md, pt, pd = pair["torch"]
    plan = api.Planner(api.DeploymentSpec(
        batch_size=2, prompt_lens=(5, 9), max_new=(4, 8), streaming=True,
        cost_coefficient=0.2, adaptive_gamma=False)).plan()
    sess = api.Session(mt, md, pt, pd, plan, device="cpu")
    front = sess.serve_async(max_stream_queue=4)
    assert isinstance(front, AsyncSpecServer) and front._task is None
    assert front.server is sess.backend.server and front.server.collect_streams
    jobs = _jobs(5)
    results = asyncio.run(_bounded(_streams(lambda s, **kw: front, None, jobs)))
    for (prompt, new), evs in zip(jobs, results):
        np.testing.assert_array_equal([e.token for e in evs],
                                      _ar(pair, prompt, new))


def test_cli_replays_on_the_cpu(capsys):
    records, front = serve_async.main(
        ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
         "--requests", "4", "--rate", "40", "--slo-base-s", "60",
         "--slo-per-token-s", "0.1", "--gamma", "3"])
    out = capsys.readouterr().out
    assert "replayed 4 requests" in out and "goodput: 4/4" in out
    assert "queue depth mean=" in out and "@" in out
    assert sorted(rec.rid for rec in front.metrics.completed) == [0, 1, 2, 3]
    mt, pt = front.server.target, front.server.params_t
    trace = poisson_trace(4, 40.0, mt.cfg.vocab_size, seed=0)
    for r, t in zip(records, trace):
        ar = autoregressive_generate(mt, pt, t.prompt[None], t.max_new,
                                     use_cache=True)[0, len(t.prompt):]
        np.testing.assert_array_equal(r["tokens"], ar.numpy())
