"""AsyncSpecServer: an asyncio streaming front end over PagedSpecServer
(port of ``repro/serving/frontend/async_server.py``).

ONE background stepper drives the paged server's round loop; everything
else is queues.

    submit() ──validate──► pending deque ─┐                 (loop thread)
                                          ▼
    stepper: drain pending → server.step() in a worker thread → fan out
             committed tokens to per-request asyncio.Queues (await put =
             BACKPRESSURE: a full stream queue pauses the whole stepper
             until the consumer drains or drops the iterator)

Threading model: the ONLY code that touches scheduler, allocator and device
state is ``_drain_and_step``, which the stepper runs via
``run_in_executor`` so a long round never blocks the event loop (arrival
stamps and cancellations stay honest under load). The worker thread runs
with the server's CUDA device as its current device, so nothing it
allocates lands on ``cuda:0`` by accident. The loop thread and the worker
hand work to each other only through thread-safe deques:

  * submissions — ``submit()`` validates eagerly (reject-at-submit errors
    surface to the caller, recorded in metrics), stamps the TRUE arrival
    time, and appends to ``_pending``; the stepper drains it into the
    scheduler before each round.
  * cancellation — dropping the async iterator (``aclose``/GC/``break``)
    lands the rid in the server's cancel deque; the next step releases the
    row, frees its KV blocks, and can re-admit a queued request into the
    freed row in the same step.

Token streams are exact: a committed token is final (verify accepted it),
so the per-round harvest fans out exactly the tokens the synchronous
``run()`` would have produced.

Every ``StreamEvent`` carries the round's ``RoundEvent.round`` id, so a
stream joins the obs layer: TTFT decomposes into queue-wait
(``RequestRecord.queue_wait``), prefill and the first round.

A failing step (deliberate difference from the JAX front end): the port's
``step()`` lets any exception other than an injected ``DrafterFault`` out,
so that a failing kernel is never hidden. The stepper then ends every open
stream with that exception (each consumer's ``async for`` raises it once
the tokens already queued are read), refuses further submissions with it,
and ``aclose`` re-raises it. It never steps again after the failure. The
JAX stepper dies with the exception and leaves its consumers waiting.
"""
from __future__ import annotations

import asyncio
import contextlib
from collections import deque
from typing import AsyncIterator, Deque, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.serving.paged_server import PagedSpecServer
from repro_torch.serving.scheduler import ServeRequest


class StreamEvent(NamedTuple):
    """One streamed token with its obs-layer join key."""
    token: int
    round: int     # RoundEvent.round id of the round that committed it
    t: float       # wall timestamp of the harvest (clock domain of ``now``)


_DONE = object()   # per-stream sentinel: request finished or was cancelled
_FAILED = object()  # per-stream sentinel: the stepper failed (``_error``)


class AsyncSpecServer:
    """Open-system asyncio wrapper: ``submit()`` returns a per-request async
    token stream; a background stepper advances the paged server while
    requests arrive, stream, and cancel concurrently.

        async with AsyncSpecServer(server) as front:
            stream = await front.submit(prompt, max_new=32, deadline_s=1.0)
            async for tok in stream:
                ...

    ``max_stream_queue`` bounds each per-request queue — the backpressure
    knob: when a consumer stops draining, the stepper blocks on that queue
    instead of buffering unboundedly (drop the iterator to release it).
    ``now`` is the injectable wall clock (deadlines are absolute in its
    domain); ``idle_poll_s`` is the idle re-check period when no work and no
    wake signal is pending.
    """

    def __init__(self, server: PagedSpecServer, *, max_stream_queue: int = 64,
                 idle_poll_s: float = 0.02, close_timeout_s: float = 5.0,
                 now=clock.wall):
        server.collect_streams = True
        self.server = server
        self.now = now
        self.max_stream_queue = int(max_stream_queue)
        self.idle_poll_s = float(idle_poll_s)
        self.close_timeout_s = float(close_timeout_s)
        # the worker thread's current CUDA device: the server's, its index
        # fixed here (a bare "cuda" means the building thread's device)
        dev = server.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._pending: Deque[Tuple[ServeRequest, float]] = deque()
        self._queues: dict = {}          # rid -> asyncio.Queue
        self._finished: set = set()
        self._next_rid = 0
        self._stop = False
        self._closed = False   # aclose ended the streams
        self._error: Optional[BaseException] = None   # the failed step's
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self.rounds_stepped = 0

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.create_task(self._stepper(), name="spec-stepper")
        return self

    async def aclose(self):
        """Stop the stepper. Live requests stop advancing; their streams end
        (sentinel). Does not tear down the wrapped server. Re-raises the
        exception a failed step ended the streams with."""
        self._stop = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=self.close_timeout_s)
            except asyncio.TimeoutError:
                self._task.cancel()
                await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        if self._error is not None:
            raise self._error
        self._closed = True
        for rid, q in list(self._queues.items()):
            if rid not in self._finished and not q.full():
                q.put_nowait(_DONE)

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.aclose()
        return False

    # ------------------------------------------------------------ submission
    async def submit(self, prompt, max_new: int,
                     deadline_s: Optional[float] = None,
                     rid: Optional[int] = None,
                     events: bool = False) -> AsyncIterator:
        """Submit one request; returns its async token stream.

        ``deadline_s`` (relative to now) becomes an absolute deadline driving
        the scheduler's EDF admission and the metrics' deadline-met flag.
        Yields ints, or ``StreamEvent``s when ``events=True``. Dropping the
        iterator cancels the request (row released, KV blocks freed).
        Raises ValueError immediately — and records the rejection — when the
        request's worst-case demand can never be admitted; raises the failed
        step's exception once a step has failed.
        """
        if self._task is None:
            raise RuntimeError("AsyncSpecServer not started — use "
                               "'async with' or await start()")
        if self._error is not None:
            raise self._error
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        t_submit = self.now()
        req = ServeRequest(rid, np.asarray(prompt, np.int32), int(max_new),
                           deadline=(t_submit + deadline_s
                                     if deadline_s is not None else None))
        self.server.sched.validate(req)   # reject-at-submit (recorded)
        q: asyncio.Queue = asyncio.Queue(maxsize=self.max_stream_queue)
        self._queues[rid] = q
        self._pending.append((req, t_submit))
        self._wake.set()
        return self._stream(rid, q, events)

    async def _stream(self, rid: int, q: asyncio.Queue, events: bool):
        try:
            while True:
                if q.empty():
                    # a queue that was full when the stepper failed or
                    # closed holds no sentinel: its end is the flag
                    if self._error is not None:
                        raise self._error
                    if self._closed:
                        break
                item = await q.get()
                if item is _DONE:
                    break
                if item is _FAILED:
                    raise self._error
                yield item if events else item.token
        finally:
            self._drop(rid)

    def _drop(self, rid: int):
        """Consumer released the iterator: cancel if still live, then unblock
        any stepper put stuck on the (now orphaned) queue."""
        q = self._queues.pop(rid, None)
        if rid not in self._finished:
            self.server.cancel(rid)
            if self._wake is not None:
                self._wake.set()
        if q is not None:
            while not q.empty():   # make room so a blocked put completes
                q.get_nowait()

    # -------------------------------------------------------------- stepper
    def _drain_and_step(self):
        """Worker-thread body: move pending submissions into the scheduler
        (arrival-time-stamped), then run one serving round. The only code
        that mutates scheduler/allocator/device state."""
        ctx = (torch.cuda.device(self._device) if self._device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            while self._pending:
                req, t_submit = self._pending.popleft()
                self.server.sched.submit(req, submitted=t_submit)
            info = self.server.step()
        if info is not None:
            info["t"] = self.now()
            if info["round"] is not None:   # notification-only steps (expiry,
                self.rounds_stepped += 1    # failure, stall) run no round
        return info

    async def _stepper(self):
        loop = asyncio.get_running_loop()
        while not self._stop:
            try:
                info = await loop.run_in_executor(None, self._drain_and_step)
            except Exception as e:
                self._fail(e)
                return
            if info is None:
                if self._pending or self.server._pending_cancels:
                    continue          # work arrived while stepping
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=self.idle_poll_s)
                except asyncio.TimeoutError:
                    pass
                continue
            await self._fanout(info)

    def _fail(self, error: BaseException):
        """A step raised: end every open stream with ``error``. A consumer
        blocked on its empty queue wakes on the sentinel; one whose queue
        is full reads its queued tokens, then finds the queue empty and
        the error set."""
        self._error = error
        for q in list(self._queues.values()):
            if not q.full():
                q.put_nowait(_FAILED)

    async def _fanout(self, info: dict):
        for rid, toks in info["streams"].items():
            q = self._queues.get(rid)
            if q is None:          # consumer dropped mid-round: discard
                continue
            for t in toks:
                # backpressure: a full stream queue pauses the stepper here
                await q.put(StreamEvent(int(t), info["round"], info["t"]))
        # expired and failed requests are just as terminal as finished ones:
        # their consumers must see the stream end, not hang (preempted rids
        # are NOT here — an evicted request resumes and keeps streaming)
        for rid in (list(info["finished"]) + list(info["cancelled"])
                    + list(info.get("expired", ()))
                    + list(info.get("failed", ()))):
            self._finished.add(rid)
            q = self._queues.get(rid)
            if q is not None:
                await q.put(_DONE)

    # -------------------------------------------------------------- queries
    @property
    def metrics(self):
        return self.server.metrics

    @property
    def events(self):
        return self.server.events

    def queue_depths(self):
        """Per-round scheduler queue depth over the run (from RoundEvents)."""
        return [ev.queue_depth for ev in self.server.events.events()]
