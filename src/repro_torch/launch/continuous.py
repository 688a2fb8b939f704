"""Continuous-batching speculative server (port of
``repro/launch/continuous.py``).

Per-row speculation (core/batched_engine.py) lets rows advance
independently, but a fixed batch still waits for its slowest member. This
server closes the loop: when a row finishes, its slot is REFILLED from the
request queue at once — a one-row prefill whose ring KV is copied into the
live batch caches — so the batch stays full and the per-row round's
committed tokens per round become wall-clock throughput.

Constraints: KV-cache families (the port's dense and moe families); uniform
(prompt_len, max_new) per server instance; greedy acceptance. The paged
server (``repro_torch.serving.PagedSpecServer``) lifts the uniform-shape
constraint; this one stays the minimal fixed-shape path, and the
``Session`` facade's continuous backend.

The rings are read through the paged kernel over an identity view
(``models.dense``), which holds while index + Q <= W for every row a round
forwards, W being ``max_len = P + max_new + gamma + 2`` rounded up to the
16-slot page. A live row at length L < P + max_new is forwarded at index
L - 1 with Q = gamma + 1, so index + Q <= P + max_new + gamma - 1. A
refilled slot keeps its old occupant's KV past index P - 1; the causal
mask hides it until the new request's own writes replace it. A row that
finishes with the queue empty is FROZEN: inactive, so it commits nothing,
but a round still forwards it. JAX leaves it at its final length, up to
P + max_new + gamma, where a verify pass would write past W; the port
rewinds a frozen row to length P (index P - 1), so its idle passes stay
inside the ring. Its tokens were harvested when it finished, and nothing
it computes afterwards is read, so nothing observable changes. A windowed
config's rings hold window + gamma + 2 slots (rounded up to the page) and
wrap; they are read through a table over positions (``models.dense``),
and copied into a slot with their ``positions`` entry checked equal.

Two more differences from JAX: ``_insert_row`` names the ring leaves
(``k``, ``v``, ``index``), copies slot b in place and raises on any leaf
it does not know or whose shape differs (JAX's tree map leaves such a
leaf untouched, which here would let the new request read its
predecessor's KV); and with fewer requests than rows, the pad rows
(rid -1, copies of the last prompt) stay active as in JAX and count in
the acceptance totals, but once one outlives its twin by more than the
ring holds, its passes read a clamped view where JAX's ring wraps, so its
acceptance from then on is not JAX's (the tokens of real requests are
unaffected).

``python -m repro_torch.launch.continuous --arch <id> --smoke --device cpu``
drives it through the ``repro_torch.api.Session`` facade on a uniform
synthetic stream; on the card drop ``--device cpu``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.cache.ops import RING
from repro_torch.core import rounds
from repro_torch.core.batched_engine import (BatchedEngineConfig,
                                             BatchedSpecEngine, RowState)
from repro_torch.obs import clock
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.parallel import tp
from repro_torch.parallel.shards import parts
from repro_torch.serving.paged_server import _set_index, _set_rows

RING_LEAVES = ("k", "v", "index")
WINDOWED_RING_LEAVES = RING_LEAVES + ("positions",)   # + the table's reach


@dataclass
class StreamRequest:
    rid: int
    prompt: np.ndarray
    tokens: Optional[np.ndarray] = None
    rounds_in_flight: int = 0


class ContinuousSpecServer:
    def __init__(self, target, drafter, params_t, params_d, *,
                 batch: int = 4, prompt_len: int = 12, max_new: int = 24,
                 gamma: int = 4, engine: Optional[BatchedSpecEngine] = None,
                 placement=None, tracer=None):
        """``engine`` lets callers share one engine across server instances;
        it must have been built with the same gamma (and placement).
        ``placement`` (api/placement.py) runs the rounds placed: each
        role's params, ring and one-row refill prefill on its own device.
        The server runs on the device of ``params_t`` otherwise."""
        assert engine is None or engine.ecfg.gamma == gamma
        if engine is not None and placement is not None \
                and placement.heterogeneous:
            ep = engine.placement
            if ep is None or (ep.drafter.devices, ep.target.devices) != \
                    (placement.drafter.devices, placement.target.devices):
                raise ValueError(
                    "shared engine was built without this placement — build "
                    "it with BatchedSpecEngine(..., placement=...) or drop one")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.engine = engine or BatchedSpecEngine(
            target, drafter, BatchedEngineConfig(gamma=gamma),
            placement=placement, tracer=self.tracer)
        self.placement = self.engine.placement
        pm = self.placement
        if pm is not None:
            params_t = pm.target.put_params(target, params_t)
            params_d = pm.drafter.put_params(drafter, params_d)
        self.params_t, self.params_d = params_t, params_d
        self.dev_t = params_t["embed"]["table"].device
        self.dev_d = params_d["embed"]["table"].device
        self.B, self.P, self.max_new, self.gamma = batch, prompt_len, max_new, gamma
        self.max_len = prompt_len + max_new + gamma + 2
        self.queue: Deque[StreamRequest] = deque()
        self.done: List[StreamRequest] = []
        self._slots: List[Optional[StreamRequest]] = [None] * batch
        self._state: Optional[RowState] = None
        self.total_rounds = 0
        self.n_prefills = 0           # prefill programs run (bootstrap: 1)
        self.n_accepted_total = 0     # accepted draft tokens across rounds
        self.n_drafted_total = 0      # drafted tokens across rounds

    # ------------------------------------------------------------ plumbing
    def _prefill_ring(self, model, params, prompts, device):
        """A ring of ``len(prompts)`` rows on ``device``, prefilled with
        each prompt but its last token (the first round's input); its index
        a [B] vector at P - 1."""
        B = prompts.shape[0]
        cache = RING.init(model, B, max_len=self.max_len,
                          spec_slack=self.gamma + 2, device=device,
                          layout=tp.layout_of(params))
        if self.P > 1:
            toks = torch.from_numpy(np.ascontiguousarray(prompts[:, :-1])).to(device)
            _, cache, _ = model.apply(params, toks, cache, logits_slice="last")
        return {**cache, "index": torch.full((B,), self.P - 1,
                                             dtype=torch.int32, device=device)}

    def _buffer(self, prompts):
        buf = torch.zeros((prompts.shape[0], self.max_len), dtype=torch.int32,
                          device=self.dev_t)
        buf[:, :self.P] = torch.from_numpy(prompts).to(self.dev_t)
        return buf

    def _prefill_one(self, prompt):
        """B=1 prefill -> (buf_row [1, T], dcache1, tcache1), each role's on
        its own device."""
        prompts = np.asarray(prompt, np.int32)[None]
        with self.tracer.span("prefill", phase="prefill", role="target"):
            buf = self._buffer(prompts)
            tc = self._prefill_ring(self.engine.target, self.params_t,
                                    prompts, self.dev_t)
            dc = self._prefill_ring(self.engine.drafter, self.params_d,
                                    prompts, self.dev_d)
            if self.tracer.enabled:
                devices.synchronize(self.dev_t)
                devices.synchronize(self.dev_d)
        self.n_prefills += 1
        return buf, dc, tc

    @staticmethod
    def _put_ring(batched, one, b: int):
        """Row 0 of the one-row ring ``one`` into row ``b`` of ``batched``:
        k and v copied in place, the index vector copied and set. Raises on
        a leaf that is not a ring's or whose shape does not match, and on
        two windowed rings whose tables reach different positions."""
        if not (set(batched) == set(one)
                and set(one) in (set(RING_LEAVES), set(WINDOWED_RING_LEAVES))):
            raise ValueError(f"ring caches hold exactly {RING_LEAVES} (and "
                             f"'positions' when windowed), got "
                             f"{sorted(batched)} and {sorted(one)}")
        if batched.get("positions") != one.get("positions"):
            raise ValueError(f"windowed rings reaching {batched['positions']} "
                             f"and {one['positions']} positions")
        for name in ("k", "v"):
            bigs, rows = parts(batched[name]), parts(one[name])
            if len(bigs) != len(rows):
                raise ValueError(f"ring leaf {name!r}: a row of {len(rows)} "
                                 f"shards for a batch of {len(bigs)}")
            for big, row in zip(bigs, rows):     # every piece of a sharded ring
                if (row.dim() != big.dim() or row.shape[1] != 1
                        or row.shape[:1] + row.shape[2:]
                        != big.shape[:1] + big.shape[2:]):
                    raise ValueError(f"ring leaf {name!r}: row of shape "
                                     f"{tuple(row.shape)} does not fit the "
                                     f"batch's {tuple(big.shape)}")
                big[:, b].copy_(row[:, 0])
        index = batched["index"].clone()
        index[b] = one["index"][0]
        return {**batched, "index": index}

    def _insert_row(self, state: RowState, b: int, buf1, dc1, tc1):
        """Copy a one-row prefill into the live batch state at slot b."""
        if self.placement is not None:
            buf1 = self.placement.to_target(buf1)
            tc1 = self.placement.to_target(tc1)
            dc1 = self.placement.to_drafter(dc1)
        state = state._replace(tcache=self._put_ring(state.tcache, tc1, b),
                               dcache=self._put_ring(state.dcache, dc1, b))
        return _set_rows(state, b, tokens=buf1[0], length=self.P, active=True)

    def _freeze(self, state: RowState, b: int) -> RowState:
        """Slot b finished with nothing queued: inactive, and rewound to
        length P (index P - 1), so the passes rounds still run on it stay
        inside its ring (module docstring)."""
        return _set_index(_set_rows(state, b, active=False, length=self.P),
                          b, self.P - 1)

    # -------------------------------------------------------------- serving
    def submit(self, req: StreamRequest):
        assert len(req.prompt) == self.P
        self.queue.append(req)

    def _bootstrap(self):
        first = [self.queue.popleft() for _ in range(min(self.B, len(self.queue)))]
        while len(first) < self.B:          # pad with copies of the last
            first.append(StreamRequest(-1, first[-1].prompt))
        prompts = np.stack([np.asarray(r.prompt, np.int32) for r in first])
        B, dev = self.B, self.dev_t
        with self.tracer.span("prefill", phase="prefill", role="target"):
            tc = self._prefill_ring(self.engine.target, self.params_t,
                                    prompts, self.dev_t)
            dc = self._prefill_ring(self.engine.drafter, self.params_d,
                                    prompts, self.dev_d)
        self.n_prefills += 1
        st = RowState(tokens=self._buffer(prompts),
                      length=torch.full((B,), self.P, dtype=torch.int32,
                                        device=dev),
                      dcache=dc, tcache=tc,
                      active=torch.ones((B,), dtype=torch.bool, device=dev),
                      n_rounds=torch.zeros((), dtype=torch.int32, device=dev),
                      n_accepted=torch.zeros((B,), dtype=torch.int32, device=dev),
                      n_drafted=torch.zeros((), dtype=torch.int32, device=dev))
        if self.placement is not None:
            st = rounds.place_state(st, self.placement, self.engine.target,
                                    self.engine.drafter)
        self._state = st
        self._slots = first

    def _snapshot(self):
        """(lengths, active) on the host, in one pull."""
        snap = torch.stack([self._state.length,
                            self._state.active.to(torch.int32)]).cpu().numpy()
        return snap[0].astype(np.int64), snap[1].astype(bool)

    def run(self):
        """Drain the queue; returns completed requests. Rounds touch the
        WHOLE batch; finished rows are emitted and refilled without a
        barrier."""
        if self._state is None:
            if not self.queue:
                return self.done
            self._bootstrap()
        eng = self.engine
        round_fn = eng.placed_round or eng.traced_round or eng.round
        traced = eng.placed_round is None and eng.traced_round is not None
        target_len = self.P + self.max_new
        n_rounds = 0
        prev_len, prev_active = self._snapshot()
        while any(r is not None and r.rid >= 0 for r in self._slots):
            if traced:
                rids = tuple(r.rid for r in self._slots
                             if r is not None and r.rid >= 0)
                self._state = round_fn(self.params_t, self.params_d,
                                       self._state, round=n_rounds, rids=rids)
            else:
                self._state = round_fn(self.params_t, self.params_d,
                                       self._state)
            n_rounds += 1
            lengths, active = self._snapshot()
            # acceptance telemetry: each active row emits n_accepted+1 tokens
            emitted = (lengths - prev_len)[prev_active]
            self.n_accepted_total += int(np.maximum(emitted - 1, 0).sum())
            self.n_drafted_total += int(prev_active.sum()) * self.gamma
            for b in range(self.B):
                req = self._slots[b]
                if req is None or req.rid < 0:
                    continue
                req.rounds_in_flight += 1
                if lengths[b] >= target_len:
                    req.tokens = self._state.tokens[b, :target_len].cpu().numpy()
                    self.done.append(req)
                    if self.queue:
                        nxt = self.queue.popleft()
                        buf1, dc1, tc1 = self._prefill_one(nxt.prompt)
                        self._state = self._insert_row(self._state, b, buf1,
                                                       dc1, tc1)
                        self._slots[b] = nxt
                        active[b] = True
                    else:
                        # freeze the slot: no more commits, no ring overflow
                        self._state = self._freeze(self._state, b)
                        self._slots[b] = StreamRequest(-1, req.prompt)
                        active[b] = False
                    lengths[b] = self.P
            # the host mirrors of the state the next round starts from
            prev_len, prev_active = lengths, active
        self.total_rounds = n_rounds
        return self.done


def main(argv=None):
    import argparse

    from repro_torch.api import DeploymentSpec, Planner, Session
    from repro_torch.launch import cli_args

    ap = argparse.ArgumentParser()
    cli_args.add_model_args(ap)
    cli_args.add_traffic_args(ap)
    cli_args.add_spec_args(ap)
    cli_args.add_trace_args(ap)
    ap.add_argument("--batch", type=int, default=4,
                    help="live slots in the continuous batch")
    args = ap.parse_args(argv)

    mt, md, pt, pd, cfg_t = cli_args.build_pair(args.arch, args.smoke,
                                                args.device)
    spec = DeploymentSpec(batch_size=args.batch,
                          prompt_lens=(args.prompt_len,),
                          max_new=args.max_new, streaming=True,
                          alpha=args.alpha,
                          cost_coefficient=args.cost_coefficient,
                          adaptive_gamma=False)
    plan = Planner(spec).plan()
    if args.gamma is not None:          # --gamma trumps the planner
        import dataclasses as _dc
        plan = _dc.replace(plan,
                           gamma=_dc.replace(plan.gamma, gamma=args.gamma))
    gamma = plan.gamma.gamma
    plan = cli_args.apply_placement_arg(plan, args.placement)
    sess = Session(mt, md, pt, pd, plan, max_batch=args.batch,
                   tracer=cli_args.make_tracer(args), device=args.device)
    if args.placement:
        print(sess.placement.describe())

    rng = np.random.default_rng(0)
    reqs = [sess.request(rng.integers(0, cfg_t.vocab_size, args.prompt_len),
                         args.max_new, rid=i) for i in range(args.requests)]
    t0 = clock.wall()
    done = sess.serve(reqs)
    dt = clock.wall() - t0
    total = sum(len(r.tokens) - r.prompt_len for r in done)
    print(f"continuous-served {len(done)} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s aggregate, gamma={gamma}"
          f"{' [forced]' if args.gamma is not None else ' [cost-model]'}, "
          f"B={args.batch}, backend={sess.backend_name})")
    cli_args.report_telemetry(sess, args)
    return sess, done


if __name__ == "__main__":
    main()
