"""Execution backends behind the Session facade (port of
``repro/api/backends.py``).

The port's execution paths — the batch-synchronized ``SpecEngine``, the
per-row ``BatchedSpecEngine``, the paged ``PagedSpecServer`` and the plain
autoregressive fallback — sit behind one ``SpecBackend`` protocol here. A
backend executes a frozen ExecutionPlan; it makes NO speculation decisions
of its own beyond the plan's runtime-feedback hook (api/feedback.py).
Requests use ``serving.ServeRequest`` as the common currency.

The continuous backend (``ContinuousSpecServer``) and the paged backend's
async front end wait for the front end's port (ROADMAP.md, Queue 1 item
4); ``Session`` raises for a plan that selects the former.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.feedback import GammaController
from repro_torch.api.plan import ExecutionPlan
from repro_torch.core.batched_engine import (BatchedEngineConfig,
                                             BatchedSpecEngine)
from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                     autoregressive_generate)
from repro_torch.serving import PagedSpecServer, SchedulerConfig, ServeRequest


class SpecBackend(Protocol):
    """What Session needs from an execution path."""
    name: str

    def generate(self, prompt, max_new: Optional[int] = None, key=None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """[B, P] prompt -> ([B, <=P+max_new] tokens, stats)."""
        ...

    def generate_batch(self, prompts, max_new: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """[B, P] prompts -> (token buffer, [B] lengths, stats)."""
        ...

    def serve(self, requests: Sequence[ServeRequest]) -> List[ServeRequest]:
        """Drain a request list; returns them with .tokens filled."""
        ...


def _as_requests(prompts, max_new: int) -> List[ServeRequest]:
    return [ServeRequest(i, np.asarray(p, np.int32), max_new)
            for i, p in enumerate(np.asarray(prompts))]


def _stack_results(done: Sequence[ServeRequest], n: int):
    """Reassemble served requests (any completion order) into [n, T] + lens,
    on the host."""
    by_rid = {r.rid: r for r in done}
    lens = np.array([len(by_rid[i].tokens) for i in range(n)], np.int32)
    buf = np.zeros((n, int(lens.max())), np.int32)
    for i in range(n):
        buf[i, :lens[i]] = by_rid[i].tokens
    return torch.from_numpy(buf), torch.from_numpy(lens)


def _counts(state) -> Tuple[int, int, int]:
    """(length, n_accepted, n_drafted) of a batch_min state, in one copy to
    the host."""
    return tuple(int(x) for x in torch.stack(
        [state.length, state.n_accepted, state.n_drafted]).cpu())


# ============================================================== single-stream
class EngineBackend:
    """SpecEngine (either strategy) / AR fallback / adaptive-gamma loop.

    Serves plans with batching='single', and is the batch-synchronized
    path for the plans the per-row and paged backends cannot honor
    (``session._select_backend``). The engines run on the device of the
    params.
    """
    name = "engine"

    def __init__(self, target, drafter, params_t, params_d,
                 plan: ExecutionPlan, max_batch: int = 8, placement=None,
                 tracer=None):
        self.target, self.drafter = target, drafter
        self.params_t, self.params_d = params_t, params_d
        self.plan = plan
        self.max_batch = max_batch
        self.placement = placement
        self.tracer = tracer
        self.controller = GammaController(plan.gamma, plan.cost_coefficient)
        self._engines: Dict[int, SpecEngine] = {}

    def _engine(self, gamma: int) -> SpecEngine:
        if gamma not in self._engines:
            p = self.plan
            self._engines[gamma] = SpecEngine(
                self.target, self.drafter,
                EngineConfig(gamma=gamma, greedy=p.greedy,
                             temperature=p.temperature, use_cache=p.use_cache,
                             strategy=p.strategy,
                             draft_policy=p.draft_policy, draft_k=p.draft_k),
                placement=self.placement, tracer=self.tracer)
        return self._engines[gamma]

    # ----------------------------------------------------------------- paths
    def _generate_ar(self, prompt, max_new, key):
        toks = autoregressive_generate(
            self.target, self.params_t, prompt, max_new,
            greedy=self.plan.greedy, temperature=self.plan.temperature,
            key=key, use_cache=self.plan.use_cache)
        # count what actually came back, not the budget (one committed
        # token per AR round, so the two counters agree)
        n_new = int(toks.shape[1]) - int(prompt.shape[1])
        stats = {"rounds": n_new, "accepted": 0, "drafted": 0,
                 "alpha_hat": float("nan"), "tokens_generated": n_new,
                 "speculative": False}
        return toks, stats

    def _generate_adaptive(self, prompt, max_new, key):
        """The plan's runtime-feedback hook driving rounds: re-pick gamma
        each round from the alpha EMA (GammaController over one engine per
        candidate gamma). Every round runs on the state the largest
        candidate's engine prefilled, whose buffer and rings leave room for
        that candidate's round and so for every smaller one."""
        p = self.plan
        B, P = prompt.shape
        g_max = max(p.gamma.candidates)
        max_len = P + max_new + g_max + 2
        state = self._engine(g_max).prefill(self.params_t, self.params_d,
                                            prompt, max_len, key)
        target_len = P + max_new
        trace_start = len(self.controller.gamma_trace)
        length, accepted, drafted = P, 0, 0
        while length < target_len:
            g = self.controller.gamma()
            state = self._engine(g).round(self.params_t, self.params_d, state)
            length, n_acc, n_drafted = _counts(state)
            self.controller.observe(n_acc - accepted, n_drafted - drafted)
            accepted, drafted = n_acc, n_drafted
        stats = {
            "rounds": int(state.n_rounds),
            "accepted": accepted,
            "drafted": drafted,
            "alpha_hat": float(accepted) / max(float(drafted), 1.0),
            "tokens_generated": length - P,
            "gamma_trace": list(self.controller.gamma_trace[trace_start:]),
            "speculative": True,
        }
        return state.tokens[:, :length], stats

    # ------------------------------------------------------------- protocol
    def generate(self, prompt, max_new=None, key=None):
        p = self.plan
        max_new = p.max_new if max_new is None else max_new
        if p.gamma.adaptive and p.gamma.candidates:
            return self._generate_adaptive(prompt, max_new, key)
        g = self.controller.gamma()
        if g == 0:
            return self._generate_ar(prompt, max_new, key)
        toks, stats = self._engine(g).generate(self.params_t, self.params_d,
                                               prompt, max_new, key=key)
        self.controller.observe(stats["accepted"], stats["drafted"])
        stats["speculative"] = True
        return toks, stats

    def generate_batch(self, prompts, max_new=None):
        toks, stats = self.generate(prompts, max_new)
        lengths = torch.full((toks.shape[0],), toks.shape[1],
                             dtype=torch.int32, device=toks.device)
        return toks, lengths, stats

    def serve(self, requests):
        return _serve_grouped(self, requests, self.max_batch)


# =================================================================== per-row
class PerRowBackend:
    """BatchedSpecEngine: each row commits its own accepted prefix. Its
    stats carry the round's rebuilt ``accepted``/``drafted`` counts beside
    the engine's per-row rates (the reference feeds them only to its
    controller), so every backend's stats sum the same way."""
    name = "per_row"

    def __init__(self, target, drafter, params_t, params_d,
                 plan: ExecutionPlan, max_batch: int = 8, placement=None,
                 tracer=None):
        self.target, self.drafter = target, drafter
        self.params_t, self.params_d = params_t, params_d
        self.plan = plan
        self.max_batch = max_batch
        self.placement = placement
        self.tracer = tracer
        # gamma is consulted at batch boundaries, where the AR path is
        # reachable (g==0 branch below) — let the controller downgrade
        self.controller = GammaController(plan.gamma, plan.cost_coefficient,
                                          allow_ar=True)
        self._engines: Dict[int, BatchedSpecEngine] = {}

    def _engine(self, gamma: int) -> BatchedSpecEngine:
        if gamma not in self._engines:
            p = self.plan
            self._engines[gamma] = BatchedSpecEngine(
                self.target, self.drafter,
                BatchedEngineConfig(gamma=gamma, max_new_tokens=p.max_new,
                                    draft_policy=p.draft_policy,
                                    draft_k=p.draft_k),
                placement=self.placement, tracer=self.tracer)
        return self._engines[gamma]

    def generate_batch(self, prompts, max_new=None):
        p = self.plan
        max_new = p.max_new if max_new is None else max_new
        g = self.controller.gamma()
        if g == 0:
            toks = autoregressive_generate(self.target, self.params_t,
                                           prompts, max_new,
                                           use_cache=p.use_cache)
            lengths = torch.full((toks.shape[0],), toks.shape[1],
                                 dtype=torch.int32, device=toks.device)
            return toks, lengths, {"rounds": max_new, "accepted": 0,
                                   "drafted": 0, "speculative": False}
        tokens, lengths, stats = self._engine(g).generate(
            self.params_t, self.params_d, prompts, max_new)
        B = prompts.shape[0]
        # the engine reports per-row rates; rebuild the round's counts
        # from them exactly as the reference does
        drafted = int(stats["rounds"]) * g * B
        accepted = int(round(float(torch.sum(stats["alpha_hat_per_row"]))
                             * int(stats["rounds"]) * g))
        self.controller.observe(accepted, drafted)
        stats = dict(stats, accepted=accepted, drafted=drafted)
        stats["speculative"] = True
        stats["alpha_hat"] = accepted / max(drafted, 1)
        return tokens, lengths, stats

    def generate(self, prompt, max_new=None, key=None):
        toks, lengths, stats = self.generate_batch(prompt, max_new)
        return toks[:, :int(lengths.min())], stats

    def serve(self, requests):
        return _serve_grouped(self, requests, self.max_batch)


# ============================================================ paged serving
class PagedBackend:
    """PagedSpecServer: ragged continuous batching over a shared block pool.
    The plan's block geometry becomes the SchedulerConfig; an adaptive
    GammaSchedule hands the gamma/AR decision to the scheduler's online
    cost-model loop (same Eq. 1, telemetry alpha)."""
    name = "paged"

    def __init__(self, target, drafter, params_t, params_d,
                 plan: ExecutionPlan, max_batch: int = 4, placement=None,
                 tracer=None, faults=None, device=None):
        self.plan = plan
        self.placement = placement
        cache = plan.cache
        scfg = SchedulerConfig(
            max_batch=max_batch, block_size=cache.block_size,
            num_blocks=cache.num_blocks,
            max_blocks_per_row=cache.max_blocks_per_row,
            gamma_max=plan.gamma_max,
            prefill_buckets=cache.prefill_buckets,
            alpha_prior=plan.gamma.alpha_init,
            cost_coefficient=plan.cost_coefficient,
            overcommit=cache.overcommit,
            prefill_chunk=cache.prefill_chunk,
            prefix_cache=cache.prefix_cache)
        gamma_override = None if plan.gamma.adaptive else plan.gamma.gamma
        self.server = PagedSpecServer(target, drafter, params_t, params_d,
                                      scfg, gamma=gamma_override,
                                      placement=placement, tracer=tracer,
                                      faults=faults, device=device)

    @property
    def metrics(self):
        return self.server.metrics

    @property
    def events(self):
        return self.server.events

    @property
    def drift(self):
        return self.server.drift

    def serve_async(self, **kw):
        """The async streaming front end is not ported yet."""
        raise NotImplementedError(
            "serve_async needs the async front end (serving/frontend), which "
            "the port has not ported yet (ROADMAP.md, Queue 1 item 4); use "
            "serve()")

    def serve(self, requests):
        for r in requests:
            self.server.submit(r)
        done_before = len(self.server.done)
        self.server.run()
        return self.server.done[done_before:]

    def generate_batch(self, prompts, max_new=None):
        max_new = self.plan.max_new if max_new is None else max_new
        reqs = _as_requests(prompts, max_new)
        done = self.serve(reqs)
        toks, lens = _stack_results(done, len(reqs))
        return toks, lens, {"speculative": self.plan.speculative,
                            "gamma": self.server.gamma}

    def generate(self, prompt, max_new=None, key=None):
        toks, lens, stats = self.generate_batch(prompt, max_new)
        return toks[:, :int(lens.min())], stats


# ------------------------------------------------------------------- helpers
def _group_uniform(requests) -> Dict[Tuple[int, int], List[ServeRequest]]:
    """Group requests by (prompt_len, max_new): one batch shape each."""
    groups: Dict[Tuple[int, int], List[ServeRequest]] = {}
    for r in requests:
        groups.setdefault((r.prompt_len, r.max_new), []).append(r)
    return groups


def _serve_grouped(backend, requests, max_batch: int) -> List[ServeRequest]:
    """Batch-at-a-time serving loop over uniform-shape groups, on any
    generate_batch backend."""
    out: List[ServeRequest] = []
    for (P, max_new), group in _group_uniform(requests).items():
        for i in range(0, len(group), max_batch):
            chunk = group[i:i + max_batch]
            prompts = np.stack([np.asarray(r.prompt, np.int32) for r in chunk])
            toks, lengths, _ = backend.generate_batch(prompts, max_new)
            toks, lengths = toks.cpu().numpy(), lengths.cpu().numpy()
            for j, r in enumerate(chunk):
                # the last round may commit past the budget — trim to it
                r.tokens = toks[j, :min(int(lengths[j]), P + max_new)]
                out.append(r)
    return out


def _serve_ar(backend, group) -> List[ServeRequest]:
    """AR-serve a uniform group on the target only (gamma*=0 plans); the
    continuous backend's AR branch, kept for its port (ROADMAP.md, Queue 1
    item 4)."""
    prompts = np.stack([np.asarray(r.prompt, np.int32) for r in group])
    toks = autoregressive_generate(backend.target, backend.params_t, prompts,
                                   group[0].max_new,
                                   use_cache=backend.plan.use_cache)
    toks = toks.cpu().numpy()
    for j, r in enumerate(group):
        r.tokens = toks[j]
    return list(group)
