"""Request scheduler for paged variable-length continuous speculative
batching (port of ``repro/serving/scheduler.py`` on its default path).

  * ADMISSION CONTROL — earliest-deadline-first (requests without a
    deadline sort last, FCFS among themselves), head-blocking on the EDF
    head; a head whose deadline has already passed is expired. Requests
    whose worst-case demand can never fit are rejected at submit.
  * WORST-CASE RESERVATION — admission reserves ``prompt_len + max_new +
    gamma_max + 1`` tokens (prompt + decode + in-flight speculation), so
    nothing is ever preempted mid-flight. Overcommit with preemption waits
    for a later slice.
  * LENGTH BUCKETING — prompts are padded up to a small set of bucket
    lengths; padding is exact (the cache index is rolled back to
    ``prompt_len - 1`` afterwards, masking the padded tail).
  * GAMMA / AR DECISION — the paper's Eq. (1) (``core/cost_model.py``) at
    the measured acceptance rate (metrics EMA, else a prior) and the
    configured cost coefficient; gamma* = 0 falls back to AR decoding.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

import numpy as np

from repro_torch.cache.paged_kv import BlockAllocator
from repro_torch.core import cost_model
from repro_torch.serving.metrics import ServingMetrics


@dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 4
    block_size: int = 8
    num_blocks: int = 128              # pool size (block 0 is reserved/null)
    max_blocks_per_row: int = 16
    gamma_max: int = 8
    prefill_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    alpha_prior: float = 0.8           # acceptance prior before telemetry
    cost_coefficient: float = 0.25     # c = t_draft / t_target

    @property
    def max_tokens_per_row(self) -> int:
        return self.max_blocks_per_row * self.block_size


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                 # [P] int32, any length
    max_new: int
    tokens: Optional[np.ndarray] = None  # filled on completion
    deadline: Optional[float] = None   # absolute SLO deadline (clock domain);
                                       # None = best-effort (sorts last)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, allocator: BlockAllocator,
                 metrics: Optional[ServingMetrics] = None):
        self.cfg = cfg
        self.alloc = allocator
        self.metrics = metrics or ServingMetrics(gamma_max=cfg.gamma_max)
        self.queue: Deque[ServeRequest] = deque()
        self._expired_pending: list = []

    # ------------------------------------------------------------ admission
    def validate(self, req: ServeRequest):
        """Reject requests whose worst-case demand can NEVER be admitted,
        with the rejection recorded in metrics. Raises ValueError."""
        try:
            demand = self.demand_tokens(req)
            if demand > self.cfg.max_tokens_per_row:
                raise ValueError(
                    f"request {req.rid}: {demand} tokens exceeds per-row "
                    f"capacity {self.cfg.max_tokens_per_row} "
                    f"({self.cfg.max_blocks_per_row} blocks x "
                    f"{self.cfg.block_size})")
            pool_tokens = (self.cfg.num_blocks - 1) * self.cfg.block_size
            if demand > pool_tokens:
                raise ValueError(
                    f"request {req.rid}: {demand} tokens exceeds the "
                    f"allocatable pool {pool_tokens} "
                    f"({self.cfg.num_blocks - 1} blocks x "
                    f"{self.cfg.block_size}; block 0 is reserved)")
            self.bucket(req.prompt_len)  # over-bucket prompts fail here
        except ValueError as e:
            self.metrics.reject(req.rid, str(e))
            raise

    def submit(self, req: ServeRequest):
        self.validate(req)
        self.metrics.submit(req.rid, req.prompt_len, req.max_new,
                            deadline=req.deadline)
        self.queue.append(req)

    def demand_tokens(self, req: ServeRequest) -> int:
        """Worst-case resident tokens: prompt + decode budget + speculative
        slack (a round writes up to gamma+1 unverified tokens past the
        committed index)."""
        return req.prompt_len + req.max_new + self.cfg.gamma_max + 1

    def has_work(self) -> bool:
        return bool(self.queue)

    def _edf_head(self) -> int:
        """Index of the earliest-deadline queued request (None deadlines
        sort last; queue position breaks ties)."""
        best, best_key = 0, None
        for i, r in enumerate(self.queue):
            key = (r.deadline if r.deadline is not None else float("inf"), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def try_admit(self, row: int) -> Optional[ServeRequest]:
        """Admit the EDF head into ``row`` if its reservation fits (EDF heads
        past their deadline are expired instead). Reserves blocks."""
        now = self.metrics.now()
        while self.queue:
            i = self._edf_head()
            req = self.queue[i]
            if req.deadline is not None and req.deadline < now:
                del self.queue[i]
                self.metrics.expire(req.rid)
                self._expired_pending.append(req.rid)
                continue
            if not self.alloc.ensure(row, self.demand_tokens(req)):
                return None
            del self.queue[i]
            self.metrics.start(req.rid)
            return req
        return None

    def drain_expired(self) -> list:
        out, self._expired_pending = self._expired_pending, []
        return out

    def release(self, row: int, req: ServeRequest):
        """Return a finished request's blocks to the pool."""
        self.alloc.free_row(row)
        n_gen = (len(req.tokens) - req.prompt_len
                 if req.tokens is not None else None)
        self.metrics.complete(req.rid, n_gen)

    # ------------------------------------------------------------ bucketing
    def bucket(self, prompt_len: int) -> int:
        for b in self.cfg.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt_len {prompt_len} exceeds largest prefill "
                         f"bucket {self.cfg.prefill_buckets[-1]}")

    def pad_to_bucket(self, prompt: np.ndarray) -> np.ndarray:
        P = len(prompt)
        out = np.zeros(self.bucket(P), np.int32)
        out[:P] = prompt
        return out

    # ------------------------------------------------------- gamma decision
    def choose_gamma(self, alpha: Optional[float] = None,
                     c: Optional[float] = None) -> Tuple[int, float]:
        """Cost-model gamma for the next round: (gamma*, predicted speedup).
        gamma* == 0 means 'speculation does not pay — run AR'."""
        if alpha is None:
            alpha = self.metrics.alpha_hat()
        if alpha is None:
            alpha = self.cfg.alpha_prior
        if c is None:
            c = self.cfg.cost_coefficient
        return cost_model.optimal_gamma(alpha, c, self.cfg.gamma_max)
