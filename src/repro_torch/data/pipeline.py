"""Synthetic-but-learnable data pipeline (the port's own copy of
``repro/data/pipeline.py``, which is numpy only; the port imports nothing of
the JAX package).

A fixed-seed order-2 (or order-1) Markov source over the model vocabulary:
structured enough that bigger models fit it better than smaller ones, which
is the draft/target alignment regime speculative sampling relies on. The
acceptance-rate experiments train a target and a drafter on the same
stream and measure how well the drafter anticipates the target.

Deterministic and zero I/O. Batches are numpy, the same bits as JAX's for
the same config; callers move them to their device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 12      # out-degree of the Markov graph (task difficulty)
    # context order. order=2 hashes (t-2, t-1) — from the model's seat that
    # is ~V^2 arbitrary contexts to memorize; order=1 keys on t-1 alone (V
    # contexts), learnable in a few hundred steps (the trained-pair recipe)
    order: int = 2


class MarkovSource:
    """Order-1/2 Markov chain with sparse random transitions."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, cfg.branching
        # successor table: for each (prev2 hash) a set of candidates + probs
        self.n_states = V if cfg.order == 1 else min(V * 4, 65536)
        self.succ = rng.integers(0, V, size=(self.n_states, B), dtype=np.int64)
        p = rng.dirichlet(np.ones(B) * 0.5, size=self.n_states)
        self.cum = np.cumsum(p, axis=1)

    def _state(self, t1, t2):
        if self.cfg.order == 1:
            return t2 % self.n_states
        return (t1 * 31 + t2 * 7) % self.n_states

    def sample(self, rng, batch: int, length: int) -> np.ndarray:
        V = self.cfg.vocab_size
        toks = np.empty((batch, length), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=batch)
        toks[:, 1] = rng.integers(0, V, size=batch)
        u = rng.random(size=(batch, length))
        for t in range(2, length):
            st = self._state(toks[:, t - 2], toks[:, t - 1])
            idx = (u[:, t, None] > self.cum[st]).sum(axis=1)
            toks[:, t] = self.succ[st, idx]
        return toks


def batches(cfg: DataConfig) -> Iterator[dict]:
    """Infinite stream of {"tokens": [B, S+1]} — callers split input/labels."""
    src = MarkovSource(cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    while True:
        toks = src.sample(rng, cfg.global_batch, cfg.seq_len + 1)
        yield {"tokens": toks}


def split_batch(batch) -> Tuple[np.ndarray, np.ndarray]:
    toks = batch["tokens"]
    return toks[:, :-1], toks[:, 1:]
