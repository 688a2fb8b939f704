"""Token samplers: greedy / temperature / top-k / top-p (port of
``repro/sampling/sampler.py``), vectorized over any leading axes. The
speculative engines use greedy or plain temperature sampling; these are
the serving-layer alternatives exposed through ``SamplerConfig``. Draws
take a key (``sampling.keys``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.sampling.keys import categorical


@dataclass(frozen=True)
class SamplerConfig:
    greedy: bool = True
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None


def sample(key, logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """logits: [..., V] -> int32 tokens [...]."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / max(cfg.temperature, 1e-6)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if cfg.top_k is not None:
        kth = torch.sort(logits, dim=-1).values[..., -cfg.top_k][..., None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if cfg.top_p is not None:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p; keep at least 1
        # (clamped into the row: past it JAX gathers a NaN, which keeps
        # every entry, as the smallest entry does)
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True)
        cutoff_idx = torch.clamp_max(cutoff_idx, logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return categorical(key, logits)
