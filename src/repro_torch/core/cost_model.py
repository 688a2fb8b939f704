"""The paper's analytical cost model (Eq. 1, from Leviathan et al. [3]);
the port's own copy of the part of ``repro/core/cost_model.py`` that the
scheduler's gamma/AR decision calls.

    S(α, γ, c) = (1 − α^(γ+1)) / ((1 − α)(γ·c + 1))

α — expected acceptance rate, γ — draft length, c — cost coefficient
t_draft / t_target. Used prescriptively: speculation pays only if c < α, and
γ* maximises S. The other terms of the JAX module (expected tokens per
round, multi-draft, tree, overlap, roofline) wait for the slices that port
their callers.
"""
from __future__ import annotations

from typing import Tuple

GAMMA_MAX_DEFAULT = 16


def speedup(alpha: float, gamma: int, c: float) -> float:
    """Eq. (1). gamma=0 degenerates to 1.0 (no speculation)."""
    alpha = float(alpha)
    gamma = int(gamma)
    if gamma == 0:
        return 1.0
    if alpha >= 1.0:
        return (gamma + 1.0) / (gamma * c + 1.0)
    num = 1.0 - alpha ** (gamma + 1)
    den = (1.0 - alpha) * (gamma * c + 1.0)
    return num / den


def optimal_gamma(alpha: float, c: float,
                  gamma_max: int = GAMMA_MAX_DEFAULT) -> Tuple[int, float]:
    """γ* maximizing Eq. (1) over 0..gamma_max; returns (γ*, S(γ*)).
    γ=0 (no speculation, S=1) is always a candidate."""
    best = (0, 1.0)
    for g in range(1, gamma_max + 1):
        s = speedup(alpha, g, c)
        if s > best[1] + 1e-12:
            best = (g, s)
    return best
