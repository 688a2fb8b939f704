"""The paper's analytical cost model (Eq. 1, from Leviathan et al. [3]);
the port's own copy of ``repro/core/cost_model.py``.

    S(α, γ, c) = (1 − α^(γ+1)) / ((1 − α)(γ·c + 1))

α — expected acceptance rate (drafter/target distribution alignment),
γ — draft length (tokens speculated per round),
c — cost coefficient t_draft / t_target (hardware+mapping dependent).

The model is used *prescriptively*, exactly as in the paper:
  (i)  decide whether speculative sampling helps at all (requires c < α), and
  (ii) pick the speedup-optimal γ* for a given (α, c),
and it is the objective function of the heterogeneous-mapping DSE
(``core/partition.py``) and of the planner (``api/planner.py``). Pure
Python floats: the arithmetic is the JAX module's, in the same order, so
every function returns JAX's value bit for bit on the same inputs.

The hardware the roofline prices is the port's: an NVIDIA H100 SXM
(``H100``, ``DEFAULT_HW``), from NVIDIA's datasheet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

import numpy as np

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


def expected_accepted(alpha: float, gamma: int) -> float:
    """E[# tokens produced per verification round] = (1 − α^(γ+1)) / (1 − α):
    the accepted draft prefix plus the bonus/resampled token (the
    numerator of Eq. (1))."""
    if alpha >= 1.0:
        return gamma + 1.0
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)


def multi_draft_gain(alpha: float, alpha_topk: float, gamma: int) -> float:
    """Expected emitted-tokens multiplier of k-candidate drafting over linear
    drafting at equal gamma (``rounds.MultiDraftPolicy``).

    The k candidates differ only in their FIRST token (drafter top-k
    alternates, greedy continuations), so the alternates recover exactly the
    rounds where the drafter's argmax misses but its top-k covers: with
    probability (alpha_topk − alpha) a recovered chain emits like a linear
    chain whose head was accepted. k enters ONLY through alpha_topk, which
    must be P[target argmax ∈ drafter top-k] measured at the SAME k the
    policy will run.
    """
    e1 = expected_accepted(alpha, gamma)
    lift = max(float(alpha_topk) - float(alpha), 0.0)
    ek = e1 + lift * expected_accepted(alpha, max(gamma - 1, 0))
    return ek / e1


def multi_draft_speedup(alpha: float, alpha_topk: float, gamma: int,
                        c: float, k: int,
                        stack_cost: float = 0.35) -> float:
    """Round-speedup of MultiDraftPolicy(k) over linear at equal (γ, c).

    In the recompute (no-cache) mode where multi-draft runs, a linear round
    is γ drafter passes + 1 target verify = γ·c + 1; the multi round's
    FIRST draft step runs unstacked (the chains branch on its top-k), then
    γ−1 draft steps and the verify stack the k candidates on the batch axis
    at ``m = 1 + (k−1)·stack_cost`` relative cost each (``stack_cost`` < 1
    is the discount of widening a batch instead of running a second pass).
    Speedup = emitted gain / relative round cost."""
    gain = multi_draft_gain(alpha, alpha_topk, gamma)
    m = 1.0 + (k - 1) * float(stack_cost)
    cost_lin = gamma * c + 1.0
    cost_multi = c * (1.0 + (gamma - 1) * m) + m
    return gain * cost_lin / cost_multi


MAX_TREE_SPAN = 31   # core.tree: 1 + width*depth <= 31 (int32 ancestor masks)


def tree_gain(alpha: float, alpha_topk: float, width: int,
              depth: int) -> float:
    """Expected emitted-tokens multiplier of a (width × depth) chain tree
    over linear drafting at gamma = depth (``rounds.TreeDraftPolicy``).

    The tree branches once at the root: width head alternates, each continued
    as a linear chain. A round emits the bonus/correction token always, plus
    — iff SOME head is accepted, probability ``head_alpha`` — that chain's
    linear continuation:

        E_tree = 1 + head_alpha · E(alpha, depth − 1)

    ``head_alpha`` is alpha_topk for width ≥ 2 and plain alpha for width =
    1, where E(α, d) = 1 + α·E(α, d−1) makes the tree reduce exactly to
    linear. Gain = E_tree / E(alpha, depth)."""
    head = float(alpha_topk) if width >= 2 else float(alpha)
    head = max(head, float(alpha))
    e_tree = 1.0 + head * expected_accepted(alpha, depth - 1)
    return e_tree / expected_accepted(alpha, depth)


def tree_speedup(alpha: float, alpha_topk: float, width: int, depth: int,
                 c: float, stack_cost: float = 0.35) -> float:
    """Round-speedup of TreeDraftPolicy(width) over LINEAR drafting at
    gamma = depth and equal c. The root draft step runs unstacked, the
    remaining depth−1 draft steps run the width branches stacked at
    ``m = 1 + (width−1)·stack_cost`` each, and the single tree-attention
    verify stacks the span's queries at the same m:

        cost_tree = c·(1 + (depth−1)·m) + m     vs     cost_lin = depth·c + 1

    width = 1 gives exactly 1.0."""
    gain = tree_gain(alpha, alpha_topk, width, depth)
    m = 1.0 + (width - 1) * float(stack_cost)
    cost_lin = depth * c + 1.0
    cost_tree = c * (1.0 + (depth - 1) * m) + m
    return gain * cost_lin / cost_tree


def optimal_tree(alpha: float, alpha_topk: Optional[float], c: float,
                 gamma_max: int = GAMMA_MAX_DEFAULT, width_max: int = 4,
                 stack_cost: float = 0.35,
                 max_span: int = MAX_TREE_SPAN) -> Tuple[Tuple[int, int], float]:
    """Best (width, depth) over the span-feasible grid, scored as ABSOLUTE
    speedup over autoregressive decoding:

        S_tree(W, D) = S(alpha, D, c) · tree_speedup(alpha, alpha_topk, W, D)

    width = 1 rows ARE the linear candidates, so a (1, D) winner means
    'stay linear'. Returns ((width, depth), S)."""
    topk = alpha if alpha_topk is None else float(alpha_topk)
    best = ((1, 0), 1.0)
    for w in range(1, width_max + 1):
        for d in range(1, gamma_max + 1):
            if 1 + w * d > max_span:
                continue
            s = speedup(alpha, d, c) * tree_speedup(alpha, topk, w, d, c,
                                                    stack_cost)
            if s > best[1] + 1e-12:
                best = ((w, d), s)
    return best


# Host dispatch + cross-device gamma-token handoff per round, in t_target
# units (the JAX module's prior, measured there on its bench pair; the
# drift monitor re-measures it on the card).
DISPATCH_OVERHEAD_DEFAULT = 0.05


def round_time(gamma: int, c: float,
               dispatch_overhead: float = DISPATCH_OVERHEAD_DEFAULT,
               overlap: bool = False) -> float:
    """Expected speculative-round time in t_target units.

    Serialized: T = γ·c + 1 + h (draft chain + verify + dispatch h).
    Overlapped (per-role devices, async dispatch): h hides under the
    verify, but no more of it than the verify is long:
    T = γ·c + 1 + max(h − 1, 0).
    """
    base = gamma * c + 1.0
    if overlap:
        return base + max(dispatch_overhead - 1.0, 0.0)
    return base + dispatch_overhead


def prefill_time(prompt_len: int, chunk: Optional[int] = None,
                 prefix_hit_tokens: int = 0, c: float = 0.0,
                 dispatch_overhead: float = DISPATCH_OVERHEAD_DEFAULT) -> float:
    """Expected prefill cost in t_target units under chunking + prefix reuse.

    Prefill feeds ``prompt_len - 1`` positions through BOTH caches, minus
    any prefix tokens attached from the shared-prefix block cache; each
    chunk program prices like one combined target+drafter step plus its
    dispatch:

        T = ceil(max(P − 1 − hit, 0) / chunk) · (1 + c + h)

    ``chunk=None`` means the bucketed all-at-once path (one program). The
    planner uses the RATIO of this across configurations, not an
    absolute-seconds claim.
    """
    suffix = max(int(prompt_len) - 1 - max(int(prefix_hit_tokens), 0), 0)
    if suffix == 0:
        return 0.0
    n_chunks = 1 if chunk is None else -(-suffix // max(int(chunk), 1))
    return n_chunks * (1.0 + float(c) + float(dispatch_overhead))


def overlap_gain(gamma: int, c: float,
                 dispatch_overhead: float = DISPATCH_OVERHEAD_DEFAULT) -> float:
    """Round-speedup of overlapped dispatch over serialized dispatch at equal
    (γ, c): the multiplier the placement DSE applies to heterogeneous
    mappings."""
    return (round_time(gamma, c, dispatch_overhead, overlap=False)
            / round_time(gamma, c, dispatch_overhead, overlap=True))


def feasible(alpha: float, c: float) -> bool:
    """Paper §II-B: c < α must hold for ANY γ to give S > 1."""
    return c < alpha


def optimal_gamma(alpha: float, c: float,
                  gamma_max: int = GAMMA_MAX_DEFAULT) -> Tuple[int, float]:
    """γ* maximizing Eq. (1) over 0..gamma_max; returns (γ*, S(γ*)).
    γ=0 (no speculation, S=1) is always a candidate, so an infeasible
    (α, c) yields (0, 1.0): 'do not speculate'."""
    best = (0, 1.0)
    for g in range(1, gamma_max + 1):
        s = speedup(alpha, g, c)
        if s > best[1] + 1e-12:
            best = (g, s)
    return best


def speedup_curve(alpha_grid: Iterable[float], gamma: int, c: float) -> np.ndarray:
    """S as a function of α for fixed (γ, c) (paper Fig. 7's predicted curves)."""
    return np.array([speedup(a, gamma, c) for a in alpha_grid])


# ---------------------------------------------------------------------------
# hardware constants of the roofline
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HardwareSpec:
    """Peak rates of one device. ``links_per_chip`` × ``link_bw`` is the
    rate one device drives its collectives at."""
    name: str
    peak_flops: float                 # dense bf16 FLOP/s per device
    hbm_bw: float                     # device-memory bytes/s per device
    link_bw: float                    # bytes/s per device-to-device link
    links_per_chip: float


# NVIDIA H100 SXM 80GB, NVIDIA's datasheet peaks (not measurements): 989
# TFLOP/s dense bf16 (tensor cores, no sparsity), 3.35 TB/s HBM3, and
# fourth-generation NVLink with 18 links of 50 GB/s, 900 GB/s in total.
# The rates assume the card's full 700 W power limit.
H100 = HardwareSpec(name="h100-sxm-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=50e9, links_per_chip=18.0)
DEFAULT_HW = H100


@dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline estimate for one step on a set of devices."""
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int, hw: Optional[HardwareSpec] = None
                   ) -> RooflineTerms:
    """Per-step roofline seconds from a step's global FLOPs, device-memory
    bytes and collective bytes (``core/analytic_cost.py``) on ``chips``
    devices of ``hw`` (default: ``DEFAULT_HW``, read at call time)."""
    hw = DEFAULT_HW if hw is None else hw
    return RooflineTerms(
        compute_s=flops / (chips * hw.peak_flops),
        memory_s=hbm_bytes / (chips * hw.hbm_bw),
        collective_s=collective_bytes / (chips * hw.links_per_chip * hw.link_bw),
    )


def cost_coefficient(t_draft: float, t_target: float) -> float:
    """c = t_draft / t_target (paper §II-B). Works on measured or roofline times."""
    return float(t_draft) / float(t_target)
