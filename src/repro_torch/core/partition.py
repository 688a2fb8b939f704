"""Design-space exploration for heterogeneous speculative-sampling mappings
(paper §III-B; port of ``repro/core/partition.py``).

Paper                               | here
------------------------------------|------------------------------------------
PU (CPU cluster / GPU)              | submesh: a named set of devices whose
                                    |   collectives a partition spans
design variant v = Π n_i            | candidate submesh sizes per partition
m partitions (drafter, target)      | m = 2, same
profiled t_draft, t_target          | roofline step-times (core/analytic_cost.py)
                                    |   or measured per-submesh step times
exhaustive search pruned by Eq. (1) | same — evaluate() scores every mapping

The design space size follows the paper's v * N^m formula: with D candidate
drafter submeshes and T target submeshes, |space| = D * T (we report the
formula's terms in DesignSpace.describe()).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cost_model


@dataclass(frozen=True)
class Submesh:
    """A partition's execution domain: the mesh axes its collectives span.

    ``axes=()`` means fully replicated — the single-chip analogue (the paper's
    one-CPU-core variant). Chips not in `axes` run the same program replicated,
    so wall-time equals a mesh of prod(sizes) chips — exactly how the paper's
    idle PUs behave during the other phase.
    """
    name: str
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def chips(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


@dataclass(frozen=True)
class Mapping:
    """One point of the design space: where drafter and target live."""
    drafter: Submesh
    target: Submesh
    variant_id: int = 0


@dataclass
class MappingEval:
    mapping: Mapping
    c: float
    t_draft: float
    t_target: float
    alpha: float
    gamma_star: int
    speedup: float
    feasible: bool
    use_speculation: bool
    overlap_gain: float = 1.0     # dispatch-overlap multiplier (1.0 = serialized)
    t_round: float = 0.0          # predicted round wall-time, SECONDS

    def row(self) -> Dict:
        return {
            "variant": self.mapping.variant_id,
            "drafter_on": f"{self.mapping.drafter.name}({self.mapping.drafter.chips})",
            "target_on": f"{self.mapping.target.name}({self.mapping.target.chips})",
            "c": round(self.c, 4),
            "gamma*": self.gamma_star if self.use_speculation else 0,
            "speculative": "Yes" if self.use_speculation else "No",
            "heterogeneous": ("Yes" if self.mapping.drafter.name != self.mapping.target.name
                              and self.use_speculation else "NA"),
            "speedup": round(self.speedup, 3),
            "overlap_gain": round(self.overlap_gain, 3),
            "t_round_ms": round(self.t_round * 1e3, 4),
        }


class DesignSpace:
    """Enumerates and evaluates drafter/target submesh mappings."""

    def __init__(self, drafter_options: Sequence[Submesh],
                 target_options: Sequence[Submesh]):
        self.drafter_options = list(drafter_options)
        self.target_options = list(target_options)

    def mappings(self) -> List[Mapping]:
        out = []
        vid = 1
        for d in self.drafter_options:
            for t in self.target_options:
                out.append(Mapping(d, t, vid))
                vid += 1
        return out

    def describe(self) -> str:
        v = len(self.drafter_options) * len(self.target_options)
        return (f"design space: v={v} variants "
                f"(D={len(self.drafter_options)} drafter submeshes x "
                f"T={len(self.target_options)} target submeshes), m=2 partitions")

    def evaluate(self, alpha: float,
                 t_draft_fn: Callable[[Submesh], float],
                 t_target_fn: Callable[[Submesh], float],
                 t_target_baseline: Optional[float] = None,
                 gamma_max: int = cost_model.GAMMA_MAX_DEFAULT,
                 overlap: bool = False,
                 dispatch_overhead: float = cost_model.DISPATCH_OVERHEAD_DEFAULT
                 ) -> List[MappingEval]:
        """Score every mapping with the analytical cost model.

        Speedups are reported relative to ``t_target_baseline`` (non-speculative
        target on its best homogeneous placement — the paper's 'homogeneous CPU
        execution' baseline). If None, the fastest t_target over mappings is used.

        ``overlap=True`` adds the overlapped-round term: heterogeneous
        speculative mappings (drafter and target on distinct submeshes, so
        the placed runtime can dispatch the next draft under the in-flight
        verify) are credited ``cost_model.overlap_gain``; homogeneous
        mappings pay the serialized ``dispatch_overhead``. The host
        dispatch/handoff cost is ~constant in SECONDS across mappings, so
        ``dispatch_overhead`` is interpreted in BASELINE-target units
        (``h_sec = h * t_target_baseline``) and re-priced per mapping in
        that mapping's own t_target units — exactly how
        ``benchmarks/bench_dse.py`` calibrates it. ``t_round`` on every row
        is the predicted round wall-time in seconds — the number the bench
        validates against measurement.
        """
        rows = []
        t_targets = {m.target.name: t_target_fn(m.target) for m in self.mappings()}
        if t_target_baseline is None:
            t_target_baseline = min(t_targets.values())
        h_sec = dispatch_overhead * t_target_baseline
        for m in self.mappings():
            td = t_draft_fn(m.drafter)
            tt = t_targets[m.target.name]
            c = cost_model.cost_coefficient(td, tt)
            feas = cost_model.feasible(alpha, c)
            g_star, s_spec = cost_model.optimal_gamma(alpha, c, gamma_max)
            hetero = m.drafter.name != m.target.name
            h_m = h_sec / tt                    # this mapping's t_target units
            gain = 1.0
            if overlap and g_star > 0:
                # EVERY speculative mapping pays its residual dispatch cost
                # (so the ranking tracks t_round); heterogeneous mappings
                # pay only the un-hideable part and the ratio is the
                # overlap credit
                base = g_star * c + 1.0
                pen = base / cost_model.round_time(g_star, c, h_m,
                                                   overlap=hetero)
                gain = cost_model.overlap_gain(g_star, c, h_m) if hetero else 1.0
                s_spec *= pen
            # absolute speedup vs the baseline placement
            s_abs = s_spec * (t_target_baseline / tt)
            s_plain = t_target_baseline / tt
            use_spec = s_abs > s_plain + 1e-12 and g_star > 0
            g_used = g_star if use_spec else 0
            t_round = tt * cost_model.round_time(
                g_used, c, h_m if overlap else 0.0,
                overlap=overlap and hetero and use_spec)
            rows.append(MappingEval(
                mapping=m, c=c, t_draft=td, t_target=tt, alpha=alpha,
                gamma_star=g_star, speedup=max(s_abs, s_plain),
                feasible=feas, use_speculation=use_spec,
                overlap_gain=gain if use_spec else 1.0, t_round=t_round))
        return rows

    def best(self, *args, **kw) -> MappingEval:
        return max(self.evaluate(*args, **kw), key=lambda r: r.speedup)


# ---------------------------------------------------------------------------
# standard option sets
# ---------------------------------------------------------------------------
# The reference's named submesh descriptors, copied verbatim: the planner's
# placement decision ranks mappings over these names, so a plan records the
# same drafter/target choice in either package. ``api/placement.py`` lowers
# the chosen pair to CUDA devices; on one card a plan of these sizes falls
# back to the degenerate lowering and ``session.placement.note`` says why.
def default_drafter_options() -> List[Submesh]:
    """Candidate drafter submeshes — the 'v' dimension of the paper's space."""
    return [
        Submesh("replicated", (), ()),                    # 1-chip analogue
        Submesh("mx", ("mx",), (4,)),                     # 4-chip model parallel
        Submesh("mx*my", ("mx", "my"), (4, 4)),           # 16-chip model parallel
        Submesh("data*mx*my", ("data", "mx", "my"), (16, 4, 4)),  # full 256
    ]


def default_target_options() -> List[Submesh]:
    return [Submesh("mx*my", ("mx", "my"), (4, 4)),
            Submesh("data*mx*my", ("data", "mx", "my"), (16, 4, 4))]
