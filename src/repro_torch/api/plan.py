"""Plan-side datatypes of the two-phase API: DeploymentSpec in, ExecutionPlan out.

The paper's pipeline is compile-then-run: an analytical cost model (Eq. 1)
plus a heterogeneous-mapping DSE decide *offline* whether to speculate, with
which draft length, and where drafter and target live; the runtime then just
executes that decision. `DeploymentSpec` is the planner's input (models,
hardware, traffic shape); `ExecutionPlan` is its frozen, JSON-serializable
output — the single artifact every execution path (`repro_torch.api.Session`)
consumes. Nothing downstream of the Planner re-derives a decision the plan
already records.

The port's copy of ``repro/api/plan.py``: the same fields, defaults,
validation and JSON, so a plan serialized by either package loads in the
other (``PLAN_VERSION`` 1).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple, Union

PLAN_VERSION = 1

STRATEGIES = ("monolithic", "modular")
BATCHING_MODES = ("single", "per_row", "continuous")
CACHE_KINDS = ("ring", "paged")
DRAFT_POLICIES = ("linear", "multi", "tree")
MAX_TREE_SPAN = 31          # core.tree: 1 + width*depth <= 31 (int32 masks)


# ------------------------------------------------------------------ spec side
@dataclass(frozen=True)
class DeploymentSpec:
    """What the operator knows before compiling a deployment.

    Traffic shape: ``batch_size`` concurrent rows, prompts drawn from
    ``prompt_lens`` (a representative sample, not a hard bound), per-request
    decode budgets from ``max_new`` (int = uniform). ``streaming`` means
    requests keep arriving and finished slots should be refilled
    (continuous batching) rather than one fixed batch generated to completion.

    Speculation economics: ``alpha`` is the expected acceptance rate
    (offline-measured or prior); the cost coefficient c = t_draft/t_target
    comes from ``cost_coefficient`` directly, from measured ``t_draft``/
    ``t_target``, or — when ``arch`` names a registry architecture — from the
    analytic roofline (core/analytic_cost.py) at ``shape``/``chips``.
    """
    # traffic shape
    batch_size: int = 1
    prompt_lens: Tuple[int, ...] = (8,)
    max_new: Union[int, Tuple[int, ...]] = 32
    streaming: bool = False
    latency_target_ms: Optional[float] = None
    max_pool_blocks: Optional[int] = None   # KV block budget (edge memory
                                            # cap); when the worst case does
                                            # not fit, the planner overcommits
                                            # admission + relies on preemption
    shared_prefix_len: int = 0              # expected shared system-prompt
                                            # length (tokens) across requests;
                                            # > 0 arms the prefix block cache
    chunked_prefill: Optional[bool] = None  # None = planner decides (paged)

    # speculation economics
    alpha: float = 0.8
    cost_coefficient: Optional[float] = None
    t_draft: Optional[float] = None
    t_target: Optional[float] = None
    gamma_max: int = 8
    adaptive_gamma: Optional[bool] = None   # None = planner decides
    alpha_ema: float = 0.9
    # draft-strategy evidence: alpha_topk = measured P[target argmax in the
    # drafter's top-k] (bench_strategies.py reports it); None = no evidence,
    # the planner keeps linear drafting. draft_policy pins the decision
    # ("tree" = cached W-chain tree rounds, draft_k = tree width; "multi" =
    # no-cache k-candidate recompute rounds).
    draft_policy: Optional[str] = None      # None = planner decides
    draft_k: int = 2
    alpha_topk: Optional[float] = None
    stack_cost: Optional[float] = None      # measured marginal cost of one
                                            # stacked candidate (None = prior)

    # sampling / execution knobs
    greedy: bool = True
    temperature: float = 1.0
    use_cache: bool = True
    strategy: Optional[str] = None          # None = planner decides

    # hardware / placement (optional roofline + submesh DSE)
    arch: Optional[str] = None              # configs.registry id
    shape: str = "decode_32k"               # configs.base.INPUT_SHAPES key
    chips: int = 1
    explore_placement: bool = False
    # DSE option sets (None = core/partition.py pod defaults) and MEASURED
    # per-submesh step-time evidence: {submesh name -> seconds}, fed back by
    # benchmarks/bench_dse.py so decision ③ closes the predict->measure loop.
    drafter_submeshes: Optional[Tuple["SubmeshSpec", ...]] = None
    target_submeshes: Optional[Tuple["SubmeshSpec", ...]] = None
    submesh_t_draft: Optional[dict] = None
    submesh_t_target: Optional[dict] = None
    dispatch_overhead: Optional[float] = None  # host round-trip, t_target units

    def __post_init__(self):
        if not self.prompt_lens:
            raise ValueError("prompt_lens must be non-empty")
        if self.strategy is not None and self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        if isinstance(self.max_new, tuple) and not self.max_new:
            raise ValueError("max_new tuple must be non-empty")
        if (self.draft_policy is not None
                and self.draft_policy not in DRAFT_POLICIES):
            raise ValueError(f"draft_policy must be one of {DRAFT_POLICIES}")
        if self.draft_k < 1 or (self.draft_policy == "multi"
                                and self.draft_k < 2):
            raise ValueError("draft_k must be >= 1 (>= 2 for 'multi')")
        if self.draft_policy == "tree" and not self.use_cache:
            raise ValueError("tree drafting is cached-only (branch KV + "
                             "tree-attention verify); use draft_policy="
                             "'multi' for no-cache candidate drafting")
        if self.shared_prefix_len < 0:
            raise ValueError("shared_prefix_len must be >= 0")

    # convenience views the planner keys its decisions on
    @property
    def max_new_budgets(self) -> Tuple[int, ...]:
        if isinstance(self.max_new, int):
            return (self.max_new,)
        return tuple(self.max_new)

    @property
    def max_new_cap(self) -> int:
        return max(self.max_new_budgets)

    @property
    def ragged(self) -> bool:
        """Mixed prompt lengths or per-request decode budgets."""
        return (len(set(self.prompt_lens)) > 1
                or len(set(self.max_new_budgets)) > 1)


# ------------------------------------------------------------------ plan side
@dataclass(frozen=True)
class SubmeshSpec:
    """Serializable mirror of core.partition.Submesh — a partition's mapping."""
    name: str = "replicated"
    axes: Tuple[str, ...] = ()
    sizes: Tuple[int, ...] = ()

    @property
    def chips(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


@dataclass(frozen=True)
class PlacementPlan:
    """Where drafter and target live (the DSE's winning mapping).

    ``overlap`` arms the placed runtime's async-dispatch pipelining (the
    next round's draft is dispatched onto the drafter submesh while the
    target submesh still verifies — the paper's idle-PU elimination);
    ``predicted_round_time`` is the overlapped-round cost term the planner
    scored the mapping with, in t_target units (0.0 = unscored).
    ``api/placement.py`` lowers it to per-role devices.
    """
    drafter: SubmeshSpec = SubmeshSpec()
    target: SubmeshSpec = SubmeshSpec()
    explored_variants: int = 1
    predicted_speedup: float = 1.0
    overlap: bool = False
    predicted_round_time: float = 0.0

    @property
    def heterogeneous(self) -> bool:
        """Drafter and target on distinct submeshes (the paper's two-PU
        mapping)."""
        return self.drafter != self.target


@dataclass(frozen=True)
class GammaSchedule:
    """The plan's speculation schedule plus its runtime-feedback hook.

    ``gamma == 0`` means the cost model ruled speculation out (c >= alpha or
    S <= 1): the session runs plain autoregressive decoding. ``adaptive``
    arms the alpha-EMA re-planning hook (api/feedback.py): the session keeps
    an online acceptance estimate and re-picks gamma over ``candidates``
    each round/batch with the same Eq. (1) the planner used offline.
    """
    gamma: int = 4
    adaptive: bool = False
    candidates: Tuple[int, ...] = ()
    alpha_ema: float = 0.9
    alpha_init: float = 0.8


@dataclass(frozen=True)
class CacheLayout:
    """ring = per-row ring buffers (cache/kv_cache.py); paged = shared block
    pool (cache/paged_kv.py) with this block geometry.

    ``overcommit`` is the paged scheduler's admission-reservation divisor:
    1.0 reserves every request's worst case (never preempts); > 1.0 admits
    on expected demand and reclaims via preemption-by-eviction when the
    pool runs dry (docs/DESIGN.md §9). The planner raises it when the
    pool budget cannot hold the traffic shape's worst case."""
    kind: str = "ring"
    block_size: int = 8
    num_blocks: int = 128
    max_blocks_per_row: int = 16
    prefill_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    overcommit: float = 1.0
    # chunked prefill: fixed token budget per interleaved chunk program
    # (None = legacy bucketed all-at-once prefill); prefix_cache arms the
    # shared-prefix block pool (docs/DESIGN.md §10). Paged-only knobs.
    prefill_chunk: Optional[int] = None
    prefix_cache: bool = False


@dataclass(frozen=True)
class ExecutionPlan:
    """Frozen output of the Planner; the only input a Session needs besides
    models and params. Fully JSON round-trippable (tested)."""
    strategy: str = "monolithic"            # STRATEGIES
    batching: str = "single"                # BATCHING_MODES
    cache: CacheLayout = CacheLayout()
    gamma: GammaSchedule = GammaSchedule()
    placement: PlacementPlan = PlacementPlan()
    draft_policy: str = "linear"            # DRAFT_POLICIES (rounds seam)
    draft_k: int = 2                        # "multi": candidates/row;
                                            # "tree": branch width (depth is
                                            # gamma.gamma — one slot/level)

    # the economics the decisions were derived from (for audit/re-planning)
    alpha: float = 0.8
    alpha_topk: Optional[float] = None      # top-k acceptance evidence the
                                            # tree/multi decision was scored
                                            # with (None = no evidence)
    cost_coefficient: float = 0.25
    gamma_max: int = 8
    predicted_speedup: float = 1.0

    # execution knobs carried through from the spec
    greedy: bool = True
    temperature: float = 1.0
    use_cache: bool = True
    max_new: int = 32

    rationale: Tuple[str, ...] = ()         # human-readable planner decisions
    version: int = PLAN_VERSION

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        if self.batching not in BATCHING_MODES:
            raise ValueError(f"batching must be one of {BATCHING_MODES}")
        if self.cache.kind not in CACHE_KINDS:
            raise ValueError(f"cache.kind must be one of {CACHE_KINDS}")
        if self.cache.kind == "paged" and self.batching != "continuous":
            raise ValueError("paged cache layout requires continuous batching")
        if self.cache.overcommit < 1.0:
            raise ValueError("cache.overcommit must be >= 1.0 (1.0 = "
                             "worst-case reservation, no preemption)")
        if self.cache.prefill_chunk is not None and self.cache.prefill_chunk < 1:
            raise ValueError("cache.prefill_chunk must be >= 1 when set")
        if ((self.cache.prefill_chunk is not None or self.cache.prefix_cache)
                and self.cache.kind != "paged"):
            raise ValueError("prefill_chunk/prefix_cache are paged-cache "
                             "knobs (cache.kind == 'paged')")
        if self.draft_policy not in DRAFT_POLICIES:
            raise ValueError(f"draft_policy must be one of {DRAFT_POLICIES}")
        if self.draft_policy == "multi" and (not self.greedy or self.use_cache
                                             or self.batching != "single"):
            raise ValueError("multi-draft plans need greedy single-stream "
                             "no-cache execution (cached candidate drafting "
                             "is draft_policy='tree')")
        if self.draft_policy == "multi" and self.draft_k < 2:
            raise ValueError("multi-draft plans need draft_k >= 2")
        if self.draft_policy in ("multi", "tree") and self.gamma.gamma == 0:
            raise ValueError(f"{self.draft_policy}-draft plans need a "
                             "speculative gamma (gamma > 0) — there is no "
                             "round to branch")
        if self.draft_policy == "tree":
            if not self.use_cache:
                raise ValueError("tree-draft plans are cached-only (branch "
                                 "KV replication/forks + tree-attention "
                                 "verify need a cache)")
            if self.batching == "continuous":
                raise ValueError("tree-draft plans run single or per_row "
                                 "batching (continuous-serving tree rounds "
                                 "— roadmap)")
            if 1 + self.draft_k * self.gamma.gamma > MAX_TREE_SPAN:
                raise ValueError(
                    f"tree span 1 + {self.draft_k}*{self.gamma.gamma} "
                    f"exceeds {MAX_TREE_SPAN} (int32 ancestor masks)")

    @property
    def speculative(self) -> bool:
        return self.gamma.gamma > 0 or (self.gamma.adaptive
                                        and bool(self.gamma.candidates))

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        d = dict(d)
        version = d.get("version", PLAN_VERSION)
        if version != PLAN_VERSION:
            raise ValueError(f"unsupported plan version {version} "
                             f"(supported: {PLAN_VERSION})")
        d["cache"] = CacheLayout(**_tupled(d.get("cache", {}),
                                           ("prefill_buckets",)))
        d["gamma"] = GammaSchedule(**_tupled(d.get("gamma", {}),
                                             ("candidates",)))
        pl = dict(d.get("placement", {}))
        for part in ("drafter", "target"):
            pl[part] = SubmeshSpec(**_tupled(pl.get(part, {}),
                                             ("axes", "sizes")))
        d["placement"] = PlacementPlan(**pl)
        d["rationale"] = tuple(d.get("rationale", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ExecutionPlan fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))


def _tupled(d: dict, keys: Tuple[str, ...]) -> dict:
    """JSON turns tuples into lists; restore the tuple-typed fields."""
    out = dict(d)
    for k in keys:
        if k in out:
            out[k] = tuple(out[k])
    return out
