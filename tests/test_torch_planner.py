"""The port's planner against ``repro``'s: the rest of the cost model
(``core/cost_model.py``), the analytic step cost, the design-space
evaluation, ``configs/base.py``'s shapes and parameter counts, the plan
datatypes with their JSON, the Planner's decisions, and the feedback hook.

Everything here is pure Python arithmetic in the same order as JAX's, so
every comparison is exact: floats with ``==``, plans by their JSON string.
Where the roofline prices hardware, the tests hand the port the JAX
module's v5e values (``V5E``, rebuilt below with JAX's 4 links per chip),
because the port's default is the H100.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import analytic_cost as jax_analytic  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import partition as jax_partition  # noqa: E402
from repro.obs.drift import DriftMonitor as JaxDriftMonitor  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.core import analytic_cost, cost_model as cm, partition  # noqa: E402
from repro_torch.obs.drift import DriftMonitor  # noqa: E402

V5E = cm.HardwareSpec(name=jcm.V5E.name, peak_flops=jcm.V5E.peak_flops,
                      hbm_bw=jcm.V5E.hbm_bw, link_bw=jcm.V5E.ici_bw,
                      links_per_chip=4.0)
ALPHAS = (0.0, 0.17, 0.5, 0.8, 0.95, 1.0)
CS = (0.0, 0.05, 0.25, 0.54, 1.5)


# ------------------------------------------------------------- cost model
def _grid(*axes):
    out = [()]
    for ax in axes:
        out = [t + (v,) for t in out for v in ax]
    return out


COST_CASES = {
    "speedup": lambda m: [m.speedup(a, g, c)
                          for a, g, c in _grid(ALPHAS, range(9), CS)],
    "expected_accepted": lambda m: [m.expected_accepted(a, g)
                                    for a, g in _grid(ALPHAS, range(9))],
    "multi_draft_gain": lambda m: [
        m.multi_draft_gain(a, t, g)
        for a, t, g in _grid(ALPHAS[:-1], (0.2, 0.9), range(1, 9))],
    "multi_draft_speedup": lambda m: [
        m.multi_draft_speedup(a, t, g, c, k, s)
        for a, t, g, c, k, s in _grid((0.3, 0.8), (0.5, 0.95), range(1, 6),
                                      CS, (2, 4), (0.35, 0.1))],
    "tree_gain": lambda m: [m.tree_gain(a, t, w, d)
                            for a, t, w, d in _grid(ALPHAS[:-1], (0.2, 0.9),
                                                    range(1, 5), range(1, 8))],
    "tree_speedup": lambda m: [
        m.tree_speedup(a, t, w, d, c, s)
        for a, t, w, d, c, s in _grid((0.3, 0.8), (0.5, 0.95), range(1, 5),
                                      range(1, 7), CS, (0.35, 0.1))],
    "optimal_tree": lambda m: [
        m.optimal_tree(a, t, c, gm, wm)
        for a, t, c, gm, wm in _grid((0.3, 0.8), (None, 0.9), CS, (4, 16),
                                     (2, 4))],
    "optimal_gamma": lambda m: [m.optimal_gamma(a, c, gm)
                                for a, c, gm in _grid(ALPHAS, CS, (1, 8, 16))],
    "round_time": lambda m: [m.round_time(g, c, h, o)
                             for g, c, h, o in _grid(range(9), CS,
                                                     (0.0, 0.05, 1.7),
                                                     (False, True))],
    "prefill_time": lambda m: [
        m.prefill_time(p, ch, hit, c, h)
        for p, ch, hit, c, h in _grid((0, 1, 2, 9, 600), (None, 1, 8, 64),
                                      (0, 8, 512), (0.0, 0.25), (0.05, 0.3))],
    "overlap_gain": lambda m: [m.overlap_gain(g, c, h)
                               for g, c, h in _grid(range(9), CS,
                                                    (0.0, 0.05, 1.7))],
    "feasible": lambda m: [m.feasible(a, c) for a, c in _grid(ALPHAS, CS)],
    "speedup_curve": lambda m: [m.speedup_curve(np.linspace(0, 1, 11), g,
                                                c).tolist()
                                for g, c in _grid(range(6), CS)],
    "cost_coefficient": lambda m: [m.cost_coefficient(d, t)
                                   for d, t in _grid((1e-3, 0.3, 7), (0.1, 3))],
    "constants": lambda m: [m.GAMMA_MAX_DEFAULT, m.MAX_TREE_SPAN,
                            m.DISPATCH_OVERHEAD_DEFAULT],
}


@pytest.mark.parametrize("name", sorted(COST_CASES))
def test_cost_model_is_jaxs(name):
    assert COST_CASES[name](cm) == COST_CASES[name](jcm)


@pytest.mark.parametrize("chips", [1, 4, 256])
def test_roofline_terms_are_jaxs_on_the_same_hardware(chips):
    for flops, hbm, coll in _grid((0.0, 3.1e12, 9.9e15), (0.0, 8.2e9, 4e11),
                                  (0.0, 1e6, 3.3e11)):
        got = cm.roofline_terms(flops, hbm, coll, chips, hw=V5E)
        want = jcm.roofline_terms(flops, hbm, coll, chips)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (got.dominant, got.step_time) == (want.dominant, want.step_time)


def test_default_hardware_is_the_h100_datasheet():
    assert cm.DEFAULT_HW is cm.H100
    assert (cm.H100.peak_flops, cm.H100.hbm_bw) == (989e12, 3.35e12)
    assert cm.H100.links_per_chip * cm.H100.link_bw == 900e9
    terms = cm.roofline_terms(989e12, 3.35e12, 900e9, 1)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (1.0, 1.0, 1.0)


def _roofline_c(arch, shape, hw):
    def step(cfg):
        sc = analytic_cost.step_cost(cfg, base.INPUT_SHAPES[shape], chips=1)
        return cm.roofline_terms(sc.flops, sc.hbm_bytes, sc.collective_bytes,
                                 1, hw=hw)
    t, d = step(registry.config(arch)), step(registry.drafter_config(arch))
    return cm.cost_coefficient(d.step_time, t.step_time), t, d


def test_the_one_chip_collective_term_is_priced_as_the_reference_prices_it():
    """A finding about the reference, ported as it is: the analytic step
    cost counts two tensor-parallel all-reduces per layer even at
    ``chips=1``. At the H100's 18 NVLink links the term stays below
    compute for Mamba-2's prefill (c as on the v5e); priced at 4 links (the
    v5e's link count) it dominates and moves c; Llama-3.2-3B's c does not
    depend on the hardware."""
    c, t, d = _roofline_c("mamba2-780m", "prefill_32k", cm.H100)
    assert t.collective_s > 0 and (t.dominant, d.dominant) == ("compute", "compute")
    assert round(c, 4) == 0.1086 == round(_roofline_c("mamba2-780m", "prefill_32k", V5E)[0], 4)
    four = dataclasses.replace(cm.H100, links_per_chip=4.0)
    c4, t4, d4 = _roofline_c("mamba2-780m", "prefill_32k", four)
    assert (t4.dominant, d4.dominant) == ("collective", "collective")
    assert round(c4, 4) == 0.125
    for shape, want in (("decode_32k", 0.2870), ("prefill_32k", 0.3829)):
        assert round(_roofline_c("llama3.2-3b", shape, cm.H100)[0], 4) == want
        assert round(_roofline_c("llama3.2-3b", shape, V5E)[0], 4) == want


# ----------------------------------------------------------------- configs
def _port_config(jcfg):
    """The port's ModelConfig with every field the two share."""
    names = {f.name for f in dataclasses.fields(base.ModelConfig)}
    return base.ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                               if k in names})


@pytest.mark.parametrize("arch", jax_registry.ARCHS)
def test_parameter_counts_are_jaxs_for_every_family(arch):
    """``param_count``/``active_param_count`` on every registry
    architecture, MoE, hybrid and encoder-decoder included (their configs
    rebuilt in the port's dataclass; only three architectures are
    registered in the port)."""
    for fn in (jax_registry.config, jax_registry.drafter_config,
               jax_registry.smoke_config):
        jcfg = fn(arch)
        cfg = _port_config(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert [cfg._block_kind(i) for i in range(7)] == \
            [jcfg._block_kind(i) for i in range(7)]


def test_registered_configs_and_shapes_are_jaxs():
    assert {k: dataclasses.astuple(v) for k, v in base.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    for arch in registry.ARCHS:
        for fn in ("config", "drafter_config", "smoke_config"):
            got = dataclasses.asdict(getattr(registry, fn)(arch))
            want = dataclasses.asdict(getattr(jax_registry, fn)(arch))
            assert got == {k: want[k] for k in got}, (arch, fn)


# ------------------------------------------------- analytic cost and the DSE
@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_step_cost_is_jaxs(arch, shape):
    for fn in ("config", "drafter_config"):
        cfg, jcfg = getattr(registry, fn)(arch), getattr(jax_registry, fn)(arch)
        for kw in ({"chips": 1}, {"chips": 4}, {"chips": 16, "fsdp": True},
                   {"chips": 8, "fsdp": True, "num_microbatches": 4},
                   {"chips": 2, "weight_gather": False, "cache_elem_bytes": 1}):
            got = analytic_cost.step_cost(cfg, base.INPUT_SHAPES[shape], **kw)
            want = jax_analytic.step_cost(jcfg, JAX_SHAPES[shape], **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert dataclasses.astuple(got.scaled(0.5)) == \
                dataclasses.astuple(want.scaled(0.5))


def _step_time_fns(mod_ac, mod_cm, mod_reg, shapes, arch, shape, **hw):
    def step(cfg):
        def t(sub):
            sc = mod_ac.step_cost(cfg, shapes[shape], chips=max(sub.chips, 1))
            return mod_cm.roofline_terms(sc.flops, sc.hbm_bytes,
                                         sc.collective_bytes,
                                         max(sub.chips, 1), **hw).step_time
        return t
    return step(mod_reg.drafter_config(arch)), step(mod_reg.config(arch))


@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_design_space_rows_are_jaxs(arch, shape):
    space = partition.DesignSpace(partition.default_drafter_options(),
                                  partition.default_target_options())
    jspace = jax_partition.DesignSpace(jax_partition.default_drafter_options(),
                                       jax_partition.default_target_options())
    td, tt = _step_time_fns(analytic_cost, cm, registry, base.INPUT_SHAPES,
                            arch, shape, hw=V5E)
    jtd, jtt = _step_time_fns(jax_analytic, jcm, jax_registry, JAX_SHAPES,
                              arch, shape)
    assert space.describe() == jspace.describe()
    for alpha, kw in ((0.8, {}), (0.17, {}), (0.95, {"overlap": True}),
                      (0.8, {"overlap": True, "dispatch_overhead": 1.7,
                             "gamma_max": 8})):
        rows = space.evaluate(alpha, td, tt, **kw)
        jrows = jspace.evaluate(alpha, jtd, jtt, **kw)
        assert [r.row() for r in rows] == [r.row() for r in jrows]
        for r, j in zip(rows, jrows):
            assert (r.c, r.t_draft, r.t_target, r.speedup, r.overlap_gain,
                    r.t_round, r.gamma_star, r.use_speculation, r.feasible) == \
                (j.c, j.t_draft, j.t_target, j.speedup, j.overlap_gain,
                 j.t_round, j.gamma_star, j.use_speculation, j.feasible)
        assert space.best(alpha, td, tt, **kw).row() == \
            jspace.best(alpha, jtd, jtt, **kw).row()


# ------------------------------------------------------------------- plans
def _submeshes(mod, *specs):
    return tuple(mod.SubmeshSpec(n, a, s) for n, a, s in specs)


RAGGED = dict(batch_size=3, prompt_lens=(5, 9, 13), max_new=(4, 12),
              streaming=True)
OPTS = {"replicated": 0.004, "mx": 0.0012, "mx*my": 0.0004,
        "data*mx*my": 0.00035}
TOPTS = {"mx*my": 0.01, "data*mx*my": 0.0031}
SPECS = {
    # tests/test_api_plan.py's artifact specs
    "default": {},
    "single_c": dict(batch_size=1, prompt_lens=(8,), max_new=16,
                     cost_coefficient=0.2),
    "uniform_stream": dict(batch_size=4, prompt_lens=(6,), max_new=12,
                           streaming=True, adaptive_gamma=False),
    "ragged_stream": dict(RAGGED, cost_coefficient=0.25),
    "ar_fallback": dict(cost_coefficient=1.5),
    "placement_c": dict(explore_placement=True, cost_coefficient=0.1),
    # its traffic shapes
    "single": dict(batch_size=1, cost_coefficient=0.2, adaptive_gamma=False),
    "per_row": dict(batch_size=4, cost_coefficient=0.2),
    "continuous_ring": dict(batch_size=4, streaming=True, cost_coefficient=0.2),
    "ragged": dict(batch_size=4, prompt_lens=(5, 11), max_new=(4, 12),
                   streaming=True, cost_coefficient=0.2),
    "ragged_batch_not_streaming": dict(batch_size=2, prompt_lens=(5, 70),
                                       max_new=40),
    "infeasible_stream": dict(batch_size=2, prompt_lens=(6,), max_new=6,
                              streaming=True, alpha=0.3, cost_coefficient=0.5),
    "infeasible_paged": dict(RAGGED, cost_coefficient=1.5),
    "adaptive_single": dict(batch_size=1, prompt_lens=(6,), max_new=12,
                            cost_coefficient=0.2, adaptive_gamma=True),
    "measured_times": dict(t_draft=0.0031, t_target=0.0117),
    "sampled": dict(greedy=False, temperature=0.7, cost_coefficient=0.3),
    # decision ⑥
    "tree_evidence": dict(batch_size=1, prompt_lens=(6,), max_new=16,
                          alpha=0.3, alpha_topk=0.8, cost_coefficient=0.1,
                          adaptive_gamma=False),
    "tree_per_row_stack": dict(batch_size=3, prompt_lens=(6,), max_new=16,
                               alpha=0.4, alpha_topk=0.9, draft_k=3,
                               cost_coefficient=0.05, stack_cost=0.2),
    "tree_declined": dict(batch_size=1, prompt_lens=(6,), max_new=16,
                          alpha=0.8, alpha_topk=0.8, cost_coefficient=0.3,
                          adaptive_gamma=False),
    "no_evidence": dict(batch_size=4, prompt_lens=(6,), max_new=16,
                        cost_coefficient=0.2, adaptive_gamma=False),
    "multi_evidence": dict(batch_size=1, use_cache=False, alpha=0.3,
                           alpha_topk=0.8, cost_coefficient=0.1),
    "multi_declined": dict(batch_size=1, use_cache=False, alpha=0.8,
                           alpha_topk=0.81, draft_k=4, cost_coefficient=0.3),
    "no_branching": dict(RAGGED, alpha_topk=0.9, cost_coefficient=0.1),
    "pinned_multi": dict(batch_size=1, use_cache=False, draft_policy="multi",
                         draft_k=3, alpha_topk=0.9, cost_coefficient=0.2),
    "pinned_tree": dict(batch_size=1, draft_policy="tree",
                        cost_coefficient=0.2),
    "pinned_tree_per_row": dict(batch_size=2, prompt_lens=(6,), max_new=8,
                                draft_policy="tree", alpha_topk=0.9,
                                cost_coefficient=0.2),
    # paged-cache knobs
    "pool_overcommit": dict(RAGGED, max_pool_blocks=20, cost_coefficient=0.2),
    "pool_overcommit_bucketed": dict(RAGGED, max_pool_blocks=12,
                                     chunked_prefill=False),
    "shared_prefix": dict(batch_size=4, prompt_lens=(530, 600, 620),
                          max_new=(32, 64), streaming=True,
                          shared_prefix_len=512),
    "shared_prefix_vetoed": dict(RAGGED, shared_prefix_len=8,
                                 chunked_prefill=False),
    "chunked_forced": dict(RAGGED, chunked_prefill=True, cost_coefficient=0.4),
    # decision ③
    "placement_unit": dict(explore_placement=True, alpha=0.9,
                           dispatch_overhead=0.8),
    "placement_measured": dict(explore_placement=True,
                               submesh_t_draft=OPTS, submesh_t_target=TOPTS),
    "placement_partial": dict(explore_placement=True,
                              submesh_t_draft={"mx": 0.001},
                              submesh_t_target=TOPTS, cost_coefficient=0.2),
    "placement_options": dict(
        explore_placement=True, cost_coefficient=0.3, alpha=0.85,
        drafter_submeshes=(("replicated", (), ()), ("d2", ("dx",), (2,))),
        target_submeshes=(("t2", ("tx",), (2,)), ("t6", ("tx",), (6,))),
        submesh_t_draft={"replicated": 0.002, "d2": 0.0013},
        submesh_t_target={"t2": 0.008, "t6": 0.0035}),
}
ARCH_SPECS = {
    f"{arch}@{shape}x{chips}{'_dse' if dse else ''}": dict(
        arch=arch, shape=shape, chips=chips, explore_placement=dse)
    for arch in registry.ARCHS
    for shape in sorted(JAX_SHAPES)
    for chips, dse in ((1, False), (4, False), (1, True))}


def _spec(mod, kw):
    kw = dict(kw)
    for key in ("drafter_submeshes", "target_submeshes"):
        if key in kw:
            kw[key] = _submeshes(mod, *kw[key])
    return mod.DeploymentSpec(**kw)


def _plans(kw):
    return api.Planner(_spec(api, kw)).plan(), japi.Planner(_spec(japi, kw)).plan()


def _same_plan(got, want):
    assert got.to_json() == want.to_json()
    # from_json round-trips both ways across the packages
    assert api.ExecutionPlan.from_json(want.to_json()) == got
    assert japi.ExecutionPlan.from_json(got.to_json()) == want
    assert api.ExecutionPlan.from_dict(want.to_dict()).to_json() == got.to_json()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plan_json_is_jaxs(name):
    got, want = _plans(SPECS[name])
    _same_plan(got, want)
    assert (got.speculative, got.placement.heterogeneous) == \
        (want.speculative, want.placement.heterogeneous)


def test_plan_grid_reaches_every_decision_branch():
    """The grid above is what the JSON comparison covers: it holds every
    batching mode, both cache kinds, each draft policy decided and given,
    declines, overcommit with and without chunking, the prefix pool, each
    placement evidence and the AR plan."""
    plans = {n: _plans(kw)[0] for n, kw in SPECS.items()}
    seen = {(p.batching, p.cache.kind, p.draft_policy) for p in plans.values()}
    assert {("single", "ring", "linear"), ("per_row", "ring", "linear"),
            ("continuous", "ring", "linear"), ("continuous", "paged", "linear"),
            ("single", "ring", "tree"), ("per_row", "ring", "tree"),
            ("single", "ring", "multi")} <= seen
    notes = " | ".join(n for p in plans.values() for n in p.rationale)
    for text in ("(given)", "(measured step times)", "(default prior)",
                 "tree drafting declined", "multi-draft declined",
                 "no top-k acceptance evidence", "branching needs",
                 "pool capped", "chunked prefill", "prefix cache on",
                 "measured submesh times ignored", "overlapped-round",
                 "gamma*=0", "adaptive gamma over", "gamma<-"):
        assert text in notes, text
    assert any(p.cache.overcommit > 1 and p.cache.prefill_chunk is None
               for p in plans.values())


@pytest.mark.parametrize("name", sorted(ARCH_SPECS))
def test_arch_plan_json_is_jaxs_on_jaxs_hardware(name, monkeypatch):
    """The roofline path (decision ②, and ③'s step times) with the port's
    default hardware patched to JAX's v5e."""
    monkeypatch.setattr(cm, "DEFAULT_HW", V5E)
    _same_plan(*_plans(ARCH_SPECS[name]))


def test_arch_plan_prices_the_h100_by_default():
    got, _ = _plans(dict(arch="mamba2-780m", shape="decode_32k"))
    c, _, _ = _roofline_c("mamba2-780m", "decode_32k", cm.H100)
    assert got.cost_coefficient == c
    assert "roofline mamba2-780m@decode_32k on 1 chips" in got.rationale[0]


PINNED_ERRORS = {
    "multi_cached": dict(batch_size=1, draft_policy="multi",
                         cost_coefficient=0.2),
    "multi_no_round": dict(batch_size=1, use_cache=False, draft_policy="multi",
                           cost_coefficient=1.5),
    "multi_sampled": dict(batch_size=1, use_cache=False, greedy=False,
                          draft_policy="multi", cost_coefficient=0.2),
    "tree_continuous": dict(RAGGED, draft_policy="tree", cost_coefficient=0.2),
    "tree_no_round": dict(batch_size=1, draft_policy="tree",
                          cost_coefficient=1.5),
    "tree_too_wide": dict(batch_size=1, draft_policy="tree", draft_k=8,
                          alpha=0.95, cost_coefficient=0.01),
}
SPEC_ERRORS = {
    "no_prompts": dict(prompt_lens=()),
    "bad_strategy": dict(strategy="fused"),
    "empty_budgets": dict(max_new=()),
    "bad_policy": dict(draft_policy="beam"),
    "multi_k1": dict(draft_policy="multi", draft_k=1, use_cache=False),
    "tree_nocache": dict(draft_policy="tree", use_cache=False),
    "negative_prefix": dict(shared_prefix_len=-1),
}


@pytest.mark.parametrize("name", sorted(PINNED_ERRORS) + sorted(SPEC_ERRORS))
def test_rejections_carry_jaxs_messages(name):
    kw = PINNED_ERRORS.get(name) or SPEC_ERRORS[name]
    with pytest.raises(ValueError) as got:
        api.Planner(_spec(api, kw)).plan()
    with pytest.raises(ValueError) as want:
        japi.Planner(_spec(japi, kw)).plan()
    assert str(got.value) == str(want.value)


def test_execution_plan_validation_is_jaxs():
    plan = api.Planner(api.DeploymentSpec()).plan()
    cases = [
        dict(strategy="fused"), dict(batching="stream"),
        dict(cache=api.CacheLayout(kind="disk")),
        dict(cache=api.CacheLayout(kind="paged")),
        dict(batching="continuous", cache=api.CacheLayout(kind="paged",
                                                          overcommit=0.5)),
        dict(cache=api.CacheLayout(prefill_chunk=0)),
        dict(cache=api.CacheLayout(prefix_cache=True)),
        dict(draft_policy="beam"), dict(draft_policy="multi"),
        dict(draft_policy="multi", use_cache=False, draft_k=1),
        dict(draft_policy="tree", gamma=api.GammaSchedule(gamma=0)),
        dict(draft_policy="tree", use_cache=False),
        dict(draft_policy="tree", batching="continuous"),
        dict(draft_policy="tree", draft_k=8, gamma=api.GammaSchedule(gamma=4)),
    ]
    for kw in cases:
        jkw = {k: (getattr(japi, type(v).__name__)(**dataclasses.asdict(v))
                   if dataclasses.is_dataclass(v) else v)
               for k, v in kw.items()}
        with pytest.raises(ValueError) as got:
            dataclasses.replace(plan, **kw)
        with pytest.raises(ValueError) as want:
            dataclasses.replace(japi.Planner(japi.DeploymentSpec()).plan(), **jkw)
        assert str(got.value) == str(want.value), kw
    for bad in ({**plan.to_dict(), "version": 99}, {**plan.to_dict(), "bogus": 1}):
        with pytest.raises(ValueError) as got:
            api.ExecutionPlan.from_dict(bad)
        with pytest.raises(ValueError) as want:
            japi.ExecutionPlan.from_dict(bad)
        assert str(got.value) == str(want.value)


def test_spec_views_are_jaxs():
    for kw in SPECS.values():
        got, want = _spec(api, kw), _spec(japi, kw)
        assert (got.max_new_budgets, got.max_new_cap, got.ragged) == \
            (want.max_new_budgets, want.max_new_cap, want.ragged)
    assert api.SubmeshSpec("m", ("a", "b"), (4, 2)).chips == 8


# ---------------------------------------------------------------- feedback
def test_best_gamma_and_alpha_ema_are_jaxs():
    for cands, a, c in _grid(((1, 2, 3, 6), (0, 1, 2), (4,)), (0.0, 0.3, 0.8, 1.0),
                             (0.05, 0.5, 0.9)):
        assert api.best_gamma(cands, a, c) == japi.best_gamma(cands, a, c)
    for prior in (None, 0.8):
        got, want = api.AlphaEma(0.7, prior=prior), japi.AlphaEma(0.7, prior=prior)
        assert got.get(0.5) == want.get(0.5)
        for acc, dr in ((3, 4), (0, 4), (4, 4), (1, 0), (2, 3)):
            assert got.observe(acc, dr) == want.observe(acc, dr)
        assert got.value == want.value


OBSERVES = [(4, 4), (0, 4), (1, 3), (0, 2), (0, 2), (0, 1), (3, 3), (6, 6),
            (8, 8), (2, 8), (0, 0), (5, 6)]


@pytest.mark.parametrize("allow_ar", [False, True])
@pytest.mark.parametrize("kw", [dict(cost_coefficient=0.2, adaptive_gamma=True),
                                dict(cost_coefficient=0.5, adaptive_gamma=True,
                                     alpha=0.6, alpha_ema=0.5),
                                dict(cost_coefficient=0.2)],
                         ids=["adaptive", "adaptive_low", "fixed"])
def test_gamma_controller_trace_is_jaxs(kw, allow_ar):
    got_plan, want_plan = _plans(kw)
    got = api.GammaController(got_plan.gamma, got_plan.cost_coefficient,
                              allow_ar=allow_ar)
    want = japi.GammaController(want_plan.gamma, want_plan.cost_coefficient,
                                allow_ar=allow_ar)
    for acc, dr in OBSERVES:
        assert got.gamma() == want.gamma()
        got.observe(acc, dr)
        want.observe(acc, dr)
        assert got.alpha_hat == want.alpha_hat
    assert got.gamma_trace == want.gamma_trace


def _monitors():
    """The port's and JAX's drift monitors fed the same rounds."""
    port, ref = DriftMonitor(gamma=4, c=0.25), JaxDriftMonitor(gamma=4, c=0.25)
    rng = np.random.default_rng(0)
    for _ in range(12):
        t = dict(t_draft=float(rng.uniform(0.02, 0.03)),
                 t_verify=float(rng.uniform(0.01, 0.012)),
                 t_commit=float(rng.uniform(1e-4, 2e-4)))
        t["t_round"] = sum(t.values()) + float(rng.uniform(0.001, 0.003))
        port.observe(**t)
        ref.observe(**t)
    return port, ref


def test_respec_from_drift_is_jaxs():
    port, ref = _monitors()
    assert port.evidence() == ref.evidence() is not None
    for kw in (SPECS["ragged"], SPECS["placement_c"], {}):
        for alpha in (None, 0.93, 1.0):
            got = api.respec_from_drift(_spec(api, kw), port, alpha=alpha)
            want = japi.respec_from_drift(_spec(japi, kw), ref, alpha=alpha)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.cost_coefficient is None and got.t_draft == want.t_draft
            plan, jplan = api.Planner(got).plan(), japi.Planner(want).plan()
            _same_plan(plan, jplan)
            assert plan.cost_coefficient == port.evidence()["c"]
    spec = _spec(api, SPECS["ragged"])
    assert api.respec_from_drift(spec, None) is spec
    assert api.respec_from_drift(spec, DriftMonitor(gamma=4, c=0.25)) is spec
