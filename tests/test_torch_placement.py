"""Port parity for placement (``repro_torch.api.placement``,
``rounds.PlacedRound``, the placed engines, the placed paged server and
``Session``'s lowering), against ``tests/test_placement.py``'s
guarantees and against ``repro`` itself.

JAX's distinct-submesh cases need eight forced host devices; the port's
lowering identifies a device by its position in the visible list, so a
list of eight ``torch.device("cpu")`` entries stands in for them here
(``CPU8``). Every placed token sequence is held to
``tests/goldens/rounds_parity.json`` on the goldens' pair (the
``llama3.2-1b`` smoke target, a one-layer-shorter drafter from
``PRNGKey(7)``). The same paths are held in lockstep with JAX's placed
engines and server under the ``d1``/``t1`` shared-device lowering, which
needs only the one JAX CPU device (``SHARED``), on the split pair of
``tests/_serving_parity.py`` (its drafter is the target's first layers, so
rounds accept part of their drafts): tokens, rounds and ``describe()``
strings equal, overlap off and on. JAX's continuous-server case waits for
the continuous server's port (ROADMAP.md, Queue 1 item 4)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_keys import JaxKey  # noqa: E402
from _serving_parity import build_pair, lockstep, one_torch_thread  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.api import placement as JPL  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import affinity as jax_affinity  # noqa: E402
from repro.core import batched_engine as jax_batched  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import partition as jax_partition  # noqa: E402
from repro.core import rounds as jax_rounds  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import PagedSpecServer as JaxServer  # noqa: E402
from repro.serving import RoundWatchdog as JaxWatchdog  # noqa: E402
from repro.serving import SchedulerConfig as JaxConfig  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import placement as PL  # noqa: E402
from repro_torch.api.plan import PlacementPlan, SubmeshSpec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import affinity, partition, rounds  # noqa: E402
from repro_torch.core.batched_engine import (BatchedEngineConfig,  # noqa: E402
                                             BatchedSpecEngine)
from repro_torch.core.engine import EngineConfig, SpecEngine  # noqa: E402
from repro_torch.launch.cli_args import apply_placement_arg  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.sampling.keys import TorchKey  # noqa: E402
from repro_torch.serving import (PagedSpecServer, RoundWatchdog,  # noqa: E402
                                 SchedulerConfig, ServeRequest)

GOLD = json.loads((pathlib.Path(__file__).parent / "goldens"
                   / "rounds_parity.json").read_text())
GAMMA = GOLD["meta"]["gamma"]
MAX_NEW = GOLD["meta"]["max_new"]

CPU8 = [torch.device("cpu")] * 8
HETERO = PlacementPlan(drafter=SubmeshSpec("d2", ("dx",), (2,)),
                       target=SubmeshSpec("t4", ("tx",), (4,)))
SHARED = PlacementPlan(drafter=SubmeshSpec("d1", ("dx",), (1,)),
                       target=SubmeshSpec("t1", ("tx",), (1,)))


def _jplan(plan):
    """The JAX package's record of a port PlacementPlan."""
    return japi.PlacementPlan(
        **{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
           if f.name not in ("drafter", "target")},
        drafter=japi.SubmeshSpec(*dataclasses.astuple(plan.drafter)),
        target=japi.SubmeshSpec(*dataclasses.astuple(plan.target)))


def _shared(overlap):
    """The d1/t1 shared-device lowering in both packages (one JAX device,
    one CPU entry)."""
    plan = dataclasses.replace(SHARED, overlap=overlap)
    return PL.lower(plan, [torch.device("cpu")]), JPL.lower(_jplan(plan))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def gold_pair():
    """The goldens' pair (tests/goldens/gen_goldens.py), bridged."""
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    jcfg_d = jcfg.replace(num_layers=max(1, jcfg.num_layers - 1), name="draft")
    cfg = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg.replace(num_layers=max(1, cfg.num_layers - 1), name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt, jpd = jt.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(7))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return (build_model(cfg), build_model(cfg_d),
            params_from_numpy(cfg, to_np(jpt), "cpu"),
            params_from_numpy(cfg_d, to_np(jpd), "cpu"), cfg)


@pytest.fixture(scope="module")
def split_pair():
    return build_pair()


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


# ------------------------------------------------------- degenerate lowering
def test_default_plan_lowers_degenerate():
    pm = PL.lower(PlacementPlan())
    assert pm is PL.DEGENERATE
    assert not pm.heterogeneous and not pm.disjoint
    x = torch.arange(4)
    assert pm.to_target(x) is x and pm.to_drafter(x) is x
    params = {"w": x}
    assert pm.drafter.put_params(None, params) is params
    assert pm.target.put_cache(None, params, 1) is params
    assert pm.describe() == JPL.lower(japi.PlacementPlan()).describe()


def test_equal_nonreplicated_submeshes_lower_degenerate():
    sub = SubmeshSpec("mx", ("mx",), (4,))
    assert not PL.lower(PlacementPlan(drafter=sub, target=sub)).heterogeneous


def test_degenerate_engine_matches_golden(gold_pair):
    """A SpecEngine handed the degenerate placement takes the unplaced path
    and reproduces the goldens."""
    mt, md, pt, pd, _ = gold_pair
    eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, greedy=True,
                                          use_cache=True, strategy="modular"),
                     placement=PL.DEGENERATE)
    assert eng.placement is None and eng.placement_note == ""
    toks, stats = eng.generate(pt, pd, _prompts(2, 6, seed=0), MAX_NEW)
    np.testing.assert_array_equal(toks.numpy(),
                                  GOLD["single_greedy_cached"]["tokens"])
    assert stats["rounds"] == GOLD["single_greedy_cached"]["rounds"]


def test_unlowerable_plan_falls_back_degenerate(gold_pair):
    """A plan needing more devices than are visible raises in ``lower``
    and runs degenerately through ``lower_or_degenerate`` and ``Session``,
    with JAX's note on one device. With no list given, the visible list is
    the CUDA devices: on a box without a GPU that raises, it does not fall
    back to the CPU."""
    big = PlacementPlan(drafter=SubmeshSpec("mx", ("mx",), (4,)),
                        target=SubmeshSpec("mx*my", ("mx", "my"), (16, 16)))
    cpu1 = [torch.device("cpu")]
    with pytest.raises(PL.PlacementError) as got:
        PL.lower(big, cpu1)
    with pytest.raises(JPL.PlacementError) as want:
        JPL.lower(_jplan(big))
    assert str(got.value) == str(want.value)
    pm = PL.lower_or_degenerate(big, cpu1)
    assert not pm.heterogeneous and "fallback" in pm.note
    assert pm.describe() == JPL.lower_or_degenerate(_jplan(big)).describe()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PL.lower(big)
    plan = dataclasses.replace(
        api.Planner(api.DeploymentSpec(cost_coefficient=0.2,
                                       adaptive_gamma=False)).plan(),
        placement=big)
    mt = gold_pair[0]
    sess = api.Session(mt, mt, None, None, plan, device="cpu")
    assert not sess.placement.heterogeneous
    assert sess.placement.note == pm.note


def test_unsupported_round_configs_reject_placement(gold_pair):
    """PlacedRound refuses what it cannot run with JAX's messages; the
    engines keep the unplaced path with JAX's reasons."""
    mt, md, *_ = gold_pair
    fake = PL.Placement(drafter=PL.RolePlacement(SubmeshSpec("d", ("d",), (1,)),
                                                 (torch.device("cpu"),), (0,)),
                        target=PL.RolePlacement(SubmeshSpec()))
    jfake = JPL.Placement(drafter=JPL.RolePlacement(japi.SubmeshSpec("d", ("d",), (1,))),
                          target=JPL.RolePlacement(japi.SubmeshSpec()))
    jmt = jax_build(jax_registry.smoke_config("llama3.2-1b"))
    cases = [
        (rounds.RoundSpec(gamma=2, use_cache=False, commit="batch_min"),
         jax_rounds.RoundSpec(gamma=2, use_cache=False), "cached"),
        (rounds.RoundSpec(greedy=True, use_cache=False, commit="batch_min",
                          policy=rounds.MultiDraftPolicy(k=2)),
         jax_rounds.RoundSpec(greedy=True, use_cache=False,
                              policy=jax_rounds.MultiDraftPolicy(k=2)), "linear"),
        (rounds.RoundSpec(gamma=2, policy=rounds.TreeDraftPolicy(width=2)),
         jax_rounds.RoundSpec(gamma=2, commit="per_row",
                              policy=jax_rounds.TreeDraftPolicy(width=2)), "linear"),
    ]
    for spec, jspec, match in cases:
        with pytest.raises(ValueError, match=match) as got:
            rounds.PlacedRound(mt, md, spec, fake)
        with pytest.raises(ValueError) as want:
            jax_rounds.PlacedRound(jmt, jmt, jspec, jfake)
        assert str(got.value) == str(want.value)
    # engines downgrade with a recorded reason instead of crashing
    hetero = PL.lower(HETERO, CPU8)
    ssm = build_model(registry.smoke_config("mamba2-780m"))
    for ecfg, drafter, note in (
            (EngineConfig(gamma=2, use_cache=False), md,
             "no-cache rounds are single-mesh"),
            (EngineConfig(gamma=2, use_cache=True, draft_policy="tree"), md,
             "tree-draft rounds are single-mesh"),
            (EngineConfig(gamma=2, use_cache=True), ssm,
             "stateful drafters are single-mesh")):
        eng = SpecEngine(mt, drafter, ecfg, placement=hetero)
        assert eng.placement is None and eng.placement_note == note


# ----------------------------------------------------------- plan durability
def test_plan_json_roundtrips_placement_and_overlap_fields():
    pp = PlacementPlan(drafter=SubmeshSpec("d2", ("dx",), (2,)),
                       target=SubmeshSpec("t4", ("tx",), (4,)),
                       explored_variants=4, predicted_speedup=2.5,
                       overlap=True, predicted_round_time=1.48)
    spec = dict(cost_coefficient=0.2, adaptive_gamma=False)
    plan = dataclasses.replace(api.Planner(api.DeploymentSpec(**spec)).plan(),
                               placement=pp)
    back = api.ExecutionPlan.from_json(plan.to_json())
    assert back == plan
    assert back.placement.overlap and back.placement.heterogeneous
    assert back.placement.predicted_round_time == pytest.approx(1.48)
    jplan = dataclasses.replace(japi.Planner(japi.DeploymentSpec(**spec)).plan(),
                                placement=_jplan(pp))
    assert plan.to_json() == jplan.to_json()


def test_planner_records_overlapped_round_term():
    def spec(mod):
        return mod.DeploymentSpec(
            alpha=0.9, cost_coefficient=0.1, explore_placement=True,
            adaptive_gamma=False,
            drafter_submeshes=(mod.SubmeshSpec("rep", (), ()),
                               mod.SubmeshSpec("d2", ("dx",), (2,))),
            target_submeshes=(mod.SubmeshSpec("t4", ("tx",), (4,)),),
            submesh_t_draft={"rep": 0.1, "d2": 0.06},
            submesh_t_target={"t4": 1.0})
    plan, jplan = api.Planner(spec(api)).plan(), japi.Planner(spec(japi)).plan()
    assert plan.placement.heterogeneous and plan.placement.overlap
    assert plan.placement.predicted_round_time > 0
    assert any("overlapped-round" in r for r in plan.rationale)
    assert any("measured step times" in r for r in plan.rationale)
    assert plan.to_json() == jplan.to_json()


# ------------------------------------------------------------- the lowering
def test_lowering_carves_disjoint_roles():
    """HETERO (d2/t4) on eight entries: the sizes and policies of JAX's
    lowering (JAX lowered over one device repeated eight times: its mesh
    shapes and policies do not depend on which devices fill them), roles
    disjoint by position."""
    pm = PL.lower(HETERO, CPU8)
    jpm = JPL.lower(_jplan(HETERO), [jax.devices()[0]] * 8)
    assert pm.heterogeneous and pm.disjoint
    assert pm.drafter.positions == (0, 1)
    assert pm.target.positions == (2, 3, 4, 5)
    assert len(pm.drafter.devices) == jpm.drafter.mesh.devices.size == 2
    assert len(pm.target.devices) == jpm.target.mesh.devices.size == 4
    for role, jrole in ((pm.drafter, jpm.drafter), (pm.target, jpm.target)):
        assert dataclasses.asdict(role.policy) == dataclasses.asdict(jrole.policy)
    assert pm.drafter.policy.model == "dx" and pm.target.policy.model == "tx"
    # a role of several devices runs on its first; the note says so
    assert pm.drafter.device == pm.target.device == torch.device("cpu")
    assert "runs on its first" in pm.note
    assert "d2 on device 0 of 2" in pm.note and "t4 on device 2 of 4" in pm.note
    # one role lowered alone (bench_dse's probe)
    r, jr = PL.role(HETERO.target, CPU8), JPL.role(_jplan(HETERO).target,
                                                   [jax.devices()[0]] * 8)
    assert r.positions == (0, 1, 2, 3)
    assert dataclasses.asdict(r.policy) == dataclasses.asdict(jr.policy)


@pytest.mark.parametrize("overlap", [False, True])
def test_shared_device_lowering_matches_jax(overlap):
    """d1/t1 on one device: JAX's shared-device lowering, heterogeneous and
    overlapping, with a string-equal ``describe()``."""
    pm, jpm = _shared(overlap)
    assert pm.heterogeneous == jpm.heterogeneous is True
    assert pm.disjoint == jpm.disjoint is False
    assert pm.overlap == overlap and pm.note == jpm.note
    assert pm.describe() == jpm.describe()
    assert "roles overlap from device 0" in pm.describe()


@pytest.mark.parametrize("axes,sizes,data", [
    ((), (), ()), (("mx",), (4,), ()), (("mx", "my"), (4, 4), ("data",)),
    (("data", "mx", "my"), (16, 4, 4), ("pod", "data"))])
def test_affinity_policies_match_jax(axes, sizes, data):
    sub = partition.Submesh("s", axes, sizes)
    jsub = jax_partition.Submesh("s", axes, sizes)
    mesh = {"data": 16, "mx": 4, "my": 4, "pod": 2}
    pol = affinity.policy_for(sub, mesh, data)
    jpol = jax_affinity.policy_for(jsub, mesh, data)
    assert dataclasses.asdict(pol) == dataclasses.asdict(jpol)
    for batch in (1, 8, 32):
        assert pol.batch_axis(batch) == jpol.batch_axis(batch)
    got = affinity.resolve(partition.Mapping(sub, sub), mesh, data)
    want = jax_affinity.resolve(jax_partition.Mapping(jsub, jsub), mesh, data)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    spec = SubmeshSpec("s", axes, sizes)
    assert dataclasses.asdict(PL._role_policy(spec)) == \
        dataclasses.asdict(JPL._role_policy(japi.SubmeshSpec("s", axes, sizes)))


def test_transfers_move_tensor_leaves():
    role = PL.RolePlacement(SubmeshSpec("d1", ("dx",), (1,)),
                            (torch.device("cpu"),), (0,))
    x = torch.arange(3)
    st = rounds.RoundState(tokens=x[None], length=x[0], key=TorchKey(1),
                           dcache={"k": [x, x], "index": x})
    out = role.put(st)
    assert isinstance(out, rounds.RoundState) and out.key is st.key
    assert out.tokens is st.tokens and out.dcache["k"][1] is x
    assert role.put(None) is None and role.put(3) == 3


# ----------------------------------------------------- placed on CPU8 (goldens)
@pytest.mark.parametrize("overlap", [False, True])
def test_distinct_roles_tokens_match_golden(gold_pair, overlap):
    """Draft on the drafter's devices, verify on the target's, tokens
    identical to the goldens, with and without overlapped dispatch."""
    mt, md, pt, pd, _ = gold_pair
    pm = PL.lower(dataclasses.replace(HETERO, overlap=overlap), CPU8)
    eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, greedy=True,
                                          use_cache=True, strategy="modular"),
                     placement=pm)
    assert eng.placement is pm
    toks, stats = eng.generate(pt, pd, _prompts(2, 6, seed=0), MAX_NEW)
    np.testing.assert_array_equal(toks.numpy(),
                                  GOLD["single_greedy_cached"]["tokens"])
    assert stats["rounds"] == GOLD["single_greedy_cached"]["rounds"]


def test_placed_round_hands_over_only_the_package(gold_pair):
    """One placed round: only [B] vectors (the last token, the lengths) go
    to the drafter, only the [B, gamma] drafts come back to the target,
    the spans are JAX's (unsynchronized dispatch/handoff), and the state is
    the unplaced round's."""
    mt, md, pt, pd, _ = gold_pair
    pm = PL.lower(HETERO, CPU8)
    tr = Tracer()
    eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, use_cache=True),
                     placement=pm, tracer=tr)
    prompt = _prompts(2, 6, seed=0)
    max_len = 6 + MAX_NEW + GAMMA + 2
    crossed = {"drafter": [], "target": []}

    class Spy(PL.Placement):
        def to_drafter(self, tree):
            crossed["drafter"].append(tree)
            return super().to_drafter(tree)

        def to_target(self, tree):
            crossed["target"].append(tree)
            return super().to_target(tree)
    spy = Spy(pm.drafter, pm.target, pm.overlap, pm.note)
    placed = rounds.PlacedRound(mt, md, eng._spec, spy, tracer=tr)
    new = placed(pt, pd, eng.prefill(pt, pd, prompt, max_len), round=0)
    ref = eng.round(pt, pd, eng.prefill(pt, pd, prompt, max_len))
    for name in ("tokens", "length", "n_rounds", "n_accepted", "n_drafted"):
        assert torch.equal(getattr(new, name), getattr(ref, name)), name
    for name in ("tcache", "dcache"):
        assert torch.equal(getattr(new, name)["index"], getattr(ref, name)["index"])
    t_last, length, active, key, d_off = crossed["drafter"][0]
    assert t_last.shape == (2,) and length.shape == ()
    drafts, q, _ = crossed["target"][0]
    assert drafts.shape == (2, GAMMA) and q is None
    assert [(s.name, s.tags) for s in tr.spans()] == [
        ("draft.dispatch", {"phase": "draft", "role": "drafter",
                            "kind": "dispatch", "round": 0}),
        ("handoff", {"phase": "handoff", "role": "target", "kind": "handoff",
                     "round": 0}),
        ("verify_commit.dispatch", {"phase": "verify", "role": "target",
                                    "kind": "dispatch", "round": 0}),
        ("rollback.dispatch", {"phase": "commit", "role": "drafter",
                               "kind": "dispatch", "round": 0})]


def test_per_row_placed_matches_golden(gold_pair):
    mt, md, pt, pd, _ = gold_pair
    eng = BatchedSpecEngine(mt, md, BatchedEngineConfig(gamma=GAMMA),
                            placement=PL.lower(HETERO, CPU8))
    assert eng.placed_round is not None and eng.traced_round is None
    toks, lengths, _ = eng.generate(pt, pd, _prompts(4, 6, seed=1), MAX_NEW)
    for b in range(4):
        np.testing.assert_array_equal(
            toks.numpy()[b, :6 + MAX_NEW], GOLD["per_row_greedy_ring"]["tokens"][b])


def test_paged_placed_matches_golden(gold_pair):
    mt, md, pt, pd, cfg = gold_pair
    ragged = [(5, 6), (9, 10), (6, 4), (11, 8)]
    rng = np.random.default_rng(3)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size, P).astype(np.int32),
                         new) for i, (P, new) in enumerate(ragged)]
    srv = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(max_batch=2),
                          gamma=GAMMA, placement=PL.lower(HETERO, CPU8),
                          device="cpu")
    st = srv._empty_state()
    # each role gets its own block-table tensor, never a shared one
    st = srv._sync_tables(st)
    assert st.tcache["block_table"] is not st.dcache["block_table"]
    assert st.tcache["block_table"].data_ptr() != st.dcache["block_table"].data_ptr()
    for r in reqs:
        srv.submit(r)
    done = {r.rid: r.tokens for r in srv.run()}
    for i in range(len(ragged)):
        np.testing.assert_array_equal(done[i], GOLD["paged_greedy"]["tokens"][i])
    assert srv.alloc.audit()["live"] == 0


def test_session_threads_placement_to_backend(gold_pair):
    mt, md, pt, pd, _ = gold_pair
    plan = dataclasses.replace(
        api.Planner(api.DeploymentSpec(batch_size=1, prompt_lens=(6,),
                                       max_new=8, cost_coefficient=0.2,
                                       adaptive_gamma=False)).plan(),
        placement=dataclasses.replace(HETERO, overlap=True))
    sess = api.Session(mt, md, pt, pd, plan, device="cpu",
                       placement=PL.lower(plan.placement, CPU8))
    assert sess.placement.heterogeneous and sess.placement.overlap
    sess.generate(_prompts(1, 6, seed=2))
    eng = sess.backend._engine(plan.gamma.gamma)
    assert eng.placement is not None
    assert "drafter@d2" in sess.describe()
    # the CLI's 1x1 plan, lowered by the Session over its device's list
    one = api.Session(mt, md, pt, pd, apply_placement_arg(plan, "1x1"),
                      device="cpu")
    assert one.placement.describe() == _shared(True)[1].describe()
    assert one.backend._engine(plan.gamma.gamma).placement is one.placement


# ---------------------------------------- lockstep with JAX's placed paths
@pytest.fixture(scope="module")
def jax_placed_runs(split_pair):
    """JAX's placed paths under the shared-device lowering, run once."""
    jt, jd, jpt, jpd = split_pair["jax"]
    out = {}
    for overlap in (False, True):
        _, jpm = _shared(overlap)
        eng = jax_engine.SpecEngine(
            jt, jd, jax_engine.EngineConfig(gamma=GAMMA, use_cache=True,
                                            strategy="modular"), placement=jpm)
        toks, st = eng.generate(jpt, jpd, jnp.asarray(_prompts(2, 9, seed=4)),
                                12)
        out[("engine", overlap)] = (np.asarray(toks), st["rounds"],
                                    st["accepted"])
    _, jpm = _shared(False)
    eng = jax_batched.BatchedSpecEngine(
        jt, jd, jax_batched.BatchedEngineConfig(gamma=GAMMA), placement=jpm)
    toks, lengths, st = eng.generate(jpt, jpd, jnp.asarray(_prompts(3, 7, seed=5)),
                                     MAX_NEW)
    out["per_row"] = (np.asarray(toks), np.asarray(lengths), st["rounds"])
    eng = jax_batched.BatchedSpecEngine(
        jt, jt, jax_batched.BatchedEngineConfig(gamma=GAMMA, greedy=False,
                                                temperature=1.0), placement=jpm)
    toks, lengths, _ = eng.generate(jpt, jpt, jnp.asarray(_prompts(3, 6, seed=5)),
                                    MAX_NEW, key=jax.random.PRNGKey(9))
    out["per_row_sampled"] = (np.asarray(toks), np.asarray(lengths))
    return out


@pytest.mark.parametrize("overlap", [False, True])
def test_placed_engine_in_lockstep_with_jax(split_pair, jax_placed_runs, overlap):
    """The placed cached SpecEngine under d1/t1: JAX's tokens, rounds and
    accepts (partial accepts on this pair), and the unplaced engine's."""
    mt, md, pt, pd = split_pair["torch"]
    pm, jpm = _shared(overlap)
    assert pm.describe() == jpm.describe()
    ecfg = EngineConfig(gamma=GAMMA, use_cache=True, strategy="modular")
    eng = SpecEngine(mt, md, ecfg, placement=pm)
    toks, st = eng.generate(pt, pd, _prompts(2, 9, seed=4), 12)
    jtoks, jrounds, jacc = jax_placed_runs[("engine", overlap)]
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert (st["rounds"], st["accepted"]) == (jrounds, jacc)
    assert st["accepted"] < st["rounds"] * GAMMA          # partial accepts
    utoks, ust = SpecEngine(mt, md, ecfg).generate(pt, pd, _prompts(2, 9, seed=4), 12)
    np.testing.assert_array_equal(toks.numpy(), utoks.numpy())
    assert ust["rounds"] == st["rounds"]


def test_placed_per_row_in_lockstep_with_jax(split_pair, jax_placed_runs):
    mt, md, pt, pd = split_pair["torch"]
    pm, _ = _shared(False)
    eng = BatchedSpecEngine(mt, md, BatchedEngineConfig(gamma=GAMMA),
                            placement=pm)
    toks, lengths, st = eng.generate(pt, pd, _prompts(3, 7, seed=5), MAX_NEW)
    jtoks, jlengths, jrounds = jax_placed_runs["per_row"]
    P = 7
    np.testing.assert_array_equal(toks.numpy()[:, :P + MAX_NEW],
                                  jtoks[:, :P + MAX_NEW])
    np.testing.assert_array_equal(lengths.numpy(), jlengths)
    assert st["rounds"] == jrounds


def test_per_row_sampled_placed_equals_unplaced_and_jax(split_pair,
                                                        jax_placed_runs):
    """The key handoff: placed sampled rounds give the unplaced engine's
    tokens at the same key, and JAX's placed tokens under its key."""
    mt, _, pt, _ = split_pair["torch"]
    ps = _prompts(3, 6, seed=5)

    def mk(pl):
        return BatchedSpecEngine(mt, mt, BatchedEngineConfig(
            gamma=GAMMA, greedy=False, temperature=1.0), placement=pl)
    t0, l0, _ = mk(None).generate(pt, pt, ps, MAX_NEW, key=TorchKey(9))
    t1, l1, _ = mk(PL.lower(HETERO, CPU8)).generate(pt, pt, ps, MAX_NEW,
                                                    key=TorchKey(9))
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())
    np.testing.assert_array_equal(l0.numpy(), l1.numpy())
    pm, _ = _shared(False)
    toks, lengths, _ = mk(pm).generate(pt, pt, ps, MAX_NEW,
                                       key=JaxKey(jax.random.PRNGKey(9)))
    jtoks, jlengths = jax_placed_runs["per_row_sampled"]
    np.testing.assert_array_equal(toks.numpy()[:, :6 + MAX_NEW],
                                  jtoks[:, :6 + MAX_NEW])
    np.testing.assert_array_equal(lengths.numpy(), jlengths)


def test_placed_paged_server_in_lockstep_with_jax(split_pair):
    """The placed paged server and JAX's under d1/t1, stepped together:
    step-infos, allocator tables and free lists after every step, then
    tokens, round counts and the audit."""
    mt, md, pt, pd = split_pair["torch"]
    jt, jd, jpt, jpd = split_pair["jax"]
    pm, jpm = _shared(False)
    cfg = dict(max_batch=3, block_size=4, num_blocks=64, max_blocks_per_row=12,
               gamma_max=6, prefill_buckets=(8, 16))
    port = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(**cfg), gamma=GAMMA,
                           placement=pm, device="cpu",
                           watchdog=RoundWatchdog(slow_factor=float("inf")))
    ref = JaxServer(jt, jd, jpt, jpd, JaxConfig(**cfg), gamma=GAMMA,
                    placement=jpm, watchdog=JaxWatchdog(slow_factor=float("inf")))
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 512, P).astype(np.int32), new)
            for P, new in [(5, 8), (9, 12), (6, 4), (13, 10), (7, 6)]]
    _, got, want = lockstep(port, ref, reqs)
    assert sorted(got) == list(range(len(reqs)))
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert port.total_rounds == ref.total_rounds
    assert port.metrics.summary()["alpha_hat"] == ref.metrics.summary()["alpha_hat"]
    assert port.alloc.audit() == ref.alloc.audit()
