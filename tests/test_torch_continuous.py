"""The port's continuous ring server (``repro_torch.launch.continuous``)
against ``repro.launch.continuous`` and the goldens
(``tests/goldens/rounds_parity.json["continuous_greedy_ring"]``): tokens,
rounds and the acceptance totals equal to JAX's server on bridged weights,
slots refilled with more requests than rows, every forwarded row inside
its ring's identity view, the explicit ring-leaf copy, the placed server
on eight CPU entries and on the shared-device lowering, the traced round
branch and the CLI on the CPU.

Two pairs: the goldens' (the ``llama3.2-1b`` smoke target, a
one-layer-shorter drafter from ``PRNGKey(7)``) and the split pair of
``tests/_serving_parity.py`` (its drafter is the target's first layers, so
rounds accept part of their drafts). The JAX servers run once per module.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _serving_parity import build_pair, one_torch_thread  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.launch.continuous import ContinuousSpecServer as JaxServer  # noqa: E402
from repro.launch.continuous import StreamRequest as JaxRequest  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.api import placement as PL  # noqa: E402
from repro_torch.api.plan import PlacementPlan, SubmeshSpec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.engine import autoregressive_generate  # noqa: E402
from repro_torch.launch import continuous  # noqa: E402
from repro_torch.launch.continuous import (ContinuousSpecServer,  # noqa: E402
                                           StreamRequest)
from repro_torch.models import dense  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

GOLD = json.loads((pathlib.Path(__file__).parent / "goldens"
                   / "rounds_parity.json").read_text())
GAMMA = GOLD["meta"]["gamma"]
MAX_NEW = GOLD["meta"]["max_new"]
CPU8 = [torch.device("cpu")] * 8
HETERO = PlacementPlan(drafter=SubmeshSpec("d2", ("dx",), (2,)),
                       target=SubmeshSpec("t4", ("tx",), (4,)))
SHARED = PlacementPlan(drafter=SubmeshSpec("d1", ("dx",), (1,)),
                       target=SubmeshSpec("t1", ("tx",), (1,)))
REUSE = dict(R=9, P=6, NEW=8, B=2, gamma=2)   # JAX's slot-reuse case


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def gold_pair():
    """The goldens' pair (tests/goldens/gen_goldens.py), in both packages."""
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    jcfg_d = jcfg.replace(num_layers=max(1, jcfg.num_layers - 1), name="draft")
    cfg = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg.replace(num_layers=max(1, cfg.num_layers - 1), name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt, jpd = jt.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(7))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


@pytest.fixture(scope="module")
def split_pair():
    return build_pair()


def _prompts(n, length, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


def _run(server_cls, request_cls, pair, prompts, **kw):
    srv = server_cls(*pair, **kw)
    for i, p in enumerate(prompts):
        srv.submit(request_cls(i, p))
    done = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    return srv, done


def _counts(srv):
    return (srv.total_rounds, srv.n_accepted_total, srv.n_drafted_total)


@pytest.fixture(scope="module")
def jax_runs(gold_pair, split_pair):
    """JAX's server on the golden case and on the slot-reuse case."""
    gold = _run(JaxServer, JaxRequest, gold_pair["jax"], _prompts(5, 6, seed=2),
                batch=2, prompt_len=6, max_new=MAX_NEW, gamma=GAMMA)
    r = REUSE
    reuse = _run(JaxServer, JaxRequest, split_pair["jax"],
                 _prompts(r["R"], r["P"], seed=1), batch=r["B"],
                 prompt_len=r["P"], max_new=r["NEW"], gamma=r["gamma"])
    return {"gold": (_counts(gold[0]), gold[1]),
            "reuse": (_counts(reuse[0]), reuse[1])}


def _same(done, want):
    assert sorted(done) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(done[rid], want[rid], err_msg=f"rid {rid}")


# ------------------------------------------------------------------ goldens
def test_continuous_matches_golden_and_jax(gold_pair, jax_runs):
    srv, done = _run(ContinuousSpecServer, StreamRequest, gold_pair["torch"],
                     _prompts(5, 6, seed=2), batch=2, prompt_len=6,
                     max_new=MAX_NEW, gamma=GAMMA)
    for i in range(5):
        np.testing.assert_array_equal(
            done[i], GOLD["continuous_greedy_ring"]["tokens"][i])
    counts, want = jax_runs["gold"]
    _same(done, want)
    assert _counts(srv) == counts
    assert srv.n_prefills == 1 + 5 - 2      # the bootstrap, then 3 refills


def test_slot_reuse_matches_jax_and_ar(split_pair, jax_runs):
    """More requests than rows: slots are refilled, every request equals
    its own greedy AR continuation, and the acceptance totals and rounds
    equal JAX's on a pair whose rounds accept part of their drafts."""
    r = REUSE
    prompts = _prompts(r["R"], r["P"], seed=1)
    srv, done = _run(ContinuousSpecServer, StreamRequest, split_pair["torch"],
                     prompts, batch=r["B"], prompt_len=r["P"],
                     max_new=r["NEW"], gamma=r["gamma"])
    counts, want = jax_runs["reuse"]
    _same(done, want)
    assert _counts(srv) == counts
    assert srv.total_rounds > r["R"] // r["B"]
    assert 0 < srv.n_accepted_total < srv.n_drafted_total
    mt, _, pt, _ = split_pair["torch"]
    ar = autoregressive_generate(mt, pt, prompts, r["NEW"], use_cache=True)
    for rid, toks in done.items():
        np.testing.assert_array_equal(toks, ar[rid].numpy())
    assert [q.rounds_in_flight > 0 for q in srv.done] == [True] * r["R"]


def test_every_forwarded_row_stays_inside_its_ring(split_pair, monkeypatch):
    """The identity view needs index + Q <= W for every row a round
    forwards: live rows, refilled rows and frozen ones. max_len = 6 + 20 +
    4 + 2 = 32 is already a whole page, so a frozen row left at its final
    length (up to 30, as in JAX) would be forwarded past W: on these
    prompts such a row reaches index + Q = 33."""
    seen = []
    real = dense.ring_read

    def check(cfg, cache, Q, tree=None):
        out = real(cfg, cache, Q, tree)
        seen.append((int(cache["index"].max()) + Q, cache["k"].shape[2]))
        return out
    monkeypatch.setattr(dense, "ring_read", check)
    prompts = _prompts(3, 6, seed=8)
    srv, done = _run(ContinuousSpecServer, StreamRequest, split_pair["torch"],
                     prompts, batch=2, prompt_len=6, max_new=20, gamma=4)
    assert srv.max_len == 32 and {w for _, w in seen} == {32}
    assert max(end for end, _ in seen) <= 32
    mt, _, pt, _ = split_pair["torch"]
    ar = autoregressive_generate(mt, pt, prompts, 20, use_cache=True)
    for rid, toks in done.items():
        np.testing.assert_array_equal(toks, ar[rid].numpy())


def test_insert_row_copies_named_ring_leaves_and_refuses_others(split_pair):
    mt, md, pt, pd = split_pair["torch"]
    srv = ContinuousSpecServer(mt, md, pt, pd, batch=2, prompt_len=6,
                               max_new=4, gamma=2)
    for i, p in enumerate(_prompts(2, 6, seed=3)):
        srv.submit(StreamRequest(i, p))
    srv._bootstrap()
    st = srv._state
    k_before = st.tcache["k"].clone()
    buf, dc, tc = srv._prefill_one(_prompts(1, 6, seed=4)[0])
    new = srv._insert_row(st, 1, buf, dc, tc)
    assert new.tcache["k"] is st.tcache["k"]            # in place
    torch.testing.assert_close(new.tcache["k"][:, 1], tc["k"][:, 0],
                               rtol=0, atol=0)
    torch.testing.assert_close(new.tcache["k"][:, 0], k_before[:, 0],
                               rtol=0, atol=0)
    assert new.tcache["index"].tolist() == [5, 5]
    assert new.length.tolist() == [6, 6] and new.active.tolist() == [True] * 2
    with pytest.raises(ValueError, match="exactly"):
        srv._insert_row(st, 1, buf, dc, {**tc, "scale": tc["index"]})
    short = {**tc, "v": tc["v"][:, :, :8]}
    with pytest.raises(ValueError, match="'v'"):
        srv._insert_row(st, 0, buf, dc, short)


# ---------------------------------------------------------------- placement
@pytest.mark.parametrize("plan", [HETERO, SHARED], ids=["d2_t4", "d1_t1"])
def test_continuous_placed_matches_golden(gold_pair, plan):
    """Placed continuous serving (per-role prefill, placed bootstrap and
    refill) on eight CPU entries reproduces the goldens."""
    pm = PL.lower(plan, CPU8)
    assert pm.heterogeneous
    srv, done = _run(ContinuousSpecServer, StreamRequest, gold_pair["torch"],
                     _prompts(5, 6, seed=2), batch=2, prompt_len=6,
                     max_new=MAX_NEW, gamma=GAMMA, placement=pm)
    assert srv.placement is pm and srv.engine.placed_round is not None
    for i in range(5):
        np.testing.assert_array_equal(
            done[i], GOLD["continuous_greedy_ring"]["tokens"][i])


def test_shared_engine_must_carry_the_placement(gold_pair):
    from repro_torch.core.batched_engine import (BatchedEngineConfig,
                                                 BatchedSpecEngine)
    mt, md, pt, pd = gold_pair["torch"]
    eng = BatchedSpecEngine(mt, md, BatchedEngineConfig(gamma=GAMMA))
    with pytest.raises(ValueError, match="placement"):
        ContinuousSpecServer(mt, md, pt, pd, gamma=GAMMA, engine=eng,
                             placement=PL.lower(HETERO, CPU8))


# ------------------------------------------------------------------- traced
def test_traced_server_matches_golden(gold_pair):
    tracer = Tracer(enabled=True)
    srv, done = _run(ContinuousSpecServer, StreamRequest, gold_pair["torch"],
                     _prompts(5, 6, seed=2), batch=2, prompt_len=6,
                     max_new=MAX_NEW, gamma=GAMMA, tracer=tracer)
    assert srv.engine.traced_round is not None
    for i in range(5):
        np.testing.assert_array_equal(
            done[i], GOLD["continuous_greedy_ring"]["tokens"][i])
    names = [s.name for s in tracer.spans()]
    assert names.count("draft") == srv.total_rounds
    assert names.count("prefill") == srv.n_prefills


# ---------------------------------------------------------------------- CLI
def test_cli_serves_on_the_cpu(capsys):
    sess, done = continuous.main(["--arch", "llama3.2-1b", "--smoke",
                                  "--device", "cpu", "--requests", "5",
                                  "--gamma", "3", "--placement", "1x1"])
    out = capsys.readouterr().out
    assert sess.backend_name == "continuous" and len(done) == 5
    assert "continuous-served 5 requests, 120 tokens" in out
    assert "placement: drafter@d1" in out
    mt, pt = sess.target, sess.params_t
    prompts = np.stack([r.prompt for r in sorted(done, key=lambda r: r.rid)])
    ar = autoregressive_generate(mt, pt, prompts, 24, use_cache=True).numpy()
    for r in done:
        np.testing.assert_array_equal(r.tokens, ar[r.rid])
