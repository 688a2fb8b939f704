"""Port parity: the port's PagedSpecServer replays the ``paged_greedy``
trace of tests/test_rounds_parity.py — ragged (prompt, max_new) =
[(5,6),(9,10),(6,4),(11,8)] from default_rng(3), max_batch=2, gamma=3 — on
the JAX-initialised ``llama3.2-1b`` smoke pair. Every request's tokens must
equal the golden (tests/goldens/rounds_parity.json) and a live run of
``repro.serving.PagedSpecServer``; the same trace served with AR rounds
only (gamma=0) must give the same tokens (the exactness invariant); and the
block allocator must audit clean with every block free at the end."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import PagedSpecServer as JaxServer  # noqa: E402
from repro.serving import SchedulerConfig as JaxConfig  # noqa: E402
from repro.serving import RoundWatchdog as JaxWatchdog  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (PagedSpecServer, RoundWatchdog,  # noqa: E402
                                 SchedulerConfig, ServeRequest)

GOLD = json.loads((pathlib.Path(__file__).parent / "goldens"
                   / "rounds_parity.json").read_text())
GAMMA = GOLD["meta"]["gamma"]
RAGGED = [(5, 6), (9, 10), (6, 4), (11, 8)]


@pytest.fixture(scope="module")
def pair():
    jcfg_t = jax_registry.smoke_config("llama3.2-1b")
    jcfg_d = jcfg_t.replace(num_layers=jcfg_t.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg_t), jax_build(jcfg_d)
    jpt, jpd = jt.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(7))
    cfg_t = registry.smoke_config("llama3.2-1b")
    cfg_d = cfg_t.replace(num_layers=cfg_t.num_layers - 1, name="draft")
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg_t), build_model(cfg_d),
                      params_from_numpy(cfg_t, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


def _prompts():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 512, P).astype(np.int32), new)
            for P, new in RAGGED]


def _serve_port(pair, gamma):
    mt, md, pt, pd = pair["torch"]
    # the watchdog reads the host clock: it must not turn a round slowed by
    # other processes to AR, which would change the round count
    srv = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(max_batch=2),
                          gamma=gamma, device="cpu",
                          watchdog=RoundWatchdog(slow_factor=float("inf")))
    for i, (p, new) in enumerate(_prompts()):
        srv.submit(ServeRequest(i, p, new))
    done = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    return srv, done


@pytest.fixture(scope="module")
def served(pair):
    return _serve_port(pair, GAMMA)


def test_matches_golden(served):
    _, done = served
    assert sorted(done) == list(range(len(RAGGED)))
    for i in range(len(RAGGED)):
        np.testing.assert_array_equal(
            done[i], np.asarray(GOLD["paged_greedy"]["tokens"][i]))


def test_matches_live_jax_server(pair, served):
    jt, jd, jpt, jpd = pair["jax"]
    srv = JaxServer(jt, jd, jpt, jpd, JaxConfig(max_batch=2), gamma=GAMMA,
                    watchdog=JaxWatchdog(slow_factor=float("inf")))
    for i, (p, new) in enumerate(_prompts()):
        srv.submit(JaxRequest(i, p, new))
    want = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    _, done = served
    for i in range(len(RAGGED)):
        np.testing.assert_array_equal(done[i], want[i])
    assert served[0].total_rounds == srv.total_rounds


def test_ar_only_gives_the_same_tokens(pair, served):
    srv_ar, done_ar = _serve_port(pair, 0)
    _, done = served
    assert srv_ar.total_rounds > served[0].total_rounds
    for i in range(len(RAGGED)):
        np.testing.assert_array_equal(done_ar[i], done[i])


def test_audit_clean_and_every_block_free(served):
    srv, _ = served
    counts = srv.alloc.audit()
    assert counts == {"free": srv.scfg.num_blocks - 1, "live": 0,
                      "cached": 0, "seized": 0}
    s = srv.metrics.summary()
    assert s["requests_completed"] == len(RAGGED)
    assert s["total_generated_tokens"] == sum(new for _, new in RAGGED)

