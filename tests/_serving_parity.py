"""Shared pieces of the port's serving-lifecycle parity tests
(tests/test_torch_prefix_cache.py, tests/test_torch_serving_lifecycle.py):
the smoke-width pair in both frameworks (and the windowed, MoE and bench
pairs),
a shared-prefix trace, and ``lockstep``, which steps the port's ``PagedSpecServer`` and
``repro.serving.PagedSpecServer`` together and compares them after every
step (their streams too, when both collect them).

The pair: the ``llama3.2-3b`` smoke target with embedding std d**-0.5 and
a one-layer ``llama3.2-1b``-smoke drafter sharing its first layer, so
drafts are rejected in some rounds; fp32; weights from one JAX init,
bridged to the port through numpy."""
import contextlib
import importlib.util
import pathlib

import jax
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.models.model import build_model as jax_build
from repro.serving import PagedSpecServer as JaxServer
from repro.serving import SchedulerConfig as JaxConfig
from repro.serving import ServeRequest as JaxRequest
from repro.serving.watchdog import RoundWatchdog
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.models.model import build_model
from repro_torch.serving import PagedSpecServer, SchedulerConfig, ServeRequest
from repro_torch.serving import RoundWatchdog as PortWatchdog

STEP_KEYS = ("finished", "cancelled", "expired", "failed", "preempted",
             "round", "queue_depth", "n_live")
COUNT_KEYS = ("requests_completed", "requests_cancelled", "requests_rejected",
              "requests_expired", "requests_failed", "n_preemptions",
              "recompute_tokens", "degradations", "total_generated_tokens",
              "rounds",
              "spec_rounds", "alpha_hat", "prefill_tokens",
              "prefix_hit_tokens", "prefix_hit_rate", "chunks_per_prefill",
              "deadline_met", "goodput")


@contextlib.contextmanager
def one_torch_thread():
    """The servers run many tiny ops: one intra-op thread keeps them from
    contending with the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def build_pair():
    """The smoke-width pair in both frameworks, from one JAX init."""
    jcfg_t = jax_registry.smoke_config("llama3.2-3b")
    scale = jcfg_t.d_model ** -0.5
    jcfg_t = jcfg_t.replace(embed_init_scale=scale)
    jcfg_d = jax_registry.smoke_config("llama3.2-1b").replace(
        embed_init_scale=scale, num_layers=jcfg_t.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg_t), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                   jpt["layers"])}
    cfg_t = registry.smoke_config("llama3.2-3b").replace(embed_init_scale=scale)
    cfg_d = registry.smoke_config("llama3.2-1b").replace(
        embed_init_scale=scale, num_layers=cfg_t.num_layers - 1, name="draft")
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg_t), build_model(cfg_d),
                      params_from_numpy(cfg_t, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}




def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_pair_configs():
    """The trained pair's configs: JAX's, from ``benchmarks/common.py``
    (``target_cfg``, ``drafter_cfg``), and the port's, from
    ``chip_smoke.py::pair_configs`` (which the card trains and serves):
    ((jax target, jax drafter), (port target, port drafter))."""
    root = pathlib.Path(__file__).resolve().parent.parent
    common = _load(root / "benchmarks" / "common.py")
    return ((common.target_cfg(), common.drafter_cfg()),
            _load(root / "chip_smoke.py").pair_configs())


def bench_pair(seeds=(0, 1)):
    """The trained pair's recipe in both frameworks, each model from JAX's
    init at its seed, bridged to the port through numpy."""
    (jcfg_t, jcfg_d), (cfg_t, cfg_d) = bench_pair_configs()
    jt, jd = jax_build(jcfg_t), jax_build(jcfg_d)
    jpt = jax.jit(jt.init)(jax.random.PRNGKey(seeds[0]))
    jpd = jax.jit(jd.init)(jax.random.PRNGKey(seeds[1]))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg_t), build_model(cfg_d),
                      params_from_numpy(cfg_t, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


def windowed_pair(window):
    """The disagreeing ``llama3.2-1b`` smoke pair (the drafter is the
    target's first layer, the embedding at std d**-0.5) with a sliding
    window, in both frameworks, from one JAX init (the windowed-ring
    tests)."""
    jcfg = jax_registry.smoke_config("llama3.2-1b")
    scale = jcfg.d_model ** -0.5
    jcfg = jcfg.replace(embed_init_scale=scale, sliding_window=window)
    cfg = registry.smoke_config("llama3.2-1b").replace(
        embed_init_scale=scale, sliding_window=window)
    jcfg_d = jcfg.replace(num_layers=jcfg.num_layers - 1, name="draft")
    cfg_d = cfg.replace(num_layers=cfg.num_layers - 1, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:-1],
                                                   jpt["layers"])}
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


def moe_pair(arch, window=None, blocks=None):
    """An MoE smoke pair in both frameworks, from one JAX init: the
    ``mixtral-8x7b`` or ``llama4-maverick-400b-a17b`` smoke target (with
    ``blocks`` blocks of ``moe_every`` layers when given; ``sliding_window``
    ``window`` when given) and a drafter that is the target's first block,
    so drafts are rejected in some rounds. The embedding keeps its std-1
    init: at std d**-0.5 the later MoE block outweighs the embedding and
    the drafter almost never agrees (batch_min rounds of two rows then
    accept nothing). fp32; the port's params cross the bridge."""
    jcfg = jax_registry.smoke_config(arch)
    cfg = registry.smoke_config(arch)
    kw = {}
    if window is not None:
        kw["sliding_window"] = window
    if blocks is not None:
        kw["num_layers"] = blocks * max(jcfg.moe_every, 1)
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    per = max(jcfg.moe_every, 1)
    jcfg_d = jcfg.replace(num_layers=per, name="draft")
    cfg_d = cfg.replace(num_layers=per, name="draft")
    jt, jd = jax_build(jcfg), jax_build(jcfg_d)
    jpt = jt.init(jax.random.PRNGKey(0))
    jpd = {**jpt, "layers": jax.tree_util.tree_map(lambda a: a[:1],
                                                   jpt["layers"])}
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return {"jax": (jt, jd, jpt, jpd),
            "torch": (build_model(cfg), build_model(cfg_d),
                      params_from_numpy(cfg, to_np(jpt), "cpu"),
                      params_from_numpy(cfg_d, to_np(jpd), "cpu"))}


def shared_prefix_trace(seed=0, n=8, system_len=18, suffix=(1, 8),
                        new=(4, 12), vocab=512):
    """The multi-client chat shape: one system prompt, then a unique
    suffix per request (``repro/serving/frontend/traffic.py``)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, system_len).astype(np.int32)
    return [(np.concatenate([system, rng.integers(
                0, vocab, int(rng.integers(suffix[0], suffix[1] + 1))
             ).astype(np.int32)]), int(rng.integers(new[0], new[1] + 1)))
            for _ in range(n)]


BASE = dict(max_batch=3, block_size=4, num_blocks=96, max_blocks_per_row=12,
            gamma_max=6, prefill_buckets=(8, 16, 32))


def servers(pair, gamma, now=None, **cfg):
    """The port's server and JAX's on one config (and one metrics clock
    ``now``, when given); neither watchdog can trip, so a slow CPU round
    cannot turn either to AR."""
    mt, md, pt, pd = pair["torch"]
    jt, jd, jpt, jpd = pair["jax"]
    cfg = {**BASE, **cfg}
    clocks = {} if now is None else {"now": now}
    port = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(**cfg), gamma=gamma,
                           device="cpu",
                           watchdog=PortWatchdog(slow_factor=float("inf")),
                           **clocks)
    ref = JaxServer(jt, jd, jpt, jpd, JaxConfig(**cfg), gamma=gamma,
                    watchdog=RoundWatchdog(slow_factor=float("inf")), **clocks)
    return port, ref


def lockstep(port, ref, reqs, on_step=None, deadlines=None):
    """Submit ``reqs`` to both servers (request i with ``deadlines[i]``,
    when given) and step them together until both idle; ``on_step(k,
    port)`` may return rids to cancel (in both) before step k. After every
    step the step-info and the allocators must agree, and, when both
    servers collect streams, each step's ``streams`` (rid -> tokens
    committed that step). Returns the port's step-infos and each server's
    tokens by rid."""
    for i, (p, new) in enumerate(reqs):
        d = None if deadlines is None else deadlines[i]
        port.submit(ServeRequest(i, p, new, deadline=d))
        ref.submit(JaxRequest(i, p, new, deadline=d))
    infos, k = [], 0
    while True:
        for rid in (on_step(k, port) if on_step else ()):
            port.cancel(rid)
            ref.cancel(rid)
        a, b = port.step(), ref.step()
        assert (a is None) == (b is None), (k, a, b)
        if a is None:
            break
        assert {key: a[key] for key in STEP_KEYS} == \
            {key: b[key] for key in STEP_KEYS}, k
        if port.collect_streams and ref.collect_streams:
            assert sorted(a["streams"]) == sorted(b["streams"]), k
            for rid, toks in b["streams"].items():
                np.testing.assert_array_equal(a["streams"][rid], toks,
                                              err_msg=f"step {k} rid {rid}")
        np.testing.assert_array_equal(port.alloc.table, ref.alloc.table)
        assert list(port.alloc.free) == list(ref.alloc.free)
        assert port.alloc.cached == ref.alloc.cached
        infos.append(a)
        k += 1
    tokens = lambda s: {r.rid: np.asarray(r.tokens) for r in s.done}  # noqa: E731
    return infos, tokens(port), tokens(ref)


def serve_port(pair, reqs, gamma, **cfg):
    """The port's server alone on ``reqs``; returns it and its tokens."""
    mt, md, pt, pd = pair["torch"]
    srv = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(**{**BASE, **cfg}),
                          gamma=gamma, device="cpu")
    for i, (p, new) in enumerate(reqs):
        srv.submit(ServeRequest(i, p, new))
    return srv, {r.rid: np.asarray(r.tokens) for r in srv.run()}


def same_tokens(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=f"rid {rid}")


def same_metrics(port, ref):
    sp, sr = port.metrics.summary(), ref.metrics.summary()
    assert {k: sp[k] for k in COUNT_KEYS} == {k: sr[k] for k in COUNT_KEYS}
    np.testing.assert_array_equal(sp["accept_hist"], sr["accept_hist"])
    assert port.metrics.prefill_chunks == ref.metrics.prefill_chunks
    assert port.metrics.n_prefills == ref.metrics.n_prefills
    if ref.prefix_pool is not None:
        assert port.prefix_pool.stats() == ref.prefix_pool.stats()


def pool_whole(srv):
    """Zero leaked blocks: the census balances with only cached blocks
    left, and a flush returns those to the free list."""
    counts = srv.alloc.audit()
    assert counts["live"] == 0 and counts["seized"] == 0
    if srv.prefix_pool is not None:
        assert counts["cached"] == srv.prefix_pool.num_nodes
        srv.prefix_pool.flush()
    assert srv.alloc.audit() == {"free": srv.scfg.num_blocks - 1, "live": 0,
                                 "cached": 0, "seized": 0}
