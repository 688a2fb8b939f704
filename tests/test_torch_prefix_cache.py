"""Port parity for chunked prefill and the prefix pool
(``repro_torch.cache.prefix_pool``, the rest of ``BlockAllocator``,
``serving.scheduler``, ``serving.metrics`` and ``serving.paged_server``)
against ``repro``.

Pieces first: the port's allocator under ``tests/_allocator_model.py``
(census balanced after every op, every op kind), ``PrefixPool`` op for op
against JAX's (same blocks, stats and LRU victims), and the scheduler's
``admit_tokens``/``validate`` over overcommit x chunked. Then the server on
the smoke-width pair of ``tests/_serving_parity.py`` (every input from a
numpy seed), stepped in lockstep with ``repro.serving.PagedSpecServer``
under the same ``SchedulerConfig`` on a shared-prefix trace at chunks 3, 8
and 16, with and without the prefix pool, gamma 3 and 0: the same
step-info (finished / cancelled / preempted / expired / failed rids, round
id, queue depth, live rows) and allocator tables at every step, the same
tokens and metrics counts, and the same tokens as its own bucketed (cold)
path. Last, the CLI. Preemption, cancellation, cached-block immutability
and the wrap corner are in ``tests/test_torch_serving_lifecycle.py``."""
import dataclasses
import os
import pathlib
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _allocator_model import (BATCH, BLOCK_SIZE, MAX_BLOCKS,  # noqa: E402
                              NUM_BLOCKS, OP_KINDS, run_allocator_model)
from _serving_parity import (build_pair, lockstep,  # noqa: E402
                             one_torch_thread, pool_whole, same_metrics,
                             same_tokens, servers, serve_port,
                             shared_prefix_trace)
from repro.cache.paged_kv import BlockAllocator as JaxAllocator  # noqa: E402
from repro.cache.prefix_pool import PrefixPool as JaxPool  # noqa: E402
from repro.serving import SchedulerConfig as JaxConfig  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.cache.paged_kv import BlockAllocator  # noqa: E402
from repro_torch.cache.prefix_pool import PrefixPool  # noqa: E402
from repro_torch.serving import SchedulerConfig, ServeRequest  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


# ------------------------------------------------------------- allocator
@pytest.mark.parametrize("seed", range(6))
def test_allocator_model_balances_on_the_port(seed):
    """The shared interleaving model drives the PORT's allocator: every op
    kind, the four-way census balanced after every op, the pool whole at
    the end."""
    rng = np.random.default_rng(seed)
    ops = [(str(rng.choice(OP_KINDS)), int(rng.integers(0, BATCH)),
            int(rng.integers(0, 3 * BLOCK_SIZE + 1))) for _ in range(400)]
    assert {k for k, _, _ in ops} == set(OP_KINDS)
    run_allocator_model(ops, alloc=BlockAllocator(NUM_BLOCKS, BLOCK_SIZE,
                                                  MAX_BLOCKS, BATCH))


# ------------------------------------------------------------ prefix pool
def _pool_pair(nb=32, bs=4, mb=8, b=4):
    port_alloc, ref_alloc = BlockAllocator(nb, bs, mb, b), JaxAllocator(nb, bs, mb, b)
    return port_alloc, PrefixPool(port_alloc), ref_alloc, JaxPool(ref_alloc)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_pool_matches_jax_op_for_op(seed):
    """Random admit (lookup + attach + grow), complete (insert + free),
    reclaim and pool-pressure interleavings on a port pool and a JAX pool
    over their own allocators: every lookup returns the same chain, every
    insert and reclaim the same count, the LRU victims are the same (the
    free lists agree block for block), and stats and censuses agree after
    every op."""
    rng = np.random.default_rng(seed)
    nb, bs, mb, B = 32, 4, 8, 4
    pa, pool, ra, ref = _pool_pair(nb, bs, mb, B)
    common = rng.integers(0, 3, mb * bs)
    rows = {}
    for _ in range(300):
        op = rng.choice(["admit", "admit", "complete", "reclaim", "pressure"])
        if op == "admit":
            empty = [b for b in range(B) if b not in rows]
            if not empty:
                continue
            b = int(rng.choice(empty))
            k = int(rng.integers(0, mb * bs // 2))
            L = int(rng.integers(2, mb * bs))
            toks = np.concatenate(
                [common[:k], rng.integers(0, 3, max(L - k, 0))])[:L]
            L = len(toks)
            cap = min((L - 1) // bs, mb)
            hit = pool.lookup(toks, cap) if cap > 0 else []
            assert hit == (ref.lookup(toks, cap) if cap > 0 else [])
            if hit:
                assert pa.attach(b, hit) == ra.attach(b, hit)
            ok = pa.ensure(b, L)
            assert ok == ra.ensure(b, L)
            if ok:
                rows[b] = (toks, L)
            else:
                assert pa.free_row(b) == ra.free_row(b)
        elif op == "complete" and rows:
            b = int(rng.choice(list(rows)))
            toks, L = rows.pop(b)
            F = min((L - 1) // bs, mb)
            if F > 0 and rng.random() < 0.8:
                blocks = [int(x) for x in pa.table[b, :F]]
                assert pool.insert(toks[:F * bs], blocks) == \
                    ref.insert(toks[:F * bs], blocks)
            assert pa.free_row(b) == ra.free_row(b)
        elif op == "reclaim":
            n = int(rng.integers(1, 4))
            assert pool.reclaim(n) == ref.reclaim(n)
        elif op == "pressure":
            n = int(rng.integers(1, 6))
            assert pa.seize(n) == ra.seize(n)
            assert pa.release_seized() == ra.release_seized()
        assert list(pa.free) == list(ra.free)
        np.testing.assert_array_equal(pa.table, ra.table)
        assert pool.stats() == ref.stats()
        assert pa.audit() == ra.audit()
        assert pa.audit()["cached"] == pool.num_nodes
    for b in list(rows):
        assert pa.free_row(b) == ra.free_row(b)
    assert pool.flush() == ref.flush()
    assert list(pa.free) == list(ra.free)
    assert pool.hits > 0 and pool.evicted_blocks > 0
    assert pa.audit() == {"free": nb - 1, "live": 0, "cached": 0, "seized": 0}


def test_pool_reclaim_spares_attached_blocks_and_is_leaf_first_lru():
    pa, pool, _, _ = _pool_pair()
    t_a = np.arange(8)
    t_b = np.concatenate([np.arange(4), np.arange(10, 14)])  # shares block 0
    assert pa.ensure(0, 8)
    pool.insert(t_a, [int(x) for x in pa.table[0, :2]])
    chain = pool.lookup(t_a, 2)
    assert len(chain) == 2
    pa.attach(1, chain)
    assert pool.lookup(t_b, 2) == chain[:1]     # diverges after block 0
    assert pool.reclaim(4) == 0 and pool.num_nodes == 2   # all attached
    pa.free_row(0)
    pa.free_row(1)
    assert pool.reclaim(1) == 1 and pool.num_nodes == 1   # the leaf first
    assert list(pa.free)[-1] == chain[1]
    assert pool.flush() == 1
    assert pa.audit() == {"free": 31, "live": 0, "cached": 0, "seized": 0}


# -------------------------------------------------------------- scheduler
@pytest.mark.parametrize("overcommit", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("chunked", [False, True])
def test_admit_tokens_and_validate_match_jax(overcommit, chunked):
    kw = dict(max_batch=2, block_size=4, num_blocks=40, max_blocks_per_row=10,
              gamma_max=4, prefill_buckets=(8, 16), overcommit=overcommit,
              prefill_chunk=5 if chunked else None)
    port = Scheduler(SchedulerConfig(**kw), BlockAllocator(40, 4, 10, 2))
    ref = JaxScheduler(JaxConfig(**kw), JaxAllocator(40, 4, 10, 2))
    rng = np.random.default_rng(int(overcommit * 10) + chunked)
    outcomes = Counter()
    for rid in range(200):
        P, new = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        prompt = rng.integers(0, 50, P)
        resume = (rng.integers(0, 50, P + int(rng.integers(0, new)))
                  if rng.random() < 0.5 else None)
        a = ServeRequest(rid, prompt, new, resume_tokens=resume)
        b = JaxRequest(rid, prompt, new, resume_tokens=resume)
        assert port.admit_tokens(a) == ref.admit_tokens(b)
        errs = []
        for sched, req in ((port, a), (ref, b)):
            try:
                sched.validate(req)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
        outcomes[errs[0] is None] += 1
    assert outcomes[True] and outcomes[False]
    assert port.metrics.rejected == ref.metrics.rejected


# ----------------------------------------------------------------- server
@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def cold(pair):
    """The port's bucketed (cold) path on the shared-prefix trace, per
    gamma."""
    reqs = shared_prefix_trace()
    out = {}
    for gamma in (3, 0):
        srv, out[gamma] = serve_port(pair, reqs, gamma)
        assert srv.metrics.prefill_tokens == sum(len(p) - 1 for p, _ in reqs)
    same_tokens(out[3], out[0])
    return out


@pytest.mark.parametrize("gamma", [3, 0])
@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("chunk", [3, 8, 16])
def test_chunked_server_matches_jax_and_its_cold_path(pair, cold, chunk,
                                                      prefix_cache, gamma):
    reqs = shared_prefix_trace()
    port, ref = servers(pair, gamma, prefill_chunk=chunk,
                         prefix_cache=prefix_cache)
    streaming = prefix_cache and chunk == 8
    port.collect_streams = ref.collect_streams = streaming
    infos, got, want = lockstep(port, ref, reqs)
    same_tokens(got, want)
    if streaming:
        # the streams, step by step equal to JAX's, add up to the tokens
        for rid, toks in got.items():
            streamed = [i["streams"][rid] for i in infos if rid in i["streams"]]
            np.testing.assert_array_equal(np.concatenate(streamed),
                                          toks[len(reqs[rid][0]):])
    else:
        assert all(i["streams"] == {} for i in infos)
    same_tokens(got, cold[gamma])
    same_metrics(port, ref)
    s = port.metrics.summary()
    assert s["requests_completed"] == len(reqs)
    assert port.n_prefill_chunks == port.metrics.prefill_chunks
    assert port.n_prefills == 0
    if prefix_cache:
        # the first wave (3 rows, admitted in one step) misses; each later
        # request attaches the system prompt's 4 full blocks
        assert s["prefix_hit_tokens"] == (len(reqs) - 3) * 16
    else:
        assert s["prefix_hit_tokens"] == 0
    assert s["prefill_tokens"] + s["prefix_hit_tokens"] == \
        sum(len(p) - 1 for p, _ in reqs)
    if gamma:
        assert s["accept_hist"][0] > 0      # some drafts were rejected
    pool_whole(port)


def test_cli_serves_chunked_with_prefix_cache_and_overcommit(capsys):
    from repro_torch.launch import serve_paged
    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--requests", "6"]
    cold = serve_paged.main(argv)
    srv = serve_paged.main(argv + ["--prefill-chunk", "8", "--prefix-cache",
                                   "--overcommit", "1.5"])
    out = capsys.readouterr().out
    assert "paged-served 6 ragged requests" in out
    assert "chunks/prefill" in out and "attached from prefix cache" in out
    assert srv.scfg.prefill_chunk == 8 and srv.scfg.prefix_cache
    assert srv.scfg.overcommit == 1.5 and srv.n_prefill_chunks > 0
    same_tokens({r.rid: r.tokens for r in srv.done},
                 {r.rid: r.tokens for r in cold.done})
    pool_whole(srv)


def test_cli_extends_buckets_for_bucketed_overcommit():
    """``--overcommit`` folds into the plan's cache layout: on the bucketed
    path the buckets grow to cover a resumed prefix (largest bucket +
    max_new - 1), on the chunked path they stay."""
    from repro_torch.api import CacheLayout, ExecutionPlan
    from repro_torch.launch import cli_args
    plan = ExecutionPlan(batching="continuous", max_new=24,
                         cache=CacheLayout(kind="paged", prefill_buckets=(8, 16)))
    assert cli_args.apply_overcommit_arg(plan, 1.0) is plan
    out = cli_args.apply_overcommit_arg(plan, 2.0).cache
    assert out.overcommit == 2.0 and out.prefill_buckets == (8, 16, 32, 64)
    chunked = dataclasses.replace(plan, cache=dataclasses.replace(
        plan.cache, prefill_chunk=4))
    assert cli_args.apply_overcommit_arg(chunked, 2.0).cache.prefill_buckets == (8, 16)


def test_cli_subprocess_on_the_cpu():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_paged", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--requests", "4",
         "--prefill-chunk", "8", "--prefix-cache", "--overcommit", "1.5"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "paged-served 4 ragged requests" in proc.stdout
    assert "chunks/prefill" in proc.stdout
