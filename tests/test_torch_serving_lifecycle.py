"""Port parity for the rest of the paged server's request lifecycle:
overcommit with preemption (also of a row in mid-prefill), cancellation of
a queued, a mid-prefill and a decoding request, cached prefix blocks
unchanged byte for byte under interleaved chunk and decode steps, and the
wrap corner, where a prompt reaches the last block of its row: the port's
``PagedSpecServer`` in lockstep with ``repro.serving.PagedSpecServer``
(``tests/_serving_parity.py``) and against its own bucketed path, on the
smoke-width pair, every input from a numpy seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import (BASE, build_pair, lockstep,  # noqa: E402
                             one_torch_thread, pool_whole, same_metrics,
                             same_tokens, servers, serve_port,
                             shared_prefix_trace)
from repro.serving import PagedSpecServer as JaxServer  # noqa: E402
from repro.serving import SchedulerConfig as JaxConfig  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.watchdog import RoundWatchdog  # noqa: E402
from repro_torch.serving import (PagedSpecServer, SchedulerConfig,  # noqa: E402
                                 ServeRequest)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("chunk", [None, 3])
def test_overcommit_preempts_and_keeps_tokens(pair, chunk):
    """Overcommit 2.0 on a tight pool: the port preempts (on the chunked
    path also a row in mid-prefill) in lockstep with JAX, and every token
    equals the same trace served at overcommit 1.0."""
    reqs = shared_prefix_trace(seed=1, system_len=10, suffix=(8, 14),
                               new=(16, 28))
    tight = dict(num_blocks=20, max_blocks_per_row=16, prefill_chunk=chunk,
                 prefill_buckets=(8, 16, 32, 64))
    port, ref = servers(pair, 3, overcommit=2.0, **tight)
    aborted = []
    abort = port._abort_prefill
    port._abort_prefill = lambda st, b, req: (aborted.append(req.rid),
                                              abort(st, b, req))[1]
    infos, got, want = lockstep(port, ref, reqs)
    same_tokens(got, want)
    same_metrics(port, ref)
    s = port.metrics.summary()
    assert s["n_preemptions"] >= 1
    assert sum(len(i["preempted"]) for i in infos) == s["n_preemptions"]
    assert any(r.preemptions for r in port.done)
    if chunk:
        assert aborted, "no mid-prefill row was preempted"
    base, got1 = serve_port(pair, reqs, 3, overcommit=1.0, **tight)
    assert base.metrics.summary()["n_preemptions"] == 0
    same_tokens(got, got1)
    pool_whole(port)


@pytest.mark.parametrize("chunked", [True, False])
def test_cancellation_of_queued_mid_prefill_and_decoding_requests(pair, chunked):
    """Cancel a queued request before the first step, a row in mid-prefill
    (chunked path only) and a decoding row, in lockstep with JAX."""
    reqs = shared_prefix_trace(seed=2, system_len=10, suffix=(6, 12))
    port, ref = servers(pair, 3, prefill_chunk=3 if chunked else None,
                         prefix_cache=chunked)
    kinds = {}

    def on_step(k, srv):
        if k == 0:
            kinds["queued"] = len(reqs) - 1
            return [len(reqs) - 1]
        for b, req in enumerate(srv._slots):
            if req is None or req.rid in kinds.values():
                continue
            if (b in srv._masked and srv._prefill_chunks[b] > 0
                    and "mid_prefill" not in kinds):
                kinds["mid_prefill"] = req.rid
                return [req.rid]
            if (b not in srv._masked and "decoding" not in kinds
                    and srv._committed(b) > req.prompt_len):
                kinds["decoding"] = req.rid
                return [req.rid]
        return []

    infos, got, want = lockstep(port, ref, reqs, on_step)
    want_kinds = {"queued", "decoding"} | ({"mid_prefill"} if chunked else set())
    assert set(kinds) == want_kinds
    assert sorted(r for i in infos for r in i["cancelled"]) == \
        sorted(kinds.values())
    same_tokens(got, want)
    same_metrics(port, ref)
    s = port.metrics.summary()
    assert s["requests_cancelled"] == len(kinds)
    assert s["requests_completed"] == len(reqs) - len(kinds)
    cancelled = {r.rid: r for r in port.metrics.cancelled}
    assert cancelled[kinds["queued"]].n_generated == 0
    if chunked:
        assert cancelled[kinds["mid_prefill"]].n_generated == 0
    assert cancelled[kinds["decoding"]].n_generated > 0
    pool_whole(port)


@pytest.mark.parametrize("gamma", [3, 0])
def test_cached_blocks_are_immutable_under_interleaved_rounds(pair, gamma):
    """Every block the prefix pool pins keeps its bytes, in both models'
    pools, for as long as it stays pinned, across chunk programs and
    decode rounds of rows attached to it, and of rows mid-prefill whose
    stale device index points into it."""
    mt, md, pt, pd = pair["torch"]
    srv = PagedSpecServer(mt, md, pt, pd, SchedulerConfig(
        **{**BASE, "max_batch": 3}, prefill_chunk=3, prefix_cache=True),
        gamma=gamma, device="cpu")
    for i, (p, new) in enumerate(shared_prefix_trace(seed=3, n=10)):
        srv.submit(ServeRequest(i, p, new))
    snap = {}
    attached_mid_prefill = 0

    def pools():
        st = srv._state
        return [st.tcache["k"], st.tcache["v"], st.dcache["k"], st.dcache["v"]]

    while srv.step() is not None:
        for blk in list(snap):
            if blk not in srv.alloc.cached:
                del snap[blk]            # evicted: may be reused now
        for blk in srv.alloc.cached:
            now = [t[:, blk].clone() for t in pools()]
            if blk in snap:
                for a, b in zip(snap[blk], now):
                    assert torch.equal(a, b), f"cached block {blk} changed"
            else:
                snap[blk] = now
        attached_mid_prefill += sum(
            1 for b in srv._masked
            if srv.alloc.table[b, 0] in srv.alloc.cached)
    assert snap and attached_mid_prefill > 0
    pool_whole(srv)


CORNER = dict(max_batch=2, block_size=16, num_blocks=32, max_blocks_per_row=4,
              gamma_max=8, prefill_buckets=(16, 32, 64))


def corner_trace():
    """Prompts of 49-51 tokens fill the last of a row's 4 blocks of 16."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 512, P).astype(np.int32), new)
            for P, new in [(50, 5), (49, 6), (20, 8), (51, 4)]]


@pytest.fixture(scope="module")
def corner_cold(pair):
    """The corner trace on both bucketed paths, in lockstep: (port tokens,
    JAX tokens)."""
    port, ref = servers(pair, 3, **CORNER)
    _, cold, cold_jax = lockstep(port, ref, corner_trace())
    same_tokens(cold, cold_jax)
    return cold, cold_jax


@pytest.mark.parametrize("chunk", [3, 16, 24])
def test_wrap_corner_matches_the_cold_path(pair, corner_cold, chunk):
    """BS 16, gamma_max 8, 4 blocks per row. At chunk 24 the last chunk of
    request 0 (P 50) starts at 48, and a chunk padded to 24 tokens would
    reach positions 64-71, which the write's clamp maps onto the last
    block's offsets 0-7: positions 48-55, real prompt KV. The port runs the
    last chunk at its true length and must equal its own cold path (and so
    JAX's)."""
    srv, got = serve_port(pair, corner_trace(), 3, prefill_chunk=chunk, **CORNER)
    same_tokens(got, corner_cold[0])
    pool_whole(srv)


def test_jax_pads_the_last_chunk_onto_the_rows_last_block(pair, corner_cold):
    """A reading of the reference at the wrap corner, kept as a test so
    the deliberate difference stays visible: JAX pads the last chunk of
    request 0 (P 50, chunk 24: chunk [48, 49) padded to [48, 72)) onto its
    own prompt KV and departs from its cold path; the port does not."""
    jt, jd, jpt, jpd = pair["jax"]
    srv = JaxServer(jt, jd, jpt, jpd, JaxConfig(**CORNER, prefill_chunk=24),
                    gamma=3, watchdog=RoundWatchdog(slow_factor=float("inf")))
    for i, (p, new) in enumerate(corner_trace()):
        srv.submit(JaxRequest(i, p, new))
    got = {r.rid: np.asarray(r.tokens) for r in srv.run()}
    cold_jax = corner_cold[1]
    assert not np.array_equal(got[0], cold_jax[0])
    for rid in (1, 2):                   # no padding past the row's end
        np.testing.assert_array_equal(got[rid], cold_jax[rid])
