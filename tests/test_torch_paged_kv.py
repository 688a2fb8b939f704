"""Port parity: the host-side ``BlockAllocator`` runs op for op against
``repro.cache.paged_kv.BlockAllocator`` on seeded random lifecycles of the
ops the server uses (admit/grow = ``ensure``, shrink = ``free_tail``,
complete = ``free_row``), the copy-on-write branch ops of paged tree rounds
(``fork_row``, ``ensure_branch``, ``adopt_branch``, ``release_branches``,
and ``free_row`` of a forked row), the prefix-cache pins (``cache_ref``,
``uncache``, ``attach``) and fault seizure (``seize``,
``release_seized``). After every op both allocators must return the same
value and hold the same tables (main and branch), refcounts, free list,
seized list, cached set, per-row allocation and version, and both
four-way censuses must balance and agree."""
from collections import Counter

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.cache.paged_kv import BlockAllocator as JaxAllocator  # noqa: E402
from repro_torch.cache.paged_kv import BlockAllocator  # noqa: E402

NUM_BLOCKS, BLOCK_SIZE, MAX_BLOCKS, BATCH = 24, 4, 8, 4


def _same(port, ref):
    np.testing.assert_array_equal(port.table, ref.table)
    np.testing.assert_array_equal(port.n_alloc, ref.n_alloc)
    assert list(port.free) == list(ref.free)
    assert port.version == ref.version
    assert port.peak_in_use == ref.peak_in_use
    np.testing.assert_array_equal(port.refcnt, ref.refcnt)
    assert list(port._seized) == list(ref._seized)
    assert port.num_seized == ref.num_seized
    assert port.cached == ref.cached
    assert port._branches.keys() == ref._branches.keys()
    for row in ref._branches:
        np.testing.assert_array_equal(port.branch_tables(row),
                                      ref.branch_tables(row))
        np.testing.assert_array_equal(port._branch_alloc[row],
                                      ref._branch_alloc[row])
    assert port.audit() == ref.audit()


@pytest.mark.parametrize("seed", range(8))
def test_allocator_matches_jax_op_for_op(seed):
    rng = np.random.default_rng(seed)
    port = BlockAllocator(NUM_BLOCKS, BLOCK_SIZE, MAX_BLOCKS, BATCH)
    ref = JaxAllocator(NUM_BLOCKS, BLOCK_SIZE, MAX_BLOCKS, BATCH)
    tokens = np.zeros(BATCH, np.int64)
    branches = {}                         # row -> branch token counts
    ran = Counter()                       # prefix-cache / seizure ops run
    for _ in range(400):
        kind = rng.choice(["ensure", "free_tail", "free_row", "query",
                           "fork", "growbr", "adopt", "dropbr", "cache_ref",
                           "uncache", "attach", "seize", "release"])
        row = int(rng.integers(0, BATCH))
        if kind in ("ensure", "free_tail") and row in branches:
            kind = "query"                # a forked row grows by branch
        if kind == "ensure":
            n = int(tokens[row] + rng.integers(0, 3 * BLOCK_SIZE + 1))
            got, want = port.ensure(row, n), ref.ensure(row, n)
            assert got == want
            if got:
                tokens[row] = max(tokens[row], n)
        elif kind == "free_tail":
            n = int(rng.integers(0, tokens[row] + 1))
            assert port.free_tail(row, n) == ref.free_tail(row, n)
            tokens[row] = min(tokens[row], n)
        elif kind == "free_row":
            assert port.free_row(row) == ref.free_row(row)
            tokens[row] = 0
            branches.pop(row, None)
        elif kind == "fork":
            if row in branches:
                continue
            n_br = int(rng.integers(1, 4))
            got = port.fork_row(row, int(tokens[row]), n_br)
            assert got == ref.fork_row(row, int(tokens[row]), n_br)
            if got is not None:
                branches[row] = [int(tokens[row])] * n_br
        elif kind == "growbr":
            if row not in branches:
                continue
            w = int(rng.integers(0, len(branches[row])))
            n = branches[row][w] + int(rng.integers(1, 2 * BLOCK_SIZE))
            got = port.ensure_branch(row, w, n)
            assert got == ref.ensure_branch(row, w, n)
            if got:
                branches[row][w] = n
        elif kind == "adopt":
            if row not in branches:
                continue
            w = int(rng.integers(0, len(branches[row])))
            assert port.adopt_branch(row, w) == ref.adopt_branch(row, w)
            tokens[row] = branches.pop(row)[w]
        elif kind == "dropbr":
            assert port.release_branches(row) == ref.release_branches(row)
            branches.pop(row, None)
        elif kind == "cache_ref":
            # pin the row's full blocks (the server caches blocks strictly
            # below a row's first decode position)
            for j in range(int(tokens[row]) // BLOCK_SIZE):
                blk = int(ref.table[row, j])
                if blk not in ref.cached:
                    port.cache_ref(blk)
                    ref.cache_ref(blk)
                    ran[kind] += 1
        elif kind == "uncache":
            # the prefix pool evicts only idle blocks (its pin alone)
            idle = [b for b in sorted(ref.cached) if ref.refcnt[b] == 1]
            for blk in idle[:int(rng.integers(1, 3))]:
                assert port.uncache(blk) == ref.uncache(blk)
                ran[kind] += 1
        elif kind == "attach":
            if ref.n_alloc[row] or not ref.cached:
                continue
            chain = sorted(ref.cached)[:int(rng.integers(1, MAX_BLOCKS + 1))]
            assert port.attach(row, chain) == ref.attach(row, chain)
            tokens[row] = len(chain) * BLOCK_SIZE
            ran[kind] += 1
        elif kind == "seize":
            n = int(rng.integers(0, 3))
            got = port.seize(n)
            assert got == ref.seize(n)
            ran[kind] += got > 0
        elif kind == "release":
            n = None if rng.random() < 0.3 else int(rng.integers(0, 6))
            got = port.release_seized(n)
            assert got == ref.release_seized(n)
            ran[kind] += got > 0
        else:
            n = int(rng.integers(0, MAX_BLOCKS * BLOCK_SIZE + 8))
            assert port.can_allocate(n) == ref.can_allocate(n)
            assert port.blocks_for(n) == ref.blocks_for(n)
            assert port.num_free == ref.num_free
        _same(port, ref)
    assert all(ran[k] for k in ("cache_ref", "uncache", "attach", "seize",
                                "release")), ran


def test_ensure_refuses_beyond_row_capacity_and_pool():
    port = BlockAllocator(4, BLOCK_SIZE, 2, 2)
    assert not port.ensure(0, 3 * BLOCK_SIZE)          # past max_blocks_per_row
    assert port.ensure(0, 2 * BLOCK_SIZE)
    assert not port.ensure(1, 2 * BLOCK_SIZE)          # one block left
    assert port.audit() == {"free": 1, "live": 2, "cached": 0, "seized": 0}
    assert port.free_row(0) == 2
    assert port.audit() == {"free": 3, "live": 0, "cached": 0, "seized": 0}
