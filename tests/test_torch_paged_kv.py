"""Port parity: the host-side ``BlockAllocator`` runs op for op against
``repro.cache.paged_kv.BlockAllocator`` on seeded random lifecycles of the
ops the default server uses (admit/grow = ``ensure``, shrink =
``free_tail``, complete = ``free_row``) and the copy-on-write branch ops
of paged tree rounds (``fork_row``, ``ensure_branch``, ``adopt_branch``,
``release_branches``, and ``free_row`` of a forked row). After every op
both allocators must return the same value and hold the same tables
(main and branch), refcounts, free list, per-row allocation and version,
and both censuses must balance."""
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
    assert port._branches.keys() == ref._branches.keys()
    for row in ref._branches:
        np.testing.assert_array_equal(port.branch_tables(row),
                                      ref.branch_tables(row))
        np.testing.assert_array_equal(port._branch_alloc[row],
                                      ref._branch_alloc[row])
    counts = port.audit()
    ref_counts = ref.audit()
    assert counts == {"free": ref_counts["free"], "live": ref_counts["live"]}


@pytest.mark.parametrize("seed", range(8))
def test_allocator_matches_jax_op_for_op(seed):
    rng = np.random.default_rng(seed)
    port = BlockAllocator(NUM_BLOCKS, BLOCK_SIZE, MAX_BLOCKS, BATCH)
    ref = JaxAllocator(NUM_BLOCKS, BLOCK_SIZE, MAX_BLOCKS, BATCH)
    tokens = np.zeros(BATCH, np.int64)
    branches = {}                         # row -> branch token counts
    for _ in range(200):
        kind = rng.choice(["ensure", "free_tail", "free_row", "query",
                           "fork", "growbr", "adopt", "dropbr"])
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
        else:
            n = int(rng.integers(0, MAX_BLOCKS * BLOCK_SIZE + 8))
            assert port.can_allocate(n) == ref.can_allocate(n)
            assert port.blocks_for(n) == ref.blocks_for(n)
            assert port.num_free == ref.num_free
        _same(port, ref)


def test_ensure_refuses_beyond_row_capacity_and_pool():
    port = BlockAllocator(4, BLOCK_SIZE, 2, 2)
    assert not port.ensure(0, 3 * BLOCK_SIZE)          # past max_blocks_per_row
    assert port.ensure(0, 2 * BLOCK_SIZE)
    assert not port.ensure(1, 2 * BLOCK_SIZE)          # one block left
    assert port.audit() == {"free": 1, "live": 2}
    assert port.free_row(0) == 2
    assert port.audit() == {"free": 3, "live": 0}
