"""Paged KV cache: block-pool storage for ragged continuous batching
(port of ``repro/cache/paged_kv.py``).

  cache = {
    "k": [L, num_blocks, block_size, Kv, D],   # one block pool per layer stack
    "v": [L, num_blocks, block_size, Kv, D],
    "block_table": [B, max_blocks_per_row] int32,  # row -> pool block ids
    "index": [B] int32                             # committed tokens per row
  }

Token at absolute position ``p`` of row ``b`` lives in
``pool[block_table[b, p // block_size], p % block_size]``. Block 0 is the
NULL block: unallocated table entries point at it, so writes from frozen or
empty batch slots land somewhere harmless. The allocator never hands it out.

Pools are updated IN PLACE: ``write`` stores into the pool tensors it is
given and returns the same tensors. The JAX package donates the buffers to
get the same effect; here no copy is ever made, and a cache dict returned by
the model shares its pools with the dict it was given. Speculative rollback
is O(1) as in JAX: attention masks on positions recovered from ``index``,
so ``rollback`` only replaces the index.

Of ``BlockAllocator`` the port has what the default server uses
(``ensure``, ``free_tail``, ``free_row``, ``num_free``, ``blocks_for``,
``can_allocate``, ``version``, ``table``, ``audit``) and the copy-on-write
branch forks of paged tree rounds (``fork_row``, ``ensure_branch``,
``branch_tables``, ``adopt_branch``, ``release_branches``). Prefix attach
and fault seizure wait for the slices that need them.
"""
from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np
import torch

from repro_torch.cache.kv_cache import _to_buf_dtype

NULL_BLOCK = 0


def init_pool(num_layers, num_blocks, block_size, num_kv_heads, head_dim,
              dtype=torch.bfloat16, device=None):
    """Per-layer-stack block pools (tables live with the cache)."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(num_layers, batch, num_blocks, block_size, max_blocks_per_row,
               num_kv_heads, head_dim, dtype=torch.bfloat16, device=None):
    cache = init_pool(num_layers, num_blocks, block_size, num_kv_heads,
                      head_dim, dtype, device)
    cache["block_table"] = torch.full((batch, max_blocks_per_row), NULL_BLOCK,
                                      dtype=torch.int32, device=device)
    cache["index"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "block_table" in cache


def _row_index(index, B, device):
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.expand(B) if idx.ndim == 0 else idx


def write(layer_cache, k_new, v_new, block_table, index):
    """Per-layer paged WRITE, in place (the read half is
    ``models.attention.attn_paged``).

    layer_cache: {"k": [NB, BS, Kv, D], "v": ...} — this layer's pool slice.
    k_new/v_new: [B, Q, Kv, D] written at positions index..index+Q-1 per row.
    Returns ``layer_cache`` (the same tensors, now updated).
    """
    BS = layer_cache["k"].shape[1]
    B, Q = k_new.shape[0], k_new.shape[1]
    MB = block_table.shape[1]
    idx = _row_index(index, B, k_new.device)
    pos = idx[:, None] + torch.arange(Q, dtype=torch.int32, device=k_new.device)
    # frozen batch slots keep getting speculative writes at their (fixed)
    # index; clamp the table lookup so an over-capacity position resolves to
    # the row's last table entry (NULL for released rows) instead of OOB
    col = torch.clamp(pos // BS, max=MB - 1).long()
    blk = torch.gather(block_table, 1, col).long()                # [B, Q]
    off = (pos % BS).long()
    layer_cache["k"][blk, off] = _to_buf_dtype(k_new, layer_cache["k"].dtype)
    layer_cache["v"][blk, off] = _to_buf_dtype(v_new, layer_cache["v"].dtype)
    return layer_cache


def copy_blocks(cache, pairs):
    """Device-side half of a copy-on-write fork: copy whole pool blocks
    ``src -> dst`` across every layer, in place. ``pairs`` is the
    (src, dst) list returned by ``BlockAllocator.fork_row`` — the partial
    tail block of a forked row is duplicated so each branch can append
    without clobbering its siblings; full prefix blocks are shared
    (refcounted), never copied."""
    if not pairs:
        return cache
    dev = cache["k"].device
    src = torch.tensor([s for s, _ in pairs], dtype=torch.long, device=dev)
    dst = torch.tensor([d for _, d in pairs], dtype=torch.long, device=dev)
    for name in ("k", "v"):
        cache[name][:, dst] = cache[name][:, src]
    return cache


def compact_positions(cache, block_table, src_pos, dst_pos):
    """Tree-verify commit-by-compaction, in place: gather KV at scattered
    ``src_pos`` and rewrite it at ``dst_pos`` (both [B, P] absolute
    positions), all layers at once. The gather (advanced indexing, which
    copies) completes before the scatter, so overlapping src/dst are safe;
    an in-place move would not be, since a winner slot may be another
    level's destination."""
    BS = cache["k"].shape[2]
    MB = block_table.shape[1]
    table = block_table.long()
    src_pos, dst_pos = src_pos.long(), dst_pos.long()
    sblk = torch.gather(table, 1, torch.clamp(src_pos // BS, max=MB - 1))
    dblk = torch.gather(table, 1, torch.clamp(dst_pos // BS, max=MB - 1))
    for name in ("k", "v"):
        moved = cache[name][:, sblk, src_pos % BS]          # [L, B, P, Kv, D]
        cache[name][:, dblk, dst_pos % BS] = moved
    return cache


def rollback(cache, accepted_index):
    """O(1) speculative rollback: drop everything after ``accepted_index``
    ([B] or scalar). Physical blocks stay resident (the next round rewrites
    them); reclaim whole tail blocks via BlockAllocator.free_tail."""
    idx = torch.as_tensor(accepted_index, dtype=torch.int32,
                          device=cache["index"].device)
    if idx.ndim == 0:
        idx = idx.expand(cache["index"].shape).clone()
    return {**cache, "index": idx}


class BlockAllocator:
    """Host-side free-list allocator for one (pool, table) pair.

    The device ``block_table`` tensor mirrors ``table``; callers push it to
    the device after any allocation change (``version`` counts changes).
    """

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_row: int, batch: int):
        if num_blocks < 2:
            raise ValueError("need at least the null block + one real block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_row = max_blocks_per_row
        self.batch = batch
        self.free: deque = deque(range(1, num_blocks))   # block 0 reserved
        self.table = np.full((batch, max_blocks_per_row), NULL_BLOCK, np.int32)
        self.n_alloc = np.zeros((batch,), np.int64)      # allocated blocks/row
        self.peak_in_use = 0                             # residency high-water
        self.version = 0     # bumped on every table mutation
        # copy-on-write state: refcnt[b] counts table references to block b
        # (main tables + branch tables); a block returns to the free list
        # only when its last reference drops. Without forks every count is 1.
        self.refcnt = np.zeros((num_blocks,), np.int64)
        self._branches: Dict[int, np.ndarray] = {}       # row -> [n_br, MB]
        self._branch_alloc: Dict[int, np.ndarray] = {}   # row -> [n_br]

    # ------------------------------------------------------------- queries
    @property
    def num_free(self) -> int:
        return len(self.free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens)
        return need <= self.max_blocks_per_row and need <= self.num_free

    def device_table(self, device) -> torch.Tensor:
        return torch.from_numpy(self.table.copy()).to(device)

    # ----------------------------------------------------------- mutation
    def ensure(self, row: int, n_tokens: int) -> bool:
        """Grow row's allocation to cover ``n_tokens`` positions. Returns
        False (allocating nothing) if the pool cannot satisfy the request."""
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks_per_row:
            return False
        have = int(self.n_alloc[row])
        if need <= have:
            return True
        if need - have > len(self.free):
            return False
        for j in range(have, need):
            self.table[row, j] = self._take_fresh()
        self.n_alloc[row] = need
        self.peak_in_use = max(self.peak_in_use, int(self.n_alloc.sum()))
        self.version += 1
        return True

    def _take_fresh(self) -> int:
        blk = self.free.popleft()
        self.refcnt[blk] = 1
        return blk

    def _release_ref(self, blk: int) -> int:
        """Drop one table reference; returns 1 if the block went back to the
        free list (its refcount hit zero), else 0."""
        self.refcnt[blk] -= 1
        if self.refcnt[blk] < 0:
            raise AssertionError(f"refcount underflow on block {blk}")
        if self.refcnt[blk] == 0:
            self.free.append(blk)
            return 1
        return 0

    def free_tail(self, row: int, n_tokens: int) -> int:
        """Release blocks beyond the one holding token ``n_tokens - 1``.
        Returns the number of blocks returned to the free list (blocks
        shared with a branch stay until their last reference drops)."""
        keep = self.blocks_for(n_tokens)
        have = int(self.n_alloc[row])
        freed = 0
        for j in range(keep, have):
            freed += self._release_ref(int(self.table[row, j]))
            self.table[row, j] = NULL_BLOCK
        self.n_alloc[row] = min(keep, have)
        if have > keep:
            self.version += 1
        return freed

    def free_row(self, row: int) -> int:
        return self.release_branches(row) + self.free_tail(row, 0)

    # -------------------------------------------- copy-on-write branch forks
    def fork_row(self, row: int, n_tokens: int, n_branches: int):
        """Fork ``row`` (committed length ``n_tokens``) into ``n_branches``
        copy-on-write branch tables for tree drafting. Full prefix blocks
        are shared (refcount bumped per branch); the partial tail block, if
        any, is duplicated per branch so branches can append independently.

        Returns the (src, dst) pool-copy pairs the caller must apply with
        ``copy_blocks``, or None if the pool cannot supply the tail copies.
        The parent row's own table is left untouched, so dropping every
        branch is a no-op rollback."""
        if row in self._branches:
            raise AssertionError(f"row {row} already forked")
        BS = self.block_size
        full = max(n_tokens, 0) // BS
        tail = 1 if n_tokens % BS else 0
        if full + tail > int(self.n_alloc[row]):
            raise AssertionError(f"fork of row {row} beyond its allocation")
        if tail * n_branches > len(self.free):
            return None
        tables = np.full((n_branches, self.max_blocks_per_row), NULL_BLOCK,
                         np.int32)
        alloc = np.zeros((n_branches,), np.int64)
        pairs = []
        for w in range(n_branches):
            for j in range(full):
                blk = int(self.table[row, j])
                tables[w, j] = blk
                self.refcnt[blk] += 1
            if tail:
                dst = self._take_fresh()
                tables[w, full] = dst
                pairs.append((int(self.table[row, full]), dst))
            alloc[w] = full + tail
        self._branches[row] = tables
        self._branch_alloc[row] = alloc
        self.peak_in_use = max(self.peak_in_use,
                               int(self.n_alloc.sum()) + tail * n_branches)
        self.version += 1
        return pairs

    def ensure_branch(self, row: int, branch: int, n_tokens: int) -> bool:
        """Grow one branch's allocation to cover ``n_tokens`` positions
        (fresh blocks only — the shared prefix never regrows)."""
        tables = self._branches[row]
        alloc = self._branch_alloc[row]
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks_per_row:
            return False
        have = int(alloc[branch])
        if need <= have:
            return True
        if need - have > len(self.free):
            return False
        for j in range(have, need):
            tables[branch, j] = self._take_fresh()
        alloc[branch] = need
        self.version += 1
        return True

    def branch_tables(self, row: int) -> np.ndarray:
        """Host-side [n_branches, MB] table stack of a forked row."""
        return self._branches[row]

    def adopt_branch(self, row: int, branch: int) -> int:
        """Commit the winning branch: the row's main table becomes the
        branch's table; every other branch reference and the old main-table
        references are dropped. Returns #blocks returned to the free list."""
        tables = self._branches.pop(row)
        alloc = self._branch_alloc.pop(row)
        freed = 0
        for w in range(tables.shape[0]):
            if w == branch:
                continue
            for j in range(int(alloc[w])):
                freed += self._release_ref(int(tables[w, j]))
        for j in range(int(self.n_alloc[row])):
            freed += self._release_ref(int(self.table[row, j]))
        self.table[row, :] = NULL_BLOCK
        n = int(alloc[branch])
        self.table[row, :n] = tables[branch, :n]
        self.n_alloc[row] = n
        self.version += 1
        return freed

    def release_branches(self, row: int) -> int:
        """Drop every branch of a forked row (tree-round rollback / abort);
        the parent row's own table is untouched. Returns #blocks freed."""
        if row not in self._branches:
            return 0
        tables = self._branches.pop(row)
        alloc = self._branch_alloc.pop(row)
        freed = 0
        for w in range(tables.shape[0]):
            for j in range(int(alloc[w])):
                freed += self._release_ref(int(tables[w, j]))
        self.version += 1
        return freed

    # ------------------------------------------------------------ auditing
    def audit(self) -> Dict[str, int]:
        """Full block census; raises AssertionError on any inconsistency.

        Invariants: free + live == num_blocks - 1 (block 0 is the null
        block; 'live' = DISTINCT blocks referenced by any main or branch
        table), every refcount equals its number of table references, no
        free block is referenced, table entries beyond each row's or
        branch's allocation are NULL, and copy-on-write sharing never
        crosses row families (a block referenced by row b's tables, main
        or branch, is referenced by no other row's)."""
        refs: Dict[int, int] = {}        # block -> #table references
        families: Dict[int, int] = {}    # block -> owning row

        def count(row, tbl, n, what):
            for x in tbl[:n]:
                x = int(x)
                if x == NULL_BLOCK:
                    raise AssertionError(f"null block handed out to {what}")
                refs[x] = refs.get(x, 0) + 1
                if families.setdefault(x, row) != row:
                    raise AssertionError(
                        f"block {x} shared across row families "
                        f"{families[x]} and {row}")
            if not (tbl[n:] == NULL_BLOCK).all():
                raise AssertionError(
                    f"{what}: non-NULL table entries beyond allocation {n}")

        for b in range(self.batch):
            count(b, self.table[b], int(self.n_alloc[b]), f"row {b}")
        for b, tables in self._branches.items():
            alloc = self._branch_alloc[b]
            for w in range(tables.shape[0]):
                count(b, tables[w], int(alloc[w]), f"row {b} branch {w}")
        for blk, n in refs.items():
            if int(self.refcnt[blk]) != n:
                raise AssertionError(
                    f"block {blk}: refcount {int(self.refcnt[blk])} != "
                    f"{n} table references")
        for blk in self.free:
            if blk in refs:
                raise AssertionError(f"block {blk} is free but still referenced")
            if int(self.refcnt[blk]) != 0:
                raise AssertionError(
                    f"free block {blk} has refcount {int(self.refcnt[blk])}")
        if len(set(self.free)) != len(self.free):
            raise AssertionError("a block appears twice on the free list")
        counts = {"free": len(self.free), "live": len(refs)}
        total = sum(counts.values())
        if total != self.num_blocks - 1:
            raise AssertionError(
                f"block census mismatch: {counts} sums to {total}, "
                f"expected {self.num_blocks - 1}")
        return counts
