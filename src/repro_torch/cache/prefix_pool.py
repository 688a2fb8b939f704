"""Refcounted radix prefix pool: shared-prefix KV reuse over paged blocks
(port of ``repro/cache/prefix_pool.py``, numpy only, as there).

Requests that share a prompt prefix — a system prompt, a few-shot header,
the committed tokens of a preempted request — recompute identical KV today.
This pool caches fully-written prompt-prefix blocks at block granularity so
a later request ATTACHES the shared blocks (``BlockAllocator.attach``) and
prefills only its unique suffix.

Structure: a radix tree whose nodes each own exactly one pool block. A
node's edge key is the tuple of ``block_size`` token ids the block covers,
so matching is EXACT (token-for-token) — the "rolling hash" over token ids
is the tuple key itself, with no collision path: two different token spans
can never alias one cached block. ``lookup`` walks full blocks from the
root and returns the longest cached block chain; ``insert`` registers a
freshly prefilled row's prefix blocks (first writer wins — a concurrent
duplicate keeps its private blocks, which simply free at release).

Safety rests on one immutability argument: only blocks strictly below the
owner's first decode position (``(P - 1) // block_size`` blocks for a
P-token prompt) are ever registered, and every attaching row writes only at
positions at-or-past its own ``P - 1``, so a cached block is never written
again after registration. That is why ``BlockAllocator.audit`` may exempt
cached blocks from family-disjoint sharing.

Lifecycle: registration pins the block (``cache_ref``, one extra
reference). Attached rows add plain table references; release drops them.
Eviction is leaf-first LRU over nodes whose block has NO table reference
left (refcount == 1, the pool pin alone) — evicting an interior node would
orphan descendants whose KV depends on it. The allocator calls ``reclaim``
through its ``reclaimer`` hook whenever the free list runs dry, so cached
blocks are free headroom, not stranded memory.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cache.paged_kv import BlockAllocator


class _Node:
    __slots__ = ("key", "block", "children", "parent", "stamp")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key                # the block_size token ids this block holds
        self.block = block            # pool block id
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = 0                # LRU clock (bumped on lookup/insert)


class PrefixPool:
    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self.bs = alloc.block_size
        self.root = _Node((), -1, None)    # virtual root, owns no block
        self._tick = 0
        # counters (ServingMetrics aggregates per-request; these are
        # pool-global and feed bench snapshots)
        self.lookups = 0
        self.hits = 0                 # lookups that matched >= 1 block
        self.hit_tokens = 0           # tokens of prefill skipped via attach
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        alloc.reclaimer = self.reclaim

    # -------------------------------------------------------------- queries
    @property
    def num_nodes(self) -> int:
        n, stack = 0, list(self.root.children.values())
        while stack:
            nd = stack.pop()
            n += 1
            stack.extend(nd.children.values())
        return n

    def stats(self) -> Dict[str, int]:
        return {"nodes": self.num_nodes, "lookups": self.lookups,
                "hits": self.hits, "hit_tokens": self.hit_tokens,
                "inserted_blocks": self.inserted_blocks,
                "evicted_blocks": self.evicted_blocks}

    def _key(self, toks: np.ndarray, i: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in toks[i * self.bs:(i + 1) * self.bs])

    # ---------------------------------------------------------- hit / miss
    def lookup(self, tokens, max_blocks: int) -> List[int]:
        """Longest cached full-block prefix of ``tokens``: the block-id
        chain to attach (possibly empty), capped at ``max_blocks`` — callers
        cap at ``(P - 1) // block_size`` so the attaching row's first decode
        write at position P - 1 never lands in a shared block."""
        self._tick += 1
        self.lookups += 1
        toks = np.asarray(tokens)
        node, out = self.root, []
        for i in range(min(len(toks) // self.bs, max_blocks)):
            nxt = node.children.get(self._key(toks, i))
            if nxt is None:
                break
            nxt.stamp = self._tick
            out.append(nxt.block)
            node = nxt
        if out:
            self.hits += 1
            self.hit_tokens += len(out) * self.bs
        return out

    def insert(self, tokens, blocks) -> int:
        """Register a freshly prefilled row's prefix blocks (``blocks[i]``
        holds ``tokens[i*bs:(i+1)*bs]``, fully written, never written
        again). Existing nodes win — a duplicate's private blocks stay
        unregistered and free at its release. Returns #blocks newly
        pinned."""
        self._tick += 1
        toks = np.asarray(tokens)
        node, fresh = self.root, 0
        for i, blk in enumerate(blocks):
            key = self._key(toks, i)
            nxt = node.children.get(key)
            if nxt is None:
                self.alloc.cache_ref(int(blk))
                nxt = _Node(key, int(blk), node)
                node.children[key] = nxt
                self.inserted_blocks += 1
                fresh += 1
            nxt.stamp = self._tick
            node = nxt
        return fresh

    # ------------------------------------------------------------- eviction
    def _evictable_leaves(self) -> List[_Node]:
        out, stack = [], list(self.root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif int(self.alloc.refcnt[nd.block]) == 1:   # pool pin only
                out.append(nd)
        return out

    def _evict(self, nd: _Node) -> int:
        del nd.parent.children[nd.key]
        self.evicted_blocks += 1
        return self.alloc.uncache(nd.block)

    def reclaim(self, n: int) -> int:
        """Evict cached blocks until ``n`` are freed or nothing evictable
        remains: leaf-first (radix integrity — descendants' KV depends on
        ancestors), least-recently-used first, skipping blocks still
        attached to a live row. Installed as ``BlockAllocator.reclaimer``,
        so a dry free list drains idle cache before any allocation fails."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.stamp)
            for nd in leaves:
                if freed >= n:
                    break
                freed += self._evict(nd)
        return freed

    def flush(self) -> int:
        """Evict every evictable node (leak accounting: after all rows are
        released the pool is the only holder, so this returns the cache to
        the free list in full). Returns #blocks freed."""
        return self.reclaim(self.alloc.num_blocks)
