"""CacheOps: the cache surface behind the speculative round core
(port of ``repro/cache/ops.py``).

Only the paged layout is ported so far: ``init`` allocates a model's block
pools, ``write`` is the layer-level append the attention stack calls,
``rollback`` is the O(1) speculative rollback, ``live_bound`` is the
round-level live-token bound threaded into the block-scan reads, and
``compact`` moves a tree round's winner path into the committed tail. The
ring layout and ``spec`` (shape-only allocation) wait for the slices that
need them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.cache import paged_kv


class _PagedOps:
    """Shared block pool + per-row block tables (vLLM-style paging)."""
    kind = "paged"

    @staticmethod
    def init(model, batch, *, num_blocks, block_size, max_blocks_per_row,
             dtype=None, device=None):
        return model.init_paged_cache(batch, num_blocks, block_size,
                                      max_blocks_per_row, dtype=dtype,
                                      device=device)

    write = staticmethod(paged_kv.write)

    @staticmethod
    def rollback(cache, accepted_index):
        return paged_kv.rollback(cache, accepted_index)

    @staticmethod
    def live_bound(length, active=None) -> Optional[torch.Tensor]:
        # batch-max committed length over ACTIVE rows only: a finished row
        # keeps its final length but commits nothing and its blocks are
        # freed, so it must not drag the bound up. A 0-dim device tensor:
        # the kernels read it on the card, no host sync.
        if active is not None:
            return torch.max(torch.where(active, length, torch.ones_like(length)))
        return torch.max(length)

    @staticmethod
    def compact(cache, src_pos, dst_pos):
        return paged_kv.compact_positions(cache, cache["block_table"],
                                          src_pos, dst_pos)


PAGED = _PagedOps()


def ops_for(cache: Any):
    """Layout dispatch for a live cache dict (only paged caches so far)."""
    if not paged_kv.is_paged(cache):
        raise NotImplementedError("only paged KV caches are ported so far")
    return PAGED
