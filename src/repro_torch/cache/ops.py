"""CacheOps: the cache surface behind the speculative round core
(port of ``repro/cache/ops.py``).

Both layouts, the ring buffer (``kv_cache.py``) and the paged block pool
(``paged_kv.py``), implement one small protocol, so the round core and the
engines are generic over layout: ``init`` allocates a model's buffers,
``write`` is the layer-level append the attention stack calls (in place on
both layouts: the read side is the block-table-native kernel, over the
pool or over a view of the ring as a pool of pages), ``rollback`` is the O(1)
speculative rollback (an index change, which a sharded cache's pieces
share), ``live_bound`` the round-level live-token bound
threaded into the paged block-scan reads (None for a ring: the kernel
bounds each row by its own index), and ``compact`` moves a tree round's
winner path into the committed tail. A tensor-parallel role's cache
(``parallel.tp``) holds ``k``/``v`` as ``Shards``, one piece per device;
``init`` takes its ``layout``, and every in-place operation runs on every
piece (``parallel.shards.parts``). JAX's ``spec`` (shape-only
allocation) has no counterpart.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.cache import kv_cache, paged_kv


class _RingOps:
    """Per-row ring buffers: [L, B, W, Kv, D], token p in slot p % W."""
    kind = "ring"

    @staticmethod
    def init(model, batch, *, max_len, spec_slack=8, dtype=None, device=None,
             layout=None):
        return model.init_cache(batch, model.cache_len(max_len),
                                spec_slack=spec_slack, dtype=dtype,
                                device=device, layout=layout)

    @staticmethod
    def write(layer_cache, k_new, v_new, index):
        """Write this step's K/V into the layer's ring buffers, in place;
        returns ``layer_cache``."""
        kv_cache.write(layer_cache["k"], layer_cache["v"], k_new, v_new, index)
        return layer_cache

    @staticmethod
    def rollback(cache, accepted_index):
        return kv_cache.rollback(cache, accepted_index)

    @staticmethod
    def live_bound(length, active=None):
        return None                      # position masking; no read bound

    @staticmethod
    def compact(cache, src_pos, dst_pos):
        return kv_cache.compact_positions(cache, src_pos, dst_pos)


class _PagedOps:
    """Shared block pool + per-row block tables (vLLM-style paging)."""
    kind = "paged"

    @staticmethod
    def init(model, batch, *, num_blocks, block_size, max_blocks_per_row,
             dtype=None, device=None, layout=None):
        return model.init_paged_cache(batch, num_blocks, block_size,
                                      max_blocks_per_row, dtype=dtype,
                                      device=device, layout=layout)

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


RING = _RingOps()
PAGED = _PagedOps()


def ops_for(cache: Any):
    """Layout dispatch for a live cache dict (None -> ring: the no-cache
    paths never touch rollback/live_bound, and ring is the benign
    default)."""
    return PAGED if paged_kv.is_paged(cache) else RING
