"""Model API (port of ``repro/models/model.py``: the dense family, and the
ssm family with no cache).

  model = build_model(cfg)
  params = model.init(seed, device)
  logits, cache, aux = model.apply(params, tokens, cache, **kw)
  logits, _, _ = model.apply(params, tokens)       # no-cache full pass
  cache = model.init_paged_cache(batch, num_blocks, block_size, max_blocks_per_row)

``init`` and ``init_paged_cache`` allocate on ``cuda`` unless the caller
passes ``device="cpu"``. The ssm family (Mamba-2) runs the no-cache pass
only: its cached pass and ``init_paged_cache`` raise (its state and conv
caches, trails and rollback come with a later slice; JAX has no paged
cache for it either). The other families and the ring cache wait for later
slices.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import device as devices
from repro_torch.cache import paged_kv
from repro_torch.models import dense, ssm

FAMILIES = {"dense": dense, "ssm": ssm}


def _ssm_cache_later():
    return NotImplementedError(
        "the ssm family runs without a cache only: its cached pass (state "
        "and conv caches, trails, rollback) comes with a later slice")


class Model:
    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet "
                f"(ported: {sorted(FAMILIES)})")
        self.cfg = cfg
        self.family = cfg.family

    def init(self, seed: Union[int, torch.Generator], device=None):
        """Seeded random weights. ``seed`` is an int or a torch.Generator
        on ``device``."""
        dev = devices.resolve(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return FAMILIES[self.family].init(self.cfg, gen, dev)

    def apply(self, params, tokens, cache=None, *, logits_slice=None,
              max_live=None, tree=None):
        """``cache=None`` runs the no-cache full-sequence pass and returns
        (logits, None, {}). ``tree`` = (depths, bits) int32 [Q] runs a
        stacked tree-verify pass (``core.tree``; dense family, paged
        cache)."""
        if self.family == "ssm":
            if cache is not None:
                raise _ssm_cache_later()
            if tree is not None:
                raise NotImplementedError(
                    f"tree-verify passes need a dense-family target (got {self.family!r})")
            logits, _ = ssm.forward(self.cfg, params, tokens,
                                    logits_slice=logits_slice)
            return logits, None, {}
        logits, new_cache = dense.forward(self.cfg, params, tokens, cache,
                                          logits_slice=logits_slice,
                                          max_live=max_live, tree=tree)
        return logits, new_cache, {}

    def init_paged_cache(self, batch, num_blocks, block_size,
                         max_blocks_per_row, dtype: Optional[torch.dtype] = None,
                         device=None):
        """Block-pool KV cache for ragged continuous batching."""
        if self.family == "ssm":
            raise _ssm_cache_later()
        cfg = self.cfg
        return paged_kv.init_cache(cfg.num_layers, batch, num_blocks,
                                   block_size, max_blocks_per_row,
                                   cfg.num_kv_heads, cfg.head_dim,
                                   dtype or cfg.act_dtype,
                                   devices.resolve(device))


def build_model(cfg) -> Model:
    return Model(cfg)
