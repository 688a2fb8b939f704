"""One leaf held as pieces on several devices.

A tensor-parallel role keeps, for each sharded leaf of its params and
caches, one tensor per device of its model axis, in shard order: a
``Shards``. The cache modules read it through ``parts`` so that every
in-place operation (a write, a block copy, a compaction, a row's zeroing)
runs on every piece; nothing here imports the models or the caches.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True, eq=False)
class Shards:
    """``parts[i]`` is the piece on shard i's device. ``dim`` is the dim of
    the whole leaf the pieces split (None: each piece is a full copy), or
    the string "kv_heads" for k/v weights whose KV heads are replicated
    over several devices (``parallel.tp``)."""
    parts: tuple
    dim: object = None

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def __len__(self):
        return len(self.parts)


def parts(x) -> tuple:
    """The per-device tensors of a leaf: a ``Shards``' pieces, or the one
    tensor of an unsharded leaf."""
    return x.parts if isinstance(x, Shards) else (x,)


def is_sharded_cache(cache) -> bool:
    return isinstance(cache, dict) and isinstance(cache.get("k"), Shards)
