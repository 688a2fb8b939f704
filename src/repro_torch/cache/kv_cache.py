"""KV buffer dtype helpers (port of part of ``repro/cache/kv_cache.py``).

Only the two conversions the paged pool uses are ported so far; the ring
cache (``init_cache``/``write``/``extend``/``rollback``/
``compact_positions``) waits for the slice that ports the no-cache and
ring-cache forward.
"""
from __future__ import annotations

import torch

KV_INT8_SCALE = 0.05   # fixed symmetric scale for int8 KV buffers


def _to_buf_dtype(x, dtype):
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() / KV_INT8_SCALE),
                           -128, 127).to(torch.int8)
    return x.to(dtype)


def _from_buf(x, out_dtype):
    if x.dtype == torch.int8:
        return (x.float() * KV_INT8_SCALE).to(out_dtype)
    return x
