"""Ring-buffer KV cache with O(1) speculative rollback (port of
``repro/cache/kv_cache.py``).

Layout: one buffer per layer stack, stacked on a leading layer axis like
the port's paged pools:

  cache = {
    "k": [L, B, W, Kv, D],   # W = buffer length (= max_len, or window for SWA)
    "v": [L, B, W, Kv, D],
    "index": int32 0-dim or [B]   # committed tokens (shared by layers)
    "positions": int   # only on a windowed ring with fewer slots than the
  }                    # positions asked for: how far its read table reaches

Token at absolute position p lives in slot p % W. Attention masks on
positions, so rolling back rejected speculative tokens is just a smaller
index: stale slots past it are masked.

``write`` updates the buffers in place (JAX returns new buffers), as
``paged_kv.write`` does; ``compact_positions`` too. ``extend`` is JAX's
read-view form of a layer write ([old buffer ++ new tokens] with their
positions): the dense forward writes first and reads the buffer through
the paged kernel instead (``models.dense``), and ``extend`` stays as the
reference that read is held against. JAX's ``cache_spec`` (shape-only
allocation) has no counterpart here. A tensor-parallel role's ring holds
``k``/``v`` as ``parallel.shards.Shards`` (one buffer per device, its KV
heads); ``compact_positions`` moves every piece.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.shards import parts

KV_INT8_SCALE = 0.05   # fixed symmetric scale for int8 KV buffers


def buffer_len(max_len: int, window: Optional[int]) -> int:
    return max_len if window is None else min(max_len, window)


def init_cache(num_layers, batch, max_len, num_kv_heads, head_dim,
               window=None, dtype=torch.bfloat16, device=None):
    W = buffer_len(max_len, window)
    shape = (num_layers, batch, W, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def _index(index, device):
    return torch.as_tensor(index, dtype=torch.int32, device=device)


def slot_positions(W: int, index, new_len: int, device=None):
    """Absolute position stored in each of the W slots AFTER writing
    ``new_len`` tokens starting at ``index``; slots never written hold -1.
    ``index`` 0-dim -> [W]; [B] -> [B, W]."""
    index = _index(index, device)
    last = index + new_len - 1                         # newest absolute position
    s = torch.arange(W, dtype=torch.int32, device=index.device)
    # newest position congruent to slot s that is <= last
    p = last[..., None] - torch.remainder(last[..., None] - s, W)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def _to_buf_dtype(x, dtype):
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() / KV_INT8_SCALE),
                           -128, 127).to(torch.int8)
    return x.to(dtype)


def _from_buf(x, out_dtype):
    if x.dtype == torch.int8:
        return (x.float() * KV_INT8_SCALE).to(out_dtype)
    return x


def write(k_buf, v_buf, k_new, v_new, index):
    """Write k_new/v_new ([B, Q, Kv, D]) at absolute positions
    index..index+Q-1 (``index`` 0-dim or [B]) into ring buffers
    ([B, W, Kv, D]), in place. When Q >= W only the last W tokens are
    kept. Returns the same buffers."""
    B, W = k_buf.shape[0], k_buf.shape[1]
    Q = k_new.shape[1]
    index = _index(index, k_buf.device)
    if Q >= W:
        k_new, v_new = k_new[:, -W:], v_new[:, -W:]
        index, Q = index + (Q - W), W
    ar = torch.arange(Q, dtype=torch.int32, device=k_buf.device)
    if index.ndim == 1:
        # per-row indices (batched speculation): scatter per row
        slots = torch.remainder(index[:, None] + ar, W).long()   # [B, Q]
        rows = torch.arange(B, device=k_buf.device)[:, None]
        k_buf[rows, slots] = _to_buf_dtype(k_new, k_buf.dtype)
        v_buf[rows, slots] = _to_buf_dtype(v_new, v_buf.dtype)
    else:
        slots = torch.remainder(index + ar, W).long()
        k_buf[:, slots] = _to_buf_dtype(k_new, k_buf.dtype)
        v_buf[:, slots] = _to_buf_dtype(v_new, v_buf.dtype)
    return k_buf, v_buf


def extend(layer_cache, k_new, v_new, index):
    """JAX's per-layer extension: returns (k_all, v_all, kv_pos,
    new_layer_cache), attention's read view and the written buffers.

    layer_cache: {"k": [B,W,Kv,D], "v": [B,W,Kv,D]}. For Q > 1 the view is
    [old buffer ++ new tokens], copied before the (in-place) write, because
    a ring write of Q > 1 tokens can evict positions earlier queries of the
    same extension still need; Q = 1 reads the written buffer."""
    W = layer_cache["k"].shape[1]
    Q = k_new.shape[1]
    index = _index(index, k_new.device)
    if Q == 1:
        k_buf, v_buf = write(layer_cache["k"], layer_cache["v"], k_new, v_new,
                             index)
        return (_from_buf(k_buf, k_new.dtype), _from_buf(v_buf, v_new.dtype),
                slot_positions(W, index, 1), {"k": k_buf, "v": v_buf})
    old_pos = slot_positions(W, index, 0)                  # positions before write
    k_all = torch.cat([_from_buf(layer_cache["k"], k_new.dtype), k_new], dim=1)
    v_all = torch.cat([_from_buf(layer_cache["v"], v_new.dtype), v_new], dim=1)
    new_pos = index[..., None] + torch.arange(Q, dtype=torch.int32,
                                              device=index.device)
    kv_pos = torch.cat([old_pos, new_pos], dim=-1)
    k_buf, v_buf = write(layer_cache["k"], layer_cache["v"], k_new, v_new, index)
    return k_all, v_all, kv_pos, {"k": k_buf, "v": v_buf}


def rollback(cache, accepted_index):
    """O(1) speculative rollback: drop everything after ``accepted_index``."""
    return {**cache, "index": _index(accepted_index, cache["index"].device)}


def compact_positions(cache, src_pos, dst_pos):
    """Tree-verify commit-by-compaction, ring flavour, in place: copy the
    KV stored at absolute positions ``src_pos`` to ``dst_pos`` ([B, P]
    each) across every layer. Positions resolve to slots mod W; the gather
    (advanced indexing, which copies) completes before the scatter, so
    overlapping moves are safe."""
    W = parts(cache["k"])[0].shape[2]
    B = src_pos.shape[0]
    rows = torch.arange(B, device=src_pos.device)[:, None]
    s = torch.remainder(src_pos.long(), W)
    d = torch.remainder(dst_pos.long(), W)
    for name in ("k", "v"):
        for buf in parts(cache[name]):     # every piece of a sharded ring
            dev = buf.device
            moved = buf[:, rows.to(dev), s.to(dev)]        # [L, B, P, Kv, D]
            buf[:, rows.to(dev), d.to(dev)] = moved
    return cache
