"""GQA attention with causal / sliding-window masking: the no-cache paths
and the paged read paths (port of ``repro/models/attention.py`` without the
ring-cache tree path).

No cache: ``attn_dense`` materialises the [B, Kv, G, Q, S] scores,
``attn_chunked`` walks KV chunks with an online softmax, and ``attention``
picks between them by the KV length (dense up to ``2 * chunk``), as JAX
does. They are the plain versions. ``attention_flash`` is the dispatch the
no-cache forward (and the encoder-decoder's non-causal attention) calls,
for positions counted from 0 on both sides: a CPU tensor takes
``attention``, a CUDA tensor the flash kernel
(``repro_torch.kernels.flash_attention``), whose plain version is
``attn_dense``.

Paged: ``attn_paged`` is the plain version, a loop over KV *blocks*
fetched through the block table with an online softmax, stopping at the
batch-max live block. ``attention_paged`` is the dispatch the model calls:
the tensor's device decides — a CPU tensor takes ``attn_paged``, a CUDA
tensor the kernel (``repro_torch.kernels.paged_attention``).
``attn_tree`` / ``attention_tree`` are the same pair for a stacked
tree-verify span, with the causal mask replaced by ``_tree_mask``.

Ring cache: the dense forward reads a ring buffer through the paged pair
above, over a view of the ring as a pool of pages (``models.dense``).
``attn_tree_ring`` is JAX's plain tree read over a ring (dense scores with
the ``_tree_mask`` visibility), the reference that read is held against.

``fresh = (k_new, v_new)`` ([B, Q, Kv, D], q's dtype), taken by every
paged and tree reader, overlays the call's own K/V on the pool: a key at
position p with index[b] <= p < index[b] + Q is read from
``fresh[b, p - index[b]]`` instead of from the pool, every other key as
``_from_buf(pool, q.dtype)``. The dense forward passes it for a Q > 1 read
of an int8 ring, so the call's own keys are read unquantized, as JAX's
[old buffer ++ new tokens] concat reads them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.cache.kv_cache import _from_buf

NEG_INF = -1e30  # large-but-finite; avoids NaNs from (-inf) - (-inf)


def _mask(q_pos, kv_pos, window, causal=True):
    """Boolean mask [Q,S] (shared positions) or [B,Q,S] (per-row positions):
    causal (or not) + optional sliding window."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = (qp >= kp) if causal else torch.ones(
        torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
        device=qp.device)
    if window is not None:
        m = m & (torch.abs(qp - kp) < window)
    m = m & (kp >= 0)  # invalid cache slots carry position -1
    return m


def _expand_mask(m):
    """[Q,S] -> [1,1,1,Q,S]; [B,Q,S] -> [B,1,1,Q,S] (scores are [B,Kv,G,Q,S])."""
    if m.ndim == 2:
        return m[None, None, None]
    return m[:, None, None]


def _gqa_scores(q, k):
    """q:[B,Q,H,D] k:[B,S,Kv,D] -> [B,Kv,H/Kv,Q,S] fp32."""
    B, Q, H, D = q.shape
    Kv = k.shape[2]
    q = q.reshape(B, Q, Kv, H // Kv, D)
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def attn_dense(q, k, v, q_pos, kv_pos, *, window=None, scale=None,
               causal=True, mask=None):
    """q:[B,Q,H,D] k,v:[B,S,Kv,D] positions int32 -> [B,Q,H,D].
    ``mask`` overrides the causal/window mask (the tree path builds its
    ancestor-bitmask visibility explicitly)."""
    B, Q, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s = _gqa_scores(q, k) * scale                             # [B,Kv,G,Q,S]
    m = mask if mask is not None else _mask(q_pos, kv_pos, window, causal)
    s = torch.where(_expand_mask(m), s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Q, H, D).to(q.dtype)


def _online_carry(B, Kv, G, Q, D, device):
    return (torch.zeros((B, Kv, G, Q, D), dtype=torch.float32, device=device),
            torch.full((B, Kv, G, Q), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((B, Kv, G, Q), dtype=torch.float32, device=device))


def _online_step(carry, qf, k_i, v_i, q_pos, kv_pos, window, scale,
                 causal=True, mask=None):
    """One online-softmax update over a KV slab — the shared inner step of
    attn_chunked and attn_paged (the recurrence the CUDA kernels implement
    in shared memory). ``mask`` overrides the causal/window mask
    (tree-speculation visibility)."""
    acc, mx, den = carry
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_i.float()) * scale
    m = mask if mask is not None else _mask(q_pos, kv_pos, window, causal)
    s = torch.where(_expand_mask(m), s, torch.full_like(s, NEG_INF))
    mx_new = torch.maximum(mx, s.amax(dim=-1))
    alpha = torch.exp(mx - mx_new)
    p = torch.exp(s - mx_new[..., None])
    den = den * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                v_i.float())
    return acc, mx_new, den


def _online_emit(acc, den, B, Q, H, D, dtype):
    o = acc / torch.clamp(den, min=1e-30)[..., None]          # [B,Kv,G,Q,D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Q, H, D).to(dtype)


def attn_chunked(q, k, v, q_pos, kv_pos, *, window=None, scale=None,
                 chunk=512, causal=True):
    """Online-softmax attention over KV chunks. Same semantics as
    attn_dense; the padded tail carries position -1 (never visible)."""
    B, Q, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    qf = q.reshape(B, Q, Kv, H // Kv, D).float()
    carry = _online_carry(B, Kv, H // Kv, Q, D, q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry = _online_step(carry, qf, k[:, sl], v[:, sl], q_pos,
                             kv_pos[sl], window, scale, causal)
    acc, _, den = carry
    return _online_emit(acc, den, B, Q, H, D, q.dtype)


def attention(q, k, v, q_pos, kv_pos, *, window=None, scale=None, chunk=512,
              causal=True):
    """Dispatch: dense path for short KV, chunked for long KV."""
    if k.shape[1] <= 2 * chunk:
        return attn_dense(q, k, v, q_pos, kv_pos, window=window, scale=scale,
                          causal=causal)
    return attn_chunked(q, k, v, q_pos, kv_pos, window=window, scale=scale,
                        chunk=chunk, causal=causal)


def attention_flash(q, k, v, *, window=None, causal=True):
    """No-cache attention dispatch, for query positions 0..Sq-1 and key
    positions 0..Skv-1 (the no-cache forward: causal, Sq = Skv; the
    encoder's self-attention and the decoder's cross-attention:
    ``causal=False``, where positions do not matter): a CPU tensor takes
    ``attention``, a CUDA tensor the flash kernel (see
    ``repro_torch.kernels.ops.flash_attention``)."""
    if q.device.type == "cpu":
        q_pos = torch.arange(q.shape[1], dtype=torch.int32)
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32)
        return attention(q, k, v, q_pos, kv_pos, window=window, causal=causal)
    from repro_torch.kernels import ops
    return ops.flash_attention(q, k, v, window=window, causal=causal)


# ------------------------------------------------------------- paged read path
def _overlay(kv_j, fresh_kv, idx, kv_pos):
    """Block ``kv_j`` [B, BS, Kv, D] (positions ``kv_pos`` [BS]) with the
    keys at idx[b] <= p < idx[b] + Q taken from ``fresh_kv`` [B, Q, Kv, D]
    (see the module docstring)."""
    Q = fresh_kv.shape[1]
    rel = kv_pos[None, :] - idx[:, None]                           # [B, BS]
    rows = torch.arange(kv_j.shape[0], device=kv_j.device)[:, None]
    src = fresh_kv[rows, torch.clamp(rel, 0, Q - 1).long()]
    return torch.where(((rel >= 0) & (rel < Q))[..., None, None], src, kv_j)


def _read_block(k_pool, v_pool, blk, dtype, fresh, idx, kv_pos):
    """Block ``blk`` [B] of the pools as ``dtype`` (dequantized from int8),
    with ``fresh`` overlaid when given."""
    k_j = _from_buf(k_pool[blk], dtype)                            # [B, BS, Kv, D]
    v_j = _from_buf(v_pool[blk], dtype)
    if fresh is not None:
        k_j = _overlay(k_j, fresh[0], idx, kv_pos)
        v_j = _overlay(v_j, fresh[1], idx, kv_pos)
    return k_j, v_j


def attn_paged(q, k_pool, v_pool, block_table, index, *, window=None,
               scale=None, max_live=None, fresh=None):
    """Block-table-native attention over a paged KV pool (plain version).

    q:            [B, Q, H, D] queries at absolute positions index..index+Q-1
                  (already written into the pool by ``paged_kv.write``).
    k_pool/v_pool:[NB, BS, Kv, D] this layer's block pool, post-write.
    block_table:  [B, MB] int32 row -> pool block ids (NULL block = 0).
    index:        [B] (or scalar) committed tokens per row BEFORE this write.
    max_live:     optional live-token bound (max over rows of index+Q); when
                  None it is computed from ``index``.
    fresh:        optional (k_new, v_new) [B, Q, Kv, D] in q's dtype, read in
                  place of the pool at positions index..index+Q-1.

    The loop runs ``ceil(max_live / BS)`` block steps, not ``MB``. The loop
    count is read on the host, so on a CUDA tensor this version syncs once
    per call; it runs on the card only to be compared with the kernel.
    """
    B, Q, H, D = q.shape
    BS, Kv = k_pool.shape[1], k_pool.shape[2]
    MB = block_table.shape[1]
    G = H // Kv
    scale = scale if scale is not None else D ** -0.5
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    if idx.ndim == 0:
        idx = idx.expand(B)
    ar = torch.arange(Q, dtype=torch.int32, device=q.device)
    q_pos = idx[:, None] + ar                                      # [B, Q]
    live = int(idx.max()) + Q if max_live is None else int(max_live)
    n_blocks = min(max((live + BS - 1) // BS, 1), MB)

    qf = q.reshape(B, Q, Kv, G, D).float()
    carry = _online_carry(B, Kv, G, Q, D, q.device)
    table = block_table.long()
    for j in range(n_blocks):
        kv_pos = j * BS + torch.arange(BS, dtype=torch.int32, device=q.device)
        k_j, v_j = _read_block(k_pool, v_pool, table[:, j], q.dtype, fresh,
                               idx, kv_pos)
        carry = _online_step(carry, qf, k_j, v_j, q_pos, kv_pos, window, scale)
    acc, _, den = carry
    return _online_emit(acc, den, B, Q, H, D, q.dtype)


def attention_paged(q, k_pool, v_pool, block_table, index, *, window=None,
                    scale=None, max_live=None, fresh=None):
    """Paged-attention dispatch: the tensor's device decides — the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor (see
    ``repro_torch.kernels.ops.paged_attention``)."""
    from repro_torch.kernels import ops
    return ops.paged_attention(q, k_pool, v_pool, block_table, index,
                               window=window, scale=scale, max_live=max_live,
                               fresh=fresh)


# -------------------------------------------------------------- tree read path
def _tree_mask(idx, kv_pos, depths, bits, window):
    """[B, span, S] visibility for one stacked tree-verify pass.

    Query slot ``s`` sits at RoPE position ``idx + depths[s]``; its KV row is
    physically written at cache slot ``idx + s``. Visibility:

      * committed prefix (kv_pos < idx): ordinary causal (+ window vs the
        query's RoPE position);
      * in-span slot t (idx <= kv_pos < idx + span): visible iff bit t of the
        query's ancestor mask is set — i.e. only along the query's own
        root path (+ window over the depth gap);
      * beyond the span: stale slots, never visible.
    """
    span = depths.shape[0]
    if kv_pos.ndim == 1:                                         # [S] shared
        kv_pos = kv_pos[None, :].expand(idx.shape[0], kv_pos.shape[0])
    rel = kv_pos - idx[:, None]                                  # [B, S]
    ar = torch.arange(span, dtype=torch.int32, device=idx.device)
    span_vis = ((bits[:, None] >> ar[None, :]) & 1) > 0          # [span, span]
    if window is not None:
        span_vis = span_vis & ((depths[:, None] - depths[None, :]) < window)
    prefix = (rel < 0)[:, None, :] & (kv_pos >= 0)[:, None, :]
    if window is not None:
        q_pos = idx[:, None] + depths[None, :]
        prefix = prefix & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    relc = torch.clamp(rel, 0, span - 1).long()
    # span_vis[:, relc]: [span, B, S] -> [B, span, S]
    inspan = span_vis[:, relc].permute(1, 0, 2)
    inspan = inspan & ((rel >= 0) & (rel < span))[:, None, :]
    return prefix | inspan


def attn_tree_ring(q, k, v, index, depths, bits, *, window=None, scale=None):
    """Tree-verify attention over a ring cache (plain version).

    q: [B, span, H, D], the packed [root, node_1..node_N] verify span, whose
    KV was just written at contiguous slots index..index+span-1 of the
    ring buffers k/v [B, W, Kv, D] (a ring that has not wrapped: slot s
    holds position s)."""
    B = q.shape[0]
    S = k.shape[1]
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    if idx.ndim == 0:
        idx = idx.expand(B)
    depths = torch.as_tensor(depths, dtype=torch.int32, device=q.device)
    bits = torch.as_tensor(bits, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    m = _tree_mask(idx, kv_pos, depths, bits, window)
    q_pos = idx[:, None] + depths[None, :]
    return attn_dense(q, k, v, q_pos, kv_pos, window=window, scale=scale,
                      mask=m)


def attn_tree(q, k_pool, v_pool, block_table, index, depths, bits, *,
              window=None, scale=None, max_live=None, fresh=None):
    """Tree-verify attention over a paged block pool (plain version).

    Same block-bounded online-softmax loop as ``attn_paged``, with the
    causal mask replaced by ``_tree_mask``: the span slots written at
    index..index+span-1 are only visible along each query's root path.
    q: [B, span, H, D]; depths/bits: int32 [span] (``core.tree``);
    ``fresh`` as for ``attn_paged`` (the span's slots). Like ``attn_paged``,
    it reads its loop count on the host."""
    B, S, H, D = q.shape                                        # S = span
    BS, Kv = k_pool.shape[1], k_pool.shape[2]
    MB = block_table.shape[1]
    G = H // Kv
    scale = scale if scale is not None else D ** -0.5
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    if idx.ndim == 0:
        idx = idx.expand(B)
    live = int(idx.max()) + S if max_live is None else int(max_live)
    n_blocks = min(max((live + BS - 1) // BS, 1), MB)
    depths = torch.as_tensor(depths, dtype=torch.int32, device=q.device)
    bits = torch.as_tensor(bits, dtype=torch.int32, device=q.device)
    q_pos = idx[:, None] + depths[None, :]

    qf = q.reshape(B, S, Kv, G, D).float()
    carry = _online_carry(B, Kv, G, S, D, q.device)
    table = block_table.long()
    for j in range(n_blocks):
        kv_pos = j * BS + torch.arange(BS, dtype=torch.int32, device=q.device)
        k_j, v_j = _read_block(k_pool, v_pool, table[:, j], q.dtype, fresh,
                               idx, kv_pos)
        m = _tree_mask(idx, kv_pos, depths, bits, window)
        carry = _online_step(carry, qf, k_j, v_j, q_pos, kv_pos, window,
                             scale, mask=m)
    acc, _, den = carry
    return _online_emit(acc, den, B, S, H, D, q.dtype)


def attention_tree(q, k_pool, v_pool, block_table, index, depths, bits, *,
                   window=None, scale=None, max_live=None, fresh=None):
    """Tree-attention dispatch: the tensor's device decides — the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor (see
    ``repro_torch.kernels.ops.tree_attention``)."""
    from repro_torch.kernels import ops
    return ops.tree_attention(q, k_pool, v_pool, block_table, index, depths,
                              bits, window=window, scale=scale,
                              max_live=max_live, fresh=fresh)
