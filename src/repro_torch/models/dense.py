"""Dense (llama-style) decoder-only transformer: RMSNorm + GQA + RoPE + SwiGLU
(port of ``repro/models/dense.py``).

The JAX package stacks layer params on axis 0 and runs ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts and a Python loop runs
them, each layer reading and writing its slice ``cache["k"][l]`` of the
stacked buffers in place. Three forwards: the no-cache full-sequence pass
(the paper's no-cache mode; attention through ``attention_flash``), the
paged-cache pass and the ring-cache pass (each plain or tree-verify).

A ring cache is read through the paged kernel over a view of the ring as
a block pool: a layer's [B, W, Kv, D] buffer is the pool
[B * W / RING_PAGE, RING_PAGE, Kv, D], and the table runs over positions,
table[b, j] = b * W / RING_PAGE + (j mod W / RING_PAGE), so position p of
row b is read from slot p mod W, where the ring wrote it. A layer writes its
Q new tokens into the ring first, then reads it like a paged pool: the
kernel's causal mask hides slots past index + Q, and the model's window
(``cfg.sliding_window``, or a hybrid model's ``cfg.local_window``; not the
padded ring) hides slots that hold positions older than it. That is JAX's
[old buffer ++ new tokens] read over ``slot_positions`` whenever the write
evicts no key a query still sees:

  * a ring that holds every position (no window, or W >= the positions
    ``Model.init_cache`` was asked for) never wraps; the table is its
    identity view and Q <= W is all that is asked;
  * a windowed ring of W = window + slack slots (rounded up to RING_PAGE)
    is exact for Q <= W - window + 1, which the engines' slack gives every
    round (linear gamma + 1 against gamma + 2, a tree's span against span
    + 1, AR 1 against 2). This is decided from shapes: the rounds read
    nothing on the host;
  * a longer call is a prefill: it reads the index once. Nothing wraps if
    index + Q <= W; from index 0 with Q > W it is windowed causal attention
    over its own tokens (``attention_flash``: the flash kernel on the card),
    and the ring keeps the last W of them. Any other call raises.

An int8 ring stores each token quantized (``kv_cache._to_buf_dtype``). JAX
reads a Q = 1 call from the written, quantized buffer, but a Q > 1 call
from [dequantized old buffer ++ the call's K/V unquantized]. So a Q > 1
read of an int8 ring passes the call's K/V as ``fresh`` (``ring_fresh``):
the reader takes positions index..index+Q-1 from them, unquantized, and
every other key from the ring. That covers verify passes, tree spans,
prefills through the write route and chunked ring prefills; it is decided
from shapes and dtypes, so it reads nothing on the host. A paged pool is
read quantized at every Q, as JAX's ``paged_kv.write`` + ``attn_paged``
read it.

The table's width is the positions the ring was sized for (the cache's
``positions`` entry, a windowed ring's only extra leaf). A per-row engine
runs every row until the slowest is done (kept from JAX), so a finished
row goes on committing past that: the kernel and its plain version clamp
the live range to the table's blocks, its commits land past its length,
and its returned tokens are unchanged; only its length and acceptance
count go on growing, as in JAX.

API:
  init(cfg, gen, device)                           -> params
  forward(cfg, params, tokens, cache, ...)          -> logits, new_cache
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.cache.ops import PAGED, RING
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_flash, attention_paged,
                                          attention_tree)


# ---------------------------------------------------------------------- init
def init_attn(gen, cfg, device):
    d, hd = cfg.d_model, cfg.head_dim
    dt = cfg.weight_dtype
    return {
        "norm": L.init_rmsnorm(d, dt, device),
        "q": L.init_linear(gen, d, cfg.num_heads * hd, dt, device),
        "k": L.init_linear(gen, d, cfg.num_kv_heads * hd, dt, device),
        "v": L.init_linear(gen, d, cfg.num_kv_heads * hd, dt, device),
        "o": L.init_linear(gen, cfg.num_heads * hd, d, dt, device),
    }


def init_layer(gen, cfg, device):
    return {
        "attn": init_attn(gen, cfg, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.weight_dtype, device),
    }


def init(cfg, gen: torch.Generator, device):
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.weight_dtype, device,
                                  scale=cfg.embed_init_scale),
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.weight_dtype, device),
    }
    if cfg.tie_embeddings:
        params["embed"] = L.with_f32_table(params["embed"])
    else:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          cfg.weight_dtype, device)
    return params


# ------------------------------------------------------------------- forward
RING_PAGE = 16      # page size of a ring read as a block pool


def ring_view_table(B, W, device, positions=None):
    """[B, positions / RING_PAGE] int32 block table of a ring of W slots
    read as a pool of RING_PAGE-slot pages: row b's column j is page
    b * W / RING_PAGE + (j mod W / RING_PAGE), the page holding positions
    16j .. 16j + 15 once they are written. ``positions`` (a multiple of
    RING_PAGE; default W, the identity view) is how many positions the
    table reaches."""
    n = W // RING_PAGE
    cols = (positions or W) // RING_PAGE
    rows = torch.arange(B, dtype=torch.int32, device=device)[:, None] * n
    return rows + torch.remainder(
        torch.arange(cols, dtype=torch.int32, device=device), n)


def ring_view(buf):
    """A layer's ring buffer [B, W, Kv, D] as a block pool
    [B * W / RING_PAGE, RING_PAGE, Kv, D] (a view, no copy)."""
    return buf.view(-1, RING_PAGE, *buf.shape[2:])


def ring_fresh(layer_cache, k, v):
    """The ``fresh`` a ring read of the call's K/V ``k``/``v`` [B, Q, Kv, D]
    takes (see the module docstring): (k, v) for an int8 ring at Q > 1,
    else None."""
    if layer_cache["k"].dtype == torch.int8 and k.shape[1] > 1:
        return k.contiguous(), v.contiguous()
    return None


def attn_block(cfg, p, x, q_pos, layer_cache, index, window, block_table,
               max_live=None, tree=None, ring=None, use_rope=True):
    """Self-attention sub-block. ``layer_cache=None`` is the no-cache pass
    (q_pos = 0..Q-1 on both sides). Otherwise write this step's K/V into
    the cache (in place), then read it through ``block_table``: the pool's
    own table, or for a ring (``ring="write"``) its view's, with the
    call's own K/V read unquantized from an int8 ring at Q > 1
    (``ring_fresh``). ``ring=
    "flash"`` is a ring prefill from index 0 longer than the ring: windowed
    causal attention over the call's own tokens, then the write. ``tree``
    = (depths, bits) int32 [Q] device tensors marks a stacked tree-verify
    pass (core/tree.py): q_pos already carries the depth offsets, the KV
    lands at contiguous slots index..index+Q-1, and visibility follows each
    slot's ancestor bitmask. ``use_rope=False`` (the encoder-decoder's
    decoder) leaves q and k unrotated."""
    B, Q, _ = x.shape
    hd = cfg.head_dim
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    q = L.linear(p["q"], h).reshape(B, Q, cfg.num_heads, hd)
    k = L.linear(p["k"], h).reshape(B, Q, cfg.num_kv_heads, hd)
    v = L.linear(p["v"], h).reshape(B, Q, cfg.num_kv_heads, hd)
    if use_rope:
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
    if layer_cache is None or ring == "flash":
        o = attention_flash(q, k, v, window=window)
        if layer_cache is not None:
            RING.write(layer_cache, k, v, index)
        return L.linear(p["o"], o.reshape(B, Q, cfg.num_heads * hd))
    fresh = None
    if ring:
        fresh = ring_fresh(layer_cache, k, v)
        layer_cache = RING.write(layer_cache, k, v, index)
        k_pool, v_pool = ring_view(layer_cache["k"]), ring_view(layer_cache["v"])
    else:
        layer_cache = PAGED.write(layer_cache, k, v, block_table, index)
        k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    if tree is not None:
        o = attention_tree(q, k_pool, v_pool, block_table, index, tree[0],
                           tree[1], window=window, max_live=max_live,
                           fresh=fresh)
    else:
        o = attention_paged(q, k_pool, v_pool, block_table, index,
                            window=window, max_live=max_live, fresh=fresh)
    return L.linear(p["o"], o.reshape(B, Q, cfg.num_heads * hd))


def dense_layer(cfg, p, x, q_pos, layer_cache, index, block_table,
                max_live=None, tree=None, ring=None):
    x = x + attn_block(cfg, p["attn"], x, q_pos, layer_cache, index,
                       cfg.sliding_window, block_table, max_live, tree, ring)
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


def ring_read(window, cache, Q, tree=None):
    """How a forward of Q tokens reads the ring ``cache`` of a model whose
    attention is windowed by ``window`` (None: full causal; see the module
    docstring): ("write", table) writes first and reads through the table,
    ("flash", table) is a prefill from index 0 longer than the ring. Rounds
    are decided from shapes; only a call past W - window + 1 tokens reads
    the index on the host. Raises on a call that would evict a key inside
    the window."""
    B, W = cache["k"].shape[1], cache["k"].shape[2]
    if W % RING_PAGE:
        raise ValueError(f"a ring buffer's length must be a multiple of "
                         f"{RING_PAGE} (Model.init_cache rounds it), got {W}")
    positions = cache.get("positions", W)
    dev = cache["k"].device
    table = ring_view_table(B, W, dev, positions)
    if positions <= W:
        if Q > W:
            raise NotImplementedError(f"{Q} tokens would wrap a ring of {W} "
                                      "slots")
        return "write", table
    if window is None:
        raise ValueError(f"a ring of {W} slots for {positions} positions "
                         "needs a sliding window")
    if Q <= W - window + 1:
        return "write", table
    first = int(cache["index"].max())
    if first + Q <= W:
        return "write", table
    if first == 0 and tree is None:
        return "flash", table
    raise ValueError(f"{Q} tokens from position {first} would evict keys "
                     f"inside the window of {window} from a ring of {W} slots")


class Pass(NamedTuple):
    """What every layer of one forward shares: the query positions, the
    cache's index and block table (a ring's view table), the paged read's
    live bound, the tree masks and how a ring is read (``ring_read``)."""
    q_pos: torch.Tensor
    index: Optional[torch.Tensor]
    block_table: Optional[torch.Tensor]
    max_live: object
    tree: Optional[tuple]
    ring: Optional[str]


def begin(cfg, params, tokens, cache, window, max_live=None, tree=None,
          input_embeds=None):
    """Embed ``tokens`` (or take ``input_embeds`` [B, Q, D]) and settle how
    the forward reads ``cache``, whose attention is windowed by
    ``window``: (x, Pass). Shared by the dense, MoE, hybrid, VLM and
    encoder-decoder forwards."""
    if cache is None and tree is not None:
        raise ValueError("a tree-verify pass needs a cache")
    x = input_embeds if input_embeds is not None \
        else L.embed(params["embed"], tokens)
    x = x.to(cfg.act_dtype)
    Q = x.shape[1]
    ring = None
    if tree is not None:
        tree = tuple(torch.as_tensor(t, dtype=torch.int32, device=x.device)
                     for t in tree)
        offs = tree[0]
    else:
        offs = torch.arange(Q, dtype=torch.int32, device=x.device)
    if cache is None:
        return x, Pass(offs, None, None, max_live, tree, None)
    index = cache["index"]
    if "block_table" not in cache:
        ring, block_table = ring_read(window, cache, Q, tree)
        max_live = None
    else:
        block_table = cache["block_table"]
    # index: scalar (shared) or [B] (per-row batched speculation)
    q_pos = index[..., None] + offs if index.ndim else index + offs
    return x, Pass(q_pos, index, block_table, max_live, tree, ring)


def layer_cache(cache, l):
    """Layer l's slice of the stacked K/V buffers (None without a cache)."""
    return None if cache is None else {"k": cache["k"][l], "v": cache["v"][l]}


def run_layer(cfg, lp, x, lc, ps: Pass):
    return dense_layer(cfg, lp, x, ps.q_pos, lc, ps.index, ps.block_table,
                       ps.max_live, ps.tree, ps.ring)


def end(cfg, params, x, cache, logits_slice=None, text_from=0):
    """Final norm and unembedding: (logits, the cache advanced past the
    forward's tokens, or None without one). ``text_from`` unembeds only
    positions from there on (the VLM's text after its vision prefix; the
    rows are normed and unembedded one by one, so this is the slice of
    the whole logits)."""
    Q = x.shape[1]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    elif text_from:
        x = x[:, text_from:]
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = L.linear(params["lm_head"], x.float())
    if cache is None:
        return logits, None
    return logits, {**cache, "index": cache["index"] + Q}


def forward(cfg, params, tokens, cache, *, logits_slice=None, max_live=None,
            tree=None, input_embeds=None, text_from=0):
    """tokens: [B, Q] int (or ``input_embeds`` [B, Q, D], the VLM's vision
    prefix and text; ``text_from`` then unembeds only the text, see
    ``end``).
    cache=None: full-sequence causal pass (the paper's no-cache mode);
    returns (logits, None).
    cache=dict: a paged or ring cache; Q new tokens are written at
    ``cache["index"]`` and the returned cache (same buffers) has index + Q.
    logits_slice: "last" unembeds only the final position (decode fast-path).
    max_live: paged caches only — live-token bound for the block-scan read
    (None derives it from the index); a 0-dim device tensor keeps the round
    free of host syncs. A ring read is bounded by each row's index + Q.
    tree: (depths, bits) int32 [Q] — a stacked tree-verify pass
    (core/tree.py): RoPE positions become index + depths and attention
    follows the ancestor bitmasks. They become device tensors once here,
    not once per layer."""
    x, ps = begin(cfg, params, tokens, cache, cfg.sliding_window, max_live,
                  tree, input_embeds)
    for l, lp in enumerate(params["layers"]):
        if cache is None:     # checkpointed under cfg.remat, as JAX's scan
            x = L.maybe_remat(lambda h, lp=lp: run_layer(cfg, lp, h, None, ps),
                              cfg)(x)
        else:
            x = run_layer(cfg, lp, x, layer_cache(cache, l), ps)
    return end(cfg, params, x, cache, logits_slice, text_from)
