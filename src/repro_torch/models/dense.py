"""Dense (llama-style) decoder-only transformer: RMSNorm + GQA + RoPE + SwiGLU
(port of the no-cache and paged paths of ``repro/models/dense.py``).

The JAX package stacks layer params on axis 0 and runs ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts and a Python loop runs
them, each layer reading and writing its slice ``cache["k"][l]`` of the
stacked pools in place. Two forwards are ported: the no-cache full-sequence
pass (the paper's no-cache mode; attention through ``attention_flash``) and
the paged-cache pass (plain and tree-verify). The ring-cache branch waits
for a later slice.

API:
  init(cfg, gen, device)                           -> params
  forward(cfg, params, tokens, cache, ...)          -> logits, new_cache
"""
from __future__ import annotations

import torch

from repro_torch.cache.ops import PAGED
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
def attn_block(cfg, p, x, q_pos, layer_cache, index, window, block_table,
               max_live=None, tree=None):
    """Self-attention sub-block. ``layer_cache=None`` is the no-cache pass
    (q_pos = 0..Q-1 on both sides). Otherwise, over a paged pool: write
    this step's K/V into the pool (in place), then read it through the
    block table. ``tree`` = (depths, bits) int32 [Q] device tensors marks a
    stacked tree-verify pass (core/tree.py): q_pos already carries the
    depth offsets, the KV lands at contiguous slots index..index+Q-1, and
    visibility follows each slot's ancestor bitmask."""
    B, Q, _ = x.shape
    hd = cfg.head_dim
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    q = L.linear(p["q"], h).reshape(B, Q, cfg.num_heads, hd)
    k = L.linear(p["k"], h).reshape(B, Q, cfg.num_kv_heads, hd)
    v = L.linear(p["v"], h).reshape(B, Q, cfg.num_kv_heads, hd)
    q = L.apply_rope(q, q_pos, cfg.rope_theta)
    k = L.apply_rope(k, q_pos, cfg.rope_theta)
    if layer_cache is None:
        o = attention_flash(q, k, v, window=window)
        return L.linear(p["o"], o.reshape(B, Q, cfg.num_heads * hd))
    layer_cache = PAGED.write(layer_cache, k, v, block_table, index)
    if tree is not None:
        o = attention_tree(q, layer_cache["k"], layer_cache["v"], block_table,
                           index, tree[0], tree[1], window=window,
                           max_live=max_live)
    else:
        o = attention_paged(q, layer_cache["k"], layer_cache["v"],
                            block_table, index, window=window,
                            max_live=max_live)
    return L.linear(p["o"], o.reshape(B, Q, cfg.num_heads * hd))


def dense_layer(cfg, p, x, q_pos, layer_cache, index, block_table,
                max_live=None, tree=None):
    x = x + attn_block(cfg, p["attn"], x, q_pos, layer_cache, index,
                       cfg.sliding_window, block_table, max_live, tree)
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


def forward(cfg, params, tokens, cache, *, logits_slice=None, max_live=None,
            tree=None):
    """tokens: [B, Q] int.
    cache=None: full-sequence causal pass (the paper's no-cache mode);
    returns (logits, None).
    cache=dict: a paged cache; Q new tokens are written at
    ``cache["index"]`` and the returned cache (same pools) has index + Q.
    logits_slice: "last" unembeds only the final position (decode fast-path).
    max_live: live-token bound for the block-scan read (None derives it
    from the index); a 0-dim device tensor keeps the round free of host
    syncs.
    tree: (depths, bits) int32 [Q] — a stacked tree-verify pass
    (core/tree.py): RoPE positions become index + depths and attention
    follows the ancestor bitmasks. They become device tensors once here,
    not once per layer."""
    if cache is not None and "block_table" not in cache:
        raise NotImplementedError("the ring-cache forward is not ported")
    if cache is None and tree is not None:
        raise ValueError("a tree-verify pass needs a cache")
    x = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    Q = x.shape[1]
    if tree is not None:
        tree = tuple(torch.as_tensor(t, dtype=torch.int32, device=x.device)
                     for t in tree)
        offs = tree[0]
    else:
        offs = torch.arange(Q, dtype=torch.int32, device=x.device)
    if cache is None:
        index = block_table = None
        q_pos = offs
    else:
        index = cache["index"]
        block_table = cache["block_table"]
        # index: scalar (shared) or [B] (per-row batched speculation)
        q_pos = index[..., None] + offs if index.ndim else index + offs
    for l, lp in enumerate(params["layers"]):
        layer_cache = (None if cache is None
                       else {"k": cache["k"][l], "v": cache["v"][l]})
        x = dense_layer(cfg, lp, x, q_pos, layer_cache, index, block_table,
                        max_live, tree)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = L.linear(params["lm_head"], x.float())
    if cache is None:
        return logits, None
    return logits, {**cache, "index": index + Q}
