"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``): what a CPU tensor runs, and what the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_dense, attn_paged, attn_tree


def blockwise_argmax_ref(logits):
    """[R, V] -> int32 [R, 1]; the first maximum wins, as in the kernel."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def flash_attention_ref(q, k, v, *, window=None, causal=True, s_valid=None):
    """The model-level dense attention with query and key positions both
    counted from 0; keys at or past ``s_valid`` carry position -1, which
    ``_mask`` never shows."""
    Sq, Skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    if s_valid is not None:
        kv_pos = torch.where(kv_pos < s_valid, kv_pos, -1)
    return attn_dense(q, k, v, q_pos, kv_pos, window=window, causal=causal)


def paged_attention_ref(q, k_pool, v_pool, block_table, index, *,
                        window=None, scale=None, max_live=None):
    """The model-level block-scan paged attention."""
    return attn_paged(q, k_pool, v_pool, block_table, index, window=window,
                      scale=scale, max_live=max_live)


def tree_attention_ref(q, k_pool, v_pool, block_table, index, depths, bits,
                       *, window=None, scale=None, max_live=None):
    """The model-level block-scan tree attention."""
    return attn_tree(q, k_pool, v_pool, block_table, index, depths, bits,
                     window=window, scale=scale, max_live=max_live)
