"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``): what a CPU tensor runs, and what the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_dense, attn_paged, attn_tree
from repro_torch.models.ssm import ssd_chunked


def int8_matmul_ref(x_q, w_q, sx, sw, out_dtype=torch.bfloat16):
    """[M,K]i8 @ [K,N]i8 with exact int32 accumulation, then the rescale
    ``acc * sx * sw[n]`` in fp32 (in that order), then the cast. A CUDA
    tensor sums in float64, which is exact here (|sum| <= K * 2**14 <
    2**53): the card has no plain int32 matmul."""
    if x_q.device.type == "cpu":
        acc = x_q.to(torch.int32) @ w_q.to(torch.int32)
    else:
        acc = (x_q.double() @ w_q.double()).to(torch.int32)
    return (acc.float() * sx * sw[None, :]).to(out_dtype)


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


def ssd_scan_ref(x, dA, Bm, Cm, chunk=128):
    """The model-level chunked SSD from a zero state, y only (any l: the
    tail is zero-padded to a chunk multiple and cut off again)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    init = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y, _ = ssd_chunked(x.float(), dA.float(), Bm.float(), Cm.float(), chunk, init)
    return y
