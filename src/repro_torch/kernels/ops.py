"""Public wrappers around the CUDA kernels (port of ``repro/kernels/ops.py``).

Model code calls these, never the C entry points. The kernel wrappers
decide by the tensor's device: the plain version for a CPU tensor, the
kernel for a CUDA tensor. Where the JAX wrappers send an explicit ``scale``
to the jnp oracle, the kernel wrapper raises for a CUDA tensor instead: the
kernel does not take one, and none occurs on the ported path. JAX also
sends an int8 KV pool to its oracle; here an int8 pool on the card
launches the int8-pool variant of the paged and tree kernels, which
dequantizes as ``cache.kv_cache._from_buf`` does (nothing falls back). The
paged and tree wrappers take ``fresh = (k_new, v_new)``, the call's own
K/V read in place of the pool at positions index..index+Q-1
(``models.attention``), with an int8 pool only on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _imm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import spec_verify as _sv
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tree_attention as _ta


def quantized_matmul(x_q, w_q, sx, sw, *, out_dtype=torch.bfloat16):
    """w8a8 matmul with its rescale epilogue: ``(x_q @ w_q) * sx * sw``.
    x_q: [..., K] int8 (quantized by the caller, as ``layers.linear`` does
    under ``quant.int8.act_quant``; JAX's wrapper quantizes inside);
    w_q: [K, N] int8; sx: 0-dim fp32 tensor; sw: [N] fp32. Ragged M, K and N
    are masked in the kernel, so nothing is padded."""
    lead = x_q.shape[:-1]
    out = _imm.int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q, sx, sw,
                           out_dtype=out_dtype)
    return out.reshape(*lead, w_q.shape[1])


def verify_greedy(draft_tokens, p_logits):
    """Fused greedy verification (see repro_torch.core.acceptance)."""
    return _sv.verify_greedy_fused(draft_tokens, p_logits)


def flash_attention(q, k, v, *, window=None, causal=True, s_valid=None):
    """No-cache blockwise attention (q and kv positions both from 0)."""
    return _fa.flash_attention(q, k, v, window=window, causal=causal,
                               s_valid=s_valid)


def paged_attention(q, k_pool, v_pool, block_table, index, *, window=None,
                    scale=None, max_live=None, fresh=None):
    """Block-table-native paged attention (prefill, draft and verify)."""
    return _pa.paged_flash_attention(q, k_pool, v_pool, block_table, index,
                                     window=window, scale=scale,
                                     max_live=max_live, fresh=fresh)


def tree_attention(q, k_pool, v_pool, block_table, index, depths, bits, *,
                   window=None, scale=None, max_live=None, fresh=None):
    """Block-table-native tree-verify attention: one stacked pass scores all
    root-to-leaf paths of a speculation tree (depths/bits from core/tree.py)."""
    return _ta.tree_flash_attention(q, k_pool, v_pool, block_table, index,
                                    depths, bits, window=window, scale=scale,
                                    max_live=max_live, fresh=fresh)


def ssd_scan(x, dA, Bm, Cm, *, chunk=128, init_state=None):
    """Fused chunked SSD scan: y from a zero state (the mamba2 no-cache
    path), or (y, final state) from ``init_state`` (the cached prefill);
    any l: the kernel treats rows past l as the zero padding."""
    return _ssd.ssd_scan(x, dA, Bm, Cm, chunk=chunk, init_state=init_state)
