"""Tree-verify attention on Hopper: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``repro/kernels/tree_attention.py::
tree_flash_attention``. The kernel is the tree mask policy of
``repro_torch/csrc/paged_attention.cu`` (C entry point
``tree_attention_fwd``; the source's header says what bounds it on the H100
and how the design answers); ``plain`` (``kernels/ref.py``, the port's
``attn_tree``) is the same function in plain PyTorch.

``tree_flash_attention`` takes the plain version for a CPU tensor. For a
CUDA tensor it launches the kernel — counting the launch in
``tree_flash_attention.launches`` — or raises on what the kernel does not
take; it never falls back. An int8 pool and ``fresh`` go as for
``paged_attention.paged_flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import MAX_SPAN
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (as_int32, check_args,
                                                 check_fresh, launch)
from repro_torch.kernels.ref import tree_attention_ref as plain

TREE_HEAD_DIMS = (32, 48, 64, 128)    # the tree policy's instantiations


def fold_window(depths, bits, window):
    """Fold a sliding window's span side into the ancestor masks: slot t
    stays visible to slot s only if their depth gap (the RoPE position gap)
    is inside the window, as ``_tree_mask`` does. On the tensors' device."""
    span = depths.shape[0]
    ar = torch.arange(span, dtype=torch.int32, device=depths.device)
    keep = ((((bits[:, None] >> ar[None, :]) & 1) > 0)
            & ((depths[:, None] - depths[None, :]) < window))
    return (keep.to(torch.int32) << ar[None, :]).sum(dim=1, dtype=torch.int32)


def tree_flash_attention(q, k_pool, v_pool, block_table, index, depths, bits,
                         *, window=None, scale=None, max_live=None, fresh=None):
    """q: [B, span, H, D], the packed [root, node_1..node_N] verify span whose
    KV was just written at pool positions index..index+span-1;
    k_pool/v_pool: [NB, BS, Kv, D]; block_table: [B, MB] int32; index: [B]
    (or scalar); depths/bits: int32 [span] (``core.tree``; on the card,
    device tensors are used as they are). ``max_live`` as for
    ``paged_flash_attention``, and so are an int8 pool and ``fresh`` (the
    span's K/V). The kernel uses scale D**-0.5: an explicit ``scale`` is
    taken only on the CPU."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, block_table, index, depths, bits,
                     window=window, scale=scale, max_live=max_live, fresh=fresh)
    build.check_no_grad("tree attention", q, k_pool, v_pool)
    check_args("tree attention", q, k_pool, v_pool, scale, window,
               head_dims=TREE_HEAD_DIMS, int8_pool=True)
    check_fresh("tree attention", q, k_pool, fresh)
    S = q.shape[1]
    if S > MAX_SPAN:
        raise ValueError(f"tree attention kernel takes a span of at most "
                         f"{MAX_SPAN} slots (int32 ancestor masks), got {S}")
    dep = as_int32(depths, (S,), q.device)
    bts = as_int32(bits, (S,), q.device)
    if window is not None:
        bts = fold_window(dep, bts, int(window))
    out = launch("tree_attention_fwd", q, k_pool, v_pool, block_table, index,
                 max_live, window, (dep, bts), fresh=fresh)
    tree_flash_attention.launches += 1
    return out


tree_flash_attention.launches = 0
