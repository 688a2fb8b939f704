"""Paged flash attention on Hopper: wrapper, launch plan, launch count and
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_flash_attention``. The kernel is ``repro_torch/csrc/paged_attention.cu``
(its header says what bounds it on the H100 and how the design answers);
``plain`` (``kernels/ref.py``, the port's ``attn_paged``) is the same
function in plain PyTorch, and ``ref.paged_split_ref`` the bf16 kernel's
split computation.

``paged_flash_attention`` takes the plain version for a CPU tensor. For a
CUDA tensor it launches the kernel — counting the launch in
``paged_flash_attention.launches`` — or raises on what the kernel does not
take; it never falls back. ``plan`` lays out a call for both mask policies:
bf16 splits each row's keys into fixed chunks of ``CHUNK`` keys from key 0
(a call then runs the chunk kernel and a combine kernel, counted once).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref as plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C entry points' codes
ROW_TILE = 16     # query (position, group) rows per block, both dtypes
CHUNK = 64        # keys per chunk of the bf16 split walk (csrc: kChunk)


class PagedPlan(NamedTuple):
    row_tile: int           # query rows per block
    row_tiles: int          # blocks per (chunk, kv-head, batch row)
    chunks: int             # key chunks per row in the grid; 1: one walk
    workspace: int          # fp32 partials of a split call (0: none)


def plan(dtype, B: int, Q: int, H: int, Kv: int, D: int, BS: int,
         MB: int) -> PagedPlan:
    """The launch of one paged or tree call. Row tile t owns (position,
    group) rows [16t, 16t + 16) of each (kv-head, batch row). bf16 splits
    every row's keys into chunks of CHUNK keys counted from key 0, one block
    each; the grid holds the ceil(MB * BS / CHUNK) chunks of the table's
    width (the live bound is on the card: blocks past it return at once),
    and each writes its partial (acc [D], then m and l) to the workspace.
    fp32 runs one block per row tile over every live page (chunks 1).
    Nothing here depends on the card, and nothing but the row count on Q:
    a row's chunks are the same in every call."""
    n_rows = Q * (H // Kv)
    tiles = -(-n_rows // ROW_TILE)
    if dtype == torch.float32:
        return PagedPlan(ROW_TILE, tiles, 1, 0)
    chunks = -(-(MB * BS) // CHUNK)
    return PagedPlan(ROW_TILE, tiles, chunks, B * Kv * n_rows * chunks * (D + 2))


def as_int32(x, shape, device):
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return t.expand(shape).contiguous() if t.shape != shape else t.contiguous()


def check_args(what, q, k_pool, v_pool, scale, window):
    """The checks every attention kernel launch makes on the card (the two
    mask policies of ``paged_attention.cu``, and ``flash_attention.cu``
    with k/v in place of the pools): raises on what the kernel does not
    take."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if k_pool.device != q.device or v_pool.device != q.device:
        raise ValueError(f"{what}: K/V on {k_pool.device}/{v_pool.device}, "
                         f"q on {q.device}")
    if scale is not None:
        raise ValueError(f"the {what} kernel uses scale D**-0.5; "
                         "an explicit scale is not supported on the GPU")
    D, Kv = q.shape[3], k_pool.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes fp32/bf16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what} kernel needs K/V of q's dtype "
                        f"{q.dtype}, got {k_pool.dtype}/{v_pool.dtype}")
    if D not in (64, 128):
        raise ValueError(f"{what} kernel takes head_dim 64 or 128, got {D}")
    if q.shape[2] % Kv or tuple(v_pool.shape) != tuple(k_pool.shape) \
            or k_pool.shape[3] != D:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous K/V")
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")


def launch(entry, q, k_pool, v_pool, block_table, index, max_live, window,
           tree_args=()):
    """Launch C entry point ``entry`` of ``paged_attention.cu`` (the causal
    one, or the tree one with ``tree_args`` = (depths, bits) device tensors)
    by the call's ``plan``; returns the output."""
    B, Q, H, D = q.shape
    NB, BS, Kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    MB = block_table.shape[1]
    dev = q.device
    q = q.contiguous()
    table = block_table.to(torch.int32).contiguous()
    idx = as_int32(index, (B,), dev)
    ml = None if max_live is None else as_int32(max_live, (), dev)
    p = plan(q.dtype, B, Q, H, Kv, D, BS, MB)
    out = torch.empty_like(q)
    ws = (torch.empty((p.workspace,), dtype=torch.float32, device=dev)
          if p.workspace else None)
    lib = build.load("paged_attention")
    err = getattr(lib, entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), None if ml is None else ml.data_ptr(),
        *(t.data_ptr() for t in tree_args), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Q, H, Kv, D, NB, BS, MB,
        p.chunks, 0 if window is None else int(window), float(D ** -0.5),
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, entry)
    return out


def paged_flash_attention(q, k_pool, v_pool, block_table, index, *,
                          window=None, scale=None, max_live=None):
    """q: [B, Q, H, D]; k_pool/v_pool: [NB, BS, Kv, D]; block_table: [B, MB]
    int32; index: [B] (or scalar) committed tokens per row, queries at
    index..index+Q-1 already written into the pool. ``max_live`` caps every
    row's scanned blocks at ceil(max_live/BS); on the card it may be a 0-dim
    device tensor, read by the kernel without a host sync. The kernel uses
    scale D**-0.5: an explicit ``scale`` is taken only on the CPU."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, block_table, index, window=window,
                     scale=scale, max_live=max_live)
    check_args("paged attention", q, k_pool, v_pool, scale, window)
    out = launch("paged_attention_fwd", q, k_pool, v_pool, block_table, index,
                 max_live, window)
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
