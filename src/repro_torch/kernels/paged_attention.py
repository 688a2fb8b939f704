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
take; it never falls back. The pool is q's dtype (fp32 or bf16) or int8:
an int8 pool launches the int8-pool instantiation, which dequantizes each
key as ``cache.kv_cache._from_buf`` does while it stages it, and takes
``fresh`` (the call's own K/V, read in place of the pool at positions
index..index+Q-1; ``models.attention``). An int8 pool is never dequantized
in PyTorch first. ``plan`` lays out a call for both mask policies:
bf16 splits each row's keys into fixed chunks of ``CHUNK`` keys from key 0
(a call then runs the chunk kernel and a combine kernel, counted once).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref as plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C entry points' codes
KV_INT8 = 2       # the code of an int8 pool (``kv_dtype``; q stays fp32/bf16)
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


HEAD_DIMS = (32, 48, 64, 128, 256)   # the paged and flash kernels' instantiations


def check_args(what, q, k_pool, v_pool, scale, window, head_dims=HEAD_DIMS,
               int8_pool=False):
    """The checks every attention kernel launch makes on the card (the two
    mask policies of ``paged_attention.cu``, and ``flash_attention.cu``
    with k/v in place of the pools): raises on what the kernel does not
    take, a head dim outside ``head_dims`` included. ``int8_pool``: the
    kernel also takes an int8 pool (the paged and tree policies)."""
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
    kv_ok = (q.dtype, torch.int8) if int8_pool else (q.dtype,)
    if k_pool.dtype not in kv_ok or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{what} kernel needs K/V of q's dtype {q.dtype}"
                        f"{' or int8' if int8_pool else ''}, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if D not in head_dims:
        raise ValueError(f"{what} kernel takes head_dim "
                         f"{', '.join(map(str, head_dims))}, got {D}")
    if q.shape[2] % Kv or tuple(v_pool.shape) != tuple(k_pool.shape) \
            or k_pool.shape[3] != D:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous K/V")
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")


def check_fresh(what, q, k_pool, fresh):
    """``fresh`` = (k_new, v_new) is taken on the card only over an int8
    pool, on q's device, in q's dtype, contiguous, of shape [B, Q, Kv, D];
    raises on anything else."""
    if fresh is None:
        return
    if k_pool.dtype != torch.int8:
        raise TypeError(f"{what} kernel takes fresh K/V only over an int8 "
                        f"pool, got a {k_pool.dtype} pool")
    B, Q, _, D = q.shape
    want = (B, Q, k_pool.shape[2], D)
    for t in fresh:
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{what}: fresh K/V must be {q.dtype} on "
                            f"{q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{what}: fresh K/V must be contiguous of shape "
                             f"{want}, got {tuple(t.shape)}")


def launch(entry, q, k_pool, v_pool, block_table, index, max_live, window,
           tree_args=(), fresh=None):
    """Launch C entry point ``entry`` of ``paged_attention.cu`` (the causal
    one, or the tree one with ``tree_args`` = (depths, bits) device tensors)
    by the call's ``plan``, over a pool of q's dtype or int8, with the
    ``fresh`` K/V when given; returns the output."""
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
    err = build.call(
        getattr(lib, entry), dev,
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), None if ml is None else ml.data_ptr(),
        *(t.data_ptr() for t in tree_args),
        *((None, None) if fresh is None else (t.data_ptr() for t in fresh)),
        out.data_ptr(), None if ws is None else ws.data_ptr(), B, Q, H, Kv, D,
        NB, BS, MB, p.chunks, 0 if window is None else int(window),
        float(D ** -0.5), DTYPES[q.dtype],
        KV_INT8 if k_pool.dtype == torch.int8 else DTYPES[q.dtype])
    build.check(err, entry)
    return out


def paged_flash_attention(q, k_pool, v_pool, block_table, index, *,
                          window=None, scale=None, max_live=None, fresh=None):
    """q: [B, Q, H, D]; k_pool/v_pool: [NB, BS, Kv, D] of q's dtype or int8;
    block_table: [B, MB] int32; index: [B] (or scalar) committed tokens per
    row, queries at index..index+Q-1 already written into the pool.
    ``max_live`` caps every row's scanned blocks at ceil(max_live/BS); on
    the card it may be a 0-dim device tensor, read by the kernel without a
    host sync. ``fresh`` = (k_new, v_new) [B, Q, Kv, D] in q's dtype is read
    in place of the pool at index..index+Q-1 (on the card: over an int8
    pool only). The kernel uses scale D**-0.5: an explicit ``scale`` is
    taken only on the CPU."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, block_table, index, window=window,
                     scale=scale, max_live=max_live, fresh=fresh)
    build.check_no_grad("paged attention", q, k_pool, v_pool)
    check_args("paged attention", q, k_pool, v_pool, scale, window,
               int8_pool=True)
    check_fresh("paged attention", q, k_pool, fresh)
    out = launch("paged_attention_fwd", q, k_pool, v_pool, block_table, index,
                 max_live, window, fresh=fresh)
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
