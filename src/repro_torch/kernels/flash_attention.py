"""No-cache flash attention on Hopper: wrapper, launch plan, launch count
and plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``. The kernel is ``repro_torch/csrc/flash_attention.cu``
(its header says what bounds it on the H100 and how the design answers);
``plain`` (``kernels/ref.py``, the port's ``attn_dense`` with both
positions counted from 0) is the same function in plain PyTorch.

``flash_attention`` takes the plain version for a CPU tensor. For a CUDA
tensor it launches the kernel — counting the launch in
``flash_attention.launches`` — or raises on what the kernel does not take;
it never falls back. The TPU tile sizes ``bq``/``bs`` are not parameters:
the kernel masks its own ragged edge, so nothing is padded. ``plan``
chooses the query rows per block and the grid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPES, check_args
from repro_torch.kernels.ref import flash_attention_ref as plain

F32_ROWS = 16             # rows per block of the fp32 (CUDA-core) kernel
BF16_ROWS = (64, 128)     # rows per block of the bf16 (tensor-core) kernel


class FlashPlan(NamedTuple):
    row_tile: int           # query rows (position, group) per block
    row_tiles: int          # blocks per (kv-head, batch row)


def plan(dtype, B: int, Sq: int, H: int, Kv: int, D: int, window=None, *,
         sms: int) -> FlashPlan:
    """The launch of one call: row tile t of each (kv-head, batch row) owns
    rows [t * row_tile, (t + 1) * row_tile) of its Sq * (H / Kv)
    (position, group) rows. bf16 takes 64-row tiles (4 warps of 16 rows),
    and 128-row tiles (4 warps of 32 rows, so each K/V fragment read from
    shared memory feeds two products) for D = 128 without a window where
    they still give each of the ``sms`` SMs two blocks: long causal walks,
    where that reuse pays."""
    n_rows = Sq * (H // Kv)
    if dtype == torch.float32:
        rows = F32_ROWS
    else:
        long_walks = -(-n_rows // 128) * Kv * B >= 2 * sms
        rows = 128 if D == 128 and window is None and long_walks else 64
    return FlashPlan(rows, -(-n_rows // rows))


def flash_attention(q, k, v, *, window=None, causal=True, s_valid=None):
    """q: [B, Sq, H, D]; k, v: [B, Skv, Kv, D] with H = Kv * gq. Query and
    key positions both count from 0; keys at or past ``s_valid`` (default
    Skv) are masked. Scale D**-0.5."""
    Skv = k.shape[1]
    s_valid = Skv if s_valid is None else int(s_valid)
    if not 1 <= s_valid <= Skv:
        raise ValueError(f"s_valid must lie in 1..{Skv}, got {s_valid}")
    if q.device.type == "cpu":
        return plain(q, k, v, window=window, causal=causal, s_valid=s_valid)
    check_args("flash attention", q, k, v, None, window)
    B, Sq, H, D = q.shape
    if k.shape[0] != B:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    q = q.contiguous()
    out = torch.empty_like(q)
    p = plan(q.dtype, B, Sq, H, k.shape[2], D, window, sms=sm_count(q.device))
    lib = build.load("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, k.shape[2], D, s_valid, int(bool(causal)),
        0 if window is None else int(window), float(D ** -0.5),
        DTYPES[q.dtype], p.row_tile,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
