"""Paged flash attention on Hopper: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_flash_attention``. The kernel is ``repro_torch/csrc/paged_attention.cu``
(its header says what bounds it on the H100 and how the design answers);
``plain`` (``kernels/ref.py``, the port's ``attn_paged``) is the same
function in plain PyTorch.

``paged_flash_attention`` takes the plain version for a CPU tensor. For a
CUDA tensor it launches the kernel — counting the launch in
``paged_flash_attention.launches`` — or raises on what the kernel does not
take; it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref as plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C entry points' codes


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
    B, Q, H, D = q.shape
    NB, BS, Kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    MB = block_table.shape[1]
    dev = q.device
    q = q.contiguous()
    table = block_table.to(torch.int32).contiguous()
    idx = as_int32(index, (B,), dev)
    ml = None if max_live is None else as_int32(max_live, (), dev)
    out = torch.empty_like(q)
    lib = build.load("paged_attention")
    err = lib.paged_attention_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), None if ml is None else ml.data_ptr(), out.data_ptr(),
        B, Q, H, Kv, D, NB, BS, MB, 0 if window is None else int(window),
        float(D ** -0.5), DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_attention_fwd")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
