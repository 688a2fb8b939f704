"""No-cache flash attention on Hopper: wrapper, launch plan, launch count
and plain version; and its backward kernel, bound through autograd.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``. The kernel is ``repro_torch/csrc/flash_attention.cu``
(its header says what bounds it on the H100 and how the design answers);
``plain`` (``kernels/ref.py``, the port's ``attn_dense`` with both
positions counted from 0) is the same function in plain PyTorch.

``flash_attention`` takes the plain version for a CPU tensor (which
autograd differentiates). For a CUDA tensor it launches the kernel —
counting the launch in ``flash_attention.launches`` — or raises on what
the kernel does not take; it never falls back. The TPU tile sizes
``bq``/``bs`` are not parameters: the kernel masks its own ragged edge, so
nothing is padded. ``plan`` chooses the query rows per block and the grid.

Training: where grad mode is on and q, k or v requires grad, the CUDA call
goes through ``FlashAttentionFn``, which launches the same forward with
its log-sum-exp output and, in the backward pass, ``flash_attention_bwd``:
the kernels of ``csrc/flash_attention_bwd.cu`` (a backward JAX never
needs: its training differentiates the jnp attention), counted in
``flash_attention_bwd.launches``, with ``ref.flash_attention_bwd_ref`` as
its plain version. Every other call (all of serving) launches the forward
without the log-sum-exp, as before.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPES, check_args
from repro_torch.kernels.ref import flash_attention_bwd_ref as plain_bwd
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


def _s_valid(k, s_valid) -> int:
    Skv = k.shape[1]
    s_valid = Skv if s_valid is None else int(s_valid)
    if not 1 <= s_valid <= Skv:
        raise ValueError(f"s_valid must lie in 1..{Skv}, got {s_valid}")
    return s_valid


def flash_attention(q, k, v, *, window=None, causal=True, s_valid=None):
    """q: [B, Sq, H, D]; k, v: [B, Skv, Kv, D] with H = Kv * gq. Query and
    key positions both count from 0; keys at or past ``s_valid`` (default
    Skv) are masked. Scale D**-0.5. Differentiable on both devices."""
    s_valid = _s_valid(k, s_valid)
    if q.device.type == "cpu":
        return plain(q, k, v, window=window, causal=causal, s_valid=s_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, window, causal, s_valid)
    return forward(q, k, v, window=window, causal=causal, s_valid=s_valid)[0]


def forward(q, k, v, *, window=None, causal=True, s_valid=None, lse=False):
    """One launch of the forward kernel on CUDA tensors: (out, the fp32
    [B, H, Sq] log-sum-exp of each row if ``lse``, else None)."""
    s_valid = _s_valid(k, s_valid)
    check_args("flash attention", q, k, v, None, window)
    B, Sq, H, D = q.shape
    if k.shape[0] != B:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    q = q.contiguous()
    out = torch.empty_like(q)
    lse_buf = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
               if lse else None)
    p = plan(q.dtype, B, Sq, H, k.shape[2], D, window, sms=sm_count(q.device))
    lib = build.load("flash_attention")
    err = build.call(
        lib.flash_attention_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse_buf is None else lse_buf.data_ptr(), B, Sq, k.shape[1],
        H, k.shape[2], D, s_valid, int(bool(causal)),
        0 if window is None else int(window), float(D ** -0.5),
        DTYPES[q.dtype], p.row_tile)
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse_buf


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, dout, *, window=None, causal=True,
                        s_valid=None):
    """(dq, dk, dv) of ``flash_attention`` at output gradient ``dout``,
    from the forward's output ``o`` and log-sum-exp ``lse`` (fp32 [B, H,
    Sq]), each in its input's dtype. A CPU tensor takes the plain version
    (autograd of the plain forward; ``o`` and ``lse`` unused). A CUDA
    tensor launches the backward kernels (delta, dK/dV, dQ: one entry
    point, counted once) or raises."""
    s_valid = _s_valid(k, s_valid)
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, dout, window=window, causal=causal,
                         s_valid=s_valid)
    check_args("flash attention backward", q, k, v, None, window)
    B, Sq, H, D = q.shape
    for name, t in (("o", o), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"flash attention backward: {name} must match q")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("flash attention backward: lse must be fp32 "
                         f"{(B, H, Sq)}, got {lse.dtype} {tuple(lse.shape)}")
    q, o, dout, lse = (t.contiguous() for t in (q, o, dout, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    lib = build.load("flash_attention_bwd")
    err = build.call(
        lib.flash_attention_bwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], D,
        s_valid, int(bool(causal)), 0 if window is None else int(window),
        float(D ** -0.5), DTYPES[q.dtype])
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel under autograd (CUDA tensors): the forward launches
    with the log-sum-exp and saves q, k, v, o and it; the backward is
    ``flash_attention_bwd``. Deterministic: a recompute under remat gives
    the same output and the same gradients."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, s_valid):
        o, lse = forward(q, k, v, window=window, causal=causal,
                         s_valid=s_valid, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (window, causal, s_valid)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        window, causal, s_valid = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout, window=window,
                                         causal=causal, s_valid=s_valid)
        return dq, dk, dv, None, None, None
