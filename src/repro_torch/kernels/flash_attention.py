"""No-cache flash attention on Hopper: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``. The kernel is ``repro_torch/csrc/flash_attention.cu``
(its header says what bounds it on the H100 and how the design answers);
``plain`` (``kernels/ref.py``, the port's ``attn_dense`` with both
positions counted from 0) is the same function in plain PyTorch.

``flash_attention`` takes the plain version for a CPU tensor. For a CUDA
tensor it launches the kernel — counting the launch in
``flash_attention.launches`` — or raises on what the kernel does not take;
it never falls back. The TPU tile sizes ``bq``/``bs`` are not parameters:
the kernel masks its own ragged edge, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPES, check_args
from repro_torch.kernels.ref import flash_attention_ref as plain


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
    lib = build.load("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, k.shape[2], D, s_valid, int(bool(causal)),
        0 if window is None else int(window), float(D ** -0.5),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
