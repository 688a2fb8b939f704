"""Chunked Mamba-2 SSD scan on Hopper: wrapper, launch count and plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``.
The kernel is ``repro_torch/csrc/ssd_scan.cu`` (its header says what
bounds it on the H100 and how the design answers); ``plain``
(``kernels/ref.py``, the port's ``ssd_chunked`` from a zero state) is the
same function in plain PyTorch.

``ssd_scan`` takes the plain version for a CPU tensor. For a CUDA tensor it
launches the kernel — counting the launch in ``ssd_scan.launches`` — or
raises on what the kernel does not take; it never falls back. The kernel
reads every operand through its strides (no transposed or padded copies)
and masks the ragged tail itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_scan_ref as plain

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 128    # the kernel's shared-memory plan


def ssd_scan(x, dA, Bm, Cm, *, chunk=128):
    """x: [b, l, h, p] (pre-multiplied by dt); dA: [b, l, h] log-decay;
    Bm, Cm: [b, l, h, n]; all fp32. Returns y [b, l, h, p] fp32, the scan
    from a zero state with rows past l read as zeros."""
    if x.device.type == "cpu":
        return plain(x, dA, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    for name, t, shape in (("dA", dA, (b, l, h)), ("Bm", Bm, (b, l, h, n)),
                           ("Cm", Cm, (b, l, h, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on {x.device}")
    if any(t.dtype != torch.float32 for t in (x, dA, Bm, Cm)):
        raise TypeError("the ssd_scan kernel takes fp32 x, dA, Bm and Cm")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"the ssd_scan kernel takes p <= {MAX_P}, n <= "
                         f"{MAX_N} and chunk <= {MAX_CHUNK}; got p={p}, n={n}, "
                         f"chunk={chunk}")
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.load("ssd_scan")
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
        b, l, h, p, n, chunk, *x.stride(), *dA.stride(), *Bm.stride(),
        *Cm.stride(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
