"""w8a8 int8 matmul with its rescale epilogue on Hopper: wrapper, launch
plan, launch count and plain version.

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul.py::
int8_matmul``. The kernel is ``repro_torch/csrc/int8_matmul.cu`` (its
header says what bounds it on the H100 and how the design answers);
``plain`` (``kernels/ref.py``) computes the same exact int32 sums and the
same fp32 epilogue, so the two agree bit for bit.

``int8_matmul`` takes the plain version for a CPU tensor. For a CUDA tensor
it launches the kernel — counting the call in ``int8_matmul.launches`` —
or raises on what the kernel does not take; it never falls back. The
activation scale ``sx`` stays a 0-dim device tensor, read by the kernel
through its pointer: a host read per linear would synchronise the stream.
The TPU block sizes are not parameters: the kernel masks the ragged edges.
``plan`` splits K where the output tiles alone would leave SMs idle; a
split call runs two CUDA kernels (the split products into an int32
workspace, then their sum and the epilogue), an unsplit call one.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPES
from repro_torch.kernels.ref import int8_matmul_ref as plain

BM, BN, BK = 96, 128, 128   # the kernel's block tile (rows, columns, K bytes)
MIN_SPLIT_STEPS = 8         # K steps a split keeps, beyond one wave of blocks


class Int8Plan(NamedTuple):
    m_tiles: int
    n_tiles: int
    k_steps: int            # BK-deep steps over K
    splits: int             # contiguous ranges of K steps, one per grid z

    def k_range(self, z: int) -> Tuple[int, int]:
        """K steps [lo, hi) of split ``z``, as the kernel computes them."""
        return (z * self.k_steps // self.splits,
                (z + 1) * self.k_steps // self.splits)


def plan(M: int, K: int, N: int, sms: int) -> Int8Plan:
    """Block (i, j, z) owns output rows [i*BM, (i+1)*BM), columns
    [j*BN, (j+1)*BN) and the K steps ``k_range(z)``. Where the output tiles
    leave some of the ``sms`` SMs idle, K is split until the blocks cover
    the SMs once, and further, up to the two blocks an SM holds, while each split keeps at
    least MIN_SPLIT_STEPS steps (a split adds an int32 workspace round
    trip); never into empty ranges."""
    m_tiles, n_tiles, k_steps = -(-M // BM), -(-N // BN), -(-K // BK)
    tiles = m_tiles * n_tiles
    splits = max(-(-sms // tiles),
                 min(2 * sms // tiles, -(-k_steps // MIN_SPLIT_STEPS)))
    return Int8Plan(m_tiles, n_tiles, k_steps, max(1, min(splits, k_steps)))


def int8_matmul(x_q, w_q, sx, sw, *, out_dtype=torch.bfloat16):
    """x_q: [M, K] int8; w_q: [K, N] int8; sx: 0-dim fp32 tensor; sw: [N]
    fp32. Returns [M, N] ``out_dtype`` = (x_q @ w_q) * sx * sw."""
    if x_q.device.type == "cpu":
        return plain(x_q, w_q, sx, sw, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x_q.device}")
    if not isinstance(sx, torch.Tensor) or sx.numel() != 1:
        raise TypeError("int8_matmul: sx must be a one-element fp32 tensor "
                        "on the card (a host float would cost a copy per call)")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0] \
            or tuple(sw.shape) != (w_q.shape[1],):
        raise ValueError(f"int8_matmul: bad shapes x_q={tuple(x_q.shape)} "
                         f"w_q={tuple(w_q.shape)} sw={tuple(sw.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 \
            or sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("the int8_matmul kernel takes int8 x_q/w_q and fp32 sx/sw")
    if out_dtype not in DTYPES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} is not fp32 or bf16")
    if any(t.device != x_q.device for t in (w_q, sx, sw)):
        raise ValueError("int8_matmul: operands on different devices")
    M, K = x_q.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    x_q, w_q, sx, sw = (t.contiguous() for t in (x_q, w_q, sx, sw))
    p = plan(M, K, N, sm_count(x_q.device))
    part = (torch.empty((p.splits, M, N), dtype=torch.int32, device=x_q.device)
            if p.splits > 1 else None)
    lib = build.load("int8_matmul")
    err = lib.int8_matmul_fwd(x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(),
                              sw.data_ptr(), out.data_ptr(),
                              None if part is None else part.data_ptr(),
                              M, K, N, p.splits, DTYPES[out_dtype],
                              torch.cuda.current_stream(x_q.device).cuda_stream)
    build.check(err, "int8_matmul_fwd")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
