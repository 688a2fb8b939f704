"""Chunked Mamba-2 SSD scan on Hopper: wrapper, launch plan, launch count and
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``.
The kernel is ``repro_torch/csrc/ssd_scan.cu`` (its header says what
bounds it on the H100 and how the design answers); ``plain``
(``kernels/ref.py``, the port's ``ssd_chunked`` from a zero state) is the
same function in plain PyTorch, and ``ref.ssd_split_ref`` the kernel's
decomposition.

``ssd_scan`` takes the plain version for a CPU tensor. For a CUDA tensor it
launches the kernel — counting the launch in ``ssd_scan.launches`` — or
raises on what the kernel does not take; it never falls back. The kernel
reads every operand through its strides (no transposed or padded copies)
and masks the ragged tail itself. A call runs two CUDA kernels when l >
chunk (the chunk kernel, then the carry kernel by programmatic dependent
launch) and is counted once. ``plan`` lays out a call.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch import device as devices
from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_scan_ref as plain

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 128    # the kernel's shared-memory plan
ROW_TILE = 16       # rows of a y tile (csrc: kRowTile)
K_TILE = 64         # state columns of a state item (csrc: kKTile)
CARRY_ROWS = 64     # rows of a carry block (csrc: kCarryRows)
HEAD_GROUPS = (4, 2, 1)


class SsdPlan(NamedTuple):
    heads: int              # heads of a y item: one score tile serves them
    row_tile: int           # rows of a y item's tile
    chunks: int             # chunks of the call, the last maybe partial
    last_rows: int          # real rows of the last chunk
    y_blocks: int           # y items: (batch row, head group, chunk, row tile)
    state_blocks: int       # state items: (batch row, head, chunk, K_TILE columns)
    carry_blocks: int       # carry blocks: (batch row, head, CARRY_ROWS rows)
    workspace: int          # fp32 chunk contributions [b, h, chunks - 1, n, p4]


def row_tiles(rows: int) -> List[int]:
    """The 16-row tiles of a chunk with ``rows`` real rows in the kernel's
    order: the last (the most causal columns, the longest item) first. A
    copy of ``ssd_chunk_kernel``'s blockIdx decoding, for ``y_items``."""
    T = -(-rows // ROW_TILE)
    return [T - 1 - t for t in range(T)]


def heads_per_block(b: int, h: int, chunk: int, sms: int, shared: bool) -> int:
    """The largest head group in HEAD_GROUPS that divides h and still gives
    the y items of one full chunk at least half the card (1 when B and C are
    not shared by the heads, or when no group does). It depends on neither
    l nor anything of the card but its SM count."""
    if not shared:
        return 1
    tiles = len(row_tiles(chunk))
    for g in HEAD_GROUPS:
        if h % g == 0 and b * (h // g) * tiles >= -(-sms // 2):
            return g
    return 1


def plan(b: int, l: int, h: int, p: int, n: int, chunk: int, sms: int, *,
         shared: bool = True) -> SsdPlan:
    """The launch of one call: the chunk kernel's y items (the full chunks'
    first, then a partial last chunk's), then its state items, in the order
    the kernel decodes blockIdx.x; and the carry kernel's blocks.
    ``shared``: B and C are one group over the heads (head stride 0)."""
    nc = -(-l // chunk)
    last = l - (nc - 1) * chunk
    hg = heads_per_block(b, h, chunk, sms, shared)
    full = nc if last == chunk else nc - 1
    y_blocks = b * (h // hg) * (full * len(row_tiles(chunk))
                                + (last != chunk) * len(row_tiles(last)))
    state_blocks = b * h * (nc - 1) * -(-n // K_TILE)
    carry_rows = chunk if nc >= 3 else last
    carry_blocks = b * h * -(-carry_rows // CARRY_ROWS) if nc > 1 else 0
    p4 = -(-p // 4) * 4                        # a state row: 16-byte aligned
    return SsdPlan(hg, ROW_TILE, nc, last, y_blocks, state_blocks, carry_blocks,
                   b * h * (nc - 1) * n * p4)


def y_items(pl: SsdPlan, b: int, h: int, chunk: int):
    """The y items of a plan, in the chunk kernel's order (the tile varies
    slowest, then the chunk, the head group and the batch row): (batch row,
    first head, chunk, tile). This mirrors ``ssd_chunk_kernel``'s blockIdx
    decoding for ``ref.ssd_split_ref``; it does not prove it: the kernel's
    own decoding is held by ``chip_smoke.py``'s cases on the card."""
    full = pl.chunks if pl.last_rows == chunk else pl.chunks - 1
    groups = h // pl.heads
    items = [(bb, g * pl.heads, c, t) for t in row_tiles(chunk)
             for c in range(full) for g in range(groups) for bb in range(b)]
    if pl.last_rows != chunk:
        items += [(bb, g * pl.heads, pl.chunks - 1, t) for t in row_tiles(pl.last_rows)
                  for g in range(groups) for bb in range(b)]
    return items


def state_items(pl: SsdPlan, b: int, h: int, n: int):
    """The state items of a plan: (batch row, head, chunk, first column),
    mirroring ``ssd_chunk_kernel``'s decoding of its state blocks for
    ``ref.ssd_split_ref`` (the kernel's own is held on the card)."""
    return [(bb, hd, c, kt * K_TILE) for bb in range(b) for hd in range(h)
            for c in range(pl.chunks - 1) for kt in range(-(-n // K_TILE))]


def shares_scores(Bm, Cm) -> bool:
    """Do all heads see the same B and C (one head, or head stride 0), so
    that a head group can share one tile of scores C B^T?"""
    return Bm.shape[2] == 1 or (Bm.stride(2) == 0 and Cm.stride(2) == 0)


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
    pl = plan(b, l, h, p, n, chunk, devices.sm_count(x.device),
              shared=shares_scores(Bm, Cm))
    ws = (torch.empty((pl.workspace,), dtype=torch.float32, device=x.device)
          if pl.workspace else None)
    lib = build.load("ssd_scan")
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), b, l, h, p, n, chunk, pl.heads,
        *x.stride(), *dA.stride(), *Bm.stride(), *Cm.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
