#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

1. Prints the card's name and power limit (nvidia-smi), builds the CUDA
   kernels from ``src/repro_torch/csrc`` (one nvcc per source, in parallel)
   and prints the build seconds and each kernel's registers and spills;
   then what the timer reads for one and two trivial kernels
   (``"case": "timer_floor"``).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (paged attention: the Llama-3.2-3B and
   -1B head geometries, Q in {1, 5, 127}, block size 16, ragged rows with a
   row on the NULL block, fp32 and bf16; argmax: [20, 128256] fp32 with
   planted ties and a NaN after a tied maximum in one row, then [7, 50281]
   (rows off a 16-byte boundary), with the plan's cluster; tree attention:
   the 3B geometry, B=4, block size 16, ragged rows, the main path's
   chain_tree(2, 4) (span 9), chain_tree(5, 6) (span 31), a non-chain tree
   and chain_tree(2, 4) with a window of 8, fp32 and bf16), one JSON line
   per case with the error, the tolerance, the kernel / plain / library /
   bound times in ms and the launch plan's key chunks and row tile. Then,
   per head geometry and dtype, on one pool: the rows of a Q=5 paged call
   must be bit-equal to Q=1 calls at the same positions, and a width-1
   chain tree call to the causal call
   (``"case": "attention_q_invariance"``).
3. Smoke-width exactness on the card: the llama3.2-1b smoke pair (fp32,
   drafter = the target's first L-1 layers, so some drafts are rejected)
   served speculatively, served with AR rounds only, and served on the CPU
   from the same weights must give identical tokens, with at least one
   round that accepted part of its draft. Then the same for paged tree
   rounds (``PagedTreeRound``, width 2, depth 3; the weights drawn on the
   CPU and copied to the card): tree on the card == tree on the CPU == AR
   on the card, with at least one partial accept and one round won by a
   chain other than 0, and both block allocators audited after every
   round.
4. The main path at full width: the paper's pair, Llama-3.2-3B target and
   Llama-3.2-1B drafter (bf16, seeded random weights), serves 8 ragged
   requests through ``PagedSpecServer`` with gamma pinned to 4. The kernel
   launch counts are set to 0 just before and read just after, and must
   equal what the path implies; the tokens must equal the same requests
   served with AR rounds. The same serve then runs once more under
   ``torch.profiler``: device busy time, idle share, launches per round
   and device time by kernel.
5. Full-width tree rounds: the same pair runs ``PagedTreeRound`` (width 2,
   depth 4) over 4 ragged prompts until each row has 32 new tokens; the
   launch counts (set to 0 just before the tree prefills, read just after
   the last round) must equal what the path implies, and the tokens must
   equal the same prompts served with AR rounds; then the same tree serve
   runs once more under ``torch.profiler`` (``"phase": "profile_tree"``).
6. The no-cache flash-attention kernel against its plain version: the
   Llama-3.2-3B and -1B head geometries at the main-path shape (B=2,
   S=134), fp32 and bf16; S in {1, 17, 1100, 2048}; a window of 8;
   non-causal; keys masked past s_valid < S. One JSON line per case, with
   the same fields as in step 2 (library: SDPA with the same mask) and the
   plan's row tile.
7. The paper's no-cache engine (``SpecEngine(use_cache=False)``): on the
   smoke pair of step 3, linear gamma 4 and multi-draft k=2 at B=2 must
   give identical tokens on the card, on the CPU and from no-cache AR on
   the card, with at least one round that accepted part of its draft; at
   full width (the paper's pair, bf16) ``launch.serve`` serves 4 requests
   of 64 + 64 tokens in two waves of 2 (T = 134) with gamma 4, with exact
   flash / argmax launch counts and no paged or tree launch, and its
   tokens must equal no-cache AR's on the card; then the same spec serve
   runs once more under ``torch.profiler`` (its ``"phase":
   "profile_nocache"`` line, as in step 4); every kernel's count is read,
   so the SSD and int8 kernels must stay at 0 there.
8. The last two kernels against their plain versions: the SSD scan at the
   Mamba-2 smoke shape, the main path's target (48 heads) and drafter (24
   heads) shapes at T = 134, 1100 rows (9 chunks of state carry), the
   target shape with B and C copied per head, and the JAX kernel test's
   impulse (fp32, B and C a stride-0 view over heads, as the model hands
   them, except in the per-head case; no library call computes the scan),
   each with the plan's head groups and block counts; then, at the target
   and drafter shapes, SSD rows 0..127 at l = 134 must be bit-equal to the
   call at l = 128 and rows 0..1023 at l = 1100 to l = 1024
   (``"case": "ssd_l_invariance"``); the int8
   matmul at the eight projections of the w8a8 Llama-3.2-3B/1B pair at
   M = 2 x 134 = 268 (bf16 out), M = 1 and 256, JAX's ragged shapes and
   fp32 out (bit-equal expected; library: ``torch._int_mm`` + rescale),
   each with the plan's K split (``splits``): an int8 call launches one
   CUDA kernel unsplit, two split (the split products, then their sum
   and the epilogue), and the wrapper counts it once either way.
9. Smoke-width exactness of the two new paths, as in step 7: the
   ``mamba2-780m`` smoke pair (``"phase": "smoke_ssm_nocache_exactness"``)
   and the llama3.2-1b smoke pair through ``quantize_for_serving`` under
   ``act_quant`` with a static scale calibrated on the CPU
   (``"smoke_w8a8_exactness"``).
10. Full width, through ``launch.serve`` with step 7's traffic: the paper's
   pair through ``quantize_for_serving`` under ``act_quant`` with a static
   scale from ``calibrate_act_scale`` over the linear inputs of one
   unquantized target pass on the first wave (``"full_width_w8a8"``: 7
   int8 launches and one flash launch per layer pass), then the
   ``mamba2-780m`` target with its registered drafter (``"full_width_ssm"``:
   one SSD launch per layer pass); tokens == AR's, exact counts of all six
   kernels, each followed by a profiled serve (``"profile_w8a8"``,
   ``"profile_ssm"``); last, a reading (it fails nothing): the Mamba-2
   target's no-cache logits on a T=128 buffer against a T=134 buffer
   sharing its first 128 tokens (``"phase": "buffer_invariance"``: bit-equal
   or not, else their max |d| and smallest top-1 margin).
11. Prints the ``{"kernels": [...]}`` line (six kernels), the card line
   again and, last, ``{"ok": true, "device": {...}}``.

Every JSON line carries ``elapsed_s``, the seconds since the script
started. Nothing is caught: any failure exits non-zero before the last line. With no
CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

START = time.perf_counter()

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FLOPS_PER_S = {torch.float32: 67e12,    # H100 SXM peak for the input type:
               torch.bfloat16: 989e12,  # fp32 CUDA cores, bf16 tensor cores,
               torch.int8: 1979e12}     # dense int8 tensor cores (OP/s)
TOL = {torch.float32: (1e-4, 1e-4),   # (atol, rtol): summation order differs
       torch.bfloat16: (1e-2, 1e-2)}  # plus one bf16 output rounding (2^-8)
GAMMA = 4
TREE_W, TREE_D = 2, 4          # full-width tree rounds: chain_tree(2, 4)
NOCACHE_PROMPT, NOCACHE_NEW = 64, 64   # full-width no-cache requests


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def emit(obj):
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - START}), flush=True)


def agreement(out, ref, dtype) -> dict:
    """A kernel's output against its plain version: max |err| and whether
    every element lies within TOL[dtype]."""
    atol, rtol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    return {"max_abs_err": float(diff.max()), "atol": atol, "rtol": rtol,
            "ok": bool((diff <= atol + rtol * ref.float().abs()).all())}


def bound(nbytes, flops, dtype) -> dict:
    """The least time the card could take for the work: the bytes over the
    memory rate or the operations over the peak rate for the input type,
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


class Timer:
    """Median device time of one call, by CUDA events, with the 50 MB L2
    flushed before every call (the serving path finds each layer's KV and
    the logits cold). Before each flush the card spins for ~1 ms, so the
    host has queued the call before the card reaches the start event: the
    events time the card's work, not a slow host's launch path."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# --------------------------------------------------------------- kernels
def timer_floor(timer):
    """What the timer reads for one and for two back-to-back trivial
    kernels (an in-place add on 16 floats): the floor under every short
    case's time, launch and L2 flush included."""
    x = torch.zeros(16, device="cuda")
    case = {"case": "timer_floor", "one_kernel_ms": timer(lambda: x.add_(1)),
            "two_kernels_ms": timer(lambda: (x.add_(1), x.add_(1)))}
    emit(case)
    return case


def attention_case(timer, name, H, Kv, D, Q, dtype, headline=False):
    from repro_torch.kernels import paged_attention as pa
    BS, MB, NB = 16, 16, 256
    g = torch.Generator(device="cuda").manual_seed(H * 1000 + Q)
    if Q == 127:                       # bucketed prefill: one row from 0
        index = [0]
    else:                              # draft / verify: ragged, row 2 NULL
        index = [37, 150, 11, 200]
    B = len(index)
    q = torch.randn((B, Q, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    table = perm[:B * MB].reshape(B, MB).to(torch.int32)
    if B > 1:
        table[2] = 0                   # a frozen slot on the NULL block
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    max_live = None if Q == 127 else (idx.max() + Q).to(torch.int32)
    args = (q, k, v, table, idx)

    out = pa.paged_flash_attention(*args, max_live=max_live)
    ref = pa.plain(*args, max_live=max_live)
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)

    # library yardstick: SDPA over a gathered, head-expanded view
    live = [min(i + Q, int(max_live) if max_live is not None else 1 << 30)
            for i in index]
    S = max(live)
    cols = torch.arange(S, device="cuda")
    blk = table.long()[:, cols // BS]                          # [B, S]
    kg = k[blk, cols % BS].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = v[blk, cols % BS].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    qg = q.permute(0, 2, 1, 3)
    qpos = idx[:, None] + torch.arange(Q, device="cuda")
    mask = (qpos[:, :, None] >= cols[None, None, :])[:, None]  # [B,1,Q,S]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    ms = timer(lambda: pa.paged_flash_attention(*args, max_live=max_live))
    plain_ms = timer(lambda: pa.plain(*args, max_live=max_live), iters=5)
    library_ms = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask))

    # least work the function needs on these inputs: each visible KV token
    # read once per kv-head, q read and out written once; 4 flops per
    # (query head, visible key, d), at the card's peak for the input type
    esz = q.element_size()
    visible = sum(min(i + qi + 1, n) for i, n in zip(index, live)
                  for qi in range(Q))
    nbytes = (2 * q.numel() * esz + sum(live) * Kv * D * 2 * esz
              + table.numel() * 4 + B * 4)
    flops = 4 * H * D * visible
    p = pa.plan(dtype, B, Q, H, Kv, D, BS, MB)
    case = {"case": "paged_attention", "geometry": name, "Q": Q, "B": B,
            "dtype": str(dtype).replace("torch.", ""), **agree,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(nbytes, flops, dtype), "chunks": p.chunks,
            "row_tile": p.row_tile, "row_tiles": p.row_tiles,
            "headline": headline}
    emit(case)
    if not agree["ok"]:
        raise SystemExit(f"paged attention disagrees with its plain version: {case}")
    return case


def q_invariance(name, H, Kv, D, dtype):
    """On one pool (B=4 ragged rows, row 2 on the NULL block, block size
    16): the rows of a Q = GAMMA + 1 verify call against Q=1 calls at the
    same positions, and a width-1 chain tree over the same span against
    the causal call, each with the serving path's live bound max(index) + Q
    as a device tensor. A row's arithmetic must not depend on Q or on the
    mask policy, so all must be bit-equal (spec == AR and tree == AR rest
    on it)."""
    from repro_torch.core.tree import chain_tree
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tree_attention as ta
    BS, MB, NB, Q = 16, 16, 256, GAMMA + 1
    g = torch.Generator(device="cuda").manual_seed(H * 100 + D)
    idx = torch.tensor([37, 150, 11, 200], dtype=torch.int32, device="cuda")
    B = idx.numel()
    q = torch.randn((B, Q, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    table = perm[:B * MB].reshape(B, MB).to(torch.int32)
    table[2] = 0

    def live(n):
        return (idx.max() + n).to(torch.int32)
    verify = pa.paged_flash_attention(q, k, v, table, idx, max_live=live(Q))
    steps = [pa.paged_flash_attention(q[:, i:i + 1].contiguous(), k, v, table,
                                      idx + i, max_live=live(i + 1))
             for i in range(Q)]
    shape = chain_tree(1, Q - 1)
    width1 = ta.tree_flash_attention(
        q, k, v, table, idx, torch.from_numpy(shape.depths).cuda(),
        torch.from_numpy(shape.bits).cuda(), max_live=live(Q))
    torch.cuda.synchronize()
    q_equal = [bool(torch.equal(s[:, 0], verify[:, i])) for i, s in enumerate(steps)]
    tree_equal = bool(torch.equal(width1, verify))
    p = pa.plan(dtype, B, Q, H, Kv, D, BS, MB)
    case = {"case": "attention_q_invariance", "geometry": name, "Q": Q,
            "B": B, "dtype": str(dtype).replace("torch.", ""),
            "chunks": p.chunks, "row_tile": p.row_tile,
            "verify_rows_equal_q1": q_equal,
            "width1_tree_equals_causal": tree_equal}
    emit(case)
    if not (all(q_equal) and tree_equal):
        raise SystemExit(f"paged/tree attention rows depend on Q or the policy: {case}")
    return case


def planted_logits(R, V, seed, nan_row=None):
    """Seeded [R, V] logits with ties planted in every row: the first
    maximum must win (and, in ``nan_row``, a NaN after the tied maximum,
    which counts as the maximum). Returns (logits, expected argmax)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((R, V), generator=g, device="cuda")
    top = float(logits.max()) + 1.0
    first = []
    span = min(8000, V // 4)
    for r in range(R):
        a = (r * 977) % (V - span - 2)
        logits[r, a] = top
        logits[r, a + 3] = top         # the same block
        logits[r, a + span] = top      # another block of the row's cluster
        first.append(a)
        if r == nan_row:
            logits[r, a + span + 1] = float("nan")
            first[-1] = a + span + 1
    return logits, torch.tensor(first, dtype=torch.int32, device="cuda")


def argmax_case(timer):
    """The argmax kernel against torch.argmax at the verify shape, with
    planted ties and, in one row, a NaN after a tied maximum; then at a
    vocabulary that is not a multiple of 4 (odd rows start off a 16-byte
    boundary: the kernel's scalar head and tail)."""
    from repro_torch.kernels import spec_verify as sv
    R, V = 5 * GAMMA, 128256
    logits, first = planted_logits(R, V, 5, nan_row=7)
    out = sv.blockwise_argmax(logits)[:, 0]
    ref = sv.plain(logits)[:, 0]
    odd, odd_first = planted_logits(7, 50281, 6, nan_row=2)
    odd_out = sv.blockwise_argmax(odd)[:, 0]
    odd_ref = sv.plain(odd)[:, 0]
    torch.cuda.synchronize()
    err = float(max((out.long() - ref.long()).abs().max(),
                    (odd_out.long() - odd_ref.long()).abs().max()))
    ok = (err == 0 and bool((out == first).all())
          and bool((odd_out == odd_first).all()))
    ms = timer(lambda: sv.blockwise_argmax(logits))
    plain_ms = timer(lambda: sv.plain(logits))
    library_ms = timer(lambda: torch.argmax(logits, dim=-1))
    case = {"case": "blockwise_argmax", "shape": [R, V], "dtype": "float32",
            "odd_shape": list(odd.shape), "nan_rows": [7, 2],
            "max_abs_err": err, "atol": 0, "rtol": 0, "ok": ok,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "cluster": sv.plan(R, V).cluster,
            **bound(logits.numel() * 4 + R * 4, R * V, torch.float32)}
    emit(case)
    if not ok:
        raise SystemExit(f"argmax kernel disagrees with torch.argmax: {case}")
    return case


def tree_attention_case(timer, name, shape, dtype, window=None,
                        headline=False):
    """Tree attention at the Llama-3.2-3B head geometry: B=4 ragged rows
    (row 2 on the NULL block), block size 16, the verify round's live
    bound max(index) + span as a device tensor."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.models.attention import _tree_mask
    H, Kv, D, BS, MB, NB = 24, 8, 128, 16, 16, 256
    span = shape.span
    g = torch.Generator(device="cuda").manual_seed(1000 + span)
    index = [37, 150, 11, 200]
    B = len(index)
    q = torch.randn((B, span, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    table = perm[:B * MB].reshape(B, MB).to(torch.int32)
    table[2] = 0
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    depths = torch.from_numpy(shape.depths).cuda()
    bits = torch.from_numpy(shape.bits).cuda()
    max_live = (idx.max() + span).to(torch.int32)
    args = (q, k, v, table, idx, depths, bits)
    kw = dict(window=window, max_live=max_live)

    out = ta.tree_flash_attention(*args, **kw)
    ref = ta.plain(*args, **kw)
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)

    # library yardstick: SDPA over a gathered, head-expanded view with the
    # tree mask as attn_mask
    S = max(index) + span
    cols = torch.arange(S, dtype=torch.int32, device="cuda")
    blk = table.long()[:, cols.long() // BS]
    kg = k[blk, cols.long() % BS].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = v[blk, cols.long() % BS].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    qg = q.permute(0, 2, 1, 3)
    mask = _tree_mask(idx, cols, depths, bits, window)        # [B, span, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    ms = timer(lambda: ta.tree_flash_attention(*args, **kw))
    plain_ms = timer(lambda: ta.plain(*args, **kw), iters=5)
    library_ms = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask[:, None]))

    # least work: each row's live KV (index + span tokens) read once per
    # kv-head, q read and out written once, the table and the tree arrays;
    # 4 flops per (query head, visible key, d) over the mask's visible pairs
    esz = q.element_size()
    live = [i + span for i in index]
    nbytes = (2 * q.numel() * esz + sum(live) * Kv * D * 2 * esz
              + table.numel() * 4 + B * 4 + 2 * span * 4)
    flops = 4 * H * D * int(mask.sum())
    p = pa.plan(dtype, B, span, H, Kv, D, BS, MB)
    case = {"case": "tree_attention", "tree": name, "span": span, "B": B,
            "window": window, "dtype": str(dtype).replace("torch.", ""),
            **agree, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, flops, dtype),
            "chunks": p.chunks, "row_tile": p.row_tile,
            "row_tiles": p.row_tiles, "headline": headline}
    emit(case)
    if not agree["ok"]:
        raise SystemExit(f"tree attention disagrees with its plain version: {case}")
    return case


def flash_case(timer, name, H, Kv, D, S, dtype, *, B=2, window=None,
               causal=True, s_valid=None, headline=False):
    """No-cache flash attention at [B, S] queries and keys (positions from
    0 on both sides), against its plain version."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(H * 10000 + S)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, Kv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, Kv, D), generator=g, device="cuda").to(dtype)
    kw = dict(window=window, causal=causal, s_valid=s_valid)

    out = fa.flash_attention(q, k, v, **kw)
    ref = fa.plain(q, k, v, **kw)
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)

    # library yardstick: SDPA over head-expanded K/V with the same mask
    # (is_causal where the mask is plain causal, so SDPA may pick its
    # flash backend)
    pos = torch.arange(S, device="cuda")
    n_valid = S if s_valid is None else s_valid
    mask = (pos[None, :] < n_valid).expand(S, S)
    if causal:
        mask = mask & (pos[:, None] >= pos[None, :])
    if window is not None:
        mask = mask & ((pos[:, None] - pos[None, :]).abs() < window)
    qg = q.permute(0, 2, 1, 3)
    kg = k.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = v.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain_causal = causal and window is None and n_valid == S
    if plain_causal:
        def library():
            return sdpa(qg, kg, vg, is_causal=True)
    else:
        def library():
            return sdpa(qg, kg, vg, attn_mask=mask)

    ms = timer(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = timer(lambda: fa.plain(q, k, v, **kw), iters=5)
    library_ms = timer(library)
    row_tile = fa.plan(dtype, B, S, H, Kv, D, window,
                       sms=sm_count(q.device)).row_tile

    # least work: q read and out written once, the s_valid keys and values
    # read once per kv-head; 4 flops per (query head, visible pair, d)
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + 2 * B * n_valid * Kv * D * esz
    flops = 4 * B * H * D * int(mask.sum())
    case = {"case": "flash_attention", "geometry": name, "B": B, "S": S,
            "window": window, "causal": causal, "s_valid": s_valid,
            "dtype": str(dtype).replace("torch.", ""), **agree,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "sdpa(is_causal)" if plain_causal else "sdpa(attn_mask)",
            **bound(nbytes, flops, dtype), "row_tile": row_tile,
            "headline": headline}
    emit(case)
    if not agree["ok"]:
        raise SystemExit(f"flash attention disagrees with its plain version: {case}")
    return case


def flash_cases(timer):
    """The main path's shapes first (T = 64 + 64 + GAMMA + 2 = 134), then
    other lengths, a window, non-causal and a masked KV tail."""
    g3, g1 = ("llama3.2-3b", 24, 8, 128), ("llama3.2-1b", 32, 8, 64)
    T = NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2
    cases = [flash_case(timer, *geom, T, dtype,
                        headline=(geom is g3 and dtype == torch.bfloat16))
             for geom in (g3, g1) for dtype in (torch.float32, torch.bfloat16)]
    cases += [flash_case(timer, *g3, S, torch.bfloat16) for S in (1, 17, 1100, 2048)]
    cases.append(flash_case(timer, *g3, T, torch.float32, window=8))
    cases.append(flash_case(timer, *g1, T, torch.bfloat16, causal=False))
    cases.append(flash_case(timer, *g3, T, torch.float32, s_valid=100))
    return cases


def ssd_inputs(b, l, h, p, n, *, impulse=False, per_head=False):
    """SSD scan inputs as ``ssm_mix`` hands them (B and C one group
    broadcast to the heads by a stride-0 view, x and dA contiguous), seeded
    by the shape, or the JAX kernel test's impulse (one input at t = 0,
    constant decay); ``per_head``: B and C copied out per head (a nonzero
    head stride, as the JAX function's signature allows)."""
    g = torch.Generator(device="cuda").manual_seed(b * l * h + n)
    if impulse:
        x = torch.zeros((b, l, h, p), device="cuda")
        x[0, 0, 0, :] = 1.0
        dA = torch.full((b, l, h), -0.05, device="cuda")
        Bm = torch.full((b, l, 1, n), 0.5, device="cuda").expand(b, l, h, n)
        Cm = torch.full((b, l, 1, n), 0.5, device="cuda").expand(b, l, h, n)
    else:
        x = torch.randn((b, l, h, p), generator=g, device="cuda")
        dA = -(torch.rand((b, l, h), generator=g, device="cuda") * 0.49 + 0.01)
        Bm = (torch.randn((b, l, 1, n), generator=g, device="cuda") * 0.5).expand(b, l, h, n)
        Cm = (torch.randn((b, l, 1, n), generator=g, device="cuda") * 0.5).expand(b, l, h, n)
    if per_head:
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    return x, dA, Bm, Cm


def ssd_flops(b, l, h, p, n, chunk, shared):
    """The chunked algorithm's flops over the real rows: per chunk of nv
    rows, the causal scores (2n per visible pair; once per batch row when
    B and C are one group over the heads, else per head) and, per head,
    their product with X (2p per pair), the state read (2pn per row, after
    the first chunk) and the state update (2pn per chunk row, where a chunk
    follows)."""
    n_chunks = -(-l // chunk)
    scores = per_head = 0
    for c in range(n_chunks):
        nv = min(chunk, l - c * chunk)
        pairs = nv * (nv + 1) // 2
        scores += pairs * 2 * n
        per_head += pairs * 2 * p
        per_head += (c > 0) * nv * 2 * p * n + (c + 1 < n_chunks) * chunk * 2 * p * n
    return scores * b * (1 if shared else h) + per_head * b * h


def ssd_case(timer, name, b, l, h, p, n, chunk, *, impulse=False,
             headline=False, per_head=False):
    """The SSD scan kernel against its plain version at [b, l, h, p] with
    state size n (``ssd_inputs``), with the launch plan's head groups and
    blocks."""
    from repro_torch import device as devices
    from repro_torch.kernels import ssd_scan as ss
    args = ssd_inputs(b, l, h, p, n, impulse=impulse, per_head=per_head)
    x, dA, Bm, Cm = args

    out = ss.ssd_scan(*args, chunk=chunk)
    ref = ss.plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    agree = agreement(out, ref, torch.float32)
    ok = agree["ok"] and bool(torch.isfinite(out).all())
    if impulse:       # the response decays through every chunk boundary
        resp = out[0, :, 0, 0]
        ok = ok and bool(resp[9] > resp[17] > resp[31] > 0)

    ms = timer(lambda: ss.ssd_scan(*args, chunk=chunk))
    plain_ms = timer(lambda: ss.plain(*args, chunk=chunk), iters=5)

    # least work: each input's distinct elements read once (B and C are one
    # group shared by all heads), y written once; ssd_flops
    def distinct(t):
        return int(np.prod([d for d, st in zip(t.shape, t.stride()) if st != 0]))
    nbytes = 4 * (sum(distinct(t) for t in args) + out.numel())
    shared = ss.shares_scores(Bm, Cm)
    flops = ssd_flops(b, l, h, p, n, chunk, shared)
    pl = ss.plan(b, l, h, p, n, chunk, devices.sm_count(x.device), shared=shared)
    case = {"case": "ssd_scan", "shape": name, "b": b, "l": l, "h": h, "p": p,
            "n": n, "chunk": chunk, "dtype": "float32", **agree, "ok": ok,
            "heads_per_block": pl.heads, "row_tile": pl.row_tile,
            "y_blocks": pl.y_blocks, "state_blocks": pl.state_blocks,
            "carry_blocks": pl.carry_blocks, "mflop": flops / 1e6,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the chunked SSD scan",
            **bound(nbytes, flops, torch.float32), "headline": headline}
    emit(case)
    if not ok:
        raise SystemExit(f"ssd_scan disagrees with its plain version: {case}")
    return case


def ssd_l_invariance():
    """The SSD kernel's rows must not depend on the buffer length: at the
    main path's target and drafter shapes, rows 0..127 of a call at l = 134
    bit-equal to the call at l = 128 on the same inputs (the spec and AR
    buffers of the no-cache engine), and rows 0..1023 at l = 1100 to the
    call at l = 1024."""
    from repro_torch.kernels import ssd_scan as ss
    checks = []
    for h in (48, 24):
        for long, short in ((134, 128), (1100, 1024)):
            args = ssd_inputs(2, long, h, 64, 128)
            y_long = ss.ssd_scan(*args, chunk=128)
            y_short = ss.ssd_scan(*(t[:, :short] for t in args), chunk=128)
            torch.cuda.synchronize()
            checks.append({"h": h, "l": long, "rows": short,
                           "bit_equal": bool(torch.equal(y_long[:, :short], y_short)),
                           "max_abs_diff": float((y_long[:, :short] - y_short).abs().max())})
    case = {"case": "ssd_l_invariance", "checks": checks,
            "ok": all(c["bit_equal"] for c in checks)}
    emit(case)
    if not case["ok"]:
        raise SystemExit(f"ssd_scan rows depend on the buffer length: {case}")
    return case


def ssd_cases(timer):
    """The mamba2 smoke shape, the main path's target and drafter shapes
    (T = 64 + 64 + GAMMA + 2 = 134 rows, two chunks of 128), a long
    sequence (9 chunks of state carry), the target shape with B and C per
    head (no shared scores), p and n that are not multiples of 4 (rows the
    kernel stages with plain loads, one case with head groups of 4) and the
    impulse."""
    T = NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2
    return [ssd_case(timer, "smoke", 2, 20, 8, 32, 16, 8),
            ssd_case(timer, "mamba2-780m", 2, T, 48, 64, 128, 128, headline=True),
            ssd_case(timer, "mamba2-draft", 2, T, 24, 64, 128, 128),
            ssd_case(timer, "mamba2-780m long", 2, 1100, 48, 64, 128, 128),
            ssd_case(timer, "mamba2-780m per-head B/C", 2, T, 48, 64, 128, 128,
                     per_head=True),
            ssd_case(timer, "ragged p, n", 2, 21, 4, 10, 6, 8),
            ssd_case(timer, "ragged p, n, head groups", 2, 141, 24, 6, 10, 128),
            ssd_case(timer, "impulse", 1, 32, 1, 4, 4, 8, impulse=True)]


def int8_case(timer, name, M, K, N, out_dtype, headline=False):
    """The int8 matmul kernel against its plain version (the same exact
    int32 sums and fp32 epilogue: bit-equal expected), with torch._int_mm
    plus the same rescale as the library yardstick where it applies
    (M > 16, K and N multiples of 8)."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import int8_matmul as im
    g = torch.Generator(device="cuda").manual_seed(M * 7 + K * 3 + N)
    x_q = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    sx = torch.full((), 0.0123, device="cuda")
    sw = torch.rand((N,), generator=g, device="cuda") * 9e-3 + 1e-3
    args = (x_q, w_q, sx, sw)

    out = im.int8_matmul(*args, out_dtype=out_dtype)
    ref = im.plain(*args, out_dtype)
    torch.cuda.synchronize()
    agree = agreement(out, ref, out_dtype)
    bit_equal = bool(torch.equal(out, ref))

    ms = timer(lambda: im.int8_matmul(*args, out_dtype=out_dtype))
    plain_ms = timer(lambda: im.plain(*args, out_dtype))
    library_ms = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        w_cm = w_q.t().contiguous().t()          # column-major, as cuBLASLt takes it
        library_ms = timer(lambda: (torch._int_mm(x_q, w_cm).float() * sx
                                    * sw).to(out_dtype))
    splits = im.plan(M, K, N, sm_count(x_q.device)).splits

    esz = out.element_size()
    nbytes = M * K + K * N + 4 + 4 * N + M * N * esz
    case = {"case": "int8_matmul", "shape": name, "M": M, "K": K, "N": N,
            "out_dtype": str(out_dtype).replace("torch.", ""), **agree,
            "bit_equal": bit_equal, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch._int_mm + rescale",
            **bound(nbytes, 2 * M * K * N, torch.int8), "splits": splits,
            "headline": headline}
    emit(case)
    if not agree["ok"]:
        raise SystemExit(f"int8_matmul disagrees with its plain version: {case}")
    return case


def int8_cases(timer):
    """The eight projections of the w8a8 Llama-3.2-3B/1B pair at the main
    path's M = 2 x 134 = 268 (bf16 out), then M = 1 and M = 256, JAX's
    ragged sweep shapes and fp32 out."""
    M = 2 * (NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2)
    proj = [("3b q/o", 3072, 3072), ("3b k/v", 3072, 1024),
            ("3b gate/up", 3072, 8192), ("3b down", 8192, 3072),
            ("1b q/o", 2048, 2048), ("1b k/v", 2048, 512),
            ("1b gate/up", 2048, 8192), ("1b down", 8192, 2048)]
    cases = [int8_case(timer, name, M, K, N, torch.bfloat16,
                       headline=(name == "3b gate/up")) for name, K, N in proj]
    cases += [int8_case(timer, "3b gate/up", m, 3072, 8192, torch.bfloat16)
              for m in (1, 256)]
    cases += [int8_case(timer, "ragged", 37, 200, 150, torch.bfloat16),
              int8_case(timer, "ragged", 1, 128, 257, torch.bfloat16),
              int8_case(timer, "3b q/o", M, 3072, 3072, torch.float32),
              int8_case(timer, "ragged", 37, 200, 150, torch.float32)]
    return cases


# --------------------------------------------------------------- serving
def serve(mt, md, pt, pd, reqs, scfg, gamma, device):
    from repro_torch.serving import PagedSpecServer, ServeRequest
    srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=gamma, device=device)
    for i, (prompt, new) in enumerate(reqs):
        srv.submit(ServeRequest(i, prompt, new))
    done = {r.rid: r.tokens for r in srv.run()}
    return srv, done


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def to_cuda(tree):
    if isinstance(tree, dict):
        return {k: to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cuda(v) for v in tree]
    return tree.cuda()


def smoke_exactness():
    """The drafter is the target's own first L-1 layers (shared embedding
    and head), and the embedding is drawn at std d**-0.5 rather than 1.0
    (at std 1.0 both models echo the last token and every draft is
    accepted). So the pair disagrees in some rounds, and the run goes
    through partial accepts, per-row rollback of KV slots the kernel has
    written, and correction tokens."""
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    from repro_torch.serving import SchedulerConfig
    gamma = 3
    cfg = registry.smoke_config("llama3.2-1b")
    cfg = cfg.replace(embed_init_scale=cfg.d_model ** -0.5)
    mt = build_model(cfg)
    md = build_model(cfg.replace(num_layers=cfg.num_layers - 1, name="draft"))
    pt = mt.init(0, "cuda")
    pd = {**pt, "layers": pt["layers"][:-1]}
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 30))).astype(np.int32),
             int(rng.integers(4, 24))) for _ in range(6)]
    scfg = SchedulerConfig(max_batch=3)
    spec, out_spec = serve(mt, md, pt, pd, reqs, scfg, gamma, "cuda")
    ar, out_ar = serve(mt, md, pt, pd, reqs, scfg, 0, "cuda")
    cpu, out_cpu = serve(mt, md, to_cpu(pt), to_cpu(pd), reqs, scfg, gamma, "cpu")
    hist = spec.metrics.summary()["accept_hist"][:gamma + 1]
    same_ar = all(np.array_equal(out_spec[i], out_ar[i]) for i in range(len(reqs)))
    same_cpu = all(np.array_equal(out_spec[i], out_cpu[i]) for i in range(len(reqs)))
    info = {"phase": "smoke_exactness", "requests": len(reqs),
            "completed": len(out_spec), "spec_rounds": spec.total_rounds,
            "ar_rounds": ar.total_rounds, "accept_hist": hist.tolist(),
            "spec_equals_ar": same_ar, "gpu_equals_cpu": same_cpu}
    emit(info)
    if hist[1:gamma].sum() == 0:
        raise SystemExit(f"no round accepted part of its draft: {info}")
    if len(out_spec) != len(reqs) or not (same_ar and same_cpu):
        raise SystemExit(f"smoke-width exactness failed: {info}")


def tree_serve(mt, md, pt, pd, reqs, width, depth, device, *, audit=False,
               before_prefill=None):
    """Paged tree rounds over ``reqs`` [(prompt, new)], one row each, until
    every row holds prompt + new tokens. Each row's first P-1 tokens are
    prefilled through a one-row view of each cache (its own table row,
    index 0, the pools shared in place, as the server's prefill does); the
    first round consumes the last prompt token. ``before_prefill`` runs
    just before the prefills. Returns (tokens per row, per-round log,
    rounds seconds, total seconds)."""
    from repro_torch.cache.ops import PAGED
    from repro_torch.cache.paged_kv import BlockAllocator
    from repro_torch.core import rounds
    from repro_torch.obs import clock
    BS, MB, NB = 16, 24, 256
    B = len(reqs)
    plen = np.asarray([len(p) for p, _ in reqs], np.int32)
    want = plen + np.asarray([n for _, n in reqs], np.int32)
    geom = dict(num_blocks=NB, block_size=BS, max_blocks_per_row=MB)
    at, ad = BlockAllocator(NB, BS, MB, B), BlockAllocator(NB, BS, MB, B)
    tokens = np.zeros((B, MB * BS), np.int32)
    for b, (prompt, _) in enumerate(reqs):
        tokens[b, :len(prompt)] = prompt
        if not (at.ensure(b, len(prompt)) and ad.ensure(b, len(prompt))):
            raise SystemExit(f"tree serve: no room for row {b}")
    tcache = {**PAGED.init(mt, B, device=device, **geom),
              "block_table": at.device_table(device)}
    dcache = {**PAGED.init(md, B, device=device, **geom),
              "block_table": ad.device_table(device)}
    if before_prefill is not None:
        before_prefill()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = clock.perf()
    zero = torch.zeros((1,), dtype=torch.int32, device=device)
    for b, (prompt, _) in enumerate(reqs):
        toks = torch.from_numpy(prompt[None, :-1]).to(device)
        mt.apply(pt, toks, {**tcache, "block_table": tcache["block_table"][b:b + 1],
                            "index": zero})
        md.apply(pd, toks, {**dcache, "block_table": dcache["block_table"][b:b + 1],
                            "index": zero}, logits_slice="last")
    length = torch.from_numpy(plen).to(device)
    state = rounds.RoundState(
        tokens=torch.from_numpy(tokens).to(device), length=length,
        dcache={**dcache, "index": length - 1},
        tcache={**tcache, "index": length - 1},
        active=torch.ones((B,), dtype=torch.bool, device=device),
        n_rounds=torch.zeros((), dtype=torch.int32, device=device),
        n_accepted=torch.zeros((B,), dtype=torch.int32, device=device),
        n_drafted=torch.zeros((), dtype=torch.int32, device=device))
    spec = rounds.RoundSpec(gamma=depth, policy=rounds.make_policy("tree", width))
    rnd = rounds.PagedTreeRound(mt, md, spec, at, ad)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = clock.perf()
    log, host_len = [], plen.copy()
    while (host_len < want).any():
        state = rnd(pt, pd, state)
        log.append({"accepted": (rnd.last_length - host_len - 1).tolist(),
                    "winner": rnd.last_winner.tolist()})
        host_len = rnd.last_length
        if audit:
            at.audit()
            ad.audit()
    out = state.tokens.cpu().numpy()
    t2 = clock.perf()
    return [out[b, :want[b]] for b in range(B)], log, t2 - t1, t2 - t0


def smoke_tree_exactness():
    """Paged tree rounds on the smoke pair of ``smoke_exactness`` (weights
    drawn with the CPU generator and copied to the card, so a CPU run
    predicts the card's): tree on the card, tree on the CPU and AR on the
    card must give identical tokens. The phase fails unless some round
    accepted part of a draft and some round's winner was not chain 0 —
    the adoption of a non-first branch and a compaction from scattered
    slots."""
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    from repro_torch.serving import SchedulerConfig
    W, D = 2, 3
    cfg = registry.smoke_config("llama3.2-1b")
    cfg = cfg.replace(embed_init_scale=cfg.d_model ** -0.5)
    mt = build_model(cfg)
    md = build_model(cfg.replace(num_layers=cfg.num_layers - 1, name="draft"))
    pt_cpu = mt.init(0, "cpu")
    pd_cpu = {**pt_cpu, "layers": pt_cpu["layers"][:-1]}
    pt, pd = to_cuda(pt_cpu), to_cuda(pd_cpu)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 30))).astype(np.int32),
             int(rng.integers(8, 24))) for _ in range(4)]
    gpu, log, _, _ = tree_serve(mt, md, pt, pd, reqs, W, D, "cuda", audit=True)
    cpu, _, _, _ = tree_serve(mt, md, pt_cpu, pd_cpu, reqs, W, D, "cpu", audit=True)
    _, out_ar = serve(mt, md, pt, pd, reqs, SchedulerConfig(max_batch=4), 0, "cuda")
    acc = [a for r in log for a in r["accepted"]]
    partial = sum(0 < a < D for a in acc)
    not_first = sum(w != 0 for r in log for w in r["winner"])
    same_cpu = all(np.array_equal(gpu[i], cpu[i]) for i in range(len(reqs)))
    same_ar = all(np.array_equal(gpu[i], out_ar[i]) for i in range(len(reqs)))
    info = {"phase": "smoke_tree_exactness", "width": W, "depth": D,
            "weights_sum": float(sum(t.double().sum() for t in (
                pt_cpu["embed"]["table"], pt_cpu["layers"][0]["attn"]["q"]["w"]))),
            "requests": len(reqs), "rounds": len(log),
            "accepted_per_round": [r["accepted"] for r in log],
            "winners": [r["winner"] for r in log],
            "partial_accepts": partial, "non_first_winners": not_first,
            "tree_gpu_equals_cpu": same_cpu, "tree_equals_ar": same_ar}
    emit(info)
    if partial == 0 or not_first == 0:
        raise SystemExit(f"tree exactness saw no partial accept or no "
                         f"non-first winner: {info}")
    if not (same_cpu and same_ar):
        raise SystemExit(f"smoke-width tree exactness failed: {info}")


def full_width_tree(mt, md, pt, pd, cfg, card):
    """The tree path at full width: ``PagedTreeRound`` (width 2, depth 4)
    over 4 ragged prompts, 32 new tokens each. Launch counts are set to 0
    just before the tree prefills and read just after the last round; the
    tokens must equal AR rounds' on the same prompts."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.serving import SchedulerConfig
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 121))).astype(np.int32),
             32) for _ in range(4)]
    # warm-up (cuBLAS handles for the verify shapes, the sort), not counted
    tree_serve(mt, md, pt, pd, [(reqs[0][0][:16], 8)], TREE_W, TREE_D, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero_counts():
        pa.paged_flash_attention.launches = 0
        ta.tree_flash_attention.launches = 0
        sv.blockwise_argmax.launches = 0

    out, log, rounds_s, wall = tree_serve(mt, md, pt, pd, reqs, TREE_W, TREE_D,
                                          "cuda", before_prefill=zero_counts)
    launches = {"tree_attention": ta.tree_flash_attention.launches,
                "paged_attention": pa.paged_flash_attention.launches,
                "blockwise_argmax": sv.blockwise_argmax.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rounds, prefills = len(log), len(reqs)
    expect = {"tree_attention": rounds * L_t,
              "paged_attention": rounds * TREE_D * L_d + prefills * (L_t + L_d),
              "blockwise_argmax": rounds}
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=256,
                           max_blocks_per_row=16)
    _, out_ar = serve(mt, md, pt, pd, reqs, scfg, 0, "cuda")
    same_ar = all(np.array_equal(out[i], out_ar[i]) for i in range(len(reqs)))
    acc = [a for r in log for a in r["accepted"]]
    generated = sum(n for _, n in reqs)
    info = {"phase": "full_width_tree", "target": mt.cfg.name,
            "drafter": md.cfg.name, "dtype": mt.cfg.dtype, "card": card,
            "width": TREE_W, "depth": TREE_D, "requests": len(reqs),
            "prompt_lens": [len(p) for p, _ in reqs], "new_tokens": 32,
            "rounds": rounds, "prefills": prefills, "wall_s": wall,
            "rounds_s": rounds_s, "ms_per_round": rounds_s / rounds * 1e3,
            "tokens_per_s": generated / wall,
            "mean_accepted_per_round": float(np.mean(acc)),
            "winners": [r["winner"] for r in log],
            "peak_memory_gib": peak, "launches": launches,
            "expected_launches": expect, "tree_equals_ar": same_ar}
    emit(info)
    if launches != expect:
        raise SystemExit(f"tree kernel launches {launches} != expected {expect}")
    if not same_ar:
        raise SystemExit(f"full-width tree tokens differ from AR: {info}")

    def run():
        _, log, _, _ = tree_serve(mt, md, pt, pd, reqs, TREE_W, TREE_D, "cuda")
        return len(log), len(reqs)
    profile("profile_tree", run, pt, pd, card)
    return launches


def full_width(mt, md, pt, pd, cfg, card):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.obs import clock
    from repro_torch.serving import SchedulerConfig
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=256,
                           max_blocks_per_row=16)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 121))).astype(np.int32),
             int(rng.integers(32, 65))) for _ in range(8)]
    # warm-up (cuBLAS handles, allocator), not counted
    serve(mt, md, pt, pd, [(reqs[0][0][:16], 8)], scfg, GAMMA, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    pa.paged_flash_attention.launches = 0
    sv.blockwise_argmax.launches = 0
    t0 = clock.perf()
    srv, done = serve(mt, md, pt, pd, reqs, scfg, GAMMA, "cuda")
    torch.cuda.synchronize()
    wall = clock.perf() - t0
    launches = {"paged_attention": pa.paged_flash_attention.launches,
                "blockwise_argmax": sv.blockwise_argmax.launches}

    rounds, prefills = srv.total_rounds, srv.n_prefills
    expect = {"paged_attention": rounds * (L_t + GAMMA * L_d) + prefills * (L_t + L_d),
              "blockwise_argmax": rounds}
    s = srv.metrics.summary()
    complete = (len(done) == len(reqs) and s["requests_failed"] == 0 and all(
        len(done[i]) == len(p) + new
        and ((done[i] >= 0) & (done[i] < cfg.vocab_size)).all()
        and np.array_equal(done[i][:len(p)], p)
        for i, (p, new) in enumerate(reqs)))
    hist = s["accept_hist"][:GAMMA + 1]
    _, out_ar = serve(mt, md, pt, pd, reqs, scfg, 0, "cuda")
    same_ar = all(np.array_equal(done[i], out_ar[i]) for i in range(len(reqs)))
    info = {"phase": "full_width", "target": mt.cfg.name, "drafter": md.cfg.name,
            "dtype": mt.cfg.dtype, "card": card, "requests": len(reqs),
            "completed": len(done), "generated_tokens": s["total_generated_tokens"],
            "wall_s": wall, "tokens_per_s": s["total_generated_tokens"] / wall,
            "rounds": rounds, "ms_per_round": wall / rounds * 1e3,
            "prefills": prefills, "gamma": GAMMA, "alpha_hat": s["alpha_hat"],
            "mean_accepted_per_round": float((hist * np.arange(len(hist))).sum()
                                             / max(hist.sum(), 1)),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "expected_launches": expect,
            "all_complete_in_vocab": bool(complete), "spec_equals_ar": same_ar}
    emit(info)
    if not complete:
        raise SystemExit(f"full-width serving did not complete cleanly: {info}")
    if launches != expect:
        raise SystemExit(f"kernel launches {launches} != expected {expect}")
    if not same_ar:
        raise SystemExit(f"full-width spec tokens differ from AR: {info}")

    def run():
        srv, _ = serve(mt, md, pt, pd, reqs, scfg, GAMMA, "cuda")
        return srv.total_rounds, srv.n_prefills
    profile("profile", run, pt, pd, card)
    return launches


def _nocache_rounds(eng, pt, pd, prompt, max_new):
    """The rounds ``SpecEngine.generate`` runs, one at a time: (tokens,
    committed tokens per round)."""
    B, P = prompt.shape
    state = eng.prefill(pt, pd, prompt, P + max_new + eng.ecfg.gamma + 2)
    committed, length = [], P
    while length < P + max_new:
        state = eng.round_nocache(pt, pd, state)
        new = int(state.length)
        committed.append(new - length)
        length = new
    return state.tokens[:, :length].cpu().numpy(), committed


def calibrated_scale(model, params, tokens) -> float:
    """The w8a8 static activation scale: ``quant.int8.calibrate_act_scale``
    over the input of every linear in one unquantized forward of ``model``
    on ``tokens``, collected by a wrapper around ``layers.linear`` that is
    installed for that pass only."""
    from repro_torch.models import layers
    from repro_torch.quant import int8 as q8
    seen, real = [], layers.linear

    def collect(p, x):
        seen.append(x.detach().float().cpu())
        return real(p, x)
    layers.linear = collect
    try:
        dev = params["embed"]["table"].device
        model.apply(params, torch.as_tensor(tokens, device=dev))
    finally:
        layers.linear = real
    return q8.calibrate_act_scale(seen)


def smoke_nocache_exactness(arch="llama3.2-1b", phase="smoke_nocache_exactness",
                            w8a8=False):
    """The no-cache engine on the smoke pair of ``arch`` (the drafter is the
    target's first L-1 layers, embedding std d**-0.5; weights drawn on the
    CPU and copied to the card), gamma 4, six prompt batches of B=2: linear
    and multi-draft k=2 rounds on the card, the same on the CPU, and
    no-cache AR on the card must give identical tokens, and some round must
    commit part of its draft (batch_min commits the rows' minimum, so with
    two rows most rounds commit one token). ``w8a8``: both models through
    ``quantize_for_serving`` and every forward under ``act_quant`` with a
    static scale calibrated on the CPU, so every linear runs the int8
    kernel on the card."""
    from repro_torch.configs import registry
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    from repro_torch.models.model import build_model
    from repro_torch.quant import int8 as q8
    gamma, P, new = 4, 12, 24
    cfg = registry.smoke_config(arch)
    cfg = cfg.replace(embed_init_scale=cfg.d_model ** -0.5)
    mt = build_model(cfg)
    md = build_model(cfg.replace(num_layers=cfg.num_layers - 1, name="draft"))
    pt_cpu = mt.init(0, "cpu")
    pd_cpu = {**pt_cpu, "layers": pt_cpu["layers"][:-1]}
    prompts = [np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, P)).astype(np.int32)
               for seed in range(6)]
    quant, scale = contextlib.nullcontext, None
    if w8a8:
        scale = calibrated_scale(mt, pt_cpu, prompts[0])
        pt_cpu, pd_cpu = (q8.quantize_for_serving(pt_cpu),
                          q8.quantize_for_serving(pd_cpu))

        def quant():
            return q8.act_quant(static_scale=scale)
    pt, pd = to_cuda(pt_cpu), to_cuda(pd_cpu)
    with quant():
        ar = [autoregressive_generate(mt, pt, p, new).cpu().numpy() for p in prompts]
    for policy in ("linear", "multi"):
        eng = SpecEngine(mt, md, EngineConfig(gamma=gamma, draft_policy=policy,
                                              draft_k=2))
        info = {"phase": phase, "arch": arch, "policy": policy,
                "gamma": gamma, "batch": 2, "prompt_len": P, "new_tokens": new,
                "act_scale": scale, "rounds": 0, "accepted": 0,
                "accepted_per_round": [], "gpu_equals_cpu": True,
                "spec_equals_ar": True, "replay_equals_generate": True}
        for prompt, want in zip(prompts, ar):
            with quant():
                gpu, st_gpu = eng.generate(pt, pd, prompt, new)
                cpu, st_cpu = eng.generate(pt_cpu, pd_cpu, prompt, new)
                replay, committed = _nocache_rounds(eng, pt, pd, prompt, new)
            gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
            info["rounds"] += st_gpu["rounds"]
            info["accepted"] += st_gpu["accepted"]
            info["accepted_per_round"].append([c - 1 for c in committed])
            info["gpu_equals_cpu"] &= np.array_equal(gpu, cpu) and st_gpu == st_cpu
            info["spec_equals_ar"] &= np.array_equal(gpu[:, :P + new], want)
            info["replay_equals_generate"] &= np.array_equal(replay, gpu)
        info = {k: bool(v) if isinstance(v, np.bool_) else v for k, v in info.items()}
        info["partial_accepts"] = sum(0 < a < gamma for batch in info["accepted_per_round"]
                                      for a in batch)
        emit(info)
        if info["partial_accepts"] == 0:
            raise SystemExit(f"no no-cache round accepted part of its draft: {info}")
        if not (info["gpu_equals_cpu"] and info["spec_equals_ar"]
                and info["replay_equals_generate"]):
            raise SystemExit(f"smoke-width no-cache exactness failed: {info}")


def kernel_counters():
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import tree_attention as ta
    return {"flash_attention": fa.flash_attention,
            "blockwise_argmax": sv.blockwise_argmax,
            "paged_attention": pa.paged_flash_attention,
            "tree_attention": ta.tree_flash_attention,
            "ssd_scan": ss.ssd_scan, "int8_matmul": im.int8_matmul}


def nocache_prompts(cfg):
    return np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, NOCACHE_PROMPT)).astype(np.int32)


def nocache_phase(phase, profile_phase, mt, md, pt, pd, cfg, card, per_pass,
                  quant=contextlib.nullcontext, extra=None):
    """The paper's no-cache mode at full width through ``launch.serve``: 4
    requests of 64 prompt + 64 new tokens, two waves of 2, gamma 4, every
    forward under ``quant()``. Every kernel's launch count is set to 0 just
    before each serve and read just after: ``per_pass`` maps a kernel to its
    launches in one (target, drafter) forward; every spec round runs GAMMA
    drafter passes, one target pass and one argmax launch, each AR step one
    target pass, and no other kernel launches. Then the same spec serve
    runs once more under ``torch.profiler``."""
    from repro_torch.launch import serve as serve_cli
    counters = kernel_counters()
    R, batch = 4, 2
    prompts = nocache_prompts(cfg)
    with quant():
        # warm-up (cuBLAS handles, allocator), not counted
        for gamma in (GAMMA, 0):
            serve_cli.serve(mt, md, pt, pd, prompts[:batch], 4, gamma=gamma,
                            batch=batch)
    torch.cuda.synchronize()

    def counted(gamma):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with quant():
            toks, s = serve_cli.serve(mt, md, pt, pd, prompts, NOCACHE_NEW,
                                      gamma=gamma, batch=batch)
        torch.cuda.synchronize()
        s["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        s["launches"] = {name: fn.launches for name, fn in counters.items()}
        return toks, s

    spec, s = counted(GAMMA)
    ar, s_ar = counted(0)
    rounds, steps = s["rounds"], s_ar["rounds"]
    expect = {name: rounds * (GAMMA * per_pass.get(name, (0, 0))[1]
                              + per_pass.get(name, (0, 0))[0])
              for name in counters}
    expect["blockwise_argmax"] = rounds
    expect_ar = {name: steps * per_pass.get(name, (0, 0))[0] for name in counters}
    expect_ar["blockwise_argmax"] = 0
    in_vocab = bool(((spec >= 0) & (spec < cfg.vocab_size)).all())
    same_ar = bool(np.array_equal(spec, ar))
    info = {"phase": phase, "target": mt.cfg.name,
            "drafter": md.cfg.name, "dtype": mt.cfg.dtype, "card": card,
            **(extra or {}),
            "requests": R, "batch": batch, "waves": s["waves"],
            "prompt_len": NOCACHE_PROMPT, "new_tokens": NOCACHE_NEW,
            "buffer_len": NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2,
            "gamma": GAMMA, "rounds": rounds,
            "mean_accepted_per_round": s["accepted"] / rounds,
            "wall_s": s["seconds"], "ms_per_round": s["seconds"] / rounds * 1e3,
            "tokens_per_s": s["tokens_per_s"],
            "peak_memory_gib": s["peak_memory_gib"],
            "ar_steps": steps, "ar_wall_s": s_ar["seconds"],
            "ar_ms_per_step": s_ar["seconds"] / steps * 1e3,
            "ar_tokens_per_s": s_ar["tokens_per_s"],
            "ar_peak_memory_gib": s_ar["peak_memory_gib"],
            "launches": s["launches"], "expected_launches": expect,
            "ar_launches": s_ar["launches"], "expected_ar_launches": expect_ar,
            "spec_equals_ar": same_ar, "in_vocab": in_vocab}
    emit(info)
    if s["launches"] != expect or s_ar["launches"] != expect_ar:
        raise SystemExit(f"no-cache kernel launches differ from the path's: {info}")
    if not (same_ar and in_vocab):
        raise SystemExit(f"full-width no-cache tokens differ from AR: {info}")

    def run():
        with quant():
            _, st = serve_cli.serve(mt, md, pt, pd, prompts, NOCACHE_NEW,
                                    gamma=GAMMA, batch=batch)
        return st["rounds"], 0
    profile(profile_phase, run, pt, pd, card)
    return s["launches"]


def full_width_nocache(mt, md, pt, pd, cfg, card):
    """The paper's pair (bf16): one flash launch per layer of each pass."""
    per_pass = {"flash_attention": (mt.cfg.num_layers, md.cfg.num_layers)}
    return nocache_phase("full_width_nocache", "profile_nocache", mt, md, pt,
                         pd, cfg, card, per_pass)


def full_width_w8a8(mt, md, pt, pd, cfg, card):
    """The paper's w8a8 deployment of the pair: both models through
    ``quantize_for_serving``, every forward under ``act_quant`` with a
    static scale calibrated over the linear inputs of one unquantized
    target pass on the first wave's prompts. Each layer runs its 7
    projections on the int8 kernel and one flash launch; the tied fp32
    unembedding stays as it is."""
    from repro_torch.quant import int8 as q8
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    scale = calibrated_scale(mt, pt, nocache_prompts(cfg)[:2])
    qt, qd = q8.quantize_for_serving(pt), q8.quantize_for_serving(pd)
    per_pass = {"flash_attention": (L_t, L_d), "int8_matmul": (7 * L_t, 7 * L_d)}

    def quant():
        return q8.act_quant(static_scale=scale)
    launches = nocache_phase("full_width_w8a8", "profile_w8a8", mt, md, qt, qd,
                             cfg, card, per_pass, quant, {"act_scale": scale})
    del qt, qd
    torch.cuda.empty_cache()
    return launches


def full_width_ssm(card):
    """Mamba-2 at full width: the mamba2-780m target and its registered
    drafter (bf16, seeded random weights), one SSD launch per layer of each
    pass and nothing else but the argmax."""
    from repro_torch.launch.cli_args import build_pair
    mt, md, pt, pd, cfg = build_pair("mamba2-780m", smoke=False, device="cuda")
    per_pass = {"ssd_scan": (mt.cfg.num_layers, md.cfg.num_layers)}
    launches = nocache_phase("full_width_ssm", "profile_ssm", mt, md, pt, pd,
                             cfg, card, per_pass)
    buffer_invariance(mt, pt, cfg, card)
    return launches


def buffer_invariance(mt, pt, cfg, card):
    """A reading, not a check: the full-width target's no-cache forward on
    a T=128 buffer (the AR buffer) and on a T=134 buffer sharing its first
    128 tokens (the spec buffer). Are logits rows 0..127 bit-equal (the
    cuBLAS GEMMs of the linears may differ with T)? If not, their max |d|
    and the smallest top-1 margin among those rows."""
    T_ar = NOCACHE_PROMPT + NOCACHE_NEW
    T_spec = T_ar + GAMMA + 2
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, T_spec)).astype(np.int64)).cuda()
    with torch.no_grad():
        spec, _, _ = mt.apply(pt, toks)
        ar, _, _ = mt.apply(pt, toks[:, :T_ar])
    torch.cuda.synchronize()
    spec, ar = spec[:, :T_ar].float(), ar.float()
    equal = bool(torch.equal(spec, ar))
    info = {"phase": "buffer_invariance", "target": mt.cfg.name, "card": card,
            "buffers": [T_ar, T_spec], "rows": T_ar, "logits_bit_equal": equal}
    if not equal:
        top2 = ar.topk(2, dim=-1).values
        info["max_abs_diff"] = float((spec - ar).abs().max())
        info["min_top1_margin"] = float((top2[..., 0] - top2[..., 1]).min())
        info["argmax_equal"] = bool(torch.equal(spec.argmax(-1), ar.argmax(-1)))
    emit(info)
    return info


def _union(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def streamed_bytes(params) -> int:
    """Weight bytes one forward step must read: every layer tensor, the
    final norm and the table the unembedding reads (the fp32 copy when
    tied); the embedding lookup reads only a few rows and is left out."""
    def size(tree):
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(size(v) for v in tree)
        return tree.numel() * tree.element_size()
    emb = params["embed"]
    head = params.get("lm_head", {"t": emb.get("table_f32", emb["table"])})
    return size(params["layers"]) + size(params["final_norm"]) + size(head)


def port_kernel_sources() -> dict:
    """The __global__ functions of the port's CUDA sources: name -> file."""
    import re
    from repro_torch.kernels import build
    pattern = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)"
    return {fn: src.name for src in build.CSRC.glob("*.cu")
            for fn in re.findall(pattern, src.read_text())}


def profile(phase, run, pt, pd, card):
    """A serve once more under torch.profiler (``run()`` serves and returns
    its rounds and prefills): the device's busy time (the union of the CUDA
    kernels' intervals), its idle share of the wall time, kernel launches
    per round and the device time by kernel, largest first. The profiler
    slows the host, so this run's wall time is not the throughput. The
    port's kernels are also listed alone, in device ms per round."""
    from repro_torch.obs import clock
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = clock.perf()
        rounds, prefills = run()
        torch.cuda.synchronize()
        wall = clock.perf() - t0
    # the profiler's raw device events: building its FunctionEvent tree
    # (prof.events()) would take minutes of host time for ~10^5 launches
    spans, by_name, by_file = [], {}, {}
    sources, fn_of = port_kernel_sources(), {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            s, d = ev.start_ns(), ev.duration_ns()
            spans.append((s, s + d))
            name = ev.name()
            by_name[name] = by_name.get(name, 0) + d
            if name not in fn_of:       # the function and template arguments
                fn = name.removeprefix("void ").split("(anonymous namespace)::", 1)[-1]
                fn_of[name] = fn.split("(", 1)[0]
            src = sources.get(fn_of[name].split("<", 1)[0])
            if src:
                by_file.setdefault(src, []).append((s, s + d))
    busy_s = _union(spans) / 1e9 if spans else None   # None: not measured
    # the port's own kernels (the __global__ functions of csrc/*.cu), by
    # function and template arguments, in ms per round; and the device
    # time of each source's kernels together (the union of their spans: a
    # kernel launched by PDL has a span that includes its wait on the
    # kernel before it, so the sum overstates)
    port = {}
    for name, ns in by_name.items():
        if sources.get(fn_of.get(name, "").split("<", 1)[0]):
            port[fn_of[name]] = port.get(fn_of[name], 0) + ns / 1e6 / rounds
    round_bytes = streamed_bytes(pt) + GAMMA * streamed_bytes(pd)
    emit({"phase": phase, "card": card, "rounds": rounds,
          "prefills": prefills, "wall_s": wall, "device_busy_s": busy_s,
          "device_idle_share": None if busy_s is None else 1 - busy_s / wall,
          "kernel_launches": len(spans),
          "kernel_launches_per_round": len(spans) / rounds,
          "weight_bytes_per_round": round_bytes,
          "weight_floor_ms_per_round": round_bytes / HBM_BYTES_PER_S * 1e3,
          "top_kernels_s": [[n[:90], ns / 1e9] for n, ns in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:12]],
          "port_kernels_ms_per_round": port,
          "port_sources_busy_ms_per_round": {
              src: _union(iv) / 1e6 / rounds for src, iv in sorted(by_file.items())}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.obs import clock
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = clock.perf()
    paths = build.build_all()
    for name in paths:
        build.load(name)
    print(f"build: {clock.perf() - t0:.3f} s wall for {sorted(paths)}", flush=True)
    for name, log in sorted(build.build_log.items()):
        regs = [ln.strip() for ln in log["ptxas"].splitlines()
                if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        print(f"build {name}: {log['seconds']:.3f} s; " + " | ".join(regs), flush=True)

    timer = Timer()
    timer_floor(timer)
    att = []
    for geom, H, Kv, D in (("llama3.2-3b", 24, 8, 128), ("llama3.2-1b", 32, 8, 64)):
        for Q in (1, GAMMA + 1, 127):
            for dtype in (torch.float32, torch.bfloat16):
                att.append(attention_case(
                    timer, geom, H, Kv, D, Q, dtype,
                    headline=(geom == "llama3.2-1b" and Q == 1
                              and dtype == torch.bfloat16)))
    arg = argmax_case(timer)
    from repro_torch.core.tree import TreeShape, chain_tree
    trees = [("chain_tree(2,4)", chain_tree(TREE_W, TREE_D), None),
             ("chain_tree(5,6)", chain_tree(5, 6), None),
             # root -> {1, 2}; 1 -> {3, 4}; 2 -> {5}; 4 -> {6}
             ("irregular", TreeShape(parents=(0, 0, 1, 1, 2, 4)), None)]
    tree_cases = [tree_attention_case(timer, name, shape, dtype, window,
                                      headline=(name == "chain_tree(2,4)"
                                                and dtype == torch.bfloat16))
                  for name, shape, window in trees
                  for dtype in (torch.float32, torch.bfloat16)]
    tree_cases += [tree_attention_case(timer, "chain_tree(2,4)",
                                       chain_tree(TREE_W, TREE_D), dtype, window=8)
                   for dtype in (torch.float32, torch.bfloat16)]
    for geom, H, Kv, D in (("llama3.2-3b", 24, 8, 128), ("llama3.2-1b", 32, 8, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            q_invariance(geom, H, Kv, D, dtype)
    fl_cases = flash_cases(timer)
    ssd = ssd_cases(timer)
    ssd_l_invariance()
    i8 = int8_cases(timer)
    del timer

    smoke_exactness()
    smoke_tree_exactness()
    smoke_nocache_exactness()
    smoke_nocache_exactness("mamba2-780m", "smoke_ssm_nocache_exactness")
    smoke_nocache_exactness("llama3.2-1b", "smoke_w8a8_exactness", w8a8=True)
    from repro_torch.launch.cli_args import build_pair
    pair = build_pair("llama3.2-3b", smoke=False, device="cuda")
    launches = full_width(*pair, card)
    tree_launches = full_width_tree(*pair, card)
    nocache_launches = full_width_nocache(*pair, card)
    w8a8_launches = full_width_w8a8(*pair, card)
    del pair
    torch.cuda.empty_cache()
    ssm_launches = full_width_ssm(card)

    head = next(c for c in att if c["headline"])
    tree_head = next(c for c in tree_cases if c["headline"])
    fl_head = next(c for c in fl_cases if c["headline"])
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:87",
         "launches": launches["paged_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in att),
         "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": head["library_ms"]},
        {"name": "blockwise_argmax", "route": "cuda",
         "source": "src/repro_torch/csrc/spec_verify.cu",
         "replaces": "src/repro/kernels/spec_verify.py:42",
         "launches": launches["blockwise_argmax"],
         "max_abs_err": arg["max_abs_err"], "ms": arg["kernel_ms"],
         "plain_ms": arg["plain_ms"], "bound_ms": arg["bound_ms"],
         "bound_by": arg["bound_by"], "library_ms": arg["library_ms"]},
        {"name": "tree_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/tree_attention.py:95",
         "launches": tree_launches["tree_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in tree_cases),
         "ms": tree_head["kernel_ms"], "plain_ms": tree_head["plain_ms"],
         "bound_ms": tree_head["bound_ms"], "bound_by": tree_head["bound_by"],
         "library_ms": tree_head["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:69",
         "launches": nocache_launches["flash_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in fl_cases),
         "ms": fl_head["kernel_ms"], "plain_ms": fl_head["plain_ms"],
         "bound_ms": fl_head["bound_ms"], "bound_by": fl_head["bound_by"],
         "library_ms": fl_head["library_ms"]},
    ]
    for name, src, replaces, n, cases in (
            ("int8_matmul", "int8_matmul.cu", "int8_matmul.py:40",
             w8a8_launches["int8_matmul"], i8),
            ("ssd_scan", "ssd_scan.cu", "ssd_scan.py:67",
             ssm_launches["ssd_scan"], ssd)):
        h = next(c for c in cases if c["headline"])
        kernels.append(
            {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/{replaces}", "launches": n,
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
             "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
             "library_ms": h["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
