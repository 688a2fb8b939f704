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
   (``"case": "attention_q_invariance"``). Then paged attention as a
   prefill chunk launches it (``"case": "paged_chunk"``): bf16, B=1, Q=64
   from starts 0, 448, 1984 and 3968 over a shuffled table of 256 blocks
   of 16 (4096 keys), the 3B and 1B geometries, with the same fields (the
   library: SDPA with the causal mask over the gathered keys); at starts
   448 and 1984 the chunk's rows must be bit-equal to the same rows of
   one whole call from 0 over a table just wide enough. Then paged
   attention as the cached dense forward launches it over a ring's
   identity view (``"case": "ring_view"``): bf16, B=2, a 144-slot ring,
   Q=1 and Q=5 at position 70 and Q=63 from 0, the 3B and 1B geometries,
   held against its plain version and against the concat read over
   ``slot_positions`` that JAX's ring computes.
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
   Two readings of the dense 3B target follow (they fail nothing;
   ``"phase": "buffer_invariance"``): its no-cache logits on a T=128
   buffer against a T=134 buffer, and one 600-token prompt's KV and
   last-position logits prefilled whole (one 639-token call, as the
   bucketed path does) against in chunks of 64. Then the main path with
   chunked prefill and the prefix pool (``"phase": "full_width_chunked"``):
   12 requests sharing a 512-token system prompt, chunks of 64, gamma 4;
   all six kernels' counts set to 0 just before and read just after must
   equal what the path implies (paged attention once per layer of every
   round's passes and every chunk program); the prefix hit tokens must
   equal the count worked out from the trace; AR rounds give the same
   tokens; overcommit 2.0 on a 96-block pool preempts with the same
   tokens; every server's block census balances; the bucketed path's
   tokens must be the same, or differ only where the readings explain it
   (within one bf16 step of the top-2 margin). Then the chunked serve runs
   once more under ``torch.profiler``, with the device time split between
   chunk programs and rounds (``"phase": "profile_chunked"``). Then the
   same serve traced (``"phase": "full_width_traced"``): (a) with an
   enabled ``repro_torch.obs.Tracer`` at gamma 4, it must give the
   untraced serve's tokens and launch counts, one round event per round
   with phase times on every speculative one, the metrics' alpha and a
   calibrated drift monitor; it prints the per-phase split of a round
   (draft, verify, commit, prefill, serve: ms per round, the events' mean
   phase times, the leaf phases' share of the serve span), the drift
   monitor's measured c and alerts, and the wall per round against the
   untraced serve's; (b) with gamma unpinned, so that the measured c
   drives Eq. (1): tokens == AR's, launches as each round's gamma implies;
   it prints every round's gamma and the gamma* of the measured c; (c) the
   no-cache engine of step 7 traced (``strategy="modular"``): tokens and
   launches equal to the untraced modular serve's, and its phase split.
   The Chrome traces go to build/traces/.
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
   so the SSD and int8 kernels must stay at 0 there. Then the cached
   engines on the same pair (``"phase": "full_width_cached"``): (a) the
   same traffic through ``launch.serve.serve(use_cache=True)`` on the ring
   KV cache: paged launches rounds x (4 * 16 + 28) + waves x (28 + 16), an
   argmax a round, the tokens equal to cached AR's, and compared with the
   no-cache serve's (a difference must sit at a near-tie: a top-2 margin
   within one bf16 step), profiled (``"profile_cached"``) and set beside
   the no-cache profile (``"phase": "cached_vs_nocache"``); (b)
   ``BatchedSpecEngine.generate`` at B=4 (``"full_width_batched_ring"``:
   every row == its cached AR, exact launches); (c) ring tree rounds W=2,
   depth 4 (``"full_width_ring_tree"``: tree 28 a round, the drafter's
   paged 16 * 4 a round + 16, the target's 28, tokens == AR). Then
   speculative sampling on the same traffic (``"phase":
   "full_width_sampled"``, T = 1): the no-cache and the cached engine
   through ``launch.serve.serve(greedy=False)``, each twice with one
   ``TorchKey`` seed (the same tokens both times; flash launches rounds x
   92 no-cache, paged rounds x 92 + waves x 44 cached, the argmax kernel
   none), each profiled (``"profile_sampled_nocache"``,
   ``"profile_sampled_cached"``) and set beside the greedy serve of this
   call; then the cached engine with the target drafting for itself
   (alpha_hat at least 0.9). Then the paper's planner and the ``Session``
   facade on the same pair (``"phase": "full_width_session"``): (a) the
   serve-paged CLI's spec for step 4's 8 ragged requests on the planner's
   block-8 geometry, gamma pinned to 4 (tokens == step 4's block-16
   serve) and adaptive (tokens == its AR serve), exact paged and argmax
   launches; (b) the serve CLI's no-cache plan, which step 7's no-cache
   serve ran (``launch.serve.serve`` plans its waves and runs them through
   ``Session.generate``); (c) a per-row plan (tokens == the B=4
   ``BatchedSpecEngine.generate``); (d) an adaptive single-stream cached
   plan (tokens == cached AR, its gamma trace printed); (e) a pinned tree
   plan (tokens == cached AR, 28 tree launches a round); (f) (a)'s pinned
   plan traced and re-planned from its drift monitor
   (``respec_from_drift``): c and gamma for the prior, the roofline and
   the measured c; the new plan must carry the measured c. Then
   plan-carried placement and the paged server's robustness layer
   (``"phase": "full_width_placed"``): (a) the default plan lowers to
   DEGENERATE, the CLI's ``1x1`` to the shared-device placement (both
   roles on cuda:0), ``2x6`` to the degenerate fallback; (b) the placed
   cached engine through ``Session``, overlap off and on, beside the
   unplaced one (tokens and rounds == the cached serve's, exact launches
   with one discarded round a wave under overlap; wall per round a
   reading); (c) the placed ``BatchedSpecEngine`` (tokens == (b) of the
   cached phase); (d) the placed paged server on step 4's trace (tokens ==
   step 4's, the audit balanced); (e) a seeded chaos serve under
   overcommit (tokens == step 4's, the pool whole, an injected drafter
   failure degraded to AR), a corrupt-output serve (the poisoned requests
   fail with the reason, the survivors exact), and a paged kernel made to
   fail inside a round: ``step()`` raises, nothing degrades.
8. The last two kernels against their plain versions: the SSD scan at the
   Mamba-2 smoke shape, the main path's target (48 heads) and drafter (24
   heads) shapes at T = 134, 1100 rows (9 chunks of state carry), the
   target shape with B and C copied per head, and the JAX kernel test's
   impulse (fp32, B and C a stride-0 view over heads, as the model hands
   them, except in the per-head case; no library call computes the scan),
   each with the plan's head groups and block counts; then, at the target
   and drafter shapes, SSD rows 0..127 at l = 134 must be bit-equal to the
   call at l = 128 and rows 0..1023 at l = 1100 to l = 1024
   (``"case": "ssd_l_invariance"``); the SSD scan as the cached Mamba-2
   prefill calls it (``"case": "ssd_state"``): 63 rows from a nonzero
   initial state with the final state returned, at the target and drafter
   shapes, then three chunks, and p and n not multiples of 4, y and the
   final state against ``ssd_chunked`` from the same state; the int8
   matmul at the eight projections of the w8a8 Llama-3.2-3B/1B pair at
   M = 2 x 134 = 268 (bf16 out), M = 1 and 256, JAX's ragged shapes and
   fp32 out (bit-equal expected; library: ``torch._int_mm`` + rescale),
   each with the plan's K split (``splits``): an int8 call launches one
   CUDA kernel unsplit, two split (the split products, then their sum
   and the epilogue), and the wrapper counts it once either way.
9. Smoke-width exactness of the two new paths, as in step 7: the
   ``mamba2-780m`` smoke pair (``"phase": "smoke_ssm_nocache_exactness"``),
   the same pair cached at fp32 (``"smoke_ssm_cached_exactness"``: P = 40,
   so the prefills run the SSD kernel from the cache's state; tokens and
   counts on the card == on the CPU == cached AR on the card, one SSD
   launch per layer of each prefill) and the llama3.2-1b smoke pair through ``quantize_for_serving`` under
   ``act_quant`` with a static scale calibrated on the CPU
   (``"smoke_w8a8_exactness"``). Then speculative sampling at smoke width
   (``"smoke_sampled_exactness"``: the cached, no-cache and ring-tree
   engines and sampled cached AR, card == CPU under a key whose draws
   are made on the host and copied to the card, partial accepts, no
   argmax launch) and the acceptance rules' law on the card with the
   device generator (``"sampled_lossless"``: 20,000 rows, first-token
   total variation below 0.03 linear, 0.02 for a width-3 tree).
10. Full width, through ``launch.serve`` with step 7's traffic: the paper's
   pair through ``quantize_for_serving`` under ``act_quant`` with a static
   scale from ``calibrate_act_scale`` over the linear inputs of one
   unquantized target pass on the first wave (``"full_width_w8a8"``: 7
   int8 launches and one flash launch per layer pass), then the
   ``mamba2-780m`` target with its registered drafter (``"full_width_ssm"``:
   one SSD launch per layer pass); tokens == AR's, exact counts of all six
   kernels, each followed by a profiled serve (``"profile_w8a8"``,
   ``"profile_ssm"``); then a reading (it fails nothing): the Mamba-2
   target's no-cache logits on a T=128 buffer against a T=134 buffer
   sharing its first 128 tokens (``"phase": "buffer_invariance"``: bit-equal
   or not, else their max |d| and smallest top-1 margin); last, (d) the
   cached Mamba-2 engine on the same traffic (``"full_width_ssm_cached"``,
   the stateful drafter, its state cache bf16 as in JAX): SSD launches
   waves x (48 + 12), from the prefills only, an argmax a round; its
   tokens against cached AR's and the no-cache serve's are readings (a
   bf16 state is rounded once a token by AR and once a round by the spec
   serve, so the two drift apart), profiled (``"profile_ssm_cached"``).
11. Prints the run's seconds (``"phase": "end"``), the ``{"kernels":
   [...]}`` line (six kernels; each kernel's launches are its main path's
   — the chunked serve of step 5 for paged attention and the argmax, the
   tree phase, the no-cache serves — plus the cached paths' of steps 7 and
   10 and the sampled serves', the Session phase's and the placed phase's
   of step 7), the card line again and, last,
   ``{"ok": true, "device": {...}}``.

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
CHUNK = 64                     # prefill chunk of the chunked serving path
CHUNK_STARTS = (0, 448, 1984, 3968)    # first key of the paged chunk cases
CHUNK_EQUAL = (448, 1984)      # ... checked bit-equal to a whole call
SYSTEM_LEN = 512               # shared system prompt of the chunked trace
RING_W = 144                   # ring_view cases: a cached wave's ring, 64 + 64
                               # + gamma + 2, rounded up to the 16-key page
RING_CASES = ((1, 70), (GAMMA + 1, 70), (63, 0))   # (Q, first position)


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


def paged_chunk_case(timer, name, H, Kv, D, start):
    """A prefill chunk as the chunked serving path launches it: bf16, B=1,
    Q=CHUNK queries at positions start..start+CHUNK-1 over a shuffled table
    of 256 blocks of 16 (4096 keys), the live bound from the index (no
    max_live, as the server passes none). At the starts in CHUNK_EQUAL the
    chunk's rows must also be bit-equal to the same rows of one whole call
    of start+CHUNK queries from 0 over a table just wide enough."""
    from repro_torch.kernels import paged_attention as pa
    dtype, BS, MB, NB, Q = torch.bfloat16, 16, 256, 512, CHUNK
    g = torch.Generator(device="cuda").manual_seed(H * 10007 + start)
    q = torch.randn((1, Q, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((NB, BS, Kv, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    table = perm[:MB].reshape(1, MB).to(torch.int32)
    idx = torch.tensor([start], dtype=torch.int32, device="cuda")
    args = (q, k, v, table, idx)

    out = pa.paged_flash_attention(*args)
    ref = pa.plain(*args)
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)

    # library yardstick: SDPA over the gathered, head-expanded keys
    # 0..start+Q-1 with the causal mask of positions start..start+Q-1
    S = start + Q
    cols = torch.arange(S, device="cuda")
    blk = table.long()[:, cols // BS]
    kg = k[blk, cols % BS].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = v[blk, cols % BS].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    qg = q.permute(0, 2, 1, 3)
    qpos = start + torch.arange(Q, device="cuda")
    mask = (qpos[:, None] >= cols[None, :])[None, None]      # [1,1,Q,S]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    ms = timer(lambda: pa.paged_flash_attention(*args))
    plain_ms = timer(lambda: pa.plain(*args), iters=3)
    library_ms = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask))

    # least work: the start+Q live keys and values read once per kv-head,
    # q read and out written once, the table; 4 flops per (query head,
    # visible key, d)
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + S * Kv * D * 2 * esz + table.numel() * 4 + 4
    flops = 4 * H * D * sum(start + i + 1 for i in range(Q))
    p = pa.plan(dtype, 1, Q, H, Kv, D, BS, MB)
    case = {"case": "paged_chunk", "geometry": name, "Q": Q, "B": 1,
            "start": start, "keys": S, "table_keys": MB * BS,
            "dtype": "bfloat16", **agree, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(nbytes, flops, dtype), "chunks": p.chunks,
            "row_tile": p.row_tile, "row_tiles": p.row_tiles}
    equal = True
    if start in CHUNK_EQUAL:
        mb = -(-S // BS)
        qw = torch.randn((1, S, H, D), generator=g, device="cuda").to(dtype)
        qw[:, start:] = q
        zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
        whole = pa.paged_flash_attention(qw, k, v, table[:, :mb].contiguous(), zero)
        torch.cuda.synchronize()
        equal = bool(torch.equal(whole[:, start:], out))
        case.update(whole_call_Q=S, whole_call_blocks=mb,
                    whole_call_chunks=pa.plan(dtype, 1, S, H, Kv, D, BS, mb).chunks,
                    rows_equal_whole_call=equal)
        del qw, whole
    emit(case)
    if not agree["ok"]:
        raise SystemExit(f"paged attention disagrees with its plain version: {case}")
    if not equal:
        raise SystemExit(f"paged chunk rows differ from the whole call's: {case}")
    return case


def ring_view_case(timer, name, H, Kv, D, Q, start):
    """Paged attention over a ring's identity view, as the cached dense
    forward launches it: bf16, B=2, a ring of RING_W slots holding random
    stale keys everywhere, Q new K/V written at start..start+Q-1 with a
    0-dim index (``SpecEngine``'s batch_min rounds), then read through the
    view [B * RING_W / 16, 16, Kv, D] with table[b, j] = b * RING_W / 16 +
    j and no max_live. Held against its plain version on the same view
    and against the concat attention over ``slot_positions`` that JAX's
    ring read computes (``kv_cache.extend`` + ``models.attention.
    attention``, on copies of the ring taken before the write). Library:
    SDPA over the ring's first start+Q keys with the causal mask."""
    from repro_torch.cache import kv_cache
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention, dense
    dtype, B, W = torch.bfloat16, 2, RING_W
    g = torch.Generator(device="cuda").manual_seed(H * 977 + Q * 31 + start)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    ring = {n: rnd(B, W, Kv, D) for n in "kv"}
    k_new, v_new, q = rnd(B, Q, Kv, D), rnd(B, Q, Kv, D), rnd(B, Q, H, D)
    idx = torch.tensor(start, dtype=torch.int32, device="cuda")
    k_all, v_all, kv_pos, _ = kv_cache.extend(
        {n: t.clone() for n, t in ring.items()}, k_new, v_new, idx)
    q_pos = idx + torch.arange(Q, dtype=torch.int32, device="cuda")
    concat = attention.attention(q, k_all, v_all, q_pos, kv_pos)
    kv_cache.write(ring["k"], ring["v"], k_new, v_new, idx)
    table = dense.ring_view_table(B, W, q.device)
    args = (q, dense.ring_view(ring["k"]), dense.ring_view(ring["v"]), table, idx)

    out = pa.paged_flash_attention(*args)
    ref = pa.plain(*args)
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)
    vs_concat = agreement(out, concat, dtype)

    S = start + Q
    kg = ring["k"][:, :S].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = ring["v"][:, :S].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    qg = q.permute(0, 2, 1, 3)
    cols = torch.arange(S, device="cuda")
    mask = (q_pos[:, None] >= cols[None, :])[None, None]       # [1,1,Q,S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: pa.paged_flash_attention(*args))
    plain_ms = timer(lambda: pa.plain(*args), iters=5)
    library_ms = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask))

    # least work: each row's start+Q live keys and values read once per
    # kv-head, q read and out written once, the table; 4 flops per (query
    # head, visible key, d)
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + B * S * Kv * D * 2 * esz + table.numel() * 4 + 4
    flops = 4 * H * D * B * sum(start + i + 1 for i in range(Q))
    p = pa.plan(dtype, B, Q, H, Kv, D, 16, W // 16)
    case = {"case": "ring_view", "geometry": name, "Q": Q, "B": B,
            "start": start, "ring_len": W, "dtype": "bfloat16", **agree,
            "vs_concat": vs_concat, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, flops, dtype),
            "chunks": p.chunks, "row_tile": p.row_tile}
    emit(case)
    if not (agree["ok"] and vs_concat["ok"]):
        raise SystemExit(f"ring-view attention disagrees: {case}")
    return case


def ring_view_cases(timer):
    return [ring_view_case(timer, geom, H, Kv, D, Q, start)
            for geom, H, Kv, D in (("llama3.2-3b", 24, 8, 128),
                                   ("llama3.2-1b", 32, 8, 64))
            for Q, start in RING_CASES]


def paged_chunk_cases(timer):
    return [paged_chunk_case(timer, geom, H, Kv, D, start)
            for geom, H, Kv, D in (("llama3.2-3b", 24, 8, 128),
                                   ("llama3.2-1b", 32, 8, 64))
            for start in CHUNK_STARTS]


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


def ssd_flops(b, l, h, p, n, chunk, shared, state=False):
    """The chunked algorithm's flops over the real rows: per chunk of nv
    rows, the causal scores (2n per visible pair; once per batch row when
    B and C are one group over the heads, else per head) and, per head,
    their product with X (2p per pair), the state read (2pn per row, after
    the first chunk, or from the first from a given ``state``) and the
    state update (2pn per chunk row, where a chunk follows, or for the last
    chunk's nv rows too from a given state, which returns the final one)."""
    n_chunks = -(-l // chunk)
    scores = per_head = 0
    for c in range(n_chunks):
        nv = min(chunk, l - c * chunk)
        pairs = nv * (nv + 1) // 2
        scores += pairs * 2 * n
        per_head += pairs * 2 * p
        per_head += (c > 0 or state) * nv * 2 * p * n
        per_head += (c + 1 < n_chunks) * chunk * 2 * p * n
        per_head += (c + 1 == n_chunks and state) * nv * 2 * p * n
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


def ssd_state_case(timer, name, b, l, h, p, n, chunk, *, headline=False):
    """The SSD kernel as the cached Mamba-2 prefill calls it: from a nonzero
    initial state (fp32 [b, h, p, n], std 0.3), returning the final state.
    y and the final state against the plain version (``ssd_chunked`` from
    the same state) at the fp32 tolerance."""
    from repro_torch import device as devices
    from repro_torch.kernels import ssd_scan as ss
    args = ssd_inputs(b, l, h, p, n)
    g = torch.Generator(device="cuda").manual_seed(b * l * h * p + n)
    state = torch.randn((b, h, p, n), generator=g, device="cuda") * 0.3
    kw = dict(chunk=chunk, init_state=state)
    (y, final), (y_ref, final_ref) = ss.ssd_scan(*args, **kw), ss.plain(*args, **kw)
    torch.cuda.synchronize()
    agree = agreement(y, y_ref, torch.float32)
    fin = agreement(final, final_ref, torch.float32)
    ok = (agree["ok"] and fin["ok"] and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(final).all()))
    case = {"case": "ssd_state", "shape": name, "b": b, "l": l, "h": h,
            "p": p, "n": n, "chunk": chunk, "dtype": "float32", **agree,
            "final_state_agreement": fin,
            "max_abs_err": max(agree["max_abs_err"], fin["max_abs_err"])}
    ms = timer(lambda: ss.ssd_scan(*args, **kw))
    plain_ms = timer(lambda: ss.plain(*args, **kw), iters=5)
    x, dA, Bm, Cm = args

    def distinct(t):
        return int(np.prod([d for d, st in zip(t.shape, t.stride()) if st != 0]))
    nbytes = 4 * (sum(distinct(t) for t in args) + y.numel() + 2 * b * h * p * n)
    shared = ss.shares_scores(Bm, Cm)
    flops = ssd_flops(b, l, h, p, n, chunk, shared, state=True)
    pl = ss.plan(b, l, h, p, n, chunk, devices.sm_count(x.device), shared=shared,
                 state=True)
    case.update({"ok": ok, "heads_per_block": pl.heads, "y_blocks": pl.y_blocks,
                 "state_blocks": pl.state_blocks, "carry_blocks": pl.carry_blocks,
                 "mflop": flops / 1e6, "kernel_ms": ms, "plain_ms": plain_ms,
                 "library_ms": None,
                 "library": "none: no single PyTorch call computes the chunked SSD scan",
                 **bound(nbytes, flops, torch.float32), "headline": headline})
    emit(case)
    if not ok:
        raise SystemExit(f"ssd_scan with a state disagrees with its plain version: {case}")
    return case


def ssd_state_cases(timer):
    """The cached Mamba-2 prefill of P = 64 prompts (l = P - 1 = 63, one
    partial chunk) at the target's and the drafter's shapes from a nonzero
    state, then three chunks, and p, n not multiples of 4 (plain loads)
    with head groups."""
    P = NOCACHE_PROMPT - 1
    return [ssd_state_case(timer, "mamba2-780m prefill", 2, P, 48, 64, 128, 128,
                           headline=True),
            ssd_state_case(timer, "mamba2-draft prefill", 2, P, 24, 64, 128, 128),
            ssd_state_case(timer, "3 chunks", 2, 300, 48, 64, 128, 128),
            ssd_state_case(timer, "ragged p, n, head groups", 2, 141, 24, 6, 10, 128)]


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
def serve(mt, md, pt, pd, reqs, scfg, gamma, device, tracer=None):
    from repro_torch.serving import PagedSpecServer, ServeRequest
    srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=gamma, tracer=tracer,
                          device=device)
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
    return launches, {"reqs": reqs, "tokens": done, "ar": out_ar}


def chunked_trace(cfg, n=12):
    """The multi-client chat shape (``repro/serving/frontend/traffic.py::
    shared_prefix_trace``) at full width: every prompt opens with the same
    SYSTEM_LEN-token system prompt, then a unique suffix of 16-120 tokens;
    32-64 new tokens each."""
    rng = np.random.default_rng(4)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN).astype(np.int32)
    return [(np.concatenate([system, rng.integers(
                0, cfg.vocab_size, int(rng.integers(16, 121))).astype(np.int32)]),
             int(rng.integers(32, 65))) for _ in range(n)]


def expected_hits(reqs, batch, BS):
    """Prefix-cache hit tokens the chunked path must record on ``reqs``:
    the first wave (the first ``batch`` requests, admitted in one step,
    before any row has inserted) misses; each later request attaches its
    longest run of equal leading full blocks with a first-wave prompt,
    capped at (P - 1) // BS blocks of each prompt (a first-wave row
    registers that many blocks when its prefill completes, before any row
    frees)."""
    def common(a, b):
        n = min((len(a) - 1) // BS, (len(b) - 1) // BS)
        k = 0
        while k < n and np.array_equal(a[k * BS:(k + 1) * BS], b[k * BS:(k + 1) * BS]):
            k += 1
        return k
    return sum(max(common(p, q) for q, _ in reqs[:batch]) * BS
               for p, _ in reqs[batch:])


def audited(srv):
    """The server's block census after a run: no live or seized block, the
    cached partition the prefix pool's nodes; after a flush of the pool,
    every block free. Returns the census before the flush."""
    counts = srv.alloc.audit()
    nodes = srv.prefix_pool.num_nodes if srv.prefix_pool is not None else 0
    if counts["live"] or counts["seized"] or counts["cached"] != nodes:
        raise SystemExit(f"block census after the run: {counts}, {nodes} pool nodes")
    if srv.prefix_pool is not None:
        srv.prefix_pool.flush()
    if srv.alloc.audit() != {"free": srv.scfg.num_blocks - 1, "live": 0,
                             "cached": 0, "seized": 0}:
        raise SystemExit(f"blocks leaked: {srv.alloc.audit()}")
    return counts


def top2_margin(logits) -> dict:
    """The top-1 minus top-2 logit of a row, and one bf16 step at the top
    logit's magnitude (2^(floor(log2 |top1|) - 7))."""
    top = logits.float().topk(2).values
    step = 2.0 ** (np.floor(np.log2(max(abs(float(top[0])), 1e-30))) - 7)
    return {"top1": float(top[0]), "margin": float(top[0] - top[1]),
            "bf16_step": float(step)}


def prefill_invariance(mt, pt, cfg, card, P=600):
    """A reading, not a check: one prompt's KV and last-position logits
    from the cold path's whole prefill (one call of bucket - 1 = 639
    tokens, padded) against the chunked path's prefill (chunks of CHUNK,
    the last at its true length), each into its own pool over the same
    table. How many of the P - 1 positions hold bit-equal K and V in every
    layer, the largest |d|, and whether the last position's logits are
    bit-equal (else their max |d|, the argmax and the top-2 margin)."""
    from repro_torch.cache.ops import PAGED
    BS, bucket = 16, 640
    MB = bucket // BS
    prompt = np.random.default_rng(12).integers(0, cfg.vocab_size, P).astype(np.int32)
    table = torch.arange(1, MB + 1, dtype=torch.int32, device="cuda")[None]
    geom = dict(num_blocks=MB + 1, block_size=BS, max_blocks_per_row=MB)

    def prefill(pieces):
        """KV of positions 0..P-2 ([2, L, P-1, Kv*D]) and the logits of
        position P-2."""
        cache = {**PAGED.init(mt, 1, device="cuda", **geom), "block_table": table}
        for start, toks in pieces:
            logits, _, _ = mt.apply(pt, torch.from_numpy(toks[None]).cuda(), {
                **cache, "index": torch.tensor([start], dtype=torch.int32, device="cuda")})
        kv = torch.stack([cache[n][:, 1:].reshape(cache[n].shape[0], MB * BS, -1)[:, :P - 1]
                          for n in ("k", "v")])
        return kv, logits[0, P - 2 - start]

    padded = np.zeros(bucket, np.int32)
    padded[:P] = prompt
    with torch.no_grad():
        kv_w, lw = prefill([(0, padded[:-1])])
        kv_c, lc = prefill([(s, prompt[s:min(s + CHUNK, P - 1)])
                            for s in range(0, P - 1, CHUNK)])
    torch.cuda.synchronize()
    rows_equal = (kv_w == kv_c).all(dim=-1).all(dim=0).all(dim=0)    # [P-1]
    equal = bool(torch.equal(lw, lc))
    info = {"phase": "buffer_invariance", "reading": "prefill_whole_vs_chunked",
            "target": mt.cfg.name, "card": card, "prompt_len": P,
            "whole_call_tokens": bucket - 1, "chunk": CHUNK,
            "kv_positions": P - 1,
            "kv_positions_bit_equal": int(rows_equal.sum()),
            "kv_max_abs_diff": float((kv_w.float() - kv_c.float()).abs().max()),
            "last_logits_bit_equal": equal}
    if not equal:
        info.update(last_logits_max_abs_diff=float((lw - lc).abs().max()),
                    argmax_equal=bool(lw.argmax() == lc.argmax()),
                    whole=top2_margin(lw), chunked=top2_margin(lc))
    emit(info)
    return info


def first_difference(a, b):
    """(rid, position) of the first token where two runs differ, or None."""
    for rid in sorted(a):
        diff = np.flatnonzero(a[rid] != b[rid]) if len(a[rid]) == len(b[rid]) else [0]
        if len(diff):
            return rid, int(diff[0])
    return None


def full_width_chunked(mt, md, pt, pd, cfg, card, reading, chunk_cases):
    """The main path with chunked prefill and the prefix pool at full width:
    the paper's pair (bf16) serves ``chunked_trace`` (12 requests sharing a
    512-token system prompt) through ``PagedSpecServer`` with batch 4,
    block 16, 64 blocks per row, 512 blocks, prefill chunks of CHUNK,
    the prefix pool on, gamma pinned to GAMMA. The launch counts of all six
    kernels are set to 0 just before and read just after; paged attention
    must launch rounds x (L_t + GAMMA x L_d) + chunks x (L_t + L_d) times,
    the argmax once a round, the other four never. Checks: every request
    complete in the vocabulary; the prefix hit tokens equal
    ``expected_hits``; the same traffic with AR rounds and the same prefill
    config gives the same tokens; again under overcommit 2.0 on a pool of
    96 blocks, with at least one preemption and the same tokens; each
    server's census balanced. Then the cold (bucketed) path, buckets
    extended to 640: where its tokens differ, the first difference is
    printed with the cold run's top-2 margin there, and the run fails
    unless the difference is the one ``reading`` (the whole-vs-chunked
    prefill reading) explains: chunk rows bit-equal to whole-call rows on
    the card (``chunk_cases``), KV or logits not bit-equal between the two
    prefills, and a margin within one bf16 step. Last, the chunked serve
    runs once more under ``torch.profiler``, each chunk program and each
    round its own region."""
    import dataclasses
    from repro_torch.serving import SchedulerConfig
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    counters = kernel_counters()
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=512,
                           max_blocks_per_row=64, prefill_chunk=CHUNK,
                           prefix_cache=True)
    reqs = chunked_trace(cfg)
    # warm-up (cuBLAS handles for the chunk shapes), not counted
    serve(mt, md, pt, pd, [(reqs[0][0][:CHUNK + 16], 8)], scfg, GAMMA, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    srv, done = serve(mt, md, pt, pd, reqs, scfg, GAMMA, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rounds, chunks = srv.total_rounds, srv.n_prefill_chunks
    expect = {name: 0 for name in counters}
    expect.update(paged_attention=rounds * (L_t + GAMMA * L_d) + chunks * (L_t + L_d),
                  blockwise_argmax=rounds)
    s = srv.metrics.summary()
    pool_stats = srv.prefix_pool.stats()
    census = audited(srv)
    complete = (len(done) == len(reqs) and s["requests_failed"] == 0 and all(
        len(done[i]) == len(p) + new
        and ((done[i] >= 0) & (done[i] < cfg.vocab_size)).all()
        and np.array_equal(done[i][:len(p)], p)
        for i, (p, new) in enumerate(reqs)))
    hits_want = expected_hits(reqs, scfg.max_batch, scfg.block_size)

    ar, out_ar = serve(mt, md, pt, pd, reqs, scfg, 0, "cuda")
    audited(ar)
    same_ar = all(np.array_equal(done[i], out_ar[i]) for i in range(len(reqs)))
    oc_cfg = dataclasses.replace(scfg, overcommit=2.0, num_blocks=96)
    oc, out_oc = serve(mt, md, pt, pd, reqs, oc_cfg, GAMMA, "cuda")
    audited(oc)
    s_oc = oc.metrics.summary()
    same_oc = (len(out_oc) == len(reqs)
               and all(np.array_equal(done[i], out_oc[i]) for i in range(len(reqs))))
    cold_cfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=512,
                               max_blocks_per_row=64,
                               prefill_buckets=scfg.prefill_buckets + (640,))
    cold, out_cold = serve(mt, md, pt, pd, reqs, cold_cfg, GAMMA, "cuda")
    audited(cold)
    diff = first_difference(done, out_cold)

    prompt_tokens = sum(len(p) - 1 for p, _ in reqs)
    info = {"phase": "full_width_chunked", "target": mt.cfg.name,
            "drafter": md.cfg.name, "dtype": mt.cfg.dtype, "card": card,
            "requests": len(reqs), "system_prompt": SYSTEM_LEN,
            "prompt_lens": [len(p) for p, _ in reqs],
            "new_tokens": [n for _, n in reqs], "chunk": CHUNK,
            "completed": len(done), "wall_s": wall, "rounds": rounds,
            "ms_per_round": wall / rounds * 1e3, "prefill_chunks": chunks,
            "generated_tokens": s["total_generated_tokens"],
            "tokens_per_s": s["total_generated_tokens"] / wall,
            "prefill_tokens": s["prefill_tokens"],
            "prefix_hit_tokens": s["prefix_hit_tokens"],
            "expected_hit_tokens": hits_want,
            "prefix_hit_rate": s["prefix_hit_rate"],
            "prefill_tokens_saved": prompt_tokens - s["prefill_tokens"],
            "p50_ttft_s": s["p50_ttft_s"], "p95_ttft_s": s["p95_ttft_s"],
            "peak_memory_gib": peak, "census": census,
            "prefix_pool": pool_stats,
            "launches": launches, "expected_launches": expect,
            "all_complete_in_vocab": bool(complete), "spec_equals_ar": same_ar,
            "ar_rounds": ar.total_rounds,
            "overcommit": {"num_blocks": oc_cfg.num_blocks, "rounds": oc.total_rounds,
                           "prefill_chunks": oc.n_prefill_chunks,
                           "preemptions": s_oc["n_preemptions"],
                           "recompute_tokens": s_oc["recompute_tokens"],
                           "tokens_equal": same_oc},
            "cold_prefills": cold.n_prefills, "cold_rounds": cold.total_rounds,
            "chunked_equals_cold": diff is None}
    deliberate = False
    if diff is not None:
        rid, pos = diff
        ctx = torch.from_numpy(out_cold[rid][None, :pos].astype(np.int64)).cuda()
        with torch.no_grad():
            margin = top2_margin(mt.apply(pt, ctx)[0][0, -1])
        rows_equal = all(c.get("rows_equal_whole_call", True) for c in chunk_cases)
        prefill_differs = not (reading["last_logits_bit_equal"] and
                               reading["kv_positions_bit_equal"] == reading["kv_positions"])
        deliberate = rows_equal and prefill_differs and margin["margin"] <= margin["bf16_step"]
        info.update(first_difference={"request": rid, "position": pos,
                                      "prompt_len": len(reqs[rid][0]),
                                      "chunked": int(done[rid][pos]),
                                      "cold": int(out_cold[rid][pos]),
                                      "cold_margin": margin},
                    attention_rows_bit_equal=rows_equal,
                    prefill_reading_differs=prefill_differs,
                    deliberate=deliberate)
    emit(info)
    if not complete:
        raise SystemExit(f"full-width chunked serving did not complete cleanly: {info}")
    if launches != expect:
        raise SystemExit(f"chunked kernel launches {launches} != expected {expect}")
    if s["prefix_hit_tokens"] != hits_want or hits_want < 8 * SYSTEM_LEN:
        raise SystemExit(f"prefix hit tokens {s['prefix_hit_tokens']} != {hits_want}")
    if not same_ar:
        raise SystemExit(f"full-width chunked spec tokens differ from AR: {info}")
    if s_oc["n_preemptions"] < 1 or not same_oc:
        raise SystemExit(f"overcommit run: no preemption or other tokens: {info}")
    if diff is not None and not deliberate:
        raise SystemExit(f"chunked tokens differ from the cold path: {info}")

    def run():
        from repro_torch.serving import PagedSpecServer, ServeRequest
        srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=GAMMA, device="cuda")
        srv._run_chunk = region("prefill_chunk", srv._run_chunk)
        eng = srv._engine(GAMMA)
        eng.round = region("round", eng.round)
        for i, (prompt, new) in enumerate(reqs):
            srv.submit(ServeRequest(i, prompt, new))
        srv.run()
        return srv.total_rounds, srv.n_prefill_chunks
    profile("profile_chunked", run, pt, pd, card, regions=("prefill_chunk", "round"))
    return launches, {"reqs": reqs, "scfg": scfg, "tokens": done,
                      "launches": launches, "ar_tokens": out_ar, "wall_s": wall,
                      "rounds": rounds, "cold_scfg": cold_cfg,
                      "cold_tokens": out_cold}


def phase_split(tracer, srv) -> dict:
    """The per-phase split of a traced serve: each phase's span time per
    round (phase_totals over all rounds), the events' mean phase times
    (t_draft/t_verify/t_commit over speculative rounds, t_prefill over the
    steps that ran a chunk, t_round over all rounds), the leaf phases'
    share of the serve span, and the drift monitor's evidence and alerts."""
    totals = tracer.phase_totals()
    serve_s = tracer.total(name="serve")
    leaf = sum(v for k, v in totals.items() if k != "serve")
    events = srv.events.events()
    drift = srv.drift
    calibrated = drift is not None and drift.calibrated
    return {"rounds": srv.total_rounds,
            "spec_rounds": sum(1 for e in events if e.gamma > 0),
            "phase_ms_per_round": {k: v / srv.total_rounds * 1e3
                                   for k, v in sorted(totals.items())},
            "event_mean_ms": {k: v * 1e3
                              for k, v in sorted(srv.events.phase_means().items())},
            "leaf_over_serve": leaf / serve_s, "spans": tracer.count(),
            "drift_unit_ms": drift.unit * 1e3 if calibrated else None,
            "drift_evidence": drift.evidence() if calibrated else None,
            "drift_alerts": drift.alerts() if calibrated else [],
            "kv_traffic": srv.kv_traffic()}


def export_trace(tracer, name) -> str:
    """Write a traced serve's Chrome trace under build/traces (gitignored);
    returns its path in the checkout."""
    path = ROOT / "build" / "traces" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tracer.export(str(path))
    return str(path.relative_to(ROOT))


def path_launches(srv, counters, L_t, L_d) -> dict:
    """The launches a paged serve's rounds and prefills imply: paged
    attention once per layer of every pass (GAMMA drafter steps and one
    verify per speculative round, a target step per AR round, both models
    per prefill or chunk program), the argmax once per speculative round,
    no other kernel."""
    events = srv.events.events()
    want = {n: 0 for n in counters}
    want.update(paged_attention=sum(L_t + e.gamma * L_d for e in events)
                + (srv.n_prefills + srv.n_prefill_chunks) * (L_t + L_d),
                blockwise_argmax=sum(1 for e in events if e.gamma > 0))
    return want


def full_width_traced(mt, md, pt, pd, cfg, card, chunked):
    """Tracing on the main path (``"phase": "full_width_traced"``), on
    ``full_width_chunked``'s pair and trace; every serve here runs with an
    enabled ``Tracer``, its six launch counts set to 0 just before and read
    just after. Each traced paged serve must give the tokens it is held to
    and the launches its rounds and prefills imply (``path_launches``), one
    RoundEvent per round with phase times on every speculative one and the
    metrics' alpha, and leaf spans covering 0.9-1.02 of the serve span (the
    bar of the JAX suite's traced serving test); it prints the per-phase
    split (``phase_split``).
    (a) The chunked serve at gamma GAMMA: tokens and launch counts equal to
    the untraced serve's, a calibrated drift monitor with evidence; it
    prints the measured c and the wall per round against the untraced
    serve's. Then the same traffic on the bucketed path (the cold config of
    ``full_width_chunked``; its whole-prompt prefills in ``prefill``):
    tokens equal that path's untraced tokens. (b) The chunked serve with
    gamma unpinned, so the drift monitor's measured c drives Eq. (1) once
    calibrated: tokens equal AR's; it prints every round's gamma and the
    gamma* the measured c gives. (c) The no-cache engine,
    ``launch.serve.serve`` at ``full_width_nocache``'s traffic with
    ``strategy="modular"``, traced and untraced: the same tokens and
    launches, flash rounds x (L_t + GAMMA x L_d); it prints the phase split
    and c = draft per token / verify. The Chrome traces go to
    build/traces/."""
    from repro_torch.core import cost_model
    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs import Tracer
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    t_phase = time.perf_counter()
    counters = kernel_counters()
    reqs = chunked["reqs"]

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: c.launches for n, c in counters.items()}

    def traced_paged(part, scfg, gamma, want_tokens):
        """One traced paged serve, its common checks and its line's
        fields; returns the server and the line."""
        tracer = Tracer()
        (srv, done), wall, launches = counted(
            lambda: serve(mt, md, pt, pd, reqs, scfg, gamma, "cuda", tracer))
        events = srv.events.events()
        want = path_launches(srv, counters, L_t, L_d)
        info = {"phase": "full_width_traced", "part": part, "card": card,
                "gamma": gamma, "requests": len(reqs), "wall_s": wall,
                "ms_per_round": wall / srv.total_rounds * 1e3,
                "prefills": srv.n_prefills,
                "prefill_chunks": srv.n_prefill_chunks,
                "alpha_hat": srv.metrics.alpha_hat(), **phase_split(tracer, srv),
                "trace": export_trace(tracer, f"full_width_traced_{part}"),
                "launches": launches, "expected_launches": want,
                "tokens_equal": all(np.array_equal(done[i], want_tokens[i])
                                    for i in range(len(reqs))),
                "events": len(events),
                "phase_times_on_spec_events": all(
                    e.t_draft is not None and e.t_verify is not None
                    and e.t_commit is not None for e in events if e.gamma > 0)}
        if not info["tokens_equal"]:
            raise SystemExit(f"traced tokens differ from the reference's: {info}")
        if launches != want:
            raise SystemExit(f"traced launches differ from the path's: {info}")
        if len(events) != srv.total_rounds or not info["phase_times_on_spec_events"]:
            raise SystemExit(f"round events incomplete: {info}")
        if srv.events.alpha_hat() != srv.metrics.alpha_hat():
            raise SystemExit(f"event alpha != metrics alpha: {info}")
        if not 0.9 <= info["leaf_over_serve"] <= 1.02:
            raise SystemExit(f"leaf spans do not cover the serve span: {info}")
        return srv, info

    # (a) gamma pinned, chunked then bucketed
    srv, info = traced_paged("a_chunked", chunked["scfg"], GAMMA, chunked["tokens"])
    info["untraced_ms_per_round"] = chunked["wall_s"] / chunked["rounds"] * 1e3
    info["untraced_launches"] = chunked["launches"]
    emit(info)
    if info["launches"] != chunked["launches"]:
        raise SystemExit(f"traced launches differ from the untraced serve's: {info}")
    if srv.drift is None or srv.drift.evidence() is None:
        raise SystemExit(f"the drift monitor did not calibrate: {info}")
    emit(traced_paged("a_bucketed", chunked["cold_scfg"], GAMMA,
                      chunked["cold_tokens"])[1])

    # (b) gamma from Eq. (1) with the measured c
    scfg = chunked["scfg"]
    srv, info = traced_paged("b_gamma_from_measured_c", scfg, None,
                             chunked["ar_tokens"])
    ev, alpha = info["drift_evidence"], info["alpha_hat"]

    def gamma_star(a, c):
        return cost_model.optimal_gamma(a, c, scfg.gamma_max)[0]
    info.update(
        gammas=[e.gamma for e in srv.events.events()],
        prior_c=scfg.cost_coefficient,
        gamma_star_prior_c=gamma_star(alpha, scfg.cost_coefficient),
        measured_c=ev["c"], gamma_star_measured_c=gamma_star(alpha, ev["c"]),
        # what the measured c would pick at lower acceptance (the random
        # weights accept every draft, and at alpha 1 Eq. (1) takes
        # gamma_max for any c < 1)
        gamma_star_measured_c_by_alpha={
            str(a): gamma_star(a, ev["c"]) for a in (0.5, 0.6, 0.7, 0.8, 0.9, 0.95)})
    emit(info)

    # (c) the no-cache engine, modular, untraced then traced
    prompts, batch = nocache_prompts(cfg), 2
    serve_cli.serve(mt, md, pt, pd, prompts[:batch], 4, gamma=GAMMA, batch=batch,
                    strategy="modular")                    # warm-up
    torch.cuda.synchronize()
    (ref, s_ref), wall_ref, launches_ref = counted(lambda: serve_cli.serve(
        mt, md, pt, pd, prompts, NOCACHE_NEW, gamma=GAMMA, batch=batch,
        strategy="modular"))
    tracer = Tracer()
    (toks, s), wall, launches = counted(lambda: serve_cli.serve(
        mt, md, pt, pd, prompts, NOCACHE_NEW, gamma=GAMMA, batch=batch,
        strategy="modular", tracer=tracer))
    rounds = s["rounds"]
    totals = tracer.phase_totals()
    want = {n: 0 for n in counters}
    want.update(flash_attention=rounds * (L_t + GAMMA * L_d), blockwise_argmax=rounds)
    same = bool(np.array_equal(toks, ref))
    info = {"phase": "full_width_traced", "part": "c_nocache_modular",
            "card": card, "requests": len(prompts), "batch": batch,
            "gamma": GAMMA, "rounds": rounds, "wall_s": wall,
            "ms_per_round": wall / rounds * 1e3,
            "untraced_ms_per_round": wall_ref / s_ref["rounds"] * 1e3,
            "phase_ms_per_round": {k: v / rounds * 1e3 for k, v in sorted(totals.items())},
            "c_draft_per_token_over_verify": cost_model.cost_coefficient(
                totals["draft"] / (rounds * GAMMA), totals["verify"] / rounds),
            "spans": tracer.count(),
            "trace": export_trace(tracer, "full_width_traced_c"),
            "launches": launches, "untraced_launches": launches_ref,
            "expected_launches": want, "tokens_equal_untraced": same}
    emit(info)
    if not same or s["rounds"] != s_ref["rounds"]:
        raise SystemExit(f"traced no-cache tokens differ from the untraced serve's: {info}")
    if launches != want or launches_ref != want:
        raise SystemExit(f"traced no-cache launches differ: {info}")
    emit({"phase": "full_width_traced", "part": "done", "card": card,
          "phase_s": time.perf_counter() - t_phase})


def region(label, fn):
    """``fn`` as a profiler region: its kernels run between the region's
    start and a synchronize at its end, so a kernel belongs to the region
    its start falls in."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
        return out
    return wrapped


def _nocache_rounds(eng, pt, pd, prompt, max_new):
    """The rounds ``SpecEngine.generate`` runs, one at a time: (tokens,
    committed tokens per round)."""
    B, P = prompt.shape
    state = eng.prefill(pt, pd, prompt, P + max_new + eng.ecfg.gamma + 2)
    committed, length = [], P
    while length < P + max_new:
        state = eng.round(pt, pd, state)
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


def smoke_ssm_cached_exactness(arch="mamba2-780m"):
    """The cached Mamba-2 engine at smoke width in fp32 (the drafter is the
    target's first L-1 layers, weights drawn on the CPU and copied to the
    card), gamma 4, six prompt batches of B=2 and P = 40, so each prefill
    (P - 1 = 39 > 16 rows) runs the SSD kernel from the cache's state and
    keeps its final state, and every round the stateful drafter's steps,
    the sequential-scan verify and the trail rollback (embedding std 0.3,
    so that rounds accept part of their drafts): the card's tokens and
    counts must equal the CPU's, and its cached AR's. At fp32 a state
    rounds to itself, so cached spec and cached AR do not drift apart (at
    bf16 they do: ``full_width_ssm``)."""
    from repro_torch.configs import registry
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.model import build_model
    gamma, P, new = 4, 40, 24
    cfg = registry.smoke_config(arch)
    cfg = cfg.replace(embed_init_scale=0.3)    # the pair accepts part of its drafts
    mt = build_model(cfg)
    md = build_model(cfg.replace(num_layers=cfg.num_layers - 1, name="draft"))
    pt_cpu = mt.init(0, "cpu")
    pd_cpu = {**pt_cpu, "layers": pt_cpu["layers"][:-1]}
    pt, pd = to_cuda(pt_cpu), to_cuda(pd_cpu)
    prompts = [np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, P)).astype(np.int32)
               for seed in range(6)]
    eng = SpecEngine(mt, md, EngineConfig(gamma=gamma, use_cache=True))
    info = {"phase": "smoke_ssm_cached_exactness", "arch": arch, "dtype": cfg.dtype,
            "gamma": gamma, "batch": 2, "prompt_len": P, "new_tokens": new,
            "rounds": 0, "accepted": 0, "ssd_launches": 0,
            "gpu_equals_cpu": True, "spec_equals_ar": True}
    for prompt in prompts:
        n0 = ss.ssd_scan.launches
        gpu, st_gpu = eng.generate(pt, pd, prompt, new)
        info["ssd_launches"] += ss.ssd_scan.launches - n0
        cpu, st_cpu = eng.generate(pt_cpu, pd_cpu, prompt, new)
        ar = autoregressive_generate(mt, pt, prompt, new, use_cache=True).cpu().numpy()
        gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
        info["rounds"] += st_gpu["rounds"]
        info["accepted"] += st_gpu["accepted"]
        info["gpu_equals_cpu"] &= bool(np.array_equal(gpu, cpu) and st_gpu == st_cpu)
        info["spec_equals_ar"] &= bool(np.array_equal(gpu[:, :P + new], ar))
    emit(info)
    # one SSD launch per layer of each prefill (target and drafter)
    want = len(prompts) * (mt.cfg.num_layers + md.cfg.num_layers)
    # rounds that rolled back part of a draft, and rounds that kept it all
    mixed = 0 < info["accepted"] < gamma * info["rounds"]
    if not (info["gpu_equals_cpu"] and info["spec_equals_ar"] and mixed
            and info["ssd_launches"] == want):
        raise SystemExit(f"smoke-width cached Mamba-2 exactness failed: {info}")


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
    prof = profile(profile_phase, run, pt, pd, card)
    return {"launches": s["launches"], "tokens": spec, "info": info,
            "profile": prof}


def full_width_nocache(mt, md, pt, pd, cfg, card):
    """The paper's pair (bf16): one flash launch per layer of each pass."""
    per_pass = {"flash_attention": (mt.cfg.num_layers, md.cfg.num_layers)}
    return nocache_phase("full_width_nocache", "profile_nocache", mt, md, pt,
                         pd, cfg, card, per_pass)


def cached_serve(phase, profile_phase, mt, md, pt, pd, cfg, card, per_pass,
                 nocache, exact):
    """The cached engine at full width through ``launch.serve.serve(use_cache
    =True)`` with the no-cache traffic (4 requests of 64 prompt + 64 new
    tokens, two waves of 2, gamma 4). Every kernel's count is set to 0 just
    before each serve and read just after: ``per_pass`` maps a kernel to
    its launches in one (target, drafter) forward; every spec round runs
    GAMMA drafter passes (GAMMA + 1 for a stateful drafter, whose passes
    launch nothing of the port), one target pass and one argmax launch,
    each wave one prefill pass of each model, each AR step one target pass
    and each AR wave one target prefill. How many new tokens equal cached
    AR's and ``nocache``'s (the no-cache serve of the same call) is
    reported, and where a request differs from either, its first
    difference with the no-cache target's top-2 margin there. ``exact``
    (the dense pair): the tokens must equal cached AR's, and a difference
    from the no-cache serve must sit within one bf16 step of the top logit
    (a near-tie that the two computations' last bits may break either
    way). Otherwise (Mamba-2 at bf16) both comparisons are readings: the
    bf16 state cache is rounded once a token by AR, once a round by the
    spec serve and never by the no-cache serve, so the three drift apart.
    The reference does the same: JAX's own cached Mamba-2 engine parts from
    its own cached AR at bf16 (tests/test_torch_ssm_bf16.py), so equality
    is not what the reference gives, and the port is held to JAX mode by
    mode on the CPU instead; ``smoke_ssm_cached_exactness`` holds the
    cached Mamba-2 path exactly at fp32. Then the same spec serve once
    more under ``torch.profiler``."""
    from repro_torch.launch import serve as serve_cli
    counters = kernel_counters()
    batch = 2
    prompts = nocache_prompts(cfg)
    P = prompts.shape[1]
    for gamma in (GAMMA, 0):           # warm-up, not counted
        serve_cli.serve(mt, md, pt, pd, prompts[:batch], 4, gamma=gamma,
                        batch=batch, use_cache=True)
    torch.cuda.synchronize()

    def counted(gamma):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        toks, st = serve_cli.serve(mt, md, pt, pd, prompts, NOCACHE_NEW,
                                   gamma=gamma, batch=batch, use_cache=True)
        torch.cuda.synchronize()
        st["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        st["launches"] = {name: fn.launches for name, fn in counters.items()}
        return toks, st

    spec, s = counted(GAMMA)
    ar, s_ar = counted(0)
    rounds, waves, steps = s["rounds"], s["waves"], s_ar["rounds"]
    d_passes = GAMMA + 1 if md.cfg.family == "ssm" else GAMMA

    def n(name, which):
        return per_pass.get(name, (0, 0, 0, 0))[which]
    expect = {name: rounds * (d_passes * n(name, 3) + n(name, 2))
              + waves * (n(name, 0) + n(name, 1)) for name in counters}
    expect["blockwise_argmax"] = rounds
    # an AR wave: one prefill pass over the prompt (its last position
    # gives the first token), then max_new - 1 single-token steps
    expect_ar = {name: (steps - s_ar["waves"]) * n(name, 2)
                 + s_ar["waves"] * n(name, 0) for name in counters}
    same_ar = bool(np.array_equal(spec, ar))

    def differences(other):
        """Each request's first new token that differs from ``other``'s,
        with the no-cache target's top-2 margin on the shared context."""
        out = []
        for row in np.flatnonzero((spec[:, P:] != other[:, P:]).any(axis=1)):
            pos = P + int(np.flatnonzero(spec[row, P:] != other[row, P:])[0])
            ctx = torch.from_numpy(spec[row:row + 1, :pos].astype(np.int64)).cuda()
            with torch.no_grad():
                margin = top2_margin(mt.apply(pt, ctx)[0][0, -1])
            out.append({"request": int(row), "position": pos,
                        "tokens": [int(spec[row, pos]), int(other[row, pos])],
                        "margin": margin,
                        "explained": margin["margin"] <= margin["bf16_step"]})
        return out
    nc = nocache["tokens"]
    equal = spec[:, P:] == nc[:, P:]
    equal_ar = spec[:, P:] == ar[:, P:]
    info = {"phase": phase, "target": mt.cfg.name, "drafter": md.cfg.name,
            "dtype": mt.cfg.dtype, "card": card, "requests": len(prompts),
            "batch": batch, "waves": waves, "prompt_len": P,
            "new_tokens": NOCACHE_NEW, "gamma": GAMMA, "rounds": rounds,
            "mean_accepted_per_round": s["accepted"] / rounds,
            "wall_s": s["seconds"], "ms_per_round": s["seconds"] / rounds * 1e3,
            "tokens_per_s": s["tokens_per_s"],
            "peak_memory_gib": s["peak_memory_gib"],
            "ar_steps": steps, "ar_wall_s": s_ar["seconds"],
            "ar_ms_per_step": s_ar["seconds"] / steps * 1e3,
            "ar_tokens_per_s": s_ar["tokens_per_s"],
            "launches": s["launches"], "expected_launches": expect,
            "ar_launches": s_ar["launches"], "expected_ar_launches": expect_ar,
            "spec_equals_ar": same_ar, "exact": exact,
            "ar_comparison": "check" if exact else
            "reading: at bf16 the reference's cached spec parts from its cached AR too",
            "new_tokens_equal_ar": int(equal_ar.sum()),
            "in_vocab": bool(((spec >= 0) & (spec < cfg.vocab_size)).all()),
            "nocache_rounds": nocache["info"]["rounds"],
            "nocache_ms_per_round": nocache["info"]["ms_per_round"],
            "new_tokens_equal_nocache": int(equal.sum()),
            "new_tokens_total": int(equal.size),
            "differences_from_ar": differences(ar),
            "differences_from_nocache": differences(nc)}
    emit(info)
    if s["launches"] != expect or s_ar["launches"] != expect_ar:
        raise SystemExit(f"cached kernel launches differ from the path's: {info}")
    if not info["in_vocab"]:
        raise SystemExit(f"full-width cached tokens out of the vocabulary: {info}")
    if exact and not same_ar:
        raise SystemExit(f"cached spec tokens differ from cached AR's: {info}")
    if exact and not all(d["explained"] for d in info["differences_from_nocache"]):
        raise SystemExit(f"cached tokens differ from no-cache beyond the margin: {info}")

    def run():
        _, st = serve_cli.serve(mt, md, pt, pd, prompts, NOCACHE_NEW,
                                gamma=GAMMA, batch=batch, use_cache=True)
        return st["rounds"], waves
    prof = profile(profile_phase, run, pt, pd, card)
    emit(cache_saving(phase, nocache, info, prof))
    return {"launches": s["launches"], "tokens": spec, "ar": ar, "info": info,
            "profile": prof}


def cache_saving(phase, nocache, cached, prof):
    """The no-cache and the cached serve of the same traffic in the same
    call, side by side: wall ms per round (unprofiled), device busy ms per
    round and idle share (profiled), the port's kernels' ms per round."""
    def side(info, p):
        busy = p["device_busy_s"]
        return {"rounds": info["rounds"], "wall_ms_per_round": info["ms_per_round"],
                "tokens_per_s": info["tokens_per_s"],
                "device_busy_ms_per_round": None if busy is None else busy / p["rounds"] * 1e3,
                "device_idle_share": p["device_idle_share"],
                "kernel_launches_per_round": p["kernel_launches_per_round"],
                "port_kernels_ms_per_round": p["port_kernels_ms_per_round"]}
    return {"phase": "cached_vs_nocache", "trace": phase,
            "nocache": side(nocache["info"], nocache["profile"]),
            "cached": side(cached, prof)}


def full_width_cached(mt, md, pt, pd, cfg, card, nocache):
    """The cached engines at full width on the paper's pair (bf16): (a) the
    no-cache traffic on the ring through ``launch.serve.serve(use_cache=
    True)`` (``cached_serve``: paged attention once per layer of every
    pass); (b) ``BatchedSpecEngine.generate`` on the ring at B=4 (the same
    prompts, 64 new tokens): paged rounds x (GAMMA L_d + L_t) + one prefill
    (L_t + L_d), an argmax a round, each row == its cached AR (B=4); (c)
    ring tree rounds, ``SpecEngine(use_cache=True, draft_policy="tree",
    draft_k=TREE_W)`` on the first 2 prompts: tree launches L_t a round,
    the drafter's paged launches GAMMA L_d a round (a root step on B rows,
    GAMMA - 1 chain steps on B W rows) + L_d for its prefill, the target's
    L_t (its prefill; its passes are tree passes), tokens == cached AR's.
    Returns the three parts' launches together, and part (a)'s dict with
    (b)'s tokens under ``"batched"``."""
    from repro_torch.core.batched_engine import (BatchedEngineConfig,
                                                 BatchedSpecEngine)
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    per_pass = {"paged_attention": (L_t, L_d, L_t, L_d)}
    a = cached_serve("full_width_cached", "profile_cached", mt, md, pt, pd, cfg,
                     card, per_pass, nocache, exact=True)
    counters = kernel_counters()
    none = {name: 0 for name in counters}
    prompts = nocache_prompts(cfg)
    P = prompts.shape[1]

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    # (b) per-row rounds on the ring, B = 4
    eng = BatchedSpecEngine(mt, md, BatchedEngineConfig(gamma=GAMMA))
    zero()
    toks, lengths, st = eng.generate(pt, pd, prompts, NOCACHE_NEW)
    torch.cuda.synchronize()
    b_launch = read()
    b_rounds = st["rounds"]
    b_expect = {**none, "paged_attention": b_rounds * (GAMMA * L_d + L_t) + L_t + L_d,
                "blockwise_argmax": b_rounds}
    ar4 = autoregressive_generate(mt, pt, prompts, NOCACHE_NEW, use_cache=True).cpu().numpy()
    toks = toks.cpu().numpy()
    b_rows = [bool(np.array_equal(toks[i, :P + NOCACHE_NEW], ar4[i]))
              for i in range(len(prompts))]
    info_b = {"phase": "full_width_batched_ring", "card": card, "batch": len(prompts),
              "prompt_len": P, "new_tokens": NOCACHE_NEW, "gamma": GAMMA,
              "rounds": b_rounds, "lengths": lengths.tolist(),
              "launches": b_launch, "expected_launches": b_expect,
              "rows_equal_ar": b_rows}
    emit(info_b)
    if b_launch != b_expect or not all(b_rows):
        raise SystemExit(f"full-width per-row ring rounds failed: {info_b}")

    # (c) ring tree rounds
    tally = {"target": 0, "drafter": 0}
    real = {}
    from repro_torch.kernels import paged_attention as pa

    def tallied(model, role):
        real[role] = model.apply

        def apply(*args, **kw):
            n0 = pa.paged_flash_attention.launches
            out = real[role](*args, **kw)
            tally[role] += pa.paged_flash_attention.launches - n0
            return out
        model.apply = apply
    tree_eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, use_cache=True,
                                               draft_policy="tree", draft_k=TREE_W))
    tree_eng.generate(pt, pd, prompts[:2, :16], 4)          # warm-up
    tallied(mt, "target")
    tallied(md, "drafter")
    try:
        zero()
        t0 = time.perf_counter()
        tree_toks, st_c = tree_eng.generate(pt, pd, prompts[:2], NOCACHE_NEW)
        torch.cuda.synchronize()
        c_wall = time.perf_counter() - t0
        c_launch = read()
    finally:
        del mt.apply, md.apply
    c_rounds = st_c["rounds"]
    c_expect = {**none, "tree_attention": L_t * c_rounds,
                "paged_attention": GAMMA * L_d * c_rounds + L_d + L_t,
                "blockwise_argmax": c_rounds}
    tree_toks = tree_toks.cpu().numpy()[:, :P + NOCACHE_NEW]
    same = bool(np.array_equal(tree_toks, a["ar"][:2]))
    info_c = {"phase": "full_width_ring_tree", "card": card, "batch": 2,
              "width": TREE_W, "depth": GAMMA, "rounds": c_rounds,
              "accepted": st_c["accepted"], "wall_s": c_wall,
              "ms_per_round": c_wall / c_rounds * 1e3,
              "launches": c_launch, "expected_launches": c_expect,
              "paged_by_model": tally,
              "expected_paged_by_model": {"target": L_t,
                                          "drafter": GAMMA * L_d * c_rounds + L_d},
              "tree_equals_ar": same}
    emit(info_c)
    if c_launch != c_expect or tally != info_c["expected_paged_by_model"] or not same:
        raise SystemExit(f"full-width ring tree rounds failed: {info_c}")
    total = {name: a["launches"][name] + b_launch[name] + c_launch[name]
             for name in counters}
    return total, {**a, "batched": toks}


def smoke_sampled_exactness():
    """Speculative sampling at smoke width (the llama3.2-1b pair of
    ``smoke_exactness``, fp32, weights drawn on the CPU and copied to the
    card), gamma 4, T = 1, four prompt batches of B=2: the cached linear,
    no-cache linear and ring-tree W=2 ``SpecEngine`` and sampled cached AR,
    each on the card and on the CPU under a key whose draws are made on
    the host and copied to the device (``HostKey``), so both sides draw
    the same numbers: the tokens and counts must be equal, some rounds
    must accept part of their drafts, the path's attention kernel must
    launch and the argmax kernel must not (sampled verify is PyTorch)."""
    from repro_torch.configs import registry
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    from repro_torch.models.model import build_model
    from repro_torch.sampling.keys import TorchKey

    class HostKey(TorchKey):
        """A TorchKey drawing on the host's CPU generator; the draws are
        copied to the tensor's device."""

        def uniform(self, shape, minval=0.0, device="cpu"):
            return super().uniform(shape, minval, "cpu").to(device)

        def gumbel(self, shape, dtype=torch.float32, device="cpu"):
            return super().gumbel(shape, dtype, "cpu").to(device)

    gamma, P, new = 4, 12, 24
    cfg = registry.smoke_config("llama3.2-1b")
    cfg = cfg.replace(embed_init_scale=cfg.d_model ** -0.5)
    mt = build_model(cfg)
    md = build_model(cfg.replace(num_layers=cfg.num_layers - 1, name="draft"))
    pt_cpu = mt.init(0, "cpu")
    pd_cpu = {**pt_cpu, "layers": pt_cpu["layers"][:-1]}
    pt, pd = to_cuda(pt_cpu), to_cuda(pd_cpu)
    prompts = [np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, P)).astype(np.int32)
               for seed in range(4)]
    counters = kernel_counters()
    paths = {"cached_linear": ({"use_cache": True}, "paged_attention"),
             "nocache_linear": ({"use_cache": False}, "flash_attention"),
             "ring_tree_w2": ({"use_cache": True, "draft_policy": "tree",
                               "draft_k": 2}, "tree_attention")}
    for path, (kw, kernel) in paths.items():
        eng = SpecEngine(mt, md, EngineConfig(gamma=gamma, greedy=False,
                                              temperature=1.0, **kw))
        info = {"phase": "smoke_sampled_exactness", "path": path, "gamma": gamma,
                "batch": 2, "prompt_len": P, "new_tokens": new, "rounds": 0,
                "accepted": 0, "drafted": 0, "gpu_equals_cpu": True}
        for fn in counters.values():
            fn.launches = 0
        for i, prompt in enumerate(prompts):
            gpu, st_gpu = eng.generate(pt, pd, prompt, new, key=HostKey(100 + i))
            cpu, st_cpu = eng.generate(pt_cpu, pd_cpu, prompt, new, key=HostKey(100 + i))
            for k in ("rounds", "accepted", "drafted"):
                info[k] += st_gpu[k]
            info["gpu_equals_cpu"] &= bool(np.array_equal(gpu.cpu().numpy(), cpu.numpy())
                                           and st_gpu == st_cpu)
        torch.cuda.synchronize()
        info["launches"] = {name: fn.launches for name, fn in counters.items()}
        emit(info)
        if not (info["gpu_equals_cpu"] and 0 < info["accepted"] < info["drafted"]
                and info["launches"][kernel] > 0
                and info["launches"]["blockwise_argmax"] == 0):
            raise SystemExit(f"smoke-width sampled exactness failed: {info}")
    same = []
    for i, prompt in enumerate(prompts):
        gpu = autoregressive_generate(mt, pt, prompt, new, greedy=False,
                                      key=HostKey(200 + i), use_cache=True)
        cpu = autoregressive_generate(mt, pt_cpu, prompt, new, greedy=False,
                                      key=HostKey(200 + i), use_cache=True)
        greedy = autoregressive_generate(mt, pt_cpu, prompt, new, use_cache=True)
        same.append((bool(np.array_equal(gpu.cpu().numpy(), cpu.numpy())),
                     bool(torch.equal(cpu, greedy))))
    info = {"phase": "smoke_sampled_exactness", "path": "cached_ar",
            "batch": 2, "prompt_len": P, "new_tokens": new,
            "gpu_equals_cpu": all(a for a, _ in same),
            "batches_equal_greedy": sum(b for _, b in same)}
    emit(info)
    if not info["gpu_equals_cpu"] or info["batches_equal_greedy"] == len(prompts):
        raise SystemExit(f"smoke-width sampled AR failed: {info}")


def sampled_lossless():
    """The stochastic acceptance rules on the card with the port's own
    key drawing on the device (``TorchKey``: a CUDA generator), one
    batched call of N = 20,000 rows over V = 8: drafts i.i.d. from q, and
    the first emitted token (an accepted draft or the residual resample)
    must follow p: total variation below 0.03 for ``verify_stochastic``
    and below 0.02 for ``verify_tree_stochastic`` at width 3 (the
    thresholds of tests/test_acceptance.py and tests/test_tree_rounds.py).
    The two calls' times are readings."""
    from repro_torch.core import acceptance
    from repro_torch.sampling.keys import TorchKey, categorical
    N, V, W = 20000, 8, 3
    rng = np.random.default_rng(31)

    def logits(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32)).cuda()

    def tv(first, p):
        emp = torch.bincount(first.long(), minlength=V).double() / N
        return float(0.5 * (emp - torch.softmax(p.double(), -1)).abs().sum())

    q_lin, p_lin = logits(V), logits(2, V)
    kd, kv = TorchKey(3).split()
    q = q_lin.expand(N, 1, V)
    drafts = categorical(kd, q)

    def linear():
        return acceptance.verify_stochastic(kv, drafts, q, p_lin.expand(N, 2, V))
    q_root, p_root = logits(V), logits(V)
    kh, kt = TorchKey(4).split()
    heads = categorical(kh, q_root.expand(N * W, V)).reshape(N, W, 1)
    p_tree = torch.cat([p_root[None, None].expand(N, 1, V),
                        torch.zeros((N, W, V), device="cuda")], dim=1)
    slots = np.arange(1, W + 1)[:, None]

    def tree():
        return acceptance.verify_tree_stochastic(kt, heads, q_root.expand(N, W, 1, V),
                                                 p_tree, slots)
    res, res_t = linear(), tree()
    timer = Timer()
    info = {"phase": "sampled_lossless", "rows": N, "vocab": V, "width": W,
            "device": str(res.out_tokens.device),
            "tv_linear": tv(res.out_tokens[:, 0], p_lin[0]),
            "accept_rate_linear": float(res.n_accepted.float().mean()),
            "tv_tree": tv(res_t.out_tokens[:, 0], p_root),
            "root_accept_rate_tree": float(res_t.n_accepted.float().mean()),
            "winners": torch.bincount(res_t.winner.long(), minlength=W).tolist(),
            "linear_ms": timer(linear), "tree_ms": timer(tree)}
    emit(info)
    if not (info["tv_linear"] < 0.03 and info["tv_tree"] < 0.02
            and res.out_tokens.is_cuda and all(info["winners"])):
        raise SystemExit(f"sampled acceptance is not lossless on the card: {info}")


def full_width_sampled(mt, md, pt, pd, cfg, card, nocache, cached):
    """Speculative sampling at full width: the paper's pair (bf16) through
    ``launch.serve.serve(greedy=False, temperature=1.0)`` with the greedy
    serves' traffic (4 requests of 64 prompt + 64 new tokens, two waves of
    2, gamma 4), the no-cache and the cached engine, each twice with one
    ``TorchKey`` seed: the tokens must be the same both times, and every
    kernel's count, set to 0 just before each serve and read just after,
    what the path implies (no-cache: flash once per layer of every pass;
    cached: paged attention once per layer of every pass and prefill; the
    argmax kernel never). The cached engine once more with the target's own
    weights as the drafter: p == q up to float order, so alpha_hat must be
    at least 0.9. Each engine's sampled serve runs once more under
    ``torch.profiler``; its line sets the readings (alpha_hat, rounds, wall
    ms per round, launches per round, device busy ms per round and idle
    share, peak memory, new tokens equal to the greedy serve's) beside the
    greedy serve's of this call (``nocache``, ``cached``). Returns the
    launches of the two sampled serves of each engine's first run."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.sampling.keys import TorchKey
    counters = kernel_counters()
    none = {name: 0 for name in counters}
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    prompts = nocache_prompts(cfg)
    P, batch, seed = prompts.shape[1], 2, 21
    for use_cache in (False, True):          # warm-up, not counted
        serve_cli.serve(mt, md, pt, pd, prompts[:batch], 4, gamma=GAMMA,
                        batch=batch, use_cache=use_cache, greedy=False,
                        key=TorchKey(seed))
    torch.cuda.synchronize()

    def counted(use_cache, drafter, params_d):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        toks, st = serve_cli.serve(mt, drafter, pt, params_d, prompts, NOCACHE_NEW,
                                   gamma=GAMMA, batch=batch, use_cache=use_cache,
                                   greedy=False, temperature=1.0, key=TorchKey(seed))
        torch.cuda.synchronize()
        st["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        st["launches"] = {name: fn.launches for name, fn in counters.items()}
        return toks, st

    def expected(use_cache, st, L_draft):
        passes = st["rounds"] * (L_t + GAMMA * L_draft)
        if use_cache:
            return {**none, "paged_attention": passes + st["waves"] * (L_t + L_draft)}
        return {**none, "flash_attention": passes}

    def side(info, prof):
        busy = prof["device_busy_s"]
        return {"rounds": info["rounds"],
                "mean_accepted_per_round": info["mean_accepted_per_round"],
                "wall_ms_per_round": info["ms_per_round"],
                "tokens_per_s": info["tokens_per_s"],
                "peak_memory_gib": info["peak_memory_gib"],
                "device_busy_ms_per_round": None if busy is None else busy / prof["rounds"] * 1e3,
                "device_idle_share": prof["device_idle_share"],
                "kernel_launches_per_round": prof["kernel_launches_per_round"]}

    launches = dict(none)
    for use_cache, greedy in ((False, nocache), (True, cached)):
        engine = "cached" if use_cache else "nocache"
        a, sa = counted(use_cache, md, pd)
        b, sb = counted(use_cache, md, pd)
        rounds = sa["rounds"]
        want = expected(use_cache, sa, L_d)

        def run():
            _, st = serve_cli.serve(mt, md, pt, pd, prompts, NOCACHE_NEW, gamma=GAMMA,
                                    batch=batch, use_cache=use_cache, greedy=False,
                                    key=TorchKey(seed))
            return st["rounds"], st["waves"] if use_cache else 0
        prof = profile(f"profile_sampled_{engine}", run, pt, pd, card)
        info = {"phase": "full_width_sampled", "engine": engine, "card": card,
                "target": mt.cfg.name, "drafter": md.cfg.name, "dtype": mt.cfg.dtype,
                "temperature": 1.0, "key": f"TorchKey({seed})",
                "requests": len(prompts), "batch": batch, "waves": sa["waves"],
                "prompt_len": P, "new_tokens": NOCACHE_NEW, "gamma": GAMMA,
                "rounds": rounds, "alpha_hat": sa["alpha_hat"],
                "mean_accepted_per_round": sa["accepted"] / rounds,
                "ms_per_round": sa["seconds"] / rounds * 1e3,
                "tokens_per_s": sa["tokens_per_s"],
                "peak_memory_gib": sa["peak_memory_gib"],
                "launches": sa["launches"], "expected_launches": want,
                "second_run_launches": sb["launches"],
                "same_seed_same_tokens": bool(np.array_equal(a, b)) and sa["rounds"] == sb["rounds"],
                "in_vocab": bool(((a >= 0) & (a < cfg.vocab_size)).all()),
                "new_tokens_equal_greedy": int((a[:, P:] == greedy["tokens"][:, P:]).sum()),
                "new_tokens_total": int(a[:, P:].size)}
        info["sampled"] = side(info, prof)
        info["greedy"] = side(greedy["info"], greedy["profile"])
        emit(info)
        if not (info["same_seed_same_tokens"] and info["in_vocab"]
                and sa["launches"] == want and sb["launches"] == expected(use_cache, sb, L_d)):
            raise SystemExit(f"full-width sampled serve failed: {info}")
        for name, n in sa["launches"].items():
            launches[name] += n
    # the target drafting for itself, cached
    c, sc = counted(True, mt, pt)
    info = {"phase": "full_width_sampled", "engine": "cached", "drafter": "target",
            "card": card, "temperature": 1.0, "rounds": sc["rounds"],
            "alpha_hat": sc["alpha_hat"], "ms_per_round": sc["seconds"] / sc["rounds"] * 1e3,
            "peak_memory_gib": sc["peak_memory_gib"], "launches": sc["launches"],
            "expected_launches": expected(True, sc, L_t),
            "new_tokens_equal_greedy": int((c[:, P:] == cached["tokens"][:, P:]).sum())}
    emit(info)
    if sc["alpha_hat"] < 0.9 or sc["launches"] != info["expected_launches"]:
        raise SystemExit(f"full-width sampled serve with the target as drafter failed: {info}")
    return launches


def full_width_session(mt, md, pt, pd, cfg, card, linear, nocache, cached):
    """The paper's planner and the Session facade at full width on the
    paper's pair (bf16; ``"phase": "full_width_session"``): each part plans
    with ``repro_torch.api.Planner`` and runs through ``Session`` on the
    card, every kernel's count set to 0 just before the run and read just
    after, and must give the tokens it is held to with exact launches.
    (a) The serve-paged CLI's spec (streaming, ``full_width``'s 8 ragged
    requests, alpha 0.8, no c: the prior) on the planner's own geometry
    (block 8: the card's paged phases so far ran block 16): gamma pinned to
    GAMMA, tokens == ``full_width``'s block-16 serve; gamma adaptive (the
    scheduler's online Eq. (1)), tokens == its AR serve; paged launches
    from each round's gamma (``path_launches``), the argmax once per
    speculative round. (b) The serve CLI's no-cache plan: ``launch.serve.
    serve`` plans its waves (``serve_plan``) and runs them through
    ``Session.generate``, so ``full_width_nocache`` ran it; its tokens
    equal AR's there and its flash launches are rounds x 92, read here.
    (c) A per-row plan (cached, modular, the 4 no-cache prompts at B=4):
    tokens == ``BatchedSpecEngine.generate``'s (``full_width_cached`` b).
    (d) An adaptive single-stream cached plan (the first prompt): tokens
    == cached AR's; prints the gamma trace. (e) A pinned tree plan
    (``draft_policy="tree"``, ``draft_k=TREE_W``; depth = the planner's
    gamma*): tokens == cached AR's, tree launches L_t a round. (f) The
    loop: (a)'s pinned plan served traced; ``respec_from_drift(spec,
    drift, alpha=sess.alpha_hat)`` re-plans with the measured c, which the
    new plan must carry; prints c and gamma* for the prior, the planner's
    roofline c for ``llama3.2-3b`` and the measured c. Returns the phase's
    launches."""
    import dataclasses

    from repro_torch.api import (DeploymentSpec, Planner, Session,
                                 respec_from_drift)
    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs import Tracer
    from repro_torch.serving import ServeRequest
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    t_phase = time.perf_counter()
    counters = kernel_counters()
    total = {name: 0 for name in counters}
    none = dict(total)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        for n, v in launches.items():
            total[n] += v
        return out, time.perf_counter() - t0, launches

    def pinned(plan, gamma):
        return dataclasses.replace(plan, gamma=dataclasses.replace(
            plan.gamma, gamma=gamma, adaptive=False, candidates=()))

    def check(info, ok):
        emit(info)
        if not ok:
            raise SystemExit(f"full-width Session part failed: {info}")

    # (a) the serve-paged plan, pinned and adaptive; (f) traced
    reqs = linear["reqs"]
    spec = DeploymentSpec(batch_size=4, prompt_lens=tuple(len(p) for p, _ in reqs),
                          max_new=tuple(n for _, n in reqs), streaming=True,
                          adaptive_gamma=True)
    plan = Planner(spec).plan()

    def paged(part, plan, want, tracer=None):
        sess = Session(mt, md, pt, pd, plan, max_batch=4, tracer=tracer)
        done, wall, launches = counted(lambda: sess.serve(
            [ServeRequest(i, p, n) for i, (p, n) in enumerate(reqs)]))
        srv = sess.backend.server
        got = {r.rid: r.tokens for r in done}
        expect = path_launches(srv, counters, L_t, L_d)
        gammas = [e.gamma for e in srv.events.events()]
        info = {"phase": "full_width_session", "part": part, "card": card,
                "backend": sess.backend_name, "block_size": srv.scfg.block_size,
                "num_blocks": srv.scfg.num_blocks,
                "max_blocks_per_row": srv.scfg.max_blocks_per_row,
                "prefill_buckets": list(srv.scfg.prefill_buckets),
                "plan_gamma": plan.gamma.gamma, "adaptive": plan.gamma.adaptive,
                "rounds": srv.total_rounds, "prefills": srv.n_prefills,
                "gammas": gammas, "wall_s": wall,
                "ms_per_round": wall / srv.total_rounds * 1e3,
                "alpha_hat": sess.alpha_hat, "launches": launches,
                "expected_launches": expect,
                "argmax_per_spec_round": launches["blockwise_argmax"]
                / max(sum(1 for g in gammas if g > 0), 1),
                "tokens_equal": sorted(got) == list(range(len(reqs))) and all(
                    np.array_equal(got[i], want[i]) for i in range(len(reqs)))}
        return sess, info, info["tokens_equal"] and launches == expect

    a_plan = pinned(plan, GAMMA)
    _, info, ok = paged("a_pinned", a_plan, linear["tokens"])
    check({**info, "plan_cache": dataclasses.asdict(plan.cache)}, ok)
    _, info, ok = paged("a_adaptive", plan, linear["ar"])
    check(info, ok)

    # (b) the serve CLI's no-cache plan, run by full_width_nocache
    b_plan = serve_cli.serve_plan(2, NOCACHE_PROMPT, NOCACHE_NEW, gamma=GAMMA)
    b_backend = Session(mt, md, pt, pd, b_plan, max_batch=2).backend_name
    nc = nocache["info"]
    info = {"phase": "full_width_session", "part": "b_nocache_cli_plan",
            "card": card, "backend": b_backend, "strategy": b_plan.strategy,
            "use_cache": b_plan.use_cache, "gamma": b_plan.gamma.gamma,
            "cli_default_gamma": serve_cli.serve_plan(
                2, NOCACHE_PROMPT, NOCACHE_NEW).gamma.gamma,
            "rounds": nc["rounds"], "flash_launches": nc["launches"]["flash_attention"],
            "expected_flash": nc["expected_launches"]["flash_attention"],
            "spec_equals_ar": nc["spec_equals_ar"]}
    check(info, b_backend == "engine" and nc["spec_equals_ar"]
          and info["flash_launches"] == info["expected_flash"])

    prompts = nocache_prompts(cfg)
    P = prompts.shape[1]

    # (c) a per-row plan
    c_plan = pinned(Planner(DeploymentSpec(
        batch_size=len(prompts), prompt_lens=(P,), max_new=NOCACHE_NEW,
        strategy="modular", adaptive_gamma=False)).plan(), GAMMA)
    sess = Session(mt, md, pt, pd, c_plan)
    (toks, lengths, st), wall, launches = counted(
        lambda: sess.generate_batch(prompts, NOCACHE_NEW))
    rounds = st["rounds"]
    expect = {**none, "paged_attention": rounds * (GAMMA * L_d + L_t) + L_t + L_d,
              "blockwise_argmax": rounds}
    same = bool(np.array_equal(toks.cpu().numpy()[:, :P + NOCACHE_NEW],
                               cached["batched"][:, :P + NOCACHE_NEW]))
    check({"phase": "full_width_session", "part": "c_per_row", "card": card,
           "backend": sess.backend_name, "batch": len(prompts), "gamma": GAMMA,
           "rounds": rounds, "wall_s": wall, "alpha_hat": st["alpha_hat"],
           "launches": launches, "expected_launches": expect,
           "tokens_equal_batched_engine": same},
          sess.backend_name == "per_row" and same and launches == expect)

    # (d) an adaptive single-stream cached plan
    d_plan = Planner(DeploymentSpec(batch_size=1, prompt_lens=(P,),
                                    max_new=NOCACHE_NEW,
                                    adaptive_gamma=True)).plan()
    sess = Session(mt, md, pt, pd, d_plan)
    (toks, st), wall, launches = counted(
        lambda: sess.generate(prompts[:1], NOCACHE_NEW))
    trace = st["gamma_trace"]
    expect = {**none, "paged_attention": sum(g * L_d + L_t for g in trace) + L_t + L_d,
              "blockwise_argmax": len(trace)}
    same = bool(np.array_equal(toks.cpu().numpy()[:, :P + NOCACHE_NEW],
                               cached["ar"][:1]))
    check({"phase": "full_width_session", "part": "d_adaptive_cached",
           "card": card, "backend": sess.backend_name,
           "candidates": list(d_plan.gamma.candidates), "gamma_trace": trace,
           "rounds": st["rounds"], "wall_s": wall,
           "ms_per_round": wall / st["rounds"] * 1e3,
           "accepted": st["accepted"], "drafted": st["drafted"],
           "alpha_ema": sess.alpha_hat, "launches": launches,
           "expected_launches": expect, "tokens_equal_cached_ar": same},
          sess.backend_name == "engine" and same and launches == expect
          and len(trace) == st["rounds"])

    # (e) a pinned tree plan
    e_plan = Planner(DeploymentSpec(batch_size=1, prompt_lens=(P,),
                                    max_new=NOCACHE_NEW, draft_policy="tree",
                                    draft_k=TREE_W, adaptive_gamma=False)).plan()
    depth = e_plan.gamma.gamma
    sess = Session(mt, md, pt, pd, e_plan)
    (toks, st), wall, launches = counted(
        lambda: sess.generate(prompts[:1], NOCACHE_NEW))
    rounds = st["rounds"]
    expect = {**none, "tree_attention": L_t * rounds,
              "paged_attention": depth * L_d * rounds + L_d + L_t,
              "blockwise_argmax": rounds}
    same = bool(np.array_equal(toks.cpu().numpy()[:, :P + NOCACHE_NEW],
                               cached["ar"][:1]))
    check({"phase": "full_width_session", "part": "e_tree", "card": card,
           "backend": sess.backend_name, "draft_policy": e_plan.draft_policy,
           "width": e_plan.draft_k, "depth": depth, "strategy": e_plan.strategy,
           "rounds": rounds, "accepted": st["accepted"], "wall_s": wall,
           "ms_per_round": wall / rounds * 1e3,
           "tree_per_round": launches["tree_attention"] / rounds,
           "launches": launches, "expected_launches": expect,
           "tokens_equal_cached_ar": same},
          e_plan.draft_policy == "tree" and same and launches == expect)

    # (f) the loop: a traced run of (a)'s pinned plan, re-planned from its
    # drift monitor
    tracer = Tracer()
    sess, info, ok = paged("f_traced", a_plan, linear["tokens"], tracer)
    drift = sess.telemetry()["drift"]
    ev = drift.evidence() if drift is not None and drift.calibrated else None
    check({**info, "drift_evidence": ev}, ok and ev is not None)
    respec = respec_from_drift(spec, drift, alpha=sess.alpha_hat)
    measured = Planner(respec).plan()
    prior = Planner(dataclasses.replace(respec, t_draft=None, t_target=None)).plan()
    roofline = Planner(dataclasses.replace(respec, t_draft=None, t_target=None,
                                           arch="llama3.2-3b")).plan()

    def at_prior_alpha(s):
        return Planner(dataclasses.replace(s, alpha=spec.alpha)).plan().gamma.gamma
    loop = {"phase": "full_width_session", "part": "f_loop", "card": card,
            "alpha_spec": spec.alpha, "alpha_measured": respec.alpha,
            "c": {"prior": prior.cost_coefficient,
                  "roofline_llama3.2-3b": roofline.cost_coefficient,
                  "measured": measured.cost_coefficient},
            "gamma_at_measured_alpha": {"prior": prior.gamma.gamma,
                                        "roofline_llama3.2-3b": roofline.gamma.gamma,
                                        "measured": measured.gamma.gamma},
            "gamma_at_spec_alpha": {
                "prior": at_prior_alpha(dataclasses.replace(respec, t_draft=None,
                                                            t_target=None)),
                "roofline_llama3.2-3b": at_prior_alpha(dataclasses.replace(
                    respec, t_draft=None, t_target=None, arch="llama3.2-3b")),
                "measured": at_prior_alpha(respec)},
            "measured_rationale": measured.rationale[0],
            "replanned_c_equals_measured": measured.cost_coefficient == ev["c"],
            "phase_s": time.perf_counter() - t_phase}
    check(loop, loop["replanned_c_equals_measured"]
          and prior.cost_coefficient == 0.25)
    return total


CHAOS_SEED = 6        # FaultPlan.seeded: a drafter failure at step 2, a
                      # delay at 3, seizures at 3-5 (before any watchdog
                      # trip can pin the batch to AR)


def full_width_placed(mt, md, pt, pd, cfg, card, linear, cached):
    """Plan-carried placement and the paged server's robustness layer at
    full width on the paper's pair (bf16; ``"phase": "full_width_placed"``),
    every kernel's count set to 0 just before each run and read just after.
    (a) Lowering on one card: the default plan lowers to DEGENERATE; the
    CLI's ``1x1`` to the shared-device placement (heterogeneous,
    overlapping, both roles on cuda:0; its ``describe()`` printed); ``2x6``
    falls back to the degenerate lowering with its note. (b) The placed
    cached ``SpecEngine`` through ``Session`` on the no-cache traffic (two
    waves of 2), overlap off and on, beside the unplaced serve: tokens and
    rounds == ``full_width_cached`` (a), paged launches rounds x
    92 + waves x 44 and an argmax a round, plus one discarded round a wave
    (92 paged, 1 argmax) under overlap; wall per round of each (a
    reading). (c) The placed ``BatchedSpecEngine`` (B=4): tokens ==
    ``full_width_cached`` (b). (d) The placed ``PagedSpecServer`` on
    ``full_width``'s trace, block 16: tokens == ``full_width``'s, exact
    launches, the audit balanced after the drain. (e) Chaos on the same
    trace under overcommit 2.0 on 40 blocks with ``FaultPlan.seeded(
    CHAOS_SEED)`` (delays, drafter failures, seizures): every request
    completes with the clean tokens, the pool whole, at least one
    "injected drafter failure" degradation (the degradation list printed);
    a ``FaultPlan(corrupt_rounds={1, 2})`` serve on (d)'s geometry fails
    the poisoned requests with the corrupt-token reason and its survivors
    keep the clean tokens; then the paged wrapper is made to raise
    ``RuntimeError`` for one call inside a speculative round: ``step()``
    must raise and no degradation be logged. Returns the phase's
    launches."""
    import dataclasses

    from repro_torch.api import PlacementPlan, Session, lower, lower_or_degenerate
    from repro_torch.device import visible
    from repro_torch.api.placement import DEGENERATE, PlacementError
    from repro_torch.core.batched_engine import (BatchedEngineConfig,
                                                 BatchedSpecEngine)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.cli_args import apply_placement_arg
    from repro_torch.serving import (FaultPlan, PagedSpecServer,
                                     SchedulerConfig, ServeRequest)
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    per_round, per_wave = GAMMA * L_d + L_t, L_t + L_d
    t_phase = time.perf_counter()
    counters = kernel_counters()
    total = {name: 0 for name in counters}
    none = dict(total)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        for n, v in launches.items():
            total[n] += v
        return out, time.perf_counter() - t0, launches

    def check(info, ok):
        emit(info)
        if not ok:
            raise SystemExit(f"full-width placed part failed: {info}")

    # (a) lowering on one card
    prompts = nocache_prompts(cfg)
    P, batch = prompts.shape[1], 2
    base = serve_cli.serve_plan(batch, P, NOCACHE_NEW, gamma=GAMMA, use_cache=True)
    one = apply_placement_arg(base, "1x1")
    shared = lower(one.placement)
    two_six = apply_placement_arg(base, "2x6").placement
    try:
        lower(two_six)
        raised = False
    except PlacementError:
        raised = True
    fallback = lower_or_degenerate(two_six)
    first = visible()[0]
    check({"phase": "full_width_placed", "part": "a_lowering", "card": card,
           "visible": [str(d) for d in visible()],
           "roles_on": [str(shared.drafter.device), str(shared.target.device)],
           "default": lower(PlacementPlan()).describe(),
           "1x1": shared.describe(), "2x6": fallback.describe()},
          lower(PlacementPlan()) is DEGENERATE and shared.heterogeneous
          and not shared.disjoint and shared.overlap
          and shared.drafter.device == shared.target.device == first
          and raised and not fallback.heterogeneous
          and fallback.note.startswith("degenerate fallback: "))

    # (b) the placed cached engine, overlap off and on, beside the unplaced
    waves = -(-len(prompts) // batch)
    plans = {"placed": dataclasses.replace(one, placement=dataclasses.replace(
                 one.placement, overlap=False)),
             "placed_overlap": one, "unplaced": base}
    want, want_rounds = cached["tokens"], cached["info"]["rounds"]
    walls = {}
    for name in plans:
        sess = Session(mt, md, pt, pd, plans[name], max_batch=batch)
        eng_placed = sess.backend._engine(GAMMA).placement is not None
        (toks, st), wall, launches = counted(
            lambda: serve_cli.serve_waves(sess, prompts, NOCACHE_NEW, batch))
        rounds = st["rounds"]
        extra = waves if name == "placed_overlap" else 0
        expect = {**none, "paged_attention": (rounds + extra) * per_round
                  + waves * per_wave, "blockwise_argmax": rounds + extra}
        walls[name] = wall / rounds * 1e3
        check({"phase": "full_width_placed", "part": f"b_{name}", "card": card,
               "placement": sess.placement.describe(), "engine_placed": eng_placed,
               "waves": waves, "rounds": rounds, "wall_s": wall,
               "ms_per_round": wall / rounds * 1e3, "launches": launches,
               "expected_launches": expect,
               "tokens_equal_cached": bool(np.array_equal(toks, want)),
               "rounds_equal_cached": rounds == want_rounds},
              np.array_equal(toks, want) and rounds == want_rounds
              and launches == expect and eng_placed == (name != "unplaced"))
    emit({"phase": "full_width_placed", "part": "b_wall_per_round_ms",
          "card": card, "reading": walls})

    # (c) the placed per-row engine, B = 4
    eng = BatchedSpecEngine(mt, md, BatchedEngineConfig(gamma=GAMMA),
                            placement=shared)
    (toks, lengths, st), wall, launches = counted(
        lambda: eng.generate(pt, pd, prompts, NOCACHE_NEW))
    rounds = st["rounds"]
    expect = {**none, "paged_attention": rounds * per_round + per_wave,
              "blockwise_argmax": rounds}
    same = bool(np.array_equal(toks.cpu().numpy()[:, :P + NOCACHE_NEW],
                               cached["batched"][:, :P + NOCACHE_NEW]))
    check({"phase": "full_width_placed", "part": "c_per_row", "card": card,
           "batch": len(prompts), "rounds": rounds, "wall_s": wall,
           "placed": eng.placed_round is not None, "launches": launches,
           "expected_launches": expect, "tokens_equal_batched_engine": same},
          same and launches == expect and eng.placed_round is not None)

    # (d) the placed paged server on the linear trace, block 16
    reqs = linear["reqs"]
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=256,
                           max_blocks_per_row=16)

    def paged(scfg, faults=None, placement=shared, reqs=reqs):
        srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=GAMMA,
                              placement=placement, faults=faults, device="cuda")
        for i, (prompt, new) in enumerate(reqs):
            srv.submit(ServeRequest(i, prompt, new))
        return srv, {r.rid: r.tokens for r in srv.run()}

    def equal(got, want, rids):
        return sorted(got) == sorted(rids) and all(
            np.array_equal(got[i], want[i]) for i in rids)
    (srv, got), wall, launches = counted(lambda: paged(scfg))
    expect = path_launches(srv, counters, L_t, L_d)
    census = audited(srv)
    same = equal(got, linear["tokens"], range(len(reqs)))
    check({"phase": "full_width_placed", "part": "d_paged", "card": card,
           "placed": srv.placement is not None, "rounds": srv.total_rounds,
           "prefills": srv.n_prefills, "wall_s": wall,
           "ms_per_round": wall / srv.total_rounds * 1e3, "launches": launches,
           "expected_launches": expect, "census": census,
           "tokens_equal_full_width": same},
          same and launches == expect and srv.placement is not None)

    # (e) chaos: seeded faults under overcommit, then corrupt output, then
    # a failing kernel, which must raise rather than degrade
    plan = FaultPlan.seeded(CHAOS_SEED, horizon=256, p_delay=0.2, delay_s=0.05,
                            p_drafter=0.15, p_seize=0.2, max_seize=3)
    oc = dataclasses.replace(scfg, num_blocks=28, overcommit=2.0)
    (srv, got), wall, launches = counted(lambda: paged(oc, plan))
    expect = path_launches(srv, counters, L_t, L_d)
    s = srv.metrics.summary()
    srv.alloc.release_seized()
    census = audited(srv)
    degr = [[r, why] for r, why in srv.metrics.degradations]
    terminal = (s["requests_completed"] == len(reqs) and not srv.metrics.requests
                and not srv.sched.queue and all(r is None for r in srv._slots))
    same = equal(got, linear["tokens"], range(len(reqs)))
    check({"phase": "full_width_placed", "part": "e_chaos", "card": card,
           "faults": plan.describe(), "steps": srv.total_steps,
           "rounds": srv.total_rounds, "spec_rounds": s["spec_rounds"],
           "preemptions": s["n_preemptions"], "degradations": degr,
           "degraded_rounds": sum(e.degraded for e in srv.events.events()),
           "fault_delays": sum(e.fault_delay > 0 for e in srv.events.events()),
           "watchdog_trips": srv.watchdog.n_trips, "wall_s": wall,
           "launches": launches, "expected_launches": expect, "census": census,
           "all_terminal": terminal, "tokens_equal_clean": same},
          same and terminal and launches == expect and any(
              "injected drafter failure" in why for _, why in degr))
    corrupt = FaultPlan(corrupt_rounds=frozenset({1, 2}))
    (srv, got), wall, launches = counted(lambda: paged(scfg, corrupt))
    expect = path_launches(srv, counters, L_t, L_d)
    failed = [[r.rid, r.failed] for r in srv.metrics.failed]
    census = audited(srv)
    survivors = [i for i in range(len(reqs)) if i not in {f[0] for f in failed}]
    s = srv.metrics.summary()
    check({"phase": "full_width_placed", "part": "e_corrupt", "card": card,
           "failed": failed, "completed": s["requests_completed"],
           "launches": launches, "expected_launches": expect, "census": census,
           "survivors_equal_clean": equal(got, linear["tokens"], survivors)},
          failed and all("corrupt token id" in why for _, why in failed)
          and s["requests_completed"] + len(failed) == len(reqs)
          and equal(got, linear["tokens"], survivors) and launches == expect)
    srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=GAMMA, placement=shared,
                          device="cuda")
    for i, (prompt, new) in enumerate(reqs[:4]):
        srv.submit(ServeRequest(i, prompt, new))
    real = pa.paged_flash_attention

    def failing(*args, **kw):
        pa.paged_flash_attention = real
        raise RuntimeError("paged attention kernel failed (injected)")
    (_, _, launches) = counted(srv.step)
    pa.paged_flash_attention = failing
    try:
        srv.step()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        pa.paged_flash_attention = real
    check({"phase": "full_width_placed", "part": "e_no_fallback", "card": card,
           "raised": raised, "degradations": srv.metrics.degradations,
           "first_step_launches": launches, "phase_s": time.perf_counter() - t_phase},
          raised == "paged attention kernel failed (injected)"
          and srv.metrics.degradations == [] and pa.paged_flash_attention is real)
    return total


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
    return launches["launches"]


def full_width_ssm(card):
    """Mamba-2 at full width: the mamba2-780m target and its registered
    drafter (bf16, seeded random weights), one SSD launch per layer of each
    pass and nothing else but the argmax; then (d) the cached engine on the
    same traffic (the stateful drafter: GAMMA + 1 sequential-scan steps a
    round; the verify's trail by the sequential scan too, as in JAX): SSD
    launches only in the prefills (one per layer: P - 1 = 63 > 16 rows
    take the chunked kernel from the cache's state, keeping its final
    state), an argmax a round. Returns (no-cache, cached) launches."""
    from repro_torch.launch.cli_args import build_pair
    mt, md, pt, pd, cfg = build_pair("mamba2-780m", smoke=False, device="cuda")
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    nocache = nocache_phase("full_width_ssm", "profile_ssm", mt, md, pt, pd,
                            cfg, card, {"ssd_scan": (L_t, L_d)})
    buffer_invariance(mt, pt, cfg, card)
    cached = cached_serve("full_width_ssm_cached", "profile_ssm_cached", mt, md,
                          pt, pd, cfg, card, {"ssd_scan": (L_t, L_d, 0, 0)},
                          nocache, exact=False)
    return nocache["launches"], cached["launches"]


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


def profile(phase, run, pt, pd, card, regions=()):
    """A serve once more under torch.profiler (``run()`` serves and returns
    its rounds and prefills): the device's busy time (the union of the CUDA
    kernels' intervals), its idle share of the wall time, kernel launches
    per round and the device time by kernel, largest first. The profiler
    slows the host, so this run's wall time is not the throughput. The
    port's kernels are also listed alone, in device ms per round. Each
    label of ``regions`` names a ``region`` the run wraps around some
    calls: the union of the device time of the kernels that start inside
    its calls, in all and per call."""
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
    calls = {label: [] for label in regions}     # host intervals per region
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in calls:
            if ev.device_type() == torch.autograd.DeviceType.CPU:
                calls[ev.name()].append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            continue          # the region's own device-side annotation
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
    in_region = {}
    for label, iv in calls.items():
        iv.sort()
        starts = [a for a, _ in iv]
        mine = []
        for s, e in spans:
            i = int(np.searchsorted(starts, s, side="right")) - 1
            if i >= 0 and s <= iv[i][1]:
                mine.append((s, e))
        busy = _union(mine) / 1e6
        in_region[label] = {"calls": len(iv), "kernels": len(mine),
                            "device_busy_ms": busy,
                            "device_busy_ms_per_call": busy / len(iv) if iv else None}
    info = {"phase": phase, "card": card, "rounds": rounds,
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
              src: _union(iv) / 1e6 / rounds for src, iv in sorted(by_file.items())},
          **({"regions": in_region} if regions else {})}
    emit(info)
    return info


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
    chunk_cases = paged_chunk_cases(timer)
    ring_cases = ring_view_cases(timer)
    fl_cases = flash_cases(timer)
    ssd = ssd_cases(timer)
    ssd += ssd_state_cases(timer)
    ssd_l_invariance()
    i8 = int8_cases(timer)
    del timer

    smoke_exactness()
    smoke_tree_exactness()
    smoke_nocache_exactness()
    smoke_nocache_exactness("mamba2-780m", "smoke_ssm_nocache_exactness")
    smoke_ssm_cached_exactness()
    smoke_nocache_exactness("llama3.2-1b", "smoke_w8a8_exactness", w8a8=True)
    smoke_sampled_exactness()
    sampled_lossless()
    from repro_torch.launch.cli_args import build_pair
    pair = build_pair("llama3.2-3b", smoke=False, device="cuda")
    _, linear = full_width(*pair, card)
    tree_launches = full_width_tree(*pair, card)
    mt, md, pt, pd, cfg = pair
    buffer_invariance(mt, pt, cfg, card)
    reading = prefill_invariance(mt, pt, cfg, card)
    launches, chunked = full_width_chunked(*pair, card, reading, chunk_cases)
    full_width_traced(*pair, card, chunked)
    del mt, md, pt, pd
    nocache = full_width_nocache(*pair, card)
    cached_launches, cached = full_width_cached(*pair, card, nocache)
    sampled_launches = full_width_sampled(*pair, card, nocache, cached)
    session_launches = full_width_session(*pair, card, linear, nocache, cached)
    placed_launches = full_width_placed(*pair, card, linear, cached)
    del cached, linear
    w8a8_launches = full_width_w8a8(*pair, card)
    del pair
    torch.cuda.empty_cache()
    ssm_launches, ssm_cached = full_width_ssm(card)

    # each kernel's launches: its main path's (the chunked serve for paged
    # attention and the argmax, the tree phase, the no-cache serves) plus
    # the cached paths' (full_width_cached parts a-c, the cached Mamba-2),
    # the sampled serves' (paged attention cached, flash no-cache), the
    # Session phase's (paged attention, the argmax, tree attention) and the
    # placed phase's (paged attention, the argmax)
    for name, n in cached_launches.items():
        launches[name] += n
    for name in ("paged_attention", "blockwise_argmax"):
        launches[name] += session_launches[name] + placed_launches[name]
    launches["paged_attention"] += sampled_launches["paged_attention"]
    tree_launches["tree_attention"] += (cached_launches["tree_attention"]
                                        + session_launches["tree_attention"])
    launches["blockwise_argmax"] += ssm_cached["blockwise_argmax"]
    head = next(c for c in att if c["headline"])
    tree_head = next(c for c in tree_cases if c["headline"])
    fl_head = next(c for c in fl_cases if c["headline"])
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:87",
         "launches": launches["paged_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in att + chunk_cases + ring_cases),
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
         "launches": (nocache["launches"]["flash_attention"]
                      + sampled_launches["flash_attention"]),
         "max_abs_err": max(c["max_abs_err"] for c in fl_cases),
         "ms": fl_head["kernel_ms"], "plain_ms": fl_head["plain_ms"],
         "bound_ms": fl_head["bound_ms"], "bound_by": fl_head["bound_by"],
         "library_ms": fl_head["library_ms"]},
    ]
    for name, src, replaces, n, cases in (
            ("int8_matmul", "int8_matmul.cu", "int8_matmul.py:40",
             w8a8_launches["int8_matmul"], i8),
            ("ssd_scan", "ssd_scan.cu", "ssd_scan.py:67",
             ssm_launches["ssd_scan"] + ssm_cached["ssd_scan"], ssd)):
        h = next(c for c in cases if c["headline"])
        kernels.append(
            {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/{replaces}", "launches": n,
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
             "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
             "library_ms": h["library_ms"]})
    emit({"phase": "end", "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
