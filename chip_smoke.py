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
   per head geometry and dtype (these two, Granite's two,
   DeepSeek-Coder 33B's and Mixtral 8x7B's), on one pool: the rows of a Q=5 paged call
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
   ``slot_positions`` that JAX's ring computes. Then both kernels over
   int8 pools, as an int8 KV cache hands them over (``"case": "int8_kv"``,
   ``int8_kv_cases``): at the 3B's 24/8/128, the 1B's 32/8/64 and the
   bench pair's 8/4/48, fp32 and bf16, paged Q 1 and 5 (B 4 ragged, row 2
   on the NULL block, a shuffled table), the Q 64 prefill chunk from 448,
   the ring view at Q 1 and 5 (144 slots, written at 70, the call's own
   K/V read as ``fresh`` at Q 5, held against JAX's concat read too) and
   chain_tree(2, 4) with the span's K/V as ``fresh``; then paged Q 5 at
   4/2/32 and 10/1/256 and the tree at 4/2/32. Each within TOL of its
   plain version and bit-equal to the float kernel over the dequantized
   pool with ``fresh`` written in; at paged Q 5 its rows bit-equal to Q=1
   calls and a width-1 tree to the causal call; timed beside that float
   call and masked SDPA over the dequantized K/V, with the bound at 1
   byte a K/V element. Then paged attention at
   the dense-family configs' head geometries (Granite 3.0 2B's target
   32/8/64 and drafter 16/8/64, DeepSeek-Coder 33B's 56/8/128: 7 or 35
   query rows per kv-head; Mixtral 8x7B's 32/8/128, whose drafter's is
   Granite's), Q 1 and 5, fp32 and bf16, as above; and over a
   windowed ring that has wrapped (``"case": "ring_wrap"``: an 80-slot
   ring, window 64, Q 1 and 5 from position 200, past two wraps, read
   through the table over positions; the Granite geometries, fp32 and
   bf16), held against its plain version and JAX's concat read, with
   SDPA masked by the slots' positions as the library. After the int8
   cases of step 8, the same cases at the hybrid family's geometries
   (RecurrentGemma 2B's 10/1/256 and its drafter's 4/1/256: MQA at head
   dim 256): paged attention at Q 1 and 5, the Q-invariance check (the
   width-1 tree skipped: the tree entry takes D 32 to 128), the wrapped
   ring, flash attention at B=2 and S=134, at S=2048 and with a window of
   64 that binds at S=1100, fp32 and bf16; and the argmax at [10, 256000]
   with planted ties. Then the VLM's and the encoder-decoder's shapes
   (``vlm_encdec_kernel_cases``): paged attention at InternVL2-26B's
   48/8/128 and Whisper large-v3's 20/20/64, Q 1 and 5, fp32 and bf16; the
   Q-invariance check at those and their drafters' 12/4/128 and 12/12/64;
   over the cached phases' ring views (InternVL's 336-slot ring at the
   vision prefill, Q = 256 + 31 from 0, and at Q 1 and 5 past it;
   Whisper's 48-slot ring at Q 3, 1 and 5); flash attention non-causal for
   the Whisper encoder (B=2, S=1500; fp32, bf16, and the drafter's
   geometry) and for its cross-attention (Sq 1, 5 and 3 over 1500 keys),
   causal for the InternVL no-cache pass (S = 256 + 70, both geometries,
   fp32 and bf16); the argmax at [10, 92553] and [10, 51866]. Then the
   per-shard geometries of the tensor-parallel phase (``tp_kernel_cases``,
   TP_GEOMS: the 3B target over 4 devices, 6/2/128, and the 1B drafter
   over 2, 16/4/64): paged attention at Q 1 and 5, the ring view at
   RING_CASES, tree attention at chain_tree(2, 4), flash attention at the
   no-cache length, each against its plain version, and the Q-invariance
   check, fp32 and bf16.
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
   served with AR rounds. Its first 4 requests then run once more under
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
   (within one bf16 step of the top-2 margin). Then the chunked serve's
   first 2 requests run once more under ``torch.profiler``, with the
   device time split between
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
   tokens must equal no-cache AR's on the card; then the spec serve's
   first wave runs once more under ``torch.profiler`` (its ``"phase":
   "profile_nocache"`` line, as in step 4; every profile of steps 7 and
   10 and of the hybrid phase serves one wave, its readings per round);
   every kernel's count is read,
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
   none), each set beside the greedy serve of this call (the sampled
   serves are not profiled); then the cached engine with the target drafting for itself
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
   fail inside a round: ``step()`` raises, nothing degrades. Then tensor
   parallelism (``"phase": "full_width_tensor_parallel"``): the pair under
   ``PlacementPlan(drafter=d2, target=t4)`` lowered on six ``cuda:0``
   entries, so the drafter's params and caches split over 2 shards (16 q /
   4 KV heads of 64 each) and the target's over 4 (6 / 2 heads of 128),
   every shard's kernels launched in turn on the one card: (a) the placed
   paged server on step 4's trace (block 16, gamma 4): its tokens against
   step 4's unsharded tokens, a parting allowed only where
   ``near_ties`` over the whole and the split target explains it; the
   spec tokens == the sharded AR
   serve's (all 8 requests in one batch) exactly; paged launches == the
   events' passes x each role's shard count, exactly; (b) the placed
   cached engine through ``Session`` on step 7's no-cache traffic (one
   wave of 4): tokens against the cached serve's (same rule), == the
   sharded cached AR's, launches rounds x (gamma L_d x 2 + L_t x 4) + the
   split prefill's L_t x 4 + L_d x 2; (c) one
   fp32 forward (the 3B cut to TP_LAYERS layers, TF32 off) sharded and
   unsharded, no-cache and a cached decode step: max |d| <= TP_TOL x
   max |logits|; (d) wall per round sharded and unsharded, a reading (one
   card: the extra launches and the reductions, no transfer). Then the
   streaming front end and the continuous ring server (``"phase":
   "full_width_frontend"``): (a) ``Session.serve_async`` replays
   ``poisson_trace(12, 4.0)`` (prompts 16-120, 32-64 new, deadlines
   from the synchronous serve's wall per round) on step 4's geometry, γ 4:
   streams == ``PagedSpecServer.run`` of the same requests (or a first
   difference at a near-tie within one bf16 step), exact paged and argmax
   launches, some deadlines met and some missed; it prints TTFT, TPOT and
   queue-wait p50/p95, goodput, queue depth, tok/s and wall per round
   beside the synchronous serve's; (b) a stream dropped after 2 tokens at
   batch 1: the queued request takes the row, exact, the census balanced;
   (c) one-slot stream queues and a slow consumer: exact; (d) the uniform
   ring-continuous plan through ``Session`` (6 prompts of 64 + 64, batch 4,
   two refills): tokens == ``BatchedSpecEngine.generate``'s and cached
   AR's, paged launches rounds x 92 + prefills x 44, an argmax a round;
   (e) (d) placed ``1x1``, the same; (f) the ``serve_async`` CLI on the
   card at smoke width, rc 0.
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
   (``"smoke_w8a8_exactness"``, three prompt batches of the six). Then
   speculative sampling at smoke width
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
   int8 launches and one flash launch per layer pass), then the compile
   tooling on the same pair (step 10a), then the
   ``mamba2-780m`` target with its registered drafter (``"full_width_ssm"``:
   one SSD launch per layer pass); tokens == AR's, exact counts of all six
   kernels, the Mamba-2 one followed by a profiled serve
   (``"profile_ssm"``; w8a8's profile was dropped for time); then
   a reading (it fails nothing): the Mamba-2
   target's no-cache logits on a T=128 buffer against a T=134 buffer
   sharing its first 128 tokens (``"phase": "buffer_invariance"``: bit-equal
   or not, else their max |d| and smallest top-1 margin); last, (d) the
   cached Mamba-2 engine on the same traffic (``"full_width_ssm_cached"``,
   the stateful drafter, its state cache bf16 as in JAX): SSD launches
   waves x (48 + 12), from the prefills only, an argmax a round; its
   tokens against cached AR's and the no-cache serve's are readings (a
   bf16 state is rounded once a token by AR and once a round by the spec
   serve, so the two drift apart); not profiled (time).
10a. The compile tooling (``"phase": "compile_steps"``): (a)
   ``launch.dryrun.run_one`` for every registry arch x input shape on
   meta tensors (one line a record, then the ok / skipped / failed counts;
   a failed record fails the phase); (b) the four steps of
   ``launch.steps`` on the full-width pair's own weights, each run once on
   card tensors that match its meta inputs leaf for leaf: prefill B 1 x
   2048 (last logits == ``Model.apply``'s), decode B 4 over a 2048-position
   cache after a 2047-token prefill (its token == cached AR's), the spec
   round B 4, gamma 4, 3B over 1B from prefilled caches (its first
   n_commit >= 1 tokens == greedy AR's), the train step B 2 x 512 (loss
   finite and == ``make_train_step``'s); each with its peak memory, wall
   and exact launch counts (paged L, L, gamma L_d + L_t with one argmax;
   flash L forward and L backward), which join the kernels line; then
   JAX's int8 KV caches on the same pair (``launch.steps``' ``cache_int8``
   and ``Model.apply`` over ``init_cache(dtype=int8)`` caches): the int8
   prefill (``b_prefill_int8``: logits == ``Model.apply``'s and, bit for
   bit, the bf16 prefill's, its cache the bf16 prefill's K/V quantized),
   the int8 decode step after an int8 prefill of 2047 (``b_decode_int8``:
   its token == greedy AR's over the same int8 cache; a reading: 32 tokens
   of greedy AR over int8 against bf16 rings, the agreement and top-2
   margins at each first difference), from int8 rings of 511 tokens the
   target's verify forward of gamma + 1 and its chain_tree(2, 4) span
   (``b_forward_int8``: logits bit-equal to the same forward over a bf16
   ring holding the dequantized ring), and the spec round over int8 rings
   for both roles (``b_spec_round_int8``: n_commit >= 1, both indices 511
   + n_commit, tokens in the vocabulary; agreement with the bf16 round
   and with int8 AR a reading), each with exact launches; the phase's and
   the int8 parts' seconds.
11. The hybrid family. At smoke width (``"phase":
   "smoke_hybrid_exactness"``, after the cached Mamba-2 smoke phase): the
   ``recurrentgemma-2b`` smoke pair (fp32, head_dim 64, local window 16),
   prompts of 24 and 40, 40 new tokens, no-cache and cached: tokens on the
   card == on the CPU == AR of the same mode, exact launches, partial
   accepts (the 32-slot rings wrap; the 39-token prefills take the flash
   route). At full width, after the Mamba-2 phases (``"phase":
   "full_width_hybrid"``): RecurrentGemma 2B and its registered drafter
   (bf16, full depth) on step 7's traffic through ``launch.serve``: (a) no
   cache, flash launches rounds x (4 x 2 + 8), tokens == AR's up to a
   near-tie, profiled (``"profile_hybrid"``); (b) cached
   (``"full_width_hybrid_cached"``), paged launches rounds x (5 x 2 + 8) +
   waves x 10, tokens against cached AR's and (a)'s as readings (bf16
   state caches, as for Mamba-2), profiled (``"profile_hybrid_cached"``).
12. The dense-family configs at full width (bf16, seeded random weights,
   each with its registered drafter): Granite 3.0 2B (``"phase":
   "full_width_granite"``): step 4's linear paged trace through
   ``PagedSpecServer``, the cached engine on step 7's no-cache traffic,
   and the cached engine with a 64-token sliding window on 4 prompts of
   120 + 64 new (80-slot rings: every prefill through the flash kernel,
   the rings wrapping twice), each exact against AR with exact launch
   counts and its peak memory. Then, after every earlier model is freed,
   DeepSeek-Coder 33B (``"phase": "full_width_deepseek_33b"``): the card's
   free memory against the reckoned bytes (the run raises if it lacks
   them), 4 requests (prompts 16-64, 32 new, gamma 4) through
   ``PagedSpecServer`` with exact launches and the peak memory; its tokens
   are AR's up to each request's first near-tie (the random untied head's
   top-2 gaps, ~0.1, lie within the spread of two bf16 evaluations of a
   position, which the phase measures at each first difference); Llama 3
   405B is only planned (``api.Planner``). Last, the MoE family: Mixtral
   8x7B with its registered drafter (``"phase": "full_width_moe"``) at full
   width and depth on ``quantize_for_serving`` weights made layer by layer
   (its 93.4 GB of bf16 weights exceed the card; the int8 ones take ~47
   GB), bf16 activations, no act-quant: the free memory against the
   reckoned bytes (the run raises if the card lacks them), then (a) 4
   requests (prompts 16-64, 32 new, gamma 4, block 16) through
   ``PagedSpecServer`` and (b) the cached engine on 2 prompts of 32 + 32
   (one wave), each with exact launches (paged 64 a round, 40 a
   prefill; an argmax a round) and held to AR of its mode up to each first
   difference, which a logit near-tie or a router near-tie (the two
   evaluations' expert choice or k-th probability gap, in some layer at a
   generated position up to the difference) must explain (its profiled
   serve was dropped for time); Llama 4 Maverick is only planned. Then
   the VLM and encoder-decoder families, each after
   every earlier model is freed. InternVL2-26B with ``internvl2-draft``
   (``"phase": "full_width_vlm"``; bf16, full width and depth, the vision
   front end a stub: seeded patches [2, 256, 3200] for each role; the free
   memory checked against the reckoned bytes first), B = 2, P = 32, 32
   new, gamma 4: (a) the no-cache ``SpecEngine`` with patches against
   no-cache AR; (b) the cached one (the vision prefix in each ring, t_off
   = d_off = 256, checked) against cached AR; (c) a text-only
   ``PagedSpecServer`` serve of 4 requests against AR. Whisper large-v3
   with ``whisper-draft`` (``"phase": "full_width_encdec"``; seeded frames
   [2, 1500, 1280] and [2, 1500, 768], each model encoding its own), a
   4-token decoder prompt: (a) the cached ``SpecEngine``, 32 new, against
   cached AR; (b) the no-cache one, 16 new (every forward encodes again,
   as in JAX), against no-cache AR. Every part: exact flash / paged /
   argmax launches by formula, tokens == AR's up to a first difference
   that a measured near-tie explains, wall per round, alpha-hat and peak
   memory.
13. Training (``"phase": "train"``, after every earlier model is freed):
   (a) the flash backward kernel (``csrc/flash_attention_bwd.cu``, bound
   through ``FlashAttentionFn``) against its plain version, the autograd
   of ``flash_attention_ref``, at B = 2 and the geometries training gives
   it: Llama 3.2 3B (24/8/128) at S 512 and 2048, 1B (32/8/64) at 512,
   RecurrentGemma (10/1/256) at 512 with a window of 64, Whisper's encoder
   (20/20/64, non-causal) at 1500; fp32 within 2e-4 max|ref| + 1e-6, bf16
   within 2e-2 max|ref|; two runs bit-equal; the forward's log-sum-exp
   against ``ref.flash_attention_lse_ref``; times of the forward with the
   lse, the backward, the plain backward, SDPA's backward (the library)
   and the bound. Then every attention kernel at head dims 48 and 32
   (``pair_kernel_cases``: 8/4/48 and 4/2/32, fp32 and bf16): flash
   forward at S 48 and 134, the backward at B 16, S 48, paged at Q 1 and
   5 and a 64-row prefill chunk, tree at chain_tree(2, 4), and the Q=5 /
   width-1-tree bit-equalities. (b) Llama 3.2 3B at full width and depth (bf16, tied,
   seeded init), AdamW over order-2 Markov batches of 4 x 512 (V 128,256):
   one batch's loss and gradients with and without ``remat`` (full) from
   the same params, equal losses and gradients bit-equal or within the
   bf16 tolerance (the line says which), flash launches 28 / 56 forward
   and 28 backward; 3 train steps with finite losses, 28 + 28 launches a
   step, the step time, peak memory and params that moved; a checkpoint
   save and restore round trip, bit-equal. (c) The trained-pair recipe
   of ``benchmarks/common.py`` letter for letter (target 6 layers, d 384,
   8 heads over 4 of 48; drafter 2 layers, d 128, 4 over 2, keeping the
   target's head_dim 48 as the recipe's ``replace`` does; fp32, V 256,
   tied) trained on the card through ``launch.train.train`` for 300
   steps each (order-1 data): each final loss under half its first, exact
   flash launches; then 6 Markov prompts through the no-cache
   ``SpecEngine``, the cached engine on the ring, ``PagedSpecServer`` and
   cached tree rounds (chain_tree(2, 4)), greedy: tokens == AR on each,
   every kernel's launches exact, α̂ of each path printed. (d) Mamba-2
   trains: mamba2-smoke's loss and gradients on the card against the CPU
   (within 1e-4 max|g| + 1e-6 a leaf), mamba2-780m 3 AdamW steps of 2 x
   512 at full width and depth (finite losses, params moved, no SSD
   launch under grad, 48 in a no-grad forward), s a step and peak memory.
14. Prints the run's seconds (``"phase": "end"``), the ``{"kernels":
   [...]}`` line (seven kernels, the flash backward with its train-phase
   launches; each kernel's launches are its main path's
   — the chunked serve of step 5 for paged attention and the argmax, the
   tree phase, the no-cache serves — plus the cached paths' of steps 7 and
   10 and the sampled serves', the Session phase's, the placed phase's
   and the front-end phase's of step 7, the hybrid serves of step 11
   and step 12's spec serves',
   Mixtral's, the VLM's, the encoder-decoder's and the train phase's
   (its pair's four serves and Mamba-2's no-grad forward) included; the
   paged and tree entries carry an ``int8_kv`` record: the headline int8
   case's times and bound, the int8 cases' largest error and the int8
   parts' launches, which the entry's count includes), the card line again
   and, last, ``{"ok": true, "device": {...}}``.

Every JSON line carries ``elapsed_s``, the seconds since the script
started. Nothing is caught: any failure exits non-zero before the last line. With no
CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
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
    on it). The tree entry takes head dims 32 to 128 only (no model with
    D = 256 runs tree rounds): at 256 the width-1 tree is skipped."""
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
    tree_equal = None                  # skipped: the tree entry rejects D
    if D in ta.TREE_HEAD_DIMS:
        shape = chain_tree(1, Q - 1)
        width1 = ta.tree_flash_attention(
            q, k, v, table, idx, torch.from_numpy(shape.depths).cuda(),
            torch.from_numpy(shape.bits).cuda(), max_live=live(Q))
        tree_equal = bool(torch.equal(width1, verify))
    torch.cuda.synchronize()
    q_equal = [bool(torch.equal(s[:, 0], verify[:, i])) for i, s in enumerate(steps)]
    p = pa.plan(dtype, B, Q, H, Kv, D, BS, MB)
    case = {"case": "attention_q_invariance", "geometry": name, "Q": Q,
            "B": B, "dtype": str(dtype).replace("torch.", ""),
            "chunks": p.chunks, "row_tile": p.row_tile,
            "verify_rows_equal_q1": q_equal,
            "width1_tree_equals_causal": tree_equal}
    emit(case)
    if not (all(q_equal) and tree_equal is not False):
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


def ring_view_case(timer, name, H, Kv, D, Q, start, W=RING_W):
    """Paged attention over a ring's identity view, as the cached dense
    forward launches it: bf16, B=2, a ring of W slots holding random
    stale keys everywhere, Q new K/V written at start..start+Q-1 with a
    0-dim index (``SpecEngine``'s batch_min rounds), then read through the
    view [B * W / 16, 16, Kv, D] with table[b, j] = b * W / 16 +
    j and no max_live. Held against its plain version on the same view
    and against the concat attention over ``slot_positions`` that JAX's
    ring read computes (``kv_cache.extend`` + ``models.attention.
    attention``, on copies of the ring taken before the write). Library:
    SDPA over the ring's first start+Q keys with the causal mask."""
    from repro_torch.cache import kv_cache
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention, dense
    dtype, B = torch.bfloat16, 2
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


INT8_KV_GEOMS = (("llama3.2-3b", 24, 8, 128), ("llama3.2-1b", 32, 8, 64),
                 ("bench-target", 8, 4, 48))
INT8_KV_DIMS = (("d128-h4-hd32", 4, 2, 32), ("recurrentgemma-2b", 10, 1, 256))


def int8_kv_case(timer, kind, name, H, Kv, D, dtype, Q=1, headline=False):
    """The paged and tree kernels over an int8 pool (``"case": "int8_kv"``),
    as an int8 KV cache hands it to them. ``kind``: "paged" (B 4 ragged,
    row 2 on the NULL block, a shuffled table of 16-key blocks, the live
    bound max(index) + Q as a device tensor), "chunk" (a prefill chunk of
    CHUNK rows from key CHUNK_EQUAL[0], B 1, over a 4096-key table),
    "ring" (B 2, an int8 ring of RING_W slots, Q new K/V written at 70 with
    a 0-dim index, then read through the identity view with
    ``dense.ring_fresh``'s K/V: the call's own at Q > 1) or "tree"
    (chain_tree(TREE_W, TREE_D) over the pool with the span's K/V as
    ``fresh``, B 4 ragged on distinct blocks). Each is held against its
    plain version (and a ring read against JAX's concat read over
    ``slot_positions``) within TOL, and must equal, bit for bit, the float
    kernel of q's dtype over ``_from_buf`` of the pool with ``fresh``
    written at its positions; at "paged" Q > 1 its rows must also equal Q
    = 1 calls at the same positions and, where the tree entry takes D, a
    width-1 tree the causal call. Timed: the int8 call, that float call
    (``float_kernel_ms``), the plain version and masked SDPA over the
    dequantized, gathered, head-expanded K/V (the dequant outside the
    timing). The bound counts K/V at 1 byte an element."""
    from repro_torch.cache import kv_cache
    from repro_torch.core.tree import chain_tree
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.models import attention, dense
    from repro_torch.models.attention import _tree_mask
    g = torch.Generator(device="cuda").manual_seed(H * 7919 + D * 31 + Q)
    BS = 16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def deq(t):
        return kv_cache._from_buf(t, dtype)

    def table_of(B, MB, NB):
        perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
        return perm[:B * MB].reshape(B, MB).to(torch.int32)

    fresh, depths, bits, vs_concat, extra = None, None, None, None, {}
    if kind in ("paged", "chunk", "tree"):
        if kind == "chunk":
            index, MB, NB, Q = [CHUNK_EQUAL[0]], 256, 512, CHUNK
        else:
            index, MB, NB = [37, 150, 11, 200], 16, 256
        if kind == "tree":
            shape = chain_tree(TREE_W, TREE_D)
            Q = shape.span
            depths = torch.from_numpy(shape.depths).cuda()
            bits = torch.from_numpy(shape.bits).cuda()
        B = len(index)
        q = rnd(B, Q, H, D)
        k, v = i8(NB, BS, Kv, D), i8(NB, BS, Kv, D)
        table = table_of(B, MB, NB)
        if kind == "paged":
            table[2] = 0                   # a frozen slot on the NULL block
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        fk, fv = deq(k), deq(v)
        if kind == "tree":
            fresh = (rnd(B, Q, Kv, D), rnd(B, Q, Kv, D))
            pos = idx[:, None].long() + torch.arange(Q, device="cuda")   # [B, Q]
            blk = table.long().gather(1, pos // BS)
            fk[blk, pos % BS], fv[blk, pos % BS] = fresh
        live = [i + Q for i in index]
        S = max(live)
        cols = torch.arange(S, device="cuda")
        gather = table.long()[:, cols // BS], cols % BS                  # [B, S]
        kg, vg = fk[gather], fv[gather]                                  # [B, S, Kv, D]
        q_pos = idx[:, None] + torch.arange(Q, device="cuda")           # [B, Q]
        if kind == "tree":
            mask = _tree_mask(idx, cols.to(torch.int32), depths, bits, None)
        else:
            mask = q_pos[:, :, None] >= cols[None, None, :]              # [B, Q, S]
        max_live = None if kind == "chunk" else (idx.max() + Q).to(torch.int32)
        pool_keys = sum(live) - (B * Q if fresh is not None else 0)
    else:                                  # ring: the identity view at 70
        B, W, start = 2, RING_W, 70
        ring = {n: i8(B, W, Kv, D) for n in "kv"}
        k_new, v_new, q = rnd(B, Q, Kv, D), rnd(B, Q, Kv, D), rnd(B, Q, H, D)
        idx = torch.tensor(start, dtype=torch.int32, device="cuda")
        k_all, v_all, kv_pos, _ = kv_cache.extend(
            {n: t.clone() for n, t in ring.items()}, k_new, v_new, idx)
        q_pos = idx + torch.arange(Q, dtype=torch.int32, device="cuda")
        concat = attention.attention(q, k_all, v_all, q_pos, kv_pos)
        kv_cache.write(ring["k"], ring["v"], k_new, v_new, idx)
        fresh = dense.ring_fresh(ring, k_new, v_new)
        fk, fv = deq(ring["k"]), deq(ring["v"])
        if fresh is not None:
            kv_cache.write(fk, fv, k_new, v_new, idx)
        table = dense.ring_view_table(B, W, q.device)
        k, v = dense.ring_view(ring["k"]), dense.ring_view(ring["v"])
        fk, fv = dense.ring_view(fk), dense.ring_view(fv)
        S, max_live = start + Q, None
        kg = fk.reshape(B, W, Kv, D)[:, :S]
        vg = fv.reshape(B, W, Kv, D)[:, :S]
        cols = torch.arange(S, device="cuda")
        mask = (q_pos[:, None] >= cols[None, :])[None].expand(B, Q, S)
        pool_keys = B * S - (B * Q if fresh is not None else 0)

    if kind == "tree":
        fn, plain = ta.tree_flash_attention, ta.plain
        args = (q, k, v, table, idx, depths, bits)
        fargs = (q, fk, fv, table, idx, depths, bits)
    else:
        fn, plain = pa.paged_flash_attention, pa.plain
        args, fargs = (q, k, v, table, idx), (q, fk, fv, table, idx)
    kw = dict(max_live=max_live, fresh=fresh)
    out = fn(*args, **kw)
    ref = plain(*args, **kw)
    same = fn(*fargs, max_live=max_live)
    if kind == "paged" and Q > 1:
        steps = [pa.paged_flash_attention(q[:, i:i + 1].contiguous(), k, v, table,
                                          idx + i, max_live=(idx.max() + i + 1).to(torch.int32))
                 for i in range(Q)]
        extra["verify_rows_equal_q1"] = [bool(torch.equal(s[:, 0], out[:, i]))
                                         for i, s in enumerate(steps)]
        if D in ta.TREE_HEAD_DIMS:
            w1 = chain_tree(1, Q - 1)
            width1 = ta.tree_flash_attention(
                q, k, v, table, idx, torch.from_numpy(w1.depths).cuda(),
                torch.from_numpy(w1.bits).cuda(), max_live=max_live)
            extra["width1_tree_equals_causal"] = bool(torch.equal(width1, out))
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)
    exact = bool(torch.equal(out, same))
    if kind == "ring":
        vs_concat = agreement(out, concat, dtype)

    qg = q.permute(0, 2, 1, 3)
    kg = kg.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = vg.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: fn(*args, **kw))
    float_ms = timer(lambda: fn(*fargs, max_live=max_live))
    plain_ms = timer(lambda: plain(*args, **kw), iters=3)
    library_ms = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask[:, None]))

    # least work: each live pool key read once per kv-head at 1 byte an
    # element (the fresh ones from ``fresh`` in q's dtype instead), q read
    # and out written once, the table and index; 4 flops per (query head,
    # visible key, d)
    esz = q.element_size()
    nbytes = (2 * q.numel() * esz + pool_keys * Kv * D * 2
              + (2 * fresh[0].numel() * esz if fresh is not None else 0)
              + table.numel() * 4 + idx.numel() * 4)
    flops = 4 * H * D * int(mask.sum())
    p = pa.plan(dtype, B, Q, H, Kv, D, BS, table.shape[1])
    case = {"case": "int8_kv", "kind": kind, "geometry": name, "Q": Q, "B": B,
            "dtype": str(dtype).replace("torch.", ""), "fresh": fresh is not None,
            **agree, "equal_to_float_kernel": exact, **extra,
            "kernel_ms": ms, "float_kernel_ms": float_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, flops, dtype),
            "chunks": p.chunks, "row_tile": p.row_tile, "headline": headline}
    if vs_concat is not None:
        case["vs_concat"] = vs_concat
    emit(case)
    inv = all(extra.get("verify_rows_equal_q1", [True])) \
        and extra.get("width1_tree_equals_causal") is not False
    if not (agree["ok"] and exact and inv
            and (vs_concat is None or vs_concat["ok"])):
        raise SystemExit(f"int8-pool attention disagrees: {case}")
    return case


def int8_kv_cases(timer):
    """``int8_kv_case`` at the paper pair's and the bench pair's
    geometries (INT8_KV_GEOMS), fp32 and bf16: paged Q 1 and GAMMA + 1, the
    prefill chunk, the ring view at Q 1 and GAMMA + 1, the tree; then at
    the remaining head dims (INT8_KV_DIMS) paged Q GAMMA + 1 and, at 32,
    the tree. Returns the cases by kernel."""
    out = {"paged": [], "tree": []}
    for geom, H, Kv, D in INT8_KV_GEOMS:
        for dtype in (torch.float32, torch.bfloat16):
            head = geom == "llama3.2-1b" and dtype == torch.bfloat16
            for kind, Q in (("paged", 1), ("paged", GAMMA + 1), ("chunk", CHUNK),
                            ("ring", 1), ("ring", GAMMA + 1)):
                out["paged"].append(int8_kv_case(
                    timer, kind, geom, H, Kv, D, dtype, Q,
                    headline=head and kind == "paged" and Q == 1))
            out["tree"].append(int8_kv_case(
                timer, "tree", geom, H, Kv, D, dtype,
                headline=geom == "llama3.2-3b" and dtype == torch.bfloat16))
    for geom, H, Kv, D in INT8_KV_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            out["paged"].append(int8_kv_case(timer, "paged", geom, H, Kv, D,
                                             dtype, GAMMA + 1))
            if D == 32:
                out["tree"].append(int8_kv_case(timer, "tree", geom, H, Kv,
                                                D, dtype))
    return out


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
                        headline=False, geom=("llama3.2-3b", 24, 8, 128)):
    """Tree attention at a head geometry ``geom`` (name, H, Kv, D; the
    Llama-3.2-3B one by default): B=4 ragged rows (row 2 on the NULL
    block), block size 16, the verify round's live bound max(index) + span
    as a device tensor."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.models.attention import _tree_mask
    (geometry, H, Kv, D), BS, MB, NB = geom, 16, 16, 256
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
    case = {"case": "tree_attention", "tree": name, "geometry": geometry,
            "span": span, "B": B,
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
               causal=True, s_valid=None, headline=False, Sq=None):
    """No-cache flash attention at [B, Sq] queries (default Sq = S) over
    [B, S] keys (positions from 0 on both sides; Sq != S is the
    encoder-decoder's non-causal cross-attention), against its plain
    version."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import flash_attention as fa
    Sq = S if Sq is None else Sq
    g = torch.Generator(device="cuda").manual_seed(H * 10000 + S + 7 * Sq)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
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
    qpos = torch.arange(Sq, device="cuda")
    n_valid = S if s_valid is None else s_valid
    mask = (pos[None, :] < n_valid).expand(Sq, S)
    if causal:
        mask = mask & (qpos[:, None] >= pos[None, :])
    if window is not None:
        mask = mask & ((qpos[:, None] - pos[None, :]).abs() < window)
    qg = q.permute(0, 2, 1, 3)
    kg = k.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = v.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain_causal = causal and window is None and n_valid == S and Sq == S
    if plain_causal:
        def library():
            return sdpa(qg, kg, vg, is_causal=True)
    else:
        def library():
            return sdpa(qg, kg, vg, attn_mask=mask)

    ms = timer(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = timer(lambda: fa.plain(q, k, v, **kw), iters=5)
    library_ms = timer(library)
    row_tile = fa.plan(dtype, B, Sq, H, Kv, D, window,
                       sms=sm_count(q.device)).row_tile

    # least work: q read and out written once, the s_valid keys and values
    # read once per kv-head; 4 flops per (query head, visible pair, d)
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + 2 * B * n_valid * Kv * D * esz
    flops = 4 * B * H * D * int(mask.sum())
    case = {"case": "flash_attention", "geometry": name, "B": B, "S": S,
            "Sq": Sq, "window": window, "causal": causal, "s_valid": s_valid,
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
    reqs = linear_trace(cfg)
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
        # the first 4 requests (one batch): the profiler's readings are
        # per round
        srv, _ = serve(mt, md, pt, pd, reqs[:4], scfg, GAMMA, "cuda")
        return srv.total_rounds, srv.n_prefills
    profile("profile", run, pt, pd, card)
    return launches, {"reqs": reqs, "tokens": done, "ar": out_ar,
                      "ms_per_round": wall / rounds * 1e3}


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


def first_differences(mt, pt, spec, other, P):
    """Each request whose new tokens in ``spec`` part from ``other``'s: its
    first differing position, with the target's no-cache top-2 margin on
    the shared context there; ``explained`` when the margin is within one
    bf16 step of the top logit (a near-tie that two computations' last bits
    may break either way)."""
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
    prefills, and a margin within one bf16 step. Last, the chunked serve's
    first 2 requests run once more under ``torch.profiler``, each chunk
    program and each round its own region."""
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
        # the first 2 requests: the readings are per chunk and per round
        for i, (prompt, new) in enumerate(reqs[:2]):
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
                            w8a8=False, batches=6):
    """The no-cache engine on the smoke pair of ``arch`` (the drafter is the
    target's first L-1 layers, embedding std d**-0.5; weights drawn on the
    CPU and copied to the card), gamma 4, ``batches`` prompt batches of B=2
    (six; three for w8a8, whose CPU runs are the slowest): linear
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
               for seed in range(batches)]
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
                  quant=contextlib.nullcontext, extra=None, near_ties=False):
    """The paper's no-cache mode at full width through ``launch.serve``: 4
    requests of 64 prompt + 64 new tokens, two waves of 2, gamma 4, every
    forward under ``quant()``. Every kernel's launch count is set to 0 just
    before each serve and read just after: ``per_pass`` maps a kernel to its
    launches in one (target, drafter) forward; every spec round runs GAMMA
    drafter passes, one target pass and one argmax launch, each AR step one
    target pass, and no other kernel launches. The tokens must equal
    no-cache AR's; with ``near_ties`` a request may part from AR where
    ``first_differences`` explains it by a near-tie. Then the spec serve's
    first wave runs once more under ``torch.profiler`` (as
    ``profile_phase``; None profiles nothing)."""
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
    diffs = ([] if same_ar or not near_ties
             else first_differences(mt, pt, spec, ar, NOCACHE_PROMPT))
    info = {"phase": phase, "target": mt.cfg.name,
            "drafter": md.cfg.name, "dtype": mt.cfg.dtype, "card": card,
            **(extra or {}),
            "requests": R, "batch": batch, "waves": s["waves"],
            "prompt_len": NOCACHE_PROMPT, "new_tokens": NOCACHE_NEW,
            "buffer_len": NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2,
            "gamma": GAMMA, "rounds": rounds,
            "mean_accepted_per_round": s["accepted"] / rounds,
            "alpha_hat": s["alpha_hat"],
            "wall_s": s["seconds"], "ms_per_round": s["seconds"] / rounds * 1e3,
            "tokens_per_s": s["tokens_per_s"],
            "peak_memory_gib": s["peak_memory_gib"],
            "ar_steps": steps, "ar_wall_s": s_ar["seconds"],
            "ar_ms_per_step": s_ar["seconds"] / steps * 1e3,
            "ar_tokens_per_s": s_ar["tokens_per_s"],
            "ar_peak_memory_gib": s_ar["peak_memory_gib"],
            "launches": s["launches"], "expected_launches": expect,
            "ar_launches": s_ar["launches"], "expected_ar_launches": expect_ar,
            "spec_equals_ar": same_ar, "in_vocab": in_vocab,
            **({"differences_from_ar": diffs} if near_ties else {})}
    emit(info)
    if s["launches"] != expect or s_ar["launches"] != expect_ar:
        raise SystemExit(f"no-cache kernel launches differ from the path's: {info}")
    agree = same_ar or (near_ties and all(d["explained"] for d in diffs))
    if not (agree and in_vocab):
        raise SystemExit(f"full-width no-cache tokens differ from AR: {info}")

    def run():
        # one wave of the traffic: the profiler's readings are per round
        with quant():
            _, st = serve_cli.serve(mt, md, pt, pd, prompts[:batch],
                                    NOCACHE_NEW, gamma=GAMMA, batch=batch)
        return st["rounds"], 0
    prof = profile(profile_phase, run, pt, pd, card) if profile_phase else None
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
    cached Mamba-2 path exactly at fp32. Then the spec serve's first wave
    once more under ``torch.profiler`` (as ``profile_phase``, with the
    cache-saving line; None profiles nothing)."""
    from repro_torch.core.engine import STATEFUL_FAMILIES
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
    d_passes = GAMMA + 1 if md.cfg.family in STATEFUL_FAMILIES else GAMMA

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
        return first_differences(mt, pt, spec, other, P)
    nc = nocache["tokens"]
    equal = spec[:, P:] == nc[:, P:]
    equal_ar = spec[:, P:] == ar[:, P:]
    info = {"phase": phase, "target": mt.cfg.name, "drafter": md.cfg.name,
            "dtype": mt.cfg.dtype, "card": card, "requests": len(prompts),
            "batch": batch, "waves": waves, "prompt_len": P,
            "new_tokens": NOCACHE_NEW, "gamma": GAMMA, "rounds": rounds,
            "mean_accepted_per_round": s["accepted"] / rounds,
            "alpha_hat": s["alpha_hat"],
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
            "reading: a bf16 state cache is rounded once a token by AR and once "
            "a round by speculation (JAX's cached Mamba-2 parts from its own "
            "cached AR too)",
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
        # one wave of the traffic: the profiler's readings are per round
        _, st = serve_cli.serve(mt, md, pt, pd, prompts[:batch], NOCACHE_NEW,
                                gamma=GAMMA, batch=batch, use_cache=True)
        return st["rounds"], st["waves"]
    prof = None
    if profile_phase:
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
    at least 0.9. Each engine's line sets the sampled serve's readings
    (alpha_hat, rounds, wall ms per round, peak memory, new tokens equal to
    the greedy serve's) beside the greedy serve's of this call (``nocache``,
    ``cached``, with their profiles' device readings). The sampled serves
    are not profiled: they run the greedy serves' kernels plus the draws
    (their last profiles, PERF.md §5: 1.088 s busy / 76.2% idle no-cache
    and 0.565 s / 90.1% cached against the greedy 1.070–1.086 s and
    0.540–0.548 s), and the two profiles took ~48 s of the script on its
    slowest host. Returns the
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

    def side(info, prof=None):
        out = {"rounds": info["rounds"],
               "mean_accepted_per_round": info["mean_accepted_per_round"],
               "wall_ms_per_round": info["ms_per_round"],
               "tokens_per_s": info["tokens_per_s"],
               "peak_memory_gib": info["peak_memory_gib"]}
        if prof is not None:
            busy = prof["device_busy_s"]
            out.update(device_busy_ms_per_round=None if busy is None
                       else busy / prof["rounds"] * 1e3,
                       device_idle_share=prof["device_idle_share"],
                       kernel_launches_per_round=prof["kernel_launches_per_round"])
        return out

    launches = dict(none)
    for use_cache, greedy in ((False, nocache), (True, cached)):
        engine = "cached" if use_cache else "nocache"
        a, sa = counted(use_cache, md, pd)
        b, sb = counted(use_cache, md, pd)
        rounds = sa["rounds"]
        want = expected(use_cache, sa, L_d)
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
        info["sampled"] = side(info)
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


CORRUPT_POOL_BLOCKS = 30  # (e)'s corrupt run: 29 blocks of 16 hold two
                          # rows of the trace, so the pool cycles
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
    a ``FaultPlan(corrupt_rounds={1, 2})`` serve on (d)'s geometry with a
    pool of CORRUPT_POOL_BLOCKS fails the poisoned requests with the
    corrupt-token reason, and its survivors, some of them in the failed
    rows' freed blocks, keep the clean tokens; then the paged wrapper is made to raise
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

    def paged(scfg, faults=None, placement=shared, reqs=reqs, hook=None):
        srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=GAMMA,
                              placement=placement, faults=faults, device="cuda")
        if hook is not None:
            hook(srv)
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
    # the corrupt run on a pool small enough that the requests admitted
    # after a failure take the failed row's freed blocks (zeroed first)
    corrupt = FaultPlan(corrupt_rounds=frozenset({1, 2}))
    reuse = {"failed_blocks": set(), "survivor_blocks": 0}

    def spy(srv):
        fail_row, release = srv._fail_row, srv.sched.release

        def failing_row(b, req, cur):
            alloc = srv.alloc
            reuse["failed_blocks"].update(
                int(x) for x in alloc.table[b, :int(alloc.n_alloc[b])])
            fail_row(b, req, cur)

        def released(b, req):
            alloc = srv.alloc
            held = {int(x) for x in alloc.table[b, :int(alloc.n_alloc[b])]}
            reuse["survivor_blocks"] += len(held & reuse["failed_blocks"])
            release(b, req)
        srv._fail_row, srv.sched.release = failing_row, released
    small = dataclasses.replace(scfg, num_blocks=CORRUPT_POOL_BLOCKS)
    (srv, got), wall, launches = counted(lambda: paged(small, corrupt, hook=spy))
    expect = path_launches(srv, counters, L_t, L_d)
    failed = [[r.rid, r.failed] for r in srv.metrics.failed]
    census = audited(srv)
    survivors = [i for i in range(len(reqs)) if i not in {f[0] for f in failed}]
    s = srv.metrics.summary()
    check({"phase": "full_width_placed", "part": "e_corrupt", "card": card,
           "num_blocks": small.num_blocks, "failed": failed,
           "completed": s["requests_completed"], "rounds": srv.total_rounds,
           "failed_blocks": len(reuse["failed_blocks"]),
           "failed_blocks_reused_by_survivors": reuse["survivor_blocks"],
           "launches": launches, "expected_launches": expect, "census": census,
           "survivors_equal_clean": equal(got, linear["tokens"], survivors)},
          failed and all("corrupt token id" in why for _, why in failed)
          and s["requests_completed"] + len(failed) == len(reqs)
          and reuse["survivor_blocks"] > 0
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


TP_PLAN = (("d2", ("dx",), (2,)), ("t4", ("tx",), (4,)))   # drafter, target
TP_GEOMS = (("llama3.2-3b/t4", 6, 2, 128), ("llama3.2-1b/d2", 16, 4, 64))
TP_LAYERS = 4      # (c): the fp32 3B cut to 4 layers (full width)
TP_TOL = 1e-4      # (c): max |sharded - unsharded| <= TP_TOL * max |logits|


def tp_kernel_cases(timer):
    """The kernels at the per-shard head counts TP_PLAN gives the pair
    (TP_GEOMS), each against its plain version with its time, bound and
    library time: paged attention at Q 1 and GAMMA + 1 and tree attention
    at chain_tree(TREE_W, TREE_D), fp32 and bf16; the ring view at
    RING_CASES; flash attention at the no-cache length; then the
    Q-invariance check. Returns the cases by kernel."""
    from repro_torch.core.tree import chain_tree
    T = NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2
    out = {"paged": [], "tree": [], "flash": []}
    for name, H, Kv, D in TP_GEOMS:
        for dtype in (torch.float32, torch.bfloat16):
            out["paged"] += [attention_case(timer, name, H, Kv, D, Q, dtype)
                             for Q in (1, GAMMA + 1)]
            out["tree"].append(tree_attention_case(
                timer, "chain_tree(2,4)", chain_tree(TREE_W, TREE_D), dtype,
                geom=(name, H, Kv, D)))
            out["flash"].append(flash_case(timer, name, H, Kv, D, T, dtype))
            q_invariance(name, H, Kv, D, dtype)
        out["paged"] += [ring_view_case(timer, name, H, Kv, D, Q, start)
                         for Q, start in RING_CASES]
    return out


def full_width_tensor_parallel(mt, md, pt, pd, cfg, card, linear, cached):
    """Tensor parallelism of both roles at full width (bf16; ``"phase":
    "full_width_tensor_parallel"``), on one card: the module docstring's
    parts (a)-(d). Every kernel's count is set to 0 just before each
    counted run and read just after. Returns the launches of (a)'s and
    (b)'s speculative runs."""
    import dataclasses

    from repro_torch.api import PlacementPlan, Session, SubmeshSpec, lower
    from repro_torch.core.engine import autoregressive_generate
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import build_model
    from repro_torch.parallel import tp
    from repro_torch.serving import (PagedSpecServer, RoundWatchdog,
                                     SchedulerConfig, ServeRequest)
    t_phase = time.perf_counter()
    plan = PlacementPlan(drafter=SubmeshSpec(*TP_PLAN[0]),
                         target=SubmeshSpec(*TP_PLAN[1]))
    pm = lower(plan, [torch.device("cuda", 0)] * 6)
    lay_t, lay_d = pm.target.layout(mt), pm.drafter.layout(md)
    spt, spd = pm.target.put_params(mt, pt), pm.drafter.put_params(md, pd)
    L_t, L_d = len(pt["layers"]), len(pd["layers"])
    n_t, n_d = lay_t.n, lay_d.n
    counters = kernel_counters()
    total = {name: 0 for name in counters}
    torch.cuda.synchronize()

    def counted(fn, add=True):
        zero_counts(counters)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = read_counts(counters)
        if add:
            for n, v in launches.items():
                total[n] += v
        return out, time.perf_counter() - t0, launches

    def check(info, ok):
        emit(info)
        if not ok:
            raise SystemExit(f"full-width tensor-parallel part failed: {info}")
    emit({"phase": "full_width_tensor_parallel", "part": "layout", "card": card,
          "placement": pm.describe(), "target": lay_t.describe(),
          "drafter": lay_d.describe(),
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})

    # (a) the placed paged server on the linear trace, block 16
    reqs = linear["reqs"]
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=256,
                           max_blocks_per_row=16)

    def paged(gamma, scfg):
        srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=gamma, placement=pm,
                              device="cuda",
                              watchdog=RoundWatchdog(slow_factor=float("inf")))
        for i, (prompt, new) in enumerate(reqs):
            srv.submit(ServeRequest(i, prompt, new))
        return srv, {r.rid: r.tokens for r in srv.run()}
    (srv, got), wall, launches = counted(lambda: paged(GAMMA, scfg))
    expect = path_launches(srv, counters, L_t * n_t, L_d * n_d)
    # the AR serve takes every request in one batch (fewer rounds; a row's
    # greedy tokens do not depend on its neighbours)
    (ar_srv, ar), ar_wall, ar_launches = counted(
        lambda: paged(0, dataclasses.replace(scfg, max_batch=len(reqs))),
        add=False)
    ar_expect = path_launches(ar_srv, counters, L_t * n_t, L_d * n_d)
    V = cfg.vocab_size
    complete = (sorted(got) == list(range(len(reqs))) and all(
        len(got[i]) == len(p) + new and ((got[i] >= 0) & (got[i] < V)).all()
        for i, (p, new) in enumerate(reqs)))
    spec_ar = complete and all(np.array_equal(got[i], ar[i]) for i in got)
    want = linear["tokens"]
    same = complete and all(np.array_equal(got[i], want[i]) for i in got)
    ties = [] if same or not complete else near_ties(
        mt, (pt, spt), [got[i] for i in range(len(reqs))],
        [want[i] for i in range(len(reqs))], reqs)
    ms_a = wall / srv.total_rounds * 1e3
    check({"phase": "full_width_tensor_parallel", "part": "a_paged",
           "card": card, "rounds": srv.total_rounds, "prefills": srv.n_prefills,
           "wall_s": wall, "ms_per_round": ms_a,
           "alpha_hat": srv.metrics.summary()["alpha_hat"],
           "launches": launches, "expected_launches": expect,
           "ar_rounds": ar_srv.total_rounds, "ar_wall_s": ar_wall,
           "ar_launches": ar_launches, "expected_ar_launches": ar_expect,
           "spec_equals_sharded_ar": spec_ar,
           "tokens_equal_unsharded": same, "differences_from_unsharded": ties},
          complete and spec_ar and launches == expect
          and ar_launches == ar_expect and all(t["explained"] for t in ties))

    # (b) the placed cached engine through Session, one wave of 4
    prompts = nocache_prompts(cfg)
    batch, P = prompts.shape                   # one wave of every prompt
    base = serve_cli.serve_plan(batch, P, NOCACHE_NEW, gamma=GAMMA, use_cache=True)
    sess = Session(mt, md, pt, pd, dataclasses.replace(base, placement=plan),
                   max_batch=batch, placement=pm)
    (toks, st), wall_b, launches_b = counted(
        lambda: serve_cli.serve_waves(sess, prompts, NOCACHE_NEW, batch))
    rounds_b = st["rounds"]
    expect_b = {**{n: 0 for n in counters},
                "paged_attention": (rounds_b + 1) * L_t * n_t
                + (rounds_b * GAMMA + 1) * L_d * n_d,   # + the split prefill
                "blockwise_argmax": rounds_b}
    with torch.no_grad():
        ar_b = autoregressive_generate(mt, spt, prompts, NOCACHE_NEW,
                                       use_cache=True).cpu().numpy()
    toks = np.asarray(toks)[:, :P + NOCACHE_NEW]
    spec_ar_b = bool(np.array_equal(toks, ar_b))
    want_b = cached["tokens"][:, :P + NOCACHE_NEW]
    same_b = bool(np.array_equal(toks, want_b))
    ties_b = [] if same_b else near_ties(mt, (pt, spt), toks, want_b,
                                         [(p, NOCACHE_NEW) for p in prompts])
    ms_b = wall_b / rounds_b * 1e3
    check({"phase": "full_width_tensor_parallel", "part": "b_engine",
           "card": card, "placement": sess.placement.describe(),
           "engine_placed": sess.backend._engine(GAMMA).placement is pm,
           "batch": batch, "rounds": rounds_b, "wall_s": wall_b,
           "ms_per_round": ms_b, "launches": launches_b,
           "expected_launches": expect_b, "spec_equals_sharded_ar": spec_ar_b,
           "tokens_equal_unsharded": same_b,
           "differences_from_unsharded": ties_b},
          spec_ar_b and launches_b == expect_b
          and sess.backend._engine(GAMMA).placement is pm
          and all(t["explained"] for t in ties_b))

    # (c) one fp32 forward, sharded against unsharded (TF32 off in main)
    fcfg = mt.cfg.replace(dtype="float32", param_dtype="float32",
                          num_layers=TP_LAYERS, name=mt.cfg.name + "-fp32")
    fm = build_model(fcfg)
    fp = fm.init(11, "cuda")
    sfp = pm.target.put_params(fm, fp)
    x = torch.from_numpy(np.random.default_rng(12).integers(
        0, V, (2, 64)).astype(np.int64)).cuda()
    with torch.no_grad():
        whole = fm.apply(fp, x)[0]
        split = fm.apply(sfp, x)[0]
        steps = []
        for prm in (fp, sfp):
            ring = fm.init_cache(2, 64, device="cuda", layout=tp.layout_of(prm))
            _, ring, _ = fm.apply(prm, x[:, :-1], ring)
            steps.append(fm.apply(prm, x[:, -1:], ring)[0])
    scale = float(whole.abs().max())
    d_nc = float((whole - split).abs().max())
    d_step = float((steps[0] - steps[1]).abs().max())
    check({"phase": "full_width_tensor_parallel", "part": "c_fp32_forward",
           "card": card, "layers": TP_LAYERS, "tokens": list(x.shape),
           "max_abs_logit": scale, "max_abs_diff_nocache": d_nc,
           "max_abs_diff_cached_step": d_step,
           "relative": max(d_nc, d_step) / scale, "tolerance": TP_TOL},
          max(d_nc, d_step) <= TP_TOL * scale)
    del fm, fp, sfp, whole, split, steps

    # (d) wall per round, a reading
    emit({"phase": "full_width_tensor_parallel", "part": "d_wall_per_round_ms",
          "card": card, "paged_sharded": ms_a,
          "paged_unsharded": linear["ms_per_round"], "engine_sharded": ms_b,
          "engine_unsharded_two_waves": cached["info"]["ms_per_round"],
          "phase_s": time.perf_counter() - t_phase,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    return total


def full_width_frontend(mt, md, pt, pd, cfg, card):
    """The streaming front end and the continuous ring server at full width
    on the paper's pair (bf16; ``"phase": "full_width_frontend"``), every
    kernel's count set to 0 just before each run and read just after.
    (a) ``Session.serve_async`` on the linear paged geometry (batch 4,
    gamma pinned to GAMMA, block 16) replays ``poisson_trace(12, 4.0)``
    (prompts 16-120, 32-64 new) open loop; the first 4 arrivals' deadline
    is the synchronous serve's wall, the others' from its wall per round
    (base 2 rounds, slope a round per GAMMA + 1 tokens), so the early
    requests meet theirs and queued ones miss, or expire at admission and
    stream nothing. The other streams must equal ``PagedSpecServer.run`` of
    the same requests, or differ first where the synchronous run's top-2
    margin sits within one bf16 step; a prefill per admitted request; paged
    launches rounds x (L_t + GAMMA L_d) + prefills x (L_t
    + L_d), an argmax per round, all rounds speculative; at least one
    deadline met and one missed. Prints TTFT, TPOT and queue-wait p50/p95,
    goodput, queue depth mean/max, aggregate tok/s and wall per round
    beside the synchronous serve's. (b) Batch 1: a stream dropped after 2
    tokens; the queued request is admitted into the freed row and its
    tokens are (a)'s; the census balanced. (c) ``max_stream_queue=1`` and a
    consumer sleeping 5 ms a token: (a)'s tokens. (d) ``Session`` on the
    uniform ring-continuous plan (6 prompts of 64 + 64, batch 4, gamma
    GAMMA: two slots refilled): tokens == ``BatchedSpecEngine.generate``'s
    and cached AR's on the same prompts; paged launches rounds x (L_t +
    GAMMA L_d) + prefills x (L_t + L_d) (the bootstrap and each refill a
    prefill of both models), an argmax per round; wall per round. (e) (d)
    placed ``1x1``: the same tokens and launch identity. (f) ``python -m
    repro_torch.launch.serve_async --arch llama3.2-1b --smoke --quiet`` on
    the card: rc 0. Returns the phase's launches."""
    import asyncio
    import dataclasses

    from repro_torch.api import DeploymentSpec, Planner, Session
    from repro_torch.core.batched_engine import (BatchedEngineConfig,
                                                 BatchedSpecEngine)
    from repro_torch.core.engine import autoregressive_generate
    from repro_torch.launch.cli_args import apply_placement_arg
    from repro_torch.serving import PagedSpecServer, SchedulerConfig
    from repro_torch.serving.frontend import (AsyncSpecServer, poisson_trace,
                                              replay)
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

    def check(info, ok):
        emit(info)
        if not ok:
            raise SystemExit(f"full-width front-end part failed: {info}")

    def expected(rounds, prefills, spec_rounds):
        return {**none, "paged_attention": rounds * (L_t + GAMMA * L_d)
                + prefills * (L_t + L_d), "blockwise_argmax": spec_rounds}

    def pct(xs, q):
        xs = [x for x in xs if x is not None]
        return float(np.percentile(xs, q)) if xs else None

    def explained(got, want, P):
        """None when the streamed tokens ``got`` equal ``want[P:]`` (``want``:
        a synchronous run's prompt + new tokens); else the position where
        they first differ, with the top-2 margin of the synchronous
        context's logits there (no-cache forward) and whether the
        difference is the deliberate kind: a near-tie within one bf16
        step, the stream complete."""
        n = len(want) - P
        diff = np.flatnonzero(got[:n] != want[P:P + len(got)])
        if len(got) == n and not len(diff):
            return None
        pos = P + (int(diff[0]) if len(diff) else min(len(got), n))
        ctx = torch.from_numpy(want[None, :pos].astype(np.int64)).cuda()
        with torch.no_grad():
            margin = top2_margin(mt.apply(pt, ctx)[0][0, -1])
        return {"position": pos, "streamed": len(got), "margin": margin,
                "deliberate": bool(len(diff)) and len(got) == n
                and margin["margin"] <= margin["bf16_step"]}

    # (a) the open-loop replay beside the synchronous serve
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=256,
                           max_blocks_per_row=16)
    shape = dict(prompt_lens=(16, 120), max_news=(32, 64))
    trace = poisson_trace(12, 4.0, cfg.vocab_size, seed=0, **shape)
    reqs = [(t.prompt, t.max_new) for t in trace]
    (sync, want), sync_wall, sync_launches = counted(
        lambda: serve(mt, md, pt, pd, reqs, scfg, GAMMA, "cuda"))
    sync_round_s = sync_wall / sync.total_rounds
    slo = dict(slo_base_s=2 * sync_round_s,
               slo_per_token_s=sync_round_s / (GAMMA + 1))
    trace = poisson_trace(12, 4.0, cfg.vocab_size, seed=0, **shape, **slo)
    # the first max_batch arrivals find a free row: their deadline is the
    # whole synchronous serve's wall, which one request alone meets even on
    # a slowed host; the later ones keep the tight SLO, and those that queue
    # miss it (or expire at admission, deadline already past)
    early = sorted(trace, key=lambda t: t.arrival_s)[:scfg.max_batch]
    early = {t.rid for t in early}
    trace = [dataclasses.replace(t, deadline_s=sync_wall) if t.rid in early
             else t for t in trace]
    spec = DeploymentSpec(batch_size=4, prompt_lens=tuple(len(p) for p, _ in reqs),
                          max_new=tuple(n for _, n in reqs), streaming=True,
                          adaptive_gamma=False)
    plan = Planner(spec).plan()
    plan = dataclasses.replace(
        plan, batching="continuous",
        cache=dataclasses.replace(plan.cache, kind="paged", block_size=16,
                                  num_blocks=256, max_blocks_per_row=16),
        gamma=dataclasses.replace(plan.gamma, gamma=GAMMA, adaptive=False,
                                  candidates=()))
    sess = Session(mt, md, pt, pd, plan, max_batch=4)

    async def open_loop():
        async with sess.serve_async() as front:
            return await asyncio.wait_for(replay(front, trace), timeout=300)
    records, wall, launches = counted(lambda: asyncio.run(open_loop()))
    srv = sess.backend.server
    s = srv.metrics.summary()
    # a request whose deadline passed while it queued is expired at
    # admission (EDF admission control): it streams nothing and is no
    # difference of tokens; every other stream is held to the sync run's
    expired = sorted(rec.rid for rec in srv.metrics.expired)
    diffs = {r["rid"]: explained(r["tokens"], want[r["rid"]],
                                 len(reqs[r["rid"]][0]))
             for r in records if r["rid"] not in expired}
    diffs = {rid: d for rid, d in diffs.items() if d is not None}
    met = [r["deadline_met"] for r in records]
    waits = [rec.queue_wait for rec in srv.metrics.completed]
    depths = [ev.queue_depth for ev in srv.events.events()]
    n_tok = sum(r["n_tokens"] for r in records)
    expect = expected(srv.total_rounds, srv.n_prefills, s["spec_rounds"])
    census = audited(srv)
    check({"phase": "full_width_frontend", "part": "a_open_loop", "card": card,
           "requests": len(trace), "rate_rps": 4.0, "slo": slo,
           "backend": sess.backend_name, "rounds": srv.total_rounds,
           "spec_rounds": s["spec_rounds"], "prefills": srv.n_prefills,
           "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "ms_per_round": wall / srv.total_rounds * 1e3,
           "sync_ms_per_round": sync_round_s * 1e3,
           "sync_rounds": sync.total_rounds, "sync_wall_s": sync_wall,
           "sync_tokens_per_s": sum(n for _, n in reqs) / sync_wall,
           "ttft_p50_s": pct([r["ttft_s"] for r in records], 50),
           "ttft_p95_s": pct([r["ttft_s"] for r in records], 95),
           "tpot_p50_s": pct([r["tpot_s"] for r in records], 50),
           "tpot_p95_s": pct([r["tpot_s"] for r in records], 95),
           "queue_wait_p50_s": pct(waits, 50), "queue_wait_p95_s": pct(waits, 95),
           "server_ttft_p50_s": s["p50_ttft_s"], "server_ttft_p95_s": s["p95_ttft_s"],
           "deadlines_met": sum(map(bool, met)), "goodput": s["goodput"],
           "early_rids": sorted(early), "expired": expired,
           "queue_depth_mean": float(np.mean(depths)), "queue_depth_max": max(depths),
           "launches": launches, "expected_launches": expect,
           "sync_launches": sync_launches, "census": census,
           "streams_equal_sync": not diffs, "differences": diffs},
          all(d["deliberate"] for d in diffs.values())
          and all(r["n_tokens"] == 0 for r in records if r["rid"] in expired)
          and not early & set(expired)
          and srv.n_prefills == len(trace) - len(expired)
          and len(records) == len(trace) and launches == expect
          and s["spec_rounds"] == srv.total_rounds
          and 0 < sum(map(bool, met)) < len(met))

    # (b) a stream dropped after 2 tokens frees the row for the queued one
    one = dataclasses.replace(scfg, max_batch=1)
    srv = PagedSpecServer(mt, md, pt, pd, one, gamma=GAMMA, device="cuda")
    (pa, na), (pb, nb) = reqs[0], reqs[1]

    async def drop():
        async with AsyncSpecServer(srv) as front:
            sa = await front.submit(pa, na)
            sb = await front.submit(pb, nb)
            got_a = []
            async for tok in sa:
                got_a.append(tok)
                if len(got_a) >= 2:
                    break
            await sa.aclose()
            got_b = await asyncio.wait_for(_drain(sb), timeout=120)
            return np.asarray(got_a, np.int32), np.asarray(got_b, np.int32)
    (got_a, got_b), wall, launches = counted(lambda: asyncio.run(drop()))
    m = srv.metrics.summary()
    expect = expected(srv.total_rounds, srv.n_prefills, m["spec_rounds"])
    census = audited(srv)
    diff_b = explained(got_b, want[1], len(pb))
    check({"phase": "full_width_frontend", "part": "b_drop", "card": card,
           "dropped_after": len(got_a), "cancelled": m["requests_cancelled"],
           "completed": m["requests_completed"],
           "cancelled_generated": srv.metrics.cancelled[0].n_generated,
           "rounds": srv.total_rounds, "launches": launches,
           "expected_launches": expect, "census": census,
           "dropped_prefix_equal": bool(np.array_equal(got_a, want[0][len(pa):len(pa) + 2])),
           "readmitted_equal": diff_b is None, "difference": diff_b},
          len(got_a) == 2 and np.array_equal(got_a, want[0][len(pa):len(pa) + 2])
          and (diff_b is None or diff_b["deliberate"])
          and m["requests_cancelled"] == 1 and m["requests_completed"] == 1
          and launches == expect)

    # (c) backpressure: one-slot stream queues, a slow consumer
    srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=GAMMA, device="cuda")

    async def slow():
        async with AsyncSpecServer(srv, max_stream_queue=1) as front:
            streams = [await front.submit(p, n) for p, n in reqs[2:4]]

            async def sip(stream):
                got = []
                async for tok in stream:
                    got.append(tok)
                    await asyncio.sleep(0.005)
                return np.asarray(got, np.int32)
            return await asyncio.wait_for(
                asyncio.gather(*(sip(x) for x in streams)), timeout=120)
    got, wall, launches = counted(lambda: asyncio.run(slow()))
    m = srv.metrics.summary()
    expect = expected(srv.total_rounds, srv.n_prefills, m["spec_rounds"])
    diffs = [explained(g, want[2 + i], len(reqs[2 + i][0]))
             for i, g in enumerate(got)]
    check({"phase": "full_width_frontend", "part": "c_backpressure",
           "card": card, "max_stream_queue": 1, "consumer_sleep_s": 0.005,
           "rounds": srv.total_rounds, "wall_s": wall, "launches": launches,
           "expected_launches": expect, "differences": diffs},
          all(d is None or d["deliberate"] for d in diffs) and launches == expect)

    # (d) the uniform ring-continuous plan, slots refilled; (e) placed 1x1
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (6, NOCACHE_PROMPT)).astype(np.int32)
    new = NOCACHE_NEW
    eng = BatchedSpecEngine(mt, md, BatchedEngineConfig(gamma=GAMMA))
    toks, _, _ = eng.generate(pt, pd, prompts, new)
    batched = toks.cpu().numpy()[:, :NOCACHE_PROMPT + new]
    ar = autoregressive_generate(mt, pt, prompts, new, use_cache=True).cpu().numpy()
    base = Planner(DeploymentSpec(batch_size=4, prompt_lens=(NOCACHE_PROMPT,),
                                  max_new=new, streaming=True,
                                  adaptive_gamma=False)).plan()
    base = dataclasses.replace(base, gamma=dataclasses.replace(
        base.gamma, gamma=GAMMA, adaptive=False, candidates=()))
    walls = {}
    for part, plan in (("d_continuous", base),
                       ("e_continuous_placed", apply_placement_arg(base, "1x1"))):
        sess = Session(mt, md, pt, pd, plan, max_batch=4)
        done, wall, launches = counted(lambda: sess.serve(
            [sess.request(p, new, rid=i) for i, p in enumerate(prompts)]))
        be = sess.backend
        got = np.stack([r.tokens for r in sorted(done, key=lambda r: r.rid)])
        expect = expected(be.total_rounds, be.n_prefills, be.total_rounds)
        walls[part] = wall / be.total_rounds * 1e3
        check({"phase": "full_width_frontend", "part": part, "card": card,
               "backend": sess.backend_name, "plan_cache": plan.cache.kind,
               "placement": sess.placement.describe(), "requests": len(prompts),
               "batch": 4, "rounds": be.total_rounds, "prefills": be.n_prefills,
               "wall_s": wall, "ms_per_round": walls[part],
               "tokens_per_s": len(prompts) * new / wall,
               "launches": launches, "expected_launches": expect,
               "tokens_equal_batched_engine": bool(np.array_equal(got, batched)),
               "tokens_equal_cached_ar": bool(np.array_equal(got, ar))},
              sess.backend_name == "continuous" and plan.cache.kind == "ring"
              and be.n_prefills == 1 + len(prompts) - 4
              and np.array_equal(got, batched) and np.array_equal(got, ar)
              and launches == expect
              and sess.placement.heterogeneous == (part != "d_continuous"))

    # (f) the CLI on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_async", "--arch",
         "llama3.2-1b", "--smoke", "--quiet"], capture_output=True, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300)
    check({"phase": "full_width_frontend", "part": "f_cli", "card": card,
           "rc": proc.returncode, "seconds": time.perf_counter() - t0,
           "stdout": proc.stdout.strip().splitlines()[:3],
           "stderr": proc.stderr.strip().splitlines()[-3:],
           "phase_s": time.perf_counter() - t_phase},
          proc.returncode == 0 and "replayed 8 requests" in proc.stdout)
    return total


async def _drain(stream):
    return np.asarray([t async for t in stream], np.int32)


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
    # not profiled: that time pays for full_width_tensor_parallel
    launches = nocache_phase("full_width_w8a8", None, mt, md, qt, qd,
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
    # not profiled: that time pays for full_width_tensor_parallel
    cached = cached_serve("full_width_ssm_cached", None, mt, md,
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


# ------------------------------------------------- the dense-family configs
GRANITE_GEOMS = (("granite-3-2b", 32, 8, 64), ("granite-draft", 16, 8, 64))
DEEPSEEK_GEOM = ("deepseek-coder-33b", 56, 8, 128)
MIXTRAL_GEOM = ("mixtral-8x7b", 32, 8, 128)   # its drafter's is Granite's
WRAP_WINDOW, WRAP_RING = 64, 80   # ring cases: window 64 + slack 6, rounded
WRAP_START = 200                  # ... first query position, past two wraps
GRANITE_WINDOW = 64               # the windowed cached Granite serve
GRANITE_WINDOW_PROMPT = 120       # its prompts: each prefill is longer than
                                  # the 80-slot ring


def dense_config_cases(timer):
    """Paged attention at the new configs' head geometries (Granite's
    target and drafter, DeepSeek-Coder 33B's GQA 7: 7 or 35 query rows per
    kv-head, a partial last row tile; Mixtral 8x7B's GQA 4 at D 128), Q 1
    and GAMMA + 1, fp32 and bf16, as ``attention_case`` runs the paper
    pair's."""
    return [attention_case(timer, geom, H, Kv, D, Q, dtype)
            for geom, H, Kv, D in GRANITE_GEOMS + (DEEPSEEK_GEOM, MIXTRAL_GEOM)
            for Q in (1, GAMMA + 1)
            for dtype in (torch.float32, torch.bfloat16)]


def wrap_ring_case(timer, name, H, Kv, D, Q, dtype):
    """Paged attention over a windowed ring that has wrapped, as the cached
    dense forward launches it (``"case": "ring_wrap"``): B=2, a ring of
    WRAP_RING slots holding random stale keys everywhere, a window of
    WRAP_WINDOW, Q new K/V written at WRAP_START.. with a 0-dim index, then
    read through the table over positions (table[b, j] = b * W / 16 +
    (j mod W / 16), as wide as the positions reached), the window passed to
    the kernel. Held against its plain version on the same view and
    against the concat attention over ``slot_positions`` that JAX's ring
    read computes. Library: SDPA over the ring's W slots with the mask of
    their positions (causal and window)."""
    from repro_torch.cache import kv_cache
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention, dense
    B, W, window, start = 2, WRAP_RING, WRAP_WINDOW, WRAP_START
    positions = -(-(start + Q) // 16) * 16
    g = torch.Generator(device="cuda").manual_seed(H * 613 + Q * 7 + D)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    ring = {n: rnd(B, W, Kv, D) for n in "kv"}
    k_new, v_new, q = rnd(B, Q, Kv, D), rnd(B, Q, Kv, D), rnd(B, Q, H, D)
    idx = torch.tensor(start, dtype=torch.int32, device="cuda")
    k_all, v_all, kv_pos, _ = kv_cache.extend(
        {n: t.clone() for n, t in ring.items()}, k_new, v_new, idx)
    q_pos = idx + torch.arange(Q, dtype=torch.int32, device="cuda")
    concat = attention.attention(q, k_all, v_all, q_pos, kv_pos, window=window)
    kv_cache.write(ring["k"], ring["v"], k_new, v_new, idx)
    table = dense.ring_view_table(B, W, q.device, positions)
    args = (q, dense.ring_view(ring["k"]), dense.ring_view(ring["v"]), table, idx)

    out = pa.paged_flash_attention(*args, window=window)
    ref = pa.plain(*args, window=window)
    torch.cuda.synchronize()
    agree = agreement(out, ref, dtype)
    vs_concat = agreement(out, concat, dtype)

    slot = kv_cache.slot_positions(W, idx, Q)                    # [W]
    rel = q_pos[:, None] - slot[None, :]
    mask = ((rel >= 0) & (rel < window) & (slot >= 0)[None, :])[None, None]
    kg = ring["k"].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    vg = ring["v"].permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1)
    qg = q.permute(0, 2, 1, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: pa.paged_flash_attention(*args, window=window))
    plain_ms = timer(lambda: pa.plain(*args, window=window), iters=5)
    library_ms = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask))

    # least work: the window + Q - 1 keys and values some query of a row
    # sees, read once per kv-head; q read and out written once; the table;
    # 4 flops per (query head, visible key, d)
    esz = q.element_size()
    nbytes = (2 * q.numel() * esz + B * (window + Q - 1) * Kv * D * 2 * esz
              + table.numel() * 4 + 4)
    flops = 4 * H * D * B * sum(min(window, start + i + 1) for i in range(Q))
    p = pa.plan(dtype, B, Q, H, Kv, D, 16, positions // 16)
    case = {"case": "ring_wrap", "geometry": name, "Q": Q, "B": B,
            "start": start, "ring_len": W, "window": window,
            "positions": positions, "wraps": start // W,
            "dtype": str(dtype).replace("torch.", ""), **agree,
            "vs_concat": vs_concat, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, flops, dtype),
            "chunks": p.chunks, "row_tile": p.row_tile}
    emit(case)
    if not (agree["ok"] and vs_concat["ok"]):
        raise SystemExit(f"wrapped-ring attention disagrees: {case}")
    return case


def wrap_ring_cases(timer):
    return [wrap_ring_case(timer, geom, H, Kv, D, Q, dtype)
            for geom, H, Kv, D in GRANITE_GEOMS
            for Q in (1, GAMMA + 1)
            for dtype in (torch.float32, torch.bfloat16)]


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def near_ties(mt, pt, spec, ar, reqs, extras=None):
    """For each request whose spec tokens part from AR's: at its first
    difference p, the target's logits for the shared prefix evaluated two
    ways in bf16, the no-cache pass (flash attention, the prefix's GEMM
    shapes) and a cached decode step (a ring prefilled with the prefix but
    its last token, then one paged step); ``spread``, the largest
    difference of any two evaluations over the vocabulary; and ``gap``,
    how far apart the two tokens the serves chose lie in each. The
    difference is ``explained`` when a gap is within the spread: two
    evaluations of these logits in this precision can order that pair
    either way. ``pt`` is the target's params or a tuple of records of
    them (the whole and a tensor-parallel split): each is evaluated both
    ways, a split one on a ring made split by its layout. ``extras``
    (batched by request, as the engine took them) go with each request's
    row: the ring is sized by ``cache_len`` and the step takes the
    prefill's decode extras."""
    from repro_torch.core.engine import decode_extras
    from repro_torch.parallel import tp
    records = pt if isinstance(pt, tuple) else (pt,)
    out = []
    for i, (p, _) in enumerate(reqs):
        diff = np.flatnonzero(spec[i] != ar[i])
        if not len(diff):
            continue
        pos = int(diff[0])
        ctx = torch.from_numpy(ar[i][:pos].astype(np.int64))[None].cuda()
        ex = {k: v[i:i + 1] for k, v in (extras or {}).items()}
        evals = []
        with torch.no_grad():
            for prm in records:
                evals.append(mt.apply(prm, ctx, **ex)[0][0, -1].float())
                ring = mt.init_cache(1, mt.cache_len(pos), device="cuda",
                                     layout=tp.layout_of(prm))
                _, ring, aux = mt.apply(prm, ctx[:, :-1], ring, **ex)
                evals.append(mt.apply(prm, ctx[:, -1:], ring,
                                      **(decode_extras(ex, aux) or {}))
                             [0][0, -1].float())
                del ring
        pair = [int(spec[i][pos]), int(ar[i][pos])]
        spread = max(float((a - b).abs().max()) for a in evals for b in evals)
        gaps = [abs(float(lg[pair[0]] - lg[pair[1]])) for lg in evals]
        out.append({"request": i, "position": pos, "new_token": pos - len(p),
                    "tokens": pair, "spread": spread, "gaps": gaps,
                    "nocache": top2_margin(evals[0]),
                    "explained": min(gaps) <= spread})
    return out


def paged_exact(phase, mt, md, pt, pd, reqs, scfg, card, exact=True,
                explain=near_ties):
    """``PagedSpecServer`` with gamma pinned to GAMMA on ``reqs``, every
    kernel's count set to 0 just before and read just after (paged: rounds
    x (L_t + GAMMA L_d) + prefills x (L_t + L_d), L the layers a forward
    runs, an argmax a round, nothing else); then the same requests with AR
    rounds: every request complete, in the vocabulary, == AR. With
    ``exact=False`` a request may part from AR at a near-tie that
    ``explain`` explains (``near_ties``: logits with top-2 gaps within the
    spread of two bf16 evaluations); its tokens up to there must be AR's.
    Returns (launches, info)."""
    from repro_torch.obs import clock
    counters = kernel_counters()
    L_t, L_d = len(pt["layers"]), len(pd["layers"])
    V = mt.cfg.vocab_size
    serve(mt, md, pt, pd, [(reqs[0][0][:16], 8)], scfg, GAMMA, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = clock.perf()
    srv, done = serve(mt, md, pt, pd, reqs, scfg, GAMMA, "cuda")
    torch.cuda.synchronize()
    wall = clock.perf() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rounds, prefills = srv.total_rounds, srv.n_prefills
    expect = {**{name: 0 for name in counters},
              "paged_attention": rounds * (L_t + GAMMA * L_d) + prefills * (L_t + L_d),
              "blockwise_argmax": rounds}
    s = srv.metrics.summary()
    complete = (len(done) == len(reqs) and s["requests_failed"] == 0 and all(
        len(done[i]) == len(p) + new and ((done[i] >= 0) & (done[i] < V)).all()
        and np.array_equal(done[i][:len(p)], p)
        for i, (p, new) in enumerate(reqs)))
    t0 = clock.perf()
    ar_srv, out_ar = serve(mt, md, pt, pd, reqs, scfg, 0, "cuda")
    torch.cuda.synchronize()
    ar_wall = clock.perf() - t0
    same_ar = all(np.array_equal(done[i], out_ar[i]) for i in range(len(reqs)))
    ties = [] if same_ar else explain(mt, pt, done, out_ar, reqs)
    new_equal = sum(int((done[i][len(p):] == out_ar[i][len(p):]).sum())
                    for i, (p, _) in enumerate(reqs))
    info = {"phase": phase, "part": "paged", "target": mt.cfg.name,
            "drafter": md.cfg.name, "dtype": mt.cfg.dtype, "card": card,
            "requests": len(reqs), "completed": len(done),
            "generated_tokens": s["total_generated_tokens"], "wall_s": wall,
            "tokens_per_s": s["total_generated_tokens"] / wall,
            "rounds": rounds, "ms_per_round": wall / rounds * 1e3,
            "prefills": prefills, "gamma": GAMMA, "alpha_hat": s["alpha_hat"],
            "accept_hist": s["accept_hist"][:GAMMA + 1].tolist(),
            "ar_rounds": ar_srv.total_rounds,
            "ar_ms_per_round": ar_wall / ar_srv.total_rounds * 1e3,
            "peak_memory_gib": peak, "launches": launches,
            "expected_launches": expect, "all_complete_in_vocab": bool(complete),
            "spec_equals_ar": same_ar, "exact": exact,
            "new_tokens_equal_ar": new_equal,
            "new_tokens_total": sum(new for _, new in reqs),
            "differences_from_ar": ties}
    emit(info)
    agree = same_ar or (not exact and all(t["explained"] for t in ties))
    if not (complete and agree and launches == expect):
        raise SystemExit(f"{phase}: paged serving failed: {info}")
    return launches, info


def cached_exact(phase, part, mt, md, pt, pd, prompts, max_new, card,
                 flash_prefill=False, exact=True, explain=near_ties):
    """The cached engine through ``launch.serve.serve(use_cache=True)``,
    two waves of 2, gamma GAMMA, then cached AR on the same prompts, each
    counted from 0: paged rounds x (GAMMA L_d + L_t), plus a paged prefill
    per wave and model, or with ``flash_prefill`` (a windowed ring shorter
    than the prompt) a flash prefill instead; an argmax a round; AR a
    paged step per token past each wave's first, and its prefill paged or
    flash. Tokens == cached AR's, or with ``exact=False`` AR's up to each
    row's first difference, which ``explain`` must explain, as in
    ``paged_exact``. Returns (launches, info)."""
    from repro_torch.launch import serve as serve_cli
    counters = kernel_counters()
    none = {name: 0 for name in counters}
    L_t, L_d = len(pt["layers"]), len(pd["layers"])
    batch = 2
    for gamma in (GAMMA, 0):                        # warm-up, not counted
        serve_cli.serve(mt, md, pt, pd, prompts[:batch], 4, gamma=gamma,
                        batch=batch, use_cache=True)
    torch.cuda.synchronize()

    def counted(gamma):
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        toks, st = serve_cli.serve(mt, md, pt, pd, prompts, max_new,
                                   gamma=gamma, batch=batch, use_cache=True)
        torch.cuda.synchronize()
        st["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return toks, st, read_counts(counters)
    spec, s, launches = counted(GAMMA)
    ar, s_ar, ar_launches = counted(0)
    rounds, waves, steps = s["rounds"], s["waves"], s_ar["rounds"]
    pre = "flash_attention" if flash_prefill else "paged_attention"
    expect = {**none, "paged_attention": rounds * (GAMMA * L_d + L_t),
              "blockwise_argmax": rounds}
    expect[pre] += waves * (L_t + L_d)
    expect_ar = {**none, "paged_attention": (steps - s_ar["waves"]) * L_t}
    expect_ar[pre] += s_ar["waves"] * L_t
    P = prompts.shape[1]
    ring = mt.init_cache(1, P + max_new + GAMMA + 2, spec_slack=GAMMA + 2,
                         device="cuda")
    same = bool(np.array_equal(spec, ar))
    ties = [] if same else explain(mt, pt, spec, ar,
                                   [(row[:P], max_new) for row in prompts])
    info = {"phase": phase, "part": part, "target": mt.cfg.name,
            "drafter": md.cfg.name, "card": card, "window": mt.cfg.sliding_window,
            "ring_len": ring["k"].shape[2],
            "ring_positions": ring.get("positions", ring["k"].shape[2]),
            "requests": len(prompts), "batch": batch, "waves": waves,
            "prompt_len": P, "new_tokens": max_new, "gamma": GAMMA,
            "rounds": rounds, "mean_accepted_per_round": s["accepted"] / rounds,
            "wall_s": s["seconds"], "ms_per_round": s["seconds"] / rounds * 1e3,
            "tokens_per_s": s["tokens_per_s"], "peak_memory_gib": s["peak_memory_gib"],
            "ar_steps": steps, "ar_ms_per_step": s_ar["seconds"] / steps * 1e3,
            "launches": launches, "expected_launches": expect,
            "ar_launches": ar_launches, "expected_ar_launches": expect_ar,
            "in_vocab": bool(((spec >= 0) & (spec < mt.cfg.vocab_size)).all()),
            "spec_equals_ar": same, "exact": exact,
            "new_tokens_equal_ar": int((spec[:, P:] == ar[:, P:]).sum()),
            "new_tokens_total": int(spec[:, P:].size),
            "differences_from_ar": ties}
    del ring
    emit(info)
    agree = same or (not exact and all(t["explained"] for t in ties))
    if not (agree and info["in_vocab"] and launches == expect
            and ar_launches == expect_ar):
        raise SystemExit(f"{phase} ({part}): cached serving failed: {info}")
    return launches, info


def linear_trace(cfg, n=8):
    """``full_width``'s recipe: n requests, prompts 16-120, 32-64 new."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 121))).astype(np.int32),
             int(rng.integers(32, 65))) for _ in range(n)]


def full_width_granite(card):
    """Granite 3.0 2B with its registered drafter at full width (bf16,
    seeded random weights; ``"phase": "full_width_granite"``): (a) the
    linear paged trace of step 4 (8 requests, prompts 16-120, 32-64 new,
    batch 4, gamma 4, block 16) through ``PagedSpecServer``; (b) the cached
    engine on the no-cache traffic (4 x (64 + 64), two waves of 2); (c) the
    same engine with a sliding window of GRANITE_WINDOW (the same weights)
    on 4 prompts of GRANITE_WINDOW_PROMPT tokens + 64 new: each ring holds
    80 slots, so every prefill runs the flash kernel and the rings wrap
    twice. Each exact against AR with exact launch counts. Returns the
    three spec serves' launches together."""
    from repro_torch.launch.cli_args import build_pair
    from repro_torch.models.model import build_model
    from repro_torch.serving import SchedulerConfig
    mt, md, pt, pd, cfg = build_pair("granite-3-2b", smoke=False, device="cuda")
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=256,
                           max_blocks_per_row=16)
    a, _ = paged_exact("full_width_granite", mt, md, pt, pd, linear_trace(cfg),
                       scfg, card)
    b, _ = cached_exact("full_width_granite", "cached", mt, md, pt, pd,
                        nocache_prompts(cfg), NOCACHE_NEW, card)
    mtw = build_model(cfg.replace(sliding_window=GRANITE_WINDOW))
    mdw = build_model(md.cfg.replace(sliding_window=GRANITE_WINDOW))
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, GRANITE_WINDOW_PROMPT)).astype(np.int32)
    c, info = cached_exact("full_width_granite", "windowed_cached", mtw, mdw,
                           pt, pd, prompts, 64, card, flash_prefill=True)
    if not (info["ring_len"] == WRAP_RING
            and GRANITE_WINDOW_PROMPT + 64 > 2 * info["ring_len"]):
        raise SystemExit(f"the windowed rings do not wrap twice: {info}")
    return {name: a[name] + b[name] + c[name] for name in a}


DEEPSEEK_POOL_BLOCKS = 64     # x 16 tokens x 253,952 B: 0.26 GB of target KV


def full_width_deepseek_33b(card):
    """DeepSeek-Coder 33B with its registered drafter at full width (bf16,
    seeded random weights; ``"phase": "full_width_deepseek_33b"``), after
    every earlier model is gone: ``torch.cuda.mem_get_info()`` first, and
    the run raises if the card lacks the reckoned bytes (the two models'
    bf16 weights by ``param_count``, the KV pools, the fp32 copy of the
    head the unembedding makes, 2 GiB of activations). Then 4 requests
    (prompts 16-64, 32 new, batch 4, gamma 4, block 16) through
    ``PagedSpecServer``: exact launches, the peak memory printed, and the
    tokens AR's up to each request's first near-tie. The random untied
    head gives logits of ~3.5 with top-2 gaps of ~0.1, within reach of the
    spread between two bf16 evaluations of one position (verify and AR
    run their GEMMs at other M; the attention rows are bit-equal across Q,
    ``attention_q_invariance``), so a difference must be one
    ``near_ties`` explains. Also plans Llama 3 405B (``api.Planner`` on its
    registry entry; it runs on no card here). Returns the spec serve's
    launches."""
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.launch.cli_args import build_pair
    from repro_torch.serving import SchedulerConfig
    for arch in ("llama3-405b",):
        plan = api.Planner(api.DeploymentSpec(arch=arch, batch_size=4,
                                              prompt_lens=(64,), max_new=32)).plan()
        emit({"phase": "full_width_deepseek_33b", "part": "planned_only",
              "arch": arch, "plan": json.loads(plan.to_json())})
    tgt, drf = (registry.config("deepseek-coder-33b"),
                registry.drafter_config("deepseek-coder-33b"))
    weights = 2 * (tgt.param_count() + drf.param_count())
    kv_per_token = 2 * 2 * (tgt.num_layers + drf.num_layers) * 8 * 128
    pools = DEEPSEEK_POOL_BLOCKS * 16 * kv_per_token
    head = 4 * tgt.d_model * tgt.vocab_size
    need = weights + pools + head + (2 << 30)
    free, total = torch.cuda.mem_get_info()
    info = {"phase": "full_width_deepseek_33b", "part": "memory", "card": card,
            "free_bytes": free, "total_bytes": total, "weight_bytes": weights,
            "kv_bytes_per_token": kv_per_token, "pool_bytes": pools,
            "head_fp32_bytes": head, "reckoned_bytes": need}
    emit(info)
    if free < need:
        raise SystemExit(f"the card lacks the reckoned bytes for the 33B pair: {info}")
    torch.cuda.reset_peak_memory_stats()
    mt, md, pt, pd, cfg = build_pair("deepseek-coder-33b", smoke=False,
                                     device="cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 65))).astype(np.int32),
             32) for _ in range(4)]
    scfg = SchedulerConfig(max_batch=4, block_size=16,
                           num_blocks=DEEPSEEK_POOL_BLOCKS, max_blocks_per_row=8)
    launches, info = paged_exact("full_width_deepseek_33b", mt, md, pt, pd,
                                 reqs, scfg, card, exact=False)
    serve_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "full_width_deepseek_33b", "part": "memory_after",
          "card": card, "init_max_memory_allocated_bytes": init_peak,
          "serve_max_memory_allocated_bytes": serve_peak,
          "max_memory_allocated_gib": max(init_peak, serve_peak) / 2**30,
          "memory_allocated_bytes": torch.cuda.memory_allocated(),
          "reckoned_bytes": need})
    return launches


MOE_POOL_BLOCKS = 256         # x 16 tokens x 147,456 B: 0.60 GB of KV, both roles
MOE_REQS = (4, 16, 64, 32)    # requests, prompt lengths 16..64, new tokens
MOE_CACHED = (2, 32, 32)      # the cached engine: prompts (one wave), length, new


def serving_bytes(cfg) -> int:
    """Bytes of a KV-family config's ``quantize_for_serving`` weights,
    reckoned from the config: int8 matmul weights with an fp32 scale per
    output column (per expert for stacked experts), the bf16 embedding and
    norms; the layers its blocks hold (``models.moe.n_layers``)."""
    from repro_torch.models import moe
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def mats(shapes, n=1):
        return sum(n * (k * m + 4 * m) for k, m in shapes)
    attn = mats([(d, q), (d, kv), (d, kv), (q, d)]) + 2 * 2 * d
    dense = attn + mats([(d, f), (d, f), (f, d)])
    if cfg.family == "moe":
        fs = cfg.num_shared_experts * f
        moe_layer = (attn + mats([(d, f), (d, f), (f, d)], cfg.num_experts)
                     + mats([(d, cfg.num_experts)])
                     + (mats([(d, fs), (d, fs), (fs, d)]) if fs else 0))
        m = moe.block_size(cfg)
        layers = moe.n_blocks(cfg) * (moe_layer + (m - 1) * dense)
    else:
        layers = cfg.num_layers * dense
    head = 0 if cfg.tie_embeddings else mats([(d, V)])
    return layers + 2 * V * d + 2 * d + head


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def moe_near_ties(mt, pt, spec, ar, reqs):
    """``near_ties`` for an MoE target, with its routing read on the same
    two evaluations: at every generated position up to a request's first
    difference (from the prompt's last token, the first one a round
    computes, through the position whose logits chose the differing
    token) and in every layer, each evaluation's router probabilities.
    Verify passes and AR steps run their GEMMs at other M, so a layer's
    router can pick other experts for one token in the two serves when its
    k-th and (k+1)-th probabilities lie within the spread of two
    evaluations; that token's hidden state, its KV and every later
    position's logits then differ. A router near-tie at a position is one
    where the two evaluations pick different experts, or the gap between
    the k-th and (k+1)-th probability is within the spread of the
    probabilities; a first difference is also explained by one at any of
    those positions. The routing is read by wrapping ``models.moe.route``
    for the call (the model has no hook)."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def route(cfg, p, xt):
        out = real(cfg, p, xt)
        seen.append(out[1].reshape(-1, out[1].shape[-1]).float())
        return out
    moe.route = route
    try:
        ties = near_ties(mt, pt, spec, ar, reqs)
    finally:
        moe.route = real
    L, K = len(seen) // max(3 * len(ties), 1), mt.cfg.num_experts_per_tok
    for n, t in enumerate(ties):
        calls = seen[3 * L * n:3 * L * (n + 1)]
        full = calls[:L]                                     # [pos, E] each
        cached = [torch.cat([a, b]) for a, b in zip(calls[L:2 * L], calls[2 * L:])]
        first = len(reqs[t["request"]][0]) - 1
        router = []
        for layer, (a, b) in enumerate(zip(full, cached)):
            for pos in range(first, t["position"]):
                sa, ia = a[pos].sort(descending=True, stable=True)
                sb, ib = b[pos].sort(descending=True, stable=True)
                spread = float((a[pos] - b[pos]).abs().max())
                gap = min(float(sa[K - 1] - sa[K]), float(sb[K - 1] - sb[K]))
                other = set(ia[:K].tolist()) != set(ib[:K].tolist())
                router.append({"layer": layer, "position": pos, "gap": gap,
                               "spread": spread, "other_experts": other,
                               "tie": other or gap <= spread})
        tied = [r for r in router if r["tie"]]
        t["router_ties"] = tied
        t["nearest_router"] = min(router, key=lambda r: r["gap"] - r["spread"],
                                  default=None)
        t["logit_explained"] = t["explained"]
        t["explained"] = t["explained"] or bool(tied)
    return ties


def full_width_moe(card, arch="mixtral-8x7b"):
    """Mixtral 8x7B with its registered drafter at full width and depth on
    ``quantize_for_serving`` weights made layer by layer
    (``quant.int8.init_for_serving``: each layer drawn in bf16, quantized
    and its bf16 dropped, so the 93.4 GB of bf16 weights never exist
    whole), bf16 activations, no act-quant (w8a16: the routed experts
    dequantize per layer, as JAX does); ``"phase": "full_width_moe"``.
    First ``torch.cuda.mem_get_info()`` against the reckoned bytes
    (``serving_bytes`` for both models, one layer's experts dequantized at
    once, the fp32 head an unembedding makes, the KV pool, 2 GiB of
    activations, or the init's peak: one layer's bf16 weights and three
    fp32 copies of its largest stacked weight while it is quantized); the
    run raises if the card lacks them. Then (a) MOE_REQS through
    ``PagedSpecServer`` (batch 4, gamma 4, block 16; prefills of at most
    63 tokens: dropless routing) and (b) the cached engine on rings of
    fewer than 4096 slots (the identity view; the window never wraps),
    one wave of 2 (the profiled serve between them was dropped for
    time); each with exact launches (paged 32 + 4 x 8 a round,
    40 a prefill, an argmax a round, nothing else) and held to AR of the
    same mode on the same params up to each first difference, which a
    logit near-tie or a router near-tie must explain
    (``moe_near_ties``). Also plans Llama 4 Maverick (``api.Planner``; it
    fits no single card). Returns the spec serves' launches together."""
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    from repro_torch.quant import int8 as q8
    from repro_torch.serving import SchedulerConfig
    plan = api.Planner(api.DeploymentSpec(
        arch="llama4-maverick-400b-a17b", batch_size=4, prompt_lens=(64,),
        max_new=32)).plan()
    emit({"phase": "full_width_moe", "part": "planned_only",
          "arch": "llama4-maverick-400b-a17b", "plan": json.loads(plan.to_json())})
    tgt, drf = registry.config(arch), registry.drafter_config(arch)
    weights = serving_bytes(tgt) + serving_bytes(drf)
    kv_per_token = sum(2 * 2 * c.num_layers * c.num_kv_heads * c.head_dim
                       for c in (tgt, drf))
    pools = MOE_POOL_BLOCKS * 16 * kv_per_token
    dequant = 3 * 2 * tgt.num_experts * tgt.d_model * tgt.d_ff
    head = 4 * tgt.d_model * tgt.vocab_size
    serve_need = weights + dequant + head + pools + (2 << 30)
    layer_bf16 = (serving_bytes(tgt.replace(num_layers=1, vocab_size=0))
                  - 2 * tgt.d_model)
    init_need = (serving_bytes(tgt) + 2 * layer_bf16
                 + 3 * 4 * tgt.num_experts * tgt.d_model * tgt.d_ff)
    need = max(serve_need, init_need)
    free, total = torch.cuda.mem_get_info()
    info = {"phase": "full_width_moe", "part": "memory", "card": card,
            "free_bytes": free, "total_bytes": total,
            "target_int8_bytes": serving_bytes(tgt),
            "drafter_int8_bytes": serving_bytes(drf),
            "bf16_weight_bytes": 2 * (tgt.param_count() + drf.param_count()),
            "dequant_bytes": dequant, "head_fp32_bytes": head,
            "kv_bytes_per_token": kv_per_token, "pool_bytes": pools,
            "serve_reckoned_bytes": serve_need, "init_reckoned_bytes": init_need,
            "reckoned_bytes": need}
    emit(info)
    if free < need:
        raise SystemExit(f"the card lacks the reckoned bytes for Mixtral: {info}")
    from repro_torch.obs import clock
    torch.cuda.reset_peak_memory_stats()
    t0 = clock.perf()
    mt, md = build_model(tgt), build_model(drf)
    pt, pd = q8.init_for_serving(mt, 0, "cuda"), q8.init_for_serving(md, 7, "cuda")
    torch.cuda.synchronize()
    init = {"phase": "full_width_moe", "part": "init", "card": card,
            "init_s": clock.perf() - t0,
            "target_bytes": tree_bytes(pt), "drafter_bytes": tree_bytes(pd),
            "init_max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "expert_dtype": str(pt["layers"][0]["moe"]["experts"]["gate"]["w_q"].dtype),
            "layers": [len(pt["layers"]), len(pd["layers"])]}
    emit(init)
    n, lo, hi, new = MOE_REQS
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, tgt.vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32),
             new) for _ in range(n)]
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=MOE_POOL_BLOCKS,
                           max_blocks_per_row=8)
    a, info_a = paged_exact("full_width_moe", mt, md, pt, pd, reqs, scfg, card,
                            exact=False, explain=moe_near_ties)

    n, P, new = MOE_CACHED
    prompts = np.random.default_rng(7).integers(0, tgt.vocab_size, (n, P)).astype(np.int32)
    b, info_b = cached_exact("full_width_moe", "cached", mt, md, pt, pd, prompts,
                             new, card, exact=False, explain=moe_near_ties)
    if info_b["ring_positions"] != info_b["ring_len"] or info_b["ring_len"] >= 4096:
        raise SystemExit(f"the cached Mixtral rings are not an identity view: {info_b}")
    emit({"phase": "full_width_moe", "part": "memory_after", "card": card,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "memory_allocated_bytes": torch.cuda.memory_allocated(),
          "reckoned_bytes": need})
    return {name: a[name] + b[name] for name in a}


# ------------------------------------------------------ the hybrid family
HYBRID_GEOMS = (("recurrentgemma-2b", 10, 1, 256),     # MQA: 10 rows a kv-head
                ("recurrentgemma-draft", 4, 1, 256))
HYBRID_WINDOW = (1100, 64)        # flash case with a window that binds: S, window


def argmax_wide_case(timer, geometry="recurrentgemma-2b", V=256000, seed=8):
    """The argmax kernel at a verify shape: 2 rows x (GAMMA + 1) positions
    over a model's vocabulary (RecurrentGemma's 256,000 tokens, twice Llama
    3's, by default), ties planted in every row (the first maximum must
    win)."""
    from repro_torch.kernels import spec_verify as sv
    R = 2 * (GAMMA + 1)
    logits, first = planted_logits(R, V, seed)
    out = sv.blockwise_argmax(logits)[:, 0]
    ref = sv.plain(logits)[:, 0]
    torch.cuda.synchronize()
    err = float((out.long() - ref.long()).abs().max())
    ok = err == 0 and bool((out == first).all())
    ms = timer(lambda: sv.blockwise_argmax(logits))
    plain_ms = timer(lambda: sv.plain(logits))
    library_ms = timer(lambda: torch.argmax(logits, dim=-1))
    case = {"case": "blockwise_argmax", "geometry": geometry,
            "shape": [R, V], "dtype": "float32", "max_abs_err": err,
            "atol": 0, "rtol": 0, "ok": ok, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "cluster": sv.plan(R, V).cluster,
            **bound(logits.numel() * 4 + R * 4, R * V, torch.float32)}
    emit(case)
    if not ok:
        raise SystemExit(f"argmax kernel disagrees with torch.argmax: {case}")
    return case


def hybrid_kernel_cases(timer):
    """The kernels at the hybrid family's shapes (RecurrentGemma 2B and its
    drafter: one kv-head, D = 256): paged attention at Q 1 and GAMMA + 1,
    fp32 and bf16, as ``attention_case`` runs the paper pair's; the Q = 5
    rows bit-equal to Q = 1 (``q_invariance``; the width-1 tree skipped,
    the tree entry takes D 32 to 128); a windowed ring that has wrapped
    (``wrap_ring_case``); no-cache flash attention at B = 2 and the main
    path's S = 134, at S = 2048 and with a window of 64 that binds at S =
    1100; the argmax at [10, 256000]. Returns (paged cases, flash cases,
    the argmax case)."""
    dtypes = (torch.float32, torch.bfloat16)
    paged = [attention_case(timer, geom, H, Kv, D, Q, dtype)
             for geom, H, Kv, D in HYBRID_GEOMS for Q in (1, GAMMA + 1)
             for dtype in dtypes]
    for geom, H, Kv, D in HYBRID_GEOMS:
        for dtype in dtypes:
            q_invariance(geom, H, Kv, D, dtype)
    paged += [wrap_ring_case(timer, geom, H, Kv, D, Q, dtype)
              for geom, H, Kv, D in HYBRID_GEOMS for Q in (1, GAMMA + 1)
              for dtype in dtypes]
    T = NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2
    flash = [flash_case(timer, *geom, T, dtype)
             for geom in HYBRID_GEOMS for dtype in dtypes]
    flash.append(flash_case(timer, *HYBRID_GEOMS[0], 2048, torch.bfloat16))
    S, window = HYBRID_WINDOW
    flash += [flash_case(timer, *HYBRID_GEOMS[0], S, dtype, window=window)
              for dtype in dtypes]
    return paged, flash, argmax_wide_case(timer)


def hybrid_launches(L_t, L_d, rounds, prompt_len, ring_len, use_cache):
    """A hybrid spec serve's kernel launches: no cache, flash per attention
    unit of GAMMA drafter passes and one target pass a round; cached,
    paged per attention unit of GAMMA + 1 stateful drafter steps and one
    verify a round, plus each model's prefill of prompt_len - 1 tokens
    (paged, or flash when it is longer than the ring); an argmax a
    round."""
    out = {"blockwise_argmax": rounds}
    if not use_cache:
        out["flash_attention"] = rounds * (GAMMA * L_d + L_t)
        return out
    pre = "flash_attention" if prompt_len - 1 > ring_len else "paged_attention"
    out["paged_attention"] = rounds * ((GAMMA + 1) * L_d + L_t)
    out[pre] = out.get(pre, 0) + L_t + L_d
    return out


def smoke_hybrid_exactness(arch="recurrentgemma-2b"):
    """The hybrid family at smoke width (fp32, head_dim 64, local window
    16, the drafter the target's first L-1 units, embedding std 0.3;
    weights drawn on the CPU and copied to the card), gamma 4, B = 2, 40
    new tokens, two prompt batches each of length 24 (the 32-slot rings
    wrap as the rounds run) and 40 (each cached prefill of 39 tokens is
    longer than the ring: the flash kernel's windowed route): the no-cache
    engine and the cached one (ring KV in the attention units, state
    caches in the RG-LRU units, the stateful drafter) on the card, the
    same on the CPU, and AR of the same mode on the card must give
    identical tokens and counts, the rounds replayed one at a time must
    give them too, some round must commit part of its draft, and the spec
    serves' launches on the card must be what the path implies
    (``hybrid_launches``)."""
    from repro_torch.configs import registry
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    from repro_torch.models import hybrid
    from repro_torch.models.model import build_model
    new = 40
    cfg = registry.smoke_config(arch)
    cfg = cfg.replace(embed_init_scale=0.3)    # the pair accepts part of its drafts
    mt = build_model(cfg)
    md = build_model(cfg.replace(num_layers=cfg.num_layers - 1, name="draft"))
    pt_cpu = mt.init(0, "cpu")
    pd_cpu = {**pt_cpu, "layers": pt_cpu["layers"][:-1]}
    pt, pd = to_cuda(pt_cpu), to_cuda(pd_cpu)
    counters = kernel_counters()
    L_t, L_d = hybrid.n_attn(mt.cfg), hybrid.n_attn(md.cfg)
    ring_len = mt.init_cache(1, 64 + new, GAMMA + 2, device="cpu")["k"].shape[2]
    for use_cache in (False, True):
        eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, use_cache=use_cache))
        info = {"phase": "smoke_hybrid_exactness", "arch": arch,
                "dtype": cfg.dtype, "use_cache": use_cache, "gamma": GAMMA,
                "batch": 2, "prompt_lens": [24, 40], "new_tokens": new,
                "local_window": cfg.local_window, "ring_len": ring_len,
                "rounds": 0, "accepted": 0, "partial_accepts": 0,
                "gpu_equals_cpu": True, "spec_equals_ar": True,
                "replay_equals_generate": True, "launches_as_expected": True,
                "launches": {}}
        for P in (24, 40):
            for seed in range(2):
                prompt = np.random.default_rng(seed).integers(
                    0, cfg.vocab_size, (2, P)).astype(np.int32)
                zero_counts(counters)
                gpu, st = eng.generate(pt, pd, prompt, new)
                torch.cuda.synchronize()
                launches = read_counts(counters)
                want = {**{name: 0 for name in counters},
                        **hybrid_launches(L_t, L_d, st["rounds"], P, ring_len,
                                          use_cache)}
                cpu, st_cpu = eng.generate(pt_cpu, pd_cpu, prompt, new)
                ar = autoregressive_generate(mt, pt, prompt, new,
                                             use_cache=use_cache).cpu().numpy()
                replay, committed = _nocache_rounds(eng, pt, pd, prompt, new)
                gpu, cpu = gpu.cpu().numpy(), cpu.numpy()
                info["rounds"] += st["rounds"]
                info["accepted"] += st["accepted"]
                info["partial_accepts"] += sum(0 < c - 1 < GAMMA for c in committed)
                info["gpu_equals_cpu"] &= bool(np.array_equal(gpu, cpu) and st == st_cpu)
                info["spec_equals_ar"] &= bool(np.array_equal(gpu[:, :P + new], ar))
                info["replay_equals_generate"] &= bool(np.array_equal(replay, gpu))
                info["launches_as_expected"] &= launches == want
                for name, n in launches.items():
                    info["launches"][name] = info["launches"].get(name, 0) + n
        emit(info)
        if not (info["gpu_equals_cpu"] and info["spec_equals_ar"]
                and info["replay_equals_generate"]
                and info["launches_as_expected"] and info["partial_accepts"]):
            raise SystemExit(f"smoke-width hybrid exactness failed: {info}")


def full_width_hybrid(card):
    """RecurrentGemma 2B with its registered drafter at full width and
    depth (bf16, seeded random weights; 8 and 2 attention units at D =
    256, 18 and 6 RG-LRU units), gamma 4, step 7's traffic (4 requests of
    64 + 64, two waves of 2) through ``launch.serve``. (a) No cache: flash
    launches rounds x (GAMMA x 2 + 8), an argmax a round, no other kernel
    (``nocache_phase``); tokens == no-cache AR's, or a first difference
    that a near-tie explains; then ``"profile_hybrid"``. (b) Cached
    (``cached_serve``): ring KV in the attention units (the 2048-token
    window does not bind at 134 positions), state and conv caches in the
    RG-LRU units, the stateful drafter's GAMMA + 1 steps a round: paged
    launches rounds x ((GAMMA + 1) x 2 + 8) + waves x (8 + 2), an argmax a
    round; its tokens against cached AR's and (a)'s are readings (the bf16
    state is rounded once a token by AR and once a round by speculation,
    as for Mamba-2), each first difference printed with its top-2 margin;
    then ``"profile_hybrid_cached"``. Returns ((a)'s launches, (b)'s)."""
    from repro_torch.launch.cli_args import build_pair
    from repro_torch.models import hybrid
    mt, md, pt, pd, cfg = build_pair("recurrentgemma-2b", smoke=False,
                                     device="cuda")
    A_t, A_d = hybrid.n_attn(mt.cfg), hybrid.n_attn(md.cfg)
    nocache = nocache_phase("full_width_hybrid", "profile_hybrid", mt, md, pt,
                            pd, cfg, card, {"flash_attention": (A_t, A_d)},
                            near_ties=True)
    cached = cached_serve("full_width_hybrid_cached", "profile_hybrid_cached",
                          mt, md, pt, pd, cfg, card,
                          {"paged_attention": (A_t, A_d, A_t, A_d)}, nocache,
                          exact=False)
    return nocache["launches"], cached["launches"]


# ------------------------------------------------- VLM and encoder-decoder
VLM_GEOMS = (("internvl2-26b", 48, 8, 128), ("internvl2-draft", 12, 4, 128))
WHISPER_GEOMS = (("whisper-large-v3", 20, 20, 64), ("whisper-draft", 12, 12, 64))
VISION = 256                      # InternVL2-26B's vision tokens
VLM_PROMPT, VLM_NEW = 32, 32      # the VLM phase's text: P, new tokens
WHISPER_PROMPT = 4                # the decoder's prompt (start tokens)
WHISPER_NEW = (32, 16)            # new tokens, cached and no-cache
WHISPER_FRAMES = 1500


def _ring_slots(n):
    return -(-n // 16) * 16


def vlm_encdec_kernel_cases(timer):
    """The kernels at the VLM and encoder-decoder families' shapes.
    Paged attention: InternVL2-26B (48/8/128) and Whisper large-v3
    (20/20/64) on a random pool at Q 1 and GAMMA + 1, fp32 and bf16
    (``attention_case``); each geometry's Q = 5 rows bit-equal to Q = 1
    calls (``q_invariance``; the drafters' too); over the cached phases'
    ring views, bf16 (``ring_view_case``): InternVL's ring of 256 + 70
    positions (336 slots) at the vision prefill (Q = 256 + P - 1 from 0)
    and at Q 1 and 5 past the prefix, Whisper's 48-slot ring at the
    decoder's prefill (Q = P - 1) and at Q 1 and 5. Flash attention: the
    Whisper encoder non-causal at B = 2, S = 1500 (fp32 and bf16; the
    drafter's 12/12/64 bf16), the cross-attention non-causal at Sq 1, 5
    and P - 1 over 1500 keys, and the InternVL no-cache pass causal at S =
    256 + the phase's buffer, both geometries, fp32 and bf16. The argmax
    at [10, 92553] and [10, 51866]. Returns (paged cases, flash cases,
    argmax cases)."""
    dtypes = (torch.float32, torch.bfloat16)
    vt, vd = VLM_GEOMS
    wt, wd = WHISPER_GEOMS
    paged = [attention_case(timer, *geom, Q, dtype)
             for geom in (vt, wt) for Q in (1, GAMMA + 1) for dtype in dtypes]
    for geom in VLM_GEOMS + WHISPER_GEOMS:
        for dtype in dtypes:
            q_invariance(*geom, dtype)
    T = VLM_PROMPT + VLM_NEW + GAMMA + 2
    W = _ring_slots(VISION + T)
    start = VISION + VLM_PROMPT - 1
    paged += [ring_view_case(timer, *geom, Q, s, W=W) for geom in VLM_GEOMS
              for Q, s in ((start, 0), (1, start + 8), (GAMMA + 1, start + 12))]
    Tw = WHISPER_PROMPT + WHISPER_NEW[0] + GAMMA + 2
    paged += [ring_view_case(timer, *geom, Q, s, W=_ring_slots(Tw))
              for geom in WHISPER_GEOMS
              for Q, s in ((WHISPER_PROMPT - 1, 0), (1, 20), (GAMMA + 1, 24))]
    S = WHISPER_FRAMES
    flash = [flash_case(timer, *wt, S, dtype, causal=False) for dtype in dtypes]
    flash.append(flash_case(timer, *wd, S, torch.bfloat16, causal=False))
    flash += [flash_case(timer, *wt, S, torch.bfloat16, causal=False, Sq=Sq)
              for Sq in (1, GAMMA + 1, WHISPER_PROMPT - 1)]
    flash.append(flash_case(timer, *wt, S, torch.float32, causal=False,
                            Sq=GAMMA + 1))
    flash += [flash_case(timer, *geom, VISION + T, dtype)
              for geom in VLM_GEOMS for dtype in dtypes]
    argmax = [argmax_wide_case(timer, geom, V, seed)
              for geom, V, seed in (("internvl2-26b", 92553, 9),
                                    ("whisper-large-v3", 51866, 10))]
    return paged, flash, argmax


def stub_extras(model, batch, seed, device):
    """Seeded stand-ins for a model's stub front end (``extra_inputs``):
    standard normal values in the activation dtype on ``device``."""
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device=device, dtype=dtype)
            for name, (shape, dtype) in model.extra_inputs(batch).items()}


def engine_exact(phase, part, mt, md, pt, pd, prompt, max_new, ex_t, ex_d,
                 use_cache, expect, card):
    """``SpecEngine`` (gamma GAMMA, B = 2) with each role's extras, then
    ``autoregressive_generate`` of the same mode on the target's, each
    after a short uncounted warm-up, every kernel's count set to 0 just
    before and read just after: ``expect(rounds)`` gives (the spec run's
    launches, AR's). Before the count, one round after a prefill runs
    under ``torch.cuda.set_sync_debug_mode("error")``: a round makes no
    host sync of its own (``core/rounds.py``), so any sync in it fails
    the part. The spec tokens must be AR's, or part from them only
    at a first difference that ``near_ties`` explains. Prints the
    wall per round, alpha-hat and peak memory. Returns (launches, info)."""
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    from repro_torch.obs import clock
    counters = kernel_counters()
    none = {name: 0 for name in counters}
    eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, use_cache=use_cache))
    P = prompt.shape[1]
    eng.generate(pt, pd, prompt, 2, extras_t=ex_t, extras_d=ex_d)
    autoregressive_generate(mt, pt, prompt, 2, extras=ex_t, use_cache=use_cache)
    st0 = eng.prefill(pt, pd, prompt, P + 2 * GAMMA + 2, ex_t, ex_d)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.round(pt, pd, st0)
    except RuntimeError as e:
        raise SystemExit(f"{phase} ({part}): a round synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del st0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = clock.perf()
    toks, st = eng.generate(pt, pd, prompt, max_new, extras_t=ex_t, extras_d=ex_d)
    torch.cuda.synchronize()
    wall = clock.perf() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    zero_counts(counters)
    t0 = clock.perf()
    ar = autoregressive_generate(mt, pt, prompt, max_new, extras=ex_t,
                                 use_cache=use_cache)
    torch.cuda.synchronize()
    ar_wall = clock.perf() - t0
    ar_launches = read_counts(counters)
    spec = toks[:, :P + max_new].cpu().numpy()
    ar = ar.cpu().numpy()
    want, want_ar = expect(st["rounds"])
    want, want_ar = {**none, **want}, {**none, **want_ar}
    same = bool(np.array_equal(spec, ar))
    ties = [] if same else near_ties(
        mt, pt, spec, ar, [(row[:P], max_new) for row in prompt], extras=ex_t)
    info = {"phase": phase, "part": part, "target": mt.cfg.name,
            "drafter": md.cfg.name, "dtype": mt.cfg.dtype, "card": card,
            "use_cache": use_cache, "batch": prompt.shape[0], "prompt_len": P,
            "extras": {k: list(v.shape) for k, v in ex_t.items()},
            "drafter_extras": {k: list(v.shape) for k, v in ex_d.items()},
            "new_tokens": max_new, "gamma": GAMMA, "rounds": st["rounds"],
            "accepted": st["accepted"], "alpha_hat": st["alpha_hat"],
            "wall_s": wall, "ms_per_round": wall / st["rounds"] * 1e3,
            "tokens_per_s": prompt.shape[0] * max_new / wall,
            "ar_wall_s": ar_wall, "ar_ms_per_token": ar_wall / max_new * 1e3,
            "peak_memory_gib": peak, "launches": launches,
            "expected_launches": want, "ar_launches": ar_launches,
            "expected_ar_launches": want_ar,
            "in_vocab": bool(((spec >= 0) & (spec < mt.cfg.vocab_size)).all()),
            "spec_equals_ar": same, "round_syncs_host": False,
            "new_tokens_equal_ar": int((spec[:, P:] == ar[:, P:]).sum()),
            "new_tokens_total": int(spec[:, P:].size),
            "differences_from_ar": ties}
    emit(info)
    agree = same or all(t["explained"] for t in ties)
    if not (agree and info["in_vocab"] and launches == want
            and ar_launches == want_ar):
        raise SystemExit(f"{phase} ({part}) failed: {info}")
    return launches, info


def _add(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    return total


def full_width_vlm(card):
    """InternVL2-26B with ``internvl2-draft`` at full width and depth
    (bf16, seeded random weights, 48 and 10 layers; the vision front end a
    stub: seeded patches [2, 256, VIT_DIM] for each role), after a check
    that the card holds the reckoned bytes. Traffic: B = 2, P = 32 text
    tokens, 32 new, gamma 4. (a) The no-cache ``SpecEngine`` with patches
    against no-cache AR: flash rounds x (GAMMA L_d + L_t), an argmax a
    round; AR flash L_t a token. (b) The cached ``SpecEngine`` (the vision
    prefix prefilled into each ring with the prompt, t_off = d_off = 256)
    against cached AR: paged (L_t + L_d) + rounds x (GAMMA L_d + L_t), an
    argmax a round; AR paged L_t a token. (c) A text-only
    ``PagedSpecServer`` serve (4 requests, prompts 16-64, 32 new) against
    AR (``paged_exact``). Each part's tokens are AR's up to any first
    difference a measured near-tie explains (the random untied head, as
    DeepSeek's). Returns the three spec runs' launches together."""
    from repro_torch.configs import registry
    from repro_torch.launch.cli_args import build_pair
    from repro_torch.models import vlm
    from repro_torch.obs import clock
    from repro_torch.serving import SchedulerConfig
    phase = "full_width_vlm"
    tgt, drf = registry.config("internvl2-26b"), registry.drafter_config("internvl2-26b")
    proj = lambda c: vlm.VIT_DIM * (c.d_model + 1) + c.d_model ** 2  # noqa: E731
    weights = 2 * (tgt.param_count() + drf.param_count() + proj(tgt) + proj(drf))
    head = 4 * tgt.vocab_size * (tgt.d_model + drf.d_model)
    need = weights + head + (4 << 30)
    free, total = torch.cuda.mem_get_info()
    info = {"phase": phase, "part": "memory", "card": card, "free_bytes": free,
            "total_bytes": total, "weight_bytes": weights,
            "head_fp32_bytes": head, "reckoned_bytes": need}
    emit(info)
    if free < need:
        raise SystemExit(f"the card lacks the reckoned bytes for InternVL2-26B: {info}")
    t0 = clock.perf()
    mt, md, pt, pd, cfg = build_pair("internvl2-26b", smoke=False, device="cuda")
    torch.cuda.synchronize()
    dev = pt["embed"]["table"].device
    emit({"phase": phase, "part": "init", "card": card,
          "init_s": clock.perf() - t0,
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30})
    L_t, L_d = len(pt["layers"]), len(pd["layers"])
    ex_t, ex_d = stub_extras(mt, 2, 20, dev), stub_extras(md, 2, 21, dev)
    prompt = np.random.default_rng(22).integers(
        0, cfg.vocab_size, (2, VLM_PROMPT)).astype(np.int32)
    new = VLM_NEW
    a, _ = engine_exact(
        phase, "a_nocache", mt, md, pt, pd, prompt, new, ex_t, ex_d, False,
        lambda r: ({"flash_attention": r * (GAMMA * L_d + L_t),
                    "blockwise_argmax": r},
                   {"flash_attention": new * L_t}), card)
    from repro_torch.core.engine import EngineConfig, SpecEngine
    eng = SpecEngine(mt, md, EngineConfig(gamma=GAMMA, use_cache=True))
    st = eng.prefill(pt, pd, prompt, VLM_PROMPT + new + GAMMA + 2, ex_t, ex_d)
    offsets = {"t_off": int(st.t_off), "d_off": int(st.d_off),
               "t_index": int(st.tcache["index"]),
               "ring_slots": int(st.tcache["k"].shape[2]),
               "decode_extras": [st.extras_t, st.extras_d]}
    del st, eng
    ok = (offsets["t_off"] == offsets["d_off"] == VISION
          and offsets["t_index"] == VISION + VLM_PROMPT - 1
          and offsets["decode_extras"] == [None, None])
    emit({"phase": phase, "part": "b_prefill_offsets", "card": card,
          **offsets, "ok": ok})
    if not ok:
        raise SystemExit(f"the VLM's cached prefill offsets are wrong: {offsets}")
    b, _ = engine_exact(
        phase, "b_cached", mt, md, pt, pd, prompt, new, ex_t, ex_d, True,
        lambda r: ({"paged_attention": L_t + L_d + r * (GAMMA * L_d + L_t),
                    "blockwise_argmax": r},
                   {"paged_attention": new * L_t}), card)
    rng = np.random.default_rng(23)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 65))).astype(np.int32),
             32) for _ in range(4)]
    scfg = SchedulerConfig(max_batch=4, block_size=16, num_blocks=64,
                           max_blocks_per_row=8)
    c, _ = paged_exact(phase, mt, md, pt, pd, reqs, scfg, card, exact=False)
    return _add(_add(dict(a), b), c)


def full_width_encdec(card):
    """Whisper large-v3 with ``whisper-draft`` at full width and depth
    (bf16, seeded random weights; 32 + 32 and 12 + 12 layers; the audio
    front end a stub: seeded frames [2, 1500, 1280] and [2, 1500, 768],
    each model encoding its own), a 4-token decoder prompt, gamma 4. (a)
    The cached ``SpecEngine``, 32 new, against cached AR: each model
    encodes once in its prefill (flash E a model), then every decoder
    forward runs paged self-attention and flash cross-attention per layer:
    flash E_t + E_d + L_t + L_d + rounds x (GAMMA L_d + L_t), paged L_t +
    L_d + the same rounds term, an argmax a round; AR flash E_t + new L_t,
    paged new L_t. (b) The no-cache ``SpecEngine``, 16 new, against
    no-cache AR: every forward encodes its frames again (as in JAX), so
    flash rounds x (GAMMA (E_d + 2 L_d) + E_t + 2 L_t) and an argmax a
    round; AR flash new (E_t + 2 L_t). Tokens are AR's up to any
    explained near-tie. Returns both spec runs' launches together."""
    from repro_torch.launch.cli_args import build_pair
    from repro_torch.obs import clock
    phase = "full_width_encdec"
    t0 = clock.perf()
    mt, md, pt, pd, cfg = build_pair("whisper-large-v3", smoke=False,
                                     device="cuda")
    torch.cuda.synchronize()
    dev = pt["embed"]["table"].device
    emit({"phase": phase, "part": "init", "card": card,
          "init_s": clock.perf() - t0,
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30})
    L_t, L_d = len(pt["dec_layers"]), len(pd["dec_layers"])
    E_t, E_d = len(pt["enc_layers"]), len(pd["enc_layers"])
    ex_t, ex_d = stub_extras(mt, 2, 30, dev), stub_extras(md, 2, 31, dev)
    prompt = np.random.default_rng(32).integers(
        0, cfg.vocab_size, (2, WHISPER_PROMPT)).astype(np.int32)
    new_c, new_n = WHISPER_NEW

    def cached(r):
        per = r * (GAMMA * L_d + L_t)
        return ({"flash_attention": E_t + E_d + L_t + L_d + per,
                 "paged_attention": L_t + L_d + per, "blockwise_argmax": r},
                {"flash_attention": E_t + new_c * L_t,
                 "paged_attention": new_c * L_t})
    a, _ = engine_exact(phase, "a_cached", mt, md, pt, pd, prompt, new_c,
                        ex_t, ex_d, True, cached, card)
    b, _ = engine_exact(
        phase, "b_nocache", mt, md, pt, pd, prompt, new_n, ex_t, ex_d, False,
        lambda r: ({"flash_attention": r * (GAMMA * (E_d + 2 * L_d)
                                            + E_t + 2 * L_t),
                    "blockwise_argmax": r},
                   {"flash_attention": new_n * (E_t + 2 * L_t)}), card)
    return _add(dict(a), b)


# ------------------------------------------------------------------ training
BWD_TOL = {torch.float32: (2e-4, 1e-6),    # |d| <= rel * max|ref| + abs: fp32
           torch.bfloat16: (2e-2, 0.0)}    # sums; bf16 inputs and outputs
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3      # (b): Llama 3.2 3B
PAIR_STEPS, PAIR_BATCH, PAIR_SEQ, PAIR_LR = 300, 16, 48, 2e-3   # (c)
PAIR_VOCAB, PAIR_PROMPTS, PAIR_PROMPT_LEN, PAIR_NEW = 256, 6, 12, 24
# (a)'s head geometries (name, H, Kv, D): the pair's target (the drafter's
# 4 / 2 heads keep its head_dim 48, see pair_configs) and d 128 over 4 / 2
# at d / H = 32
PAIR_GEOMS = (("bench-target", 8, 4, 48), ("d128-h4-hd32", 4, 2, 32))
MAMBA_BATCH, MAMBA_SEQ, MAMBA_STEPS = 2, 512, 3      # (d): mamba2-780m
MAMBA_SMOKE_SEQ = 20          # (d): mamba2-smoke's 8-token chunks, the last ragged
SSM_GRAD_TOL = (1e-4, 1e-6)   # |d| <= rel * max|cpu| + abs per gradient leaf:
                              # fp32 sums in other orders on the card


def flash_bwd_case(timer, name, H, Kv, D, S, dtype, *, B=2, window=None,
                   causal=True, headline=False):
    """The flash backward kernel at [B, S] against its plain version
    (autograd of ``flash_attention_ref``) on the same inputs, run twice
    (bit-equal), from the forward's output and log-sum-exp (the lse held
    to ``ref.flash_attention_lse_ref``). Times: the forward with the lse,
    the backward's three kernels, the plain backward (its forward
    included), and SDPA's backward alone over head-expanded K/V (graph
    kept from one forward) as the library; then the forward with the lse
    and the backward together against SDPA's forward and backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(H * 1000 + S + D)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D)))
    do = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    kw = dict(window=window, causal=causal)
    o, lse = fa.forward(q, k, v, lse=True, **kw)
    lse_ref = ref.flash_attention_lse_ref(q, k, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    rel, atol = BWD_TOL[dtype]
    errs, ok = {}, True
    for nm, x, y in zip(("dq", "dk", "dv"), got, want):
        err = float((x.float() - y.float()).abs().max())
        top = float(y.float().abs().max())
        errs[nm] = {"max_abs_err": err, "max_abs_ref": top,
                    "tol": rel * top + atol}
        ok &= err <= rel * top + atol
    lse_err = float((lse - lse_ref).abs().max())
    ok &= lse_err <= 1e-3 if dtype == torch.bfloat16 else lse_err <= 1e-4
    deterministic = all(torch.equal(x, y) for x, y in zip(got, again))

    ms_fwd = timer(lambda: fa.forward(q, k, v, lse=True, **kw))
    iters = 5 if S > 1024 else 10
    ms = timer(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
               iters=iters)
    plain_ms = timer(lambda: ref.flash_attention_bwd_ref(q, k, v, do, **kw),
                     iters=3)
    qg = q.permute(0, 2, 1, 3).detach().requires_grad_(True)
    kg = k.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1).detach().requires_grad_(True)
    vg = v.permute(0, 2, 1, 3).repeat_interleave(H // Kv, 1).detach().requires_grad_(True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(S, device="cuda")
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]).abs() < window

    def library_fwd():
        if causal and window is None:
            return sdpa(qg, kg, vg, is_causal=True)
        return sdpa(qg, kg, vg, attn_mask=mask)
    dog = do.permute(0, 2, 1, 3)
    out = library_fwd()
    library_ms = timer(lambda: torch.autograd.grad(out, (qg, kg, vg), dog,
                                                   retain_graph=True),
                       iters=iters)
    del out
    library_fwd_bwd_ms = timer(
        lambda: torch.autograd.grad(library_fwd(), (qg, kg, vg), dog), iters=iters)

    def fwd_bwd():
        o_, lse_ = fa.forward(q, k, v, lse=True, **kw)
        return fa.flash_attention_bwd(q, k, v, o_, lse_, do, **kw)
    fwd_bwd_ms = timer(fwd_bwd, iters=iters)
    # least work: q, k, v, o, dO and lse read once, dq, dk, dv written once;
    # 10 D flops per (query head, visible pair): S, dP, dV, dK, dQ
    esz = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * esz + lse.numel() * 4 \
        + (q.numel() + 2 * k.numel()) * esz
    flops = 10 * B * H * D * int(mask.sum())
    case = {"phase": "train", "part": "a_flash_backward", "geometry": name,
            "B": B, "S": S, "H": H, "Kv": Kv, "D": D, "window": window,
            "causal": causal, "dtype": str(dtype).replace("torch.", ""),
            **errs, "lse_max_abs_err": lse_err, "rel_tol": rel, "abs_tol": atol,
            "ok": bool(ok), "deterministic": deterministic,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "fwd_lse_ms": ms_fwd, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "sdpa backward",
            "fwd_bwd_ms": fwd_bwd_ms, "library_fwd_bwd_ms": library_fwd_bwd_ms,
            **bound(nbytes, flops, dtype), "headline": headline}
    emit(case)
    if not (ok and deterministic):
        raise SystemExit(f"the flash backward kernel disagrees with its plain "
                         f"version or is not deterministic: {case}")
    return case


def flash_bwd_cases(timer):
    """(a): the geometries the trained families give the backward, B = 2,
    fp32 and bf16: Llama 3.2 3B (S 512 and 2048), 1B, RecurrentGemma's MQA
    at D 256 with its window of 64, Whisper's encoder (non-causal)."""
    geoms = (("llama3.2-3b", 24, 8, 128, 512, {}),
             ("llama3.2-3b", 24, 8, 128, 2048, {}),
             ("llama3.2-1b", 32, 8, 64, 512, {}),
             ("recurrentgemma-2b", 10, 1, 256, 512, {"window": 64}),
             ("whisper-encoder", 20, 20, 64, 1500, {"causal": False}))
    return [flash_bwd_case(timer, name, H, Kv, D, S, dtype,
                           headline=(name == "llama3.2-3b" and S == 512
                                     and dtype == torch.bfloat16), **kw)
            for name, H, Kv, D, S, kw in geoms
            for dtype in (torch.float32, torch.bfloat16)]


def train_counters():
    """The flash kernels' wrappers, forward and backward, by name."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd}


def train_3b(card):
    """(b): Llama 3.2 3B at full width and depth (bf16, tied, the port's
    seeded init), AdamW over order-2 Markov batches of 4 x 512 from
    ``data.pipeline`` (V 128256). The loss and gradients of one batch with
    and without ``remat`` (full) from the same params: the losses equal, the
    gradients bit-equal or within the bf16 tolerance of (a) (the line says
    which); flash launches L and 2 L forward, L backward. Then 3 train steps
    (each loss finite, L forward and L backward launches a step), the step
    time and peak memory, the params moved; a checkpoint save and restore
    round trip, leaf by leaf bit-equal. Returns the launches."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.models.model import build_model
    from repro_torch.obs import clock
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop
    cfg = registry.config("llama3.2-3b")
    L = cfg.num_layers
    model = build_model(cfg)
    t0 = clock.perf()
    params = train_loop.trainable(model.init(0, "cuda"))
    torch.cuda.synchronize()
    init_s = clock.perf() - t0
    stream = pipeline.batches(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0, order=2))

    def batch():
        toks, labels = pipeline.split_batch(next(stream))
        return {"tokens": torch.as_tensor(toks, device="cuda"),
                "labels": torch.as_tensor(labels, device="cuda")}
    total = {"flash_attention": 0, "flash_attention_bwd": 0}

    counters = train_counters()

    def counted(fn):
        zero_counts(counters)
        torch.cuda.synchronize()
        t = clock.perf()
        out = fn()
        torch.cuda.synchronize()
        n = read_counts(counters)
        for key in total:
            total[key] += n[key]
        return out, clock.perf() - t, n

    b0 = batch()
    (l0, _, g0), t_plain, n_plain = counted(
        lambda: train_loop.value_and_grad(model, params, b0["tokens"], b0["labels"]))
    remat = build_model(cfg.replace(remat=True))
    (l1, _, g1), t_remat, n_remat = counted(
        lambda: train_loop.value_and_grad(remat, params, b0["tokens"], b0["labels"]))
    rel = BWD_TOL[torch.bfloat16][0]
    bit_equal, worst = True, 0.0
    for path, x in opt.leaves(g0):
        y = opt.get(g1, path)
        if not torch.equal(x, y):
            bit_equal = False
            worst = max(worst, float((x.float() - y.float()).abs().max())
                        / max(float(y.float().abs().max()), 1e-30))
    del g0, g1
    info = {"phase": "train", "part": "b_remat", "card": card, "arch": cfg.name,
            "layers": L, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "init_s": init_s,
            "loss": float(l0), "loss_remat": float(l1),
            "losses_equal": bool(torch.equal(l0, l1)),
            "grads_bit_equal": bit_equal, "grads_worst_rel_err": worst,
            "grads_within_bf16_tol": worst <= rel,
            "fwd_bwd_s": t_plain, "fwd_bwd_remat_s": t_remat,
            "launches": n_plain, "launches_remat": n_remat,
            "launches_expected": {"flash_attention": L, "flash_attention_bwd": L},
            "launches_remat_expected": {"flash_attention": 2 * L,
                                        "flash_attention_bwd": L}}
    info["ok"] = bool(info["losses_equal"] and (bit_equal or worst <= rel)
                      and n_plain == info["launches_expected"]
                      and n_remat == info["launches_remat_expected"])
    emit(info)
    if not info["ok"]:
        raise SystemExit(f"remat changed the 3B loss or gradients, or the "
                         f"flash launches are off: {info}")

    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=max(10, TRAIN_STEPS // 20),
                           total_steps=TRAIN_STEPS)
    state = train_loop.init_opt_state(model, ocfg, params)
    step = train_loop.make_train_step(model, ocfg)
    # matrices: a bf16 norm scale at 1.0 moves only by steps past its ulp
    watch = [("embed", "table"), ("layers", 0, "attn", "q", "w"),
             ("layers", L - 1, "mlp", "down", "w")]
    before = {p: opt.get(params, p).clone() for p in watch}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        b = batch()
        (params, state, met), t, n = counted(lambda: step(params, state, b))
        steps.append({"step": i, "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]), "lr": met["lr"],
                      "step_s": t, "launches": n})
    peak = torch.cuda.max_memory_allocated()
    moved = {"/".join(map(str, p)): not torch.equal(before[p], opt.get(params, p))
             for p in watch}
    del before
    info = {"phase": "train", "part": "b_steps", "card": card, "arch": cfg.name,
            "steps": steps, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
            "max_memory_allocated_gib": peak / 2**30, "params_moved": moved,
            "launches_per_step_expected": {"flash_attention": L,
                                           "flash_attention_bwd": L}}
    info["ok"] = bool(all(np.isfinite(s["loss"]) for s in steps)
                      and all(moved.values())
                      and all(s["launches"] == info["launches_per_step_expected"]
                              for s in steps))
    emit(info)
    if not info["ok"]:
        raise SystemExit(f"the 3B train steps failed: {info}")

    del state
    gc.collect()
    torch.cuda.empty_cache()
    path = ROOT / "build" / "train_ckpt" / "llama3.2-3b.npz"
    t = clock.perf()
    ckpt.save(str(path), params, step=TRAIN_STEPS)
    save_s = clock.perf() - t
    nbytes = path.stat().st_size
    like = opt.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), params)
    t = clock.perf()
    back, got_step = ckpt.restore(str(path), like, "cuda")
    torch.cuda.synchronize()
    restore_s = clock.perf() - t
    path.unlink()
    equal = all(torch.equal(x, opt.get(back, p)) and x.dtype == opt.get(back, p).dtype
                for p, x in opt.leaves(params))
    info = {"phase": "train", "part": "b_checkpoint", "card": card,
            "file_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "step": got_step, "round_trip_equal": equal,
            "ok": bool(equal and got_step == TRAIN_STEPS)}
    emit(info)
    if not info["ok"]:
        raise SystemExit(f"the 3B checkpoint did not round-trip: {info}")
    return total


def pair_configs():
    """(c)'s pair: the trained-pair recipe of ``benchmarks/common.py``
    (``target_cfg`` and ``drafter_cfg``) letter for letter: fp32, V 256,
    tied, embedding std d**-0.5; the target 6 layers of d 384 over 8 query
    and 4 kv heads (head_dim 48), the drafter 2 layers of d 128 over 4 and
    2. The drafter is the target's config ``replace``d, which keeps the
    head_dim derived from the target (48): its query heads are 4 x 48 =
    192 wide over d 128, in the port as in JAX."""
    from repro_torch.configs.base import ModelConfig
    target = ModelConfig(name="bench-target", family="dense", num_layers=6,
                         d_model=384, num_heads=8, num_kv_heads=4, d_ff=1024,
                         vocab_size=PAIR_VOCAB, tie_embeddings=True,
                         dtype="float32", param_dtype="float32",
                         embed_init_scale=384 ** -0.5)
    drafter = target.replace(name="bench-drafter", num_layers=2, d_model=128,
                             num_heads=4, num_kv_heads=2, d_ff=256,
                             embed_init_scale=128 ** -0.5)
    return target, drafter


def pair_kernel_cases(timer):
    """(a) at the head geometries PAIR_GEOMS (head_dim 48 and 32),
    fp32 and bf16, each kernel against its plain version with its time,
    bound and library time: flash forward at S = PAIR_SEQ (the recipe's
    training length) and 134 (a no-cache buffer), the flash backward at the
    training batch [PAIR_BATCH, PAIR_SEQ], paged attention at Q 1 and
    GAMMA + 1 (B 4 ragged, a row on the NULL block) and a bf16 prefill
    chunk of 64 rows from key 448 (its rows bit-equal to a whole call),
    tree attention at chain_tree(TREE_W, TREE_D); then Q=5 rows bit-equal
    to Q=1 calls and a width-1 tree to the causal call. Returns the cases
    by kernel."""
    from repro_torch.core.tree import chain_tree
    T = NOCACHE_PROMPT + NOCACHE_NEW + GAMMA + 2
    out = {"flash": [], "flash_bwd": [], "paged": [], "tree": []}
    for name, H, Kv, D in PAIR_GEOMS:
        for dtype in (torch.float32, torch.bfloat16):
            out["flash"] += [flash_case(timer, name, H, Kv, D, S, dtype)
                             for S in (PAIR_SEQ, T)]
            out["flash_bwd"].append(flash_bwd_case(timer, name, H, Kv, D,
                                                   PAIR_SEQ, dtype, B=PAIR_BATCH))
            out["paged"] += [attention_case(timer, name, H, Kv, D, Q, dtype)
                             for Q in (1, GAMMA + 1)]
            out["tree"].append(tree_attention_case(
                timer, "chain_tree(2,4)", chain_tree(TREE_W, TREE_D), dtype,
                geom=(name, H, Kv, D)))
            q_invariance(name, H, Kv, D, dtype)
        out["paged"].append(paged_chunk_case(timer, name, H, Kv, D,
                                             CHUNK_EQUAL[0]))
    return out


def trained_pair(card):
    """(c): the pair trained on the card through ``launch.train.train``
    (order-1 data, data seed 0, batch 16, seq 48, lr 2e-3, 300 steps, init
    seeds 0 and 1): each final loss under half its first, flash launches L
    a step forward and backward. Then the 6 Markov prompts of 12 tokens
    (the recipe's ``prompts(6, 12, seed=9)``) through the four serving
    paths of ``pair_serves``. Returns the launches of both."""
    from repro_torch.data import pipeline
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.obs import clock
    from repro_torch.training import train_loop
    total = {name: 0 for name in (*kernel_counters(), "flash_attention_bwd")}
    counters = train_counters()
    trained = []
    for cfg, seed in zip(pair_configs(), (0, 1)):
        zero_counts(counters)
        t = clock.perf()
        params, losses = train(cfg, steps_n=PAIR_STEPS, batch=PAIR_BATCH,
                               seq=PAIR_SEQ, lr=PAIR_LR, seed=seed,
                               log_every=100, data_seed=0, data_order=1,
                               device="cuda")
        torch.cuda.synchronize()
        wall = clock.perf() - t
        n = read_counts(counters)
        for key in n:
            total[key] += n[key]
        want = PAIR_STEPS * cfg.num_layers
        info = {"phase": "train", "part": "c_train", "card": card,
                "model": cfg.name, "layers": cfg.num_layers,
                "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
                "first_loss": losses[0], "final_loss": losses[-1],
                "loss_every_50": losses[::50], "train_s": wall,
                "s_per_step": wall / PAIR_STEPS, "launches": n,
                "launches_expected": {"flash_attention": want,
                                      "flash_attention_bwd": want}}
        info["ok"] = bool(losses[-1] < 0.5 * losses[0]
                          and n == info["launches_expected"])
        emit(info)
        if not info["ok"]:
            raise SystemExit(f"the pair's {cfg.name} did not learn: {info}")
        trained.append((build_model(cfg), train_loop.serving_params(params)))
    (mt, pt), (md, pd) = trained
    src = pipeline.MarkovSource(pipeline.DataConfig(
        vocab_size=PAIR_VOCAB, seq_len=PAIR_PROMPT_LEN,
        global_batch=PAIR_PROMPTS, seed=0, order=1))
    prompts = src.sample(np.random.default_rng(9), PAIR_PROMPTS, PAIR_PROMPT_LEN)
    for key, n in pair_serves(card, mt, md, pt, pd, prompts).items():
        total[key] += n
    return total


def pair_serves(card, mt, md, pt, pd, prompts):
    """(c)'s serves of the trained pair at its own head dims, greedy,
    PAIR_NEW new tokens a prompt, every kernel's count set to 0 just before
    each path and read just after, and each path's tokens == its AR's:
    the no-cache ``SpecEngine`` (gamma GAMMA, a prompt at a time: flash
    rounds x (GAMMA L_d + L_t), an argmax a round) against no-cache AR;
    the cached engine on the ring (``cached_exact``: paged attention)
    against cached AR; ``PagedSpecServer`` (``paged_exact``: paged
    attention and the argmax) against AR rounds; cached tree rounds
    (``SpecEngine(use_cache=True, draft_policy="tree")``, chain_tree(TREE_W,
    TREE_D), a prompt at a time: tree L_t a round, paged TREE_D L_d a
    round + L_d + L_t for the prefills) against cached AR. Reports each
    path's acceptance rate. Returns the four paths' launches summed."""
    from repro_torch.core.engine import (EngineConfig, SpecEngine,
                                         autoregressive_generate)
    from repro_torch.obs import clock
    from repro_torch.serving import SchedulerConfig
    counters = kernel_counters()
    none = {name: 0 for name in counters}
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    P = prompts.shape[1]

    def one_at_a_time(eng, depth, expect, use_cache):
        """Each prompt through ``eng``, counted; (tokens, launches,
        expected launches, rounds, accepted, seconds)."""
        eng.generate(pt, pd, prompts[:1, :8], 4)            # warm-up
        launches, expected = dict(none), dict(none)
        rounds = accepted = 0
        toks = []
        torch.cuda.synchronize()
        t = clock.perf()
        for i in range(len(prompts)):
            zero_counts(counters)
            out, st = eng.generate(pt, pd, prompts[i:i + 1], PAIR_NEW)
            torch.cuda.synchronize()
            for name, n in read_counts(counters).items():
                launches[name] += n
            for name, n in expect(st["rounds"]).items():
                expected[name] += n
            rounds += st["rounds"]
            accepted += st["accepted"]
            toks.append(out[0, :P + PAIR_NEW].cpu().numpy())
        seconds = clock.perf() - t
        ar = autoregressive_generate(mt, pt, prompts, PAIR_NEW,
                                     use_cache=use_cache).cpu().numpy()
        same = bool(np.array_equal(np.stack(toks), ar))
        return {"rounds": rounds, "accepted": accepted,
                "alpha_hat": accepted / (rounds * depth), "wall_s": seconds,
                "ms_per_round": seconds / rounds * 1e3, "launches": launches,
                "expected_launches": expected, "spec_equals_ar": same,
                "ok": same and launches == expected}, np.stack(toks)

    def check(part, info):
        emit({"phase": "train", "part": part, "card": card, **info})
        if not info["ok"]:
            raise SystemExit(f"the trained pair's {part} failed: {info}")

    nocache, spec = one_at_a_time(
        SpecEngine(mt, md, EngineConfig(gamma=GAMMA, greedy=True, use_cache=False)),
        GAMMA, lambda r: {**none, "flash_attention": r * (GAMMA * L_d + L_t),
                          "blockwise_argmax": r}, use_cache=False)
    check("c_serve_nocache", {"gamma": GAMMA, **nocache})
    cached_launches, cached = cached_exact("train", "c_serve_cached", mt, md, pt,
                                           pd, prompts, PAIR_NEW, card)
    scfg = SchedulerConfig(max_batch=3, block_size=16, num_blocks=64,
                           max_blocks_per_row=4)
    reqs = [(prompts[i], PAIR_NEW) for i in range(len(prompts))]
    paged_launches, paged = paged_exact("train", mt, md, pt, pd, reqs, scfg, card)
    hist = np.asarray(paged["accept_hist"])
    tree, tree_toks = one_at_a_time(
        SpecEngine(mt, md, EngineConfig(gamma=TREE_D, greedy=True, use_cache=True,
                                        draft_policy="tree", draft_k=TREE_W)),
        TREE_D, lambda r: {**none, "tree_attention": r * L_t,
                           "paged_attention": r * TREE_D * L_d + L_d + L_t,
                           "blockwise_argmax": r}, use_cache=True)
    check("c_serve_tree", {"width": TREE_W, "depth": TREE_D, **tree})
    summary = {"prompts": PAIR_PROMPTS, "prompt_len": PAIR_PROMPT_LEN,
               "new_tokens": PAIR_NEW, "gamma": GAMMA,
               "alpha_hat": {"nocache": nocache["alpha_hat"],
                             "cached": cached["mean_accepted_per_round"] / GAMMA,
                             "paged": float(hist @ np.arange(GAMMA + 1))
                             / (hist.sum() * GAMMA),
                             "tree": tree["alpha_hat"]},
               "tree_equals_nocache_spec": bool(np.array_equal(tree_toks, spec)),
               "ok": True}
    check("c_serve", summary)
    return {name: nocache["launches"][name] + cached_launches[name]
            + paged_launches[name] + tree["launches"][name] for name in counters}


def train_mamba2(card):
    """(d): Mamba-2 trains on the card. Under grad ``ssm_mix`` runs
    ``ssm.ssd_chunked`` (the SSD kernel has no backward; JAX trains
    through the same function). mamba2-smoke: one ``value_and_grad`` of a
    [2, MAMBA_SMOKE_SEQ] batch (8-token chunks: boundaries crossed, a
    ragged last chunk) on the card against the same on the CPU from the
    same params: the losses within 1e-5 relative, every gradient leaf
    within SSM_GRAD_TOL, no SSD launch. mamba2-780m at full width and
    depth (bf16, the port's seeded init): MAMBA_STEPS AdamW steps of
    MAMBA_BATCH x MAMBA_SEQ order-2 Markov tokens, each loss finite, the
    watched params moved, no SSD launch in a step; s a step and peak
    memory; then one no-grad forward of the last batch: L SSD launches and
    finite logits. Returns the launches."""
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.model import build_model
    from repro_torch.obs import clock
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop
    cfg = registry.smoke_config("mamba2-780m")
    model = build_model(cfg)
    params = train_loop.trainable(model.init(0, "cpu"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, MAMBA_SMOKE_SEQ + 1))
    tokens, labels = torch.as_tensor(toks[:, :-1]), torch.as_tensor(toks[:, 1:])
    l_cpu, _, g_cpu = train_loop.value_and_grad(model, params, tokens, labels)
    ss.ssd_scan.launches = 0
    l_gpu, _, g_gpu = train_loop.value_and_grad(model, to_cuda(params),
                                                tokens.cuda(), labels.cuda())
    torch.cuda.synchronize()
    rel, atol = SSM_GRAD_TOL
    worst, ok = 0.0, True
    leaves = list(opt.leaves(g_cpu))
    for path, want in leaves:
        got = opt.get(g_gpu, path).cpu()
        err = float((got - want).abs().max())
        ok &= err <= rel * float(want.abs().max()) + atol
        worst = max(worst, err / max(float(want.abs().max()), 1e-30))
    loss_rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    info = {"phase": "train", "part": "d_mamba2_smoke", "card": card,
            "arch": cfg.name, "batch": 2, "seq": MAMBA_SMOKE_SEQ,
            "chunk": cfg.ssm_chunk, "loss_card": float(l_gpu),
            "loss_cpu": float(l_cpu), "loss_rel_err": loss_rel,
            "grad_leaves": len(leaves), "grads_worst_rel_err": worst,
            "rel_tol": rel, "abs_tol": atol, "ssd_scan_launches": ss.ssd_scan.launches}
    info["ok"] = bool(ok and loss_rel <= 1e-5 and ss.ssd_scan.launches == 0)
    emit(info)
    if not info["ok"]:
        raise SystemExit(f"Mamba-2's card gradients differ from the CPU's: {info}")
    del g_gpu

    cfg = registry.config("mamba2-780m")
    L = cfg.num_layers
    model = build_model(cfg)
    t0 = clock.perf()
    params = train_loop.trainable(model.init(0, "cuda"))
    torch.cuda.synchronize()
    init_s = clock.perf() - t0
    stream = pipeline.batches(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=MAMBA_SEQ, global_batch=MAMBA_BATCH,
        seed=0, order=2))
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=MAMBA_STEPS)
    state = train_loop.init_opt_state(model, ocfg, params)
    step = train_loop.make_train_step(model, ocfg)
    watch = [("embed", "table"), ("layers", 0, "in_proj", "w"),
             ("layers", L - 1, "out_proj", "w")]
    before = {p: opt.get(params, p).clone() for p in watch}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(MAMBA_STEPS):
        x, y = pipeline.split_batch(next(stream))
        b = {"tokens": torch.as_tensor(x, device="cuda"),
             "labels": torch.as_tensor(y, device="cuda")}
        ss.ssd_scan.launches = 0
        torch.cuda.synchronize()
        t = clock.perf()
        params, state, met = step(params, state, b)
        torch.cuda.synchronize()
        steps.append({"step": i, "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]), "lr": met["lr"],
                      "step_s": clock.perf() - t,
                      "ssd_scan_launches": ss.ssd_scan.launches})
    peak = torch.cuda.max_memory_allocated()
    moved = {"/".join(map(str, p)): not torch.equal(before[p], opt.get(params, p))
             for p in watch}
    del state, before
    ss.ssd_scan.launches = 0
    with torch.no_grad():
        logits = model.apply(train_loop.serving_params(params), b["tokens"])[0]
    torch.cuda.synchronize()
    fwd_launches = ss.ssd_scan.launches
    finite = bool(torch.isfinite(logits).all())
    info = {"phase": "train", "part": "d_mamba2_780m", "card": card,
            "arch": cfg.name, "layers": L, "dtype": cfg.dtype,
            "batch": MAMBA_BATCH, "seq": MAMBA_SEQ, "init_s": init_s,
            "steps": steps, "s_per_step": [s["step_s"] for s in steps],
            "max_memory_allocated_gib": peak / 2**30, "params_moved": moved,
            "no_grad_forward_ssd_scan_launches": fwd_launches,
            "no_grad_forward_expected": L, "no_grad_logits_finite": finite}
    info["ok"] = bool(all(np.isfinite(s["loss"]) and s["ssd_scan_launches"] == 0
                          for s in steps)
                      and all(moved.values()) and fwd_launches == L and finite)
    emit(info)
    if not info["ok"]:
        raise SystemExit(f"the mamba2-780m train steps failed: {info}")
    del params, logits
    return {"ssd_scan": fwd_launches}


def full_width_train(card):
    """The ``train`` phase: (a) the flash backward kernel against its plain
    version, and every attention kernel at the bench pair's head dims; (b)
    Llama 3.2 3B trained at full width and depth; (c) the bench pair
    trained and served on four paths; (d) Mamba-2 trained. Returns (a)'s
    backward cases, its cases at the pair's head dims by kernel, and (b)
    + (c) + (d)'s launches."""
    from repro_torch.obs import clock
    t0 = clock.perf()
    timer = Timer()
    cases = flash_bwd_cases(timer)
    pair_cases = pair_kernel_cases(timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    t_a = clock.perf() - t0
    launches = {name: 0 for name in (*kernel_counters(), "flash_attention_bwd")}
    for key, n in train_3b(card).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    t_b = clock.perf() - t0 - t_a
    for key, n in trained_pair(card).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    t_c = clock.perf() - t0 - t_a - t_b
    for key, n in train_mamba2(card).items():
        launches[key] += n
    emit({"phase": "train", "part": "done", "card": card, "a_s": t_a,
          "b_s": t_b, "c_s": t_c, "d_s": clock.perf() - t0 - t_a - t_b - t_c,
          "phase_s": clock.perf() - t0, "launches": launches})
    return cases, pair_cases, launches


# ------------------------------------------------------------ compile steps
COMPILE_SHAPES = {          # (seq_len, global_batch, kind): fits one card
    "prefill": (2048, 1, "prefill"),
    "decode": (2048, 4, "decode"),
    "spec_round": (2048, 4, "decode"),
    "train": (512, 2, "train"),
}
SPEC_PROMPT = 512           # the spec round's prefilled prompt


def like_meta(meta, real) -> bool:
    """Whether ``real`` holds the tree of meta tensors ``meta`` leaf for
    leaf: the same containers and keys, each tensor of the meta one's shape
    and dtype on the card, every other leaf equal."""
    if isinstance(meta, torch.Tensor):
        return (isinstance(real, torch.Tensor) and real.is_cuda
                and real.shape == meta.shape and real.dtype == meta.dtype)
    if isinstance(meta, dict):
        return (isinstance(real, dict) and meta.keys() == real.keys()
                and all(like_meta(meta[k], real[k]) for k in meta))
    if isinstance(meta, (list, tuple)):
        return (isinstance(real, (list, tuple)) and len(meta) == len(real)
                and all(like_meta(m, r) for m, r in zip(meta, real)))
    return meta == real


def zeros_like_meta(cache):
    """A fresh cache on the card (zeros, index 0) shaped as the meta cache
    ``cache`` (a flat dict, as every family's is); other entries as they
    are."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device="cuda")
            if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


INT8_AR_NEW = 32            # the int8 decode part's reading: greedy AR tokens


def clone_cache(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def int8_forwards(mt, params, ring8, counters, total, total8, card):
    """``"part": "b_forward_int8"``: from the int8 ring ``ring8`` (a
    prefilled target cache), the target's verify forward of GAMMA + 1
    tokens and its chain_tree(TREE_W, TREE_D) tree-span forward, each
    against the same forward over a ring of the activation dtype holding
    ``_from_buf`` of the int8 one: the logits must be bit-equal (the int8
    read takes the call's own K/V from ``fresh``, the float ring holds them
    as written). Each forward's launches must be exact (L paged, or L tree);
    they join ``total``, the int8 ones ``total8`` too."""
    from repro_torch.cache import kv_cache
    from repro_torch.core.tree import chain_tree
    L = mt.cfg.num_layers
    act = mt.cfg.act_dtype
    rng = np.random.default_rng(13)
    tree = chain_tree(TREE_W, TREE_D)
    B = ring8["k"].shape[1]
    ring = {k: kv_cache._from_buf(v, act) if k in ("k", "v") else v
            for k, v in clone_cache(ring8).items()}
    info = {"phase": "compile_steps", "part": "b_forward_int8", "card": card,
            "index": int(ring8["index"]), "ring_dtypes": [str(ring8["k"].dtype),
                                                         str(ring["k"].dtype)]}
    ok = True
    for name, Q, kw, kernel in (("verify", GAMMA + 1, {}, "paged_attention"),
                                ("tree", tree.span,
                                 {"tree": (tree.depths, tree.bits)}, "tree_attention")):
        toks = torch.as_tensor(rng.integers(0, mt.cfg.vocab_size, (B, Q)),
                               dtype=torch.int32, device="cuda")
        logits, launches = {}, {}
        for label, cache in (("int8", ring8), ("float", ring)):
            zero_counts(counters)
            logits[label], _, _ = mt.apply(params, toks, clone_cache(cache), **kw)
            torch.cuda.synchronize()
            launches[label] = read_counts(counters)
            for key in total:
                total[key] += launches[label][key]
                total8[key] += launches[label][key] if label == "int8" else 0
        want = {k: L if k == kernel else 0 for k in counters}
        equal = bool(torch.equal(logits["int8"], logits["float"]))
        info[name] = {"Q": Q, "logits_bit_equal": equal,
                      "max_abs_diff": float((logits["int8"].float()
                                             - logits["float"].float()).abs().max()),
                      "launches": launches, "launches_expected": want}
        ok = ok and equal and all(n == want for n in launches.values())
    info["ok"] = ok
    emit(info)
    if not ok:
        raise SystemExit(f"compile_steps b_forward_int8 failed: {info}")
    return info


def int8_ar_reading(mt, params, prompt):
    """A reading, not a check: greedy AR of INT8_AR_NEW tokens after
    ``prompt`` over an int8 ring and over a ring of the activation dtype
    (``Model.apply``, each row fed its own tokens, as JAX's int8 test runs
    it): the share of new tokens that agree (JAX's bar is 0.9) and, at each
    row's first difference, both runs' top-2 margins there with one bf16
    step at the top logit (``top2_margin``)."""
    from repro_torch.core.rounds import next_token
    B, P = prompt.shape
    toks, tops = {}, {}
    for name, dtype in (("int8", torch.int8), ("float", None)):
        cache = mt.init_cache(B, P + INT8_AR_NEW, spec_slack=0, dtype=dtype,
                              device="cuda")
        x, out, top = prompt, [], []
        for _ in range(INT8_AR_NEW):
            logits, cache, _ = mt.apply(params, x, cache, logits_slice="last")
            top.append(logits[:, -1].float().topk(2, dim=-1).values)
            nxt, _ = next_token(logits[:, -1], True, 1.0, None)
            out.append(nxt)
            x = nxt[:, None]
        toks[name] = torch.stack(out, 1).cpu().numpy()
        tops[name] = torch.stack(top, 1).cpu().numpy()                 # [B, N, 2]
        del cache
    a, b = toks["int8"], toks["float"]
    firsts = []
    for r in range(B):
        diff = np.flatnonzero(a[r] != b[r])
        if len(diff):
            i = int(diff[0])
            firsts.append({"row": r, "new_token": i,
                           "tokens": [int(a[r, i]), int(b[r, i])],
                           **{f"{n}_top1": float(tops[n][r, i, 0]) for n in tops},
                           **{f"{n}_margin": float(tops[n][r, i, 0] - tops[n][r, i, 1])
                              for n in tops},
                           "bf16_step": float(2.0 ** (np.floor(np.log2(
                               max(abs(float(tops["float"][r, i, 0])), 1e-30))) - 7))})
    return {"new_tokens": INT8_AR_NEW, "agreement": float((a == b).mean()),
            "jax_bar": 0.9, "rows_equal": int((a == b).all(axis=1).sum()),
            "first_differences": firsts}


def compile_dryrun(card):
    """(a): ``launch.dryrun.run_one`` for every registry arch x input shape
    on meta tensors (single pod): one line a record, then the counts. A
    failed record fails the phase after the sweep, as JAX's sweep does."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun
    counts = {"ok": 0, "skipped": 0, "failed": 0}
    for arch in registry.ARCHS:
        for shape in INPUT_SHAPES:
            try:
                rec = dryrun.run_one(arch, shape, False, verbose=False)
            except Exception as e:   # recorded, then the phase fails below
                rec = {"arch": arch, "shape": shape, "multi_pod": False,
                       "status": "failed", "error": repr(e)[:500]}
            counts[rec["status"]] += 1
            emit({"phase": "compile_steps", "part": "a_dryrun", **rec})
    emit({"phase": "compile_steps", "part": "a_counts", "card": card, **counts,
          "ok": counts["failed"] == 0})
    if counts["failed"]:
        raise SystemExit(f"the meta dry run failed {counts['failed']} records")
    return counts


def compile_steps(mt, md, pt, pd, cfg, card):
    """The ``compile_steps`` phase on the full-width pair's own weights:
    (a) the meta dry run; (b) the four steps ``launch.steps`` builds, at
    shapes that fit one card (``COMPILE_SHAPES``), each run once on tensors
    that match its meta inputs leaf for leaf: the prefill's last logits ==
    ``Model.apply(..., logits_slice="last")``'s; the decode step after a
    prefill gives cached AR's next token; the spec round's first n_commit
    tokens == greedy AR's continuation from the same prefilled caches; the
    train step's loss finite and == ``make_train_step``'s on the same
    batch. Each with its peak memory, wall and exact launches of the
    paged, argmax, flash and flash-backward wrappers (the others 0).
    Returns the four steps' launches."""
    from repro_torch.cache import kv_cache
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engine import autoregressive_generate
    from repro_torch.core.rounds import next_token
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.obs import clock
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop
    t0 = clock.perf()
    compile_dryrun(card)
    t_a = clock.perf() - t0
    L_t, L_d = mt.cfg.num_layers, md.cfg.num_layers
    shapes = {k: ShapeConfig(f"{k}_{s}", s, b, kind)
              for k, (s, b, kind) in COMPILE_SHAPES.items()}
    params_t, params_d = train_loop.trainable(pt), train_loop.trainable(pd)
    counters = {**kernel_counters(), "flash_attention_bwd": fa.flash_attention_bwd}
    rng = np.random.default_rng(11)
    total = dict.fromkeys(counters, 0)
    total8 = dict.fromkeys(counters, 0)      # the launches over int8 caches

    def tokens(B, S):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               dtype=torch.int32, device="cuda")

    def run(name, fn, inputs, args, expected, int8=False):
        """One step: its inputs against the meta ones, then the call with
        the counts set to 0 just before and read just after (``int8``: a
        step over int8 caches, its counts also kept in ``total8``)."""
        matched = like_meta(inputs, args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        t = clock.perf()
        out = fn(*args.values())
        torch.cuda.synchronize()
        wall = clock.perf() - t
        n = read_counts(counters)
        for key in total:
            total[key] += n[key]
            total8[key] += n[key] if int8 else 0
        want = {k: expected.get(k, 0) for k in counters}
        return out, {"phase": "compile_steps", "part": f"b_{name}", "card": card,
                     "inputs_match_meta": matched, "wall_s": wall,
                     "max_memory_allocated_gib":
                         torch.cuda.max_memory_allocated() / 2**30,
                     "launches": n, "launches_expected": want,
                     "launches_ok": n == want}

    def check(info, ok):
        info["ok"] = bool(ok and info["inputs_match_meta"] and info["launches_ok"])
        emit(info)
        if not info["ok"]:
            raise SystemExit(f"compile_steps {info['part']} failed: {info}")

    # prefill: B 1, S 2048 on a fresh cache
    fn, inp = steps.build_prefill_step(mt, shapes["prefill"])
    args = {"params": params_t, "tokens": tokens(1, 2048),
            "cache": zeros_like_meta(inp["cache"]), "extras": {}}
    (logits, pcache), info = run("prefill", fn, inp, args, {"paged_attention": L_t})
    ref, _, _ = mt.apply(params_t, args["tokens"], zeros_like_meta(inp["cache"]),
                         logits_slice="last")
    info.update(logits_shape=list(logits.shape),
                equal_to_apply=bool(torch.equal(logits, ref)))
    check(info, info["equal_to_apply"] and bool(torch.isfinite(logits).all()))

    # the same prefill over an int8 cache: from index 0 every key a layer
    # reads is the call's own, unquantized (``fresh``), so the logits are
    # the bf16 prefill's bit for bit, and the cache holds its K/V quantized
    t8 = clock.perf()
    fn, inp = steps.build_prefill_step(mt, shapes["prefill"], cache_int8=True)
    args = {"params": params_t, "tokens": args["tokens"],
            "cache": zeros_like_meta(inp["cache"]), "extras": {}}
    (logits8, cache8), info = run("prefill_int8", fn, inp, args,
                                  {"paged_attention": L_t}, int8=True)
    ref, _, _ = mt.apply(params_t, args["tokens"], zeros_like_meta(inp["cache"]),
                         logits_slice="last")
    info.update(cache_dtype=str(cache8["k"].dtype),
                equal_to_apply=bool(torch.equal(logits8, ref)),
                equal_to_bf16_prefill=bool(torch.equal(logits8, logits)),
                cache_is_bf16_quantized=all(
                    torch.equal(cache8[n], kv_cache._to_buf_dtype(pcache[n], torch.int8))
                    for n in "kv"))
    check(info, info["equal_to_apply"] and info["equal_to_bf16_prefill"]
          and info["cache_is_bf16_quantized"] and cache8["k"].dtype == torch.int8)
    del args, logits, ref, pcache, logits8, cache8
    t_int8 = clock.perf() - t8

    # decode: B 4 over a 2048-position cache, after a prefill of 2047
    fn, inp = steps.build_decode_step(mt, shapes["decode"])
    prompt = tokens(4, 2047)
    cache = zeros_like_meta(inp["cache"])
    logits, cache, _ = mt.apply(params_t, prompt, cache, logits_slice="last")
    nxt, _ = next_token(logits[:, -1], True, 1.0, None)
    args = {"params": params_t, "tokens": nxt[:, None], "cache": cache,
            "extras": {}}
    (logits, cache), info = run("decode", fn, inp, args, {"paged_attention": L_t})
    got, _ = next_token(logits[:, -1], True, 1.0, None)
    ar = autoregressive_generate(mt, params_t, prompt, 2, use_cache=True)
    info.update(tokens=got.tolist(), ar_tokens=ar[:, -1].tolist(),
                cache_index=int(cache["index"]))
    check(info, torch.equal(got, ar[:, -1]) and info["cache_index"] == 2048)
    del args, cache, logits, ar

    # the decode step over an int8 cache prefilled with the same 2047
    # tokens: its token == greedy AR's, stepped by ``Model.apply`` over the
    # same int8 cache (JAX's int8 test); then a reading: greedy AR of
    # INT8_AR_NEW tokens over int8 against bf16 caches
    t8 = clock.perf()
    fn, inp = steps.build_decode_step(mt, shapes["decode"], cache_int8=True)
    cache = zeros_like_meta(inp["cache"])
    logits, cache, _ = mt.apply(params_t, prompt, cache, logits_slice="last")
    nxt, _ = next_token(logits[:, -1], True, 1.0, None)
    ar_cache = clone_cache(cache)
    args = {"params": params_t, "tokens": nxt[:, None], "cache": cache,
            "extras": {}}
    (logits, cache), info = run("decode_int8", fn, inp, args,
                                {"paged_attention": L_t}, int8=True)
    got, _ = next_token(logits[:, -1], True, 1.0, None)
    ref, ar_cache, _ = mt.apply(params_t, nxt[:, None], ar_cache,
                                logits_slice="last")
    ar, _ = next_token(ref[:, -1], True, 1.0, None)
    info.update(cache_dtype=str(cache["k"].dtype), tokens=got.tolist(),
                ar_tokens=ar.tolist(), logits_equal_apply=bool(torch.equal(logits, ref)),
                cache_index=int(cache["index"]),
                ar_int8_vs_bf16=int8_ar_reading(mt, params_t, prompt))
    check(info, torch.equal(got, ar) and info["cache_index"] == 2048
          and cache["k"].dtype == torch.int8)
    del args, cache, ar_cache, logits, ref
    gc.collect()
    torch.cuda.empty_cache()
    t_int8 += clock.perf() - t8

    # spec round: B 4, gamma 4, the 3B target and 1B drafter from prefilled caches
    fn, inp = steps.build_spec_round_step(mt, md, shapes["spec_round"], gamma=GAMMA)
    prompt = tokens(4, SPEC_PROMPT)
    tcache, dcache = zeros_like_meta(inp["tcache"]), zeros_like_meta(inp["dcache"])
    _, tcache, _ = mt.apply(params_t, prompt[:, :-1], tcache, logits_slice="last")
    _, dcache, _ = md.apply(params_d, prompt[:, :-1], dcache, logits_slice="last")
    ar_cache = clone_cache(tcache)
    args = {"params_t": params_t, "params_d": params_d,
            "t_last": prompt[:, -1].contiguous(), "tcache": tcache, "dcache": dcache}
    (out, n_commit, tcache, dcache), info = run(
        "spec_round", fn, inp, args,
        {"paged_attention": GAMMA * L_d + L_t, "blockwise_argmax": 1})
    ar, tok = [], args["t_last"]
    for _ in range(GAMMA + 1):
        logits, ar_cache, _ = mt.apply(params_t, tok[:, None], ar_cache,
                                       logits_slice="last")
        tok, _ = next_token(logits[:, -1], True, 1.0, None)
        ar.append(tok)
    ar = torch.stack(ar, dim=1)
    n = int(n_commit)
    info.update(n_commit=n, out_tokens=out.tolist(), ar_tokens=ar.tolist(),
                tcache_index=int(tcache["index"]), dcache_index=int(dcache["index"]))
    check(info, n >= 1 and torch.equal(out[:, :n], ar[:, :n])
          and info["tcache_index"] == info["dcache_index"] == SPEC_PROMPT - 1 + n)
    del args, tcache, dcache, ar_cache, logits

    # int8 rings for both roles, prefilled with the same 511 tokens: the
    # target's verify and tree forwards (``int8_forwards``), then the round
    t8 = clock.perf()
    B_s, S_s = shapes["spec_round"].global_batch, shapes["spec_round"].seq_len
    inp = {**inp, **{role: m.cache_spec(B_s, S_s, spec_slack=GAMMA + 2,
                                        dtype=torch.int8)
                     for role, m in (("tcache", mt), ("dcache", md))}}
    tcache, dcache = zeros_like_meta(inp["tcache"]), zeros_like_meta(inp["dcache"])
    _, tcache, _ = mt.apply(params_t, prompt[:, :-1], tcache, logits_slice="last")
    _, dcache, _ = md.apply(params_d, prompt[:, :-1], dcache, logits_slice="last")
    int8_forwards(mt, params_t, tcache, counters, total, total8, card)
    ar_cache = clone_cache(tcache)
    args = {"params_t": params_t, "params_d": params_d,
            "t_last": prompt[:, -1].contiguous(), "tcache": tcache, "dcache": dcache}
    (out8, n_commit, tcache, dcache), info = run(
        "spec_round_int8", fn, inp, args,
        {"paged_attention": GAMMA * L_d + L_t, "blockwise_argmax": 1}, int8=True)
    ar, tok = [], args["t_last"]
    for _ in range(GAMMA + 1):
        logits, ar_cache, _ = mt.apply(params_t, tok[:, None], ar_cache,
                                       logits_slice="last")
        tok, _ = next_token(logits[:, -1], True, 1.0, None)
        ar.append(tok)
    ar = torch.stack(ar, dim=1)
    n8, both = int(n_commit), min(n, int(n_commit))
    info.update(n_commit=n8, out_tokens=out8.tolist(), ar_int8_tokens=ar.tolist(),
                tcache_index=int(tcache["index"]), dcache_index=int(dcache["index"]),
                agreement_bf16_round=float((out8[:, :both] == out[:, :both])
                                           .float().mean()),
                agreement_int8_ar=float((out8[:, :n8] == ar[:, :n8]).float().mean()))
    check(info, n8 >= 1 and tcache["k"].dtype == dcache["k"].dtype == torch.int8
          and info["tcache_index"] == info["dcache_index"] == SPEC_PROMPT - 1 + n8
          and bool(((out8 >= 0) & (out8 < cfg.vocab_size)).all()))
    del args, tcache, dcache, ar_cache, logits, out, out8
    t_int8 += clock.perf() - t8
    gc.collect()
    torch.cuda.empty_cache()

    # train: B 2, S 512, one microbatch, AdamW over the target's params
    ocfg = opt.AdamWConfig()
    fn, inp = steps.build_train_step(mt, shapes["train"], 1, ocfg)
    batch = tokens(2, 513)
    args = {"params": params_t,
            "opt_state": train_loop.init_opt_state(mt, ocfg, params_t),
            "batch": {"tokens": batch[:, :-1].contiguous(),
                      "labels": batch[:, 1:].contiguous()}}
    (new, _, met), info = run("train", fn, inp, args,
                              {"flash_attention": L_t, "flash_attention_bwd": L_t})
    del new
    _, _, ref = train_loop.make_train_step(mt, ocfg, 1)(*args.values())
    info.update(loss=float(met["loss"]), loss_make_train_step=float(ref["loss"]),
                grad_norm=float(met["grad_norm"]))
    check(info, bool(torch.isfinite(met["loss"]))
          and torch.equal(met["loss"], ref["loss"]))
    del args, met, ref
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "compile_steps", "part": "done", "card": card, "a_s": t_a,
          "b_s": clock.perf() - t0 - t_a, "int8_s": t_int8,
          "phase_s": clock.perf() - t0, "launches": total,
          "int8_launches": total8})
    return total, total8


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
    for geom, H, Kv, D in ((("llama3.2-3b", 24, 8, 128), ("llama3.2-1b", 32, 8, 64))
                           + GRANITE_GEOMS + (DEEPSEEK_GEOM, MIXTRAL_GEOM)):
        for dtype in (torch.float32, torch.bfloat16):
            q_invariance(geom, H, Kv, D, dtype)
    chunk_cases = paged_chunk_cases(timer)
    ring_cases = ring_view_cases(timer)
    kv8 = int8_kv_cases(timer)
    ring_cases += dense_config_cases(timer) + wrap_ring_cases(timer)
    fl_cases = flash_cases(timer)
    ssd = ssd_cases(timer)
    ssd += ssd_state_cases(timer)
    ssd_l_invariance()
    i8 = int8_cases(timer)
    hy_paged, hy_flash, hy_arg = hybrid_kernel_cases(timer)
    ve_paged, ve_flash, ve_arg = vlm_encdec_kernel_cases(timer)
    tp_cases = tp_kernel_cases(timer)
    del timer

    smoke_exactness()
    smoke_tree_exactness()
    smoke_nocache_exactness()
    smoke_nocache_exactness("mamba2-780m", "smoke_ssm_nocache_exactness")
    smoke_ssm_cached_exactness()
    smoke_hybrid_exactness()
    smoke_nocache_exactness("llama3.2-1b", "smoke_w8a8_exactness", w8a8=True,
                            batches=3)
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
    tp_launches = full_width_tensor_parallel(*pair, card, linear, cached)
    frontend_launches = full_width_frontend(*pair, card)
    del cached, linear
    w8a8_launches = full_width_w8a8(*pair, card)
    gc.collect()
    torch.cuda.empty_cache()
    compile_launches, compile_int8 = compile_steps(*pair, card)
    del pair
    torch.cuda.empty_cache()
    ssm_launches, ssm_cached = full_width_ssm(card)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_nocache, hybrid_cached = full_width_hybrid(card)
    gc.collect()
    torch.cuda.empty_cache()
    granite_launches = full_width_granite(card)
    gc.collect()
    torch.cuda.empty_cache()
    deepseek_launches = full_width_deepseek_33b(card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = full_width_moe(card)
    gc.collect()
    torch.cuda.empty_cache()
    vlm_launches = full_width_vlm(card)
    gc.collect()
    torch.cuda.empty_cache()
    encdec_launches = full_width_encdec(card)
    gc.collect()
    torch.cuda.empty_cache()
    bwd_cases, pair_cases, train_launches = full_width_train(card)

    # each kernel's launches: its main path's (the chunked serve for paged
    # attention and the argmax, the tree phase, the no-cache serves) plus
    # the cached paths' (full_width_cached parts a-c, the cached Mamba-2),
    # the sampled serves' (paged attention cached, flash no-cache), the
    # Session phase's (paged attention, the argmax, tree attention), the
    # placed, tensor-parallel and front-end phases' (paged attention, the
    # argmax)
    for name, n in cached_launches.items():
        launches[name] += n
    for name in ("paged_attention", "blockwise_argmax"):
        launches[name] += (session_launches[name] + placed_launches[name]
                           + tp_launches[name] + frontend_launches[name])
    launches["paged_attention"] += sampled_launches["paged_attention"]
    tree_launches["tree_attention"] += (cached_launches["tree_attention"]
                                        + session_launches["tree_attention"])
    launches["blockwise_argmax"] += ssm_cached["blockwise_argmax"]
    # the dense-family configs' spec serves (paged, argmax; flash for the
    # windowed rings' prefills)
    for name in ("paged_attention", "blockwise_argmax"):
        launches[name] += (granite_launches[name] + deepseek_launches[name]
                           + moe_launches[name])
    # the hybrid family's spec serves (flash no-cache, paged cached, the
    # argmax in both)
    launches["paged_attention"] += hybrid_cached["paged_attention"]
    launches["blockwise_argmax"] += (hybrid_nocache["blockwise_argmax"]
                                     + hybrid_cached["blockwise_argmax"])
    # the VLM's and the encoder-decoder's spec runs (flash no-cache and
    # for the encoder and cross-attention, paged cached, the argmax)
    for name in ("paged_attention", "blockwise_argmax"):
        launches[name] += vlm_launches[name] + encdec_launches[name]
    # the compile_steps phase's steps (paged, the argmax; flash and its
    # backward in the train step; the int8 parts' paged, argmax and, in
    # their tree-span forwards, tree)
    for name in ("paged_attention", "blockwise_argmax"):
        launches[name] += compile_launches[name]
    tree_launches["tree_attention"] += compile_launches["tree_attention"]
    # the train phase's serves of the bench pair (paged, the argmax, tree;
    # flash below) and its no-grad Mamba-2 forward (SSD)
    for name in ("paged_attention", "blockwise_argmax"):
        launches[name] += train_launches[name]
    tree_launches["tree_attention"] += train_launches["tree_attention"]
    head = next(c for c in att if c["headline"])
    tree_head = next(c for c in tree_cases if c["headline"])
    fl_head = next(c for c in fl_cases if c["headline"])

    def int8_record(cases, kernel):
        """The ``int8_kv`` record of a kernel's entry: the headline int8
        case, the largest error of its int8 cases, and its launches over
        int8 caches on the main path (the compile_steps int8 parts; also
        counted in the entry's ``launches``)."""
        h = next(c for c in cases if c["headline"])
        return {"geometry": h["geometry"], "kind": h["kind"], "Q": h["Q"],
                "dtype": h["dtype"], "ms": h["kernel_ms"],
                "float_kernel_ms": h["float_kernel_ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": h["library_ms"],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "launches": compile_int8[kernel]}
    bwd_head = next(c for c in bwd_cases if c["headline"])
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:87",
         "launches": launches["paged_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in att + chunk_cases
                            + ring_cases + hy_paged + ve_paged
                            + pair_cases["paged"] + kv8["paged"]
                            + tp_cases["paged"]),
         "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": head["library_ms"],
         "int8_kv": int8_record(kv8["paged"], "paged_attention")},
        {"name": "blockwise_argmax", "route": "cuda",
         "source": "src/repro_torch/csrc/spec_verify.cu",
         "replaces": "src/repro/kernels/spec_verify.py:42",
         "launches": launches["blockwise_argmax"],
         "max_abs_err": max(c["max_abs_err"] for c in [arg, hy_arg] + ve_arg),
         "ms": arg["kernel_ms"],
         "plain_ms": arg["plain_ms"], "bound_ms": arg["bound_ms"],
         "bound_by": arg["bound_by"], "library_ms": arg["library_ms"]},
        {"name": "tree_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/tree_attention.py:95",
         "launches": tree_launches["tree_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in tree_cases
                            + pair_cases["tree"] + kv8["tree"]
                            + tp_cases["tree"]),
         "ms": tree_head["kernel_ms"], "plain_ms": tree_head["plain_ms"],
         "bound_ms": tree_head["bound_ms"], "bound_by": tree_head["bound_by"],
         "library_ms": tree_head["library_ms"],
         "int8_kv": int8_record(kv8["tree"], "tree_attention")},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:69",
         "launches": (nocache["launches"]["flash_attention"]
                      + sampled_launches["flash_attention"]
                      + granite_launches["flash_attention"]
                      + hybrid_nocache["flash_attention"]
                      + vlm_launches["flash_attention"]
                      + encdec_launches["flash_attention"]
                      + train_launches["flash_attention"]
                      + compile_launches["flash_attention"]),
         "max_abs_err": max(c["max_abs_err"] for c in fl_cases + hy_flash
                            + ve_flash + pair_cases["flash"]
                            + tp_cases["flash"]),
         "ms": fl_head["kernel_ms"], "plain_ms": fl_head["plain_ms"],
         "bound_ms": fl_head["bound_ms"], "bound_by": fl_head["bound_by"],
         "library_ms": fl_head["library_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:69",
         "note": "the gradient of that kernel's function; JAX trains through "
                 "its jnp attention and has no backward kernel",
         "launches": (train_launches["flash_attention_bwd"]
                      + compile_launches["flash_attention_bwd"]),
         "max_abs_err": max(c["max_abs_err"]
                            for c in bwd_cases + pair_cases["flash_bwd"]),
         "ms": bwd_head["kernel_ms"], "plain_ms": bwd_head["plain_ms"],
         "bound_ms": bwd_head["bound_ms"], "bound_by": bwd_head["bound_by"],
         "library_ms": bwd_head["library_ms"]},
    ]
    for name, src, replaces, n, cases in (
            ("int8_matmul", "int8_matmul.cu", "int8_matmul.py:40",
             w8a8_launches["int8_matmul"], i8),
            ("ssd_scan", "ssd_scan.cu", "ssd_scan.py:67",
             ssm_launches["ssd_scan"] + ssm_cached["ssd_scan"]
             + train_launches["ssd_scan"], ssd)):
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
