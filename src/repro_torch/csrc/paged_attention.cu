// Paged flash attention over a KV block pool, for Hopper (sm_90a), with two
// mask policies: causal (paged_attention_fwd) and tree (tree_attention_fwd).
//
// Causal replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_flash_attention, pallas_call at :132). Same function: GQA attention
// of Q query rows per sequence, at positions index..index+Q-1, over a
// [NB, BS, Kv, D] block pool whose block ids are read from the row's block
// table inside the kernel; causal, optional sliding window, softmax in fp32
// with NEG_INF = -1e30 masking, a 1e-30 denominator floor, scale D**-0.5
// and the per-row live bound min(ceil((idx+Q)/BS), ceil(max_live/BS)) pages.
//
// Tree replaces src/repro/kernels/tree_attention.py (tree_flash_attention,
// pallas_call at :161): the same walk for a stacked tree-verify span of
// Q = span <= 31 query slots written at index..index+span-1. Slot s sits at
// RoPE position index + depths[s]; a committed-prefix key (kv_pos < index)
// is causal (+ window), an in-span key at rel = kv_pos - index is visible
// iff bit rel of the slot's int32 ancestor mask bits[s] is set, and keys
// beyond the span are never visible. The wrapper has already folded the
// window's span side into bits. depths/bits are [span] device arrays read
// by slot (the TPU version pre-expands them to rows to avoid a gather).
//
// What bounds it on the H100: at decode and verify (Q = 1, gamma+1 or a
// tree span; 3 to 93 (position, group) rows) a call reads each live KV
// page once per kv-head — well under a MB at the serving path's contexts,
// < 1 us at 3.35 TB/s — and does 4*D flops per visible (query head, key)
// pair, far less. Neither bound is near: the call is bound by latency —
// the launch, two dependent trips to device memory (the block table, then
// the pages it names) and the chain of products and softmax after them.
// At prefill (Q up to 128) the pairs grow with Q and the tensor-core work
// grows with them.
//
// bf16 design (the full-width serving path's type), the answer to latency:
//  * split KV over fixed key chunks (flash-decoding): one block per (tile
//    of 16 query rows, chunk of kChunk = 64 keys counted from key 0,
//    kv-head, batch row), so a decode call of 4 rows and 8 kv-heads at B=4
//    over <= 256 keys runs 4 * 8 * 4 = 128 blocks rather than 32 that each
//    walk every page. Each block writes its chunk's fp32 partial (row max
//    m, sum l, weighted values acc) to a workspace; a second kernel
//    (paged_combine_kernel) merges a row's partials in chunk order. It is
//    a programmatic dependent launch: its launch overlaps the chunk kernel
//    and it waits for the partials on the card (griddepcontrol.wait).
//    Blocks whose chunk starts past the row's live bound return at once;
//    the grid is sized by the table width MB * BS, which the host knows
//    without a sync;
//  * the gathers are 16-byte cp.async straight from the pool into shared
//    memory: each 16-byte piece of a key takes its address from its own
//    page's block-table entry, so any block size works. Rows on the NULL
//    block 0 read block 0; block ids are clamped into the pool; keys past
//    the live bound are zero-filled and masked. K and V go in two commit
//    groups, so QK^T and the softmax run while V is in flight (one chunk
//    per block: a ring of slabs, as in flash_attention.cu, would have
//    nothing to overlap);
//  * QK^T and PV run on the tensor cores, mma.sync.m16n8k16 bf16 -> fp32,
//    as in flash_attention.cu: Q and K by ldmatrix, V by ldmatrix.trans,
//    16-byte XOR swizzles; QK^T's C fragment is PV's A fragment, so P goes
//    to bf16 in registers. Queries stay on the M side at every Q: at
//    decode 12 (1B) or 13 (3B) of the 16 rows are padding, but the tensor
//    cores are not what bounds the call, and keys on the M side (S^T =
//    K Q^T) would need another fragment path for the verify and prefill
//    rows — and a row's arithmetic must not change with Q (below);
//  * the softmax stays in registers: a row lives in a quad, its max and
//    sum are two shuffles each, exp2 by ex2.approx on scores pre-scaled by
//    D**-0.5 * log2(e). Each of the 4 warps computes the whole 16 x 64
//    score tile (the same instructions, so the same bits) and then its own
//    quarter of the output columns: no shared-memory exchange and one
//    barrier per commit group.
//
// Exactness. A row's output does not depend on Q, on its row tile, on its
// batch mates or on the card: every bf16 call reduces a row's keys in the
// same 64-key chunks from key 0, in the same in-chunk order, and merges
// them in chunk order with weights exp2(m_c - M) that are exactly 1 where
// m_c is the row's max (an explicit compare: ex2.approx(0) need not be 1).
// A chunk fully masked for a row has m_c = -1e30 and weight exactly 0, and
// a masked key has weight exactly 0 in its chunk, so the extra chunk and
// keys a Q = 5 verify walks past a row's position add exactly 0: the rows
// it shares with a Q = 1 call at the same positions are bit-equal, and a
// width-1 tree equals the causal call bit for bit (chip_smoke.py checks
// both on the card). Nothing in the arithmetic switches on Q, and nothing
// assumes index == 0 at large Q.
//
// fp32 (the smoke models' type, exactness phases only) keeps the first
// port's CUDA-core body: one block per (16-row tile, kv-head, row) walks every
// live page with an online softmax in shared memory, scalar loads, fp32
// math. TF32 or bf16 products would miss the plain version's 1e-4.
//
// Head dims 32 and 48 (the repo's own trained pair: benchmarks/common.py),
// 64, 128 and 256 (RecurrentGemma's). An fp32 row's columns go to gcd(D,
// 128) threads: two columns a thread at D = 256, three at D = 48. The bf16
// block's Q tile, K and V take dynamic shared memory (16 + 2 * 64 rows of
// 512 B at D = 256: 72 KB). The output's D / 16 pairs of n8 tiles (one
// ldmatrix.x4.trans of V each) go to the 4 warps in runs of ceil(D / 64):
// a quarter of the columns each at 64, 128 and 256; at D = 48 warps 0-2
// take one pair and warp 3 none, at D = 32 warps 0-1 one pair. Below 64 a
// shared row is padded to 128 bytes, so the XOR swizzle of its 16-byte
// chunks (4 at D = 32, 6 at D = 48; no XOR closes on 0..5) stays inside
// the row and an ldmatrix phase's 8 rows still hit 8 distinct bank groups;
// the padding is never loaded or read. None of this touches a row's
// arithmetic, so the exactness above holds at every D. The tree policy
// takes 32 to 128: no model with D = 256 runs tree rounds.
//
// int8 pools (an int8 KV cache: repro_torch/cache/kv_cache.py stores
// round(x / 0.05) clamped to [-128, 127]). JAX sends an int8 pool to its
// jnp oracle; here both policies and both bodies are instantiated over the
// pool's type KV as well as over q's: fp32 or bf16 q over a pool of q's
// type (the code above, unchanged instruction for instruction) or over an
// int8 pool. An int8 key is staged as _from_buf makes it: fp32(x) * 0.05f
// (kKvInt8Scale, KV_INT8_SCALE's fp32 value), rounded to q's type. Where
// the optional fresh_k / fresh_v ([B, Q, Kv, D], q's type) cover the key
// (index <= key < index + Q), it is staged from there instead, unquantized:
// a Q > 1 read of an int8 ring sees the call's own K/V as JAX's
// [old buffer ++ new tokens] concat does. The bf16 body stages an int8
// chunk synchronously (an 8-byte load per 16-byte swizzled piece, converted
// and stored to the same slot), so it gives up the K/V commit-group overlap;
// the fp32 body reads 4 int8 columns a load. From the staging barrier on,
// scores, softmax, PV and the combine are the float body's. So an int8
// call equals, bit for bit, the float kernel of q's type over the
// dequantized pool with fresh written at its positions, and the Q and
// policy invariance above hold for it too. What bounds an int8
// call: half the K/V bytes of bf16 (a quarter of fp32), and at decode it is
// still latency bound, as above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kKvInt8Scale = 0.05f;   // cache/kv_cache.py: KV_INT8_SCALE

// an int8 pool's value as _from_buf makes it in fp32
__device__ __forceinline__ float dequant(int8_t x) {
  return static_cast<float>(x) * kKvInt8Scale;
}

// the keys a row's walk covers: whole pages, at least one, at most the
// table's MB, capped by max_live when given
__device__ __forceinline__ int live_keys(const int* __restrict__ index,
                                         const int* __restrict__ max_live, int b,
                                         int Q, int BS, int MB) {
  int live = min(max((index[b] + Q + BS - 1) / BS, 1), MB);
  if (max_live != nullptr) live = min(live, min(max((*max_live + BS - 1) / BS, 1), MB));
  return live * BS;
}

// ------------------------------------------------------------ fp32 kernel
constexpr int kF32Threads = 128;
constexpr int kF32Rows = 16;

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// KV: float (a pool of q's type) or int8_t (an int8 pool, read with fresh_k /
// fresh_v where they cover the key; both null on a float pool)
template <int D, bool kTree, typename KV>
__global__ void __launch_bounds__(kF32Threads)
paged_attention_f32_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
                           const KV* __restrict__ v_pool,
                           const int* __restrict__ block_table,
                           const int* __restrict__ index,
                           const int* __restrict__ max_live,
                           float* __restrict__ out, int Q, int H, int Kv, int NB,
                           int BS, int MB, int window, float scale,
                           const int* __restrict__ depths,
                           const int* __restrict__ bits,
                           const float* __restrict__ fresh_k,
                           const float* __restrict__ fresh_v) {
  constexpr int DP = D + 1;                       // padded shared row stride
  // the threads that share a row's columns; each owns kCols of them
  constexpr int kColThreads = gcd(D, kF32Threads);  // 32, 16, 64, 128, 128
  constexpr int kRowsPerPass = kF32Threads / kColThreads;   // 4, 8, 2, 1, 1
  constexpr int kCols = D / kColThreads;                     // 1, 3, 1, 1, 2
  constexpr int kAcc = kF32Rows / kRowsPerPass;   // rows per thread
  static_assert(kF32Threads % kColThreads == 0 && D % kColThreads == 0 &&
                kF32Rows % kRowsPerPass == 0, "threads must own whole rows");

  const int row0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int gq = H / Kv;
  const int n_rows = Q * gq;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kF32Rows][DP]
  float* k_s = q_s + kF32Rows * DP;    // [BS][DP]
  float* v_s = k_s + BS * DP;          // [BS][DP]
  float* p_s = v_s + BS * DP;          // [kF32Rows][BS] scores, then probs
  // the tree policy adds, after p_s, each row's query position and ancestor
  // mask ([kF32Rows] ints each)
  __shared__ float m_s[kF32Rows], l_s[kF32Rows], a_s[kF32Rows];

  const int idx_b = index[b];
  const int live = live_keys(index, max_live, b, Q, BS, MB) / BS;

  // rows of the tile are (query position, group) pairs, r = qi * gq + g
  for (int e = tid; e < kF32Rows * D; e += kF32Threads) {
    const int r = e / D, d = e % D;
    const int rg = row0 + r;
    float x = 0.f;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      x = q[((static_cast<size_t>(b) * Q + qi) * H + h * gq + g) * D + d];
    }
    q_s[r * DP + d] = x;
  }
  if (tid < kF32Rows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    if constexpr (kTree) {
      // rows are (slot, group): r = s * gq + g; padded rows see the prefix
      int* qpos_s = reinterpret_cast<int*>(p_s + kF32Rows * BS);
      unsigned* bits_s = reinterpret_cast<unsigned*>(qpos_s + kF32Rows);
      const int rg = row0 + tid;
      const bool real = rg < n_rows;
      qpos_s[tid] = idx_b + (real ? depths[rg / gq] : 0);
      bits_s[tid] = real ? static_cast<unsigned>(bits[rg / gq]) : 0u;
    }
  }

  const int d_own = tid % kColThreads;   // columns d_own + c * kColThreads
  const int r_own = tid / kColThreads;
  float acc[kAcc][kCols];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int* tbl = block_table + static_cast<size_t>(b) * MB;
  for (int j = 0; j < live; ++j) {
    const int blk = min(max(tbl[j], 0), NB - 1);
    __syncthreads();   // the previous step is done with k_s, v_s and p_s
    if constexpr (sizeof(KV) == 1) {
      // 4 columns a thread: one 4-byte load of each pool, dequantized, or
      // the 4 values of fresh where it covers the key
      for (int e = tid; e < BS * D / 4; e += kF32Threads) {
        const int s = e / (D / 4), d = (e % (D / 4)) * 4;
        const int rel = j * BS + s - idx_b;
        float kx[4], vx[4];
        if (fresh_k != nullptr && rel >= 0 && rel < Q) {
          const size_t f = ((static_cast<size_t>(b) * Q + rel) * Kv + h) * D + d;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            kx[c] = fresh_k[f + c];
            vx[c] = fresh_v[f + c];
          }
        } else {
          const size_t off = ((static_cast<size_t>(blk) * BS + s) * Kv + h) * D + d;
          const char4 kc = *reinterpret_cast<const char4*>(k_pool + off);
          const char4 vc = *reinterpret_cast<const char4*>(v_pool + off);
          kx[0] = dequant(kc.x), kx[1] = dequant(kc.y), kx[2] = dequant(kc.z), kx[3] = dequant(kc.w);
          vx[0] = dequant(vc.x), vx[1] = dequant(vc.y), vx[2] = dequant(vc.z), vx[3] = dequant(vc.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          k_s[s * DP + d + c] = kx[c];
          v_s[s * DP + d + c] = vx[c];
        }
      }
    } else {
      for (int e = tid; e < BS * D; e += kF32Threads) {
        const int s = e / D, d = e % D;
        const size_t off = ((static_cast<size_t>(blk) * BS + s) * Kv + h) * D + d;
        k_s[s * DP + d] = k_pool[off];
        v_s[s * DP + d] = v_pool[off];
      }
    }
    __syncthreads();

    // masked, scaled scores
    for (int e = tid; e < kF32Rows * BS; e += kF32Threads) {
      const int r = e / BS, s = e % BS;
      const float* qr = q_s + r * DP;
      const float* ks = k_s + s * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[d], dot);
      if constexpr (kTree) {
        const int* qpos_s = reinterpret_cast<const int*>(p_s + kF32Rows * BS);
        const unsigned* bits_s = reinterpret_cast<const unsigned*>(qpos_s + kF32Rows);
        const int q_pos = qpos_s[r];
        const int kv_pos = j * BS + s;
        const int rel = kv_pos - idx_b;
        bool visible;
        if (rel < 0) {
          visible = q_pos >= kv_pos;
          if (window > 0) visible = visible && (q_pos - kv_pos) < window;
        } else {
          visible = rel < Q && ((bits_s[r] >> rel) & 1u);
        }
        p_s[r * BS + s] = visible ? dot * scale : kNegInf;
      } else {
        const int q_pos = idx_b + (row0 + r) / gq;
        const int kv_pos = j * BS + s;
        bool visible = q_pos >= kv_pos;
        if (window > 0) visible = visible && abs(q_pos - kv_pos) < window;
        p_s[r * BS + s] = visible ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per row
    if (tid < kF32Rows) {
      float* pr = p_s + tid * BS;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int s = 0; s < BS; ++s) m_new = fmaxf(m_new, pr[s]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int s = 0; s < BS; ++s) {
        const float p = expf(pr[s] - m_new);
        pr[s] = p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r_own + i * kRowsPerPass;
      const float* pr = p_s + r * BS;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = d_own + c * kColThreads;
        float pv = 0.f;
        for (int s = 0; s < BS; ++s) pv = fmaf(pr[s], v_s[s * DP + d], pv);
        acc[i][c] = acc[i][c] * a_s[r] + pv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r_own + i * kRowsPerPass;
    const int rg = row0 + r;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      const float den = fmaxf(l_s[r], 1e-30f);
      float* const dst = out + ((static_cast<size_t>(b) * Q + qi) * H + h * gq + g) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) dst[d_own + c * kColThreads] = acc[i][c] / den;
    }
  }
}

// ------------------------------------------------------------ bf16 kernels
constexpr int kChunk = 64;          // keys per chunk, counted from key 0
constexpr int kRows = 16;           // query rows per block: one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 int8 pool values (8 bytes, element 0 in the low byte) -> 8 bf16 as
// _from_buf makes them: fp32(x) * 0.05f rounded to nearest even
__device__ __forceinline__ uint4 dequant8(uint2 raw) {
  const uint32_t w[2] = {raw.x, raw.y};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = w[i >> 1];
    const int sh = (i & 1) * 16;
    o[i] = pack_bf16(dequant(static_cast<int8_t>((word >> sh) & 0xffu)),
                     dequant(static_cast<int8_t>((word >> (sh + 8)) & 0xffu)));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// bytes of one shared row of a D-wide bf16 tile: D * 2, padded to 128 (8
// 16-byte pieces) below D = 64 so the swizzle below stays inside the row
template <int D>
__host__ __device__ constexpr int row_bytes() {
  static_assert(D % 16 == 0, "a row is whole k16 steps and n8 tile pairs");
  return D < 64 ? 128 : D * 2;
}

// byte offset of 16-byte piece `ch` of row `r` in a tile of D-wide bf16
// rows, XOR-swizzled by the row's low 3 bits (8 rows of one ldmatrix phase
// land on 8 distinct bank groups)
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * row_bytes<D>() + ((ch ^ (r & 7)) << 4));
}

template <int D>
constexpr int bf16_smem_bytes() {
  return (kRows + 2 * kChunk) * row_bytes<D>();   // the Q tile, the chunk's K and V
}

// The workspace of a split call: acc [B, Kv, n_rows, n_chunks, D] fp32,
// then (m, l) [B, Kv, n_rows, n_chunks] as float2; m in log2 units.
// KV: __nv_bfloat16 (a pool of q's type) or int8_t (an int8 pool, with
// fresh_k / fresh_v as in the fp32 kernel).
template <int D, bool kTree, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const KV* __restrict__ k_pool,
                            const KV* __restrict__ v_pool,
                            const int* __restrict__ block_table,
                            const int* __restrict__ index,
                            const int* __restrict__ max_live,
                            float* __restrict__ ws, int Q, int H, int Kv, int NB,
                            int BS, int MB, int n_chunks, int window,
                            float scale_log2, const int* __restrict__ depths,
                            const int* __restrict__ bits,
                            const __nv_bfloat16* __restrict__ fresh_k,
                            const __nv_bfloat16* __restrict__ fresh_v) {
  constexpr int CH = D / 8;                     // 16-byte pieces per row
  constexpr int KT = D / 16;                    // k16 steps of QK^T
  // the output's pairs of n8 tiles (one ldmatrix.x4.trans of V each); warp
  // w owns pairs [w kPW, (w + 1) kPW) that are below NP
  constexpr int NP = D / 16;
  constexpr int kPW = (NP + kWarps - 1) / kWarps;
  constexpr int kCopies = kChunk * CH / kThreads;   // K (or V) pieces per thread
  static_assert(kPW * kWarps >= NP, "every pair of output tiles has a warp");
  static_assert(kChunk * CH % kThreads == 0, "whole K/V pieces per thread");

  // dynamic: 72 KB at D = 256 (bf16_smem_bytes), past the 48 KB of static
  extern __shared__ __align__(128) unsigned char bf16_smem[];
  unsigned char* const q_s = bf16_smem;                         // [kRows][D]
  unsigned char* const k_s = q_s + kRows * row_bytes<D>();      // [kChunk][D]
  unsigned char* const v_s = k_s + kChunk * row_bytes<D>();     // [kChunk][D]

  // the combine may be scheduled now; its griddepcontrol.wait still waits
  // for this whole grid to finish and its writes to land
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int c = blockIdx.x % n_chunks;
  const int row0 = (blockIdx.x / n_chunks) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gq = H / Kv;
  const int n_rows = Q * gq;
  const int key0 = c * kChunk;

  // the pages of this thread's K/V pieces, read before the live bound is
  // known so the table and the index are one trip to device memory, not two
  const int* tbl = block_table + static_cast<size_t>(b) * MB;
  size_t off[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = tid + i * kThreads;
    const int key = key0 + e / CH;
    off[i] = 0;
    if (key < MB * BS) {
      const int blk = min(max(tbl[key / BS], 0), NB - 1);
      off[i] = ((static_cast<size_t>(blk) * BS + key % BS) * Kv + h) * D + (e % CH) * 8;
    }
  }
  const int live = live_keys(index, max_live, b, Q, BS, MB);
  if (key0 >= live) return;                     // the whole block: past the walk
  const int idx_b = index[b];

  // group 0: the Q tile and the chunk's K; group 1: its V (an int8 pool:
  // group 0 the Q tile, K and V staged by plain loads, group 1 empty)
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, ch = e % CH;
    const int rg = row0 + r;
    const bool ok = rg < n_rows;
    size_t q_off = 0;
    if (ok) {
      const int qi = rg / gq, gg = rg % gq;
      q_off = ((static_cast<size_t>(b) * Q + qi) * H + h * gq + gg) * D + ch * 8;
    }
    cp_async16(smem_u32(q_s + swz<D>(r, ch)), q + q_off, ok);
  }
  if constexpr (sizeof(KV) == 1) {
    cp_async_commit();
    // each 16-byte piece (8 keys' columns) from an 8-byte int8 load,
    // dequantized, or from fresh where it covers the key; zero past the walk
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / CH, ch = e % CH;
      const int key = key0 + s;
      uint4 kc = make_uint4(0u, 0u, 0u, 0u), vc = kc;
      if (key < live) {
        const int rel = key - idx_b;
        if (fresh_k != nullptr && rel >= 0 && rel < Q) {
          const size_t f = ((static_cast<size_t>(b) * Q + rel) * Kv + h) * D + ch * 8;
          kc = *reinterpret_cast<const uint4*>(fresh_k + f);
          vc = *reinterpret_cast<const uint4*>(fresh_v + f);
        } else {
          kc = dequant8(*reinterpret_cast<const uint2*>(k_pool + off[i]));
          vc = dequant8(*reinterpret_cast<const uint2*>(v_pool + off[i]));
        }
      }
      *reinterpret_cast<uint4*>(k_s + swz<D>(s, ch)) = kc;
      *reinterpret_cast<uint4*>(v_s + swz<D>(s, ch)) = vc;
    }
    cp_async_commit();
  } else {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / CH, ch = e % CH;
      cp_async16(smem_u32(k_s + swz<D>(s, ch)), k_pool + off[i], key0 + s < live);
    }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / CH, ch = e % CH;
      cp_async16(smem_u32(v_s + swz<D>(s, ch)), v_pool + off[i], key0 + s < live);
    }
    cp_async_commit();
  }

  // this thread's two rows (g and g + 8): query position and, for the
  // tree, ancestor mask; padded rows see the prefix and are never stored
  int q_pos[2];
  unsigned anc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rg = row0 + g + 8 * hh;
    if constexpr (kTree) {
      const bool real = rg < n_rows;
      q_pos[hh] = idx_b + (real ? depths[rg / gq] : 0);
      anc[hh] = real ? static_cast<unsigned>(bits[rg / gq]) : 0u;
    } else {
      q_pos[hh] = idx_b + rg / gq;
      anc[hh] = 0u;
    }
  }

  cp_async_wait<1>();
  __syncthreads();   // Q and K have landed

  // S = Q K^T, 16 rows x 64 keys: n8 tile n = keys key0 + 8n ..
  const int mi = lane >> 3;
  float sc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    uint32_t qa[4];
    ldsm_x4(qa, smem_u32(q_s + swz<D>((mi & 1) * 8 + (lane & 7), 2 * s + (mi >> 1))));
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t kb[4];
      const int key = 16 * p + (mi >> 1) * 8 + (lane & 7);
      ldsm_x4(kb, smem_u32(k_s + swz<D>(key, 2 * s + (mi & 1))));
      mma_bf16(sc[2 * p], qa, kb[0], kb[1]);
      mma_bf16(sc[2 * p + 1], qa, kb[2], kb[3]);
    }
  }

  // scale into log2 units and mask
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kv_pos = key0 + 8 * n + 2 * t + (e & 1);
      const int qp = q_pos[e >> 1];
      bool visible;
      if constexpr (kTree) {
        const int rel = kv_pos - idx_b;
        if (rel < 0) {
          visible = qp >= kv_pos && (window <= 0 || qp - kv_pos < window);
        } else {
          visible = rel < Q && ((anc[e >> 1] >> rel) & 1u);
        }
      } else {
        visible = qp >= kv_pos && (window <= 0 || qp - kv_pos < window);
      }
      visible = visible && kv_pos < live;
      sc[n][e] = visible ? sc[n][e] * scale_log2 : kNegInf;
    }

  // the chunk's softmax, per row: the quad (4 lanes) holds its 64 scores
  float m_r[2], l_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * hh], sc[n][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = fast_exp2(sc[n][2 * hh] - mx);
      const float p1 = fast_exp2(sc[n][2 * hh + 1] - mx);
      sc[n][2 * hh] = p0;
      sc[n][2 * hh + 1] = p1;
      sum += p0 + p1;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m_r[hh] = mx;
    l_r[hh] = sum;
  }

  cp_async_wait<0>();
  __syncthreads();   // V has landed

  // O = P V for this warp's output columns: n8 tiles 2p, 2p + 1 of its
  // pairs p; P (bf16, from the C fragments) is the A operand, k16 step kk
  // = keys key0 + 16kk ..
  float o[2 * kPW][4];
#pragma unroll
  for (int i = 0; i < 2 * kPW; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
    pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
    pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
    pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
    for (int pp = 0; pp < kPW; ++pp) {
      const int p = warp * kPW + pp;
      if (p >= NP) break;
      uint32_t vb[4];
      const int key = 16 * kk + (mi & 1) * 8 + (lane & 7);
      ldsm_x4_trans(vb, smem_u32(v_s + swz<D>(key, 2 * p + (mi >> 1))));
      mma_bf16(o[2 * pp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * pp + 1], pa, vb[2], vb[3]);
    }
  }

  // the chunk's partial: acc by every warp (its columns), (m, l) by warp 0
  const size_t n_part = static_cast<size_t>(gridDim.z) * Kv * n_rows * n_chunks;
  float2* const ml = reinterpret_cast<float2*>(ws + n_part * D);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rg = row0 + g + 8 * hh;
    if (rg >= n_rows) continue;
    const size_t slot = ((static_cast<size_t>(b) * Kv + h) * n_rows + rg) * n_chunks + c;
    float* const dst = ws + slot * D + warp * kPW * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2 * kPW; ++i)
      if (warp * kPW + i / 2 < NP)
        *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
    if (warp == 0 && t == 0) ml[slot] = make_float2(m_r[hh], l_r[hh]);
  }
}

// Merges each row's chunk partials in chunk order: M = the largest m_c,
// weights w_c = exp2(m_c - M), exactly 1 where m_c == M; out = sum w_c acc_c
// / max(sum w_c l_c, 1e-30). One thread per (row, d).
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws, const int* __restrict__ index,
                     const int* __restrict__ max_live,
                     __nv_bfloat16* __restrict__ out, int Q, int H, int Kv,
                     int BS, int MB, int n_chunks) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int gq = H / Kv;
  const int n_rows = Q * gq;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int r = e / D, d = e % D;
  if (r >= n_rows) return;
  const int chunks = (live_keys(index, max_live, b, Q, BS, MB) + kChunk - 1) / kChunk;
  // launched early (programmatic dependent launch): wait for the chunk
  // kernel's partials
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t n_part = static_cast<size_t>(gridDim.z) * Kv * n_rows * n_chunks;
  const size_t row = ((static_cast<size_t>(b) * Kv + h) * n_rows + r) * n_chunks;
  const float2* const ml = reinterpret_cast<const float2*>(ws + n_part * D) + row;
  const float* const acc = ws + row * D + d;
  float M = kNegInf;
  for (int c = 0; c < chunks; ++c) M = fmaxf(M, ml[c].x);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float2 part = ml[c];
    const float w = part.x == M ? 1.f : fast_exp2(part.x - M);
    L = fmaf(w, part.y, L);
    A = fmaf(w, acc[static_cast<size_t>(c) * D], A);
  }
  const int qi = r / gq, gg = r % gq;
  out[((static_cast<size_t>(b) * Q + qi) * H + h * gq + gg) * D + d] =
      __float2bfloat16(A / fmaxf(L, 1e-30f));
}

template <int D, bool kTree, typename KV>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const void* block_table, const void* index, const void* max_live,
               const void* depths, const void* bits, const void* fresh_k,
               const void* fresh_v, void* out, int B, int Q, int H, int Kv,
               int NB, int BS, int MB, int window, float scale,
               cudaStream_t stream) {
  constexpr int DP = D + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kF32Rows) * DP + 2 * static_cast<size_t>(BS) * DP +
                       static_cast<size_t>(kF32Rows) * BS) +
      (kTree ? 2 * sizeof(int) * kF32Rows : 0);
  auto kernel = paged_attention_f32_kernel<D, kTree, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gq = H / Kv;
  const dim3 grid((Q * gq + kF32Rows - 1) / kF32Rows, Kv, B);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(index), static_cast<const int*>(max_live),
      static_cast<float*>(out), Q, H, Kv, NB, BS, MB, window, scale,
      static_cast<const int*>(depths), static_cast<const int*>(bits),
      static_cast<const float*>(fresh_k), static_cast<const float*>(fresh_v));
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kTree, typename KV>
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const void* block_table, const void* index, const void* max_live,
                const void* depths, const void* bits, const void* fresh_k,
                const void* fresh_v, void* out, void* ws, int B, int Q, int H,
                int Kv, int NB, int BS, int MB, int n_chunks, int window,
                float scale, cudaStream_t stream) {
  const int n_rows = Q * (H / Kv);
  const long long blocks_x =
      static_cast<long long>((n_rows + kRows - 1) / kRows) * n_chunks;
  if (n_chunks != (MB * BS + kChunk - 1) / kChunk || blocks_x > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = bf16_smem_bytes<D>();
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_bf16_kernel<D, kTree, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  paged_attention_bf16_kernel<D, kTree, KV><<<dim3(static_cast<unsigned>(blocks_x), Kv, B),
                                              kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(index), static_cast<const int*>(max_live),
      static_cast<float*>(ws), Q, H, Kv, NB, BS, MB, n_chunks, window,
      scale * kLog2e, static_cast<const int*>(depths), static_cast<const int*>(bits),
      static_cast<const __nv_bfloat16*>(fresh_k), static_cast<const __nv_bfloat16*>(fresh_v));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the combine as a programmatic dependent launch: its launch overlaps the
  // chunk kernel, and it waits on the card (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows * D + kThreads - 1) / kThreads, Kv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, paged_combine_kernel<D>, static_cast<const float*>(ws),
      static_cast<const int*>(index), static_cast<const int*>(max_live),
      static_cast<__nv_bfloat16*>(out), Q, H, Kv, BS, MB, n_chunks));
}

// one body's instantiation at head dim D (the tree policy takes 32 to 128)
template <bool kTree, typename KV>
int dispatch_f32(const void* q, const void* k_pool, const void* v_pool,
                 const void* block_table, const void* index, const void* max_live,
                 const void* depths, const void* bits, const void* fresh_k,
                 const void* fresh_v, void* out, int B, int Q, int H, int Kv, int D,
                 int NB, int BS, int MB, int window, float scale, cudaStream_t st) {
#define REPRO_PA_F32(DIM)                                                           \
  return launch_f32<DIM, kTree, KV>(q, k_pool, v_pool, block_table, index, max_live, \
                                    depths, bits, fresh_k, fresh_v, out, B, Q, H,   \
                                    Kv, NB, BS, MB, window, scale, st)
  if (D == 32) REPRO_PA_F32(32);
  if (D == 48) REPRO_PA_F32(48);
  if (D == 64) REPRO_PA_F32(64);
  if (D == 128) REPRO_PA_F32(128);
  if constexpr (!kTree) {
    if (D == 256) REPRO_PA_F32(256);
  }
#undef REPRO_PA_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kTree, typename KV>
int dispatch_bf16(const void* q, const void* k_pool, const void* v_pool,
                  const void* block_table, const void* index, const void* max_live,
                  const void* depths, const void* bits, const void* fresh_k,
                  const void* fresh_v, void* out, void* ws, int B, int Q, int H,
                  int Kv, int D, int NB, int BS, int MB, int n_chunks, int window,
                  float scale, cudaStream_t st) {
#define REPRO_PA_BF16(DIM)                                                           \
  return launch_bf16<DIM, kTree, KV>(q, k_pool, v_pool, block_table, index, max_live, \
                                     depths, bits, fresh_k, fresh_v, out, ws, B, Q,  \
                                     H, Kv, NB, BS, MB, n_chunks, window, scale, st)
  if (D == 32) REPRO_PA_BF16(32);
  if (D == 48) REPRO_PA_BF16(48);
  if (D == 64) REPRO_PA_BF16(64);
  if (D == 128) REPRO_PA_BF16(128);
  if constexpr (!kTree) {
    if (D == 256) REPRO_PA_BF16(256);
  }
#undef REPRO_PA_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: q's type (0 fp32, 1 bf16); kv_dtype: the pool's (dtype, or 2 =
// int8). fresh_k / fresh_v: null, or both given over an int8 pool.
template <bool kTree>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* index, const void* max_live,
             const void* depths, const void* bits, const void* fresh_k,
             const void* fresh_v, void* out, void* ws, int B, int Q, int H,
             int Kv, int D, int NB, int BS, int MB, int n_chunks, int window,
             float scale, int dtype, int kv_dtype, void* stream) {
  if (B < 1 || Q < 1 || Kv < 1 || H % Kv != 0 || BS < 1 || MB < 1 || NB < 1 ||
      Kv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8_pool = kv_dtype == 2;
  if ((kv_dtype != dtype && !int8_pool) || ((fresh_k != nullptr) != (fresh_v != nullptr)) ||
      (fresh_k != nullptr && !int8_pool))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n_chunks == 1) {
    if (int8_pool) {
      if ((reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) % 4 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
      return dispatch_f32<kTree, int8_t>(q, k_pool, v_pool, block_table, index, max_live,
                                         depths, bits, fresh_k, fresh_v, out, B, Q, H,
                                         Kv, D, NB, BS, MB, window, scale, st);
    }
    return dispatch_f32<kTree, float>(q, k_pool, v_pool, block_table, index, max_live,
                                      depths, bits, nullptr, nullptr, out, B, Q, H, Kv,
                                      D, NB, BS, MB, window, scale, st);
  }
  if (dtype == 1 && ws != nullptr) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
         reinterpret_cast<uintptr_t>(v_pool) | reinterpret_cast<uintptr_t>(ws) |
         reinterpret_cast<uintptr_t>(fresh_k) | reinterpret_cast<uintptr_t>(fresh_v)) %
            16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (int8_pool)
      return dispatch_bf16<kTree, int8_t>(q, k_pool, v_pool, block_table, index, max_live,
                                          depths, bits, fresh_k, fresh_v, out, ws, B, Q,
                                          H, Kv, D, NB, BS, MB, n_chunks, window, scale,
                                          st);
    return dispatch_bf16<kTree, __nv_bfloat16>(q, k_pool, v_pool, block_table, index,
                                               max_live, depths, bits, nullptr, nullptr,
                                               out, ws, B, Q, H, Kv, D, NB, BS, MB,
                                               n_chunks, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// D: 32, 48, 64, 128 or 256. dtype: q's (and out's) type, 0 = float32
// (n_chunks 1, ws unused), 1 = bfloat16 (n_chunks = ceil(MB * BS / 64); ws a
// 16-byte aligned fp32 workspace of B * Kv * Q * (H / Kv) * n_chunks * (D +
// 2) floats). kv_dtype: the pools' type, dtype or 2 = int8. fresh_k /
// fresh_v: null, or (int8 pools only) [B, Q, Kv, D] of q's type, read in
// place of the pool at positions index..index+Q-1 (16-byte aligned in
// bf16). window <= 0 means full causal. max_live may be null (no cap).
// Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_table,
                                   const void* index, const void* max_live,
                                   const void* fresh_k, const void* fresh_v,
                                   void* out, void* ws, int B, int Q, int H,
                                   int Kv, int D, int NB, int BS, int MB,
                                   int n_chunks, int window, float scale,
                                   int dtype, int kv_dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, block_table, index, max_live,
                         nullptr, nullptr, fresh_k, fresh_v, out, ws, B, Q, H, Kv,
                         D, NB, BS, MB, n_chunks, window, scale, dtype, kv_dtype,
                         stream);
}

// The tree policy: q/out [B, span, H, D]; depths/bits int32 [span] (bits
// already windowed on the span side); span <= 31; D 32, 48, 64 or 128;
// fresh_k / fresh_v [B, span, Kv, D] when given. Other arguments as above.
extern "C" int tree_attention_fwd(const void* q, const void* k_pool,
                                  const void* v_pool, const void* block_table,
                                  const void* index, const void* max_live,
                                  const void* depths, const void* bits,
                                  const void* fresh_k, const void* fresh_v,
                                  void* out, void* ws, int B, int span, int H,
                                  int Kv, int D, int NB, int BS, int MB,
                                  int n_chunks, int window, float scale,
                                  int dtype, int kv_dtype, void* stream) {
  if (span < 1 || span > 31) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k_pool, v_pool, block_table, index, max_live,
                        depths, bits, fresh_k, fresh_v, out, ws, B, span, H, Kv,
                        D, NB, BS, MB, n_chunks, window, scale, dtype, kv_dtype,
                        stream);
}
