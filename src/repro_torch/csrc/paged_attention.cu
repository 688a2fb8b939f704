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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

template <int D, bool kTree>
__global__ void __launch_bounds__(kF32Threads)
paged_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                           const float* __restrict__ v_pool,
                           const int* __restrict__ block_table,
                           const int* __restrict__ index,
                           const int* __restrict__ max_live,
                           float* __restrict__ out, int Q, int H, int Kv, int NB,
                           int BS, int MB, int window, float scale,
                           const int* __restrict__ depths,
                           const int* __restrict__ bits) {
  constexpr int DP = D + 1;                       // padded shared row stride
  constexpr int kRowsPerPass = kF32Threads / D;   // 1 (D=128) or 2 (D=64)
  constexpr int kAcc = kF32Rows / kRowsPerPass;   // acc registers per thread

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

  const int d_own = tid % D;
  const int r_own = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int* tbl = block_table + static_cast<size_t>(b) * MB;
  for (int j = 0; j < live; ++j) {
    const int blk = min(max(tbl[j], 0), NB - 1);
    __syncthreads();   // the previous step is done with k_s, v_s and p_s
    for (int e = tid; e < BS * D; e += kF32Threads) {
      const int s = e / D, d = e % D;
      const size_t off = ((static_cast<size_t>(blk) * BS + s) * Kv + h) * D + d;
      k_s[s * DP + d] = k_pool[off];
      v_s[s * DP + d] = v_pool[off];
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
      float pv = 0.f;
      for (int s = 0; s < BS; ++s) pv = fmaf(pr[s], v_s[s * DP + d_own], pv);
      acc[i] = acc[i] * a_s[r] + pv;
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
      out[((static_cast<size_t>(b) * Q + qi) * H + h * gq + g) * D + d_own] = acc[i] / den;
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

// byte offset of 16-byte piece `ch` of row `r` in a tile of D-wide bf16
// rows, XOR-swizzled by the row's low 3 bits (8 rows of one ldmatrix phase
// land on 8 distinct bank groups)
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * D * 2 + ((ch ^ (r & 7)) << 4));
}

// The workspace of a split call: acc [B, Kv, n_rows, n_chunks, D] fp32,
// then (m, l) [B, Kv, n_rows, n_chunks] as float2; m in log2 units.
template <int D, bool kTree>
__global__ void __launch_bounds__(kThreads)
paged_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_pool,
                            const __nv_bfloat16* __restrict__ v_pool,
                            const int* __restrict__ block_table,
                            const int* __restrict__ index,
                            const int* __restrict__ max_live,
                            float* __restrict__ ws, int Q, int H, int Kv, int NB,
                            int BS, int MB, int n_chunks, int window,
                            float scale_log2, const int* __restrict__ depths,
                            const int* __restrict__ bits) {
  constexpr int CH = D / 8;                     // 16-byte pieces per row
  constexpr int KT = D / 16;                    // k16 steps of QK^T
  constexpr int NTW = D / 8 / kWarps;           // this warp's n8 output tiles
  constexpr int kCopies = kChunk * CH / kThreads;   // K (or V) pieces per thread

  __shared__ __align__(128) unsigned char q_s[kRows * D * 2];
  __shared__ __align__(128) unsigned char k_s[kChunk * D * 2];
  __shared__ __align__(128) unsigned char v_s[kChunk * D * 2];

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

  // group 0: the Q tile and the chunk's K; group 1: its V
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

  // O = P V for this warp's output columns: n8 tiles warp * NTW ..; P
  // (bf16, from the C fragments) is the A operand, k16 step kk = keys
  // key0 + 16kk ..
  float o[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
    pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
    pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
    pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
    for (int pp = 0; pp < NTW / 2; ++pp) {
      uint32_t vb[4];
      const int p = warp * (NTW / 2) + pp;
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
    float* const dst = ws + slot * D + warp * NTW * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < NTW; ++i)
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

template <int D, bool kTree>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const void* block_table, const void* index, const void* max_live,
               const void* depths, const void* bits, void* out, int B, int Q,
               int H, int Kv, int NB, int BS, int MB, int window, float scale,
               cudaStream_t stream) {
  constexpr int DP = D + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kF32Rows) * DP + 2 * static_cast<size_t>(BS) * DP +
                       static_cast<size_t>(kF32Rows) * BS) +
      (kTree ? 2 * sizeof(int) * kF32Rows : 0);
  auto kernel = paged_attention_f32_kernel<D, kTree>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gq = H / Kv;
  const dim3 grid((Q * gq + kF32Rows - 1) / kF32Rows, Kv, B);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(index), static_cast<const int*>(max_live),
      static_cast<float*>(out), Q, H, Kv, NB, BS, MB, window, scale,
      static_cast<const int*>(depths), static_cast<const int*>(bits));
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kTree>
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const void* block_table, const void* index, const void* max_live,
                const void* depths, const void* bits, void* out, void* ws, int B,
                int Q, int H, int Kv, int NB, int BS, int MB, int n_chunks,
                int window, float scale, cudaStream_t stream) {
  const int n_rows = Q * (H / Kv);
  const long long blocks_x =
      static_cast<long long>((n_rows + kRows - 1) / kRows) * n_chunks;
  if (n_chunks != (MB * BS + kChunk - 1) / kChunk || blocks_x > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  paged_attention_bf16_kernel<D, kTree><<<dim3(static_cast<unsigned>(blocks_x), Kv, B),
                                          kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(index), static_cast<const int*>(max_live),
      static_cast<float*>(ws), Q, H, Kv, NB, BS, MB, n_chunks, window,
      scale * kLog2e, static_cast<const int*>(depths), static_cast<const int*>(bits));
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

template <bool kTree>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* index, const void* max_live,
             const void* depths, const void* bits, void* out, void* ws, int B,
             int Q, int H, int Kv, int D, int NB, int BS, int MB, int n_chunks,
             int window, float scale, int dtype, void* stream) {
  if (B < 1 || Q < 1 || Kv < 1 || H % Kv != 0 || BS < 1 || MB < 1 || NB < 1 ||
      Kv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n_chunks == 1) {
#define REPRO_PA_F32(DIM)                                                        \
  return launch_f32<DIM, kTree>(q, k_pool, v_pool, block_table, index, max_live, \
                                depths, bits, out, B, Q, H, Kv, NB, BS, MB,      \
                                window, scale, st)
    if (D == 64) REPRO_PA_F32(64);
    if (D == 128) REPRO_PA_F32(128);
#undef REPRO_PA_F32
  }
  if (dtype == 1 && ws != nullptr) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
         reinterpret_cast<uintptr_t>(v_pool) | reinterpret_cast<uintptr_t>(ws)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
#define REPRO_PA_BF16(DIM)                                                        \
  return launch_bf16<DIM, kTree>(q, k_pool, v_pool, block_table, index, max_live, \
                                 depths, bits, out, ws, B, Q, H, Kv, NB, BS, MB,  \
                                 n_chunks, window, scale, st)
    if (D == 64) REPRO_PA_BF16(64);
    if (D == 128) REPRO_PA_BF16(128);
#undef REPRO_PA_BF16
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (n_chunks 1, ws unused), 1 = bfloat16 (n_chunks =
// ceil(MB * BS / 64); ws a 16-byte aligned fp32 workspace of
// B * Kv * Q * (H / Kv) * n_chunks * (D + 2) floats). window <= 0 means full
// causal. max_live may be null (no cap). Returns a cudaError_t (0 =
// launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_table,
                                   const void* index, const void* max_live,
                                   void* out, void* ws, int B, int Q, int H,
                                   int Kv, int D, int NB, int BS, int MB,
                                   int n_chunks, int window, float scale,
                                   int dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, block_table, index, max_live,
                         nullptr, nullptr, out, ws, B, Q, H, Kv, D, NB, BS, MB,
                         n_chunks, window, scale, dtype, stream);
}

// The tree policy: q/out [B, span, H, D]; depths/bits int32 [span] (bits
// already windowed on the span side); span <= 31. Other arguments as above.
extern "C" int tree_attention_fwd(const void* q, const void* k_pool,
                                  const void* v_pool, const void* block_table,
                                  const void* index, const void* max_live,
                                  const void* depths, const void* bits,
                                  void* out, void* ws, int B, int span, int H,
                                  int Kv, int D, int NB, int BS, int MB,
                                  int n_chunks, int window, float scale,
                                  int dtype, void* stream) {
  if (span < 1 || span > 31) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k_pool, v_pool, block_table, index, max_live,
                        depths, bits, out, ws, B, span, H, Kv, D, NB, BS, MB,
                        n_chunks, window, scale, dtype, stream);
}
