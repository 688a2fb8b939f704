// Causal / sliding-window / non-causal GQA flash attention with no KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :87). Same function: q [B, Sq, H, D]
// against k/v [B, Skv, Kv, D], H = Kv * gq, query and key positions both
// counted from 0; fp32 scores scaled by D**-0.5; the mask kv_pos < s_valid,
// & q_pos >= kv_pos when causal, & |q_pos - kv_pos| < window when a window
// is given; masked scores set to the FINITE -1e30 (as the TPU kernel and
// attn_dense do: a slab masked for a row before its first visible key then
// carries weight 1 that the first visible key's rescale multiplies by
// exactly 0, where -inf would give NaN); an online softmax in fp32 with the
// denominator floored at 1e-30; output in q's dtype. A row with no visible
// key at all (only possible with s_valid < Skv and a window) is not defined:
// the TPU kernel, attn_dense and this kernel average different sets of
// values there, and no caller has one.
//
// What bounds it on the H100: the no-cache forward calls it at S = P +
// max_new + gamma + 2 (134 on the main path), where it reads q, k and v and
// writes o once — a few MB, ~1 us at 3.35 TB/s — and does 4*H*D flops per
// visible (query, key) pair, ~0.2 GFLOP at the Llama-3.2-3B geometry (0.2 us
// at the 989 TFLOP/s of the bf16 tensor cores). Neither bound is near: a
// block walks at most three 64-key slabs at S = 134, so the call is bound
// by latency — the launch, the first loads from device memory, and the
// serial chain of each slab's products and softmax. At S = 2048 the pairs
// grow as S^2 and the operations bound it (0.052 ms).
//
// Design (bf16, the serving path's type). One block per (tile of query
// rows, kv-head, batch row); the tile's rows are (position, group) pairs,
// r = qi * gq + g, so each K/V slab is read once for all gq query heads
// that share the kv-head, as the TPU kernel folds them. A loop inside the
// block takes the place of the TPU kernel's sequential KV grid axis.
//  * both products run on the tensor cores, mma.sync.m16n8k16 bf16 -> fp32:
//    K is read with ldmatrix, V with ldmatrix.trans; the weights P are
//    rounded to bf16 in registers and used directly as the A operand of PV
//    (the C fragment of QK^T is laid out as the A fragment of PV);
//  * the online softmax stays in registers: a row lives in the 4 lanes of
//    a quad, so its max and sum are two shuffles; ex2.approx takes the
//    scores pre-multiplied by D**-0.5 * log2(e); no shared-memory round
//    trip; the accumulator is rescaled only when the row's max moved;
//  * K/V arrive as 64-key slabs by 16-byte cp.async into a ring of stages
//    (kStages - 1 slabs in flight while one is computed), one barrier per
//    slab. Shared rows are XOR-swizzled in 16-byte chunks so every
//    ldmatrix phase hits 8 distinct bank groups;
//  * the row tiles launch last first, so the tiles with the longest causal
//    walks start in the first wave and the short ones fill the tail.
// Two shapes of block (the wrapper's plan picks): 64 rows as 4 warps of 16
// (MT = 1), Q fragments read once and kept in registers, a three-stage
// ring — the short walks of the serving path (S = 134: at most 3 slabs),
// where latency rules; and 128 rows as 4 warps of 32 (MT = 2), Q re-read
// from shared memory, a two-stage ring — long causal walks at D = 128,
// where each K/V fragment read from shared memory then feeds two products
// (at 255 registers, with a few bytes of spill). 32-row tiles (2 warps)
// were measured and were no faster at any shape (PERF.md).
// The KV walk covers only the slabs some row of the tile can see: it stops
// at the causal limit of the tile's last row (and at s_valid), and with a
// window starts at the window of its first row. Keys outside that range are
// never loaded: cp.async zero-fills them, so a masked weight of 0 never
// meets a NaN. Exactness across buffer lengths: slab boundaries sit at
// multiples of 64 from key 0, each row keeps its own max and sum, and a
// slab that is fully masked for a row once it has seen a visible key adds
// exactly 0 with a rescale of exactly 1 — so a row's output depends only on
// its own keys, not on Sq, Skv, the tile shape or the rows it shares a
// tile with.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.0152 ms at the
// 3B main-path shape (B=2, S=134; SDPA 0.0148), 0.0116 ms at the 1B shape
// (SDPA 0.0131), 0.212 ms at S = 2048 (SDPA 0.117). What holds the long
// walks back: mma.sync issues at most about half the rate wgmma reaches,
// and warps read whole K/V slabs from shared memory; wgmma fed by TMA, with
// a slab shared by a warpgroup, is the next step. The bf16 weights P and
// ex2.approx put the largest error against the plain version at one bf16
// step, 0.0156 at |x| in [2, 4), where the tolerance is 0.03 (ROADMAP.md,
// Queue 3).
//
// fp32 (the smoke models' type) keeps the CUDA-core kernel: TF32 or bf16
// products would miss the plain version's 1e-4. It stages 32-key slabs in
// shared memory as fp32 with scalar loads, each warp scoring 4 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ fp32 kernel
constexpr int kF32Threads = 128;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Rows = 16;
constexpr int kF32RowsPerWarp = kF32Rows / kF32Warps;   // 4
constexpr int kF32Keys = 32;                             // one key per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the KV range some row of the tile [row0, row0 + rows) can see
struct KvRange {
  int lo, hi;
};

__device__ __forceinline__ KvRange kv_range(int row0, int rows, int n_rows,
                                            int gq, int s_valid, int causal,
                                            int window) {
  const int q_lo = row0 / gq;
  const int q_hi = (min(row0 + rows, n_rows) - 1) / gq;
  int hi = s_valid;
  if (causal) hi = min(hi, q_hi + 1);
  else if (window > 0) hi = min(hi, q_hi + window);
  const int lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  return {lo, hi};
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int Sq, int Skv, int H, int Kv, int s_valid,
                           int causal, int window, float scale) {
  constexpr int DP = D + 1;                          // padded K row stride
  constexpr int kRowsPerPass = kF32Threads / D;      // 1 (D=128) or 2 (D=64)
  constexpr int kAcc = kF32Rows / kRowsPerPass;      // acc registers per thread

  __shared__ float q_s[kF32Rows * DP];
  __shared__ float k_s[kF32Keys * DP];
  __shared__ float v_s[kF32Keys * D];
  __shared__ float p_s[kF32Rows * kF32Keys];         // this slab's weights
  __shared__ float a_s[kF32Rows];                    // this slab's rescale
  __shared__ float l_s[kF32Rows];                    // final denominators

  const int row0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = H / Kv;
  const int n_rows = Sq * gq;

  for (int e = tid; e < kF32Rows * D; e += kF32Threads) {
    const int r = e / D, d = e % D;
    const int rg = row0 + r;
    float x = 0.f;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      x = q[((static_cast<size_t>(b) * Sq + qi) * H + h * gq + g) * D + d];
    }
    q_s[r * DP + d] = x;
  }

  const KvRange kv = kv_range(row0, kF32Rows, n_rows, gq, s_valid, causal, window);

  float m_r[kF32RowsPerWarp], l_r[kF32RowsPerWarp];
#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  const int d_own = tid % D;
  const int r_own = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int j = kv.lo / kF32Keys * kF32Keys; j < kv.hi; j += kF32Keys) {
    __syncthreads();   // q_s is staged / the previous step is done with the slabs
    for (int e = tid; e < kF32Keys * D; e += kF32Threads) {
      const int s = e / D, d = e % D;
      const int key = j + s;
      float kx = 0.f, vx = 0.f;
      if (key < kv.hi) {
        const size_t off = ((static_cast<size_t>(b) * Skv + key) * Kv + h) * D + d;
        kx = k[off];
        vx = v[off];
      }
      k_s[s * DP + d] = kx;
      v_s[s * D + d] = vx;
    }
    __syncthreads();

    // scores and the online-softmax update: warp w owns rows 4w..4w+3,
    // lane s scores key j + s
    const int kv_pos = j + lane;
    const float* ks = k_s + lane * DP;
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const int r = warp * kF32RowsPerWarp + i;
      const float* qr = q_s + r * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[d], dot);
      const int q_pos = (row0 + r) / gq;
      bool visible = kv_pos < s_valid;
      if (causal) visible = visible && q_pos >= kv_pos;
      if (window > 0) visible = visible && abs(q_pos - kv_pos) < window;
      const float sc = visible ? dot * scale : kNegInf;
      const float m_new = fmaxf(m_r[i], warp_max(sc));
      const float alpha = expf(m_r[i] - m_new);
      const float p = expf(sc - m_new);
      l_r[i] = l_r[i] * alpha + warp_sum(p);
      m_r[i] = m_new;
      p_s[r * kF32Keys + lane] = p;
      if (lane == 0) a_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r_own + i * kRowsPerPass;
      const float* pr = p_s + r * kF32Keys;
      float pv = 0.f;
#pragma unroll 8
      for (int s = 0; s < kF32Keys; ++s) pv = fmaf(pr[s], v_s[s * D + d_own], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) l_s[warp * kF32RowsPerWarp + i] = l_r[i];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r_own + i * kRowsPerPass;
    const int rg = row0 + r;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      out[((static_cast<size_t>(b) * Sq + qi) * H + h * gq + g) * D + d_own] =
          acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

// ------------------------------------------------------------ bf16 kernel
constexpr int kSlab = 64;          // keys per K/V slab
constexpr int kWarps = 4;          // warps per block

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

// byte offset of 16-byte chunk `ch` of row `r` in a tile of D-wide bf16
// rows: chunks are XOR-swizzled by the row's low 3 bits, so the 8 rows an
// ldmatrix phase reads at one chunk land on 8 distinct bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * D * 2 + ((ch ^ (r & 7)) << 4));
}

template <int D, int kRows, int kStages>
constexpr int bf16_smem_bytes() {
  return (kRows + kStages * 2 * kSlab) * D * 2;   // Q tile + the K/V ring
}

// kWarps warps of MT m16 tiles each: kRows = 16 * MT * kWarps query rows
template <int D, int MT, int kStages>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                            int H, int Kv, int s_valid, int causal, int window,
                            float scale_log2) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = 16 * MT * kWarps;
  constexpr int CH = D / 8;                // 16-byte chunks per row
  constexpr int kSlabBytes = kSlab * D * 2;
  constexpr int NT = D / 8;                // n8 tiles of the output
  constexpr int KT = D / 16;               // k16 steps of QK^T
  constexpr bool kQInRegs = MT == 1;       // else re-read from shared memory

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const q_s = smem;
  unsigned char* const kv_s = smem + kRows * D * 2;   // stage s: K, then V

  // the row tiles run last first (grid z, the slowest axis): the tiles
  // with the longest causal walks start in the first wave
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gq = H / Kv;
  const int n_rows = Sq * gq;

  const KvRange kv = kv_range(row0, kRows, n_rows, gq, s_valid, causal, window);
  const int j0 = kv.lo / kSlab * kSlab;
  const int n_slabs = kv.hi > j0 ? (kv.hi - j0 + kSlab - 1) / kSlab : 0;

  auto load_slab = [&](int j, int stage) {
    unsigned char* const ks = kv_s + stage * 2 * kSlabBytes;
    unsigned char* const vs = ks + kSlabBytes;
    for (int c = tid; c < kSlab * CH; c += kThreads) {
      const int s = c / CH, ch = c % CH;
      const int key = j + s;
      const bool ok = key >= kv.lo && key < kv.hi;
      const size_t off = ok ? ((static_cast<size_t>(b) * Skv + key) * Kv + h) * D + ch * 8 : 0;
      const uint32_t dst = swz<D>(s, ch);
      cp_async16(smem_u32(ks + dst), k + off, ok);
      cp_async16(smem_u32(vs + dst), v + off, ok);
    }
  };

  // the ring: group 0 = Q + slab 0, then one group per slab, kStages - 1
  // slabs in flight while a slab is computed
  if (n_slabs > 0) {
    for (int c = tid; c < kRows * CH; c += kThreads) {
      const int r = c / CH, ch = c % CH;
      const int rg = row0 + r;
      const bool ok = rg < n_rows;
      size_t off = 0;
      if (ok) {
        const int qi = rg / gq, gg = rg % gq;
        off = ((static_cast<size_t>(b) * Sq + qi) * H + h * gq + gg) * D + ch * 8;
      }
      cp_async16(smem_u32(q_s + swz<D>(r, ch)), q + off, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_slabs) load_slab(j0 + i * kSlab, i);
    cp_async_commit();
  }

  // this warp's rows: 16 per m16 tile mt; this thread's two rows of each
  // (g and g + 8) and their positions
  const int wr = warp * 16 * MT;
  int q_pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) q_pos[mt][hh] = (row0 + wr + 16 * mt + g + 8 * hh) / gq;
  const int q_lo = row0 / gq;

  uint32_t qf[kQInRegs ? KT : 1][4];
  float o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i) o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = kNegInf;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }

  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slab i has landed; every warp is done with slab i - 1
    if (i + kStages - 1 < n_slabs)
      load_slab(j0 + (i + kStages - 1) * kSlab, (i + kStages - 1) % kStages);
    cp_async_commit();

    if (kQInRegs && i == 0) {
#pragma unroll
      for (int s = 0; s < KT; ++s) {
        const int mi = lane >> 3;
        const int r = wr + (mi & 1) * 8 + (lane & 7);
        ldsm_x4(qf[kQInRegs ? s : 0], smem_u32(q_s + swz<D>(r, 2 * s + (mi >> 1))));
      }
    }

    const unsigned char* const ks = kv_s + (i % kStages) * 2 * kSlabBytes;
    const unsigned char* const vs = ks + kSlabBytes;
    const int j = j0 + i * kSlab;

    // S = Q K^T: 16 rows x 64 keys per m16 tile, n8 tile n = keys j + 8n ..
    float sc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n) sc[mt][n][0] = sc[mt][n][1] = sc[mt][n][2] = sc[mt][n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      uint32_t qa[MT][4];
      const int mi = lane >> 3;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[mt][e] = qf[kQInRegs ? s : 0][e];
        } else {
          const int r = wr + 16 * mt + (mi & 1) * 8 + (lane & 7);
          ldsm_x4(qa[mt], smem_u32(q_s + swz<D>(r, 2 * s + (mi >> 1))));
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kb[4];
        const int key = 16 * p + (mi >> 1) * 8 + (lane & 7);
        ldsm_x4(kb, smem_u32(ks + swz<D>(key, 2 * s + (mi & 1))));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * p], qa[mt], kb[0], kb[1]);
          mma_bf16(sc[mt][2 * p + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    // scale into log2 units and mask; a slab every row of the tile sees
    // whole skips the mask
    const bool full = j + kSlab <= s_valid && window <= 0 &&
                      (!causal || j + kSlab - 1 <= q_lo);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[mt][n][e] * scale_log2;
          if (!full) {
            const int kv_pos = j + 8 * n + 2 * t + (e & 1);
            const int qp = q_pos[mt][e >> 1];
            bool visible = kv_pos < s_valid;
            if (causal) visible = visible && qp >= kv_pos;
            if (window > 0) visible = visible && abs(qp - kv_pos) < window;
            if (!visible) x = kNegInf;
          }
          sc[mt][n][e] = x;
        }

    // online softmax, per row: the quad (4 lanes) holds the row's 64 scores
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[mt][n][2 * hh], sc[mt][n][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[mt][hh], mx);
        // exactly 1 where the max holds, so a slab masked for this row adds
        // nothing and rescales nothing
        const float alpha = m_new == m_r[mt][hh] ? 1.f : fast_exp2(m_r[mt][hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float p0 = fast_exp2(sc[mt][n][2 * hh] - m_new);
          const float p1 = fast_exp2(sc[mt][n][2 * hh + 1] - m_new);
          sc[mt][n][2 * hh] = p0;
          sc[mt][n][2 * hh + 1] = p1;
          sum += p0 + p1;
        }
        l_r[mt][hh] = l_r[mt][hh] * alpha + sum;   // this lane's share; the quad adds at the end
        m_r[mt][hh] = m_new;
        if (alpha != 1.f) {
#pragma unroll
          for (int nd = 0; nd < NT; ++nd) {
            o[mt][nd][2 * hh] *= alpha;
            o[mt][nd][2 * hh + 1] *= alpha;
          }
        }
      }

    // O += P V: P (bf16, from the C fragments) is the A operand, k16 step
    // kk = keys j + 16kk .. j + 16kk + 15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t vb[4];
        const int mi = lane >> 3;
        const int key = 16 * kk + (mi & 1) * 8 + (lane & 7);
        ldsm_x4_trans(vb, smem_u32(vs + swz<D>(key, 2 * p + (mi >> 1))));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * p], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * p + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_r[mt][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float den = fmaxf(l, 1e-30f);
      const int rg = row0 + wr + 16 * mt + g + 8 * hh;
      if (rg < n_rows) {
        const int qi = rg / gq, gg = rg % gq;
        __nv_bfloat16* const dst =
            out + ((static_cast<size_t>(b) * Sq + qi) * H + h * gq + gg) * D;
#pragma unroll
        for (int nd = 0; nd < NT; ++nd)
          *reinterpret_cast<uint32_t*>(dst + 8 * nd + 2 * t) =
              pack_bf16(o[mt][nd][2 * hh] / den, o[mt][nd][2 * hh + 1] / den);
      }
    }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int Kv, int s_valid, int causal,
               int window, float scale, cudaStream_t stream) {
  const int gq = H / Kv;
  const dim3 grid((Sq * gq + kF32Rows - 1) / kF32Rows, Kv, B);
  flash_attention_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, Kv,
      s_valid, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MT, int kStages>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int Kv, int s_valid, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr int kRows = 16 * MT * kWarps;
  constexpr int kSmem = bf16_smem_bytes<D, kRows, kStages>();
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D, MT, kStages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const long long tiles = (static_cast<long long>(Sq) * (H / Kv) + kRows - 1) / kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Kv, B, static_cast<unsigned>(tiles));
  flash_attention_bf16_kernel<D, MT, kStages><<<grid, kWarps * 32, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, Kv, s_valid, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: [B, Sq, H, D]; k/v: [B, Skv, Kv, D]; all contiguous, of one dtype
// (0 = float32, 1 = bfloat16); H a multiple of Kv; D 64 or 128;
// 1 <= s_valid <= Skv; causal 0/1; window <= 0 means no window. row_tile is
// the query rows per block: 16 for float32; 64, or 128 with D = 128, for
// bfloat16 (whose pointers must be 16-byte aligned). Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int Kv, int D, int s_valid, int causal,
                                   int window, float scale, int dtype,
                                   int row_tile, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Kv < 1 || H % Kv != 0 || s_valid < 1 ||
      s_valid > Skv || Kv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && row_tile == kF32Rows) {
    if (D == 64) return launch_f32<64>(q, k, v, out, B, Sq, Skv, H, Kv, s_valid, causal, window, scale, st);
    if (D == 128) return launch_f32<128>(q, k, v, out, B, Sq, Skv, H, Kv, s_valid, causal, window, scale, st);
  }
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (D == 64 && row_tile == 64)
      return launch_bf16<64, 1, 3>(q, k, v, out, B, Sq, Skv, H, Kv, s_valid, causal, window, scale, st);
    if (D == 128 && row_tile == 64)
      return launch_bf16<128, 1, 3>(q, k, v, out, B, Sq, Skv, H, Kv, s_valid, causal, window, scale, st);
    if (D == 128 && row_tile == 128)
      return launch_bf16<128, 2, 2>(q, k, v, out, B, Sq, Skv, H, Kv, s_valid, causal, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
