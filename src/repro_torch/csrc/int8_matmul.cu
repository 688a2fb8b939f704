// w8a8 int8 matmul with its rescale epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (int8_matmul, pallas_call at :52). Same function: x_q [M, K] int8 times
// w_q [K, N] int8 with exact int32 accumulation, then out = acc * sx * sw[n]
// in fp32, in that order, cast to the output type (fp32 or bf16). sx is a
// 0-dim fp32 tensor on the card, read through its pointer, so no caller
// ever reads it on the host. w_q keeps JAX's [K, N] layout (N contiguous),
// and is neither transposed nor copied.
//
// What bounds it on the H100: on the main path (the w8a8 no-cache pass of
// the Llama-3.2-3B/1B pair) M is 2 x 134 = 268 rows and the weight is the
// larger operand: the 3B gate projection (268 x 3072 -> 8192, bf16 out)
// reads 25 MB of weight and 0.8 MB of activations and writes 4.4 MB, ~9 us
// at 3.35 TB/s, against 13.5 GOP, ~7 us at the 1,979 TOP/s of the dense
// int8 tensor cores (mma.sync reaches only part of that). The bytes bound
// it, barely, if the weight is read from device memory once.
//
// Design. Each block owns a 96 x 128 output tile (4 warps of 48 x 64, int8
// tensor cores through mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, 96
// int32 accumulators per thread) and walks its share of K in 128-deep steps:
//  * the weight is streamed once: M = 268 is covered by three 96-row tiles,
//    and M is the fastest grid axis, so the three blocks that share a
//    weight tile run side by side and two of them find it in L2;
//  * the loads are pipelined: raw x and w tiles arrive by 16-byte cp.async
//    into a ring of kStages stages (dynamic shared memory), kStages - 1
//    steps ahead of the tensor cores, one barrier per step; a row whose
//    start is not 16-byte aligned (K or N not a multiple of 16) is read
//    bytewise into registers and stored 16 bytes at a time instead;
//  * the .col B operand wants 4 consecutive k of one n in a register, while
//    w_q's tile arrives as [k][n]: each lane reads 8 bytes (8 n) of 4
//    consecutive k rows with 64-bit shared loads and transposes the 4 x 4
//    byte blocks in registers with __byte_perm. The lane's 8 columns become
//    8 different n8 tiles (logical column g of tile i is physical column
//    8g + i of the warp's 64), so each lane's accumulators end up covering
//    16 contiguous output columns per row, stored with 16-byte stores;
//  * shared tiles are XOR-swizzled in 16-byte chunks: x rows (ldmatrix, 8
//    rows per phase) by row & 7, w rows (64-bit loads, 4 k rows x 4 chunks
//    per phase) by (row >> 2 & 3) << 1, so neither read conflicts;
//  * split K where the grid is thin: the wrapper's plan (kernels/
//    int8_matmul.py) splits the K steps into `splits` contiguous ranges,
//    grid axis 2, so that the blocks fill the card's SMs (the 8192-deep down
//    projections, the narrow k/v and q/o projections). Each split writes
//    its int32 partial tile to a workspace [splits, M, N]; a second kernel
//    adds the partials in split order and applies the epilogue. int32 sums
//    are exact, so the result is bit-equal to the unsplit one.
// Rows past M, columns past N and depths past K load as zeros and are never
// written. Not here: wgmma (its s8 B operand must be K-major in shared
// memory, which needs the weight transposed) and TMA.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), at M = 268, bf16
// out: 0.0442 ms for the 3B gate projection (torch._int_mm + rescale
// 0.0636), 0.0507 ms for the 3B down projection (0.0618); every main-path
// projection below the library's time. What holds it back now is the
// issue rate of mma.sync and its fragment loads (the gate projection's
// 13.5 GOP in 0.0442 ms is 305 TOP/s, a sixth of the int8 peak), not the
// weight's bytes (25 MB in 0.0442 ms is 0.57 TB/s). K or N not a multiple
// of 16 (never on the serving path) takes the bytewise path and is several
// times slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int kBM = 96, kBN = 128, kBK = 128;   // block tile (bytes of K)
constexpr int kStages = 4;
constexpr int kThreads = 128;                    // 4 warps, 2 x 2 of 48 x 64
constexpr int kWM = 48, kWN = 64;
constexpr int kMT = kWM / 16;                    // m16 tiles per warp (3)
constexpr int kNT = kWN / 8;                     // n8 tiles per warp (8)
constexpr int kATile = kBM * kBK;                // x tile bytes, [m][k]
constexpr int kBTile = kBK * kBN;                // w tile bytes, [k][n]
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmem = kStages * kStageBytes;     // 114,688 bytes
constexpr int kEpiThreads = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of a row from `src`, those at or past `limit` read as 0 (the
// path for rows whose start is not 16-byte aligned)
__device__ __forceinline__ int4 load16_bytes(const int8_t* src, int limit) {
  union {
    int4 v;
    int8_t c[16];
  } u;
#pragma unroll
  for (int i = 0; i < 16; ++i) u.c[i] = i < limit ? src[i] : static_cast<int8_t>(0);
  return u.v;
}

// rows w0..w3 (4 bytes each, one per column) -> columns c0..c3 (4 bytes
// each, one per row): a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2,
                                             uint32_t w3, uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);   // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);   // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t x_off(int r, int ch) {     // [m][k] tile
  return static_cast<uint32_t>(r * kBK + ((ch ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t w_off(int r, int ch) {     // [k][n] tile
  return static_cast<uint32_t>(r * kBN + ((ch ^ (((r >> 2) & 3) << 1)) << 4));
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8], int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
    return;
  }
  for (int i = 0; i < 8 && i < n; ++i) p[i] = x[i];
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8], int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    uint4 u;
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    u.x = *reinterpret_cast<uint32_t*>(&h[0]);
    u.y = *reinterpret_cast<uint32_t*>(&h[1]);
    u.z = *reinterpret_cast<uint32_t*>(&h[2]);
    u.w = *reinterpret_cast<uint32_t*>(&h[3]);
    *reinterpret_cast<uint4*>(p) = u;
    return;
  }
  for (int i = 0; i < 8 && i < n; ++i) p[i] = __float2bfloat16(x[i]);
}

__device__ __forceinline__ void store8(int* p, const int (&x)[8], int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    reinterpret_cast<int4*>(p)[0] = make_int4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(x[4], x[5], x[6], x[7]);
    return;
  }
  for (int i = 0; i < 8 && i < n; ++i) p[i] = x[i];
}

// T = float / __nv_bfloat16: the finished output; T = int: this split's
// int32 partial sums, at out + blockIdx.z * M * N
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   T* __restrict__ out, int M, int K, int N, int splits,
                   int vec_x, int vec_w) {
  extern __shared__ __align__(128) int8_t smem[];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * kWM, wn = (warp & 1) * kWN;
  const int g = lane >> 2, t = lane & 3;

  // this split's K steps: [z * steps / splits, (z + 1) * steps / splits)
  const int steps = (K + kBK - 1) / kBK;
  const int z = blockIdx.z;
  const int s_lo = static_cast<int>(static_cast<long long>(z) * steps / splits);
  const int s_hi = static_cast<int>(static_cast<long long>(z + 1) * steps / splits);
  const int nk = s_hi - s_lo;

  // this thread's copy slots, the same in every step: x rows and w (k) rows
  // lr + 16i of the tiles, 16-byte chunk lc (the swizzles depend only on
  // lr's low bits, so slot i sits 16i rows below slot 0 in shared memory)
  const int lr = tid >> 3, lc = tid & 7;
  const uint32_t x_dst = x_off(lr, lc), w_dst = w_off(lr, lc);
  const int8_t* const x_src = x + static_cast<size_t>(m0 + lr) * K + lc * 16;
  const int8_t* const w_src = w + static_cast<size_t>(lr) * N + n0 + lc * 16;
  const bool w_col_ok = n0 + lc * 16 < N;

  auto load_stage = [&](int step, int stage) {
    int8_t* const xs = smem + stage * kStageBytes;
    int8_t* const ws = xs + kATile;
    const int k0 = step * kBK;
    const bool x_col_ok = k0 + lc * 16 < K;
#pragma unroll
    for (int i = 0; i < kBM / 16; ++i) {
      const bool ok = x_col_ok && m0 + lr + 16 * i < M;
      const int8_t* src = ok ? x_src + static_cast<size_t>(16 * i) * K + k0 : x;
      int8_t* const dst = xs + x_dst + 16 * i * kBK;
      if (vec_x)
        cp_async16(smem_u32(dst), src, ok);
      else
        *reinterpret_cast<int4*>(dst) =
            ok ? load16_bytes(src, K - k0 - lc * 16) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kBK / 16; ++i) {
      const bool ok = w_col_ok && k0 + lr + 16 * i < K;
      const int8_t* src = ok ? w_src + static_cast<size_t>(k0 + 16 * i) * N : w;
      int8_t* const dst = ws + w_dst + 16 * i * kBN;
      if (vec_w)
        cp_async16(smem_u32(dst), src, ok);
      else
        *reinterpret_cast<int4*>(dst) =
            ok ? load16_bytes(src, N - n0 - lc * 16) : make_int4(0, 0, 0, 0);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s_lo + s, s);
    cp_async_commit();
  }

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step i has landed; every warp is done with step i - 1
    if (i + kStages - 1 < nk) load_stage(s_lo + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();

    const int8_t* const xs = smem + (i % kStages) * kStageBytes;
    const int8_t* const ws = xs + kATile;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int r = wm + mi * 16 + (lane & 15);
        ldsm_x4(a[mi], smem_u32(xs + x_off(r, 2 * kk + (lane >> 4))));
      }
      // b[ni][h]: k = 32kk + 16h + 4t .. +3 of physical column wn + 8g + ni
      uint32_t b[kNT][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint2 rows[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 32 * kk + 16 * h + 4 * t + j;
          const int col = wn + 8 * g;
          rows[j] = *reinterpret_cast<const uint2*>(ws + w_off(r, col >> 4) + (col & 15));
        }
        uint32_t lo[4], hi[4];
        transpose4x4(rows[0].x, rows[1].x, rows[2].x, rows[3].x, lo);
        transpose4x4(rows[0].y, rows[1].y, rows[2].y, rows[3].y, hi);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b[c][h] = lo[c];
          b[4 + c][h] = hi[c];
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // acc[mi][ni][2hh + e] is row wm + 16mi + g + 8hh, logical column 2t + e
  // of n8 tile ni = physical column wn + 8(2t + e) + ni: this lane holds
  // columns wn + 16t .. wn + 16t + 15 of each of its rows
  const int col0 = n0 + wn + 16 * t;
  const int ncols = N - col0;
  if (ncols <= 0) return;
  if constexpr (std::is_same<T, int>::value) {
    int* const part = out + static_cast<size_t>(z) * M * N;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int v8[8];
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) v8[ni] = acc[mi][ni][2 * hh + e];
          if (ncols > 8 * e)
            store8(part + static_cast<size_t>(row) * N + col0 + 8 * e, v8, ncols - 8 * e);
        }
      }
  } else {
    const float s = *sx;
    float scol[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) scol[c] = c < ncols ? sw[col0 + c] : 0.f;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v8[8];
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
            v8[ni] = static_cast<float>(acc[mi][ni][2 * hh + e]) * s * scol[8 * e + ni];
          if (ncols > 8 * e)
            store8(out + static_cast<size_t>(row) * N + col0 + 8 * e, v8, ncols - 8 * e);
        }
      }
  }
}

// out[m, n] = (sum over z of part[z, m, n]) * sx * sw[n], the partials added
// in split order; one thread per 4 consecutive elements of a row
template <typename T>
__global__ void __launch_bounds__(kEpiThreads)
int8_splitk_epilogue(const int* __restrict__ part, const float* __restrict__ sx,
                     const float* __restrict__ sw, T* __restrict__ out, int M,
                     int N, int splits) {
  const int quads = (N + 3) / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * kEpiThreads + threadIdx.x;
  if (idx >= static_cast<long long>(M) * quads) return;
  const int row = static_cast<int>(idx / quads);
  const int col = static_cast<int>(idx % quads) * 4;
  const int n = min(4, N - col);
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t base = static_cast<size_t>(row) * N + col;
  int sum[4] = {0, 0, 0, 0};
  const bool vec = n == 4 && N % 4 == 0;
  for (int z = 0; z < splits; ++z) {
    const int* p = part + z * plane + base;
    if (vec) {
      const int4 q = *reinterpret_cast<const int4*>(p);
      sum[0] += q.x;
      sum[1] += q.y;
      sum[2] += q.z;
      sum[3] += q.w;
    } else {
      for (int i = 0; i < n; ++i) sum[i] += p[i];
    }
  }
  const float s = *sx;
  for (int i = 0; i < n; ++i) {
    const float y = static_cast<float>(sum[i]) * s * sw[col + i];
    if constexpr (std::is_same<T, float>::value)
      out[base + i] = y;
    else
      out[base + i] = __float2bfloat16(y);
  }
}

template <typename T>
int set_smem_attribute() {
  static bool done = false;   // once per instantiation
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <typename T>
int launch(const void* x, const void* w, const void* sx, const void* sw,
           void* out, void* part, int M, int K, int N, int splits,
           cudaStream_t stream) {
  const int vec_x = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  if (splits == 1) {
    if (const int err = set_smem_attribute<T>()) return err;
    int8_matmul_kernel<T><<<grid, kThreads, kSmem, stream>>>(
        xp, wp, sxp, swp, static_cast<T*>(out), M, K, N, 1, vec_x, vec_w);
    return static_cast<int>(cudaGetLastError());
  }
  if (const int err = set_smem_attribute<int>()) return err;
  int8_matmul_kernel<int><<<grid, kThreads, kSmem, stream>>>(
      xp, wp, sxp, swp, static_cast<int*>(part), M, K, N, splits, vec_x, vec_w);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const long long threads = static_cast<long long>(M) * ((N + 3) / 4);
  const int blocks = static_cast<int>((threads + kEpiThreads - 1) / kEpiThreads);
  int8_splitk_epilogue<T><<<blocks, kEpiThreads, 0, stream>>>(
      static_cast<const int*>(part), sxp, swp, static_cast<T*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q: [M, K] int8, w_q: [K, N] int8, both contiguous; sx: one fp32 on the
// card; sw: [N] fp32; out: [M, N] contiguous of dtype 0 = float32,
// 1 = bfloat16. splits: the number of K ranges (1 .. ceil(K / 128), or 1
// when K = 0); with splits > 1, part is an int32 workspace of
// splits * M * N elements (otherwise unused). One kernel launch when
// splits == 1, two otherwise. Returns a cudaError_t (0 = launched).
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* sx,
                               const void* sw, void* out, void* part, int M,
                               int K, int N, int splits, int dtype,
                               void* stream) {
  const int steps = (K + kBK - 1) / kBK;
  if (M < 1 || K < 0 || N < 1 || (N + kBN - 1) / kBN > 65535 || splits < 1 ||
      splits > 65535 || splits > (steps > 0 ? steps : 1) ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, sx, sw, out, part, M, K, N, splits, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, sx, sw, out, part, M, K, N, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
