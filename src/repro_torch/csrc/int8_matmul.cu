// w8a8 int8 matmul with its rescale epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (int8_matmul, pallas_call at :52). Same function: x_q [M, K] int8 times
// w_q [K, N] int8 with exact int32 accumulation, then out = acc * sx * sw[n]
// in fp32, in that order, cast to the output type (fp32 or bf16). sx is a
// 0-dim fp32 tensor on the card, read through its pointer, so no caller
// ever reads it on the host. w_q keeps JAX's [K, N] layout (N contiguous).
//
// What bounds it on the H100: on the main path (the w8a8 no-cache pass of
// the Llama-3.2-3B/1B pair) M is 2 x 134 = 268 rows and the weight is the
// larger operand: the 3B gate projection (268 x 3072 -> 8192, bf16 out)
// reads 25 MB of weight and 0.8 MB of activations and writes 4.4 MB, ~9 us
// at 3.35 TB/s, against 13.5 GOP, ~7 us at the 1,979 TOP/s of the dense
// int8 tensor cores. The bytes bound it, barely; at this M the weight is
// read from device memory once per 64-row block row, so the tile walks
// over M reuse it from L2.
//
// Design. The TPU kernel keeps an int32 accumulator tile in VMEM across a
// sequential K grid axis; here each thread block owns one 64 x 64 output
// tile and walks K in a loop, with the accumulators in registers. Four
// warps each compute a 32 x 32 quarter with int8 tensor cores through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (2 x 4 tiles of 16 x 8,
// 32 int32 accumulators per thread). Each step stages a [64, 128] tile of
// x_q row-major and a [128, 64] tile of w_q transposed to [n][k] in shared
// memory: the .col operand wants K contiguous, so the tile is transposed
// in shared memory rather than the parameter in device memory. Shared
// rows are padded to 144 bytes, so the fragments' 32-bit reads fall on 32
// distinct banks. Rows past M, columns past N and depths past K load as
// zeros and are never written: ragged edges are masked here instead of
// copied into padded buffers (16-byte loads where a row's start is
// aligned, bytes otherwise). Simple first: no cp.async or TMA pipeline,
// no wgmma; a persistent, pipelined wgmma kernel is for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 128;
constexpr int kThreads = 128;                 // 4 warps, 2 x 2 quarters of 32 x 32
constexpr int kStride = kBK + 16;             // bytes per shared row

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of a row from `src`, those at or past `limit` read as 0
__device__ __forceinline__ int4 load16(const int8_t* src, int limit, bool vec) {
  if (vec && limit >= 16) return *reinterpret_cast<const int4*>(src);
  union {
    int4 v;
    int8_t c[16];
  } u;
#pragma unroll
  for (int i = 0; i < 16; ++i) u.c[i] = i < limit ? src[i] : static_cast<int8_t>(0);
  return u.v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   T* __restrict__ out, int M, int K, int N, int vec_x, int vec_w) {
  __shared__ __align__(16) int8_t As[kBM * kStride];   // [m][k]
  __shared__ __align__(16) int8_t Bs[kBN * kStride];   // [n][k]

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x_q tile, row-major: kBM rows of kBK bytes in 16-byte pieces
    for (int c = tid; c < kBM * kBK / 16; c += kThreads) {
      const int r = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + kc;
      int4 v = make_int4(0, 0, 0, 0);
      if (gm < M && gk < K) v = load16(x + static_cast<size_t>(gm) * K + gk, K - gk, vec_x);
      *reinterpret_cast<int4*>(As + r * kStride + kc) = v;
    }
    // w_q tile: kBK rows of kBN bytes (N contiguous), transposed to [n][k]
    for (int c = tid; c < kBK * kBN / 16; c += kThreads) {
      const int kk = c / (kBN / 16), nc = (c % (kBN / 16)) * 16;
      const int gk = k0 + kk, gn = n0 + nc;
      union {
        int4 v;
        int8_t b[16];
      } u;
      u.v = make_int4(0, 0, 0, 0);
      if (gk < K && gn < N) u.v = load16(w + static_cast<size_t>(gk) * N + gn, N - gn, vec_w);
#pragma unroll
      for (int i = 0; i < 16; ++i) Bs[(nc + i) * kStride + kk] = u.b[i];
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * kStride + ks + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * kStride + ks + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t+1 of the 16 x 8 tile; c2, c3 at row g + 8
  const float s = *sx;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + mi * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn + ni * 8 + t * 2 + (r & 1);
        if (row < M && col < N)
          store(&out[static_cast<size_t>(row) * N + col],
                static_cast<float>(acc[mi][ni][r]) * s * sw[col]);
      }
}

template <typename T>
int launch(const void* x, const void* w, const void* sx, const void* sw,
           void* out, int M, int K, int N, cudaStream_t stream) {
  const int vec_x = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<T*>(out), M, K, N, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q: [M, K] int8, w_q: [K, N] int8, both contiguous; sx: one fp32 on the
// card; sw: [N] fp32; out: [M, N] contiguous of dtype 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* sx,
                               const void* sw, void* out, int M, int K, int N,
                               int dtype, void* stream) {
  if (M < 1 || K < 0 || N < 1 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, sx, sw, out, M, K, N, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, sx, sw, out, M, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
