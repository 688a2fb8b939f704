// The backward pass of the no-cache flash attention (csrc/flash_attention.cu)
// for Hopper (sm_90a): the gradients dq, dk, dv of o = softmax(q k^T * scale
// masked) v, from the forward's output o and its per-row log-sum-exp lse.
//
// Replaces no TPU kernel: JAX trains through its jnp attention
// (attn_dense / attn_chunked), which XLA differentiates, and never reaches
// the Pallas flash kernel (src/repro/kernels/flash_attention.py) there. The
// port's no-cache forward does reach its flash kernel on the card, so that
// kernel needs a gradient: kernels/flash_attention.py binds this one through
// a torch.autograd.Function. Its plain version is the autograd of
// kernels/ref.py::flash_attention_ref, and kernels/ref.py::
// flash_attention_bwd_tiled is this file's recurrence in PyTorch.
//
// The function (FlashAttention-2's backward): with the same mask as the
// forward (kv_pos < s_valid, q_pos >= kv_pos when causal, |q_pos - kv_pos|
// < window when a window is given; positions counted from 0 on both sides)
//   delta_i = sum_d dO[i, d] * O[i, d]
//   P_ij    = exp(S_ij * scale - lse_i) where visible, else 0 (the forward's
//             finite -1e30 mask gives exactly 0 there)
//   dV_j   += P_ij dO_i          dP_ij = dO_i . V_j
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dK_j   += dS_ij Q_i * scale  dQ_i += dS_ij K_j * scale
// GQA folds as in the forward: the rows of a kv-head are the (position,
// group) pairs r = q_pos * gq + g, so the gq query heads that share a
// kv-head accumulate into one dK/dV row.
//
// Three kernels, launched in order by one entry point: delta (a warp per
// row), dK/dV (a block per 32-key tile of a kv-head and batch row, walking
// every 32-row tile that can see the keys) and dQ (a block per 32-row tile,
// walking the key tiles its rows can see, the forward's KV range). Each
// output element is written by exactly one thread, after a loop in a fixed
// order: no atomics, so two runs give the same bits and a remat recompute
// gives the same gradients.
//
// What bounds it on the H100: operations. Per visible (row, key) pair it
// does 4 * D fused multiply-adds in the dK/dV kernel (S, dP, dV, dK) and 3 *
// D in the dQ kernel (S, dP, dQ): 14 * D flops a pair, 3.5x the forward's
// 4 * D, ~0.18 TFLOP for the 3B geometry at B = 2, S = 2048. Design: a
// simple kernel, right first. Every input is widened to fp32 in shared
// memory (bf16 inputs, fp32 accumulation, gradients stored in the input
// dtype) and every product is an fp32 FMA on the CUDA cores, from shared
// memory rows padded to D + 1 floats (conflict-free), each thread holding a
// 2 x 2 block of scores and two rows or keys of the accumulated gradient in
// registers. It runs far under the tensor cores' rate. Measured
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; B = 2): 1.36 ms at the 3B
// geometry, S = 512, in fp32 and bf16 alike (~8 TFLOP/s of its 14 * D
// flops a pair; SDPA's backward 0.070 ms bf16, 0.43 ms fp32), 13.2-13.3
// ms at S = 2048. mma.sync or wgmma products are the next step.
//
// Head dims 32, 48, 64, 128 and 256: a thread owns D / 16 columns (2 at
// D = 32, 3 at D = 48) of its two rows or keys; nothing else depends on D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;             // rows (position, group) or keys per tile
constexpr int kHalf = kTile / 2;      // a thread owns rows/keys t and t + 16
constexpr int kDeltaWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int q_pos, int kv_pos, int s_valid,
                                        int causal, int window) {
  bool ok = kv_pos < s_valid;
  if (causal) ok = ok && q_pos >= kv_pos;
  if (window > 0) ok = ok && abs(q_pos - kv_pos) < window;
  return ok;
}

// shared memory of both tile kernels: four [kTile][D + 1] fp32 tiles (the
// rows' Q and dO, the keys' K and V), the weights P and dS [kTile][kTile +
// 1], and the rows' lse and delta
template <int D>
constexpr int smem_bytes() {
  static_assert(D % kHalf == 0, "a thread owns D / 16 whole columns");
  return static_cast<int>(sizeof(float)) *
         (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

template <int D>
struct Smem {
  float* q;     // [kTile][D + 1]
  float* dout;  // [kTile][D + 1]
  float* k;     // [kTile][D + 1]
  float* v;     // [kTile][D + 1]
  float* p;     // [kTile][kTile + 1]
  float* ds;    // [kTile][kTile + 1]
  float* lse;   // [kTile]
  float* delta; // [kTile]
  __device__ explicit Smem(float* base) {
    constexpr int DP = D + 1;
    q = base;
    dout = q + kTile * DP;
    k = dout + kTile * DP;
    v = k + kTile * DP;
    p = v + kTile * DP;
    ds = p + kTile * (kTile + 1);
    lse = ds + kTile * (kTile + 1);
    delta = lse + kTile;
  }
};

// rows r0 .. r0 + kTile - 1 of a kv-head: Q, dO, lse and delta into shared
// memory (zeros past n_rows)
template <typename T, int D>
__device__ __forceinline__ void load_rows(const Smem<D>& sm, const T* __restrict__ q,
                                          const T* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int r0,
                                          int b, int h, int Sq, int H, int gq,
                                          int n_rows) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int rg = r0 + r;
    float qx = 0.f, ox = 0.f;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      const size_t off = ((static_cast<size_t>(b) * Sq + qi) * H + h * gq + g) * D + d;
      qx = to_f(q[off]);
      ox = to_f(dout[off]);
    }
    sm.q[r * DP + d] = qx;
    sm.dout[r * DP + d] = ox;
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int rg = r0 + r;
    float l = 0.f, dl = 0.f;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      const size_t off = (static_cast<size_t>(b) * H + h * gq + g) * Sq + qi;
      l = lse[off];
      dl = delta[off];
    }
    sm.lse[r] = l;
    sm.delta[r] = dl;
  }
}

// keys j0 .. j0 + kTile - 1 of a kv-head: K and V into shared memory (zeros
// past Skv)
template <typename T, int D>
__device__ __forceinline__ void load_keys(const Smem<D>& sm, const T* __restrict__ k,
                                          const T* __restrict__ v, int j0, int b,
                                          int h, int Skv, int Kv) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int s = e / D, d = e % D;
    const int key = j0 + s;
    float kx = 0.f, vx = 0.f;
    if (key < Skv) {
      const size_t off = ((static_cast<size_t>(b) * Skv + key) * Kv + h) * D + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    sm.k[s * DP + d] = kx;
    sm.v[s * DP + d] = vx;
  }
}

// P and dS of the staged row tile (rows r0 + r) against the staged key tile
// (keys j0 + s): thread (ri, kj) scores rows ri, ri + 16 against keys kj,
// kj + 16, for both S = Q K^T and dP = dO V^T
template <int D>
__device__ __forceinline__ void weights(const Smem<D>& sm, int r0, int j0, int gq,
                                        int n_rows, int s_valid, int causal,
                                        int window, float scale) {
  constexpr int DP = D + 1;
  const int ri = threadIdx.x / kHalf, kj = threadIdx.x % kHalf;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const float* q0 = sm.q + ri * DP;
  const float* q1 = q0 + kHalf * DP;
  const float* o0 = sm.dout + ri * DP;
  const float* o1 = o0 + kHalf * DP;
  const float* k0 = sm.k + kj * DP;
  const float* k1 = k0 + kHalf * DP;
  const float* v0 = sm.v + kj * DP;
  const float* v1 = v0 + kHalf * DP;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a0 = q0[d], a1 = q1[d], b0 = k0[d], b1 = k1[d];
    s[0][0] = fmaf(a0, b0, s[0][0]);
    s[0][1] = fmaf(a0, b1, s[0][1]);
    s[1][0] = fmaf(a1, b0, s[1][0]);
    s[1][1] = fmaf(a1, b1, s[1][1]);
    const float c0 = o0[d], c1 = o1[d], e0 = v0[d], e1 = v1[d];
    dp[0][0] = fmaf(c0, e0, dp[0][0]);
    dp[0][1] = fmaf(c0, e1, dp[0][1]);
    dp[1][0] = fmaf(c1, e0, dp[1][0]);
    dp[1][1] = fmaf(c1, e1, dp[1][1]);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = ri + kHalf * a;
    const int rg = r0 + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int sk = kj + kHalf * c;
      float p = 0.f;
      if (rg < n_rows && visible(rg / gq, j0 + sk, s_valid, causal, window))
        p = expf(s[a][c] * scale - sm.lse[r]);
      sm.p[r * (kTile + 1) + sk] = p;
      sm.ds[r * (kTile + 1) + sk] = p * (dp[a][c] - sm.delta[r]);
    }
  }
}

// delta[b, head, qi] = sum_d dO * O over one row, a warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int H, int D) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * Sq * H) return;
  // row = (b * Sq + qi) * H + head, the layout of o
  const int head = static_cast<int>(row % H);
  const long long bq = row / H;
  const int qi = static_cast<int>(bq % Sq), b = static_cast<int>(bq / Sq);
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(pd[d]), to_f(po[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<size_t>(b) * H + head) * Sq + qi] = acc;
}

// dK, dV of one 32-key tile of one kv-head and batch row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                      int H, int Kv, int s_valid, int causal, int window,
                      float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / kHalf;          // columns per thread
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int j0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int gq = H / Kv;
  const int n_rows = Sq * gq;

  // the query positions that can see a key of [j0, j_hi)
  const int j_hi = min(min(j0 + kTile, Skv), s_valid);
  int qi_lo = causal ? j0 : 0;
  int qi_hi = Sq;
  if (window > 0) {
    qi_lo = max(qi_lo, j0 - window + 1);
    qi_hi = min(qi_hi, j_hi - 1 + window);
  }
  if (j_hi <= j0) qi_hi = qi_lo;         // no visible key in the tile

  load_keys<T, D>(sm, k, v, j0, b, h, Skv, Kv);

  // thread (kj, dc): keys kj, kj + 16; columns dc + 16 c
  const int kj = threadIdx.x / kHalf, dc = threadIdx.x % kHalf;
  float acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int r0 = qi_lo * gq; r0 < qi_hi * gq; r0 += kTile) {
    __syncthreads();   // the keys are staged / the last tile's sums are done
    load_rows<T, D>(sm, q, dout, lse, delta, r0, b, h, Sq, H, gq, n_rows);
    __syncthreads();
    weights<D>(sm, r0, j0, gq, n_rows, s_valid, causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float p0 = sm.p[r * (kTile + 1) + kj];
      const float p1 = sm.p[r * (kTile + 1) + kj + kHalf];
      const float s0 = sm.ds[r * (kTile + 1) + kj];
      const float s1 = sm.ds[r * (kTile + 1) + kj + kHalf];
      const float* orow = sm.dout + r * DP + dc;
      const float* qrow = sm.q + r * DP + dc;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float ox = orow[kHalf * c], qx = qrow[kHalf * c];
        acc_v[0][c] = fmaf(p0, ox, acc_v[0][c]);
        acc_v[1][c] = fmaf(p1, ox, acc_v[1][c]);
        acc_k[0][c] = fmaf(s0, qx, acc_k[0][c]);
        acc_k[1][c] = fmaf(s1, qx, acc_k[1][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = j0 + kj + kHalf * a;
    if (key >= Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * Skv + key) * Kv + h) * D + dc;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + kHalf * c] = from_f<T>(acc_k[a][c] * scale);
      dv[off + kHalf * c] = from_f<T>(acc_v[a][c]);
    }
  }
}

// dQ of one 32-row tile of one kv-head and batch row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Skv, int H, int Kv,
                    int s_valid, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / kHalf;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int r0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int gq = H / Kv;
  const int n_rows = Sq * gq;

  // the keys some row of the tile can see (the forward's kv_range)
  const int q_lo = r0 / gq;
  const int q_hi = (min(r0 + kTile, n_rows) - 1) / gq;
  int hi = s_valid;
  if (causal) hi = min(hi, q_hi + 1);
  else if (window > 0) hi = min(hi, q_hi + window);
  const int lo = window > 0 ? max(0, q_lo - window + 1) : 0;

  load_rows<T, D>(sm, q, dout, lse, delta, r0, b, h, Sq, H, gq, n_rows);

  // thread (ri, dc): rows ri, ri + 16; columns dc + 16 c
  const int ri = threadIdx.x / kHalf, dc = threadIdx.x % kHalf;
  float acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int j0 = lo / kTile * kTile; j0 < hi; j0 += kTile) {
    __syncthreads();   // the rows are staged / the last tile's sums are done
    load_keys<T, D>(sm, k, v, j0, b, h, Skv, Kv);
    __syncthreads();
    weights<D>(sm, r0, j0, gq, n_rows, s_valid, causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kTile; ++s) {
      const float s0 = sm.ds[ri * (kTile + 1) + s];
      const float s1 = sm.ds[(ri + kHalf) * (kTile + 1) + s];
      const float* krow = sm.k + s * DP + dc;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kx = krow[kHalf * c];
        acc[0][c] = fmaf(s0, kx, acc[0][c]);
        acc[1][c] = fmaf(s1, kx, acc[1][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int rg = r0 + ri + kHalf * a;
    if (rg >= n_rows) continue;
    const int qi = rg / gq, g = rg % gq;
    const size_t off = ((static_cast<size_t>(b) * Sq + qi) * H + h * gq + g) * D + dc;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[off + kHalf * c] = from_f<T>(acc[a][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, float* delta, void* dq, void* dk,
           void* dv, int B, int Sq, int Skv, int H, int Kv, int s_valid,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);

  const long long rows = static_cast<long long>(B) * Sq * H;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
                              kThreads, 0, stream>>>(static_cast<const T*>(o), dot, delta,
                                                     B, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((Skv + kTile - 1) / kTile, Kv, B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, kSmem, stream>>>(
      qt, kt, vt, dot, lt, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv,
      H, Kv, s_valid, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long row_tiles = (static_cast<long long>(Sq) * (H / Kv) + kTile - 1) / kTile;
  const dim3 grid_q(static_cast<unsigned>(row_tiles), Kv, B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, kSmem, stream>>>(
      qt, kt, vt, dot, lt, delta, static_cast<T*>(dq), Sq, Skv, H, Kv, s_valid,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, float* delta, void* dq, void* dk,
             void* dv, int B, int Sq, int Skv, int H, int Kv, int s_valid,
             int causal, int window, float scale, cudaStream_t st) {
  if (D == 32)
    return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv,
                         s_valid, causal, window, scale, st);
  if (D == 48)
    return launch<T, 48>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv,
                         s_valid, causal, window, scale, st);
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv,
                         s_valid, causal, window, scale, st);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv,
                          s_valid, causal, window, scale, st);
  if (D == 256)
    return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv,
                          s_valid, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Skv, Kv, D]; all
// contiguous, of one dtype (0 = float32, 1 = bfloat16); lse (the forward's)
// and delta (scratch, written here): fp32 [B, H, Sq]. H a multiple of Kv;
// D 32, 48, 64, 128 or 256; 1 <= s_valid <= Skv; causal 0/1; window <= 0
// means no window. Launches three kernels on `stream`; returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B,
                                   int Sq, int Skv, int H, int Kv, int D, int s_valid,
                                   int causal, int window, float scale, int dtype,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Kv < 1 || H % Kv != 0 || s_valid < 1 ||
      s_valid > Skv || Kv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, dout, lse, dl, dq, dk, dv, B, Sq, Skv, H, Kv,
                           s_valid, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, dout, lse, dl, dq, dk, dv, B, Sq, Skv,
                                   H, Kv, s_valid, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
