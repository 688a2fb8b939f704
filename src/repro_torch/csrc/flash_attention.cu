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
// writes o once — a few MB — and does 4*H*D flops per visible (query, key)
// pair: ~0.2 GFLOP per call at the Llama-3.2-3B geometry, under the ~295
// flops per byte the bf16 tensor cores need. The bound is the bytes (~1 µs
// at 3.35 TB/s); at S = 2048 the pairs grow as S^2 and the operations bound
// it instead.
//
// Design. The TPU kernel carried (max, denom, acc) across a sequential grid
// axis over KV blocks; here a loop inside the block takes that axis' place.
// One thread block per (tile of kRowTile query rows, kv-head, batch row).
// The tile's rows are (position, group) pairs, r = qi * gq + g, so each K/V
// slab is read once for all gq query heads that share the kv-head, as the
// TPU kernel folds them. Each step stages one [kKvTile, D] K and V slab in
// shared memory as fp32 (K rows padded to D+1 floats, so the score loop is
// free of bank conflicts). kKvTile is one warp: each warp owns 4 rows of
// the tile, each lane one key of the slab, so the max and the sum of the
// online softmax are warp shuffles and the row state (max, denom) stays in
// the warp's registers. For the weighted sum each thread owns one d column
// of kRowTile / (128 / D) rows. The KV loop runs only over the slabs some
// row of the tile can see: it stops at the causal limit of the tile's last
// row (and at s_valid), and with a window starts at the window of its first
// row. That is exact: a slab masked for every row adds weight exactly 0
// once a visible key has arrived, and every row with a visible key finds it
// inside the walked range. Keys past the walked range are zero-filled, so a
// masked key's weight 0 never meets a NaN. Simple first: scalar loads, fp32
// CUDA-core math; tensor cores (wgmma), TMA and a split of long KV walks are
// for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;
constexpr int kRowsPerWarp = kRowTile / kWarps;   // 4
constexpr int kKvTile = 32;                        // one key per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int Kv, int s_valid, int causal,
                       int window, float scale) {
  constexpr int DP = D + 1;                       // padded K row stride
  constexpr int kRowsPerPass = kThreads / D;      // 1 (D=128) or 2 (D=64)
  constexpr int kAcc = kRowTile / kRowsPerPass;   // acc registers per thread

  __shared__ float q_s[kRowTile * DP];
  __shared__ float k_s[kKvTile * DP];
  __shared__ float v_s[kKvTile * D];
  __shared__ float p_s[kRowTile * kKvTile];       // this slab's weights
  __shared__ float a_s[kRowTile];                 // this slab's rescale
  __shared__ float l_s[kRowTile];                 // final denominators

  const int row0 = blockIdx.x * kRowTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = H / Kv;
  const int n_rows = Sq * gq;

  for (int e = tid; e < kRowTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int rg = row0 + r;
    float x = 0.f;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      x = to_f32(q[((static_cast<size_t>(b) * Sq + qi) * H + h * gq + g) * D + d]);
    }
    q_s[r * DP + d] = x;
  }

  // the KV range some row of the tile can see
  const int q_lo = row0 / gq;
  const int q_hi = (min(row0 + kRowTile, n_rows) - 1) / gq;
  int kv_hi = s_valid;
  if (causal) kv_hi = min(kv_hi, q_hi + 1);
  else if (window > 0) kv_hi = min(kv_hi, q_hi + window);
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  const int d_own = tid % D;
  const int r_own = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int j = kv_lo / kKvTile * kKvTile; j < kv_hi; j += kKvTile) {
    __syncthreads();   // q_s is staged / the previous step is done with the slabs
    for (int e = tid; e < kKvTile * D; e += kThreads) {
      const int s = e / D, d = e % D;
      const int kv = j + s;
      float kx = 0.f, vx = 0.f;
      if (kv < kv_hi) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kv) * Kv + h) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
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
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
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
      p_s[r * kKvTile + lane] = p;
      if (lane == 0) a_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r_own + i * kRowsPerPass;
      const float* pr = p_s + r * kKvTile;
      float pv = 0.f;
#pragma unroll 8
      for (int s = 0; s < kKvTile; ++s) pv = fmaf(pr[s], v_s[s * D + d_own], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp * kRowsPerWarp + i] = l_r[i];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r_own + i * kRowsPerPass;
    const int rg = row0 + r;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      store(&out[((static_cast<size_t>(b) * Sq + qi) * H + h * gq + g) * D + d_own],
            acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Kv, int s_valid, int causal,
           int window, float scale, cudaStream_t stream) {
  const int gq = H / Kv;
  const dim3 grid((Sq * gq + kRowTile - 1) / kRowTile, Kv, B);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Kv,
      s_valid, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: [B, Sq, H, D]; k/v: [B, Skv, Kv, D]; all contiguous, of one dtype
// (0 = float32, 1 = bfloat16); H a multiple of Kv; D 64 or 128;
// 1 <= s_valid <= Skv; causal 0/1; window <= 0 means no window. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int Kv, int D, int s_valid, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Kv < 1 || H % Kv != 0 || s_valid < 1 ||
      s_valid > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_LAUNCH(T, DIM) \
  return launch<T, DIM>(q, k, v, out, B, Sq, Skv, H, Kv, s_valid, causal, window, scale, st)
  if (dtype == 0 && D == 64) REPRO_FA_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) REPRO_FA_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) REPRO_FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_FA_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_FA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
