// Paged flash attention over a KV block pool, for Hopper (sm_90a), with two
// mask policies: causal (paged_attention_fwd) and tree (tree_attention_fwd).
//
// Causal replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_flash_attention, pallas_call at :132). Same function: GQA attention
// of Q query rows per sequence, at positions index..index+Q-1, over a
// [NB, BS, Kv, D] block pool whose block ids are read from the row's block
// table inside the kernel; causal, optional sliding window, online softmax
// in fp32 with NEG_INF = -1e30 masking, a 1e-30 denominator floor, scale
// D**-0.5 and the per-row live bound min(ceil((idx+Q)/BS), ceil(max_live/BS)).
//
// Tree replaces src/repro/kernels/tree_attention.py (tree_flash_attention,
// pallas_call at :161): the same loop for a stacked tree-verify span of
// Q = span <= 31 query slots written at index..index+span-1. Slot s sits at
// RoPE position index + depths[s]; a committed-prefix key (kv_pos < index)
// is causal (+ window), an in-span key at rel = kv_pos - index is visible
// iff bit rel of the slot's int32 ancestor mask bits[s] is set, and keys
// beyond the span are never visible. The wrapper has already folded the
// window's span side into bits. depths/bits are [span] device arrays read
// by slot (the TPU version pre-expands them to rows to avoid a gather).
//
// What bounds it on the H100: at decode and verify (Q = 1, gamma+1 or a
// tree span) the kernel reads each live KV block once per (row, kv-head)
// and does ~4*Q*gq*D flops per KV token — far below the ~20 fp32 flops per
// byte the card needs to be compute bound — so it is bound by the KV bytes
// it reads. At prefill (Q up to 255) the arithmetic grows with Q and the
// fp32 CUDA-core math becomes the limit.
//
// Design. One thread block per (tile of kRowTile query rows, kv-head, row).
// The TPU kernel carried the running (max, denom, acc) across a sequential
// grid axis over KV blocks; here a loop inside the block takes that axis'
// place, so the state never leaves the block: max and denom in shared
// memory, acc in registers (each thread owns one d column of kRowTile /
// (128 / D) query rows). GQA is folded into the rows, as on the TPU: the
// gq query heads that share a kv-head read its KV slab once. Each step
// stages one [BS, D] K and V slab in shared memory (rows padded to D+1
// floats so the score loop is free of bank conflicts). Rows whose table
// points at the NULL block 0 read block 0, which always exists; block ids
// are clamped into the pool so a corrupt table cannot fault. The mask is a
// compile-time policy (kTree), so the block-table walk, the slabs and the
// online softmax exist once and the causal instantiation keeps its own
// statements (the tree-only parameters come last, so the causal ones keep
// their places); the tree policy stages each row's query position and
// ancestor mask in shared memory once. Simple first: scalar loads, fp32
// CUDA-core math; tensor cores (wgmma) and TMA are for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D, bool kTree>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ index,
                       const int* __restrict__ max_live,
                       T* __restrict__ out, int Q, int H, int Kv, int NB,
                       int BS, int MB, int window, float scale,
                       const int* __restrict__ depths,
                       const int* __restrict__ bits) {
  constexpr int DP = D + 1;                       // padded shared row stride
  constexpr int kRowsPerPass = kThreads / D;      // 1 (D=128) or 2 (D=64)
  constexpr int kAcc = kRowTile / kRowsPerPass;   // acc registers per thread

  const int row0 = blockIdx.x * kRowTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int gq = H / Kv;
  const int n_rows = Q * gq;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kRowTile][DP]
  float* k_s = q_s + kRowTile * DP;    // [BS][DP]
  float* v_s = k_s + BS * DP;          // [BS][DP]
  float* p_s = v_s + BS * DP;          // [kRowTile][BS] scores, then probs
  // the tree policy adds, after p_s, each row's query position and ancestor
  // mask ([kRowTile] ints each), declared inside its own branches so the
  // causal instantiation carries nothing of it
  __shared__ float m_s[kRowTile], l_s[kRowTile], a_s[kRowTile];

  const int idx_b = index[b];
  int live = min(max((idx_b + Q + BS - 1) / BS, 1), MB);
  if (max_live != nullptr) {
    const int cap = min(max((*max_live + BS - 1) / BS, 1), MB);
    live = min(live, cap);
  }

  // rows of the tile are (query position, group) pairs, r = qi * gq + g
  for (int e = tid; e < kRowTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int rg = row0 + r;
    float x = 0.f;
    if (rg < n_rows) {
      const int qi = rg / gq, g = rg % gq;
      x = to_f32(q[((static_cast<size_t>(b) * Q + qi) * H + h * gq + g) * D + d]);
    }
    q_s[r * DP + d] = x;
  }
  if (tid < kRowTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    if constexpr (kTree) {
      // rows are (slot, group): r = s * gq + g; padded rows see the prefix
      int* qpos_s = reinterpret_cast<int*>(p_s + kRowTile * BS);
      unsigned* bits_s = reinterpret_cast<unsigned*>(qpos_s + kRowTile);
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
    for (int e = tid; e < BS * D; e += kThreads) {
      const int s = e / D, d = e % D;
      const size_t off = ((static_cast<size_t>(blk) * BS + s) * Kv + h) * D + d;
      k_s[s * DP + d] = to_f32(k_pool[off]);
      v_s[s * DP + d] = to_f32(v_pool[off]);
    }
    __syncthreads();

    // masked, scaled scores
    for (int e = tid; e < kRowTile * BS; e += kThreads) {
      const int r = e / BS, s = e % BS;
      const float* qr = q_s + r * DP;
      const float* ks = k_s + s * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[d], dot);
      if constexpr (kTree) {
        const int* qpos_s = reinterpret_cast<const int*>(p_s + kRowTile * BS);
        const unsigned* bits_s = reinterpret_cast<const unsigned*>(qpos_s + kRowTile);
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
    if (tid < kRowTile) {
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
      store(&out[((static_cast<size_t>(b) * Q + qi) * H + h * gq + g) * D + d_own],
            acc[i] / den);
    }
  }
}

template <typename T, int D, bool kTree>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* index, const void* max_live,
           const void* depths, const void* bits, void* out, int B, int Q,
           int H, int Kv, int NB, int BS, int MB, int window, float scale,
           cudaStream_t stream) {
  constexpr int DP = D + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRowTile) * DP + 2 * static_cast<size_t>(BS) * DP +
                       static_cast<size_t>(kRowTile) * BS) +
      (kTree ? 2 * sizeof(int) * kRowTile : 0);
  auto kernel = paged_attention_kernel<T, D, kTree>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gq = H / Kv;
  const dim3 grid((Q * gq + kRowTile - 1) / kRowTile, Kv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(index), static_cast<const int*>(max_live),
      static_cast<T*>(out), Q, H, Kv, NB, BS, MB, window, scale,
      static_cast<const int*>(depths), static_cast<const int*>(bits));
  return static_cast<int>(cudaGetLastError());
}

template <bool kTree>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* index, const void* max_live,
             const void* depths, const void* bits, void* out, int B, int Q,
             int H, int Kv, int D, int NB, int BS, int MB, int window,
             float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PA_LAUNCH(T, DIM)                                                  \
  return launch<T, DIM, kTree>(q, k_pool, v_pool, block_table, index, max_live, \
                               depths, bits, out, B, Q, H, Kv, NB, BS, MB,     \
                               window, scale, st)
  if (dtype == 0 && D == 64) REPRO_PA_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) REPRO_PA_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) REPRO_PA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_PA_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_PA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means full causal.
// max_live may be null (no cap). Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_table,
                                   const void* index, const void* max_live,
                                   void* out, int B, int Q, int H, int Kv,
                                   int D, int NB, int BS, int MB, int window,
                                   float scale, int dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, block_table, index, max_live,
                         nullptr, nullptr, out, B, Q, H, Kv, D, NB, BS, MB,
                         window, scale, dtype, stream);
}

// The tree policy: q/out [B, span, H, D]; depths/bits int32 [span] (bits
// already windowed on the span side); span <= 31. Other arguments as above.
extern "C" int tree_attention_fwd(const void* q, const void* k_pool,
                                  const void* v_pool, const void* block_table,
                                  const void* index, const void* max_live,
                                  const void* depths, const void* bits,
                                  void* out, int B, int span, int H, int Kv,
                                  int D, int NB, int BS, int MB, int window,
                                  float scale, int dtype, void* stream) {
  if (span < 1 || span > 31) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k_pool, v_pool, block_table, index, max_live,
                        depths, bits, out, B, span, H, Kv, D, NB, BS, MB,
                        window, scale, dtype, stream);
}
