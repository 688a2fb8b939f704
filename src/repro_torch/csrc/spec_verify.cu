// Row argmax over the vocabulary for greedy speculative verification, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spec_verify.py
// (blockwise_argmax, pallas_call at :47), reached through
// verify_greedy_fused. Same function: the argmax of each row of the
// [B*(gamma+1), V] fp32 target logits, with ties going to the LOWEST index
// (what jnp.argmax and torch.argmax return); a NaN counts as the maximum,
// as in both of those. The acceptance epilogue (cumprod of matches, bonus
// token) stays in plain torch, as the JAX version leaves it in jnp.
//
// What bounds it on the H100: one compare per logit read, so it is bound by
// the logits bytes (B*(gamma+1)*V*4, ~10 MB at full width).
//
// Design. The TPU kernel streamed vocab blocks through a sequential grid
// axis with a running (max, idx) in scratch. With only B*(gamma+1) ~ 20 rows,
// one block per row would leave most of the 132 SMs idle, so each row is cut
// into chunks of kChunk logits: pass 1 runs one block per (chunk, row), each
// thread keeping its own (max, idx) and the block reducing them (warp
// shuffles, then shared memory) to one partial per chunk; pass 2 reduces a
// row's partials with one warp. Every comparison breaks ties by the lower
// index, so the result does not depend on the order of the reduction.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;

// does (v, i) beat (m, mi)?
__device__ __forceinline__ bool better(float v, int i, float m, int mi) {
  const bool vn = isnan(v), mn = isnan(m);
  if (vn || mn) return vn && (!mn || i < mi);
  return v > m || (v == m && i < mi);
}

__device__ __forceinline__ void warp_reduce(float& m, int& mi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(0xffffffffu, m, off);
    const int oi = __shfl_down_sync(0xffffffffu, mi, off);
    if (better(om, oi, m, mi)) {
      m = om;
      mi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_chunks(const float* __restrict__ logits, float* __restrict__ part_m,
              int* __restrict__ part_i, int V, int n_chunks) {
  const int c = blockIdx.x;
  const int r = blockIdx.y;
  const float* row = logits + static_cast<size_t>(r) * V;
  const int start = c * kChunk;
  const int stop = min(start + kChunk, V);

  float m = -INFINITY;
  int mi = INT_MAX;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = start + k * kThreads + threadIdx.x;
    if (i < stop) {
      const float v = row[i];
      if (better(v, i, m, mi)) {
        m = v;
        mi = i;
      }
    }
  }
  warp_reduce(m, mi);

  __shared__ float sm[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm[warp] = m;
    si[warp] = mi;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? sm[lane] : -INFINITY;
    mi = lane < kThreads / 32 ? si[lane] : INT_MAX;
    warp_reduce(m, mi);
    if (lane == 0) {
      part_m[static_cast<size_t>(r) * n_chunks + c] = m;
      part_i[static_cast<size_t>(r) * n_chunks + c] = mi;
    }
  }
}

__global__ void argmax_rows(const float* __restrict__ part_m,
                            const int* __restrict__ part_i,
                            int* __restrict__ out, int n_chunks) {
  const int r = blockIdx.x;
  float m = -INFINITY;
  int mi = INT_MAX;
  for (int c = threadIdx.x; c < n_chunks; c += 32) {
    const float v = part_m[static_cast<size_t>(r) * n_chunks + c];
    const int i = part_i[static_cast<size_t>(r) * n_chunks + c];
    if (better(v, i, m, mi)) {
      m = v;
      mi = i;
    }
  }
  warp_reduce(m, mi);
  if (threadIdx.x == 0) out[r] = mi;
}

}  // namespace

// Number of chunks a row of V logits is cut into: the caller allocates
// the [R, n_chunks] partial buffers (fp32 maxima, int32 indices).
extern "C" int row_argmax_chunks(int V) { return (V + kChunk - 1) / kChunk; }

// logits: [R, V] fp32, contiguous; out: [R] int32. Returns a cudaError_t.
extern "C" int row_argmax(const void* logits, void* part_m, void* part_i,
                          void* out, int R, int V, void* stream) {
  if (R <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = row_argmax_chunks(V);
  argmax_chunks<<<dim3(n_chunks, R), kThreads, 0, st>>>(
      static_cast<const float*>(logits), static_cast<float*>(part_m),
      static_cast<int*>(part_i), V, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_rows<<<R, 32, 0, st>>>(static_cast<const float*>(part_m),
                                static_cast<const int*>(part_i),
                                static_cast<int*>(out), n_chunks);
  return static_cast<int>(cudaGetLastError());
}
