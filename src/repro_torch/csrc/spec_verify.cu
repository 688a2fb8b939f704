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
// the logits bytes (B*(gamma+1)*V*4, ~10 MB at full width: 0.0031 ms at
// 3.35 TB/s). At that size a launch and the trip to memory and back are
// most of the time, so the design spends one launch and one pass.
//
// Design. The TPU kernel streamed vocab blocks through a sequential grid
// axis with a running (max, idx) in scratch. Here each row is one thread
// block cluster of up to 8 blocks (kernels/spec_verify.py::plan sizes it
// from V), so ~20 rows fill the 132 SMs in a single launch. A block takes a
// contiguous share of its row's 16-byte-aligned body as float4 streaming
// loads (kUnroll in flight per thread); the first block also takes the
// scalar head before the first aligned address, the last the scalar tail.
// Each thread keeps its own (max, idx); the block reduces them (warp
// shuffles, then shared memory), and block 0 of the cluster reads the other
// blocks' results through distributed shared memory and writes the row's
// index. No partial buffer leaves the card's shared memory. Every
// comparison breaks ties by the lower index, so the result does not depend
// on the order of the reduction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxCluster = 8;

// does (v, i) beat (m, mi)?
__device__ __forceinline__ bool better(float v, int i, float m, int mi) {
  const bool vn = isnan(v), mn = isnan(m);
  if (vn || mn) return vn && (!mn || i < mi);
  return v > m || (v == m && i < mi);
}

__device__ __forceinline__ void take(float v, int i, float& m, int& mi) {
  if (better(v, i, m, mi)) {
    m = v;
    mi = i;
  }
}

__device__ __forceinline__ void warp_reduce(float& m, int& mi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(0xffffffffu, m, off);
    const int oi = __shfl_down_sync(0xffffffffu, mi, off);
    take(om, oi, m, mi);
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_cluster_kernel(const float* __restrict__ logits, int* __restrict__ out, int V) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const float* row = logits + static_cast<size_t>(blockIdx.y) * V;
  // the row: a scalar head up to the first 16-byte boundary, a float4 body,
  // a scalar tail
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const int head = min(V, (4 - mis) & 3);
  const int n4 = (V - head) >> 2;
  const int tail = head + 4 * n4;
  const int per = (n4 + n_blocks - 1) / n_blocks;
  const int q0 = min(n4, rank * per), q1 = min(n4, q0 + per);

  float m = -INFINITY;
  int mi = INT_MAX;
  if (rank == 0)
    for (int i = threadIdx.x; i < head; i += kThreads) take(row[i], i, m, mi);
  const float4* body = reinterpret_cast<const float4*>(row + head);
  for (int q = q0 + threadIdx.x; q < q1; q += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int qq = q + u * kThreads;
      if (qq < q1) v[u] = __ldcs(body + qq);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int qq = q + u * kThreads;
      if (qq < q1) {
        const int i = head + 4 * qq;
        take(v[u].x, i, m, mi);
        take(v[u].y, i + 1, m, mi);
        take(v[u].z, i + 2, m, mi);
        take(v[u].w, i + 3, m, mi);
      }
    }
  }
  if (rank == n_blocks - 1)
    for (int i = tail + threadIdx.x; i < V; i += kThreads) take(row[i], i, m, mi);
  warp_reduce(m, mi);

  __shared__ float wm[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ float block_m;
  __shared__ int block_i;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wm[warp] = m;
    wi[warp] = mi;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? wm[lane] : -INFINITY;
    mi = lane < kThreads / 32 ? wi[lane] : INT_MAX;
    warp_reduce(m, mi);
    if (lane == 0) {
      block_m = m;
      block_i = mi;
    }
  }
  cluster.sync();                    // every block's (max, idx) is in its shared memory
  if (rank == 0 && warp == 0) {
    m = -INFINITY;
    mi = INT_MAX;
    if (lane < n_blocks) {
      m = *cluster.map_shared_rank(&block_m, lane);
      mi = *cluster.map_shared_rank(&block_i, lane);
    }
    warp_reduce(m, mi);
    if (lane == 0) out[blockIdx.y] = mi;
  }
  cluster.sync();                    // no block leaves while block 0 reads it
}

}  // namespace

// logits: [R, V] fp32, contiguous; out: [R] int32; cluster: blocks per row,
// 1..8. One launch. Returns a cudaError_t.
extern "C" int row_argmax(const void* logits, void* out, int R, int V,
                          int cluster, void* stream) {
  if (R <= 0 || R > 65535 || V <= 0 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, R, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, argmax_cluster_kernel, static_cast<const float*>(logits),
      static_cast<int*>(out), V));
}
