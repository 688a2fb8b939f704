// Chunked Mamba-2 SSD scan from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// pallas_call at :80). Same function: x [b, l, h, p] (pre-multiplied by dt),
// dA [b, l, h] (log-decay, negative), B and C [b, l, h, n], all fp32, give
// y [b, l, h, p] fp32; per chunk of Q rows (a_cs = cumsum of dA in the chunk)
//   y     = ((C B^T) o Ldec) X + exp(a_cs) o (C state^T)
//   state = exp(a_cs[Q-1]) state + X^T (B o exp(a_cs[Q-1] - a_cs))
// with Ldec[i][j] = exp(a_cs[i] - a_cs[j]) for j <= i and 0 above the
// diagonal. Above the diagonal a_cs[i] - a_cs[j] is positive and exp can
// overflow to inf, so the mask SELECTS 0 there (as the TPU kernel's
// jnp.where does) and never multiplies an inf by 0. Rows at or past l are
// the zero padding of the JAX wrapper (ops.py pads dA, x, B, C with 0): they
// are never read, and only the l real rows are written.
//
// Exactness. Row i's output reads only rows <= i, and every sum runs in a
// fixed order that depends on Q alone (the cumsum of the chunk sequentially
// from its first row, dot products over n and the causal sum over j in index
// order, one thread per output element), never on l. So a row's value does
// not depend on how long the buffer is: the no-cache engine's target pass
// (a buffer of P + max_new + gamma + 2 rows) and autoregressive steps (P +
// max_new rows) agree on every row they share, bit for bit.
//
// What bounds it on the H100: on the main path (b = 2, l = 134 padded to two
// chunks of 128, h = 48, p = 64, n = 128) it reads x, dA, B and C and writes y
// once, ~38 MB with B and C counted per head (the model hands them as a
// stride-0 view over heads, so the card reads far fewer), ~0.011 ms at
// 3.35 TB/s; the chunk products are ~2 GFLOP of fp32 work over the padded
// rows, ~0.030 ms at the 67 TFLOP/s of the CUDA cores. Operations bound it.
// fp32 FFMA, not TF32: the plain version runs with TF32 off.
//
// Design. The TPU kernel walks a sequential grid axis over chunks and keeps
// the [p, n] state in VMEM scratch; here one thread block per (batch row,
// head) walks the chunks in a loop and keeps the state in shared memory
// (64 x 129 floats at full width), zeroed at the start. Per chunk the block
// stages B [Q, n] and X [Q, p] in shared memory (B rows padded to n + 1
// floats, so the column-parallel reads are free of bank conflicts), computes
// the chunk's cumsum, then walks the valid rows in tiles of kRowTile: it
// stages the tile's C rows, forms the tile's causal scores [kRowTile, Q]
// (each score one thread's dot product over n) and then each output element
// (one thread each) as the causal sum over the scores plus the decayed state
// read. The state is updated only when another chunk follows, so a final
// partial chunk computes only its real rows. Operands are read through
// their strides, so the group broadcast of B and C to heads (stride 0) and
// the views the model splits out of its projections cost no copy. With one
// block per (batch row, head), the main path fills 96 (target) or 48
// (drafter) of the 132 SMs: low occupancy, left as it is here. Simple
// first: scalar loads, fp32 CUDA-core math, no register tiling; tensor cores
// (TF32 is not exact enough for the plain version's tolerance unless split
// in three), TMA and a split over chunks are for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowTile = 32;

struct Strides {
  long long b, l, h, e;   // element strides of the batch, row, head and last axes
};

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, int L, int H, int P, int N, int Q,
                Strides sx, Strides sa, Strides sb, Strides sc) {
  extern __shared__ float smem[];
  const int NP = N + 1;                       // padded row stride of B and the state
  float* st = smem;                           // [P][NP]
  float* Bs = st + P * NP;                    // [Q][NP]
  float* Xs = Bs + Q * NP;                    // [Q][P]
  float* Cs = Xs + Q * P;                     // [kRowTile][N]
  float* Ss = Cs + kRowTile * N;              // [kRowTile][Q]
  float* da = Ss + kRowTile * Q;              // [Q] this chunk's dA
  float* acs = da + Q;                        // [Q] its cumsum
  float* eac = acs + Q;                       // [Q] exp(acs)
  float* dec = eac + Q;                       // [Q] exp(acs[Q-1] - acs)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float* xb = x + b * sx.b + h * sx.h;
  const float* ab = dA + b * sa.b + h * sa.h;
  const float* bb = Bm + b * sb.b + h * sb.h;
  const float* cb = Cm + b * sc.b + h * sc.h;
  float* yb = y + (static_cast<long long>(b) * L * H + h) * P;
  const long long y_row = static_cast<long long>(H) * P;

  for (int e = tid; e < P * NP; e += kThreads) st[e] = 0.f;
  const int n_chunks = (L + Q - 1) / Q;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int nv = min(Q, L - t0);            // real rows of this chunk
    __syncthreads();                          // the previous chunk is done with its tiles
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, k = e % N;
      Bs[j * NP + k] = j < nv ? bb[(t0 + j) * sb.l + k * sb.e] : 0.f;
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, k = e % P;
      Xs[j * P + k] = j < nv ? xb[(t0 + j) * sx.l + k * sx.e] : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads) da[j] = j < nv ? ab[(t0 + j) * sa.l] : 0.f;
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) {
      float s = 0.f;                          // sequential: the order depends on j only
      for (int i = 0; i <= j; ++i) s += da[i];
      acs[j] = s;
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) {
      eac[j] = expf(acs[j]);
      dec[j] = expf(acs[Q - 1] - acs[j]);
    }

    for (int r0 = 0; r0 < nv; r0 += kRowTile) {
      const int nr = min(kRowTile, nv - r0);
      const int jn = r0 + nr;                 // columns some row of the tile can see
      __syncthreads();                        // eac/dec written; the previous tile is done
      for (int e = tid; e < nr * N; e += kThreads) {
        const int i = e / N, k = e % N;
        Cs[i * N + k] = cb[(t0 + r0 + i) * sc.l + k * sc.e];
      }
      __syncthreads();
      // causal scores of the tile: (C_i . B_j) * exp(acs[i] - acs[j]), j <= i
      for (int e = tid; e < nr * jn; e += kThreads) {
        const int i = e / jn, j = e % jn;
        const int ig = r0 + i;
        float s = 0.f;
        if (j <= ig) {
          const float* ci = Cs + i * N;
          const float* bj = Bs + j * NP;
          float dot = 0.f;
#pragma unroll 8
          for (int k = 0; k < N; ++k) dot = fmaf(ci[k], bj[k], dot);
          s = dot * expf(acs[ig] - acs[j]);
        }
        Ss[i * Q + j] = s;
      }
      __syncthreads();
      // y = scores . X  +  exp(acs) * (C . state^T); the state term is 0 in chunk 0
      for (int e = tid; e < nr * P; e += kThreads) {
        const int i = e / P, pp = e % P;
        const int ig = r0 + i;
        const float* si = Ss + i * Q;
        float yd = 0.f;
        for (int j = 0; j <= ig; ++j) yd = fmaf(si[j], Xs[j * P + pp], yd);
        float yo = 0.f;
        if (c > 0) {
          const float* ci = Cs + i * N;
          const float* sp = st + pp * NP;
#pragma unroll 8
          for (int k = 0; k < N; ++k) yo = fmaf(ci[k], sp[k], yo);
          yo *= eac[ig];
        }
        yb[(t0 + ig) * y_row + pp] = yd + yo;
      }
    }

    if (c + 1 < n_chunks) {                   // a full chunk: carry the state
      __syncthreads();                        // every row has read the old state
      const float dtot = expf(acs[Q - 1]);
      for (int e = tid; e < P * N; e += kThreads) {
        const int pp = e / N, k = e % N;
        float acc = 0.f;
        for (int j = 0; j < Q; ++j) acc = fmaf(Xs[j * P + pp], dec[j] * Bs[j * NP + k], acc);
        st[pp * NP + k] = dtot * st[pp * NP + k] + acc;
      }
    }
  }
}

size_t smem_bytes(int P, int N, int Q) {
  const size_t NP = N + 1;
  return sizeof(float) * (P * NP + Q * NP + static_cast<size_t>(Q) * P +
                          kRowTile * N + kRowTile * Q + 4 * Q);
}

}  // namespace

// x/y: [b, l, h, p]; dA: [b, l, h]; B/C: [b, l, h, n]; fp32; x, dA, B and C
// read through the given element strides (batch, row, head, last axis; dA
// has no last axis), y written contiguous. 1 <= p <= 64, 1 <= n <= 128,
// 1 <= chunk <= 128. Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const void* dA, const void* Bm,
                            const void* Cm, void* y, int b, int l, int h,
                            int p, int n, int chunk, long long x_sb,
                            long long x_sl, long long x_sh, long long x_sp,
                            long long a_sb, long long a_sl, long long a_sh,
                            long long b_sb, long long b_sl, long long b_sh,
                            long long b_sn, long long c_sb, long long c_sl,
                            long long c_sh, long long c_sn, void* stream) {
  if (b < 1 || l < 1 || h < 1 || p < 1 || p > 64 || n < 1 || n > 128 ||
      chunk < 1 || chunk > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(p, n, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sx{x_sb, x_sl, x_sh, x_sp}, sa{a_sb, a_sl, a_sh, 0},
      sb{b_sb, b_sl, b_sh, b_sn}, sc{c_sb, c_sl, c_sh, c_sn};
  ssd_scan_kernel<<<b * h, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), l, h, p, n, chunk, sx, sa, sb, sc);
  return static_cast<int>(cudaGetLastError());
}
