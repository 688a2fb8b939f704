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
// What bounds it on the H100: operations. On the main path (b = 2, l = 134:
// a chunk of 128 rows and one of 6, h = 48, p = 64, n = 128) the work the
// chunked algorithm needs over the real rows is 316.7 MFLOP (C B^T once per
// batch row, since B and C are one group broadcast to every head; the causal
// product with X and the state read per head; the state update of chunk 0
// per head), 0.0047 ms at the 67 TFLOP/s of the CUDA cores; the drafter
// (h = 24) needs 160.5 MFLOP, 0.0024 ms. The bytes (x, dA, y, one copy of B
// and C: ~5 MB) take ~0.0015 ms. Three limits held the first port of this
// kernel (one block per (batch row, head), walking its chunks) at 0.16 ms:
// every FMA read two or three operands from shared memory, 96 (48) blocks
// left 36 (84) of the 132 SMs idle, and every head recomputed the same
// C B^T.
//
// Design. Two kernels, launched back to back (one wrapper launch):
//  * ssd_chunk_kernel: one block per work item, of two kinds.
//    - A y item: (batch row, group of HG heads, chunk, 16-row tile), the
//      tiles with the most causal columns first. The block forms the tile's
//      causal scores C_i . B_j once for the group (HG > 1 only when B and C
//      have head stride 0, as ssm_mix passes them), writes each head's
//      decayed scores to shared memory and multiplies them by the heads' X:
//      y_diag for every row of the tile.
//    - A state item: (batch row, head, chunk that has a successor, 64 state
//      columns): the chunk's contribution X^T (B o exp(a_cs[Q-1] - a_cs)) to
//      the next state, into an fp32 workspace [b, h, nc - 1, n, p4].
//    Both stream their operands through a ring of three shared-memory stage
//    buffers filled by 16-byte cp.async (plain loads, none past a row's
//    end, when a row is not 16-byte aligned or p or n is not a multiple of
//    4), two stages in flight ahead of the one computed.
//  * ssd_carry_kernel, a programmatic dependent launch (its launch overlaps
//    the first kernel; griddepcontrol.wait holds it until the first grid's
//    writes are visible): one block per (batch row, head, 64-row tile) walks
//    chunks 1..nc-1, carrying the state in shared memory
//    (state' = exp(a_cs[Q-1]) state + contribution, in chunk order), and
//    adds exp(a_cs) o (C state^T) to y_diag for its rows, the k range split
//    over four groups of warps. At l <= chunk it is not launched.
// Every product is register-tiled fp32 FFMA: a thread owns up to 4 x 4
// outputs and reads its operands as float4s from shared memory, laid out so
// a warp's reads are one or a few wavefronts. The plan
// (kernels/ssd_scan.py::plan) picks HG in {4, 2, 1} so the y items of one
// chunk fill half the card. What bounds the kernel now is not arithmetic
// but the latency of each block's chain of stages (a cp.async wait and a
// barrier each) at 16 warps per SM: running the y and state products on
// the tensor cores in 3xTF32 (mma.sync m16n8k8, a hi/lo split of every
// operand) left the main path's time unchanged, so the exact fp32 products
// stay.
//
// Exactness. Row i's output reads only rows <= i, and every sum runs in an
// order fixed by the chunk length and the row alone: the chunk's cumsum (one
// warp: lane t sums rows 4t..4t+3 in order, then a Hillis-Steele scan adds
// the lanes below), each score's dot over k = 0..n-1, each y_diag's sum over
// j = 0, 1, ... (terms above the diagonal or past the real rows are exact
// zeros), each contribution's sum over the chunk's rows in order, the state
// recurrence over chunks 0, 1, ... and the dot of C with the state over k
// (four k groups, added in group order). Nothing depends on l, b, h, the
// plan's head groups, or the card: the no-cache engine's target pass (a
// buffer of P + max_new + gamma + 2 rows) and autoregressive steps (P +
// max_new rows) agree on every row they share, bit for bit (chip_smoke.py's
// "ssd_l_invariance" case).

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;          // largest chunk
constexpr int kN = 128;          // largest state size
constexpr int kP = 64;           // largest head dim
constexpr int kRowTile = 16;     // rows of a y tile
constexpr int kSlab = 32;        // score depth of a B slab; rows of a state item's stage
constexpr int kXRows = 16;       // rows of a y item's X slab
constexpr int kRing = 3;         // stage buffers: kRing - 1 stages in flight
constexpr int kKTile = 64;       // state columns of a state item
constexpr int kCarryRows = 64;   // rows of a carry block

struct Strides {
  long long b, l, h, e;   // element strides of the batch, row, head and last axes
};

// The call's geometry and work items (kernels/ssd_scan.py::plan mirrors it).
struct Shape {
  int B, L, H, P, N, Q;
  int P4;            // row stride of a workspace state: p rounded up to 4
  int nc;            // chunks
  int last_rows;     // real rows of the last chunk
  int hg;            // heads of a y item
  int groups;        // H / hg
  int full_chunks;   // chunks with Q real rows
  int tiles_full, tiles_last;   // 16-row tiles of a full and of the last chunk
  int k_tiles;       // state items per (batch row, head, chunk)
  int carry_tiles;   // carry blocks per (batch row, head)
  int y_full, n_state, y_last;
};

__device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float comp(const float4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// One float4 of shared memory at dst from global src[0, 4) (src + m * e),
// zero where !valid and for m >= cols (cols: the row's columns left from
// src): a 16-byte cp.async when VEC (src contiguous and 16-byte aligned, the
// row width a multiple of 4, so cols >= 4 wherever valid), else up to four
// plain loads, none past the row.
template <bool VEC>
__device__ __forceinline__ void stage4(float* dst, const float* src, long long e,
                                       bool valid, int cols) {
  if constexpr (VEC) {
    cp_async16(smem_u32(dst), src, valid);   // not read when !valid
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) dst[m] = valid && m < cols ? src[m * e] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void commit() {
  if constexpr (VEC) cp_async_commit();
}

// every staged copy but the newest kRing - 2 groups has landed
template <bool VEC>
__device__ __forceinline__ void wait_older() {
  if constexpr (VEC) cp_async_wait<kRing - 2>();
}

// Inclusive cumsum of one chunk's dA (rows >= nv read as 0) into acs[0, kQ),
// by one warp: lane t holds rows 4t..4t+3 and sums them in order, then adds
// the sum of the lanes below (a Hillis-Steele scan over lane totals). Row
// j's sum runs in an order fixed by j alone.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             long long stride, int nv,
                                             float* acs, int lane) {
  float v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = 4 * lane + m;
    v[m] = j < nv ? a[j * stride] : 0.f;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float t = v[3];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, t, d);
    if (lane >= d) t = u + t;
  }
  float below = __shfl_up_sync(0xffffffffu, t, 1);
  if (lane == 0) below = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) acs[4 * lane + m] = below + v[m];
}

// One B slab's part of a tile's scores: acc[a][q] += C[2 rg + a][k] B[cb +
// 32 q][k] over the slab's kSlab columns k in order, for the NQ column
// groups the tile's rows can see. The four k of a float4 are outermost, so
// consecutive FMAs feed 2 NQ different sums.
template <int NQ>
__device__ __forceinline__ void score_slab(float (&acc)[2][4], const float* c0,
                                           const float* b0) {
#pragma unroll 2
  for (int kk = 0; kk < kSlab; kk += 4) {
    const float4 c4[2] = {*reinterpret_cast<const float4*>(c0 + kk),
                          *reinterpret_cast<const float4*>(c0 + (kN + 4) + kk)};
    float4 b4[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      b4[q] = *reinterpret_cast<const float4*>(b0 + 32 * q * (kSlab + 4) + kk);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[a][q] = fmaf(comp(c4[a], m), comp(b4[q], m), acc[a][q]);
  }
}

template <int HG>
struct YSmem {
  static constexpr int kAcs = HG * kQ;                       // [HG][kQ]
  static constexpr int kCs = kRowTile * (kN + 4);            // [kRowTile][kN + 4]
  static constexpr int kSpRow = kQ + 4;                      // a row of decayed scores
  static constexpr int kSpHead = kRowTile * kSpRow + 4;      // one head's [kRowTile][kSpRow]
  static constexpr int kSp = HG * kSpHead;                   // [HG][kRowTile][kSpRow]
  static constexpr int kXw = HG * kP + 4;                    // X slab row stride
  static constexpr int kBslab = kQ * (kSlab + 4);            // [kQ][kSlab + 4]
  static constexpr int kXslab = kXRows * kXw;                // [kXRows][HG * kP + 4]
  static constexpr int kU = kBslab > kXslab ? kBslab : kXslab;   // one ring buffer
  static constexpr int kFloats = kAcs + kCs + kSp + kRing * kU;
};

constexpr int kStateStage = kSlab * (kP + 4) + kSlab * (kKTile + 4);
constexpr int kStateFloats = kQ + kQ + kRing * kStateStage;
constexpr int kKGroups = 4;      // k groups of the carry product
constexpr int kCarryFloats =
    kN * (kP + 4) + kN * (kCarryRows + 4) + kKGroups * kRowTile * (kP + 4) + kQ;

template <int HG>
constexpr size_t chunk_smem_bytes() {
  return sizeof(float) * (YSmem<HG>::kFloats > kStateFloats ? YSmem<HG>::kFloats
                                                            : kStateFloats);
}

// A y item: the rows of 16-row tile t of chunk c, heads h0..h0+HG-1. It
// runs its score stages (B slabs of kSlab state columns; the first also
// brings the tile's C rows), then its y stages (X slabs of kXRows rows),
// through a ring of kRing buffers, kRing - 1 stages in flight ahead of the
// one computed.
template <int HG, bool VEC>
__device__ void y_item(float* smem, const float* __restrict__ x,
                       const float* __restrict__ dA, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       const Shape& s, const Strides& sx, const Strides& sa,
                       const Strides& sb, const Strides& sc, int bb, int h0,
                       int c, int t, int nv) {
  using S = YSmem<HG>;
  float* acs = smem;
  float* Cs = acs + S::kAcs;
  float* Sp = Cs + S::kCs;
  float* U = Sp + S::kSp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * s.Q;
  const int Np = round_up(s.N, kSlab);
  const int nk = Np / kSlab;                  // score stages of a tile
  if (warp < HG)
    chunk_cumsum(dA + bb * sa.b + t0 * sa.l + (h0 + warp) * sa.h, sa.l, nv,
                 acs + warp * kQ, lane);
  // B and C of head h0 serve the whole group (HG > 1 only at head stride 0)
  const float* bbase = Bm + bb * sb.b + t0 * sb.l + h0 * sb.h;
  const float* cbase = Cm + bb * sc.b + t0 * sc.l + h0 * sc.h;
  const float* xbase = x + bb * sx.b + t0 * sx.l + h0 * sx.h;
  // the y product's thread tile: rows HG*ty .. +HG, columns 4*tx .. +4 of
  // the group's [HG * kP] (head tx / 16)
  const int ty = tid / (HG * 16), tx = tid % (HG * 16);
  const int hh = tx / 16, pcol = 4 * (tx % 16);
  // the scores' thread tile: rows 2*rg, 2*rg+1 and columns cb + 32 q; a
  // warp spans 4 row pairs and 8 neighbouring columns, so its C and B
  // reads are one shared-memory wavefront each
  const int rg = (warp & 1) * 4 + (lane >> 3), cb = (warp >> 1) * 8 + (lane & 7);

  // the tile: first row, real rows, the columns its rows can see (rounded
  // up to whole score column groups), stage count
  const int r0 = t * kRowTile, nr = min(kRowTile, nv - r0);
  const int Jp = round_up(r0 + nr, kSlab);
  const int n_stages = nk + Jp / kXRows;

  // each thread's share of the staged copies, its addresses computed once:
  // B slab rows tid/8 + 32 i (16-byte column piece tid % 8), X slab rows
  // tid/(16 HG) + (16/HG) i (piece tid % (16 HG): head, 4 columns), C rows
  // tid/32 + 8 i (piece tid % 32)
  constexpr int kXStep = kThreads / (HG * 16);
  const int bj = tid / (kSlab / 4), bk = 4 * (tid % (kSlab / 4));
  const float* bsrc = bbase + bj * sb.l + bk * sb.e;
  const int xj = tid / (HG * 16), xc = tid % (HG * 16);
  const int xp = 4 * (xc % 16);
  const float* xsrc = xbase + xj * sx.l + (xc / 16) * sx.h + xp * sx.e;
  const int ci = tid / (kN / 4), ck = 4 * (tid % (kN / 4));
  auto issue = [&](int g) {
    if (g < n_stages) {
      float* Ub = U + (g % kRing) * S::kU;
      if (g < nk) {
        const int k0 = g * kSlab;
        if (g == 0) {                         // the tile's C rows, with its first B slab
#pragma unroll
          for (int i = 0; i < kRowTile / (kThreads / (kN / 4)); ++i) {
            const int row = ci + i * (kThreads / (kN / 4));
            if (ck < Np)
              stage4<VEC>(&Cs[row * (kN + 4) + ck], cbase + (r0 + row) * sc.l + ck * sc.e,
                          sc.e, row < nr && ck < s.N, s.N - ck);
          }
        }
        // B slab: rows [0, Jp), columns k0 + [0, kSlab)
#pragma unroll
        for (int i = 0; i < kQ / (kThreads / (kSlab / 4)); ++i) {
          const int j = bj + i * (kThreads / (kSlab / 4));
          if (j < Jp)
            stage4<VEC>(&Ub[j * (kSlab + 4) + bk],
                        bsrc + i * (kThreads / (kSlab / 4)) * sb.l + k0 * sb.e, sb.e,
                        j < nv && k0 + bk < s.N, s.N - k0 - bk);
        }
      } else {                                // X slab: rows j0 + [0, kXRows), the group's heads
        const int j0 = (g - nk) * kXRows;
#pragma unroll
        for (int i = 0; i < kXRows / kXStep; ++i) {
          const int jj = xj + i * kXStep;
          stage4<VEC>(&Ub[jj * S::kXw + 4 * xc], xsrc + (j0 + i * kXStep) * sx.l, sx.e,
                      j0 + jj < nv && xp < s.P, s.P - xp);
        }
      }
    }
    commit<VEC>();                            // an empty group past the last stage
  };

  float acc[2][4];
  float yacc[HG][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
#pragma unroll
  for (int r = 0; r < HG; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) yacc[r][q] = 0.f;
  const float* sp = &Sp[hh * S::kSpHead + (HG * ty) * S::kSpRow];
  // g < 0: the first kRing - 1 stages are issued before any is computed
#pragma unroll 1
  for (int g = 1 - kRing; g < n_stages; ++g) {
    if (g >= 0) {
      wait_older<VEC>();
      __syncthreads();                        // stage g landed; stage g-1's buffer is free
    }
    issue(g + kRing - 1);
    if (g < 0) continue;
    const float* Ub = U + (g % kRing) * S::kU;
    if (g < nk) {
      // scores of rows 2*rg + {0, 1}, columns cb + 32 q, over k in order
      const float* c0 = &Cs[(2 * rg) * (kN + 4) + g * kSlab];
      const float* b0 = &Ub[cb * (kSlab + 4)];
      switch (Jp / 32) {                      // column groups the tile's rows can see
        case 1: score_slab<1>(acc, c0, b0); break;
        case 2: score_slab<2>(acc, c0, b0); break;
        case 3: score_slab<3>(acc, c0, b0); break;
        default: score_slab<4>(acc, c0, b0); break;
      }
      if (g == nk - 1) {
        // each head's decayed causal scores: Sp[h][i][j] (read from the
        // next stage on, after its barrier)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int il = 2 * rg + a, i = r0 + il;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = cb + 32 * q;
            const bool vis = j <= i && i < nv;
            if (j < Jp) {
              for (int h2 = 0; h2 < HG; ++h2) {
                const float d = acs[h2 * kQ + i] - acs[h2 * kQ + j];
                Sp[h2 * S::kSpHead + il * S::kSpRow + j] = vis ? acc[a][q] * expf(d) : 0.f;
              }
            }
          }
        }
      }
    } else {
      // y_diag += Sp X over this slab's rows j, in order, 4 at a time
      const int j0 = (g - nk) * kXRows;
#pragma unroll
      for (int jj = 0; jj < kXRows; jj += 4) {
        float4 av[HG], xv[4];
#pragma unroll
        for (int r = 0; r < HG; ++r)
          av[r] = *reinterpret_cast<const float4*>(&sp[r * S::kSpRow + j0 + jj]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          xv[m] = *reinterpret_cast<const float4*>(&Ub[(jj + m) * S::kXw + 4 * tx]);
#pragma unroll
        for (int m = 0; m < 4; ++m)           // j outermost: 4 HG independent sums in a row
#pragma unroll
          for (int r = 0; r < HG; ++r) {
            const float a = comp(av[r], m);
            yacc[r][0] = fmaf(a, xv[m].x, yacc[r][0]);
            yacc[r][1] = fmaf(a, xv[m].y, yacc[r][1]);
            yacc[r][2] = fmaf(a, xv[m].z, yacc[r][2]);
            yacc[r][3] = fmaf(a, xv[m].w, yacc[r][3]);
          }
      }
      if (j0 + kXRows == Jp) {                // the last y stage: store the tile's rows
#pragma unroll
        for (int r = 0; r < HG; ++r) {
          const int il = HG * ty + r;
          if (il < nr && pcol < s.P) {
            float* yr = y + ((static_cast<long long>(bb) * s.L + t0 + r0 + il) * s.H + h0 + hh) * s.P + pcol;
            if constexpr (VEC) {
              *reinterpret_cast<float4*>(yr) =
                  make_float4(yacc[r][0], yacc[r][1], yacc[r][2], yacc[r][3]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (pcol + q < s.P) yr[q] = yacc[r][q];
            }
          }
        }
      }
    }
  }
}

// A state item: columns k0 .. k0+kKTile-1 of chunk c's contribution
// (X o exp(a_cs[Q-1] - a_cs))^T B for head hd, into ws [b, h, nc-1, n, P4],
// the chunk's rows streamed through a ring of kRing stage buffers.
template <bool VEC>
__device__ void state_item(float* smem, const float* __restrict__ x,
                           const float* __restrict__ dA, const float* __restrict__ Bm,
                           float* __restrict__ ws, const Shape& s,
                           const Strides& sx, const Strides& sa, const Strides& sb,
                           int bb, int hd, int c, int kt) {
  float* acs = smem;                          // [kQ]
  float* dec = acs + kQ;                      // [kQ]
  float* ring = dec + kQ;                     // kRing x {X [kSlab][kP + 4], B [kSlab][kKTile + 4]}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * s.Q, k0 = kt * kKTile, Q = s.Q;
  const float* xb = x + bb * sx.b + t0 * sx.l + hd * sx.h;
  const float* bbase = Bm + bb * sb.b + t0 * sb.l + hd * sb.h;
  const int n_stages = (Q + kSlab - 1) / kSlab;
  // each thread stages rows tid/16 + 16 i of both slabs, 16-byte piece tid % 16
  constexpr int kStep = kThreads / (kP / 4);
  static_assert(kP == kKTile, "X and B slabs share the thread layout");
  const int sj = tid / (kP / 4), sp4 = 4 * (tid % (kP / 4));
  const float* xsrc = xb + sj * sx.l + sp4 * sx.e;
  const float* bsrc = bbase + sj * sb.l + (k0 + sp4) * sb.e;
  auto issue = [&](int st) {
    if (st < n_stages) {
      float* Xs = ring + (st % kRing) * kStateStage;
      float* Bs = Xs + kSlab * (kP + 4);
      const int j0 = st * kSlab;
#pragma unroll
      for (int i = 0; i < kSlab / kStep; ++i) {
        const int jj = sj + i * kStep;
        stage4<VEC>(&Xs[jj * (kP + 4) + sp4], xsrc + (j0 + i * kStep) * sx.l, sx.e,
                    j0 + jj < Q && sp4 < s.P, s.P - sp4);
        stage4<VEC>(&Bs[jj * (kKTile + 4) + sp4], bsrc + (j0 + i * kStep) * sb.l, sb.e,
                    j0 + jj < Q && k0 + sp4 < s.N, s.N - k0 - sp4);
      }
    }
    commit<VEC>();
  };
  if (warp == 0)
    chunk_cumsum(dA + bb * sa.b + t0 * sa.l + hd * sa.h, sa.l, Q, acs, lane);
  const int ty = tid / 16, tx = tid % 16;     // rows p = 4 ty .., columns k = 4 tx ..
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
  // st < 0: the first kRing - 1 stages are issued before any is computed
#pragma unroll 1
  for (int st = 1 - kRing; st < n_stages; ++st) {
    if (st >= 0) {
      wait_older<VEC>();
      // X o dec on the pieces this thread staged (its own copies have
      // landed); the barrier then publishes them
      float* Xw = ring + (st % kRing) * kStateStage;
#pragma unroll
      for (int i = 0; i < kSlab / kStep; ++i) {
        const int jj = sj + i * kStep;
        float4* v = reinterpret_cast<float4*>(&Xw[jj * (kP + 4) + sp4]);
        const float dj = dec[st * kSlab + jj];
        *v = make_float4(v->x * dj, v->y * dj, v->z * dj, v->w * dj);
      }
      __syncthreads();                        // stage st visible; stage st-1's buffer free
    }
    issue(st + kRing - 1);
    if (st == -1) {                           // the cumsum is in place after this barrier
      __syncthreads();
      for (int j = tid; j < kQ; j += kThreads) dec[j] = j < Q ? expf(acs[Q - 1] - acs[j]) : 0.f;
      __syncthreads();
    }
    if (st < 0) continue;
    const float* Xs = ring + (st % kRing) * kStateStage;
    const float* Bs = Xs + kSlab * (kP + 4);
#pragma unroll 4
    for (int jj = 0; jj < kSlab; ++jj) {
      const float4 av = *reinterpret_cast<const float4*>(&Xs[jj * (kP + 4) + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[jj * (kKTile + 4) + 4 * tx]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float xa = comp(av, a);
        acc[a][0] = fmaf(xa, bv.x, acc[a][0]);
        acc[a][1] = fmaf(xa, bv.y, acc[a][1]);
        acc[a][2] = fmaf(xa, bv.z, acc[a][2]);
        acc[a][3] = fmaf(xa, bv.w, acc[a][3]);
      }
    }
  }
  if (4 * ty < s.P) {
    float* z = ws + ((static_cast<long long>(bb) * s.H + hd) * (s.nc - 1) + c) * s.N * s.P4 + 4 * ty;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * tx + q;
      if (k < s.N)
        *reinterpret_cast<float4*>(z + k * s.P4) =
            make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
    }
  }
}

template <int HG, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ ws, Shape s,
                 Strides sx, Strides sa, Strides sb, Strides sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // the carry kernel may be scheduled now; its griddepcontrol.wait still
  // waits for this whole grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int item = blockIdx.x;                      // the plan keeps the grid below 2^31
  const int y_items = s.y_full + s.y_last;
  if (item >= y_items) {                      // state items, after every y item
    item -= y_items;
    const int kt = item % s.k_tiles;
    item /= s.k_tiles;
    const int c = item % (s.nc - 1);
    item /= s.nc - 1;
    state_item<VEC>(smem, x, dA, Bm, ws, s, sx, sa, sb, item / s.H, item % s.H, c, kt);
    return;
  }
  // y items: the full chunks' first, then those of a partial last chunk;
  // the tile varies slowest, from the last (the most causal columns) down,
  // so the longest items start first
  const bool last = item >= s.y_full;
  if (last) item -= s.y_full;
  const int T = last ? s.tiles_last : s.tiles_full;
  const int bb = item % s.B;
  item /= s.B;
  const int g = item % s.groups;
  item /= s.groups;
  int c = s.nc - 1;
  if (!last) {
    c = item % s.full_chunks;
    item /= s.full_chunks;
  }
  y_item<HG, VEC>(smem, x, dA, Bm, Cm, y, s, sx, sa, sb, sc, bb, g * HG, c, T - 1 - item,
                  last ? s.last_rows : s.Q);
}

// One block per (batch row, head, 64-row tile): walks chunks 1..nc-1,
// carrying the state, and adds exp(a_cs) o (C state^T) to its rows' y_diag.
// The product runs 16 rows at a time with its k range split over four
// groups of two warps (so a chunk of a few rows still keeps every warp
// busy); the four partial sums are added in group order.
__global__ void __launch_bounds__(kThreads)
ssd_carry_kernel(const float* __restrict__ dA, const float* __restrict__ Cm,
                 float* __restrict__ y, const float* __restrict__ ws, Shape s,
                 Strides sa, Strides sc) {
  extern __shared__ float4 smem4[];
  float* St = reinterpret_cast<float*>(smem4);  // [kN][kP + 4]: state^T entering the chunk
  float* Ct = St + kN * (kP + 4);               // [kN][kCarryRows + 4]: C^T of the tile's rows
  float* Red = Ct + kN * (kCarryRows + 4);      // [kKGroups][kRowTile][kP + 4]: partial sums
  float* acs = Red + kKGroups * kRowTile * (kP + 4);   // [kQ]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = blockIdx.x % s.carry_tiles;
  const int hd = (blockIdx.x / s.carry_tiles) % s.H;
  const int bb = blockIdx.x / (s.carry_tiles * s.H);
  // the product: k group kg, rows 4 ty .. +4 of a 16-row sub-tile, columns 4 tx ..
  const int kg = tid / (kThreads / kKGroups), ty = (tid / 16) % 4, tx = tid % 16;
  const int kper = (s.N + kKGroups - 1) / kKGroups;
  // the epilogue: row tid / 16 of the sub-tile, columns 4 tx ..
  const int er = tid / 16;
  const int r0 = rt * kCarryRows, Q = s.Q;
  // chunk c's cumsum into acs and its C rows into Ct (no input of these
  // comes from the first kernel)
  auto stage = [&](int c) {
    const int t0 = c * Q, nv = min(Q, s.L - t0);
    if (warp == 0)
      chunk_cumsum(dA + bb * sa.b + t0 * sa.l + hd * sa.h, sa.l, nv, acs, lane);
    if (r0 < nv) {                              // all loads first, then the stores
      const float* cb = Cm + bb * sc.b + (t0 + r0) * sc.l + hd * sc.h;
      constexpr int kRows = kCarryRows / (kThreads / 32), kCols = kN / 32;
      float v[kRows][kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = warp + a * (kThreads / 32);
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          const int k = lane + 32 * m;
          v[a][m] = r0 + i < nv && k < s.N ? cb[i * sc.l + k * sc.e] : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = warp + a * (kThreads / 32);
#pragma unroll
        for (int m = 0; m < kCols; ++m)
          Ct[(lane + 32 * m) * (kCarryRows + 4) + i] = v[a][m];
      }
    }
  };
  for (int e = tid; e < kN * (kP + 4); e += kThreads) St[e] = 0.f;
  if (warp == 0)                                // chunk 0 is full: it has a successor
    chunk_cumsum(dA + bb * sa.b + hd * sa.h, sa.l, Q, acs, lane);
  __syncthreads();
  float decay = expf(acs[Q - 1]);               // exp(a_cs[Q-1]) of the chunk before
  __syncthreads();                              // acs of chunk 0 is read
  stage(1);
  const float* z = ws + (static_cast<long long>(bb) * s.H + hd) * (s.nc - 1) * s.N * s.P4;
  // the contributions and y_diag come from the first kernel
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int c = 1; c < s.nc; ++c) {
    const int t0 = c * Q, nv = min(Q, s.L - t0);
    const float* zc = z + static_cast<long long>(c - 1) * s.N * s.P4;
    if (4 * tx < s.P) {                         // 16 threads per state row, 16 rows a pass
      constexpr int kPasses = kN / (kThreads / 16);
      const int k1 = tid / 16;
      float4 zv[kPasses];
#pragma unroll
      for (int m = 0; m < kPasses; ++m) {       // all loads first
        const int k = k1 + m * (kThreads / 16);
        if (k < s.N) zv[m] = *reinterpret_cast<const float4*>(zc + k * s.P4 + 4 * tx);
      }
#pragma unroll
      for (int m = 0; m < kPasses; ++m) {
        const int k = k1 + m * (kThreads / 16);
        if (k < s.N) {
          float4* sv = reinterpret_cast<float4*>(&St[k * (kP + 4) + 4 * tx]);
          float4 v = *sv;
          v.x = fmaf(decay, v.x, zv[m].x);
          v.y = fmaf(decay, v.y, zv[m].y);
          v.z = fmaf(decay, v.z, zv[m].z);
          v.w = fmaf(decay, v.w, zv[m].w);
          *sv = v;
        }
      }
    }
    __syncthreads();                            // St, acs and Ct of chunk c are in place
    const float next_decay = c + 1 < s.nc ? expf(acs[Q - 1]) : 0.f;
    for (int sub = 0; sub * kRowTile < min(kCarryRows, nv - r0); ++sub) {   // uniform
      const int i0 = sub * kRowTile;
      // y_diag of the epilogue's outputs, loaded before the product
      const int ie = r0 + i0 + er;
      float* ye = y + ((static_cast<long long>(bb) * s.L + t0 + ie) * s.H + hd) * s.P + 4 * tx;
      float yd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) yd[q] = ie < nv && 4 * tx + q < s.P ? ye[q] : 0.f;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const int ka = kg * kper, kb = min(s.N, ka + kper);
#pragma unroll 4
      for (int k = ka; k < kb; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&Ct[k * (kCarryRows + 4) + i0 + 4 * ty]);
        const float4 bv = *reinterpret_cast<const float4*>(&St[k * (kP + 4) + 4 * tx]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = comp(av, r);
          acc[r][0] = fmaf(a, bv.x, acc[r][0]);
          acc[r][1] = fmaf(a, bv.y, acc[r][1]);
          acc[r][2] = fmaf(a, bv.z, acc[r][2]);
          acc[r][3] = fmaf(a, bv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(&Red[(kg * kRowTile + 4 * ty + r) * (kP + 4) + 4 * tx]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      __syncthreads();                          // the partial sums are in place
      if (ie < nv && 4 * tx < s.P) {
        float4 t = *reinterpret_cast<const float4*>(&Red[er * (kP + 4) + 4 * tx]);
#pragma unroll
        for (int g = 1; g < kKGroups; ++g) {    // the k groups in order
          const float4 u = *reinterpret_cast<const float4*>(&Red[(g * kRowTile + er) * (kP + 4) + 4 * tx]);
          t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
        }
        const float ea = expf(acs[ie]);
        const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * tx + q < s.P) ye[q] = fmaf(tv[q], ea, yd[q]);
      }
      __syncthreads();                          // Red is read before the next sub-tile
    }
    __syncthreads();                            // St, acs and Ct of chunk c are read
    decay = next_decay;
    if (c + 1 < s.nc) stage(c + 1);
  }
}

// a kernel's dynamic shared memory, with the carveout at its maximum so
// two chunk blocks (or three carry blocks) fit on an SM
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HG, bool VEC>
int launch_chunk(const Shape& s, long long blocks, const void* x, const void* dA,
                 const void* Bm, const void* Cm, void* y, void* ws,
                 const Strides& sx, const Strides& sa, const Strides& sb,
                 const Strides& sc, cudaStream_t stream) {
  const size_t bytes = chunk_smem_bytes<HG>();
  cudaError_t err = set_smem(ssd_chunk_kernel<HG, VEC>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<HG, VEC><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<float*>(ws), s, sx, sa, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_chunk_hg(const Shape& s, long long blocks, const void* x, const void* dA,
                    const void* Bm, const void* Cm, void* y, void* ws,
                    const Strides& sx, const Strides& sa, const Strides& sb,
                    const Strides& sc, cudaStream_t st) {
  return s.hg == 4 ? launch_chunk<4, VEC>(s, blocks, x, dA, Bm, Cm, y, ws, sx, sa, sb, sc, st)
       : s.hg == 2 ? launch_chunk<2, VEC>(s, blocks, x, dA, Bm, Cm, y, ws, sx, sa, sb, sc, st)
                   : launch_chunk<1, VEC>(s, blocks, x, dA, Bm, Cm, y, ws, sx, sa, sb, sc, st);
}

// 16-byte copies need a contiguous last axis and every row start 16-byte aligned
bool aligned16(const void* ptr, const Strides& st, int width) {
  return st.e == 1 && width % 4 == 0 && st.b % 4 == 0 && st.l % 4 == 0 &&
         st.h % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// x/y: [b, l, h, p]; dA: [b, l, h]; B/C: [b, l, h, n]; fp32; x, dA, B and C
// read through the given element strides (batch, row, head, last axis; dA
// has no last axis), y written contiguous. ws: fp32 [b, h, nc - 1, n, p4]
// with p4 = p rounded up to 4 (unused when l <= chunk). heads_per_block in
// {1, 2, 4} divides h; above 1 the head strides of B and C must be 0.
// 1 <= p <= 64, 1 <= n <= 128, 1 <= chunk <= 128. Returns a cudaError_t
// (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const void* dA, const void* Bm,
                            const void* Cm, void* y, void* ws, int b, int l,
                            int h, int p, int n, int chunk, int heads_per_block,
                            long long x_sb, long long x_sl, long long x_sh,
                            long long x_sp, long long a_sb, long long a_sl,
                            long long a_sh, long long b_sb, long long b_sl,
                            long long b_sh, long long b_sn, long long c_sb,
                            long long c_sl, long long c_sh, long long c_sn,
                            void* stream) {
  const int hg = heads_per_block;
  if (b < 1 || l < 1 || h < 1 || p < 1 || p > kP || n < 1 || n > kN ||
      chunk < 1 || chunk > kQ || !(hg == 1 || hg == 2 || hg == 4) || h % hg != 0 ||
      (hg > 1 && (b_sh != 0 || c_sh != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{};
  s.B = b; s.L = l; s.H = h; s.P = p; s.N = n; s.Q = chunk;
  s.P4 = (p + 3) / 4 * 4;
  s.nc = (l + chunk - 1) / chunk;
  s.last_rows = l - (s.nc - 1) * chunk;
  s.hg = hg;
  s.groups = h / hg;
  s.full_chunks = s.last_rows == chunk ? s.nc : s.nc - 1;
  s.tiles_full = (chunk + kRowTile - 1) / kRowTile;
  s.tiles_last = (s.last_rows + kRowTile - 1) / kRowTile;
  s.k_tiles = (n + kKTile - 1) / kKTile;
  const int carry_rows = s.nc >= 3 ? chunk : s.last_rows;
  s.carry_tiles = (carry_rows + kCarryRows - 1) / kCarryRows;
  const long long y_full = static_cast<long long>(b) * s.groups * s.full_chunks * s.tiles_full;
  const long long n_state = static_cast<long long>(b) * h * (s.nc - 1) * s.k_tiles;
  const long long y_last =
      s.last_rows == chunk ? 0 : static_cast<long long>(b) * s.groups * s.tiles_last;
  const long long blocks = y_full + n_state + y_last;
  const long long carry_blocks = static_cast<long long>(b) * h * s.carry_tiles;
  if (blocks > 0x7fffffffLL || carry_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  s.y_full = static_cast<int>(y_full);
  s.n_state = static_cast<int>(n_state);
  s.y_last = static_cast<int>(y_last);
  if (s.nc > 1 && (ws == nullptr || reinterpret_cast<uintptr_t>(ws) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{x_sb, x_sl, x_sh, x_sp}, sa{a_sb, a_sl, a_sh, 0},
      sb{b_sb, b_sl, b_sh, b_sn}, sc{c_sb, c_sl, c_sh, c_sn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x, sx, p) && aligned16(Bm, sb, n) && aligned16(Cm, sc, n) &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int err = vec ? launch_chunk_hg<true>(s, blocks, x, dA, Bm, Cm, y, ws, sx, sa, sb, sc, st)
                : launch_chunk_hg<false>(s, blocks, x, dA, Bm, Cm, y, ws, sx, sa, sb, sc, st);
  if (err != 0 || s.nc == 1) return err;
  const size_t bytes = sizeof(float) * kCarryFloats;
  const cudaError_t cerr = set_smem(ssd_carry_kernel, bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  // the carry kernel as a programmatic dependent launch: its launch overlaps
  // the chunk kernel, and it waits on the card (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(carry_blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, ssd_carry_kernel, static_cast<const float*>(dA),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<const float*>(ws), s, sa, sc));
}

