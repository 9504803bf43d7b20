// ALS bucket solves for Hopper (sm_90a): per bucket row, the weighted Gram
// and right-hand side of its normal equations, then Jacobi-preconditioned CG.
//
// Replaces the TPU kernels of incubator_predictionio_tpu/ops/pallas_kernels.py:
//   * two-stage, one row per program: als_solve_cg_pallas (:869) -> pallas_call
//     (:1003) -> _als_cg_kernel (:653); entry pio_als_solve_cg, rows = 1;
//   * two-stage, R = 8 rows per program: the same entry -> pallas_call (:959)
//     -> _als_cg_kernel_rows (:756); entry pio_als_solve_cg, rows = 8;
//   * fused gather: als_fused_solve_cg_pallas (:1196) -> pallas_call (:1300)
//     -> _als_fused_kernel (:1052); entry pio_als_fused_solve_cg.
// Same contract:
//   * Gram[k][l] = sum_d gw_d t_dk t_dl and rhs[k] = sum_d rw_d t_dk, summed
//     in f32. With a bf16 table both weights round to bf16 first and so does
//     the weighted row gw_d t_d (pallas_kernels.py:700, :782, :1082, :1091);
//     bf16 x bf16 products are exact in f32. An f32 table is plain f32 FMAs,
//     no TF32 (the TPU kernel pins Precision.HIGHEST).
//   * the ridge lam (and the implicit YtY) stay out of the Gram: the matvec
//     is ap[k] = sum_l p[l] Gram[l][k] + lam p[k] (+ sum_l p[l] YtY[l][k]),
//     in f32; the Jacobi diagonal is Gram[k][k] + lam (+ YtY[k][k]).
//   * iters CG steps, cold from 0 or warm from x0 (one extra matvec), with
//     the guards alpha = pap > 0 ? rz / pap : 0, beta = rz > 0 ? rz2 / rz : 0
//     and minv = diag > 0 ? 1 / diag : 0, so empty and converged systems are
//     fixed points. The fused entry returns exactly 0 where nnz = 0
//     (pallas_kernels.py:1318); the two-stage entry has no such guard.
//   * rank padding (K up to KP, a multiple of 16) solves to exactly 0.
//
// What bounds it on this card: the Gram, 2 * nnz * K^2 operations per
// half-sweep against nnz * K elements gathered, so it is operations-bound
// (at K = 128 in f32: 64 FMAs per 4-byte element read). The fused entry and
// the R = 8 form run the products on the f32 FMA units (67 TFLOP/s on an
// H100 SXM at 700 W, data sheet) also when the table is bf16; the one-row
// two-stage form runs them on the tensor cores (989 TFLOP/s bf16; f32 as
// 3xTF32 at 495/3).
//
// Two-stage, one row (rows = 1): split-D partial Grams on the tensor cores.
// A wide bucket has few rows (8 at D = 32,768) and each row's d range is
// long, so one block per row would leave most SMs idle. The launch plan
// (ops/als_kernels.two_stage_plan, computed in Python, checked here) cuts
// each row's d range into S equal slices, so that B * S reaches two blocks
// per SM where D allows; a block stages its slice in 64- or 128-row slabs.
//   * Stage 1 (gram_slice_kernel), one block per (row, slice): slabs of the
//     gathered [D, K] block come into shared memory by cp.async (16-byte
//     copies, double-buffered; rows padded by 8 elements, so fragment reads
//     are conflict-free). Gram = X^T X runs on mma.sync: bf16 m16n8k16, both
//     operands from one ldmatrix.trans of the [d][k] slab, exact products
//     into f32 accumulators; f32 as 3xTF32 m16n8k8 (the integer
//     round-and-mask split of the flash kernel, lo*lo dropped). 8 warps
//     tile the Gram (4 x 2 tiles of 32 x 64 at K = 128; below, warps also
//     split the d steps and are added in warp order). The rhs is f32 FMAs.
//     With one slice the block puts the Gram into shared memory and runs the
//     CG itself; else it writes its partial record (Gram and rhs) to a
//     workspace the wrapper allocates.
//   * Stage 2 (S > 1): gram_reduce_kernel sums each row's S records in
//     slice order (a fixed order: the result does not depend on scheduling)
//     over many blocks; gram_solve_kernel, one block per row, loads the sum
//     into the shared-memory Gram and runs the same CG as the other forms.
// The fused entry and the R = 8 form keep the design below.
//
// Design (fused, and R = 8). The TPU grid's sequential d axis (Gram carried in VMEM scratch
// across d steps) becomes a loop over 32-row d tiles inside one block of 256
// threads. Each tile's rows (gathered from the table by cols in the fused
// entry, read from the [B, D, K] block gathered outside in the two-stage
// one; each thread issues all its loads of a tile before it stores any)
// are staged in shared memory as f32; each thread sums a TM x TM piece of
// the Gram in registers (TM = KP / 16, 64 accumulators at K = 128) over 8
// tiles, then adds it to the Gram in shared memory (KP x (KP + KP/8) f32,
// 72 KB at K = 128, beside the tiles: 106 KB in all, dynamic shared memory
// above 48 KB, two blocks per SM), so the Gram is never in device memory.
// Then the whole CG runs in the block: the matvec splits each output
// coordinate over 256 / KP threads (padded row stride, no bank conflicts),
// the two dot products per step are block reductions.
//
// R = 8 rows per block (two-stage only): eight 64 KB Grams do not fit in
// 227 KB of shared memory at K = 128, so the block builds the eight Grams
// in turn, as above, copying each into a scratch buffer that the wrapper
// allocates in device memory ([ceil(B / 8) * 8, KP, KP] f32), then runs the
// CG batched over the group, one warp per row, reading its Gram from that
// buffer (it stays in L2 across the CG steps). Every reduction is per row
// (warp shuffles), so rows never mix. One layout serves every K.
//
// Plain C interface, bound from Python with ctypes; launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileD = 32;       // d rows staged per tile
constexpr int kFlushTiles = 8;   // tiles summed in registers per flush
constexpr int kGroupRows = 8;    // rows per block of the R = 8 form
constexpr int kMaxRank = 128;
// rows of d in one staged slab of the split-D Gram (Mma<KP>::TD): padded
// rank 64 and 128 take the wide slabs' fewer rows, 16 and 32 the narrow
constexpr int kSlabRowsWide = 64;
constexpr int kSlabRowsNarrow = 128;
// the rank the kernels compute at: K rounded up to 16, 32, 64 or 128
constexpr int padded_rank(int K) {
  return K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 128;
}
constexpr int slab_rows(int kp) {
  return kp >= 64 ? kSlabRowsWide : kSlabRowsNarrow;
}
// two blocks per SM, so at most 128 registers a thread
constexpr int kMinBlocks = 2;

template <int KP>
struct Geo {
  static constexpr int TM = KP / 16;         // Gram rows/cols per thread
  static constexpr int TPR = kThreads / KP;  // threads per matvec output
  static constexpr int GS = KP + KP / 8;     // shared Gram row stride
  static constexpr int NQ = (KP + 31) / 32;  // coordinates per lane (R = 8)
};

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// rounding to the table's type (identity for f32)
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the Gram coordinate of a thread's i-th fragment element: two float4 runs
// (64 apart) at TM = 8, one at TM = 4, contiguous below
template <int TM>
__device__ __forceinline__ int own(int t, int i) {
  if constexpr (TM >= 4) {
    return (i / 4) * 64 + t * 4 + (i % 4);
  } else {
    return t * TM + i;
  }
}

template <int TM>
__device__ __forceinline__ void fragment(const float* row, int t,
                                         float (&f)[TM]) {
  if constexpr (TM >= 4) {
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(row + g * 64 + t * 4);
      f[4 * g] = v.x;
      f[4 * g + 1] = v.y;
      f[4 * g + 2] = v.z;
      f[4 * g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) f[i] = row[t * TM + i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// Shared-memory scratch of the Gram phase.
struct Tile {
  float* t;    // [kTileD, KP] rows as f32
  float* w;    // [kTileD, KP] gw-weighted rows (fused only)
  float* rw;   // [kTileD] rhs weights
  float* gw;   // [kTileD] Gram weights
  int* src;    // [kTileD] source row, -1 = contributes nothing
};

// Add a thread's register sums to its own Gram coordinates in G and to
// its rhs, and zero them.
template <int KP>
__device__ __forceinline__ void flush(float (&acc)[Geo<KP>::TM][Geo<KP>::TM],
                                      float& part, float* G, float& rhs,
                                      int tx, int ty) {
  constexpr int TM = Geo<KP>::TM, GS = Geo<KP>::GS;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      G[own<TM>(ty, i) * GS + own<TM>(tx, j)] += acc[i][j];
      acc[i][j] = 0.f;
    }
  rhs += part;
  part = 0.f;
}

// One bucket row's Gram into G (shared, [KP][GS]) and its rhs into rhs
// (threads tid < KP); the block syncs before it returns. FUSED: rows come
// from table[cols[d]] weighted by gw; otherwise from the row's [D, K]
// block, unweighted (already masked). Sums run in two levels, as the TPU
// kernel adds each d tile's product to its scratch: each thread sums
// kFlushTiles tiles in registers (acc, part), then adds them to its own
// coordinates of G and to rhs. A row of 40,000 observations is then ~160
// sums of 256 terms, not one sum of 40,000 in turn, whose rounding the
// unconverged CG would amplify.
template <int KP, typename T, bool FUSED>
__device__ void gram_rhs(const T* __restrict__ src, int M,
                         const int* __restrict__ cols,
                         const float* __restrict__ gw,
                         const float* __restrict__ rw, size_t row, int D,
                         int K, Tile tile, float* G, float& rhs) {
  constexpr int TM = Geo<KP>::TM, GS = Geo<KP>::GS;
  constexpr int kPer = kTileD * KP / kThreads;  // tile elements per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TM];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      acc[i][j] = 0.f;
      G[own<TM>(ty, i) * GS + own<TM>(tx, j)] = 0.f;  // this thread's own
    }
  rhs = 0.f;
  const T* base = FUSED ? src : src + row * D * K;
  for (int d0 = 0, n = 1; d0 < D; d0 += kTileD, ++n) {
    const int nd = min(kTileD, D - d0);
    if (tid < kTileD) {
      int s = -1;
      float wr = 0.f, wg = 0.f;
      if (tid < nd) {
        const size_t e = row * D + d0 + tid;
        wr = round_as<T>(rw[e]);
        if constexpr (FUSED) {
          wg = round_as<T>(gw[e]);
          s = cols[e];
          // an entry with both weights 0 (padding) adds exactly nothing
          if ((wg == 0.f && wr == 0.f) || s < 0 || s >= M) s = -1;
        } else {
          s = d0 + tid;
          wg = 1.f;
        }
      }
      tile.src[tid] = s;
      tile.rw[tid] = wr;
      tile.gw[tid] = wg;
    }
    __syncthreads();
    // every load of the tile is issued before any is used, so a thread
    // has kPer loads in flight instead of waiting out each one in turn;
    // rows past nd have src -1 and stage zeros
    float v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * kThreads;
      const int s = tile.src[e / KP], k = e % KP;
      v[q] = (s >= 0 && k < K) ? load_f(base, (size_t)s * K + k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * kThreads;
      tile.t[e] = v[q];
      if constexpr (FUSED) tile.w[e] = round_as<T>(tile.gw[e / KP] * v[q]);
    }
    __syncthreads();
    const float* left = FUSED ? tile.w : tile.t;
    for (int d = 0; d < nd; ++d) {
      float a[TM], b[TM];
      fragment<TM>(left + d * KP, ty, a);
      fragment<TM>(tile.t + d * KP, tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (tid < KP)
      for (int d = 0; d < nd; ++d)
        part = fmaf(tile.rw[d], tile.t[d * KP + tid], part);
    if (n % kFlushTiles == 0) flush<KP>(acc, part, G, rhs, tx, ty);
    __syncthreads();
  }
  flush<KP>(acc, part, G, rhs, tx, ty);
  __syncthreads();
}

// ap = Gram p + lam p (+ YtY p) for one row, the whole block; sp holds p.
template <int KP>
__device__ void matvec_block(const float* G, const float* sp, float* sap,
                             float lam, const float* __restrict__ yty,
                             int K) {
  constexpr int TPR = Geo<KP>::TPR, GS = Geo<KP>::GS;
  const int k = threadIdx.x / TPR, h = threadIdx.x % TPR;
  float s = 0.f, sy = 0.f;
#pragma unroll 8
  for (int j = 0; j < KP / TPR; ++j) {
    const int l = j * TPR + h;
    s = fmaf(G[l * GS + k], sp[l], s);
  }
  if (yty != nullptr && k < K)
    for (int j = 0; j < KP / TPR; ++j) {
      const int l = j * TPR + h;
      if (l < K) sy = fmaf(yty[(size_t)l * K + k], sp[l], sy);
    }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
  }
  if (h == 0) sap[k] = (s + lam * sp[k]) + sy;
  __syncthreads();
}

// Jacobi-PCG on (G + lam I [+ YtY]) x = b for one bucket row, the whole
// block: G is the row's Gram in shared memory ([KP][GS]), b this thread's
// rhs coordinate (threads tid < KP); x goes to out[row], or exactly 0 where
// `empty`. sp, sap and red are shared scratch of KP, KP and 32 floats.
template <int KP>
__device__ void cg_block(const float* G, float b, float lam_r,
                         const float* __restrict__ yty,
                         const float* __restrict__ x0, size_t row, int K,
                         int iters, float* sp, float* sap, float* red,
                         bool empty, float* __restrict__ out) {
  constexpr int GS = Geo<KP>::GS;
  const int tid = threadIdx.x;
  const bool mine = tid < KP;
  float minv = 0.f, x = 0.f, r = 0.f;
  if (mine) {
    float dg = G[tid * GS + tid] + lam_r;
    if (yty != nullptr && tid < K) dg += yty[(size_t)tid * K + tid];
    minv = dg > 0.f ? 1.f / dg : 0.f;
    r = b;
  }
  if (x0 != nullptr) {
    if (mine) {
      x = tid < K ? x0[row * K + tid] : 0.f;
      sp[tid] = x;
    }
    __syncthreads();
    matvec_block<KP>(G, sp, sap, lam_r, yty, K);
    if (mine) r = b - sap[tid];
  }
  float z = minv * r;
  float rz = block_sum(mine ? r * z : 0.f, red);
  float p = z;
  if (mine) sp[tid] = p;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    matvec_block<KP>(G, sp, sap, lam_r, yty, K);
    const float ap = mine ? sap[tid] : 0.f;
    const float pap = block_sum(p * ap, red);
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    x = x + alpha * p;
    r = r - alpha * ap;
    z = minv * r;
    const float rz2 = block_sum(r * z, red);
    const float beta = rz > 0.f ? rz2 / rz : 0.f;
    p = z + beta * p;
    rz = rz2;
    if (mine) sp[tid] = p;
    __syncthreads();
  }
  if (tid < K) out[row * K + tid] = empty ? 0.f : x;
}

// Fused entry, one bucket row per block: the gathered Gram + rhs, then
// Jacobi-PCG in the block.
template <int KP, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    row_solve_kernel(const T* __restrict__ src, int M,
                     const int* __restrict__ cols,
                     const float* __restrict__ gw,
                     const float* __restrict__ rw,
                     const float* __restrict__ lam,
                     const float* __restrict__ nnz,
                     const float* __restrict__ yty,
                     const float* __restrict__ x0, float* __restrict__ out,
                     int D, int K, int iters) {
  constexpr int GS = Geo<KP>::GS;
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);         // [KP][GS] Gram
  float* tiles = G + KP * GS;                         // [2][kTileD][KP]
  float* sp = tiles + kTileD * KP * 2;
  float* sap = sp + KP;
  float* red = sap + KP;
  Tile tile{tiles, tiles + kTileD * KP, red + 32, red + 32 + kTileD,
            reinterpret_cast<int*>(red + 32 + 2 * kTileD)};

  const size_t row = blockIdx.x;
  float b;
  gram_rhs<KP, T, true>(src, M, cols, gw, rw, row, D, K, tile, G, b);
  cg_block<KP>(G, b, lam[row], yty, x0, row, K, iters, sp, sap, red,
               nnz[row] <= 0.f, out);
}

// R = 8 rows per block (two-stage): the eight Grams in turn into the
// device scratch, then one warp per row runs that row's CG.
template <int KP, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    group_solve_kernel(const T* __restrict__ g, const float* __restrict__ wv,
                       const float* __restrict__ lam,
                       const float* __restrict__ x0,
                       float* __restrict__ out, float* __restrict__ scratch,
                       int B, int D, int K, int iters) {
  constexpr int TM = Geo<KP>::TM, GS = Geo<KP>::GS, NQ = Geo<KP>::NQ;
  static_assert(kWarps == kGroupRows, "one warp per row of the group");
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);  // [KP][GS] one row's Gram
  float* tiles = G + KP * GS;                  // [kTileD][KP]
  float* srhs = tiles + kTileD * KP;           // [R, KP]
  float* sp = srhs + kGroupRows * KP;          // [R, KP]
  float* red = sp + kGroupRows * KP;
  Tile tile{tiles, nullptr, red + 32, red + 32 + kTileD,
            reinterpret_cast<int*>(red + 32 + 2 * kTileD)};

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t b0 = (size_t)blockIdx.x * kGroupRows;
  for (int rr = 0; rr < kGroupRows && b0 + rr < (size_t)B; ++rr) {
    float b;
    gram_rhs<KP, T, false>(g, 0, nullptr, nullptr, wv, b0 + rr, D, K, tile,
                           G, b);
    // each thread copies the coordinates it summed (no other thread
    // touches them before the next row's gram_rhs zeroes them)
    float* Gg = scratch + (b0 + rr) * KP * KP;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int gi = own<TM>(ty, i), gj = own<TM>(tx, j);
        Gg[gi * KP + gj] = G[gi * GS + gj];
      }
    if (tid < KP) srhs[rr * KP + tid] = b;
  }
  __syncthreads();

  const int w = tid >> 5, lane = tid & 31;
  const size_t row = b0 + w;
  if (row >= (size_t)B) return;
  const float* Gg = scratch + row * KP * KP;
  float* spw = sp + w * KP;
  const float lam_r = lam[row];
  float x[NQ], r[NQ], p[NQ], z[NQ], ap[NQ], minv[NQ], b[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int k = lane + 32 * q;
    const bool ok = k < KP;
    b[q] = ok ? srhs[w * KP + k] : 0.f;
    const float dg = ok ? Gg[k * KP + k] + lam_r : 0.f;
    minv[q] = dg > 0.f ? 1.f / dg : 0.f;
    x[q] = (x0 != nullptr && k < K) ? x0[row * K + k] : 0.f;
    if (ok) spw[k] = x[q];
  }
  __syncwarp();
  auto matvec = [&]() {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int k = lane + 32 * q;
      float s = 0.f;
      if (k < KP) {
        for (int l = 0; l < KP; ++l) s = fmaf(Gg[l * KP + k], spw[l], s);
        s = s + lam_r * spw[k];
      }
      ap[q] = s;
    }
    __syncwarp();  // every lane has read p before it is rewritten
  };
  if (x0 != nullptr) {
    matvec();
#pragma unroll
    for (int q = 0; q < NQ; ++q) r[q] = b[q] - ap[q];
  } else {
#pragma unroll
    for (int q = 0; q < NQ; ++q) r[q] = b[q];
  }
  float part = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    z[q] = minv[q] * r[q];
    p[q] = z[q];
    part += r[q] * z[q];
    const int k = lane + 32 * q;
    if (k < KP) spw[k] = p[q];
  }
  float rz = warp_sum(part);
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    matvec();
    part = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) part += p[q] * ap[q];
    const float pap = warp_sum(part);
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    part = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      x[q] = x[q] + alpha * p[q];
      r[q] = r[q] - alpha * ap[q];
      z[q] = minv[q] * r[q];
      part += r[q] * z[q];
    }
    const float rz2 = warp_sum(part);
    const float beta = rz > 0.f ? rz2 / rz : 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      p[q] = z[q] + beta * p[q];
      const int k = lane + 32 * q;
      if (k < KP) spw[k] = p[q];
    }
    rz = rz2;
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int k = lane + 32 * q;
    if (k < K) out[row * K + k] = x[q];
  }
}

// -- two-stage, one row: split-D partial Grams on the tensor cores ---------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; the bytes past src_bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits by integer ops,
// lo = x - hi exactly (the tensor core reads lo's top 10 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a * b, m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp layout of the Gram on the tensor cores: WM x WN warp tiles of
// WTM x WTN (16-row m blocks, 8-column n blocks), and WD warps splitting
// the d steps of a stage (their Grams are added in warp order at the end).
// Stages are TD rows of d; shared rows are padded by 8 elements, which puts
// the 8 rows of an ldmatrix (bf16) and the 4 x 8 scalar fragment reads
// (f32) on distinct banks.
template <int KP>
struct Mma {
  static constexpr int WTM = KP >= 32 ? 32 : 16;
  static constexpr int WTN = KP == 128 ? 64 : KP >= 32 ? 32 : 16;
  static constexpr int WM = KP / WTM, WN = KP / WTN;
  static constexpr int WD = kWarps / (WM * WN);
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int TD = slab_rows(KP);
  static constexpr int RS = KP + 8;
  static constexpr int NG = kThreads / KP;  // rhs: thread groups over d
  static_assert(WM * WN * WD == kWarps, "warp layout");
};

template <typename T>
__device__ __forceinline__ T zero_as();
template <>
__device__ __forceinline__ float zero_as<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_as<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Stage rows [d0, d0 + TD) of one bucket row's [D, K] block (rows past d_end
// and columns past K zero) and their rhs weights. vec: 16-byte cp.async
// (K * sizeof(T) a multiple of 16 and the block aligned); else f32 takes
// 4-byte cp.async and bf16 plain loads.
template <int KP, typename T>
__device__ __forceinline__ void load_slab(T* dst, float* wdst, const T* src,
                                          const float* wsrc, int d0,
                                          int d_end, int K, bool vec) {
  constexpr int TD = Mma<KP>::TD, RS = Mma<KP>::RS;
  constexpr int kPer = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kParts = KP / kPer;
#pragma unroll
    for (int i = 0; i < (TD * kParts + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (e < TD * kParts) {
        const int r = e / kParts, col = (e % kParts) * kPer;
        const bool in = d0 + r < d_end && col < K;
        cp_async16(dst + r * RS + col,
                   in ? src + (size_t)(d0 + r) * K + col : src, in ? 16 : 0);
      }
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int e = tid; e < TD * KP; e += kThreads) {
      const int r = e / KP, col = e % KP;
      const bool in = d0 + r < d_end && col < K;
      cp_async4(dst + r * RS + col, in ? src + (size_t)(d0 + r) * K + col : src,
                in ? 4 : 0);
    }
  } else {
    for (int e = tid; e < TD * KP; e += kThreads) {
      const int r = e / KP, col = e % KP;
      const bool in = d0 + r < d_end && col < K;
      dst[r * RS + col] = in ? src[(size_t)(d0 + r) * K + col]
                             : zero_as<T>();
    }
  }
  if (tid < TD) {
    const bool in = d0 + tid < d_end;
    cp_async4(wdst + tid, in ? wsrc + d0 + tid : wsrc, in ? 4 : 0);
  }
}

// acc += X^T X over the TD rows of a staged slab, this warp's d steps.
template <int KP>
__device__ __forceinline__ void slab_gram(
    const __nv_bfloat16* X,
    float (&acc)[Mma<KP>::MT][Mma<KP>::NT][4], int wm, int wn, int wd,
    int lane) {
  using M = Mma<KP>;
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = wd; ks < M::TD / 16; ks += M::WD) {
    const __nv_bfloat16* x0 = X + (ks * 16) * M::RS;
    uint32_t a[M::MT][4];
#pragma unroll
    for (int mi = 0; mi < M::MT; ++mi)
      ldsm_x4_trans(a[mi], x0 + ((j >> 1) * 8 + r) * M::RS +
                               wm * M::WTM + mi * 16 + (j & 1) * 8);
#pragma unroll
    for (int np = 0; np < M::NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, x0 + ((j & 1) * 8 + r) * M::RS + wn * M::WTN +
                           np * 16 + (j >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < M::MT; ++mi) {
        mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

template <int KP>
__device__ __forceinline__ void slab_gram(
    const float* X, float (&acc)[Mma<KP>::MT][Mma<KP>::NT][4], int wm,
    int wn, int wd, int lane) {
  using M = Mma<KP>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int ks = wd; ks < M::TD / 8; ks += M::WD) {
    const float* x0 = X + (ks * 8 + t) * M::RS;
    const float* x1 = x0 + 4 * M::RS;
    uint32_t ah[M::MT][4], al[M::MT][4];
#pragma unroll
    for (int mi = 0; mi < M::MT; ++mi) {
      const int m = wm * M::WTM + mi * 16 + g;
      split_tf32(x0[m], ah[mi][0], al[mi][0]);
      split_tf32(x0[m + 8], ah[mi][1], al[mi][1]);
      split_tf32(x1[m], ah[mi][2], al[mi][2]);
      split_tf32(x1[m + 8], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < M::NT; ++ni) {
      const int n = wn * M::WTN + ni * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(x0[n], bh0, bl0);
      split_tf32(x1[n], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < M::MT; ++mi) {  // lo*hi + hi*lo + hi*hi
        mma_tf32(acc[mi][ni], al[mi], bh0, bh1);
        mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
        mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
      }
    }
  }
}

// Shared memory of gram_slice_kernel: the two slabs and their weights, in
// the same bytes as the Gram that follows them; then the rhs pieces and the
// CG's vectors.
template <int KP, typename T>
__host__ __device__ constexpr size_t slab_union_bytes() {
  using M = Mma<KP>;
  constexpr size_t slabs = 2 * (M::TD * M::RS * sizeof(T) + M::TD * 4);
  constexpr size_t gram = KP * Geo<KP>::GS * 4;
  return slabs > gram ? slabs : gram;
}

template <int KP, typename T>
constexpr size_t slice_smem_bytes() {
  return slab_union_bytes<KP, T>() + 4 * (Mma<KP>::NG * KP + 2 * KP + 32);
}

// Stage 1 of the two-stage solve: block (row, slice) sums the Gram and rhs
// of rows [s * slice_rows, min(D, (s + 1) * slice_rows)) of one bucket row's
// gathered [D, K] block. The slabs come in by cp.async, double-buffered; the
// Gram runs on the tensor cores (bf16 m16n8k16, exact products; f32 as
// 3xTF32 m16n8k8) into f32 accumulators, the rhs on the FMA units. The warp
// pieces are added into a shared Gram in warp order. SOLVE (one slice):
// the block then runs the CG on it; else it writes the partial record
// (Gram [KP][KP], rhs [KP]) to part[row][slice].
template <int KP, typename T, bool SOLVE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gram_slice_kernel(const T* __restrict__ g, const float* __restrict__ wv,
                      const float* __restrict__ lam,
                      const float* __restrict__ x0, float* __restrict__ out,
                      float* __restrict__ part, int D, int K, int iters,
                      int S, int slice_rows, int vec) {
  using M = Mma<KP>;
  constexpr int GS = Geo<KP>::GS, TD = M::TD, RS = M::RS;
  extern __shared__ float4 smem4[];
  T* slab = reinterpret_cast<T*>(smem4);                       // [2][TD][RS]
  float* wsl = reinterpret_cast<float*>(slab + 2 * TD * RS);   // [2][TD]
  float* G = reinterpret_cast<float*>(smem4);  // [KP][GS], after the slabs
  float* rs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                       slab_union_bytes<KP, T>());  // [NG][KP]
  float* sp = rs + M::NG * KP;
  float* sap = sp + KP;
  float* red = sap + KP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wd = warp % M::WD, wn = (warp / M::WD) % M::WN,
            wm = warp / (M::WD * M::WN);
  const size_t row = blockIdx.x / S;
  const int sl = blockIdx.x % S;
  const int d_begin = sl * slice_rows;
  const int d_end = min(D, d_begin + slice_rows);
  const int n_slabs = (d_end - d_begin + TD - 1) / TD;
  const T* src = g + row * D * K;
  const float* wsrc = wv + row * D;

  float acc[M::MT][M::NT][4];
#pragma unroll
  for (int mi = 0; mi < M::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < M::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float rpart = 0.f;
  const int rk = tid % KP, rg = tid / KP;

  load_slab<KP, T>(slab, wsl, src, wsrc, d_begin, d_end, K, vec);
  cp_async_commit();
  for (int n = 0; n < n_slabs; ++n) {
    const int buf = n & 1;
    if (n + 1 < n_slabs)
      load_slab<KP, T>(slab + (buf ^ 1) * TD * RS, wsl + (buf ^ 1) * TD, src,
                       wsrc, d_begin + (n + 1) * TD, d_end, K, vec);
    cp_async_commit();  // an empty group past the last slab
    cp_async_wait_1();
    __syncthreads();
    const T* X = slab + buf * TD * RS;
    slab_gram<KP>(X, acc, wm, wn, wd, lane);
    const float* w = wsl + buf * TD;
    for (int d = rg; d < TD; d += M::NG)
      rpart = fmaf(round_as<T>(w[d]), widen<T>(X[d * RS + rk]), rpart);
    __syncthreads();  // this slab's buffer is free for slab n + 2
  }

  // the warp pieces into G, in warp order of wd; the rhs pieces into rs
  rs[rg * KP + rk] = rpart;
  for (int w = 0; w < M::WD; ++w) {
    if (wd == w) {
      const int g8 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
      for (int mi = 0; mi < M::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < M::NT; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = wm * M::WTM + mi * 16 + g8 + 8 * h;
            const int col = wn * M::WTN + ni * 8 + t2;
            float2* p = reinterpret_cast<float2*>(G + m * GS + col);
            float2 v = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            if (w > 0) {
              const float2 o = *p;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *p = v;
          }
    }
    __syncthreads();
  }
  float b = 0.f;
  if (tid < KP)
    for (int q = 0; q < M::NG; ++q) b += rs[q * KP + tid];
  if constexpr (SOLVE) {
    cg_block<KP>(G, b, lam[row], nullptr, x0, row, K, iters, sp, sap, red,
                 false, out);
  } else {
    float* rec = part + (row * S + sl) * (size_t)(KP * KP + KP);
    for (int e = tid; e < KP * KP / 2; e += kThreads) {  // GS is even
      const int m = e / (KP / 2), c = (e % (KP / 2)) * 2;
      reinterpret_cast<float2*>(rec)[e] =
          *reinterpret_cast<const float2*>(G + m * GS + c);
    }
    if (tid < KP) rec[KP * KP + tid] = b;
  }
}

// Stage 2a (S > 1): sum[row] = sum over slices s = 0, 1, ... of
// part[row][s], in that order (a deterministic result), float4 at a time.
__global__ void __launch_bounds__(kThreads)
    gram_reduce_kernel(const float4* __restrict__ part, int S, int rec4,
                       int chunks, float4* __restrict__ sum) {
  const size_t row = blockIdx.x / chunks;
  const int e = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  if (e >= rec4) return;
  const float4* p = part + row * S * (size_t)rec4 + e;
  float4 a = p[0];
#pragma unroll 4
  for (int s = 1; s < S; ++s) {
    const float4 v = p[(size_t)s * rec4];
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  sum[row * rec4 + e] = a;
}

// Stage 2b (S > 1): one block per row loads its summed record into the
// shared Gram and runs the CG.
template <int KP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gram_solve_kernel(const float* __restrict__ sum,
                      const float* __restrict__ lam,
                      const float* __restrict__ x0, float* __restrict__ out,
                      int K, int iters) {
  constexpr int GS = Geo<KP>::GS;
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);  // [KP][GS]
  float* sp = G + KP * GS;
  float* sap = sp + KP;
  float* red = sap + KP;
  const size_t row = blockIdx.x;
  const float* rec = sum + row * (size_t)(KP * KP + KP);
  for (int e = threadIdx.x; e < KP * KP / 2; e += kThreads) {  // GS is even
    const int m = e / (KP / 2), c = (e % (KP / 2)) * 2;
    *reinterpret_cast<float2*>(G + m * GS + c) =
        reinterpret_cast<const float2*>(rec)[e];
  }
  const float b = threadIdx.x < KP ? rec[KP * KP + threadIdx.x] : 0.f;
  __syncthreads();
  cg_block<KP>(G, b, lam[row], nullptr, x0, row, K, iters, sp, sap, red,
               false, out);
}

template <int KP>
constexpr size_t solve_smem_bytes() {
  return 4 * (KP * Geo<KP>::GS + 2 * KP + 32);
}

// The two-stage entry's gathered block in one pass: g[e] = table[cols[e]]
// where mask[e] > 0, else zeros (e over B * D), as the plain version's
// table[cols] * mask for a mask of 0 and 1. One warp per row of g: 16-byte
// copies when rows are 16-byte aligned, elements otherwise; out-of-range
// ids give zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const T* __restrict__ table, int M,
                       const int* __restrict__ cols,
                       const float* __restrict__ mask, long long n, int K,
                       T* __restrict__ g) {
  const long long e = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= n) return;
  const int lane = threadIdx.x & 31;
  const int c = cols[e];
  const bool live = mask[e] > 0.f && c >= 0 && c < M;
  const T* src = table + (size_t)c * K;
  T* dst = g + (size_t)e * K;
  const bool vec = (K * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  if (vec) {
    const int n4 = K * (int)sizeof(T) / 16;
    for (int i = lane; i < n4; i += 32)
      reinterpret_cast<float4*>(dst)[i] =
          live ? reinterpret_cast<const float4*>(src)[i]
               : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < K; i += 32) dst[i] = live ? src[i] : zero_as<T>();
  }
}

// Floats of the two-stage workspace: the S partial records of every row
// and, for S > 1, the summed records.
size_t two_stage_floats(int B, int KP, int S) {
  const size_t rec = (size_t)KP * KP + KP;
  return S > 1 ? (size_t)B * rec * ((size_t)S + 1) : 0;
}

template <int KP, typename T>
int launch_sliced(const void* g, const float* wv, const float* lam,
                  const float* x0, float* out, float* work, int B, int D,
                  int K, int iters, int S, int slice_rows, cudaStream_t st) {
  const bool vec = (K * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const size_t smem = slice_smem_bytes<KP, T>();
  const T* gt = static_cast<const T*>(g);
  cudaError_t err;
  if (S == 1) {
    auto kernel = gram_slice_kernel<KP, T, true>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, kThreads, smem, st>>>(gt, wv, lam, x0, out, nullptr, D, K,
                                      iters, 1, slice_rows, vec);
    return (int)cudaGetLastError();
  }
  auto kernel = gram_slice_kernel<KP, T, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((size_t)B * S), kThreads, smem, st>>>(
      gt, wv, lam, x0, out, work, D, K, iters, S, slice_rows, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rec4 = (KP * KP + KP) / 4;
  const int chunks = (rec4 + kThreads - 1) / kThreads;
  float* sum = work + (size_t)B * S * (KP * KP + KP);
  gram_reduce_kernel<<<(unsigned)((size_t)B * chunks), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(work), S, rec4, chunks,
      reinterpret_cast<float4*>(sum));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto solve = gram_solve_kernel<KP>;
  const size_t ssmem = solve_smem_bytes<KP>();
  err = cudaFuncSetAttribute(
      solve, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  if (err != cudaSuccess) return (int)err;
  solve<<<B, kThreads, ssmem, st>>>(sum, lam, x0, out, K, iters);
  return (int)cudaGetLastError();
}

template <int KP>
size_t row_smem_bytes() {
  return sizeof(float) * (KP * Geo<KP>::GS + kTileD * KP * 2 + 2 * KP + 32 +
                          3 * kTileD);
}

template <int KP>
size_t group_smem_bytes() {
  return sizeof(float) * (KP * Geo<KP>::GS + kTileD * KP +
                          2 * kGroupRows * KP + 32 + 3 * kTileD);
}

template <int KP, typename T>
int launch_rows(const void* src, int M, const int* cols, const float* gw,
                const float* rw, const float* lam, const float* nnz,
                const float* yty, const float* x0, float* out, int B, int D,
                int K, int iters, cudaStream_t stream) {
  auto kernel = row_solve_kernel<KP, T>;
  const size_t smem = row_smem_bytes<KP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, stream>>>(static_cast<const T*>(src), M, cols,
                                        gw, rw, lam, nnz, yty, x0, out, D, K,
                                        iters);
  return (int)cudaGetLastError();
}

template <int KP, typename T>
int launch_group(const void* g, const float* wv, const float* lam,
                 const float* x0, float* out, float* scratch, int B, int D,
                 int K, int iters, cudaStream_t stream) {
  auto kernel = group_solve_kernel<KP, T>;
  const size_t smem = group_smem_bytes<KP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kGroupRows - 1) / kGroupRows;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(g), wv, lam,
                                           x0, out, scratch, B, D, K, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int two_stage(const void* g, const float* wv, const float* lam,
              const float* x0, float* out, float* scratch, float* work, int B,
              int D, int K, int iters, int rows, int S, int slice_rows,
              cudaStream_t s) {
  const int kp = padded_rank(K);
  if (rows == kGroupRows) {
    switch (kp) {
      case 16: return launch_group<16, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
      case 32: return launch_group<32, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
      case 64: return launch_group<64, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
      default: return launch_group<128, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
    }
  }
  switch (kp) {
    case 16: return launch_sliced<16, T>(g, wv, lam, x0, out, work, B, D, K, iters, S, slice_rows, s);
    case 32: return launch_sliced<32, T>(g, wv, lam, x0, out, work, B, D, K, iters, S, slice_rows, s);
    case 64: return launch_sliced<64, T>(g, wv, lam, x0, out, work, B, D, K, iters, S, slice_rows, s);
    default: return launch_sliced<128, T>(g, wv, lam, x0, out, work, B, D, K, iters, S, slice_rows, s);
  }
}


template <typename T>
int fused(const void* table, int M, const int* cols, const float* gw,
          const float* rw, const float* lam, const float* nnz,
          const float* yty, const float* x0, float* out, int B, int D, int K,
          int iters, cudaStream_t s) {
  const int kp = padded_rank(K);
  switch (kp) {
    case 16: return launch_rows<16, T>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
    case 32: return launch_rows<32, T>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
    case 64: return launch_rows<64, T>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
    default: return launch_rows<128, T>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
  }
}

}  // namespace

extern "C" {

// Bytes of the rows = 1 workspace for S slices (0 for one slice): the
// partial records (Gram [KP][KP] and rhs [KP], f32) of every row and slice,
// then the summed record of every row.
size_t pio_als_two_stage_workspace_bytes(int B, int K, int S) {
  return sizeof(float) * two_stage_floats(B, padded_rank(K), S);
}

// Two-stage solve: g [B, D, K] (the masked rows gathered outside, f32 or
// bf16), wv [B, D] f32 (vals * mask), lam [B] f32, x0 [B, K] f32 or NULL,
// out [B, K] f32; rows 1 or 8; scratch [ceil(B/8)*8, KP, KP] f32 for rows 8
// (else NULL), KP = K rounded up to 16, 32, 64 or 128. rows 1 takes the
// launch plan of ops/als_kernels.two_stage_plan: S slices of slice_rows
// rows of d, each d row in exactly one, no more slices than slabs of
// slab_rows(KP) rows, and a workspace of workspace_bytes >=
// pio_als_two_stage_workspace_bytes(B, K, S).
int pio_als_solve_cg(const void* g, int g_is_bf16, const float* wv,
                     const float* lam, const float* x0, float* out,
                     float* scratch, int B, int D, int K, int iters, int rows,
                     int S, int slice_rows, void* workspace,
                     size_t workspace_bytes, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || K > kMaxRank || iters < 0 ||
      (rows != 1 && rows != kGroupRows) ||
      (rows == kGroupRows && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 1 &&
      (S <= 0 || slice_rows <= 0 ||
       (long long)S * slice_rows < D ||
       (long long)(S - 1) * slice_rows >= D ||
       S > (D + slab_rows(padded_rank(K)) - 1) / slab_rows(padded_rank(K)) ||
       workspace_bytes < pio_als_two_stage_workspace_bytes(B, K, S) ||
       (S > 1 && workspace == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* work = static_cast<float*>(workspace);
  return g_is_bf16
             ? two_stage<__nv_bfloat16>(g, wv, lam, x0, out, scratch, work, B,
                                        D, K, iters, rows, S, slice_rows, s)
             : two_stage<float>(g, wv, lam, x0, out, scratch, work, B, D, K,
                                iters, rows, S, slice_rows, s);
}

// The gathered block of the two-stage entry: g [n, K] = table [M, K] rows
// cols [n] (i32) where mask [n] (f32) > 0, else zeros; f32 or bf16, g and
// table 16-byte aligned.
int pio_als_gather_rows(const void* table, int table_is_bf16, int M,
                        const int* cols, const float* mask, long long n,
                        int K, void* g, void* stream) {
  if (M <= 0 || n < 0 || K <= 0 || K > kMaxRank)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  if (table_is_bf16)
    gather_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table), M, cols, mask, n, K,
        static_cast<__nv_bfloat16*>(g));
  else
    gather_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), M, cols, mask, n, K,
        static_cast<float*>(g));
  return (int)cudaGetLastError();
}

// Fused gather solve: table [M, K] (f32 or bf16), cols [B, D] i32,
// gw / rw [B, D] f32 (Gram and rhs weights, mask folded in), lam and nnz
// [B] f32, yty [K, K] f32 or NULL, x0 [B, K] f32 or NULL, out [B, K] f32.
int pio_als_fused_solve_cg(const void* table, int table_is_bf16, int M,
                           const int* cols, const float* gw, const float* rw,
                           const float* lam, const float* nnz,
                           const float* yty, const float* x0, float* out,
                           int B, int D, int K, int iters, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || K > kMaxRank || M <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_is_bf16
             ? fused<__nv_bfloat16>(table, M, cols, gw, rw, lam, nnz, yty,
                                    x0, out, B, D, K, iters, s)
             : fused<float>(table, M, cols, gw, rw, lam, nnz, yty, x0, out,
                            B, D, K, iters, s);
}

}  // extern "C"
