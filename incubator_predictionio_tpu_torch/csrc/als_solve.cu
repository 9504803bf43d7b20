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
// (at K = 128 in f32: 64 FMAs per 4-byte element read). The kernel runs
// the products on the f32 FMA units (67 TFLOP/s on an H100 SXM at 700 W,
// data sheet) also when the table is bf16, where the tensor cores would
// offer 989 TFLOP/s: it is the simple form; mma/wgmma on bf16 tiles is the
// fast one.
//
// Design. The TPU grid's sequential d axis (Gram carried in VMEM scratch
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileD = 32;       // d rows staged per tile
constexpr int kFlushTiles = 8;   // tiles summed in registers per flush
constexpr int kGroupRows = 8;    // rows per block of the R = 8 form
constexpr int kMaxRank = 128;
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

// One bucket row per block: Gram + rhs, then Jacobi-PCG in the block.
template <int KP, typename T, bool FUSED>
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
  float* tiles = G + KP * GS;                         // [1 or 2][kTileD][KP]
  float* sp = tiles + kTileD * KP * (FUSED ? 2 : 1);
  float* sap = sp + KP;
  float* red = sap + KP;
  Tile tile{tiles, tiles + kTileD * KP, red + 32, red + 32 + kTileD,
            reinterpret_cast<int*>(red + 32 + 2 * kTileD)};

  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  float b;
  gram_rhs<KP, T, FUSED>(src, M, cols, gw, rw, row, D, K, tile, G, b);

  const float lam_r = lam[row];
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
  if (tid < K) {
    const bool empty = FUSED && nnz[row] <= 0.f;
    out[row * K + tid] = empty ? 0.f : x;
  }
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

template <int KP, bool FUSED>
size_t row_smem_bytes() {
  return sizeof(float) * (KP * Geo<KP>::GS + kTileD * KP * (FUSED ? 2 : 1) +
                          2 * KP + 32 + 3 * kTileD);
}

template <int KP>
size_t group_smem_bytes() {
  return sizeof(float) * (KP * Geo<KP>::GS + kTileD * KP +
                          2 * kGroupRows * KP + 32 + 3 * kTileD);
}

template <int KP, typename T, bool FUSED>
int launch_rows(const void* src, int M, const int* cols, const float* gw,
                const float* rw, const float* lam, const float* nnz,
                const float* yty, const float* x0, float* out, int B, int D,
                int K, int iters, cudaStream_t stream) {
  auto kernel = row_solve_kernel<KP, T, FUSED>;
  const size_t smem = row_smem_bytes<KP, FUSED>();
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
              const float* x0, float* out, float* scratch, int B, int D,
              int K, int iters, int rows, cudaStream_t s) {
  const int kp = K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 128;
  if (rows == kGroupRows) {
    switch (kp) {
      case 16: return launch_group<16, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
      case 32: return launch_group<32, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
      case 64: return launch_group<64, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
      default: return launch_group<128, T>(g, wv, lam, x0, out, scratch, B, D, K, iters, s);
    }
  }
  switch (kp) {
    case 16: return launch_rows<16, T, false>(g, 0, nullptr, nullptr, wv, lam, nullptr, nullptr, x0, out, B, D, K, iters, s);
    case 32: return launch_rows<32, T, false>(g, 0, nullptr, nullptr, wv, lam, nullptr, nullptr, x0, out, B, D, K, iters, s);
    case 64: return launch_rows<64, T, false>(g, 0, nullptr, nullptr, wv, lam, nullptr, nullptr, x0, out, B, D, K, iters, s);
    default: return launch_rows<128, T, false>(g, 0, nullptr, nullptr, wv, lam, nullptr, nullptr, x0, out, B, D, K, iters, s);
  }
}

template <typename T>
int fused(const void* table, int M, const int* cols, const float* gw,
          const float* rw, const float* lam, const float* nnz,
          const float* yty, const float* x0, float* out, int B, int D, int K,
          int iters, cudaStream_t s) {
  const int kp = K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 128;
  switch (kp) {
    case 16: return launch_rows<16, T, true>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
    case 32: return launch_rows<32, T, true>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
    case 64: return launch_rows<64, T, true>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
    default: return launch_rows<128, T, true>(table, M, cols, gw, rw, lam, nnz, yty, x0, out, B, D, K, iters, s);
  }
}

}  // namespace

extern "C" {

// Two-stage solve: g [B, D, K] (the masked rows gathered outside, f32 or
// bf16), wv [B, D] f32 (vals * mask), lam [B] f32, x0 [B, K] f32 or NULL,
// out [B, K] f32; rows 1 or 8; scratch [ceil(B/8)*8, KP, KP] f32 for rows 8
// (else NULL), KP = K rounded up to 16, 32, 64 or 128.
int pio_als_solve_cg(const void* g, int g_is_bf16, const float* wv,
                     const float* lam, const float* x0, float* out,
                     float* scratch, int B, int D, int K, int iters, int rows,
                     void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || K > kMaxRank || iters < 0 ||
      (rows != 1 && rows != kGroupRows) ||
      (rows == kGroupRows && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_is_bf16
             ? two_stage<__nv_bfloat16>(g, wv, lam, x0, out, scratch, B, D,
                                        K, iters, rows, s)
             : two_stage<float>(g, wv, lam, x0, out, scratch, B, D, K, iters,
                                rows, s);
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
