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
//     bf16 x bf16 products are exact in f32. An f32 table gives f32-accurate
//     products (the TPU kernel pins Precision.HIGHEST): 3xTF32 below.
//   * the ridge lam (and the implicit YtY) stay out of the Gram: the matvec
//     is ap[k] = sum_l p[l] Gram[l][k] + lam p[k] (+ sum_l p[l] YtY[l][k]),
//     in f32; the Jacobi diagonal is Gram[k][k] + lam (+ YtY[k][k]).
//   * iters CG steps, cold from 0 or warm from x0 (one extra matvec), with
//     the guards alpha = pap > 0 ? rz / pap : 0, beta = rz > 0 ? rz2 / rz : 0
//     and minv = diag > 0 ? 1 / diag : 0, so empty and converged systems are
//     fixed points. The fused entry returns exactly 0 where nnz = 0
//     (pallas_kernels.py:1318); the two-stage entry has no such guard.
//   * rank padding (K up to KP: 16, 32, 64 or 128, then a multiple of 128, as
//     the TPU's als_padded_dims, pallas_kernels.py:846) solves to exactly 0.
//
// What bounds it on this card: the Gram, 2 * nnz * K^2 operations per
// half-sweep (half of them for its symmetric triangle) against nnz * K
// elements gathered, so it is operations-bound: at K = 128 in f32, 64 FMAs
// per 4-byte element read. The products run on the tensor cores: bf16
// mma.sync m16n8k16 (989 TFLOP/s dense on an H100 SXM at 700 W, data
// sheet), f32 as 3xTF32 m16n8k8 (the integer round-and-mask split of the
// flash kernel, lo*lo dropped: 495/3 TFLOP/s). A short row (d <= K) is the
// exception: its Gram costs more than its CG needs, and the R-row form
// below forms none.
//
// Design. One stage 1 serves both entries (GATHER: the fused entry's rows
// table[cols[d]], Gram-weighted by gw; else the two-stage entry's gathered
// [B, D, K] block, unweighted). A wide bucket has few rows (8 at D = 32,768)
// and each row's d range is long, so one block per row would leave most SMs
// idle: the launch plan (ops/als_kernels.solve_plan, computed in Python,
// checked here) cuts each row's d range into S equal slices, so that B * S
// (times the tiles below) reaches two blocks per SM where D allows.
//   * Stage 1, one block per (row, slice) (gram_slice_kernel; above rank 128
//     also per Gram tile, gram_tile_kernel): slabs of TD rows of d come
//     into shared memory by cp.async, 16-byte copies double-buffered, so the
//     next slab's L2/HBM reads overlap this slab's products; a slab's per-row
//     inputs (the table row cols[d] and both weights) come one slab further
//     ahead, in a ring of three, so a gathered row's address is known when
//     its copy is issued. Rows that contribute nothing (both weights 0, or a
//     column outside the table) are zero-filled, not read. The Gram runs on
//     the tensor cores: bf16 from ldmatrix.trans of the [d][k] slab; f32 as
//     3xTF32. Implicit confidences weigh the A fragment as it is loaded (in
//     bf16 one rounding of the exact f32 product: the TPU's gw_d t_d; in f32
//     one multiply before the split); the explicit weights are the mask,
//     which needs none where it holds only 0 and 1, as the buckets do (a
//     block that finds another value in its rows weighs them). A slab's
//     products (bf16; f32: a pair of k steps) go into a fresh accumulator
//     added in IEEE f32: the tensor cores' own adds into a running sum
//     drop bits, which a row's thousands of steps compound. Warps own
//     16-row m blocks and compute only the Gram's upper triangle (n
//     blocks of 8 columns from the m block's diagonal on, the diagonal
//     16 x 16 block whole): 72 of 128 products at K = 128, the m blocks
//     paired (0 with 7, 1 with 6, ...) so the SM's four tensor-core
//     sub-partitions get 18 n blocks each. Below
//     rank 128 warps also split the d steps and are added in warp order.
//     The rhs is f32 FMAs on the unweighted rows. With one slice the block
//     solves the row itself; else it writes its partial record (Gram
//     mirrored to the full square, rhs) to a workspace the wrapper allocates.
//     With a bf16 table and confidence weights (implicit) the rounded
//     weighted rows make the reference's Gram asymmetric; there every
//     block is summed and nothing mirrored.
//   * The CG with one slice at K = 128 runs its matvec from the Gram where
//     the mma accumulators leave it: each thread's products with p are
//     summed down the columns by a halving butterfly of warp shuffles and
//     across a row quad, the eight warps' partial vectors added in warp
//     order through shared memory (no atomics: the result does not depend
//     on scheduling); four block syncs a CG step. Below 128 the Gram goes to
//     shared memory and the matvec reads it there (cg_block's other form).
//   * Stage 2 (S > 1): gram_reduce_kernel sums each row's S records in slice
//     order (a fixed order) over many blocks; gram_solve_kernel, one block
//     per row, loads the sum into a shared-memory Gram and runs the CG.
//   * Above rank 128 a Gram of KP x KP f32 (256 KB at 256) does not fit in
//     shared memory. Stage 1 then builds it in 128 x 128 tiles, one block
//     per (row, slice, tile of the upper triangle), each writing its tile
//     and its mirror into the row's record, and the rhs with the diagonal
//     tiles; wide_solve_kernel runs the CG from the Gram in device memory
//     (it stays in L2 across the steps), one block per row, its vectors in
//     shared memory: the padded rank is at most kMaxRank.
//
// The R-row form (two-stage, rows = 8), for many short rows: the TPU's
// answer to a half-sweep of ~165k one-row programs that was overhead-bound
// (pallas_kernels.py:757-763). A row with d <= KP observations (KP <= 128)
// needs no Gram: its CG's matvec Gram p = T^T (T p) costs 4 d K operations
// from the row's [d, K] block against 2 K^2 from a Gram, and the Jacobi
// diagonal sum_d t_dk^2 and the rhs come in one pass over the block. So one
// block stages the blocks of R such rows (R up to kGroupRows, as many as
// fit in shared memory: 8 at d <= 64 in bf16 or d <= 32 in f32) with
// 16-byte cp.async copies, and each warp then runs one row's whole CG from
// shared memory, its vectors in registers and every reduction a warp
// shuffle: no block sync after the staging, no Gram, nothing through
// device memory. The CG runs in f64 (see rows_solve_kernel): T^T (T p)
// rounds differently from (T^T T) p, not its function, and in f64 the
// form follows the exact solve. A row with d > KP, or a rank above
// kRowsMaxRank, takes the one-row plan: stage 1 on the tensor cores, its d
// range cut into slices where it is long, so that a wide bucket of few
// rows fills the card.
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
constexpr int kGroupRows = 8;      // R-row form: most rows (warps) a block
constexpr int kRowsMaxRank = 128;  // R-row form: widest padded rank
constexpr int kSmemBlock = 232448; // shared memory a block can use (227 KB)
// rows of d in one staged slab of stage 1 (Tri<KT>::TD): padded rank 64 and
// above take the wide slabs' fewer rows, 16 and 32 the narrow
constexpr int kSlabRowsWide = 64;
constexpr int kSlabRowsNarrow = 128;
// above rank 128 the Gram is built in tiles of kGramTile x kGramTile
constexpr int kGramTile = 128;
// widest padded rank: the CG above 128 keeps five vectors of it in 160 KB of
// shared memory (the TPU kernel pins a KP x KP f32 Gram in VMEM, far less)
constexpr int kMaxRank = 8192;
// two blocks per SM, so at most 128 registers a thread: stage 1 at rank
// 128 spills under the cap, and without it (one block per SM, no spills)
// runs 1.1-1.6x slower on an H100
constexpr int kMinBlocks = 2;

// the rank the kernels compute at: K rounded up to 16, 32, 64 or 128, then
// to a multiple of kGramTile
constexpr int padded_rank(int K) {
  return K <= 16 ? 16
         : K <= 32 ? 32
         : K <= 64 ? 64
                   : (K + kGramTile - 1) / kGramTile * kGramTile;
}
constexpr int slab_rows(int kp) {
  return kp >= 64 ? kSlabRowsWide : kSlabRowsNarrow;
}
// stage-1 Gram tiles of one (row, slice): the upper triangle's above 128
constexpr int gram_tiles(int kp) {
  return kp <= kGramTile ? 1
                         : (kp / kGramTile) * (kp / kGramTile + 1) / 2;
}

template <int KP>
struct Geo {
  static constexpr int TPR = kThreads / KP;  // threads per matvec output
  static constexpr int GS = KP + KP / 8;     // shared Gram row stride
};

// rounding to the table's type (identity for f32)
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// block_sum with one sync: red holds two buffers of kWarps, used in turn
// (par flips), so a buffer is rewritten only after another call's sync,
// which every reader of its last use has passed
__device__ __forceinline__ float block_sum2(float v, float* red, int& par) {
  v = warp_sum(v);
  float* r = red + par * kWarps;
  par ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += r[w];
  return t;
}

// -- the CG ------------------------------------------------------------------

// ap = Gram p + lam p (+ YtY p) for one row, the whole block, from the Gram
// in shared memory ([KP][GS]); sp holds p.
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
// block: thread tid < KP holds coordinate tid, with dg = G[tid][tid] and b
// its rhs; matvec(sp, sap) returns coordinate tid of ap = (G + lam I [+
// YtY]) p for p in sp (sap: scratch it may use), every thread calling it.
// x goes to out[row], or exactly 0 where `empty`. sp, sap and red are
// shared scratch of KP, KP and 2 * kWarps floats. Three block syncs a step
// besides the matvec's.
template <int KP, typename MV>
__device__ __forceinline__ void cg_block(float dg, float b, float lam_r,
                                         const float* __restrict__ yty,
                                         const float* __restrict__ x0,
                                         size_t row, int K, int iters,
                                         float* sp, float* sap, float* red,
                                         bool empty, float* __restrict__ out,
                                         MV matvec) {
  const int tid = threadIdx.x;
  const bool mine = tid < KP;
  float minv = 0.f, x = 0.f, r = 0.f;
  if (mine) {
    dg += lam_r;
    if (yty != nullptr && tid < K) dg += yty[(size_t)tid * K + tid];
    minv = dg > 0.f ? 1.f / dg : 0.f;
    r = b;
  }
  int par = 0;
  if (x0 != nullptr) {
    if (mine) {
      x = tid < K ? x0[row * K + tid] : 0.f;
      sp[tid] = x;
    }
    __syncthreads();
    const float ax = matvec(sp, sap);
    if (mine) r = b - ax;
  }
  float z = minv * r;
  float rz = block_sum2(mine ? r * z : 0.f, red, par);
  float p = z;
  if (mine) sp[tid] = p;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const float mv = matvec(sp, sap);
    const float ap = mine ? mv : 0.f;
    const float pap = block_sum2(p * ap, red, par);
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    x = x + alpha * p;
    r = r - alpha * ap;
    z = minv * r;
    const float rz2 = block_sum2(r * z, red, par);
    const float beta = rz > 0.f ? rz2 / rz : 0.f;
    p = z + beta * p;
    rz = rz2;
    if (mine) sp[tid] = p;
    __syncthreads();
  }
  if (tid < K) out[row * K + tid] = empty ? 0.f : x;
}

// -- stage 1 on the tensor cores ------------------------------------------------

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// acc += c in IEEE f32. A slab's steps (bf16) or a pair of steps (f32) go
// into a fresh accumulator c, added here: the tensor cores' own adds into
// a running sum drop bits (they do not round to nearest), and a row's
// thousands of steps compound that (1.5e-4 of an f64 solve at D 9,000 and
// rank 256 in f32, against 2e-6 this way)
__device__ __forceinline__ void add4(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// two packed bf16 values times their weights, as the TPU kernel forms
// gw_d t_d: the weights rounded to bf16, the exact f32 products rounded to
// nearest even once
__device__ __forceinline__ uint32_t weigh_bf16x2(uint32_t a, float w0,
                                                 float w1) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  __nv_bfloat162 v =
      __floats2bfloat162_rn(t.x * round_as<__nv_bfloat16>(w0),
                            t.y * round_as<__nv_bfloat16>(w1));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Warp layout of stage 1 for a Gram tile of KT x KT (KT = the padded rank up
// to 128, else kGramTile): NM m blocks of 16 rows and NN n blocks of 8
// columns; warp w takes m block mblock(w) and, below 128, splits the d
// steps with the WD - 1 other warps of that block. Slabs are TD rows of d;
// shared rows are padded by 8 elements, which puts the 8 rows of an
// ldmatrix (bf16) and the 4 x 8 scalar fragment reads (f32) on distinct
// banks.
template <int KT>
struct Tri {
  static constexpr int NM = KT / 16;
  static constexpr int NN = KT / 8;
  static constexpr int WD = kWarps / NM;
  static constexpr int TD = slab_rows(KT);
  static constexpr int RS = KT + 8;
  static constexpr int NG = kThreads / KT;  // rhs: thread groups over d
  static_assert(NM * WD == kWarps, "warp layout");
};

// m block of warp w: 0, 1, .., NM/2 - 1, then NM - 1, NM - 2, ..: warps w
// and w + 4 share an SM sub-partition and get m blocks i and NM - 1 - i,
// whose upper-triangle n blocks add up to the same count
template <int KT>
__device__ __forceinline__ int mblock(int warp) {
  constexpr int NM = Tri<KT>::NM;
  const int x = warp % NM;
  return x < NM / 2 ? x : (3 * NM) / 2 - 1 - x;
}

// acc[nb] += A^T B over one staged slab, this warp's d steps: A the slab XA
// (weighted by w per d row when W and weighted), B the slab XB, m block mi,
// n blocks
// from jlo on (2 mi on a diagonal tile of a symmetric Gram: its upper
// triangle; else 0).
template <int KT, bool W>
__device__ __forceinline__ void slab_gram(const __nv_bfloat16* XA,
                                          const __nv_bfloat16* XB,
                                          const float* w, bool weighted,
                                          float (&acc)[Tri<KT>::NN][4],
                                          int mi, int jlo, int wd, int lane) {
  using G = Tri<KT>;
  constexpr int KS = G::TD / 16;                // k steps of a slab
  constexpr int KW = (KS + G::WD - 1) / G::WD;  // this warp's, at most
  const int j = lane >> 3, r = lane & 7, t = lane & 3;
  // the A fragments of this warp's k steps of the slab, held in registers
  uint32_t a[KW][4];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    const int ks = wd + q * G::WD;
    if (ks >= KS) continue;
    ldsm_x4_trans(a[q], XA + (ks * 16 + (j >> 1) * 8 + r) * G::RS +
                            mi * 16 + (j & 1) * 8);
    if (W && weighted) {
      // A's registers 0 and 1 hold d rows 2t, 2t + 1 of the step, 2 and 3
      // rows 2t + 8, 2t + 9
      const float* wk = w + ks * 16 + 2 * t;
      a[q][0] = weigh_bf16x2(a[q][0], wk[0], wk[1]);
      a[q][1] = weigh_bf16x2(a[q][1], wk[0], wk[1]);
      a[q][2] = weigh_bf16x2(a[q][2], wk[8], wk[9]);
      a[q][3] = weigh_bf16x2(a[q][3], wk[8], wk[9]);
    }
  }
  // each n block pair sums the slab's steps in fresh accumulators, added
  // to the running sum once a slab
#pragma unroll
  for (int np = 0; np < G::NN / 2; ++np) {
    if (2 * np < jlo) continue;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      const int ks = wd + q * G::WD;
      if (ks >= KS) continue;
      uint32_t b[4];
      ldsm_x4_trans(b, XB + (ks * 16 + (j & 1) * 8 + r) * G::RS + np * 16 +
                           (j >> 1) * 8);
      mma_bf16(c0, a[q], b[0], b[1]);
      mma_bf16(c1, a[q], b[2], b[3]);
    }
    add4(acc[2 * np], c0);
    add4(acc[2 * np + 1], c1);
  }
}

template <int KT, bool W>
__device__ __forceinline__ void slab_gram(const float* XA, const float* XB,
                                          const float* w, bool weighted,
                                          float (&acc)[Tri<KT>::NN][4],
                                          int mi, int jlo, int wd, int lane) {
  using G = Tri<KT>;
  const int g = lane >> 2, t = lane & 3;
  // k steps in pairs: each n block sums a pair in a fresh accumulator
  static_assert(G::TD / 8 % (2 * G::WD) == 0, "pairs of this warp's steps");
#pragma unroll 1
  for (int ks0 = 2 * wd; ks0 < G::TD / 8; ks0 += 2 * G::WD) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ks = ks0 + h;
      const float* a0 = XA + (ks * 8 + t) * G::RS + mi * 16 + g;
      const float* a1 = a0 + 4 * G::RS;
      float wa = 1.f, wb = 1.f;  // the weights of d rows t and t + 4
      if (W && weighted) {
        wa = w[ks * 8 + t];
        wb = w[ks * 8 + t + 4];
      }
      split_tf32(a0[0] * wa, ah[h][0], al[h][0]);
      split_tf32(a0[8] * wa, ah[h][1], al[h][1]);
      split_tf32(a1[0] * wb, ah[h][2], al[h][2]);
      split_tf32(a1[8] * wb, ah[h][3], al[h][3]);
    }
#pragma unroll
    for (int nb = 0; nb < G::NN; ++nb) {
      if (nb < jlo) continue;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* b0 = XB + ((ks0 + h) * 8 + t) * G::RS + g + nb * 8;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b0[0], bh0, bl0);
        split_tf32(b0[4 * G::RS], bh1, bl1);
        mma_tf32(c, al[h], bh0, bh1);  // lo*hi + hi*lo + hi*hi
        mma_tf32(c, ah[h], bl0, bl1);
        mma_tf32(c, ah[h], bh0, bh1);
      }
      add4(acc[nb], c);
    }
  }
}

// One bucket solve's arrays, as the C entries take them: the gather source
// (GATHER: the table [M, K]; else the gathered block [B, D, K]), cols and
// the Gram weights gw [B, D] (GATHER only: else the Gram is unweighted),
// the rhs weights rw [B, D], per row lam and nnz (nnz: the fused entry's
// empty rows, exactly 0; may be null), yty [K, K] (implicit; may be null),
// x0 [B, K] (may be null), out [B, K], and the workspace of partial records.
template <typename T>
struct Args {
  const T* src;
  int M;
  const int* cols;
  const float* gw;
  const float* rw;
  const float* lam;
  const float* nnz;
  const float* yty;
  const float* x0;
  float* out;
  float* part;
  int D, K, iters;
};

// Unweighted (explicit) the Gram weights are the mask, which the buckets
// hold as 0 or 1: such rows need no multiply (a row with both weights 0
// is zero-filled). A weight in the block's d rows [d_begin, d_end) that is
// neither turns the weighting on, and with a bf16 table the full Gram as
// well (see solve). Every block of one (row, slice) reads the same
// weights, so all decide alike.
template <typename T, bool GATHER>
__device__ __forceinline__ void weigh_fractional(const Args<T>& a, size_t row,
                                                 int d_begin, int d_end,
                                                 int& weighted, int& full) {
  if constexpr (GATHER) {
    if (weighted) return;
    bool frac = false;
    const float* gw = a.gw + row * (size_t)a.D;
    for (int d = d_begin + (int)threadIdx.x; d < d_end; d += kThreads)
      frac |= gw[d] != 0.f && gw[d] != 1.f;
    if (__syncthreads_or(frac)) {
      weighted = 1;
      full |= sizeof(T) == 2;
    }
  }
}

// the per-row inputs of slab rows [d0, d0 + TD) (0 past d_end) into one slot
// of the ring: GATHER the table row, the Gram and the rhs weight; else the
// rhs weight alone
template <int TD, bool GATHER>
__device__ __forceinline__ void load_index(int* icol, float* igw, float* irw,
                                           const int* cols, const float* gw,
                                           const float* rw, size_t base,
                                           int d0, int d_end) {
  constexpr int NI = GATHER ? 3 : 1;
  for (int e = threadIdx.x; e < NI * TD; e += kThreads) {
    const int which = GATHER ? e / TD : 2, r = GATHER ? e % TD : e;
    const bool in = d0 + r < d_end;
    const size_t at = base + d0 + r;
    void* dst = which == 0 ? static_cast<void*>(icol + r)
                : which == 1 ? static_cast<void*>(igw + r)
                             : static_cast<void*>(irw + r);
    const void* src = which == 0 ? static_cast<const void*>(cols + at)
                      : which == 1 ? static_cast<const void*>(gw + at)
                                   : static_cast<const void*>(rw + at);
    cp_async4(dst, in ? src : static_cast<const void*>(rw), in ? 4 : 0);
  }
}

// Slab rows [d0, d0 + TD) into dst: np <= NP panels of TD x RS elements,
// panel p holding the KT columns from c0a, c0b (zero past K); GATHER rows are table
// rows icol[r], zero where the row contributes nothing (both weights 0 or
// a row outside the table), else rows of the bucket row's [D, K] block,
// zero past d_end. vec: 16-byte cp.async (K * sizeof(T) a multiple of 16
// and the source aligned); else f32 takes 4-byte cp.async and bf16 plain
// loads.
template <int KT, int NP, typename T, bool GATHER>
__device__ __forceinline__ void load_rows(T* dst, const int* icol,
                                          const float* igw, const float* irw,
                                          const T* src, int M, size_t brow,
                                          int d0, int d_end, int K, int np,
                                          int c0a, int c0b, bool vec) {
  using G = Tri<KT>;
  constexpr int kPer = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  auto row_src = [&](int r) -> const T* {
    if constexpr (GATHER) {
      const int c = icol[r];
      return ((unsigned)c < (unsigned)M && (igw[r] != 0.f || irw[r] != 0.f))
                 ? src + (size_t)c * K
                 : nullptr;
    } else {
      return d0 + r < d_end ? src + (brow + d0 + r) * K : nullptr;
    }
  };
  if (vec) {
    constexpr int kParts = KT / kPer;
    constexpr int kPanel = G::TD * kParts;
    const int all = np * kPanel;
#pragma unroll
    for (int i = 0; i < (NP * kPanel + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (e < all) {
        const int p = e / kPanel, q = e - p * kPanel;
        const int r = q / kParts, cl = (q % kParts) * kPer;
        const int col = (p == 0 ? c0a : c0b) + cl;
        const T* s = row_src(r);
        const bool in = s != nullptr && col < K;
        cp_async16(dst + (p * G::TD + r) * G::RS + cl, in ? s + col : src,
                   in ? 16 : 0);
      }
    }
  } else {
    const int all = np * G::TD * KT;
    for (int e = tid; e < all; e += kThreads) {
      const int p = e / (G::TD * KT), q = e - p * (G::TD * KT);
      const int r = q / KT, cl = q % KT;
      const int col = (p == 0 ? c0a : c0b) + cl;
      const T* s = row_src(r);
      const bool in = s != nullptr && col < K;
      T* d = dst + (p * G::TD + r) * G::RS + cl;
      if constexpr (sizeof(T) == 4)
        cp_async4(d, in ? s + col : src, in ? 4 : 0);
      else
        *d = in ? s[col] : zero_as<T>();
    }
  }
}

// Stage 1's loop over d rows [d_begin, d_end) of bucket row `row`: slabs of
// TD rows come in double-buffered (slab: [2][np][TD][RS], np <= NP panels
// of columns from c0a and c0b), their per-row
// inputs one slab further ahead in a ring of three slots (icol, igw, irw:
// [3][TD] each), and body(X, w, rw) runs on each slab that has landed while
// the next one's copies are in flight; first() runs once, while the first
// slab's inputs are.
template <int KT, int NP, typename T, bool GATHER, typename Body,
          typename First>
__device__ __forceinline__ void slab_loop(T* slab, int* icol, float* igw,
                                          float* irw, const Args<T>& a,
                                          size_t row, int d_begin, int d_end,
                                          int np, int c0a, int c0b, bool vec,
                                          Body body, First first) {
  using G = Tri<KT>;
  constexpr int TD = G::TD;
  const int SL = np * TD * G::RS;  // elements of one slab buffer
  const size_t base = row * (size_t)a.D;
  const int n_slabs = (d_end - d_begin + TD - 1) / TD;
  load_index<TD, GATHER>(icol, igw, irw, a.cols, a.gw, a.rw, base, d_begin,
                         d_end);
  cp_async_commit();
  first();
  cp_async_wait_all();
  __syncthreads();
  load_rows<KT, NP, T, GATHER>(slab, icol, igw, irw, a.src, a.M, base,
                               d_begin, d_end, a.K, np, c0a, c0b, vec);
  if (n_slabs > 1)
    load_index<TD, GATHER>(icol + TD, igw + TD, irw + TD, a.cols, a.gw, a.rw,
                           base, d_begin + TD, d_end);
  cp_async_commit();
  for (int n = 0; n < n_slabs; ++n) {
    // slab n and slab n + 1's inputs have landed, and every warp is done
    // with slab n - 1, whose buffer and ring slot are rewritten now
    cp_async_wait_all();
    __syncthreads();
    const int s1 = (n + 1) % 3, s2 = (n + 2) % 3, s0 = n % 3;
    if (n + 1 < n_slabs)
      load_rows<KT, NP, T, GATHER>(slab + ((n + 1) & 1) * SL, icol + s1 * TD,
                                   igw + s1 * TD, irw + s1 * TD, a.src, a.M,
                                   base, d_begin + (n + 1) * TD, d_end, a.K,
                                   np, c0a, c0b, vec);
    if (n + 2 < n_slabs)
      load_index<TD, GATHER>(icol + s2 * TD, igw + s2 * TD, irw + s2 * TD,
                             a.cols, a.gw, a.rw, base, d_begin + (n + 2) * TD,
                             d_end);
    cp_async_commit();
    body(slab + (n & 1) * SL, igw + s0 * TD, irw + s0 * TD);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The shared memory of gram_slice_kernel: the slabs and the ring, in the
// same bytes as the Gram that follows them; then the rhs pieces, the CG's
// vectors and reduction scratch, the warps' matvec parts and the diagonal.
template <int KP, typename T>
__host__ __device__ constexpr size_t slab_ring_bytes(int np) {
  using G = Tri<(KP < kGramTile ? KP : kGramTile)>;
  return 2 * (size_t)np * G::TD * G::RS * sizeof(T) + 3 * (size_t)G::TD * 12;
}

template <int KP, typename T>
__host__ __device__ constexpr size_t slice_union_bytes() {
  return slab_ring_bytes<KP, T>(1) > (size_t)KP * Geo<KP>::GS * 4
             ? slab_ring_bytes<KP, T>(1)
             : (size_t)KP * Geo<KP>::GS * 4;
}

template <int KP, typename T>
constexpr size_t slice_smem_bytes() {
  return slice_union_bytes<KP, T>() +
         4 * ((size_t)Tri<KP>::NG * KP + 2 * KP + 32 + kWarps * KP + KP);
}

// Stage 1, rank <= 128: block (row, slice) sums the Gram and rhs of d rows
// [s * slice_rows, min(D, (s + 1) * slice_rows)) of one bucket row: its
// upper triangle, mirrored, or with `full` every block (see solve). SOLVE
// (one slice): the block then runs the CG, at K = 128 from the
// accumulators, below from the warps' pieces summed in shared memory; else
// it writes the partial record (Gram [KP][KP], rhs [KP]) to
// part[row][slice].
template <int KP, typename T, bool GATHER, bool SOLVE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gram_slice_kernel(Args<T> a, int S, int slice_rows, int vec,
                      int weighted, int full) {
  using G = Tri<KP>;
  constexpr int GS = Geo<KP>::GS, TD = G::TD, RS = G::RS, NN = G::NN;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  T* slab = reinterpret_cast<T*>(sm);  // [2][TD][RS]
  int* icol = reinterpret_cast<int*>(sm + 2 * (size_t)TD * RS * sizeof(T));
  float* igw = reinterpret_cast<float*>(icol + 3 * TD);
  float* irw = igw + 3 * TD;
  float* Gs = reinterpret_cast<float*>(sm);  // [KP][GS], after the slabs
  float* rs =
      reinterpret_cast<float*>(sm + slice_union_bytes<KP, T>());  // [NG][KP]
  float* sp = rs + G::NG * KP;
  float* sap = sp + KP;
  float* red = sap + KP;
  float* part = red + 32;            // [kWarps][KP]
  float* sdg = part + kWarps * KP;   // [KP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = mblock<KP>(warp), wd = warp / G::NM;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = blockIdx.x / S;
  const int sl = blockIdx.x % S;
  const int d_begin = sl * slice_rows;
  const int d_end = min(a.D, d_begin + slice_rows);
  int jlo = 0;  // set by the loop's first(): the Gram's form

  float acc[NN][4];
#pragma unroll
  for (int nb = 0; nb < NN; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float rpart = 0.f;
  const int rk = tid % KP, rg = tid / KP;
  slab_loop<KP, 1, T, GATHER>(
      slab, icol, igw, irw, a, row, d_begin, d_end, 1, 0, 0, vec != 0,
      [&](const T* X, const float* w, const float* wr) {
        slab_gram<KP, GATHER>(X, X, w, weighted != 0, acc, mi, jlo, wd,
                              lane);
        for (int d = rg; d < TD; d += G::NG)
          rpart = fmaf(round_as<T>(wr[d]), widen<T>(X[d * RS + rk]), rpart);
      },
      [&] {
        weigh_fractional<T, GATHER>(a, row, d_begin, d_end, weighted, full);
        jlo = full ? 0 : 2 * mi;
      });
  rs[rg * KP + rk] = rpart;
  const float lam_r = SOLVE ? a.lam[row] : 0.f;
  const bool empty = SOLVE && a.nnz != nullptr && a.nnz[row] <= 0.f;

  if constexpr (SOLVE && KP == kGramTile) {
    {
      // the diagonal from the accumulators, then the CG with the matvec
      // where the accumulators are
#pragma unroll
      for (int nb = 0; nb < NN; ++nb)
        if ((nb >> 1) == mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = mi * 16 + g + 8 * (e >> 1);
            if (m == nb * 8 + 2 * t + (e & 1)) sdg[m] = acc[nb][e];
          }
      __syncthreads();
      float b = 0.f, dg = 0.f;
      if (tid < KP) {
        for (int q = 0; q < G::NG; ++q) b += rs[q * KP + tid];
        dg = sdg[tid];
      }
      float* pw = part + warp * KP;
      auto matvec = [&](const float* p, float*) {
        const float pm0 = p[mi * 16 + g], pm1 = p[mi * 16 + g + 8];
        // this thread's products down its columns (col(i): column pair i /
        // 2, column i % 2 of the pair), summed over the 8 lanes of a column
        // by halving: after three exchanges a lane holds four column sums
        auto col = [&](int i) {
          return fmaf(acc[i >> 1][2 + (i & 1)], pm1, acc[i >> 1][i & 1] * pm0);
        };
        const bool u4 = lane & 16, u2 = lane & 8, u1 = lane & 4;
        float h[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float lo = col(q), hi = col(q + 16);
          h[q] = (u4 ? hi : lo) +
                 __shfl_xor_sync(0xffffffffu, u4 ? lo : hi, 16);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          h[q] = (u2 ? h[q + 8] : h[q]) +
                 __shfl_xor_sync(0xffffffffu, u2 ? h[q] : h[q + 8], 8);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h[q] = (u1 ? h[q + 4] : h[q]) +
                 __shfl_xor_sync(0xffffffffu, u1 ? h[q] : h[q + 4], 4);
        // and, for a symmetric Gram, along the rows of the blocks above
        // the diagonal (the lower triangle's, mirrored), summed over the
        // quad
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int nb = 0; nb < NN; ++nb)
          if (!full && nb >= jlo + 2) {
            const float2 pn =
                *reinterpret_cast<const float2*>(p + nb * 8 + 2 * t);
            r0 = fmaf(acc[nb][0], pn.x, fmaf(acc[nb][1], pn.y, r0));
            r1 = fmaf(acc[nb][2], pn.x, fmaf(acc[nb][3], pn.y, r1));
          }
        r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
        r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
        *reinterpret_cast<float2*>(pw + 16 * g + 2 * t) =
            make_float2(h[0], h[1]);
        *reinterpret_cast<float2*>(pw + 16 * g + 8 + 2 * t) =
            make_float2(h[2], h[3]);
        __syncwarp();
        if (t == 0) {
          pw[mi * 16 + g] += r0;
          pw[mi * 16 + g + 8] += r1;
        }
        __syncthreads();
        float s = 0.f, sy = 0.f;
        if (tid < KP) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += part[w * KP + tid];
          if (a.yty != nullptr && tid < a.K)
            for (int l = 0; l < a.K; ++l)
              sy = fmaf(a.yty[(size_t)l * a.K + tid], p[l], sy);
          s = (s + lam_r * p[tid]) + sy;
        }
        return s;  // the thread's own coordinate: nobody else reads it
      };
      cg_block<KP>(dg, b, lam_r, a.yty, a.x0, row, a.K, a.iters, sp, sap,
                   red, empty, a.out, matvec);
      return;
    }
  }

  // the warp pieces into Gs, in warp order of wd, each mirrored below the
  // diagonal blocks unless the Gram is full
  for (int w = 0; w < G::WD; ++w) {
    if (wd == w) {
#pragma unroll
      for (int nb = 0; nb < NN; ++nb)
        if (nb >= jlo)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mi * 16 + g + 8 * h, n = nb * 8 + 2 * t;
            float2* pg = reinterpret_cast<float2*>(Gs + m * GS + n);
            float2 v = make_float2(acc[nb][2 * h], acc[nb][2 * h + 1]);
            if (w > 0) {
              const float2 o = *pg;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *pg = v;
            if (!full && nb >= jlo + 2) {
              Gs[n * GS + m] = v.x;
              Gs[(n + 1) * GS + m] = v.y;
            }
          }
    }
    __syncthreads();
  }
  float b = 0.f;
  if (tid < KP)
    for (int q = 0; q < G::NG; ++q) b += rs[q * KP + tid];
  if constexpr (SOLVE) {
    cg_block<KP>(tid < KP ? Gs[tid * GS + tid] : 0.f, b, lam_r, a.yty, a.x0,
                 row, a.K, a.iters, sp, sap, red, empty, a.out,
                 [&](const float* p, float* ap) {
                   matvec_block<KP>(Gs, p, ap, lam_r, a.yty, a.K);
                   return threadIdx.x < KP ? ap[threadIdx.x] : 0.f;
                 });
  } else {
    float* rec = a.part + (row * S + sl) * (size_t)(KP * KP + KP);
    for (int e = tid; e < KP * KP / 2; e += kThreads) {  // GS is even
      const int m = e / (KP / 2), c = (e % (KP / 2)) * 2;
      reinterpret_cast<float2*>(rec)[e] =
          *reinterpret_cast<const float2*>(Gs + m * GS + c);
    }
    if (tid < KP) rec[KP * KP + tid] = b;
  }
}

template <typename T>
constexpr size_t tile_smem_bytes() {
  return slab_ring_bytes<kGramTile, T>(2) +
         4 * (size_t)Tri<kGramTile>::NG * kGramTile;
}

// Stage 1 above rank 128: block (row, slice, tile) sums Gram tile (I, J)
// of the 128 x 128 tiles of the padded rank, over the slice's d rows
// (panel 0 the columns of I, panel 1 those of J, one panel when I = J),
// into the record part[row][slice] ([KP][KP], then rhs [KP]): the tiles
// with I <= J and their mirrors, or with `full` every tile (see solve); a
// diagonal tile also writes rhs[I]. The grid covers the upper triangle of
// tiles, or with `square` (where a block may find its Gram full) them all.
template <typename T, bool GATHER>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gram_tile_kernel(Args<T> a, int KP, int S, int slice_rows, int vec,
                     int weighted, int full, int square) {
  using G = Tri<kGramTile>;
  constexpr int TD = G::TD, RS = G::RS, NN = G::NN;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  T* slab = reinterpret_cast<T*>(sm);  // [2][2][TD][RS]
  int* icol = reinterpret_cast<int*>(sm + 4 * (size_t)TD * RS * sizeof(T));
  float* igw = reinterpret_cast<float*>(icol + 3 * TD);
  float* irw = igw + 3 * TD;
  float* rs = irw + 3 * TD;  // [NG][kGramTile]

  const int nt = KP / kGramTile;
  const int tiles = square ? nt * nt : nt * (nt + 1) / 2;
  const int tile = blockIdx.x % tiles;
  const size_t rsl = blockIdx.x / tiles;
  const size_t row = rsl / S;
  const int sl = (int)(rsl % S);
  // tile -> (I, J), row-major over the square or the upper triangle
  int I = square ? tile / nt : 0, rem = square ? tile % nt : tile;
  if (!square)
    while (rem >= nt - I) {
      rem -= nt - I;
      ++I;
    }
  const int J = square ? rem : I + rem;
  const bool diag = I == J;
  const int d_begin = sl * slice_rows;
  const int d_end = min(a.D, d_begin + slice_rows);
  weigh_fractional<T, GATHER>(a, row, d_begin, d_end, weighted, full);
  // on a square grid a symmetric Gram's lower tiles are the upper ones'
  // mirrors, which those write
  if (square && !full && I > J) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = mblock<kGramTile>(warp);
  const int jlo = diag && !full ? 2 * mi : 0;
  const int g = lane >> 2, t = lane & 3;

  float acc[NN][4];
#pragma unroll
  for (int nb = 0; nb < NN; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float rpart = 0.f;
  const int rk = tid % kGramTile, rg = tid / kGramTile;
  slab_loop<kGramTile, 2, T, GATHER>(
      slab, icol, igw, irw, a, row, d_begin, d_end, diag ? 1 : 2,
      I * kGramTile, J * kGramTile, vec != 0,
      [&](const T* X, const float* w, const float* wr) {
        slab_gram<kGramTile, GATHER>(X, diag ? X : X + TD * RS, w,
                                     weighted != 0, acc, mi, jlo, 0, lane);
        if (diag)
          for (int d = rg; d < TD; d += G::NG)
            rpart =
                fmaf(round_as<T>(wr[d]), widen<T>(X[d * RS + rk]), rpart);
      },
      [] {});
  float* rec = a.part + (row * S + sl) * ((size_t)KP * KP + KP);
#pragma unroll
  for (int nb = 0; nb < NN; ++nb)
    if (nb >= jlo)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = I * kGramTile + mi * 16 + g + 8 * h;
        const int n = J * kGramTile + nb * 8 + 2 * t;
        const float v0 = acc[nb][2 * h], v1 = acc[nb][2 * h + 1];
        *reinterpret_cast<float2*>(rec + (size_t)m * KP + n) =
            make_float2(v0, v1);
        if (!full && (!diag || nb >= jlo + 2)) {
          rec[(size_t)n * KP + m] = v0;
          rec[(size_t)(n + 1) * KP + m] = v1;
        }
      }
  if (diag) {
    rs[rg * kGramTile + rk] = rpart;
    __syncthreads();
    if (tid < kGramTile) {
      float b = 0.f;
      for (int q = 0; q < G::NG; ++q) b += rs[q * kGramTile + tid];
      rec[(size_t)KP * KP + I * kGramTile + tid] = b;
    }
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

// Stage 2b (S > 1, rank <= 128): one block per row loads its summed record
// into the shared Gram and runs the CG.
template <int KP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gram_solve_kernel(const float* __restrict__ sum,
                      const float* __restrict__ lam,
                      const float* __restrict__ nnz,
                      const float* __restrict__ yty,
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
  const float lam_r = lam[row];
  const int tid = threadIdx.x;
  cg_block<KP>(tid < KP ? G[tid * GS + tid] : 0.f, b, lam_r, yty, x0, row, K,
               iters, sp, sap, red, nnz != nullptr && nnz[row] <= 0.f, out,
               [&](const float* p, float* ap) {
                 matvec_block<KP>(G, p, ap, lam_r, yty, K);
                 return threadIdx.x < KP ? ap[threadIdx.x] : 0.f;
               });
}

template <int KP>
constexpr size_t solve_smem_bytes() {
  return 4 * (KP * Geo<KP>::GS + 2 * KP + 32);
}

// Above rank 128: the CG of one row per block from its record (Gram
// [KP][KP], symmetric, then rhs [KP]) in device memory, where the Gram stays
// in L2 across the steps; x, r, p, ap and the Jacobi inverse in shared
// memory, coordinates k = tid, tid + 256, .. per thread. The same steps
// and guards as cg_block.
__global__ void __launch_bounds__(kThreads)
    wide_solve_kernel(const float* __restrict__ recs,
                      const float* __restrict__ lam,
                      const float* __restrict__ nnz,
                      const float* __restrict__ yty,
                      const float* __restrict__ x0, float* __restrict__ out,
                      int KP, int K, int iters) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);
  float* sr = sx + KP;
  float* sp = sr + KP;
  float* sap = sp + KP;
  float* sm = sap + KP;
  float* red = sm + KP;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* G = recs + row * ((size_t)KP * KP + KP);
  const float* rhs = G + (size_t)KP * KP;
  const float lam_r = lam[row];
  auto matvec = [&](const float* p, float* ap) {
    for (int k = tid; k < KP; k += kThreads) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int l = 0; l < KP; l += 4) {
        s0 = fmaf(G[(size_t)l * KP + k], p[l], s0);
        s1 = fmaf(G[(size_t)(l + 1) * KP + k], p[l + 1], s1);
        s2 = fmaf(G[(size_t)(l + 2) * KP + k], p[l + 2], s2);
        s3 = fmaf(G[(size_t)(l + 3) * KP + k], p[l + 3], s3);
      }
      float sy = 0.f;
      if (yty != nullptr && k < K)
        for (int l = 0; l < K; ++l)
          sy = fmaf(yty[(size_t)l * K + k], p[l], sy);
      ap[k] = (((s0 + s1) + (s2 + s3)) + lam_r * p[k]) + sy;
    }
    __syncthreads();
  };
  for (int k = tid; k < KP; k += kThreads) {
    float dg = G[(size_t)k * KP + k] + lam_r;
    if (yty != nullptr && k < K) dg += yty[(size_t)k * K + k];
    sm[k] = dg > 0.f ? 1.f / dg : 0.f;
    sx[k] = (x0 != nullptr && k < K) ? x0[row * K + k] : 0.f;
    sr[k] = rhs[k];
  }
  __syncthreads();
  if (x0 != nullptr) {
    matvec(sx, sap);
    for (int k = tid; k < KP; k += kThreads) sr[k] = rhs[k] - sap[k];
  }
  float part = 0.f;
  for (int k = tid; k < KP; k += kThreads) {
    const float z = sm[k] * sr[k];
    sp[k] = z;
    part += sr[k] * z;
  }
  float rz = block_sum(part, red);
  for (int it = 0; it < iters; ++it) {
    matvec(sp, sap);
    part = 0.f;
    for (int k = tid; k < KP; k += kThreads) part += sp[k] * sap[k];
    const float pap = block_sum(part, red);
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    part = 0.f;
    for (int k = tid; k < KP; k += kThreads) {
      sx[k] = sx[k] + alpha * sp[k];
      sr[k] = sr[k] - alpha * sap[k];
      part += sr[k] * (sm[k] * sr[k]);
    }
    const float rz2 = block_sum(part, red);
    const float beta = rz > 0.f ? rz2 / rz : 0.f;
    for (int k = tid; k < KP; k += kThreads)
      sp[k] = sm[k] * sr[k] + beta * sp[k];
    rz = rz2;
    __syncthreads();
  }
  const bool empty = nnz != nullptr && nnz[row] <= 0.f;
  for (int k = tid; k < K; k += kThreads) out[row * K + k] = empty ? 0.f : sx[k];
}

// The two-stage entry's gathered block in one pass: g[e] = table[cols[e]] *
// mask[e] (e over B * D), as the plain version's table[cols] * mask: a copy
// where the mask is 1, zeros where it is 0 or the id is out of range, else
// the product rounded to T, the mask rounded to T first. One warp per row
// of g: 16-byte copies when rows are 16-byte aligned, elements otherwise.
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
  const float m = mask[e];
  const bool live = m != 0.f && c >= 0 && c < M;
  const T* src = table + (size_t)c * K;
  T* dst = g + (size_t)e * K;
  if (live && m != 1.f) {
    const float mr = round_as<T>(m);
    for (int i = lane; i < K; i += 32)
      dst[i] = narrow<T>(widen<T>(src[i]) * mr);
    return;
  }
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

// -- the R-row form: many short rows, one warp each ---------------------------

// Lane layout of the R-row form at padded rank KP: a lane holds VK
// coordinates (16 bytes of a staged row), LK lanes span a row, and the
// warp's 32 / LK lane groups split the d rows; shared rows are padded by
// 16 bytes, which puts the 8 lanes of a 16-byte shared load that read 8
// consecutive d rows at one column on distinct banks.
template <int KP, typename T>
struct RowsGeo {
  static constexpr int VK = 16 / (int)sizeof(T);
  static constexpr int LK = KP / VK;
  static constexpr int GD = 32 / LK;
  static constexpr int RS = KP + VK;
};

// Shared memory of one row of the R-row form: its [D][RS] block, then f64
// u [D rounded up to 2] and p [KP].
template <int KP, typename T>
__host__ __device__ constexpr size_t rows_row_bytes(int D) {
  return (size_t)D * RowsGeo<KP, T>::RS * sizeof(T) +
         8 * ((size_t)(D + 1) / 2 * 2 + KP);
}

// rows a block of the R-row form takes: as many as fit (at most kGroupRows)
template <int KP, typename T>
int rows_per_block(int D) {
  const size_t per = rows_row_bytes<KP, T>(D);
  const size_t r = kSmemBlock / per;
  return (int)(r < (size_t)kGroupRows ? r : (size_t)kGroupRows);
}

// the VK coordinates [c, c + VK) of a staged row, widened to f32
__device__ __forceinline__ void load_vk(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vk(const __nv_bfloat16* p,
                                        float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// R-row form (two-stage, rows = 8): block x stages the [D, K] blocks of
// rows [x R, x R + R) of g (contiguous there; columns K..KP zero), then
// warp w runs row x R + w's CG alone: the Jacobi diagonal sum_d t_dk^2 and
// rhs sum_d wv_d t_dk in one pass, then each matvec as u = T p (lanes over
// d rows, a row's products summed across the lanes that split its
// columns), ap = T^T u + lam p (lanes over columns, summed across the
// lane groups that split the d rows), every sum a butterfly of shuffles,
// which leaves identical values in every lane. The CG, its matvec
// included, runs in f64 and rounds x to f32 once: T^T (T p) rounds
// differently from the Gram route's (T^T T) p, and a system with d < K is
// singular but for the ridge, where 16 f32 CG steps amplify any rounding
// (chip_smoke.als_tolerance); in f64 the form follows the exact solve of
// the same CG. The same steps and guards as cg_block; no guard for an
// empty row (the two-stage contract).
template <int KP, typename T>
__global__ void __launch_bounds__(kThreads)
    rows_solve_kernel(const T* __restrict__ g, const float* __restrict__ wv,
                      const float* __restrict__ lam,
                      const float* __restrict__ x0, float* __restrict__ out,
                      int B, int D, int K, int iters, int R, int vec) {
  using RG = RowsGeo<KP, T>;
  constexpr int VK = RG::VK, LK = RG::LK, GD = RG::GD, RS = RG::RS;
  extern __shared__ float4 smem4[];
  T* slab = reinterpret_cast<T*>(smem4);  // [R][D][RS]
  const size_t b0 = (size_t)blockIdx.x * R;
  const int nr = (int)min((size_t)R, (size_t)B - b0);
  const int D2 = (D + 1) / 2 * 2;
  // [R][D2 + KP] f64, 16-byte aligned: a row's RS elements are 16 bytes
  double* vecs = reinterpret_cast<double*>(slab + (size_t)R * D * RS);

  // stage the rows' blocks: nr * D rows of K elements from g, in order
  const T* src = g + b0 * D * K;
  const int n_rows = nr * D;
  if (vec) {
    constexpr int kParts = KP / VK;
    for (int e = threadIdx.x; e < n_rows * kParts; e += blockDim.x) {
      const int r = e / kParts, c = (e % kParts) * VK;
      const bool in = c < K;
      cp_async16(slab + (size_t)r * RS + c, in ? src + (size_t)r * K + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * KP; e += blockDim.x) {
      const int r = e / KP, c = e % KP;
      const bool in = c < K;
      T* d = slab + (size_t)r * RS + c;
      if constexpr (sizeof(T) == 4)
        cp_async4(d, in ? src + (size_t)r * K + c : src, in ? 4 : 0);
      else
        *d = in ? src[(size_t)r * K + c] : zero_as<T>();
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= nr) return;
  const size_t row = b0 + warp;
  const T* S = slab + (size_t)warp * D * RS;
  double* su = vecs + (size_t)warp * (D2 + KP);
  double* sp = su + D2;
  const int kl = lane % LK, dg = lane / LK, k0 = kl * VK;
  const bool owner = dg == 0;  // one replica of each coordinate counts
  // u = T p: DR lanes take DR d rows at a time, the KS = 32 / DR lanes of
  // a row splitting its LK column parts
  int DR = 1;
  while (DR < D && DR < 32) DR <<= 1;
  const int KS = 32 / DR, dr = lane % DR, ks = lane / DR;

  double dia[VK], b[VK];
#pragma unroll
  for (int i = 0; i < VK; ++i) dia[i] = b[i] = 0.0;
  for (int d = dg; d < D; d += GD) {
    float t[VK];
    load_vk(S + (size_t)d * RS + k0, t);
    const double w = round_as<T>(wv[row * D + d]);
#pragma unroll
    for (int i = 0; i < VK; ++i) {
      dia[i] = fma((double)t[i], (double)t[i], dia[i]);
      b[i] = fma(w, (double)t[i], b[i]);
    }
  }
#pragma unroll
  for (int o = LK; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < VK; ++i) {
      dia[i] += __shfl_xor_sync(0xffffffffu, dia[i], o);
      b[i] += __shfl_xor_sync(0xffffffffu, b[i], o);
    }
  const double lam_r = lam[row];

  // ap = T^T (T v) + lam v, every lane calling it with its coordinates
  auto matvec = [&](const double (&v)[VK], double (&ap)[VK]) {
    if (owner)
#pragma unroll
      for (int i = 0; i < VK; i += 2)
        *reinterpret_cast<double2*>(sp + k0 + i) = make_double2(v[i], v[i + 1]);
    __syncwarp();
    for (int d0 = 0; d0 < D; d0 += DR) {
      const int d = d0 + dr;
      double s = 0.0;
      if (d < D)
        for (int c = ks; c < LK; c += KS) {
          float t[VK];
          load_vk(S + (size_t)d * RS + c * VK, t);
#pragma unroll
          for (int i = 0; i < VK; i += 2) {
            const double2 pv =
                *reinterpret_cast<const double2*>(sp + c * VK + i);
            s = fma((double)t[i], pv.x, s);
            s = fma((double)t[i + 1], pv.y, s);
          }
        }
      for (int o = DR; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (ks == 0 && d < D) su[d] = s;
    }
    __syncwarp();
    double a[VK];
#pragma unroll
    for (int i = 0; i < VK; ++i) a[i] = 0.0;
    for (int d = dg; d < D; d += GD) {
      float t[VK];
      load_vk(S + (size_t)d * RS + k0, t);
      const double u = su[d];
#pragma unroll
      for (int i = 0; i < VK; ++i) a[i] = fma((double)t[i], u, a[i]);
    }
#pragma unroll
    for (int o = LK; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < VK; ++i)
        a[i] += __shfl_xor_sync(0xffffffffu, a[i], o);
#pragma unroll
    for (int i = 0; i < VK; ++i) ap[i] = a[i] + lam_r * v[i];
    __syncwarp();  // sp and su are free again
  };
  auto dot = [&](const double (&u)[VK], const double (&v)[VK]) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < VK; ++i) s = fma(u[i], v[i], s);
    return warp_sum_f64(owner ? s : 0.0);
  };

  double x[VK], r[VK], p[VK], z[VK], ap[VK], minv[VK];
#pragma unroll
  for (int i = 0; i < VK; ++i) {
    const int k = k0 + i;
    const double dd = dia[i] + lam_r;
    minv[i] = dd > 0.0 ? 1.0 / dd : 0.0;
    x[i] = (x0 != nullptr && k < K) ? (double)x0[row * K + k] : 0.0;
    r[i] = b[i];
  }
  if (x0 != nullptr) {
    matvec(x, ap);
#pragma unroll
    for (int i = 0; i < VK; ++i) r[i] = b[i] - ap[i];
  }
#pragma unroll
  for (int i = 0; i < VK; ++i) {
    z[i] = minv[i] * r[i];
    p[i] = z[i];
  }
  double rz = dot(r, z);
  for (int it = 0; it < iters; ++it) {
    matvec(p, ap);
    const double pap = dot(p, ap);
    const double alpha = pap > 0.0 ? rz / pap : 0.0;
#pragma unroll
    for (int i = 0; i < VK; ++i) {
      x[i] = x[i] + alpha * p[i];
      r[i] = r[i] - alpha * ap[i];
      z[i] = minv[i] * r[i];
    }
    const double rz2 = dot(r, z);
    const double beta = rz > 0.0 ? rz2 / rz : 0.0;
#pragma unroll
    for (int i = 0; i < VK; ++i) p[i] = z[i] + beta * p[i];
    rz = rz2;
  }
  if (owner)
#pragma unroll
    for (int i = 0; i < VK; ++i)
      if (k0 + i < K) out[row * K + k0 + i] = (float)x[i];
}

// Floats of the workspace of B rows cut into S slices: the S partial
// records of every row and, for S > 1, the summed records; above rank 128
// also the one record of an unsliced row, where stage 1 writes its tiles.
size_t solve_floats(int B, int KP, int S) {
  const size_t rec = (size_t)KP * KP + KP;
  const size_t per = S > 1 ? (size_t)S + 1 : KP > kGramTile ? 1 : 0;
  return (size_t)B * rec * per;
}

// The launch plan of ops/als_kernels.solve_plan, checked: S slices of
// slice_rows rows of d, each d row in exactly one, no more slices than
// slabs, and a workspace of at least solve_floats(B, KP, S) floats.
bool bad_plan(int B, int D, int K, int S, int slice_rows,
              const void* workspace, size_t workspace_bytes) {
  const int kp = padded_rank(K), sr = slab_rows(kp);
  const size_t need = sizeof(float) * solve_floats(B, kp, S);
  return S <= 0 || slice_rows <= 0 || (long long)S * slice_rows < D ||
         (long long)(S - 1) * slice_rows >= D || S > (D + sr - 1) / sr ||
         workspace_bytes < need || (need > 0 && workspace == nullptr);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
bool aligned16(const Args<T>& a) {
  return (a.K * sizeof(T)) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(a.src) & 15) == 0;
}

template <int KP, typename T, bool GATHER>
int launch_slices(const Args<T>& a, int B, int S, int slice_rows,
                  int weighted, int full, cudaStream_t st) {
  const int vec = aligned16(a);
  const size_t smem = slice_smem_bytes<KP, T>();
  int err;
  if (S == 1) {
    auto kernel = gram_slice_kernel<KP, T, GATHER, true>;
    if ((err = set_smem(kernel, smem)) != 0) return err;
    kernel<<<B, kThreads, smem, st>>>(a, 1, slice_rows, vec, weighted,
                                      full);
    return (int)cudaGetLastError();
  }
  auto kernel = gram_slice_kernel<KP, T, GATHER, false>;
  if ((err = set_smem(kernel, smem)) != 0) return err;
  kernel<<<(unsigned)((size_t)B * S), kThreads, smem, st>>>(
      a, S, slice_rows, vec, weighted, full);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int rec4 = (KP * KP + KP) / 4;
  const int chunks = (rec4 + kThreads - 1) / kThreads;
  float* sum = a.part + (size_t)B * S * (KP * KP + KP);
  gram_reduce_kernel<<<(unsigned)((size_t)B * chunks), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(a.part), S, rec4, chunks,
      reinterpret_cast<float4*>(sum));
  if ((err = (int)cudaGetLastError()) != 0) return err;
  auto solve = gram_solve_kernel<KP>;
  const size_t ssmem = solve_smem_bytes<KP>();
  if ((err = set_smem(solve, ssmem)) != 0) return err;
  solve<<<B, kThreads, ssmem, st>>>(sum, a.lam, a.nnz, a.yty, a.x0, a.out,
                                    a.K, a.iters);
  return (int)cudaGetLastError();
}

template <typename T, bool GATHER>
int launch_tiles(const Args<T>& a, int B, int KP, int S, int slice_rows,
                 int weighted, int full, cudaStream_t st) {
  const int vec = aligned16(a);
  const size_t rec = (size_t)KP * KP + KP;
  // explicit weights in bf16 may turn out fractional, and the Gram full
  const int square = full || (GATHER && !weighted && sizeof(T) == 2);
  const size_t smem = tile_smem_bytes<T>();
  auto kernel = gram_tile_kernel<T, GATHER>;
  int err;
  if ((err = set_smem(kernel, smem)) != 0) return err;
  const int nt = KP / kGramTile;
  const size_t tiles = square ? (size_t)nt * nt : (size_t)gram_tiles(KP);
  kernel<<<(unsigned)((size_t)B * S * tiles), kThreads, smem, st>>>(
      a, KP, S, slice_rows, vec, weighted, full, square);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const float* grams = a.part;
  if (S > 1) {
    const int rec4 = (int)(rec / 4);
    const int chunks = (rec4 + kThreads - 1) / kThreads;
    float* sum = a.part + (size_t)B * S * rec;
    gram_reduce_kernel<<<(unsigned)((size_t)B * chunks), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(a.part), S, rec4, chunks,
        reinterpret_cast<float4*>(sum));
    if ((err = (int)cudaGetLastError()) != 0) return err;
    grams = sum;
  }
  const size_t ssmem = sizeof(float) * (5 * (size_t)KP + 32);
  if ((err = set_smem(wide_solve_kernel, ssmem)) != 0) return err;
  wide_solve_kernel<<<B, kThreads, ssmem, st>>>(grams, a.lam, a.nnz, a.yty,
                                                a.x0, a.out, KP, a.K,
                                                a.iters);
  return (int)cudaGetLastError();
}

// The Gram's form. The fused entry's implicit confidences (yty given)
// weigh the rows. The explicit Gram weights are the mask, 0 or 1 as the
// buckets hold it, and a row with both weights 0 is zero-filled, so the
// others weigh 1 (`weighted` 0) unless a block finds another weight in
// its d rows (weigh_fractional: weighing every f32 row instead, exact for
// a 0 or 1, measured slower on an H100). Weighted rows rounded to bf16
// make the reference's Gram asymmetric, Gram[k][l] = sum_d round(gw_d
// t_dk) t_dl: there every block is summed (`full`). Otherwise it is
// symmetric (f32 weighted rows are exact to f32 rounding) and only its
// upper triangle is, then mirrored.
template <typename T, bool GATHER>
int solve(const Args<T>& a, int B, int S, int slice_rows, cudaStream_t s) {
  const int w = GATHER && a.yty != nullptr;
  const int full = w && sizeof(T) == 2;
  const int kp = padded_rank(a.K);
  switch (kp) {
    case 16: return launch_slices<16, T, GATHER>(a, B, S, slice_rows, w, full, s);
    case 32: return launch_slices<32, T, GATHER>(a, B, S, slice_rows, w, full, s);
    case 64: return launch_slices<64, T, GATHER>(a, B, S, slice_rows, w, full, s);
    case 128: return launch_slices<128, T, GATHER>(a, B, S, slice_rows, w, full, s);
    default: return launch_tiles<T, GATHER>(a, B, kp, S, slice_rows, w, full, s);
  }
}

template <int KP, typename T>
int launch_rows(const void* g, const float* wv, const float* lam,
                const float* x0, float* out, int B, int D, int K, int iters,
                cudaStream_t stream) {
  auto kernel = rows_solve_kernel<KP, T>;
  const int R = rows_per_block<KP, T>(D);
  const size_t smem = R * rows_row_bytes<KP, T>(D);
  int err;
  if ((err = set_smem(kernel, smem)) != 0) return err;
  const int vec = (K * sizeof(T)) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  kernel<<<(unsigned)((B + R - 1) / R), 32 * R, smem, stream>>>(
      static_cast<const T*>(g), wv, lam, x0, out, B, D, K, iters, R, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int solve_rows(const void* g, const float* wv, const float* lam,
               const float* x0, float* out, int B, int D, int K, int iters,
               cudaStream_t s) {
  switch (padded_rank(K)) {
    case 16: return launch_rows<16, T>(g, wv, lam, x0, out, B, D, K, iters, s);
    case 32: return launch_rows<32, T>(g, wv, lam, x0, out, B, D, K, iters, s);
    case 64: return launch_rows<64, T>(g, wv, lam, x0, out, B, D, K, iters, s);
    default: return launch_rows<128, T>(g, wv, lam, x0, out, B, D, K, iters, s);
  }
}

// whether the R-row form takes rows of d observations at rank K
bool rows_form(int D, int K) {
  const int kp = padded_rank(K);
  return kp <= kRowsMaxRank && D <= kp;
}

}  // namespace

extern "C" {

// Bytes of the workspace of B rows of rank K cut into S slices: the partial
// records (Gram [KP][KP] and rhs [KP], f32) of every row and slice, then for
// S > 1 the summed record of every row; above rank 128 at least one record
// a row (0 for one slice at rank <= 128).
size_t pio_als_workspace_bytes(int B, int K, int S) {
  return sizeof(float) * solve_floats(B, padded_rank(K), S);
}

// Two-stage solve: g [B, D, K] (the masked rows gathered outside, f32 or
// bf16), wv [B, D] f32 (vals * mask), lam [B] f32, x0 [B, K] f32 or NULL,
// out [B, K] f32; rows 1 or 8. rows 8, the R-row form, takes rows of d <= KP
// at padded rank KP <= kRowsMaxRank (KP = K rounded up to 16, 32, 64 or
// 128; pio_als_rows_form) and no plan; rows 1 the launch plan (S,
// slice_rows, workspace: bad_plan).
int pio_als_solve_cg(const void* g, int g_is_bf16, const float* wv,
                     const float* lam, const float* x0, float* out, int B,
                     int D, int K, int iters, int rows, int S, int slice_rows,
                     void* workspace, size_t workspace_bytes, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || K > kMaxRank || iters < 0 ||
      (rows != 1 && rows != kGroupRows) ||
      (rows == kGroupRows && !rows_form(D, K)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == kGroupRows)
    return g_is_bf16 ? solve_rows<__nv_bfloat16>(g, wv, lam, x0, out, B, D,
                                                 K, iters, s)
                     : solve_rows<float>(g, wv, lam, x0, out, B, D, K, iters,
                                         s);
  if (bad_plan(B, D, K, S, slice_rows, workspace, workspace_bytes))
    return (int)cudaErrorInvalidValue;
  float* work = static_cast<float*>(workspace);
  if (g_is_bf16) {
    const Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(g),
                                0, nullptr, nullptr, wv, lam, nullptr,
                                nullptr, x0, out, work, D, K, iters};
    return solve<__nv_bfloat16, false>(a, B, S, slice_rows, s);
  }
  const Args<float> a{static_cast<const float*>(g), 0, nullptr, nullptr,
                      wv, lam, nullptr, nullptr, x0, out, work, D, K, iters};
  return solve<float, false>(a, B, S, slice_rows, s);
}

// Rows a block of the R-row form takes at these sizes (one warp each), or 0
// where the form does not take them (the one-row plan does).
int pio_als_group_rows(int D, int K, int is_bf16) {
  if (D <= 0 || K <= 0 || !rows_form(D, K)) return 0;
  switch (padded_rank(K)) {
    case 16: return is_bf16 ? rows_per_block<16, __nv_bfloat16>(D) : rows_per_block<16, float>(D);
    case 32: return is_bf16 ? rows_per_block<32, __nv_bfloat16>(D) : rows_per_block<32, float>(D);
    case 64: return is_bf16 ? rows_per_block<64, __nv_bfloat16>(D) : rows_per_block<64, float>(D);
    default: return is_bf16 ? rows_per_block<128, __nv_bfloat16>(D) : rows_per_block<128, float>(D);
  }
}

// The gathered block of the two-stage entry: g [n, K] = table [M, K] rows
// cols [n] (i32) where mask [n] (f32) > 0, else zeros; f32 or bf16, g and
// table 16-byte aligned.
int pio_als_gather_rows(const void* table, int table_is_bf16, int M,
                        const int* cols, const float* mask, long long n,
                        int K, void* g, void* stream) {
  if (M <= 0 || n < 0 || K <= 0) return (int)cudaErrorInvalidValue;
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
// gw / rw [B, D] f32 (Gram and rhs weights, mask folded in: without yty,
// explicit, gw is the mask, of any value), lam and nnz
// [B] f32, yty [K, K] f32 or NULL, x0 [B, K] f32 or NULL, out [B, K] f32;
// the launch plan as the two-stage entry's (bad_plan).
int pio_als_fused_solve_cg(const void* table, int table_is_bf16, int M,
                           const int* cols, const float* gw, const float* rw,
                           const float* lam, const float* nnz,
                           const float* yty, const float* x0, float* out,
                           int B, int D, int K, int iters, int S,
                           int slice_rows, void* workspace,
                           size_t workspace_bytes, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || K > kMaxRank || M <= 0 || iters < 0 ||
      bad_plan(B, D, K, S, slice_rows, workspace, workspace_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* work = static_cast<float*>(workspace);
  if (table_is_bf16) {
    const Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(table), M,
                                cols, gw, rw, lam, nnz, yty, x0, out, work,
                                D, K, iters};
    return solve<__nv_bfloat16, true>(a, B, S, slice_rows, s);
  }
  const Args<float> a{static_cast<const float*>(table), M, cols, gw, rw, lam,
                      nnz, yty, x0, out, work, D, K, iters};
  return solve<float, true>(a, B, S, slice_rows, s);
}

}  // extern "C"
