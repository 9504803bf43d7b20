// Forward flash attention (online softmax) on BSHD tensors, for Hopper
// (sm_90a), with its products on the tensor cores.
//
// Replaces the TPU kernel incubator_predictionio_tpu/ops/pallas_kernels.py
// flash_attention (:582) -> _flash_with_vjp (:483) -> _flash_bhsd (:425,
// pallas_call :450), body _flash_kernel (:350). Same contract:
//   * q [B, Sq, H, D], k and v [B, Skv, H, D], f32 or bf16, read through their
//     strides (no transposes); out [B, Sq, H, D] contiguous, in q's dtype;
//   * f32 softmax state: the running max m, sum l and the accumulator are f32;
//     f32 q is scaled on load (q * scale, as the TPU kernel does); bf16 q
//     enters the product as it is and its f32 scores are scaled, since q *
//     scale is not a bf16 value;
//   * a key is live when valid[b, key] > 0 and, if causal, key <= query, with
//     positions counted from 0 for both q and kv, also when Sq != Skv;
//   * a masked score is -1e30 (MASK_VALUE) in the max, and its probability is
//     set to 0 explicitly: if a query's first live tile is fully masked, m =
//     -1e30 and exp(s - m) would be 1;
//   * a query with no live key (the left padding of a SASRec window) gives
//     exactly 0: l == 0 is divided as 1.
//
// What bounds it on this card: the QK^T and PV products, 4*D FLOP per live
// (query, key) pair and head; the bytes (q, k, v read once, out written once)
// are far smaller at S >= 1024. So the products run on the tensor cores:
//   * bf16: mma.sync m16n8k16 with f32 accumulation. QK^T is exact in its
//     products, as JAX's upcast-then-dot is; P is rounded to bf16 for PV
//     (FlashAttention-2's choice), held to chip_smoke's 8e-3 tolerance.
//   * f32: 3xTF32. Each operand is split a = hi + lo, hi rounded to TF32,
//     and mma.sync m16n8k8 TF32 takes lo*hi + hi*lo + hi*hi, which keeps f32
//     accuracy (1e-4 of max|out|) at three times the TF32 work; the card's
//     least time for that is at 495/3 TFLOP/s (runtime.TF32_FLOPS). The
//     split is two integer ops and a subtraction: cvt.rna.tf32 would issue
//     at a quarter of the rate, and ~350 of them a warp and tile made the
//     conversions, not the tensor cores, the limit.
// Past the products, what costs is per element of S (mask, exp2, the online
// softmax): interior tiles whose 64 keys are all valid and wholly in the
// causal past skip the per-element mask, and exp2 is one ex2.approx.
//
// Design (FlashAttention-2's layout): one block of 4 warps per (query tile of
// 64, batch*head), 16 query rows a warp; batch*head and the query tiles share
// grid x, so any B*H is taken. The warp's Q fragments stay in
// registers for the whole KV scan; S = QK^T of a 64-key tile accumulates in
// registers; the online softmax runs on those accumulator fragments (row max
// and sum across the lane quad with two __shfl_xor_sync); P is repacked from
// the S accumulators straight into the A operand of the PV product (f32:
// the keys of an 8-key step are taken in the order 0,2,4,6,1,3,5,7, the order
// the accumulator holds them, and V's rows are read in the same order); O
// accumulates in registers. K and V tiles are double-buffered in shared
// memory and filled by cp.async, tile t+1's copy in flight while tile t's
// products run; fragments of K (and of bf16 V, transposed) are read with
// ldmatrix. Every shared-memory row is padded by 16 bytes, which puts the 8
// rows of an ldmatrix (and the f32 V reads, rows 2t and 2t+1 of lane t) on
// distinct banks. Head widths pad to 16/32/64/128 with zeros in shared memory.
// Unaligned inputs (a head width or stride not a multiple of 16 bytes) take
// plain loads into the same layout, without the overlap.
//
// Tiles that are wholly padding are skipped: a first small kernel
// (flash_tiles_kernel) reads the validity once and marks, for each batch row
// and 64-key tile, whether it holds a live key and whether all 64 keys are
// valid (one ballot each), in bitmasks in the workspace. The attention block
// visits only marked tiles, below the causal limit (key tiles wholly in the
// future of the query tile): a dead tile is neither copied nor computed, so a
// left-padded window costs in proportion to its live tiles, holes included.
// A query tile with no live tile writes exactly 0 and does no products.
// Within a live tile the mask is per element. Query tiles start longest-first.
//
// A small grid (fewer than 4 blocks an SM: the engine's one served window
// is 128 query tiles x 2 heads) would leave each query tile's key tiles as
// one serial chain on one SM, and a window half padded would take half the
// full window's time. There a query tile's live tiles are cut into chunks of
// 8 (by rank, so padding makes no empty chunks), one block each (grid z,
// last chunks first); a query tile with more than one chunk writes f32
// partials (o unnormalised, m, l) to the workspace, and
// flash_combine_kernel merges them, one warp a row.
//
// Heads of 129-256 (the TPU kernel pads only S and takes any D) take
// flash_wide_kernel, the same layout on the tensor cores: each warp owns
// all of its 16 rows' output columns, so QK^T runs once per tile. Its O
// accumulator fills half a thread's registers, so Q is read from shared
// memory per k step instead of held in registers, and K and V have one
// buffer each, refilled in separate cp.async groups (FlashAttention-2's
// order) to fit 64-key tiles of 256-wide f32 rows in shared memory. Head
// widths pad to a multiple of 32 with zeros in shared memory. Heads wider
// than 256 would not fit its registers and take flash_dtiled_kernel, the
// first design: D-tiled on the f32 FMA units, one block of 128 threads per
// (16 query rows, batch*head, 128 output columns), each recomputing S for
// its columns; right, not fast.
//
// Plain C interface, bound from Python with ctypes; launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kWarps = 4;       // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kMaskValue = -1e30f;  // ops/attention.py MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; the head_dim stride is 1
};

// Which 64-key tiles of each batch row hold a live key (live) and have all
// 64 keys valid (full), one bit a tile, [B][words] each; written by
// flash_tiles_kernel before the attention reads it.
struct Tiles {
  uint32_t *live, *full;
  int words;
};

// A query tile's live key tiles cut into chunks of `chunk` live tiles, one
// block each, when the grid of query tiles is too small to fill the card
// (n > 1: the most chunks a query tile can have). A query tile with more
// than one chunk writes f32 partials (unnormalised o, max m in log2 units,
// sum l) for each, [n][B*H][Sq]([D]), and flash_combine_kernel merges them.
struct Split {
  int n, chunk;
  float *o, *m, *l;
};

constexpr int kSplitTiles = 8;   // live tiles a chunk: 512 keys
constexpr int kMaxDevices = 64;  // devices whose attributes are cached
constexpr int kMaxHead = 128;    // widest head of flash_fwd_kernel
constexpr int kMaxWide = 256;    // widest head of flash_wide_kernel
constexpr int kWQ = 16;          // heads above kMaxWide: query rows a block
constexpr int kWC = 64;          // heads above kMaxWide: columns a QK^T step
constexpr int kWV = 128;         // heads above kMaxWide: output columns

// key tiles a query tile can see: below the causal limit, if causal
__host__ __device__ __forceinline__ int q_tile_kv(int qt, int Sq, int Skv,
                                                  int causal) {
  int n = (Skv + kBK - 1) / kBK;
  if (causal) {
    // live only if tile_start <= the tile's last real query position
    const int last = (qt * kBQ + kBQ < Sq ? qt * kBQ + kBQ : Sq) - 1;
    n = n < last / kBK + 1 ? n : last / kBK + 1;
  }
  return n;
}

// marked tiles below n
__device__ __forceinline__ int count_live(const uint32_t* bits, int n) {
  int c = 0;
  for (int w = 0; w < (n >> 5); ++w) c += __popc(__ldg(bits + w));
  if (n & 31) c += __popc(__ldg(bits + (n >> 5)) & ((1u << (n & 31)) - 1u));
  return c;
}

// chunks of a query tile with n_live live tiles (1: not split)
__device__ __forceinline__ int q_tile_chunks(int n_live, const Split& sp) {
  if (sp.n <= 1 || n_live <= sp.chunk) return 1;
  return (n_live + sp.chunk - 1) / sp.chunk;
}

// elements of one shared-memory row: the padded head and 16 bytes
template <typename T, int DP>
__host__ __device__ constexpr int row_elems() {
  return DP + 16 / (int)sizeof(T);
}

template <typename T, int DP>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)kBK * row_elems<T, DP>() * sizeof(T);
}

// Qs, then Ks[2], Vs[2], Val[2][kBK] f32
template <typename T, int DP>
__host__ __device__ constexpr size_t fixed_smem_bytes() {
  return 5 * tile_bytes<T, DP>() + 2 * kBK * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zeroed
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
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

// 2^x in one MUFU op (ex2.approx: relative error ~2^-22; 2^-1e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (integer ops, at
// full rate, where cvt.rna.tf32 issues at a quarter of it), lo = x - hi
// exactly; the tensor core reads lo's top 10 mantissa bits, an error of at
// most 2^-22 |x|
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

// c += a * b in 3xTF32: a and b split into TF32 halves, lo*lo dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// 64 rows [row0, row0 + 64) of a [rows, D] slab with row stride `stride`
// into a shared tile of padded rows; rows >= limit and columns >= D are
// zero. vec: 16-byte cp.async (D and the strides multiples of 16 bytes);
// else plain loads.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0,
                                          int limit, int D, bool vec) {
  constexpr int kRow = row_elems<T, DP>();
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = DP / kPer;         // per row
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * kPer;
      const int row = row0 + r;
      const bool in = row < limit && col < D;
      cp_async16(dst + r * kRow + col,
                 in ? src + (long long)row * stride + col : src, in ? 16 : 0);
    }
  } else {
    for (int c = tid; c < kBK * DP; c += kThreads) {
      const int r = c / DP, col = c % DP;
      const int row = row0 + r;
      dst[r * kRow + col] = (row < limit && col < D)
                                ? src[(long long)row * stride + col]
                                : from_f32<T>(0.f);
    }
  }
}

// the validity of keys [k0, k0 + 64) as f32 in shared memory (0 past Skv)
__device__ __forceinline__ void load_valid(float* dst, const float* valb,
                                           int k0, int Skv) {
  const int tid = threadIdx.x;
  if (tid < kBK) {
    const int key = k0 + tid;
    if (valb == nullptr)
      dst[tid] = key < Skv ? 1.f : 0.f;
    else
      cp_async4(dst + tid, key < Skv ? valb + key : valb, key < Skv ? 4 : 0);
  }
}

// first marked tile at or after t, or n
__device__ __forceinline__ int next_live(const uint32_t* bits, int t, int n) {
  while (t < n) {
    const uint32_t w = __ldg(bits + (t >> 5)) >> (t & 31);
    if (w) return min(t + __ffs(w) - 1, n);
    t = (t | 31) + 1;
  }
  return n;
}

// the marked tile of rank r (from 0), or n
__device__ __forceinline__ int nth_live(const uint32_t* bits, int r, int n) {
  for (int w = 0; w < ((n + 31) >> 5); ++w) {
    uint32_t x = __ldg(bits + w);
    const int c = __popc(x);
    if (r < c) {
      for (int i = 0; i < r; ++i) x &= x - 1u;  // drop the r lowest
      return min(w * 32 + __ffs(x) - 1, n);
    }
    r -= c;
  }
  return n;
}

// Tiles of batch row blockIdx.x / words, word blockIdx.x % words (32
// tiles): warp w reads tiles 8w..8w+7, all 16 of a lane's loads in flight
// together, one ballot a tile for live and one for full
__global__ void __launch_bounds__(kThreads)
    flash_tiles_kernel(const float* __restrict__ valid, int Skv, Tiles tiles) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / tiles.words;
  const int word = blockIdx.x - b * tiles.words;
  const int t0 = word * 32 + warp * 8;
  const float* valb = valid == nullptr ? nullptr : valid + (long long)b * Skv;
  float x[8][2];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = (t0 + u) * kBK + 32 * half + lane;
      x[u][half] =
          key >= Skv ? 0.f : valb == nullptr ? 1.f : __ldg(valb + key);
    }
  uint32_t live = 0u, full = 0u;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const bool l0 = x[u][0] > 0.f, l1 = x[u][1] > 0.f;
    live |= (__any_sync(0xffffffffu, l0 || l1) ? 1u : 0u) << u;
    full |= (__all_sync(0xffffffffu, l0 && l1) ? 1u : 0u) << u;
  }
  __shared__ uint32_t part[2][kWarps];
  if (lane == 0) {
    part[0][warp] = live << (8 * warp);
    part[1][warp] = full << (8 * warp);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long w = (long long)b * tiles.words + word;
    tiles.live[w] = part[0][0] | part[0][1] | part[0][2] | part[0][3];
    tiles.full[w] = part[1][0] | part[1][1] | part[1][2] | part[1][3];
  }
}

// S = Q K^T over one tile of kBK keys: 8 column tiles of 8 keys, DP / 16
// (bf16) or DP / 8 (f32) k steps; qfrag(kk, a) gives the warp's A fragment
// of step kk: bf16 the m16n8k16 registers, f32 the (scaled) q values of the
// m16n8k8 fragment, split here
template <typename T, int DP, typename QF>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const T* Kt,
                                        int lane, QF qfrag) {
  constexpr int kRow = row_elems<T, DP>();
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4];
      qfrag(kk, qa);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, Kt + (np * 16 + (j >> 1) * 8 + r) * kRow + kk * 16 +
                         (j & 1) * 8);
        mma_bf16(s[2 * np], qa, bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qa, bfr[2], bfr[3]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      float qf[4];
      qfrag(kk, qf);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(qf[e], ah[e], al[e]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4], bh[4], bl[4];
        ldsm_x4(bfr, reinterpret_cast<const float*>(Kt) +
                         (np * 16 + (j >> 1) * 8 + r) * kRow + kk * 8 +
                         (j & 1) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(bfr[e]), bh[e], bl[e]);
        mma_3xtf32(s[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(s[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

// The mask of keys [k0, k0 + kBK) (where `masked`: validity Vl, and the
// causal limit), then the online softmax on the S fragments in log2 units:
// m_r and this thread's part of l_r updated, o rescaled, s turned into P
// (0 at a masked key, explicitly)
template <int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4],
                                             float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&o)[ND][4], bool masked,
                                             const float* Vl, bool causal,
                                             int r_lo, int k0, float s_mul,
                                             int t4) {
  float mx[2] = {kMaskValue, kMaskValue};
  if (masked) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const int row = r_lo + (e >> 1) * 8;
        const bool live = Vl[col] > 0.f && (!causal || row >= k0 + col);
        s[n][e] = live ? s[n][e] * s_mul : kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= s_mul;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_r[i], mx[i]);
    corr[i] = ex2(m_r[i] - m_new);  // 0 after a fully masked start
    m_r[i] = m_new;
    l_r[i] *= corr[i];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = s[n][e];
      const float p = masked && sv == kMaskValue ? 0.f : ex2(sv - m_r[e >> 1]);
      s[n][e] = p;
      l_r[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }
}

// O += P V over one tile: P from the S accumulators as the A operand (bf16:
// rounded, 16 keys a step; f32: split, 8 keys a step in the order
// 0,2,4,6,1,3,5,7 that the accumulator holds them, V's rows read alike)
template <typename T, int DP>
__device__ __forceinline__ void pv_tile(float (&o)[DP / 8][4],
                                        const float (&s)[8][4], const T* Vt,
                                        int lane) {
  constexpr int kRow = row_elems<T, DP>();
  constexpr int kND = DP / 8;
  if constexpr (sizeof(T) == 2) {
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys: S tiles 2kk and 2kk + 1
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, Vt + (kk * 16 + (j & 1) * 8 + r) * kRow +
                               (2 * dp + (j >> 1)) * 8);
        mma_bf16(o[2 * dp], pa, bfr[0], bfr[1]);
        mma_bf16(o[2 * dp + 1], pa, bfr[2], bfr[3]);
      }
    }
  } else {
    const int g = lane >> 2, t4 = lane & 3;
    const float* Vf = reinterpret_cast<const float*>(Vt);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // 8 keys, in the order 0,2,4,6,1,...
      uint32_t ph[4], pl[4];
      split_tf32(s[kk][0], ph[0], pl[0]);  // row g,     key 2t
      split_tf32(s[kk][2], ph[1], pl[1]);  // row g + 8, key 2t
      split_tf32(s[kk][1], ph[2], pl[2]);  // row g,     key 2t + 1
      split_tf32(s[kk][3], ph[3], pl[3]);  // row g + 8, key 2t + 1
      const float* v0 = Vf + (kk * 8 + 2 * t4) * kRow + g;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[n * 8], bh0, bl0);         // key 2t
        split_tf32(v0[kRow + n * 8], bh1, bl1);  // key 2t + 1
        mma_3xtf32(o[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// l_r summed over the lane quad and inverted (a row with no live key, l =
// 0, divides by 1 and gives exactly 0)
__device__ __forceinline__ void row_inverse(float (&l_r)[2],
                                            float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / (l_r[i] == 0.f ? 1.f : l_r[i]);
  }
}

// this thread's output of rows r_lo and r_lo + 8 (those below Sq), o * inv
template <typename T, int ND>
__device__ __forceinline__ void write_out(T* out, const float (&o)[ND][4],
                                          const float (&inv)[2], int b,
                                          int h, int H, int Sq, int D,
                                          int r_lo, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= Sq) continue;
    T* orow = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t4 + e;
        if (d < D) orow[d] = from_f32<T>(o[n][2 * i + e] * inv[i]);
      }
  }
}

// whether key tile t needs the per-key mask: some key may be invalid, or in
// the causal future of a query of the tile starting at q0
__device__ __forceinline__ bool tile_masked(const uint32_t* full_bits, int t,
                                            int q0, int causal) {
  return (causal && t * kBK + kBK - 1 > q0) ||
         !((__ldg(full_bits + (t >> 5)) >> (t & 31)) & 1u);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ valid,
                     T* __restrict__ out, int H, int BH, int Sq, int Skv,
                     int D, Strides qs, Strides ks, Strides vs, int causal,
                     float scale, int vec, Tiles tiles, Split split) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRow = row_elems<T, DP>();
  constexpr int kND = DP / 8;  // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBK * kRow;  // [2] tiles
  T* Vs = Ks + 2 * kBK * kRow;
  float* Val = reinterpret_cast<float*>(Vs + 2 * kBK * kRow);  // [2][kBK]

  // the last query tiles have the most live key tiles under the causal
  // mask: they start first (grid x: query tiles from the last, then heads)
  const int qt = gridDim.x / BH - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group and thread in group

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* valb = valid == nullptr ? nullptr : valid + (long long)b * Skv;

  // the query tile's live key tiles below its causal limit, and this
  // block's chunk of them: ranks [chunk * C, chunk * C + todo). The last
  // chunks start first (a left-padded window's live keys are there).
  const uint32_t* live_bits = tiles.live + (long long)b * tiles.words;
  const uint32_t* full_bits = tiles.full + (long long)b * tiles.words;
  const int n_kv = q_tile_kv(qt, Sq, Skv, causal);
  const int n_live = count_live(live_bits, n_kv);
  const int chunks = q_tile_chunks(n_live, split);
  const int chunk = gridDim.z - 1 - blockIdx.z;
  if (chunk >= chunks) return;  // past this query tile's live tiles
  const bool partial = chunks > 1;
  int todo = partial ? min(split.chunk, n_live - chunk * split.chunk)
                     : n_live;

  // with no live tile the scan below is empty: the rows give exactly 0, and
  // no products run
  int t = partial ? nth_live(live_bits, chunk * split.chunk, n_kv)
                  : next_live(live_bits, 0, n_kv);
  const bool vec_ok = vec != 0;
  if (todo > 0) {
    load_tile<T, DP>(Qs, qb, qs.s, q0, Sq, D, vec_ok);
    load_tile<T, DP>(Ks, kb, ks.s, t * kBK, Skv, D, vec_ok);
    load_tile<T, DP>(Vs, vb, vs.s, t * kBK, Skv, D, vec_ok);
    load_valid(Val, valb, t * kBK, Skv);
    cp_async_commit();
  }

  // f32 state of rows g and g + 8 of this warp's 16
  float m_r[2] = {kMaskValue, kMaskValue};
  float l_r[2] = {0.f, 0.f};  // this thread's part of the row sums
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // Q fragments (A operands), loaded from Qs once the first group lands
  constexpr int kQF = kBf16 ? DP / 16 : DP / 8;
  uint32_t qa[kBf16 ? kQF : 1][4];  // bf16: m16n8k16 A fragments
  float qf[kBf16 ? 1 : kQF][4];     // f32: scaled q, split per use
  // bf16 scores are scaled here; f32 q is scaled on load
  const float s_mul = kBf16 ? scale * kLog2e : kLog2e;
  const int r_lo = q0 + warp * 16 + g;  // query rows of c0/c1 and c2/c3

  int buf = 0;
  bool first = true;
  while (todo > 0) {
    const int tn = todo > 1 ? next_live(live_bits, t + 1, n_kv) : n_kv;
    if (tn < n_kv) {
      const int nb = buf ^ 1;
      load_tile<T, DP>(Ks + nb * kBK * kRow, kb, ks.s, tn * kBK, Skv, D,
                       vec_ok);
      load_tile<T, DP>(Vs + nb * kBK * kRow, vb, vs.s, tn * kBK, Skv, D,
                       vec_ok);
      load_valid(Val + nb * kBK, valb, tn * kBK, Skv);
    }
    cp_async_commit();  // an empty group past the last tile
    cp_async_wait_1();  // tile t (and Q) landed
    __syncthreads();

    if (first) {
      first = false;
      const T* qw = Qs + warp * 16 * kRow;
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kQF; ++kk) {
          const int j = lane >> 3, r = lane & 7;
          ldsm_x4(qa[kk],
                  qw + ((j & 1) * 8 + r) * kRow + kk * 16 + (j >> 1) * 8);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kQF; ++kk) {
          const float* q0p = reinterpret_cast<const float*>(qw);
          qf[kk][0] = q0p[g * kRow + kk * 8 + t4] * scale;
          qf[kk][1] = q0p[(g + 8) * kRow + kk * 8 + t4] * scale;
          qf[kk][2] = q0p[g * kRow + kk * 8 + t4 + 4] * scale;
          qf[kk][3] = q0p[(g + 8) * kRow + kk * 8 + t4 + 4] * scale;
        }
      }
    }

    float s[8][4];
    qk_tile<T, DP>(s, Ks + buf * kBK * kRow, lane, [&](int kk, auto& a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kBf16)
          a[e] = qa[kk][e];
        else
          a[e] = qf[kk][e];
      }
    });
    softmax_tile<kND>(s, m_r, l_r, o,
                      tile_masked(full_bits, t, q0, causal), Val + buf * kBK,
                      causal, r_lo, t * kBK, s_mul, t4);
    pv_tile<T, DP>(o, s, Vs + buf * kBK * kRow, lane);

    __syncthreads();  // tile t's buffers are free for the copy of tile t + 2
    t = tn;
    buf ^= 1;
    --todo;
  }

  float inv[2];
  row_inverse(l_r, inv);
  if (partial) {
    const long long base = ((long long)chunk * BH + bh) * Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 8 * i;
      if (row >= Sq) continue;
      if (t4 == 0) {
        split.m[base + row] = m_r[i];
        split.l[base + row] = l_r[i];
      }
      float* orow = split.o + (base + row) * D;
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + 2 * t4 + e;
          if (d < D) orow[d] = o[n][2 * i + e];
        }
    }
    return;
  }
  write_out<T, kND>(out, o, inv, b, h, H, Sq, D, r_lo, t4);
}

// Heads of kMaxHead + 1 .. kMaxWide: the layout of flash_fwd_kernel (4
// warps of 16 query rows, each warp all DP output columns, so QK^T runs
// once per tile), whose O accumulator is now DP / 2 registers a thread
// (128 at DP 256). Q's fragments no longer fit beside it, so Q stays in
// shared memory (f32: scaled in place once, by each warp for its rows) and
// is read per k step (ldmatrix in bf16, and split at that load in f32). K
// and V have one buffer each, filled in separate cp.async groups, as
// FlashAttention-2 does: tile t + 1's K copy is issued once every warp has
// read tile t's K and lands during tile t's softmax and PV, its V copy
// once PV(t) is done and lands during QK^T(t + 1); shared memory Q, K, V:
// 3 x 64 padded rows, 99.5 KB in bf16 at DP 256 (two blocks an SM), 195 KB
// in f32. The tile skip, masks, softmax and products are flash_fwd_kernel's;
// no key tiles are cut into chunks (one block per (query tile, head) is
// 256 blocks at the engine's window of 8,192 and two heads).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ valid, T* __restrict__ out,
                      int H, int BH, int Sq, int Skv, int D, Strides qs,
                      Strides ks, Strides vs, int causal, float scale,
                      int vec, Tiles tiles) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRow = row_elems<T, DP>();
  constexpr int kND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBK * kRow;
  T* Vs = Ks + kBK * kRow;
  float* Val = reinterpret_cast<float*>(Vs + kBK * kRow);  // [2][kBK]

  const int qt = gridDim.x / BH - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* valb = valid == nullptr ? nullptr : valid + (long long)b * Skv;
  const uint32_t* live_bits = tiles.live + (long long)b * tiles.words;
  const uint32_t* full_bits = tiles.full + (long long)b * tiles.words;
  const int n_kv = q_tile_kv(qt, Sq, Skv, causal);
  int todo = count_live(live_bits, n_kv);
  int t = next_live(live_bits, 0, n_kv);
  const bool vec_ok = vec != 0;
  if (todo > 0) {
    load_tile<T, DP>(Qs, qb, qs.s, q0, Sq, D, vec_ok);
    load_tile<T, DP>(Ks, kb, ks.s, t * kBK, Skv, D, vec_ok);
    load_valid(Val, valb, t * kBK, Skv);
    cp_async_commit();
    load_tile<T, DP>(Vs, vb, vs.s, t * kBK, Skv, D, vec_ok);
    cp_async_commit();
  }

  float m_r[2] = {kMaskValue, kMaskValue};
  float l_r[2] = {0.f, 0.f};
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float s_mul = kBf16 ? scale * kLog2e : kLog2e;
  const int r_lo = q0 + warp * 16 + g;
  T* qw = Qs + warp * 16 * kRow;  // this warp's 16 rows of Q

  int buf = 0;
  bool first = true;
  while (todo > 0) {
    cp_async_wait_1();  // K(t), its validity (and Q) landed; V(t) may not
    __syncthreads();
    if (first) {
      first = false;
      if constexpr (!kBf16) {  // f32 q scaled on load, each warp its rows
        float* qf = reinterpret_cast<float*>(qw);
        for (int e = lane; e < 16 * DP; e += 32)
          qf[(e / DP) * kRow + e % DP] *= scale;
        __syncwarp();
      }
    }
    float s[8][4];
    qk_tile<T, DP>(s, Ks, lane, [&](int kk, auto& a) {
      if constexpr (kBf16) {
        const int j = lane >> 3, r = lane & 7;
        ldsm_x4(a, qw + ((j & 1) * 8 + r) * kRow + kk * 16 + (j >> 1) * 8);
      } else {
        const float* qp = reinterpret_cast<const float*>(qw);
        a[0] = qp[g * kRow + kk * 8 + t4];
        a[1] = qp[(g + 8) * kRow + kk * 8 + t4];
        a[2] = qp[g * kRow + kk * 8 + t4 + 4];
        a[3] = qp[(g + 8) * kRow + kk * 8 + t4 + 4];
      }
    });
    __syncthreads();  // every warp has read K(t): K(t + 1) may come in
    const int tn = todo > 1 ? next_live(live_bits, t + 1, n_kv) : n_kv;
    if (tn < n_kv) {
      load_tile<T, DP>(Ks, kb, ks.s, tn * kBK, Skv, D, vec_ok);
      load_valid(Val + (buf ^ 1) * kBK, valb, tn * kBK, Skv);
    }
    cp_async_commit();  // an empty group past the last tile
    softmax_tile<kND>(s, m_r, l_r, o,
                      tile_masked(full_bits, t, q0, causal), Val + buf * kBK,
                      causal, r_lo, t * kBK, s_mul, t4);
    cp_async_wait_1();  // V(t) landed; K(t + 1) may not
    __syncthreads();
    pv_tile<T, DP>(o, s, Vs, lane);
    __syncthreads();  // every warp has read V(t): V(t + 1) may come in
    if (tn < n_kv) load_tile<T, DP>(Vs, vb, vs.s, tn * kBK, Skv, D, vec_ok);
    cp_async_commit();
    t = tn;
    buf ^= 1;
    --todo;
  }
  float inv[2];
  row_inverse(l_r, inv);
  write_out<T, kND>(out, o, inv, b, h, H, Sq, D, r_lo, t4);
}

// out = sum_c o_c 2^(m_c - M) / sum_c l_c 2^(m_c - M), M = max_c m_c, over
// the chunks c of query rows whose live tiles were split, one warp a row; a
// chunk where the row has no live key has l_c = 0 and o_c = 0 and is
// skipped, and a row with none in any chunk gives exactly 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_combine_kernel(T* __restrict__ out, int H, int BH, int Sq, int Skv,
                         int D, int causal, Tiles tiles, Split split) {
  const int row_blocks = (Sq + kWarps - 1) / kWarps;
  const int bh = blockIdx.x / row_blocks;
  const int row = (blockIdx.x - bh * row_blocks) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= Sq) return;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int chunks = q_tile_chunks(
      count_live(tiles.live + (long long)b * tiles.words,
                 q_tile_kv(row / kBQ, Sq, Skv, causal)),
      split);
  if (chunks <= 1) return;  // written by its one block
  const long long stride = (long long)BH * Sq;  // between chunks
  const long long r0 = (long long)bh * Sq + row;
  float mx = kMaskValue;
  for (int c = lane; c < chunks; c += 32)
    mx = fmaxf(mx, split.m[c * stride + r0]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float l = 0.f;
  for (int c = lane; c < chunks; c += 32)
    l += split.l[c * stride + r0] * ex2(split.m[c * stride + r0] - mx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* orow = out + (((long long)b * Sq + row) * H + h) * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (split.l[c * stride + r0] == 0.f) continue;  // o_c is 0
      acc += split.o[(c * stride + r0) * D + d] *
             ex2(split.m[c * stride + r0] - mx);
    }
    orow[d] = from_f32<T>(acc * inv);
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// shared memory of flash_dtiled_kernel: a chunk of Q [kWQ][kWC] and of K
// [kBK][kWC + 1] (the odd stride puts a warp's 8 keys on distinct banks),
// V's output columns [kBK][kWV], P [kWQ][kBK] and the keys' validity
constexpr size_t dtiled_smem_bytes() {
  return sizeof(float) *
         (kWQ * kWC + kBK * (kWC + 1) + kBK * kWV + kWQ * kBK + kBK);
}

// Heads wider than kMaxWide, whose O accumulator would not fit in
// registers: block (query tile of kWQ rows, batch*head, output columns
// [dv0, dv0 + kWV)) on grid x, query tiles from the last.
// Thread (row, j) of the 16 x 8 holds keys j, j + 8, .. of the row's scores
// and output columns j, j + 8, ..; a row's max and sum are taken over its 8
// threads. f32 throughout (bf16 inputs widened, exact products).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dtiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ valid, T* __restrict__ out,
                        int H, int BH, int Sq, int Skv, int D, Strides qs,
                        Strides ks, Strides vs, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qc = reinterpret_cast<float*>(smem);  // [kWQ][kWC]
  float* Kc = Qc + kWQ * kWC;                   // [kBK][kWC + 1]
  float* Vs = Kc + kBK * (kWC + 1);             // [kBK][kWV]
  float* Ps = Vs + kBK * kWV;                   // [kWQ][kBK]
  float* Val = Ps + kWQ * kBK;                  // [kBK]
  constexpr int kKeys = kBK / 8, kCols = kWV / 8;  // per thread

  const int nv = (D + kWV - 1) / kWV, nq = (Sq + kWQ - 1) / kWQ;
  long long x = blockIdx.x;
  const int dv = (int)(x % nv);
  x /= nv;
  const int bh = (int)(x % BH);
  const int qt = nq - 1 - (int)(x / BH);
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = qt * kWQ, dv0 = dv * kWV;
  const int tid = threadIdx.x, row = tid >> 3, j = tid & 7;
  const int qr = q0 + row;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* valb = valid == nullptr ? nullptr : valid + (long long)b * Skv;
  const float s_mul = scale * kLog2e;

  int n_kv = (Skv + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kWQ, Sq) - 1) / kBK + 1);
  float m_r = kMaskValue, l_r = 0.f;  // l_r: this thread's keys' part
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBK;
    if (tid < kBK)
      Val[tid] = k0 + tid >= Skv ? 0.f : valb == nullptr ? 1.f : valb[k0 + tid];
    float s[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) s[u] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kWC) {
      __syncthreads();  // the chunks are free
      for (int e = tid; e < kWQ * kWC; e += kThreads) {
        const int r = e / kWC, c = c0 + e % kWC;
        Qc[e] = (q0 + r < Sq && c < D)
                    ? to_f32<T>(qb[(long long)(q0 + r) * qs.s + c])
                    : 0.f;
      }
      for (int e = tid; e < kBK * kWC; e += kThreads) {
        const int r = e / kWC, c = e % kWC;
        Kc[r * (kWC + 1) + c] =
            (k0 + r < Skv && c0 + c < D)
                ? to_f32<T>(kb[(long long)(k0 + r) * ks.s + c0 + c])
                : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < kWC; ++c) {
        const float qv = Qc[row * kWC + c];
#pragma unroll
        for (int u = 0; u < kKeys; ++u)
          s[u] = fmaf(qv, Kc[(j + 8 * u) * (kWC + 1) + c], s[u]);
      }
    }
    for (int e = tid; e < kBK * kWV; e += kThreads) {
      const int r = e / kWV, c = dv0 + e % kWV;
      Vs[e] = (k0 + r < Skv && c < D)
                  ? to_f32<T>(vb[(long long)(k0 + r) * vs.s + c])
                  : 0.f;
    }
    // mask, then the online softmax (log2 units)
    float mx = kMaskValue;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int key = j + 8 * u;
      const bool live = Val[key] > 0.f && (!causal || qr >= k0 + key);
      s[u] = live ? s[u] * s_mul : kMaskValue;
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_r, mx);
    const float corr = ex2(m_r - m_new);  // 0 after a fully masked start
    m_r = m_new;
    l_r *= corr;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const float p = s[u] == kMaskValue ? 0.f : ex2(s[u] - m_r);
      Ps[row * kBK + j + 8 * u] = p;
      l_r += p;
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[i] *= corr;
    __syncthreads();  // V and P are in
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = Ps[row * kBK + kk];
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        o[i] = fmaf(p, Vs[kk * kWV + j + 8 * i], o[i]);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    l_r += __shfl_xor_sync(0xffffffffu, l_r, off);
  const float inv = 1.f / (l_r == 0.f ? 1.f : l_r);  // fully masked row -> 0
  if (qr >= Sq) return;
  T* orow = out + (((long long)b * Sq + qr) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = dv0 + j + 8 * i;
    if (c < D) orow[c] = from_f32<T>(o[i] * inv);
  }
}

// how the key tiles are cut: chunks of kSplitTiles live tiles when the
// query tiles and heads give fewer blocks than 4 per SM (the kernel's
// occupancy at the engine's head width), else no cut; heads wider than
// kMaxHead are never cut (flash_wide_kernel)
Split split_plan(int B, int H, int Sq, int Skv, int D) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const long long blocks = (long long)((Sq + kBQ - 1) / kBQ) * B * H;
  const int n_kv = (Skv + kBK - 1) / kBK;
  Split sp{1, n_kv, nullptr, nullptr, nullptr};
  if (D <= kMaxHead && blocks < 4LL * sms && n_kv > kSplitTiles) {
    sp.n = (n_kv + kSplitTiles - 1) / kSplitTiles;
    sp.chunk = kSplitTiles;
  }
  return sp;
}

// the workspace: the tile bitmasks (16-byte aligned), then the partials
size_t tiles_bytes(int B, int Skv) {
  const size_t words = ((size_t)(Skv + kBK - 1) / kBK + 31) / 32;
  return (2 * sizeof(uint32_t) * B * words + 15) / 16 * 16;
}

size_t workspace_bytes(int B, int H, int Sq, int Skv, int D) {
  if (D > kMaxWide) return 0;  // flash_dtiled_kernel takes none
  const Split sp = split_plan(B, H, Sq, Skv, D);
  const size_t partials =
      sp.n <= 1 ? 0 : sizeof(float) * (size_t)sp.n * B * H * Sq * (D + 2);
  return tiles_bytes(B, Skv) + partials;
}

// dynamic shared memory of the attention kernel at padded head width DP
template <typename T, int DP>
constexpr size_t smem_bytes() {
  return DP > kMaxHead ? 3 * tile_bytes<T, DP>() + 2 * kBK * sizeof(float)
                       : fixed_smem_bytes<T, DP>();
}

// the tile bitmasks, then the attention kernel at padded head width DP
// (flash_fwd_kernel, or flash_wide_kernel above kMaxHead), then, where key
// tiles were cut, flash_combine_kernel
template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const float* valid,
           void* out, int B, int H, int Sq, int Skv, int D, Strides qs,
           Strides ks, Strides vs, int causal, float scale, int vec,
           void* workspace, cudaStream_t stream) {
  constexpr bool kWide = DP > kMaxHead;
  if (workspace == nullptr && workspace_bytes(B, H, Sq, Skv, D) > 0)
    return (int)cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  Tiles tiles{nullptr, nullptr, ((Skv + kBK - 1) / kBK + 31) / 32};
  if (tiles.words > 0) {
    tiles.live = reinterpret_cast<uint32_t*>(ws);
    tiles.full = tiles.live + (size_t)B * tiles.words;
  }
  Split sp = split_plan(B, H, Sq, Skv, D);
  if (sp.n > 1) {
    const size_t rows = (size_t)sp.n * B * H * Sq;
    sp.o = reinterpret_cast<float*>(ws + tiles_bytes(B, Skv));
    sp.m = sp.o + rows * D;
    sp.l = sp.m + rows;
  }
  const int smem = (int)smem_bytes<T, DP>();
  static bool smem_set[kMaxDevices] = {};  // attribute set, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    if constexpr (kWide)
      err = cudaFuncSetAttribute(flash_wide_kernel<T, DP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    else
      err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  if (tiles.words > 0) {
    flash_tiles_kernel<<<(unsigned)((long long)tiles.words * B), kThreads, 0,
                         stream>>>(valid, Skv, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int BH = B * H;
  const long long nq = (Sq + kBQ - 1) / kBQ;
  if constexpr (kWide) {
    flash_wide_kernel<T, DP><<<(unsigned)(nq * BH), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), valid, static_cast<T*>(out), H, BH, Sq, Skv,
        D, qs, ks, vs, causal, scale, vec, tiles);
    return (int)cudaGetLastError();
  } else {
    flash_fwd_kernel<T, DP>
        <<<dim3((unsigned)(nq * BH), 1, (unsigned)sp.n), kThreads, smem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), valid, static_cast<T*>(out),
                     H, BH, Sq, Skv, D, qs, ks, vs, causal, scale, vec, tiles,
                     sp);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.n <= 1) return (int)err;
    flash_combine_kernel<T>
        <<<(unsigned)((long long)((Sq + kWarps - 1) / kWarps) * BH),
           kThreads, 0, stream>>>(static_cast<T*>(out), H, BH, Sq, Skv, D,
                                  causal, tiles, sp);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_dtiled(const void* q, const void* k, const void* v,
                  const float* valid, void* out, int B, int H, int Sq,
                  int Skv, int D, Strides qs, Strides ks, Strides vs,
                  int causal, float scale, cudaStream_t stream) {
  const size_t smem = dtiled_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dtiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + kWQ - 1) / kWQ) * B * H *
                           ((D + kWV - 1) / kWV);
  flash_dtiled_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), H, B * H, Sq,
      Skv, D, qs, ks, vs, causal, scale);
  return (int)cudaGetLastError();
}

// the padded head width of D: 16, 32, 64 or 128, then a multiple of 32 up
// to kMaxWide; 0 above (flash_dtiled_kernel)
constexpr int head_pad(int D) {
  return D <= 16 ? 16
         : D <= 32 ? 32
         : D <= 64 ? 64
         : D <= kMaxHead ? kMaxHead
         : D <= kMaxWide ? (D + 31) / 32 * 32
                         : 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* valid,
             void* out, int B, int H, int Sq, int Skv, int D, Strides qs,
             Strides ks, Strides vs, int causal, float scale, void* workspace,
             cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows: pointers, strides and D
  constexpr long long kPer = 16 / sizeof(T);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = al(q) && al(k) && al(v) && D % kPer == 0 &&
                  qs.b % kPer == 0 && qs.s % kPer == 0 && qs.h % kPer == 0 &&
                  ks.b % kPer == 0 && ks.s % kPer == 0 && ks.h % kPer == 0 &&
                  vs.b % kPer == 0 && vs.s % kPer == 0 && vs.h % kPer == 0;
#define PIO_FLASH_LAUNCH(DP)                                                  \
  case DP:                                                                    \
    return launch<T, DP>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,  \
                         causal, scale, vec, workspace, stream);
  switch (head_pad(D)) {
    PIO_FLASH_LAUNCH(16)
    PIO_FLASH_LAUNCH(32)
    PIO_FLASH_LAUNCH(64)
    PIO_FLASH_LAUNCH(128)
    PIO_FLASH_LAUNCH(160)
    PIO_FLASH_LAUNCH(192)
    PIO_FLASH_LAUNCH(224)
    PIO_FLASH_LAUNCH(256)
    default:
      return launch_dtiled<T>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks,
                              vs, causal, scale, stream);
  }
#undef PIO_FLASH_LAUNCH
}

// any B * H and D whose grid fits grid x (2^31 - 1 blocks)
bool bad_shape(int B, int H, int Sq, int Skv, int D) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv < 0 || D <= 0) return true;
  const long long bh = (long long)B * H;
  const long long blocks =
      D <= kMaxWide ? (long long)((Sq + kBQ - 1) / kBQ) * bh
                    : (long long)((Sq + kWQ - 1) / kWQ) * bh *
                          ((D + kWV - 1) / kWV);
  return bh > 0x7fffffffLL || blocks > 0x7fffffffLL;
}

template <typename T>
size_t dtype_smem_bytes(int D) {
  switch (head_pad(D)) {
    case 16: return smem_bytes<T, 16>();
    case 32: return smem_bytes<T, 32>();
    case 64: return smem_bytes<T, 64>();
    case 128: return smem_bytes<T, 128>();
    case 160: return smem_bytes<T, 160>();
    case 192: return smem_bytes<T, 192>();
    case 224: return smem_bytes<T, 224>();
    case 256: return smem_bytes<T, 256>();
    default: return dtiled_smem_bytes();
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of one attention block at head width D (the
// build report's complement: ptxas prints only static shared memory)
size_t pio_flash_smem_bytes(int D, int dtype) {
  if (D <= 0 || (dtype != 0 && dtype != 1)) return 0;
  return dtype == 1 ? dtype_smem_bytes<__nv_bfloat16>(D)
                    : dtype_smem_bytes<float>(D);
}

// scratch the call with these sizes needs (the tile bitmasks, and f32
// partials when the key tiles are cut), on the current device; the caller
// allocates it and passes it as `workspace`
size_t pio_flash_workspace_bytes(int B, int H, int Sq, int Skv, int D) {
  if (bad_shape(B, H, Sq, Skv, D)) return 0;
  return workspace_bytes(B, H, Sq, Skv, D);
}

// q, k, v: BSHD with head_dim stride 1 and the given (batch, seq, head)
// element strides; valid [B, Skv] f32 contiguous (nullptr: every key valid);
// out [B, Sq, H, D] contiguous. dtype 0 = f32, 1 = bf16 (q, k, v and out).
// workspace: pio_flash_workspace_bytes() bytes, 16-byte aligned (nullptr
// when that is 0); its contents need no initialisation.
int pio_flash_attention(const void* q, const void* k, const void* v,
                        const float* valid, void* out, int B, int H, int Sq,
                        int Skv, int D, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int causal, float scale, int dtype,
                        void* workspace, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  if (dtype == 0)
    return dispatch<float>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,
                           causal, scale, workspace, st);
  return dispatch<__nv_bfloat16>(q, k, v, valid, out, B, H, Sq, Skv, D, qs,
                                 ks, vs, causal, scale, workspace, st);
}

}  // extern "C"
