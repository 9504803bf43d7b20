// Exhaustive score + mask + top-k for recommendation serving, for Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_predictionio_tpu/ops/pallas_kernels.py
// score_and_top_k_pallas (:317) -> _score_topk_pallas (:230, pallas_call :259)
// -> _topk_tile_kernel (:186). Same contract:
//   * scores q . item in full f32, one fmaf per rank element in a fixed order
//     (the TPU kernel pins Precision.HIGHEST: no TF32, no bf16);
//   * a disallowed item scores -3.4e38;
//   * top-k per query row, descending, ties to the lowest item id;
//   * a slot past the allowed count gets score -3.4e38 and id -1.
//   * k <= 128, any K, B <= 65,535 * 8.
//
// What bounds it on this card: the item table read (I*K*4 bytes at
// 3.35 TB/s). An f32-accurate product can run as 3xTF32 on the tensor cores
// at 495/3 TFLOP/s, so even at 64 queries and rank 128 the products
// (2*B*I*K) take less time than the bytes; this kernel runs them on the f32
// FMA units (67 TFLOP/s), where at B 64 they come level with the bytes.
// The [B, I] score matrix never reaches device memory, as on the TPU.
//
// Design.
// Pass 1 (tile_topk_kernel): a grid of (item blocks) x (row groups of 8
//   query rows; at B <= 8 one group of exactly B rows, the row count a
//   template parameter, so no dead row is scored). The item blocks are few
//   enough that about two blocks per SM fill the card in one wave (the
//   launch plan, ops/kernels.topk_plan, is computed in Python and checked
//   here); each walks a contiguous range of kTile-item tiles. A tile comes
//   into shared memory in 32-column chunks by cp.async (16-byte copies,
//   eight threads reading one item's 128 contiguous bytes), double-buffered,
//   so the next chunk is in flight while this one is scored. Thread t
//   scores item t of the tile for every row of the group from shared memory
//   (rows padded by 16 bytes: conflict-free float4 reads), q broadcast from
//   shared memory: staged whole up to rank kMaxStagedRank, above it (the
//   TPU kernel pads any rank to 128 lanes) one 32-column chunk of the 8
//   rows at a time, copied with the items' chunk into the same stage.
//   Selection by threshold: each (block, row) keeps candidate keys in a
//   shared buffer of kBuf; a key packs (score, id) into 64 bits ordered as
//   (score desc, id asc), so one integer comparison is the whole order.
//   Its threshold is the key just below its k-th best so far: a tile's keys
//   below the k-th best key are dropped by one comparison (an equal score
//   with a lower id still passes), the rest appended (warp ballot + one
//   atomic).
//   A row is pruned to its best k (prune: a radix select, no sort) as soon
//   as it first holds k keys, which sets its threshold after one tile, and
//   again whenever its buffer might not take another tile; after the first
//   tiles almost nothing passes, so the block streams. At the end each row
//   is pruned to k once more and only those k are sorted (bitonic, in
//   shared memory) and written out.
// Pass 2 (merge_topk_kernel): one block per query row merges its L sorted
//   lists of k keys. When the L * k keys exceed half the merge buffer, the
//   k-th best of the first ceil(k / L) keys of each list is found first (a
//   radix select of those L * ceil(k / L) >= k keys): a lower bound of the
//   row's k-th best key, which starts the threshold. Then every list is
//   streamed in batches (eight keys in flight per thread) through the same
//   threshold-and-prune selection as pass 1; the final k are sorted, and
//   fillers turn into (-3.4e38, -1) there.
// Disallowed items never enter a buffer: a slot that would hold one is a
// filler in the output either way.
//
// Plain C interface, bound from Python with ctypes; launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kTile = 256;               // items per tile: one per thread
constexpr int kChunk = 32;               // rank columns per pipeline stage
constexpr int kRowStride = kChunk + 4;   // padded shared row, in floats
constexpr int kStages = 2;               // pipeline stages (chunk buffers)
constexpr int kMaxRows = 8;              // query rows per block
constexpr int kBlocksPerSm = 2;          // pass-1 blocks resident per SM
constexpr int kBuf = 512;                // candidate keys per (block, row)
constexpr int kMaxStagedRank = 256;     // q staged whole up to this rank
constexpr int kMaxK = 128;
constexpr int kMergeBuf = 4096;          // keys gathered per row in pass 2
constexpr int kMaxLists = kMergeBuf - kMaxK;
constexpr float kNegInf = -3.4e38f;      // disallowed score (pallas_kernels.py:52)

static_assert(kThreads == kTile, "one item per thread");

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

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (score, id) as one key: larger key = higher score, then lower id. The
// score's bits are mapped to an order-preserving unsigned integer (-0 is
// taken as +0 first); the low word is ~id. Key 0 is below every real one
// and marks an empty slot.
__device__ __forceinline__ u64 make_key(float s, int id) {
  uint32_t u = __float_as_uint(s + 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | (0xffffffffu - static_cast<uint32_t>(id));
}

__device__ __forceinline__ float key_score(u64 key) {
  uint32_t u = static_cast<uint32_t>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_id(u64 key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// Sorts nseg segments of n keys each (n a power of two; segment s starts at
// buf + s * stride) into descending order; the whole block, which it syncs.
__device__ void bitonic_desc(u64* buf, int nseg, int stride, int n) {
  const int half = n >> 1, lg = __ffs(half) - 1;  // n: a power of two
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int e = threadIdx.x; e < nseg * half; e += blockDim.x) {
        const int seg = e >> lg, i = e & (half - 1);
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        u64* b = buf + seg * stride;
        const u64 x = b[lo], y = b[lo + j];
        if (((lo & size) == 0) ? (x < y) : (x > y)) {
          b[lo] = y;
          b[lo + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Appends `key` to cnt/buf where keep is set: one atomic per warp. Every
// lane of the warp calls it.
__device__ __forceinline__ void append(bool keep, u64 key, int* cnt, u64* buf,
                                       int cap) {
  const unsigned lanes = __ballot_sync(0xffffffffu, keep);
  if (lanes == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(lanes) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(lanes));
  base = __shfl_sync(0xffffffffu, base, leader);
  const int pos = base + __popc(lanes & ((1u << lane) - 1u));
  if (keep && pos < cap) buf[pos] = key;
}

// Per-row state of a radix select (shared memory).
struct Sel {
  u64 prefix;  // the key bits fixed so far (bits >= shift + width)
  u64 T;       // the result: exactly k keys are >= T
  int shift;   // this pass's digit is bits [shift, shift + width)
  int width;
  int need;    // rank of the k-th key among the keys matching prefix
  int active;
};

// Keeps the best k keys of each of the first `rows` buffers (cnt[r] keys
// at buf + r * stride) and, once a row holds k keys, raises thr[r] to T - 1,
// where exactly k kept keys are >= T. A radix select, not a sort: the first digit starts at the highest
// bit in which the row's keys differ (one warp per row finds it), each pass
// histograms one digit of the keys still in play into hist ([rows][256],
// shared) and one warp per row finds the bin that holds the k-th key, until
// that bin holds no more keys than are still needed. Rows with at most k
// keys are left alone. Block-wide, rows <= the block's warps; syncs.
__device__ void prune(u64* buf, int stride, int* cnt, u64* thr, int rows,
                      int k, unsigned* hist, Sel* sel) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp < rows) {
    const int n = cnt[warp];
    u64 lo = ~0ull, hi = 0ull;
    for (int i = lane; i < n; i += 32) {
      const u64 x = buf[warp * stride + i];
      lo = x < lo ? x : lo;
      hi = x > hi ? x : hi;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 l2 = __shfl_xor_sync(0xffffffffu, lo, o);
      const u64 h2 = __shfl_xor_sync(0xffffffffu, hi, o);
      lo = l2 < lo ? l2 : lo;
      hi = h2 > hi ? h2 : hi;
    }
    if (lane == 0) {
      Sel q;
      q.active = n > k;  // then n >= 2 distinct keys: lo != hi
      q.need = k;
      q.T = 0;
      q.shift = 0;
      q.width = 1;
      q.prefix = 0;
      if (n == k) q.T = lo;  // all of them: the threshold is the k-th
      if (q.active) {
        const int top = 63 - __clzll(static_cast<long long>(lo ^ hi));
        q.shift = max(0, top - 7);
        q.width = top + 1 - q.shift;
        q.prefix = top >= 63 ? 0ull : (hi >> (top + 1)) << (top + 1);
      }
      sel[warp] = q;
    }
  }
  __syncthreads();
  for (;;) {
    bool any = false;
    for (int r = 0; r < rows; ++r) any |= sel[r].active != 0;
    if (!any) break;
    for (int e = tid; e < rows * 256; e += kThreads) hist[e] = 0;
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const Sel q = sel[r];
      if (!q.active) continue;
      const int hs = q.shift + q.width;
      const u64 hmask = hs >= 64 ? 0ull : (~0ull << hs);
      const unsigned dmask = (1u << q.width) - 1u;
      for (int i = tid; i < cnt[r]; i += kThreads) {
        const u64 x = buf[r * stride + i];
        if ((x & hmask) == q.prefix)
          atomicAdd(&hist[r * 256 + (static_cast<unsigned>(x >> q.shift) & dmask)], 1u);
      }
    }
    __syncthreads();
    if (warp < rows && sel[warp].active) {
      Sel q = sel[warp];
      const unsigned* h = hist + warp * 256;
      // lane l holds bins [8l, 8l + 8); above = keys in higher lanes' bins
      unsigned c[8], mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = h[lane * 8 + j];
        mine += c[j];
      }
      unsigned suffix = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_down_sync(0xffffffffu, suffix, o);
        if (lane + o < 32) suffix += t;
      }
      unsigned above = suffix - mine;
      const unsigned need = static_cast<unsigned>(q.need);
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (above < need && need <= above + c[j]) {  // one lane, one bin
          const u64 tb = q.prefix | (static_cast<u64>(lane * 8 + j) << q.shift);
          q.need = static_cast<int>(need - above);
          if (c[j] == need - above || q.shift == 0) {
            q.T = tb;
            q.active = 0;
          } else {
            const int ns = max(0, q.shift - 8);
            q.prefix = tb;
            q.width = q.shift - ns;
            q.shift = ns;
          }
          sel[warp] = q;
        }
        above += c[j];
      }
    }
    __syncthreads();
  }
  // keep the keys >= T of each pruned row (exactly k): warp r compacts row
  // r in place, 32 keys at a time (a kept key only ever moves down)
  if (warp < rows && sel[warp].T != 0) {
    const u64 t = sel[warp].T;
    u64* b = buf + warp * stride;
    const int n = cnt[warp];
    int out = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const u64 x = i < n ? b[i] : 0ull;
      const bool keep = i < n && x >= t;
      const unsigned lanes = __ballot_sync(0xffffffffu, keep);
      if (keep) b[out + __popc(lanes & ((1u << lane) - 1u))] = x;
      out += __popc(lanes);
    }
    if (lane == 0) {
      cnt[warp] = out;
      thr[warp] = t - 1;
    }
  }
  __syncthreads();
}

// Sorts each of the first `rows` buffers (cnt[r] <= n keys, n a power of
// two) into descending order, the slots past cnt[r] filled with 0.
__device__ void sort_rows(u64* buf, int stride, const int* cnt, int rows) {
  int most = 0;
  for (int r = 0; r < rows; ++r) most = max(most, cnt[r]);
  const int n = pow2_at_least(most);
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n, i = e - r * n;
    if (i >= cnt[r]) buf[r * stride + i] = 0;
  }
  __syncthreads();
  bitonic_desc(buf, rows, stride, n);
}

// floats of one pipeline stage: the tile's chunk, then with kStreamQ the
// chunk's columns of the block's R query rows
template <int R, bool kStreamQ>
__host__ __device__ constexpr int stage_floats() {
  return kTile * kRowStride + (kStreamQ ? R * kChunk : 0);
}

// Stage s of a block's walk: tile t0 + s / nc, rank columns of chunk s % nc
// (and, kStreamQ, those columns of query rows row0 .. row0 + R - 1).
template <bool kVec, int R, bool kStreamQ>
__device__ __forceinline__ void load_stage(float* dst, const float* items,
                                           int I, int K, int tile, int chunk,
                                           const float* q, int B, int row0) {
  const int col0 = chunk * kChunk;
  const int tid = threadIdx.x;
  if constexpr (kStreamQ) {
    float* qd = dst + kTile * kRowStride;  // [R][kChunk]
    for (int e = tid; e < R * kChunk; e += kThreads) {
      const int r = e / kChunk, col = col0 + e % kChunk;
      const bool in = row0 + r < B && col < K;
      cp_async4(qd + e, in ? q + (size_t)(row0 + r) * K + col : q,
                in ? 4 : 0);
    }
  }
  if (kVec) {
    constexpr int kParts = kChunk / 4;  // 16-byte pieces per row chunk
#pragma unroll
    for (int i = 0; i < kTile * kParts / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kParts, col = col0 + (e % kParts) * 4;
      const int gid = tile * kTile + r;
      const bool in = gid < I && col < K;
      cp_async16(dst + r * kRowStride + (col - col0),
                 in ? items + (size_t)gid * K + col : items, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kTile * kChunk / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kChunk, c = e % kChunk;
      const int gid = tile * kTile + r, col = col0 + c;
      const bool in = gid < I && col < K;
      cp_async4(dst + r * kRowStride + c,
                in ? items + (size_t)gid * K + col : items, in ? 4 : 0);
    }
  }
}

template <int R, bool kStreamQ>
size_t tile_smem_bytes(int K) {
  const int kq = (K + kChunk - 1) / kChunk * kChunk;
  return sizeof(float) * ((size_t)kStages * stage_floats<R, kStreamQ>() +
                          (kStreamQ ? 0 : (size_t)R * kq)) +
         sizeof(u64) * (size_t)R * kBuf;
}

template <int R, bool kVec, bool kStreamQ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    tile_topk_kernel(const float* __restrict__ q,
                     const float* __restrict__ items,
                     const uint8_t* __restrict__ allowed, int B, int I, int K,
                     int k, int tiles_per_block, int item_blocks,
                     u64* __restrict__ cand) {
  extern __shared__ float4 smem4[];
  const int kq = (K + kChunk - 1) / kChunk * kChunk;
  const int nc = kq / kChunk;
  constexpr int kStage = stage_floats<R, kStreamQ>();
  float* stage = reinterpret_cast<float*>(smem4);  // [kStages][kStage]
  float* q_s = stage + kStages * kStage;            // [R][kq], staged whole
  u64* buf = reinterpret_cast<u64*>(q_s + (kStreamQ ? 0 : R * kq));  // [R][kBuf]
  __shared__ int cnt[R];
  __shared__ u64 thr[R];
  __shared__ Sel sel[R];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kMaxRows;
  const int live = min(R, B - row0);
  const int n_tiles = (I + kTile - 1) / kTile;
  const int t0 = blockIdx.x * tiles_per_block;
  const int steps = (min(n_tiles, t0 + tiles_per_block) - t0) * nc;

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps)
      load_stage<kVec, R, kStreamQ>(stage + p * kStage, items, I, K,
                                    t0 + p / nc, p % nc, q, B, row0);
    cp_async_commit();
  }
  if constexpr (!kStreamQ)
    for (int e = tid; e < R * kq; e += kThreads) {
      const int r = e / kq, c = e - r * kq;
      q_s[e] = (r < live && c < K) ? q[(size_t)(row0 + r) * K + c] : 0.f;
    }
  if (tid < R) {
    cnt[tid] = 0;
    thr[tid] = 0;
  }

  float acc[R];
  for (int s = 0; s < steps; ++s) {
    const int ahead = s + kStages - 1;
    if (ahead < steps)
      load_stage<kVec, R, kStreamQ>(stage + (ahead % kStages) * kStage, items,
                                    I, K, t0 + ahead / nc, ahead % nc, q, B,
                                    row0);
    cp_async_commit();        // an empty group past the last stage
    cp_async_wait<kStages - 1>();  // stage s landed
    __syncthreads();
    const int c = s % nc;
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
    }
    float* here = stage + (s % kStages) * kStage;
    const float* x_row = here + tid * kRowStride;
    const float* qc = kStreamQ ? here + kTile * kRowStride : q_s + c * kChunk;
    const int qs = kStreamQ ? kChunk : kq;  // q row stride
#pragma unroll
    for (int j = 0; j < kChunk; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(x_row + j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(qc + r * qs + j);
        float a = acc[r];
        a = fmaf(w.x, x.x, a);
        a = fmaf(w.y, x.y, a);
        a = fmaf(w.z, x.z, a);
        a = fmaf(w.w, x.w, a);
        acc[r] = a;
      }
    }
    __syncthreads();  // this stage's buffer is free for stage s + kStages
    if (c != nc - 1) continue;

    // the tile is scored: select. Stage s's buffer is free until the next
    // step's copy: the radix histograms go there. A row is pruned to its
    // best k as soon as it holds k keys with no threshold yet (its first
    // tile), and when the buffer might not take another tile.
    bool full = false;
    for (int r = 0; r < live; ++r)
      full |= cnt[r] > kBuf - kTile || (thr[r] == 0 && cnt[r] >= k);
    if (full)
      prune(buf, kBuf, cnt, thr, live, k, reinterpret_cast<unsigned*>(here),
            sel);
    const int gid = (t0 + s / nc) * kTile + tid;
    const bool ok = gid < I && (allowed == nullptr || allowed[gid] != 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < live) {
        const u64 key = make_key(acc[r], gid);
        append(ok && key > thr[r], key, &cnt[r], buf + r * kBuf, kBuf);
      }
    }
  }
  __syncthreads();
  bool over = false;
  for (int r = 0; r < live; ++r) over |= cnt[r] > k;
  if (over)
    prune(buf, kBuf, cnt, thr, live, k, reinterpret_cast<unsigned*>(stage),
          sel);
  sort_rows(buf, kBuf, cnt, live);
  for (int e = tid; e < live * k; e += kThreads) {
    const int r = e / k, j = e - r * k;
    cand[((size_t)(row0 + r) * item_blocks + blockIdx.x) * k + j] =
        j < cnt[r] ? buf[r * kBuf + j] : 0ull;
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_topk_kernel(const u64* __restrict__ cand, int L, int k,
                      float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ u64 mbuf[kMergeBuf];
  __shared__ unsigned hist[256];
  __shared__ Sel sel[1];
  __shared__ int cnt[1];
  __shared__ u64 thr[1];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const u64* c = cand + row * (size_t)L * k;
  const int total = L * k;

  if (tid == 0) {
    cnt[0] = 0;
    thr[0] = 0;
  }
  __syncthreads();
  constexpr int kLoads = 8;  // keys a thread has in flight per batch
  constexpr int kBatch = kLoads * kThreads;
  static_assert(kBatch <= kMergeBuf / 2, "room for a batch after a prune");
  if (total > kMergeBuf - kBatch) {
    // a lower bound of the row's k-th key: the k-th of the first
    // m = ceil(k / L) keys of each (sorted) list, L * m >= k of them
    const int m = (k + L - 1) / L;
    for (int e0 = 0; e0 < L * m; e0 += kThreads) {
      const int e = e0 + tid;
      const u64 key = e < L * m ? c[(size_t)(e / m) * k + (e % m)] : 0ull;
      append(key != 0, key, cnt, mbuf, kMergeBuf);
    }
    __syncthreads();
    prune(mbuf, kMergeBuf, cnt, thr, 1, k, hist, sel);  // thr: bound - 1
    if (tid == 0) cnt[0] = 0;
    __syncthreads();
  }
  // every key above it, kLoads a thread in flight at once; the buffer is
  // pruned to k whenever it might not take another batch
  for (int e0 = 0; e0 < total; e0 += kBatch) {
    u64 key[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads + tid;
      key[u] = e < total ? c[e] : 0ull;
    }
    if (cnt[0] > kMergeBuf - kBatch)
      prune(mbuf, kMergeBuf, cnt, thr, 1, k, hist, sel);
    const u64 t = thr[0];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      append(key[u] > t, key[u], cnt, mbuf, kMergeBuf);
    __syncthreads();
  }
  if (cnt[0] > k) prune(mbuf, kMergeBuf, cnt, thr, 1, k, hist, sel);
  sort_rows(mbuf, kMergeBuf, cnt, 1);
  const int n = cnt[0];
  for (int j = tid; j < k; j += kThreads) {
    const u64 key = j < n ? mbuf[j] : 0ull;
    const float s = key_score(key);
    const bool filler = key == 0 || s <= 0.5f * kNegInf;  // pallas_kernels :294
    out_s[row * k + j] = filler ? kNegInf : s;
    out_i[row * k + j] = filler ? -1 : key_id(key);
  }
}

template <int R, bool kStreamQ = false>
int launch_tiles(const float* q, const float* items, const uint8_t* allowed,
                 int B, int I, int K, int k, int tpb, int item_blocks,
                 u64* cand, cudaStream_t st) {
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(items) & 15) == 0;
  auto kernel = vec ? tile_topk_kernel<R, true, kStreamQ>
                    : tile_topk_kernel<R, false, kStreamQ>;
  const size_t smem = tile_smem_bytes<R, kStreamQ>(K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)item_blocks,
                  (unsigned)((B + kMaxRows - 1) / kMaxRows));
  kernel<<<grid, kThreads, smem, st>>>(q, items, allowed, B, I, K, k, tpb,
                                       item_blocks, cand);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the wrapper allocates for one call: item_blocks sorted lists of k
// keys (8 bytes each) per query row.
size_t pio_score_topk_workspace_bytes(int B, int k, int item_blocks) {
  return (size_t)B * (size_t)item_blocks * (size_t)k * sizeof(u64);
}

// q [B, K] f32, items [I, K] f32, allowed [I] u8 (nullptr: all allowed),
// out_s [B, k] f32, out_i [B, k] i32, all contiguous on the device of
// `stream`. The launch plan (ops/kernels.topk_plan): item_blocks blocks
// along the items, each walking tiles_per_block tiles of 256 items, so
// every item falls in exactly one block; workspace of workspace_bytes >=
// pio_score_topk_workspace_bytes(B, k, item_blocks).
int pio_score_topk(const float* q, const float* items, const uint8_t* allowed,
                   int B, int I, int K, int k, int item_blocks,
                   int tiles_per_block, float* out_s, int* out_i,
                   void* workspace, size_t workspace_bytes, void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || k <= 0 || k > kMaxK ||
      k > I || (B + kMaxRows - 1) / kMaxRows > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = ((long long)I + kTile - 1) / kTile;
  if (item_blocks <= 0 || item_blocks > kMaxLists || tiles_per_block <= 0 ||
      (long long)item_blocks * tiles_per_block < n_tiles ||
      (long long)(item_blocks - 1) * tiles_per_block >= n_tiles ||
      workspace_bytes < pio_score_topk_workspace_bytes(B, k, item_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* cand = static_cast<u64*>(workspace);
  int rc;
  // above kMaxStagedRank the query rows stream by chunk, eight rows a block
  if (K > kMaxStagedRank)
    rc = launch_tiles<kMaxRows, true>(q, items, allowed, B, I, K, k,
                                      tiles_per_block, item_blocks, cand, st);
  else switch (B < kMaxRows ? B : kMaxRows) {
    case 1: rc = launch_tiles<1>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    case 2: rc = launch_tiles<2>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    case 3: rc = launch_tiles<3>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    case 4: rc = launch_tiles<4>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    case 5: rc = launch_tiles<5>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    case 6: rc = launch_tiles<6>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    case 7: rc = launch_tiles<7>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
    default: rc = launch_tiles<8>(q, items, allowed, B, I, K, k, tiles_per_block, item_blocks, cand, st); break;
  }
  if (rc != 0) return rc;
  merge_topk_kernel<<<(unsigned)B, kThreads, 0, st>>>(cand, item_blocks, k,
                                                      out_s, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
