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
//
// What bounds it on this card: at one query it is the item table read
// (I*K*4 bytes at 3.35 TB/s); at 64 queries and rank 128 the f32 FMAs
// (2*B*I*K at 67 TFLOP/s without tensor cores) come level with the bytes.
// The design keeps the [B, I] score matrix out of device memory, as the TPU
// kernel did: each block scores one tile of items for a few query rows into
// shared memory and writes back only that tile's k candidates per row. It is
// the simple form; a split-f32 tensor-core product fed by TMA is the fast one.
//
// Pass 1 (tile_topk_kernel): grid (item tiles of 1024) x (query tiles of 8).
//   The query tile is staged in shared memory; each thread scores 4 items for
//   the 8 rows; the allow mask is applied; then warp w selects row w's
//   tile-local top-k from the 8 x 1024 scores in shared memory by repeated
//   warp argmax (score desc, id asc). Candidates go to a scratch buffer
//   [n_tiles, B, k], each list sorted.
// Pass 2 (merge_topk_kernel): each warp merges up to 32 sorted lists (one per
//   lane, the lane holding its list's head) into one sorted list of k, again
//   by warp argmax. Repeated until one list per row is left; the last round
//   writes the result and turns filler slots into (-3.4e38, -1).
//
// Plain C interface, bound from Python with ctypes; launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kTileItems = 1024;
constexpr int kQueryRows = 8;
constexpr int kThreads = 256;  // 8 warps: warp w selects query row w
constexpr int kItemsPerThread = kTileItems / kThreads;
constexpr int kMaxRank = 256;
constexpr int kMaxK = 128;
constexpr int kFanIn = 32;  // merge: one sorted list per lane
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -3.4e38f;  // disallowed score (pallas_kernels.py:52)

static_assert(kThreads / 32 == kQueryRows, "one warp per query row");

// Strict total order on (score desc, id asc, lane asc): every lane of a
// butterfly reduction ends with the same winner.
__device__ __forceinline__ bool better(float s, int i, int l, float s2, int i2,
                                       int l2) {
  if (s != s2) return s > s2;
  if (i != i2) return i < i2;
  return l < l2;
}

__device__ __forceinline__ void warp_argmax(float& s, int& i, int& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    const int l2 = __shfl_xor_sync(0xffffffffu, l, off);
    if (better(s2, i2, l2, s, i, l)) {
      s = s2;
      i = i2;
      l = l2;
    }
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    tile_topk_kernel(const float* __restrict__ q,
                     const float* __restrict__ items,
                     const uint8_t* __restrict__ allowed, int B, int I, int K,
                     int k, float* __restrict__ cand_s,
                     int* __restrict__ cand_i) {
  __shared__ float q_s[kQueryRows * kMaxRank];
  __shared__ float sc[kQueryRows][kTileItems];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kQueryRows;
  const int base = tile * kTileItems;
  const int tid = threadIdx.x;

  for (int e = tid; e < kQueryRows * K; e += kThreads) {
    const int r = e / K;
    q_s[e] = (row0 + r < B) ? q[(size_t)row0 * K + e] : 0.f;
  }
  __syncthreads();

  float acc[kItemsPerThread][kQueryRows];
  const float* rows[kItemsPerThread];
  bool live[kItemsPerThread];
#pragma unroll
  for (int m = 0; m < kItemsPerThread; ++m) {
    const int gid = base + tid + m * kThreads;
    live[m] = gid < I;
    rows[m] = items + (size_t)(live[m] ? gid : 0) * K;
#pragma unroll
    for (int r = 0; r < kQueryRows; ++r) acc[m][r] = 0.f;
  }

  if (kVec4) {
    for (int c = 0; c < K; c += 4) {
      float4 x[kItemsPerThread];
#pragma unroll
      for (int m = 0; m < kItemsPerThread; ++m)
        x[m] = live[m] ? __ldg(reinterpret_cast<const float4*>(rows[m] + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kQueryRows; ++r) {
        const float q0 = q_s[r * K + c], q1 = q_s[r * K + c + 1];
        const float q2 = q_s[r * K + c + 2], q3 = q_s[r * K + c + 3];
#pragma unroll
        for (int m = 0; m < kItemsPerThread; ++m) {
          float a = acc[m][r];
          a = fmaf(q0, x[m].x, a);
          a = fmaf(q1, x[m].y, a);
          a = fmaf(q2, x[m].z, a);
          a = fmaf(q3, x[m].w, a);
          acc[m][r] = a;
        }
      }
    }
  } else {
    for (int c = 0; c < K; ++c) {
      float x[kItemsPerThread];
#pragma unroll
      for (int m = 0; m < kItemsPerThread; ++m)
        x[m] = live[m] ? __ldg(rows[m] + c) : 0.f;
#pragma unroll
      for (int r = 0; r < kQueryRows; ++r) {
        const float qv = q_s[r * K + c];
#pragma unroll
        for (int m = 0; m < kItemsPerThread; ++m)
          acc[m][r] = fmaf(qv, x[m], acc[m][r]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kItemsPerThread; ++m) {
    const int j = tid + m * kThreads;
    const int gid = base + j;
    // past the catalogue: -inf, below every real or disallowed score, so
    // a tile that runs out ends its list with fillers
    const bool ok = live[m] && (allowed == nullptr || allowed[gid] != 0);
#pragma unroll
    for (int r = 0; r < kQueryRows; ++r)
      sc[r][j] = !live[m] ? -CUDART_INF_F : (ok ? acc[m][r] : kNegInf);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = row0 + warp;
  if (row >= B) return;
  float* my = sc[warp];
  float* out_s = cand_s + ((size_t)tile * B + row) * k;
  int* out_i = cand_i + ((size_t)tile * B + row) * k;
  for (int slot = 0; slot < k; ++slot) {
    float bs = -CUDART_INF_F;
    int bj = INT_MAX;
    // lane scans j = lane + 32m in increasing j: '>' keeps the lowest id
#pragma unroll 8
    for (int m = 0; m < kTileItems / 32; ++m) {
      const float v = my[lane + 32 * m];
      if (v > bs) {
        bs = v;
        bj = lane + 32 * m;
      }
    }
    int bl = lane;
    warp_argmax(bs, bj, bl);
    if (bs == -CUDART_INF_F) {  // everything left is taken or off the end
      for (int s = slot + lane; s < k; s += 32) {
        out_s[s] = -CUDART_INF_F;
        out_i[s] = -1;
      }
      break;
    }
    if (lane == 0) {
      out_s[slot] = bs;
      out_i[slot] = base + bj;
    }
    if (lane == (bj & 31)) my[bj] = -CUDART_INF_F;  // only its owner reads it
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    merge_topk_kernel(const float* __restrict__ in_s,
                      const int* __restrict__ in_i, int n_in, int B, int k,
                      float* __restrict__ out_s, int* __restrict__ out_i,
                      int finalize) {
  const int w = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n_out = (n_in + kFanIn - 1) / kFanIn;
  if (w >= n_out * B) return;  // warp-uniform
  const int g = w / B;
  const int row = w - g * B;
  const int list = g * kFanIn + lane;
  const bool has = list < n_in;
  const size_t off = ((size_t)(has ? list : 0) * B + row) * k;
  const float* ls = in_s + off;
  const int* li = in_i + off;
  int p = 0;
  float hs = has ? ls[0] : -CUDART_INF_F;
  int hi = has ? li[0] : INT_MAX;
  float* os = out_s + ((size_t)g * B + row) * k;
  int* oi = out_i + ((size_t)g * B + row) * k;
  for (int slot = 0; slot < k; ++slot) {
    float bs = hs;
    int bi = hi;
    int bl = lane;
    warp_argmax(bs, bi, bl);
    if (lane == 0) {
      if (finalize && bs <= 0.5f * kNegInf) {  // filler (pallas_kernels :294)
        os[slot] = kNegInf;
        oi[slot] = -1;
      } else {
        os[slot] = bs;
        oi[slot] = bi;
      }
    }
    if (lane == bl) {
      ++p;
      if (has && p < k) {
        hs = ls[p];
        hi = li[p];
      } else {
        hs = -CUDART_INF_F;
        hi = INT_MAX;
      }
    }
  }
}

size_t n_tiles(int I) { return ((size_t)I + kTileItems - 1) / kTileItems; }

}  // namespace

extern "C" {

// Scratch the wrapper allocates for one call: two candidate levels of
// (f32 score, i32 id) pairs.
size_t pio_score_topk_workspace_bytes(int B, int I, int k) {
  const size_t n0 = n_tiles(I);
  const size_t n1 = (n0 + kFanIn - 1) / kFanIn;
  return (n0 + n1) * (size_t)B * (size_t)k * (sizeof(float) + sizeof(int));
}

// q [B, K] f32, items [I, K] f32, allowed [I] u8 (nullptr: all allowed),
// out_s [B, k] f32, out_i [B, k] i32, workspace of
// pio_score_topk_workspace_bytes(B, I, k) bytes. All contiguous, on the
// device of `stream`.
int pio_score_topk(const float* q, const float* items, const uint8_t* allowed,
                   int B, int I, int K, int k, float* out_s, int* out_i,
                   void* workspace, void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || K > kMaxRank || k <= 0 || k > kMaxK ||
      k > I || (B + kQueryRows - 1) / kQueryRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n0 = n_tiles(I);
  const size_t n1 = (n0 + kFanIn - 1) / kFanIn;
  float* a_s = static_cast<float*>(workspace);
  int* a_i = reinterpret_cast<int*>(a_s + n0 * B * k);
  float* b_s = reinterpret_cast<float*>(a_i + n0 * B * k);
  int* b_i = reinterpret_cast<int*>(b_s + n1 * B * k);

  const dim3 grid1((unsigned)n0, (unsigned)((B + kQueryRows - 1) / kQueryRows));
  const bool vec4 =
      K % 4 == 0 && (reinterpret_cast<uintptr_t>(items) & 15) == 0;
  if (vec4)
    tile_topk_kernel<true><<<grid1, kThreads, 0, st>>>(q, items, allowed, B, I,
                                                       K, k, a_s, a_i);
  else
    tile_topk_kernel<false><<<grid1, kThreads, 0, st>>>(q, items, allowed, B,
                                                        I, K, k, a_s, a_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // level l lives in a (even l) or b (odd l); a holds n0 >= n2 >= ... lists
  // and b holds n1 >= n3 >= ..., so the ping-pong never overruns
  const float* src_s = a_s;
  const int* src_i = a_i;
  size_t n = n0;
  bool to_b = true;
  for (;;) {
    const size_t n_out = (n + kFanIn - 1) / kFanIn;
    const bool fin = n_out == 1;
    float* dst_s = fin ? out_s : (to_b ? b_s : a_s);
    int* dst_i = fin ? out_i : (to_b ? b_i : a_i);
    const size_t warps = n_out * (size_t)B;
    const unsigned blocks =
        (unsigned)((warps * 32 + kMergeThreads - 1) / kMergeThreads);
    merge_topk_kernel<<<blocks, kMergeThreads, 0, st>>>(
        src_s, src_i, (int)n, B, k, dst_s, dst_i, fin ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess || fin) return (int)err;
    src_s = dst_s;
    src_i = dst_i;
    n = n_out;
    to_b = !to_b;
  }
}

}  // extern "C"
