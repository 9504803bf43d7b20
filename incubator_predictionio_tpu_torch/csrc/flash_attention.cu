// Forward flash attention (online softmax) on BSHD tensors, for Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_predictionio_tpu/ops/pallas_kernels.py
// flash_attention (:582) -> _flash_with_vjp (:483) -> _flash_bhsd (:425,
// pallas_call :450), body _flash_kernel (:350). Same contract:
//   * q [B, Sq, H, D], k and v [B, Skv, H, D], f32 or bf16, read through their
//     strides (no transposes); out [B, Sq, H, D] contiguous, in q's dtype;
//   * f32 arithmetic throughout: q is scaled on load (q * scale, as the TPU
//     kernel does), scores, running max m, sum l and accumulator are f32;
//   * a key is live when valid[b, key] > 0 and, if causal, key <= query, with
//     positions counted from 0 for both q and kv, also when Sq != Skv;
//   * a masked score is -1e30 (MASK_VALUE), and its probability is set to 0
//     explicitly: if a query's first live tile is fully masked, m = -1e30 and
//     exp(s - m) would be 1;
//   * a query with no live key (the left padding of a SASRec window) gives
//     exactly 0: l == 0 is divided as 1;
//   * causal: key tiles wholly in the future of the query tile are skipped.
//
// What bounds it on this card: the QK^T and PV products, 4*D FLOP per live
// (query, key) pair, run here on the f32 FMA units (67 TFLOP/s); the bytes
// (q, k, v read once, out written once) are far smaller at S >= 1024. The
// design keeps the [Sq, Skv] score matrix out of device memory, as the TPU
// kernel kept it in VMEM, but does not carry its grid: one block per
// (query tile of 64, batch*head); the KV scan is a loop inside the block over
// 64-key tiles staged in shared memory (converted to f32 on load). 256
// threads as 16 x 16: thread (ty, tx) owns query rows ty + 16i (i < 4), the
// score columns tx + 16j (j < 4) and the output columns tx + 16c. The 16
// threads of a row are one half-warp, so the row max and sum are shuffles
// and the row state (m, l) stays in registers; the probabilities go to
// shared memory for the PV product, read back by the same warp. It is the
// simple form: tensor-core products (mma.sync / wgmma) fed by TMA are later
// work.
//
// Plain C interface, bound from Python with ctypes; launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr float kMaskValue = -1e30f;  // ops/attention.py MASK_VALUE

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

struct Strides {
  long long b, s, h;  // in elements; the head_dim stride is 1
};

template <int DP>
constexpr size_t smem_floats() {
  // Qs [kBQ][DP+1], Ks [kBK][DP+1], Vs [kBK][DP], Ps [kBQ][kBK+1], Val [kBK]
  return (size_t)kBQ * (DP + 1) + (size_t)kBK * (DP + 1) + (size_t)kBK * DP +
         (size_t)kBQ * (kBK + 1) + kBK;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ valid,
                     T* __restrict__ out, int H, int Sq, int Skv, int D,
                     Strides qs, Strides ks, Strides vs, int causal,
                     float scale) {
  constexpr int kNC = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (DP + 1);
  float* Vs = Ks + kBK * (DP + 1);
  float* Ps = Vs + kBK * DP;
  float* Val = Ps + kBQ * (kBK + 1);

  // the last query tiles have the most live key tiles under the causal
  // mask: they start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* valb = valid == nullptr ? nullptr : valid + (long long)b * Skv;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    float x = 0.f;
    if (row < Sq && d < D) x = to_f32(qb[row * qs.s + d]) * scale;
    Qs[r * (DP + 1) + d] = x;
  }

  int n_kv = (Skv + kBK - 1) / kBK;
  if (causal) {
    // live only if tile_start <= the tile's last real query position
    const int last = min(q0 + kBQ, Sq) - 1;
    n_kv = min(n_kv, last / kBK + 1);
  }

  float m_i[kRows], l_i[kRows], acc[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Qs staged; the previous tile's Ks, Vs, Val consumed
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < Skv && d < D) {
        kx = to_f32(kb[key * ks.s + d]);
        vx = to_f32(vb[key * vs.s + d]);
      }
      Ks[r * (DP + 1) + d] = kx;
      Vs[r * DP + d] = vx;
    }
    if (tid < kBK) {
      const int key = k0 + tid;
      Val[tid] =
          (key < Skv && (valb == nullptr || valb[key] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      bool live[kCols];
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        live[j] = Val[col] > 0.f && (!causal || row >= k0 + col);
        if (!live[j]) s[i][j] = kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 16 threads are one half-warp: lanes differ in bits 0-3
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's probabilities are read by the warp that wrote them

#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float pv[kRows], vv[kNC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + jj];
#pragma unroll
      for (int c = 0; c < kNC; ++c) vv[c] = Vs[jj * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kNC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];  // fully masked row -> 0
    T* o = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) o[d] = from_f32<T>(acc[i][c] / l);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const float* valid,
           void* out, int B, int H, int Sq, int Skv, int D, Strides qs,
           Strides ks, Strides vs, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), H, Sq, Skv, D,
      qs, ks, vs, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* valid,
             void* out, int B, int H, int Sq, int Skv, int D, Strides qs,
             Strides ks, Strides vs, int causal, float scale,
             cudaStream_t stream) {
  if (D <= 16)
    return launch<T, 16>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,
                         causal, scale, stream);
  if (D <= 32)
    return launch<T, 32>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,
                         causal, scale, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,
                         causal, scale, stream);
  return launch<T, 128>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,
                        causal, scale, stream);
}

}  // namespace

extern "C" {

// q, k, v: BSHD with head_dim stride 1 and the given (batch, seq, head)
// element strides; valid [B, Skv] f32 contiguous (nullptr: every key valid);
// out [B, Sq, H, D] contiguous. dtype 0 = f32, 1 = bf16 (q, k, v and out).
int pio_flash_attention(const void* q, const void* k, const void* v,
                        const float* valid, void* out, int B, int H, int Sq,
                        int Skv, int D, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int causal, float scale, int dtype,
                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv < 0 || D <= 0 || D > 128 ||
      (long long)B * H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  if (dtype == 0)
    return dispatch<float>(q, k, v, valid, out, B, H, Sq, Skv, D, qs, ks, vs,
                           causal, scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, valid, out, B, H, Sq, Skv, D, qs,
                                 ks, vs, causal, scale, st);
}

}  // extern "C"
