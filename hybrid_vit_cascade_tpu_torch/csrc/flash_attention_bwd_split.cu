// Kernels L and M: the split flash attention backward for Hopper (sm_90a).
//
// Replace hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py::_bwd_pallas, the
// backward the JAX package runs with HVC_FLASH_FUSED_BWD=0: its two kernel
// bodies _bwd_dq_kernel (L here) and _bwd_dkv_kernel (M here). Both recompute
// the probabilities of out = softmax(q·kᵀ·scale)·v from the forward's per-row
// log-sum-exp, with delta = Σ_d do·out precomputed per query row by the caller
// (as _bwd_pallas computes it before its pallas_calls):
//   L: dq[i]  = scale · Σ_j p_ij (dp_ij − δ_i) k_j          (products s, dp, dq)
//   M: dv[j]  = Σ_i p_ij do_i,  dk[j] = scale · Σ_i ds_ij q_i  (products s, dp, dv, dk)
// with s = q·kᵀ·scale, p = exp(s − lse), dp = do·vᵀ, ds = p (dp − δ).
//
// What differs from the TPU kernels, and why:
// - The TPU kernels carry their accumulators in VMEM across a sequential grid
//   dimension (kv blocks for dq, q blocks for dk/dv). Hopper blocks run
//   concurrently and in no order, so here that sweep is a loop inside the
//   block: L gives one block a tile of query rows and loops over every key
//   tile; M gives one block a tile of key rows and loops over every query
//   tile. Each dq, dk and dv element is accumulated in registers by one
//   thread (L; M on the CUDA cores) or one warp (M on the tensor cores) and
//   stored once, with no atomics, so the result does not depend on launch
//   order (kernel D's dq is summed across blocks: it adds the key tiles'
//   shares into one accumulator in key-tile order).
// - The lse is the natural-log one kernel A stores; no base-2/LN2 bookkeeping
//   on the outputs, no 128-lane padding of d, no lse = 1e30 padded rows.
//   Bounds checks mask the ragged kv tail (L) and the ragged query tail (M).
//
// What bounds them on this card: at the main path's long shape (8 heads ×
// 32,768 × 32,768, d = 32) L does 3 and M 4 products of N²·d per head and
// both read a few MB, so both are compute-bound. Together they do 7 products
// where kernel D does 5: s and dp are computed in both.
//
// M has two instances, by an explicit rule (dkv_uses_tc, which the wrapper
// reads through hvc_flash_attention_bwd_dkv_tc; no fallback): bf16 on the
// tensor cores, fp32 on the CUDA cores (TF32 would leave the fp32
// tolerances). On the tensor cores M is kernel D's body without its dq phase
// (flash_bwd_tc_kernel<D, false>, flash_bwd_tc.cuh): work items of one head's
// 128 keys, 16 a warp, k and v fragments and the dk and dv accumulators in
// registers, query tiles of 64 double-buffered by cp.async, Sᵀ = K·qᵀ and
// dPᵀ = V·doutᵀ, P and dS rounded to bf16 (as _bwd_dkv_kernel rounds them:
// pb = p.astype, ds = (...).astype) and taken as A operands straight from the
// accumulator fragments; one block per item. Its dk and dv are D's bits.
//
// L, and M in fp32, run as fp32 FMAs on the CUDA cores (67 TFLOP/s peak): each
// thread owns one row (d = 32) or half of one (d = 64, the halves combined with
// one warp shuffle) and holds its slices of the row's operands and
// accumulators in registers; the other side's tile is staged once per block in
// shared memory as fp32 and read as float4 broadcasts, four FMAs per
// shared-memory load. These do not round p and ds to bf16.
//
// Layout: q, dout (BH, Nq, d), k and v (BH, Nk, d), contiguous, fp32 or bf16;
// lse and delta (BH, Nq) fp32; dq (BH, Nq, d), dk and dv (BH, Nk, d) in the
// input dtype. All offsets 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"

namespace {

constexpr int kDh = 32;  // columns owned by one thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Σ over this thread's kDh columns of a·row, and of b·row2, for rows in shared
// memory read as float4 broadcasts; the two halves of a d = 64 row are
// neighbouring lanes and are combined with one shuffle.
template <int TPR>
__device__ __forceinline__ void two_dots(const float* ra, const float* rb, const float (&a)[kDh],
                                         const float (&b)[kDh], float& sa, float& sb) {
  const float4* pa = reinterpret_cast<const float4*>(ra);
  const float4* pb = reinterpret_cast<const float4*>(rb);
  sa = 0.f;
  sb = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < kDh / 4; ++c4) {
    const float4 x = pa[c4];
    const float4 y = pb[c4];
    sa = fmaf(x.x, a[4 * c4 + 0], sa);
    sa = fmaf(x.y, a[4 * c4 + 1], sa);
    sa = fmaf(x.z, a[4 * c4 + 2], sa);
    sa = fmaf(x.w, a[4 * c4 + 3], sa);
    sb = fmaf(y.x, b[4 * c4 + 0], sb);
    sb = fmaf(y.y, b[4 * c4 + 1], sb);
    sb = fmaf(y.z, b[4 * c4 + 2], sb);
    sb = fmaf(y.w, b[4 * c4 + 3], sb);
  }
  if (TPR == 2) {
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  }
}

// acc += w · row, row in shared memory
__device__ __forceinline__ void axpy(float w, const float* row, float (&acc)[kDh]) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c4 = 0; c4 < kDh / 4; ++c4) {
    const float4 x = p[c4];
    acc[4 * c4 + 0] = fmaf(w, x.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(w, x.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(w, x.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(w, x.w, acc[4 * c4 + 3]);
  }
}

template <typename T>
__device__ __forceinline__ void load_row(const T* src, bool valid, float (&dst)[kDh]) {
#pragma unroll
  for (int c = 0; c < kDh; ++c) dst[c] = valid ? to_f32(src[c]) : 0.f;
}

// ------------------------------------------------------------- kernel L: dq ---

constexpr int kDqRows = 128;  // query rows per block
constexpr int kDqBkv = 64;    // keys per staged tile

template <typename T, int D>
__global__ void __launch_bounds__(kDqRows * (D / kDh))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, long long nq,
                    long long nk, float scale) {
  constexpr int TPR = D / kDh;
  constexpr int NT = kDqRows * TPR;
  __shared__ __align__(16) float ks[kDqBkv * D];
  __shared__ __align__(16) float vs[kDqBkv * D];

  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int c0 = (tid % TPR) * kDh;  // first column owned by this thread
  const long long i = static_cast<long long>(blockIdx.x) * kDqRows + tid / TPR;
  const bool ivalid = i < nq;
  const long long row = bh * nq + (ivalid ? i : 0);

  float qr[kDh], dor[kDh], dqr[kDh];
  load_row(q + row * D + c0, ivalid, qr);
  load_row(dout + row * D + c0, ivalid, dor);
#pragma unroll
  for (int c = 0; c < kDh; ++c) dqr[c] = 0.f;
  // base 2: p = exp2(s·scale·log2e − lse·log2e); +inf gives p = 0 past Nq
  const float lse_i = ivalid ? lse[row] * kLog2e : CUDART_INF_F;
  const float delta_i = ivalid ? delta[row] : 0.f;
  const float scale_log2 = scale * kLog2e;

  const T* kb = k + bh * nk * D;
  const T* vb = v + bh * nk * D;
  for (long long kv0 = 0; kv0 < nk; kv0 += kDqBkv) {
    __syncthreads();  // the previous key tile is no longer read
    for (int e = tid; e < kDqBkv * D; e += NT) {
      const bool in = kv0 + e / D < nk;
      ks[e] = in ? to_f32(kb[kv0 * D + e]) : 0.f;
      vs[e] = in ? to_f32(vb[kv0 * D + e]) : 0.f;
    }
    __syncthreads();
    const int nj = static_cast<int>(nk - kv0 < kDqBkv ? nk - kv0 : kDqBkv);
    for (int j = 0; j < nj; ++j) {
      float s, dp;
      two_dots<TPR>(ks + j * D + c0, vs + j * D + c0, qr, dor, s, dp);
      const float p = exp2f(fmaf(s, scale_log2, -lse_i));
      axpy(p * (dp - delta_i), ks + j * D + c0, dqr);
    }
  }
  if (ivalid) {
    T* dst = dq + row * D + c0;
#pragma unroll
    for (int c = 0; c < kDh; ++c) dst[c] = from_f32<T>(dqr[c] * scale);
  }
}

// -------------------------------------------------------- kernel M: dk, dv ---

constexpr int kKvRows = 64;  // key rows per block

template <int D>
struct DkvShape {
  static constexpr int kTpr = D / kDh;
  static constexpr int kThreads = kKvRows * kTpr;
  static constexpr int kBq = D == 32 ? 64 : 32;  // query rows per staged tile
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvShape<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     long long nq, long long nk, float scale) {
  using S = DkvShape<D>;
  constexpr int TPR = S::kTpr;
  constexpr int NT = S::kThreads;
  constexpr int BQ = S::kBq;
  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float dos[BQ * D];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int c0 = (tid % TPR) * kDh;
  const long long j = static_cast<long long>(blockIdx.x) * kKvRows + tid / TPR;
  const bool jvalid = j < nk;
  const long long krow = bh * nk + (jvalid ? j : 0);

  float kr[kDh], vr[kDh], dkr[kDh], dvr[kDh];
  load_row(k + krow * D + c0, jvalid, kr);
  load_row(v + krow * D + c0, jvalid, vr);
#pragma unroll
  for (int c = 0; c < kDh; ++c) dkr[c] = dvr[c] = 0.f;
  const float scale_log2 = scale * kLog2e;

  const T* qb = q + bh * nq * D;
  const T* dob = dout + bh * nq * D;
  for (long long q0 = 0; q0 < nq; q0 += BQ) {
    __syncthreads();  // the previous query tile is no longer read
    for (int e = tid; e < BQ * D; e += NT) {
      const bool in = q0 + e / D < nq;
      qs[e] = in ? to_f32(qb[q0 * D + e]) : 0.f;
      dos[e] = in ? to_f32(dob[q0 * D + e]) : 0.f;
    }
    for (int e = tid; e < BQ; e += NT) {
      const bool in = q0 + e < nq;
      lse_s[e] = in ? lse[bh * nq + q0 + e] * kLog2e : CUDART_INF_F;
      delta_s[e] = in ? delta[bh * nq + q0 + e] : 0.f;
    }
    __syncthreads();
    const int ni = static_cast<int>(nq - q0 < BQ ? nq - q0 : BQ);
    for (int i = 0; i < ni; ++i) {
      float s, dp;
      two_dots<TPR>(qs + i * D + c0, dos + i * D + c0, kr, vr, s, dp);
      // past Nk (jvalid false) k and v read as zero rows: their p is computed
      // but never stored
      const float p = exp2f(fmaf(s, scale_log2, -lse_s[i]));
      axpy(p, dos + i * D + c0, dvr);
      axpy(p * (dp - delta_s[i]), qs + i * D + c0, dkr);
    }
  }
  if (jvalid) {
    T* dkrow = dk + krow * D + c0;
    T* dvrow = dv + krow * D + c0;
#pragma unroll
    for (int c = 0; c < kDh; ++c) {
      dkrow[c] = from_f32<T>(dkr[c] * scale);
      dvrow[c] = from_f32<T>(dvr[c]);
    }
  }
}

bool sizes_ok(long long bh, long long nq, long long nk, long long rows_per_block,
              long long rows) {
  return bh > 0 && bh <= 65535 && nq > 0 && nk > 0 &&
         (rows + rows_per_block - 1) / rows_per_block <= 2147483647LL;
}

// The instance of M a call takes, an explicit rule (no fallback): bf16 on the
// tensor cores, fp32 on the CUDA cores. The wrapper reads it through
// hvc_flash_attention_bwd_dkv_tc to count launches.
bool dkv_uses_tc(int dtype) { return dtype == 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t.
extern "C" int hvc_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, long long bh,
                                          long long nq, long long nk, int head_dim, int dtype,
                                          float scale, void* stream) {
  if (!sizes_ok(bh, nq, nk, kDqRows, nq)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nq + kDqRows - 1) / kDqRows), static_cast<unsigned>(bh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVC_DQ(T, D)                                                                          \
  flash_bwd_dq_kernel<T, D><<<grid, kDqRows * (D / kDh), 0, s>>>(                              \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),            \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                             \
      static_cast<const float*>(delta), static_cast<T*>(dq), nq, nk, scale)
  if (dtype == 0 && head_dim == 32) {
    HVC_DQ(float, 32);
  } else if (dtype == 0 && head_dim == 64) {
    HVC_DQ(float, 64);
  } else if (dtype == 1 && head_dim == 32) {
    HVC_DQ(__nv_bfloat16, 32);
  } else if (dtype == 1 && head_dim == 64) {
    HVC_DQ(__nv_bfloat16, 64);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HVC_DQ
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvc_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, long long bh,
                                           long long nq, long long nk, int head_dim, int dtype,
                                           float scale, void* stream) {
  if (!sizes_ok(bh, nq, nk, kKvRows, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dkv_uses_tc(dtype)) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (head_dim == 32)
      return launch_bwd_tc<32, false>(q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
                                      bh, nq, nk, scale, s);
    if (head_dim == 64)
      return launch_bwd_tc<64, false>(q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
                                      bh, nq, nk, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((nk + kKvRows - 1) / kKvRows), static_cast<unsigned>(bh));
#define HVC_DKV(T, D)                                                                         \
  flash_bwd_dkv_kernel<T, D><<<grid, DkvShape<D>::kThreads, 0, s>>>(                           \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),            \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                             \
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), nq, nk,      \
      scale)
  if (dtype == 0 && head_dim == 32) {
    HVC_DKV(float, 32);
  } else if (dtype == 0 && head_dim == 64) {
    HVC_DKV(float, 64);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HVC_DKV
  return static_cast<int>(cudaGetLastError());
}

// 1 if hvc_flash_attention_bwd_dkv runs a call of this dtype (0 = float32,
// 1 = bfloat16) on the tensor cores, else 0: the rule of its dispatch.
extern "C" int hvc_flash_attention_bwd_dkv_tc(int dtype) { return dkv_uses_tc(dtype) ? 1 : 0; }
