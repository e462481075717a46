// Kernel A: flash attention forward for Hopper (sm_90a).
//
// Replaces hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py::_flash_fwd_padded
// (kernel body _fwd_kernel): out = softmax(q·kᵀ·scale)·v with an online softmax
// over KV tiles, fp32 running max / sum / accumulator, no score matrix in device
// memory, and a per-row log-sum-exp. The TPU kernel stores the lse in base 2;
// this one stores it in base e (natural log), which is what a caller of the
// forward alone can use directly.
//
// Not carried over from the TPU kernel: the 128-lane padding of d and the V
// "ones-lane" row sum. Both work around the TPU's (8, 128) tiling; here d is a
// template parameter and the row sum is a scalar in a register.
//
// What bounds it on this card: at the main path's long shapes (8 heads ×
// 32,768 queries × 32,768 keys, d = 32) the work is 4·N²·d flops per head and
// the inputs are a few MB, so the kernel is compute-bound. This first version
// runs the two products as fp32 FMAs on the CUDA cores (67 TFLOP/s peak on an
// H100 SXM), not on the tensor cores. Design against that bound: one query row
// per thread, with q, the accumulator and one tile of scores held in
// registers; K and V tiles staged once per block in shared memory (converted
// to fp32 on load) and read as float4 broadcasts, so four FMAs are issued per
// shared-memory load; one exp2 per score, with log2(e) folded into the q
// pre-scale. Moving the products to wgmma is later work.
//
// Layout: q (BH, Nq, d), k and v (BH, Nk, d), contiguous, fp32 or bf16.
// out (BH, Nq, d) in the input dtype, lse (BH, Nq) fp32. Ragged Nq and Nk are
// masked. All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // query rows per block: one per thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, long long nq, long long nk,
                 float scale_log2) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[BKV * D];
  __shared__ __align__(16) float vs[BKV * D];

  const long long bh = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = row < nq;
  const T* qrow = q + (bh * nq + (valid ? row : 0)) * D;
  const T* kb = k + bh * nk * D;
  const T* vb = v + bh * nk * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = valid ? to_f32(qrow[c]) * scale_log2 : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;  // running max, base-2 units
  float l = 0.f;            // running sum of exp2(s - m)

  for (long long kv0 = 0; kv0 < nk; kv0 += BKV) {
    const long long left = nk - kv0;
    const int n_valid = left < BKV ? static_cast<int>(left) : BKV;
    __syncthreads();  // the previous tile is no longer read
    const T* kt = kb + kv0 * D;
    const T* vt = vb + kv0 * D;
    for (int i = threadIdx.x; i < BKV * D; i += kThreads) {
      const bool in = (i / D) < n_valid;
      ks[i] = in ? to_f32(kt[i]) : 0.f;
      vs[i] = in ? to_f32(vt[i]) : 0.f;
    }
    __syncthreads();

    float s[BKV];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 kk = kr[c4];
        dot = fmaf(qr[4 * c4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
      }
      s[j] = j < n_valid ? dot : -CUDART_INF_F;
      m_new = fmaxf(m_new, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite here and
    // exp2(-inf) = 0 clears the (empty) state on the first tile.
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
      }
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / l;
    T* orow = out + (bh * nq + row) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = from_f32<T>(acc[c] * inv);
    lse[bh * nq + row] = (m + log2f(l)) * kLn2;
  }
}

template <typename T, int D, int BKV>
void launch(const void* q, const void* k, const void* v, void* out, void* lse, long long bh,
            long long nq, long long nk, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nq + kThreads - 1) / kThreads),
                  static_cast<unsigned>(bh));
  flash_fwd_kernel<T, D, BKV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), nq, nk, scale * kLog2e);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Returns a cudaError_t.
extern "C" int hvc_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, long long bh, long long nq, long long nk,
                                       int head_dim, int dtype, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || (nq + kThreads - 1) / kThreads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32) {
    launch<float, 32, 64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else if (dtype == 0 && head_dim == 64) {
    launch<float, 64, 32>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else if (dtype == 1 && head_dim == 32) {
    launch<__nv_bfloat16, 32, 64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    launch<__nv_bfloat16, 64, 32>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
