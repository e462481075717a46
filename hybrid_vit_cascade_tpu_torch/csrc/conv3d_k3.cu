// Kernels B and C: 3×3×3 convolution forward, stride 1 and stride 2, for
// Hopper (sm_90a).
//
// Replaces hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py::_conv_fwd (kernel
// bodies _conv_kernel_smallcin, _conv_kernel_ztriple, _conv_kernel) and
// hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py::_conv_fwd_s2 (kernel body
// _fwd_kernel). Semantics are those of F.conv3d(x, w, b, stride=S, padding=1)
// on NCDHW input with OIDHW weights, for any D, H and W: zero padding in all
// three dims (the dense path; the TPU kernels take inputs pre-haloed in D
// because the slab bodies feed them). fp32 bias and accumulation; output in
// the input dtype.
//
// Not carried over: the TPU kernels' flat (H·W)-lane layout and its lane-block
// sizing (_lane_block), the selection-matrix even/odd lane packing of the
// stride-2 kernel (_sel_matrix) — a strided shared-memory read does the same
// here — and _erf_f32 (the chain's gelu prologue is not part of this kernel;
// it exists in JAX because Mosaic lacks erf).
//
// What bounds it on this card: the hot call is 64→32 channels at 256³
// (1.86 TFLOP per call), so the conv is compute-bound; the 1-channel-input
// calls at 256³ (1→32, 1→64) are bound by writing their 32/64-channel
// outputs. This first version computes with fp32 FMAs on the CUDA cores, not
// with the tensor cores (an implicit GEMM on wgmma is later work). Design
// against that bound: one output voxel per thread and CO_T = 32 output
// channels per block held in registers; per chunk of CI_C input channels the
// block stages the input patch (with its halo, zero-filled at the borders)
// and the chunk's weights in shared memory, both converted to fp32 once. The
// weights are stored [ci][tap][co] so each tap's 32 output channels are read
// as eight float4 broadcasts: four FMAs per shared-memory load. Input
// channels with cin < 4 take a CI_C = 1 variant so the 1-channel stems do no
// zero work.
//
// Layout: x (B, Cin, D, H, W), w (Cout, Cin, 3, 3, 3) in x's dtype, bias
// (Cout,) fp32, out (B, Cout, Do, Ho, Wo) with Do = (D - 1) / S + 1 (likewise
// Ho, Wo). All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCoTile = 32;  // output channels per block

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

template <typename T, int S, int TH, int TW, int CI_C>
__global__ void __launch_bounds__(TH * TW)
conv3d_k3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int cin, int cout, int D,
                 int H, int W, int Do, int Ho, int Wo, int n_co_groups) {
  constexpr int NT = TH * TW;
  constexpr int PH = (TH - 1) * S + 3;
  constexpr int PW = (TW - 1) * S + 3;
  constexpr int PATCH = 3 * PH * PW;
  constexpr int WCHUNK = CI_C * 27 * kCoTile;
  __shared__ float xs[CI_C * PATCH];
  __shared__ __align__(16) float ws[WCHUNK];

  const int tiles_w = (Wo + TW - 1) / TW;
  const int tile_h = blockIdx.x / tiles_w;
  const int tile_w = blockIdx.x % tiles_w;
  const int od = blockIdx.y;
  const int b = blockIdx.z / n_co_groups;
  const int co0 = (blockIdx.z % n_co_groups) * kCoTile;
  const int ty = threadIdx.x / TW;
  const int tx = threadIdx.x % TW;
  const int oh = tile_h * TH + ty;
  const int ow = tile_w * TW + tx;
  // input coordinates of the patch origin (padding 1)
  const int id0 = od * S - 1;
  const int ih0 = tile_h * TH * S - 1;
  const int iw0 = tile_w * TW * S - 1;

  const long long plane = static_cast<long long>(H) * W;
  const long long vol = static_cast<long long>(D) * plane;
  const T* xb = x + static_cast<long long>(b) * cin * vol;

  float acc[kCoTile];
#pragma unroll
  for (int co = 0; co < kCoTile; ++co) acc[co] = (co0 + co < cout) ? bias[co0 + co] : 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += CI_C) {
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < CI_C * PATCH; i += NT) {
      const int cl = i / PATCH;
      const int r = i - cl * PATCH;
      const int pd = r / (PH * PW);
      const int r2 = r - pd * (PH * PW);
      const int ph = r2 / PW;
      const int pw = r2 - ph * PW;
      const int ci = ci0 + cl;
      const int id = id0 + pd;
      const int ih = ih0 + ph;
      const int iw = iw0 + pw;
      float val = 0.f;
      if (ci < cin && id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W)
        val = to_f32(xb[ci * vol + id * plane + static_cast<long long>(ih) * W + iw]);
      xs[i] = val;
    }
    for (int i = threadIdx.x; i < WCHUNK; i += NT) {
      const int co = i % kCoTile;
      const int t = i / kCoTile;
      const int tap = t % 27;
      const int ci = ci0 + t / 27;
      const int oc = co0 + co;
      ws[i] = (ci < cin && oc < cout)
                  ? to_f32(w[(static_cast<long long>(oc) * cin + ci) * 27 + tap])
                  : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int cl = 0; cl < CI_C; ++cl) {
      const float* xp = xs + cl * PATCH + (ty * S) * PW + tx * S;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float xv = xp[kd * PH * PW + kh * PW + kw];
            const float4* wr = reinterpret_cast<const float4*>(
                ws + (cl * 27 + kd * 9 + kh * 3 + kw) * kCoTile);
#pragma unroll
            for (int c4 = 0; c4 < kCoTile / 4; ++c4) {
              const float4 ww = wr[c4];
              acc[4 * c4 + 0] = fmaf(xv, ww.x, acc[4 * c4 + 0]);
              acc[4 * c4 + 1] = fmaf(xv, ww.y, acc[4 * c4 + 1]);
              acc[4 * c4 + 2] = fmaf(xv, ww.z, acc[4 * c4 + 2]);
              acc[4 * c4 + 3] = fmaf(xv, ww.w, acc[4 * c4 + 3]);
            }
          }
        }
      }
    }
  }

  if (oh < Ho && ow < Wo) {
    const long long oplane = static_cast<long long>(Ho) * Wo;
    const long long ovol = static_cast<long long>(Do) * oplane;
    T* ob = out + (static_cast<long long>(b) * cout + co0) * ovol + od * oplane +
            static_cast<long long>(oh) * Wo + ow;
#pragma unroll
    for (int co = 0; co < kCoTile; ++co)
      if (co0 + co < cout) ob[co * ovol] = from_f32<T>(acc[co]);
  }
}

template <typename T, int S, int TH, int TW, int CI_C>
int launch(const void* x, const void* w, const void* bias, void* out, long long batch, int cin,
           int cout, int D, int H, int W, int Do, int Ho, int Wo, cudaStream_t stream) {
  const int n_co_groups = (cout + kCoTile - 1) / kCoTile;
  const long long tiles =
      static_cast<long long>((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  if (tiles > 2147483647LL || Do > 65535 || batch * n_co_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(Do),
                  static_cast<unsigned>(batch * n_co_groups));
  conv3d_k3_kernel<T, S, TH, TW, CI_C><<<grid, TH * TW, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), cin, cout, D, H, W, Do, Ho, Wo, n_co_groups);
  return static_cast<int>(cudaGetLastError());
}

// Tiles: stride 1 uses 8×32 output voxels per block (256 threads); stride 2
// uses 8×16 (128 threads), which keeps its 2×-wider input patch under the
// 48 KB of static shared memory.
template <int S>
int dispatch(const void* x, const void* w, const void* bias, void* out, long long batch,
             int cin, int cout, int D, int H, int W, int dtype, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || D <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Do = (D - 1) / S + 1;
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  constexpr int TH = 8;
  constexpr int TW = S == 1 ? 32 : 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small_cin = cin < 4;
  if (dtype == 0) {
    return small_cin
               ? launch<float, S, TH, TW, 1>(x, w, bias, out, batch, cin, cout, D, H, W, Do, Ho, Wo, s)
               : launch<float, S, TH, TW, 4>(x, w, bias, out, batch, cin, cout, D, H, W, Do, Ho, Wo, s);
  }
  if (dtype == 1) {
    return small_cin
               ? launch<__nv_bfloat16, S, TH, TW, 1>(x, w, bias, out, batch, cin, cout, D, H, W, Do, Ho, Wo, s)
               : launch<__nv_bfloat16, S, TH, TW, 4>(x, w, bias, out, batch, cin, cout, D, H, W, Do, Ho, Wo, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int hvc_conv3d_k3s1_fwd(const void* x, const void* w, const void* bias, void* out,
                                   long long batch, int cin, int cout, int D, int H, int W,
                                   int dtype, void* stream) {
  return dispatch<1>(x, w, bias, out, batch, cin, cout, D, H, W, dtype, stream);
}

extern "C" int hvc_conv3d_k3s2_fwd(const void* x, const void* w, const void* bias, void* out,
                                   long long batch, int cin, int cout, int D, int H, int W,
                                   int dtype, void* stream) {
  return dispatch<2>(x, w, bias, out, batch, cin, cout, D, H, W, dtype, stream);
}
