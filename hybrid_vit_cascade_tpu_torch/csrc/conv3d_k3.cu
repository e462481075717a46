// Kernels B and C: 3×3×3 convolution forward, stride 1 and stride 2, and
// their chain forms H (stride 1) and I (stride 2), for Hopper (sm_90a).
//
// Replaces hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py::_conv_fwd (kernel
// bodies _conv_kernel_smallcin, _conv_kernel_ztriple, _conv_kernel, with the
// chain options window / vp / want_sums / act / dact of _stitch_z and
// _emit_out) and hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py::
// _conv_fwd_s2 (kernel body _fwd_kernel, with window / want_sums / act).
//
// One template serves the dense conv and the slab-chain conv. Output plane od
// reads planes S·od + {0, 1, 2} of a virtual D-slab; slab plane q is plane
// q − qlo of the input view x, which holds nv planes and may be a D-narrowed
// view of a larger tensor (batch and channel strides are arguments). Planes
// outside the view read as zeros: that is the chain's valid-plane window (the
// dense path's per-conv zero padding), applied at the load, so no padded or
// rolled copy of the source is made. H and W are SAME (padding 1). The dense
// SAME conv is the chain conv with qlo = 1 over a view of all D planes.
// fp32 bias and accumulation; output in the input dtype.
//
// Chain options (CHAIN = true only; the dense instantiation compiles them
// out):
//   act      gelu (erf form) or silu applied to each loaded input value in
//            fp32 and rounded back to the operand type before the products,
//            as _pact does; act(0) = 0, so masked planes stay zero.
//   dact     the backward of a fused prologue, as the stride-1 data gradient
//            runs it: the fp32 result is multiplied by act′(x) at the output
//            voxel (x given with its own strides) before rounding.
//   sums     per-(batch, output channel) fp32 Σ and Σ² of the rounded output
//            (GroupNorm statistics): each block writes its partials, a second
//            kernel adds them in a fixed order (deterministic, no atomics).
//
// Not carried over: the TPU kernels' flat (H·W)-lane layout and lane-block
// sizing (_lane_block), the z-stitch scratch, the selection-matrix even/odd
// lane packing of the stride-2 kernel (_sel_matrix; a strided shared-memory
// read does the same here), and _erf_f32 (Mosaic has no erf; CUDA has erff).
//
// What bounds it on this card: the hot call is 64→32 channels at 256³
// (1.86 TFLOP per call), so the conv is compute-bound; the 1-channel-input
// calls at 256³ (1→32, 1→64) are bound by writing their 32/64-channel
// outputs. This first version computes with fp32 FMAs on the CUDA cores, not
// with the tensor cores (an implicit GEMM on wgmma is later work). Design
// against that bound: one output voxel per thread and CO_T = 32 output
// channels per block held in registers; per chunk of CI_C input channels the
// block stages the input patch (with its halo, zero-filled outside the view
// and the H/W borders, the prologue applied once per staged value) and the
// chunk's weights in shared memory, both converted to fp32 once. The
// weights are stored [ci][tap][co] so each tap's 32 output channels are read
// as eight float4 broadcasts: four FMAs per shared-memory load. Input
// channels with cin < 4 take a CI_C = 1 variant so the 1-channel stems do no
// zero work, and a one-output-channel variant (CO_T = 1, stride 1) serves the
// data gradient of the 1→C convs, which kernel B computes with Cout = 1. The
// sums epilogue costs a warp-shuffle reduction per channel, small beside the
// 27·Cin FMAs per output value except at Cin = 1.
//
// Layout: x view (B, Cin, nv, H, W) with element strides xb (batch), xc
// (channel), H·W (plane), W, 1; w (Cout, Cin, 3, 3, 3) in x's dtype, bias
// (Cout,) fp32, out (B, Cout, Do, Ho, Wo) contiguous with Ho = (H − 1)/S + 1
// (likewise Wo). All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCoTile = 32;  // output channels per block (the CO_T = 1 variant aside)

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

// act codes: 0 none, 1 gelu (erf form), 2 silu
__device__ __forceinline__ float act_f32(int act, float v) {
  if (act == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (act == 2) return v / (1.f + expf(-v));
  return v;
}

__device__ __forceinline__ float dact_f32(int act, float v) {
  if (act == 1)
    return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
           v * 0.3989422804014327f * expf(-0.5f * v * v);
  const float s = 1.f / (1.f + expf(-v));
  return s * (1.f + v * (1.f - s));
}

struct ChainArgs {
  long long xb, xc;    // element strides of the input view's batch and channel dims
  int nv, qlo;         // planes in the view; slab plane of view plane 0
  int act;             // prologue
  int dact;            // epilogue act′ kind (with dact_x)
  const void* dact_x;  // x at the output's geometry, strides db, dc
  long long db, dc;
  float* partial;      // [b][co][block][2] or nullptr
};

template <typename T, int S, int TH, int TW, int CI_C, int CO_T, bool CHAIN>
__global__ void __launch_bounds__(TH * TW)
conv3d_k3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int cin, int cout,
                 int H, int W, int Do, int Ho, int Wo, int n_co_groups, ChainArgs ca) {
  constexpr int NT = TH * TW;
  constexpr int PH = (TH - 1) * S + 3;
  constexpr int PW = (TW - 1) * S + 3;
  constexpr int PATCH = 3 * PH * PW;
  constexpr int WCHUNK = CI_C * 27 * CO_T;
  __shared__ float xs[CI_C * PATCH];
  __shared__ __align__(16) float ws[WCHUNK];

  const int tiles_w = (Wo + TW - 1) / TW;
  const int tile_h = blockIdx.x / tiles_w;
  const int tile_w = blockIdx.x % tiles_w;
  const int od = blockIdx.y;
  const int b = blockIdx.z / n_co_groups;
  const int co0 = (blockIdx.z % n_co_groups) * CO_T;
  const int ty = threadIdx.x / TW;
  const int tx = threadIdx.x % TW;
  const int oh = tile_h * TH + ty;
  const int ow = tile_w * TW + tx;
  // view plane and input row/column of the patch origin (padding 1 in H, W)
  const int p0 = od * S - ca.qlo;
  const int ih0 = tile_h * TH * S - 1;
  const int iw0 = tile_w * TW * S - 1;

  const long long plane = static_cast<long long>(H) * W;
  const T* xb = x + static_cast<long long>(b) * ca.xb;

  float acc[CO_T];
#pragma unroll
  for (int co = 0; co < CO_T; ++co) acc[co] = (co0 + co < cout) ? bias[co0 + co] : 0.f;

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
      const int p = p0 + pd;
      const int ih = ih0 + ph;
      const int iw = iw0 + pw;
      float val = 0.f;
      if (ci < cin && p >= 0 && p < ca.nv && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        val = to_f32(xb[ci * ca.xc + p * plane + static_cast<long long>(ih) * W + iw]);
        if constexpr (CHAIN) {
          if (ca.act) val = to_f32(from_f32<T>(act_f32(ca.act, val)));
        }
      }
      xs[i] = val;
    }
    for (int i = threadIdx.x; i < WCHUNK; i += NT) {
      const int co = i % CO_T;
      const int t = i / CO_T;
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
            const float* wt = ws + (cl * 27 + kd * 9 + kh * 3 + kw) * CO_T;
            if constexpr (CO_T % 4 == 0) {
              const float4* wr = reinterpret_cast<const float4*>(wt);
#pragma unroll
              for (int c4 = 0; c4 < CO_T / 4; ++c4) {
                const float4 ww = wr[c4];
                acc[4 * c4 + 0] = fmaf(xv, ww.x, acc[4 * c4 + 0]);
                acc[4 * c4 + 1] = fmaf(xv, ww.y, acc[4 * c4 + 1]);
                acc[4 * c4 + 2] = fmaf(xv, ww.z, acc[4 * c4 + 2]);
                acc[4 * c4 + 3] = fmaf(xv, ww.w, acc[4 * c4 + 3]);
              }
            } else {
#pragma unroll
              for (int co = 0; co < CO_T; ++co) acc[co] = fmaf(xv, wt[co], acc[co]);
            }
          }
        }
      }
    }
  }

  const bool inside = oh < Ho && ow < Wo;
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long opix = od * oplane + static_cast<long long>(oh) * Wo + ow;
  if constexpr (!CHAIN) {
    if (inside) {
      const long long ovol = static_cast<long long>(Do) * oplane;
      T* ob = out + (static_cast<long long>(b) * cout + co0) * ovol + opix;
#pragma unroll
      for (int co = 0; co < CO_T; ++co)
        if (co0 + co < cout) ob[co * ovol] = from_f32<T>(acc[co]);
    }
  } else {
    const long long ovol = static_cast<long long>(Do) * oplane;
    if (inside) {
      T* ob = out + (static_cast<long long>(b) * cout + co0) * ovol + opix;
      const T* dx = static_cast<const T*>(ca.dact_x);
#pragma unroll
      for (int co = 0; co < CO_T; ++co) {
        if (co0 + co >= cout) continue;
        float a = acc[co];
        if (ca.dact)
          a *= dact_f32(ca.dact,
                        to_f32(dx[static_cast<long long>(b) * ca.db + (co0 + co) * ca.dc + opix]));
        const T rounded = from_f32<T>(a);
        ob[co * ovol] = rounded;
        acc[co] = to_f32(rounded);  // the value the statistics see
      }
    }
    if (ca.partial != nullptr) {  // block-uniform branch
      constexpr int NW = NT / 32;
      __shared__ float red[NW][CO_T][2];
      const int lane = threadIdx.x % 32;
      const int warp = threadIdx.x / 32;
#pragma unroll
      for (int co = 0; co < CO_T; ++co) {
        float s = (inside && co0 + co < cout) ? acc[co] : 0.f;
        float q = s * s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (lane == 0) {
          red[warp][co][0] = s;
          red[warp][co][1] = q;
        }
      }
      __syncthreads();
      if (threadIdx.x < 2 * CO_T) {
        const int co = threadIdx.x / 2;
        const int k = threadIdx.x % 2;
        if (co0 + co < cout) {
          float t = 0.f;
#pragma unroll
          for (int wi = 0; wi < NW; ++wi) t += red[wi][co][k];
          const long long nblk = static_cast<long long>(Do) * gridDim.x;
          const long long blk = static_cast<long long>(od) * gridDim.x + blockIdx.x;
          ca.partial[((static_cast<long long>(b) * cout + co0 + co) * nblk + blk) * 2 + k] = t;
        }
      }
    }
  }
}

// sums[k][b·cout + c] = Σ_blk partial[b·cout + c][blk][k], in a fixed order:
// each thread adds a strided share, then a tree over the block's threads.
constexpr int kSumThreads = 256;
__global__ void __launch_bounds__(kSumThreads)
sum_block_partials_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                          long long nblk, int n_rows) {
  __shared__ float red[2][kSumThreads];
  const int row = blockIdx.x;
  const float* pr = partial + static_cast<long long>(row) * nblk * 2;
  float s = 0.f, q = 0.f;
  for (long long i = threadIdx.x; i < nblk; i += kSumThreads) {
    s += pr[2 * i];
    q += pr[2 * i + 1];
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = q;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red[0][threadIdx.x] += red[0][threadIdx.x + half];
      red[1][threadIdx.x] += red[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[row] = red[0][0];
    sums[n_rows + row] = red[1][0];
  }
}

template <typename T, int S, int TH, int TW, int CI_C, int CO_T, bool CHAIN>
int launch(const void* x, const void* w, const void* bias, void* out, long long batch, int cin,
           int cout, int H, int W, int Do, int Ho, int Wo, const ChainArgs& ca,
           float* sums, cudaStream_t stream) {
  const int n_co_groups = (cout + CO_T - 1) / CO_T;
  const long long tiles =
      static_cast<long long>((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  if (tiles > 2147483647LL || Do > 65535 || batch * n_co_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(Do),
                  static_cast<unsigned>(batch * n_co_groups));
  conv3d_k3_kernel<T, S, TH, TW, CI_C, CO_T, CHAIN><<<grid, TH * TW, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), cin, cout, H, W, Do, Ho, Wo, n_co_groups, ca);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ca.partial == nullptr) return static_cast<int>(e);
  const long long rows = batch * cout;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  sum_block_partials_kernel<<<static_cast<unsigned>(rows), kSumThreads, 0, stream>>>(
      ca.partial, sums, static_cast<long long>(Do) * tiles, static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}

// Tiles: stride 1 uses 8×32 output voxels per block (256 threads); stride 2
// uses 8×16 (128 threads), which keeps its 2×-wider input patch under the
// 48 KB of static shared memory.
template <int S, bool CHAIN, typename T>
int dispatch_t(const void* x, const void* w, const void* bias, void* out, long long batch,
               int cin, int cout, int H, int W, int Do, const ChainArgs& ca, float* sums,
               cudaStream_t s) {
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  constexpr int TH = 8;
  constexpr int TW = S == 1 ? 32 : 16;
  if constexpr (S == 1) {
    if (cout == 1 && cin >= 4)
      return launch<T, S, TH, TW, 4, 1, CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do, Ho,
                                               Wo, ca, sums, s);
  }
  if (cin < 4)
    return launch<T, S, TH, TW, 1, kCoTile, CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do,
                                                   Ho, Wo, ca, sums, s);
  return launch<T, S, TH, TW, 4, kCoTile, CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do,
                                                 Ho, Wo, ca, sums, s);
}

template <int S>
int dispatch(const void* x, const void* w, const void* bias, void* out, long long batch,
             int cin, int cout, int nv, int H, int W, int Do, int qlo, long long xb,
             long long xc, int act, int dact, const void* dact_x, long long db, long long dc,
             void* partial, void* sums, int dtype, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || nv < 0 || H <= 0 || W <= 0 || Do <= 0 ||
      act < 0 || act > 2 || dact < 0 || dact > 2 || (dact != 0) != (dact_x != nullptr) ||
      (partial == nullptr) != (sums == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChainArgs ca{xb, xc, nv, qlo, act, dact, dact_x, db, dc, static_cast<float*>(partial)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sm = static_cast<float*>(sums);
  const bool chain = act != 0 || dact != 0 || partial != nullptr;
  if (dtype == 0)
    return chain ? dispatch_t<S, true, float>(x, w, bias, out, batch, cin, cout, H, W, Do, ca, sm, s)
                 : dispatch_t<S, false, float>(x, w, bias, out, batch, cin, cout, H, W, Do, ca, sm, s);
  if (dtype == 1)
    return chain ? dispatch_t<S, true, __nv_bfloat16>(x, w, bias, out, batch, cin, cout, H, W, Do, ca, sm, s)
                 : dispatch_t<S, false, __nv_bfloat16>(x, w, bias, out, batch, cin, cout, H, W, Do, ca, sm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Kernels B/H (stride 1) and C/I (stride 2). x is the input view (nv planes,
// batch/channel strides xb/xc); output plane od of `out` (B, Cout, Do, Ho, Wo)
// reads view planes S·od + {0,1,2} − qlo. act: prologue (0 none, 1 gelu,
// 2 silu); dact/dact_x/db/dc: act′ epilogue; partial (B·Cout·Do·tiles·2 fp32
// scratch) and sums (2 × B·Cout fp32): the Σ/Σ² epilogue, both null without
// it. With act, dact and partial all unset the dense kernel runs.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int hvc_conv3d_k3s1_fwd(const void* x, const void* w, const void* bias, void* out,
                                   long long batch, int cin, int cout, int nv, int H, int W,
                                   int Do, int qlo, long long xb, long long xc, int act, int dact,
                                   const void* dact_x, long long db, long long dc, void* partial,
                                   void* sums, int dtype, void* stream) {
  return dispatch<1>(x, w, bias, out, batch, cin, cout, nv, H, W, Do, qlo, xb, xc, act, dact,
                     dact_x, db, dc, partial, sums, dtype, stream);
}

extern "C" int hvc_conv3d_k3s2_fwd(const void* x, const void* w, const void* bias, void* out,
                                   long long batch, int cin, int cout, int nv, int H, int W,
                                   int Do, int qlo, long long xb, long long xc, int act, int dact,
                                   const void* dact_x, long long db, long long dc, void* partial,
                                   void* sums, int dtype, void* stream) {
  if (dact != 0) return static_cast<int>(cudaErrorInvalidValue);  // stride-1 dgrad only
  return dispatch<2>(x, w, bias, out, batch, cin, cout, nv, H, W, Do, qlo, xb, xc, act, dact,
                     dact_x, db, dc, partial, sums, dtype, stream);
}
