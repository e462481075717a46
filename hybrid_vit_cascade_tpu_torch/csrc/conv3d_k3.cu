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
// (1.86 TFLOP per call, forward or as the 32→64-channel data gradient), so
// the conv is compute-bound; the 1-channel-input calls at 256³ (1→32, 1→64)
// are bound by writing their 32/64-channel outputs, and their data gradient
// (32/64 → 1 channel) by reading g. The instances are picked by explicit
// rules (no fallback): bf16 with Cin ≥ 8 and Cout ≥ 8 takes the tensor cores
// (fwd_uses_tc, which the wrapper reads through hvc_conv3d_k3_fwd_tc), and
// so does the bf16 stride-1 call with one output channel and 8 ≤ Cin ≤ 64,
// the one-output-channel data gradient (c1_uses_tc, read through
// hvc_conv3d_k3s1_c1_tc: conv_c1_tc_kernel below), and so does the bf16
// call with one input channel, Cout ≥ 8 and no act′ epilogue, the forward of
// the 1→32 / 1→64 convs at stride 1 and of stage 1's 1→64 stem at stride 2
// (c1in_uses_tc, read through hvc_conv3d_k3s{1,2}_c1in_tc:
// conv_c1in_tc_kernel and conv_c1in_s2_tc_kernel below); fp32 (the tensor
// cores would mean TF32, outside the fp32 tolerances) takes the CUDA cores.
//
// B/H on the tensor cores (conv_tc_kernel): the implicit GEMM out[co, voxel]
// = Σ_{tap, ci} w_tap[co, ci] · x_tap[ci, voxel] with M = Cout (32 a block,
// masked at the tile), N = output voxels, K = Cin × 27 taps, on mma.sync
// m16n8k16 bf16 → fp32, the orientation PR 5's probe V3' sustained at 424.5
// TF/s (Cout = 32 as M, K = Cin per tap). mma.sync, not wgmma: wgmma's
// 64-row M would waste half of a 32-channel Cout tile, and at 8 warps the
// per-warp shared-memory operands already keep the tensor cores fed. A block
// computes 4 planes × 4 rows × 32 columns of output voxels (512) and walks
// Cin in chunks of 16 (one k16 step per tap); its input patch, 6 × 6 × 34
// positions (2.4× the tile's voxels), is staged channels-innermost,
// [position][16 ci] in 48-byte rows, so a tap is a per-lane row offset of an
// ldmatrix B load (8 neighbouring positions are 8 different bank groups) and
// every row stays 16-byte aligned however the tap shifts the input along W.
// The staging reads x with one 2-byte load per (position, channel) —
// neighbouring threads take neighbouring columns, so a warp reads whole row
// segments of any alignment — replays the act prologue in fp32 rounded to
// bf16, packs 8 channels and stores 16 bytes. The chunk's weights sit beside
// the patch as [tap][co][16 ci] (the A operand, ldmatrix). Warp w owns plane
// w / 2, rows 2·(w % 2) + {0, 1}, all 32 columns: 32 co × 64 voxels, 64 fp32
// accumulators a thread, and per tap 2 A and 4 B ldmatrix.x4 for 16 mma.
// The accumulators run the whole K (≤ 6,912 products a value; no flush).
// 100 KB of shared memory and ≤ 128 registers a thread keep two blocks on
// an SM, so one block's staging runs under the other's products. Epilogue
// on the fragments: bias, act′(x) at the voxel (dact), round to bf16, store
// (pairs of columns as one 32-bit store where Wo is even); Σ/Σ² of the
// rounded values by quad shuffles, then the 8 warps in order through shared
// memory, one partial per block.
//
// B/H/C/I on the CUDA cores (conv3d_k3_kernel): one output voxel per thread
// and CO_T = 32 output channels per block held in registers, fp32 FMAs; per
// chunk of CI_C input channels the block stages the input patch (with its
// halo, zero-filled outside the view and the H/W borders, the prologue
// applied once per staged value) and the chunk's weights in shared memory,
// both converted to fp32 once. The
// weights are stored [ci][tap][co] so each tap's 32 output channels are read
// as eight float4 broadcasts: four FMAs per shared-memory load. Input
// channels with cin < 4 take a CI_C = 1 variant so the fp32 1-channel stems
// do no zero work, and a one-output-channel variant (CO_T = 1, stride 1) serves the
// fp32 data gradient of the 1→C convs, which kernel B computes with Cout = 1
// (the bf16 one takes conv_c1_tc_kernel). The
// sums epilogue costs a warp-shuffle reduction per channel, small beside the
// 27·Cin FMAs per output value except at Cin = 1.
//
// Layout: x view (B, Cin, nv, H, W) with element strides xb (batch), xc
// (channel), H·W (plane), W, 1; w (Cout, Cin, 3, 3, 3) in x's dtype, bias
// (Cout,) fp32, out (B, Cout, Do, Ho, Wo) contiguous with Ho = (H − 1)/S + 1
// (likewise Wo). All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

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

// ------------------------------------------- B and H on the tensor cores ---

constexpr int kTcThreads = 256;                  // 8 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcCo = 32;                        // output channels per block: M
constexpr int kTcCi = 16;                        // input channels per chunk: one k16 step a tap
constexpr int kTcTd = 4, kTcTh = 4, kTcTw = 32;  // output voxels per block: 512
constexpr int kTcPd = kTcTd + 2, kTcPh = kTcTh + 2, kTcPw = kTcTw + 2;
constexpr int kTcPos = kTcPd * kTcPh * kTcPw;    // patch positions: 1,224
constexpr int kTcLd = kTcCi + 8;                 // bf16 per patch position and weight row: 48
                                                 // bytes, three 16-byte units, so 8 neighbouring
                                                 // rows hit 8 different bank groups
constexpr int kTcPatch = kTcPos * kTcLd;         // bf16, [position][ci]
constexpr int kTcWts = 27 * kTcCo * kTcLd;       // bf16, [tap][co][ci]
constexpr int kTcSmem = (kTcPatch + kTcWts) * 2; // 100,224 bytes: two blocks an SM

__device__ __forceinline__ unsigned short act_bits(int act, unsigned short u) {
  const float v = act_f32(act, __bfloat162float(__ushort_as_bfloat16(u)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t act_bf16x2(int act, uint32_t w) {
  const float lo = act_f32(act, __uint_as_float(w << 16));
  const float hi = act_f32(act, __uint_as_float(w & 0xffff0000u));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Block (blockIdx.x, blockIdx.y): Cout tile blockIdx.x % n_co (fastest, so
// the Cout tiles of one voxel tile run together and share its patch in L2),
// voxel tile blockIdx.x / n_co (W fastest, then H, then D: neighbouring
// blocks share halo rows in L2), batch blockIdx.y.
template <bool CHAIN>
__global__ void __launch_bounds__(kTcThreads, 2)
conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int cin, int cout,
               int H, int W, int Do, int n_co, ChainArgs ca) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* patch = reinterpret_cast<bf16*>(smem_raw);
  bf16* wts = patch + kTcPatch;
  __shared__ float red[kTcWarps][kTcCo][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = H, Wo = W;
  const int tiles_w = (Wo + kTcTw - 1) / kTcTw;
  const int tiles_h = (Ho + kTcTh - 1) / kTcTh;
  const int co0 = static_cast<int>(blockIdx.x % n_co) * kTcCo;
  const int tile = static_cast<int>(blockIdx.x / n_co);
  const int od0 = tile / (tiles_w * tiles_h) * kTcTd;
  const int oh0 = tile / tiles_w % tiles_h * kTcTh;
  const int ow0 = tile % tiles_w * kTcTw;
  const long long b = blockIdx.y;
  const long long plane = static_cast<long long>(H) * W;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + b * ca.xb;
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(w);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(wts);

  // warp w: output plane w / 2, rows 2·(w % 2) + {0, 1}, columns 0-31, as four
  // groups of 16 voxels (group g: row g / 2, columns 16·(g % 2) + 0-15). This
  // lane's row of the B loads: voxel ln of a group, channels lk … lk + 7.
  const int vz = warp >> 1, vy0 = (warp & 1) * 2;
  const int ln = (lane & 7) + ((lane >> 4) << 3);
  const int lk = ((lane >> 3) & 1) * 8;
  const bf16* brow[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    brow[g] = patch + ((vz * kTcPh + vy0 + (g >> 1)) * kTcPw + (g & 1) * 16 + ln) * kTcLd + lk;

  float acc[2][8][4];  // [16-row co tile][8-voxel column tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kTcCi) {
    __syncthreads();  // the previous chunk's patch and weights are no longer read
    // the patch, zero outside the view's planes, the image and Cin; the
    // prologue applied (act(0) = 0 keeps the padding)
    for (int pos = tid; pos < kTcPos; pos += kTcThreads) {
      const int pw = pos % kTcPw;
      const int ph = pos / kTcPw % kTcPh;
      const int pd = pos / (kTcPw * kTcPh);
      const int p = od0 - ca.qlo + pd, ih = oh0 - 1 + ph, iw = ow0 - 1 + pw;
      const bool ok = p >= 0 && p < ca.nv && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const unsigned short* src = xb + (ok ? p * plane + static_cast<long long>(ih) * W + iw : 0);
      // all 16 loads first, in flight together; the prologue after them (a
      // branch between the loads would serialize them)
      unsigned short u[kTcCi];
#pragma unroll
      for (int c = 0; c < kTcCi; ++c) u[c] = ok && ci0 + c < cin ? src[(ci0 + c) * ca.xc] : 0;
      if constexpr (CHAIN) {
        if (ca.act) {
#pragma unroll
          for (int c = 0; c < kTcCi; ++c) u[c] = act_bits(ca.act, u[c]);
        }
      }
      uint32_t v[kTcCi / 2];
#pragma unroll
      for (int i = 0; i < kTcCi / 2; ++i)
        v[i] = static_cast<uint32_t>(u[2 * i]) | (static_cast<uint32_t>(u[2 * i + 1]) << 16);
      uint4* dst = reinterpret_cast<uint4*>(patch + pos * kTcLd);
      dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
      dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
    // the chunk's weights, [tap][co][ci], zero outside Cout and Cin
    for (int u = tid; u < kTcCo * kTcCi; u += kTcThreads) {
      const int k = u % kTcCi, co = u / kTcCi;
      const int ci = ci0 + k, oc = co0 + co;
      const bool ok = ci < cin && oc < cout;
      const unsigned short* src = wg + (ok ? (static_cast<long long>(oc) * cin + ci) * 27 : 0);
#pragma unroll
      for (int tap = 0; tap < 27; ++tap)
        wsm[(tap * kTcCo + co) * kTcLd + k] = ok ? src[tap] : 0;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int toff = (((tap / 9) * kTcPh + (tap / 3) % 3) * kTcPw + tap % 3) * kTcLd;
      uint32_t a[2][4];
      load_a(a[0], wts + tap * kTcCo * kTcLd, kTcLd, 0, 0, lane);
      load_a(a[1], wts + tap * kTcCo * kTcLd, kTcLd, 16, 0, lane);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t r[4];
        ldsm_x4(r, brow[g] + toff);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * g], a[mt], r[0], r[1]);
          mma16816(acc[mt][2 * g + 1], a[mt], r[2], r[3]);
        }
      }
    }
  }

  // epilogue on the fragments: acc[mt][nt][2·half + j] is output channel
  // co0 + 16·mt + lane / 4 + 8·half at column 8·nt + 2·(lane % 4) + j of the
  // warp's voxels. Bias, then act′ (its loads together, outside any branch
  // per value), then round, store and sum.
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const int od = od0 + vz;
  auto co_of = [&](int mt, int half) { return co0 + mt * 16 + (lane >> 2) + half * 8; };
  auto oh_of = [&](int nt) { return oh0 + vy0 + (nt >> 2); };
  auto ow_of = [&](int nt) { return ow0 + (nt & 3) * 8 + 2 * (lane & 3); };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co_of(mt, half);
      const float bco = co < cout ? bias[co] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][2 * half] += bco;
        acc[mt][nt][2 * half + 1] += bco;
      }
    }
  if constexpr (CHAIN) {
    if (ca.dact) {  // block-uniform branch
      const unsigned short* dxp = static_cast<const unsigned short*>(ca.dact_x);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int co = co_of(mt, half);
          unsigned short xv[8][2];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int oh = oh_of(nt), ow = ow_of(nt);
            const bool row_ok = co < cout && od < Do && oh < Ho;
            const long long off = row_ok ? b * ca.db + co * ca.dc + od * oplane +
                                               static_cast<long long>(oh) * Wo + ow : 0;
            xv[nt][0] = row_ok && ow < Wo ? dxp[off] : 0;
            xv[nt][1] = row_ok && ow + 1 < Wo ? dxp[off + 1] : 0;
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[mt][nt][2 * half + j] *=
                  dact_f32(ca.dact, __bfloat162float(__ushort_as_bfloat16(xv[nt][j])));
        }
    }
  }
  float s1[2][2], s2[2][2];  // this thread's Σ and Σ² per [mt][half]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co_of(mt, half);
      bf16* ob = out + (b * cout + co) * ovol;
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int oh = oh_of(nt), ow = ow_of(nt);
        const bool row_ok = co < cout && od < Do && oh < Ho;
        const bool ok0 = row_ok && ow < Wo, ok1 = row_ok && ow + 1 < Wo;
        const long long opix = od * oplane + static_cast<long long>(oh) * Wo + ow;
        const bf16 r0 = __float2bfloat16_rn(acc[mt][nt][2 * half]);
        const bf16 r1 = __float2bfloat16_rn(acc[mt][nt][2 * half + 1]);
        if (ok1 && (Wo & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(ob + opix) = __halves2bfloat162(r0, r1);
        } else {
          if (ok0) ob[opix] = r0;
          if (ok1) ob[opix + 1] = r1;
        }
        const float f0 = ok0 ? __bfloat162float(r0) : 0.f;  // the values the statistics see
        const float f1 = ok1 ? __bfloat162float(r1) : 0.f;
        s += f0 + f1;
        q += f0 * f0 + f1 * f1;
      }
      s1[mt][half] = s;
      s2[mt][half] = q;
    }
  if constexpr (CHAIN) {
    if (ca.partial != nullptr) {  // block-uniform branch
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s = s1[mt][half], q = s2[mt][half];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {  // the quad: the voxels of this row
            s += __shfl_xor_sync(0xffffffffu, s, off);
            q += __shfl_xor_sync(0xffffffffu, q, off);
          }
          if ((lane & 3) == 0) {
            const int c = mt * 16 + (lane >> 2) + half * 8;
            red[warp][c][0] = s;
            red[warp][c][1] = q;
          }
        }
      __syncthreads();
      if (tid < 2 * kTcCo) {  // the warps in order, one partial per block
        const int c = tid / 2, k = tid % 2;
        if (co0 + c < cout) {
          float t = 0.f;
#pragma unroll
          for (int wi = 0; wi < kTcWarps; ++wi) t += red[wi][c][k];
          const long long nblk = gridDim.x / n_co;
          ca.partial[((b * cout + co0 + c) * nblk + tile) * 2 + k] = t;
        }
      }
    }
  }
}

template <bool CHAIN>
int launch_tc(const void* x, const void* w, const void* bias, void* out, long long batch,
              int cin, int cout, int H, int W, int Do, const ChainArgs& ca, float* sums,
              cudaStream_t stream) {
  const long long tiles = static_cast<long long>((Do + kTcTd - 1) / kTcTd) *
                          ((H + kTcTh - 1) / kTcTh) * ((W + kTcTw - 1) / kTcTw);
  const int n_co = (cout + kTcCo - 1) / kTcCo;
  if (tiles * n_co > 2147483647LL || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = conv_tc_kernel<CHAIN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles * n_co), static_cast<unsigned>(batch)), kTcThreads,
         kTcSmem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                            static_cast<const float*>(bias), static_cast<bf16*>(out), cin, cout,
                            H, W, Do, n_co, ca);
  e = cudaGetLastError();
  if (e != cudaSuccess || ca.partial == nullptr) return static_cast<int>(e);
  const long long rows = batch * cout;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  sum_block_partials_kernel<<<static_cast<unsigned>(rows), kSumThreads, 0, stream>>>(
      ca.partial, sums, tiles, static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------ the one-output-channel B/H on the tensor cores ---

constexpr int kC1Threads = 256;               // 8 warps
constexpr int kC1Warps = kC1Threads / 32;
constexpr int kC1Ci = 64;                     // input channels a block holds: the rule's most
constexpr int kC1Th = 4, kC1Tw = 64;          // output rows × columns per block: one a thread
constexpr int kC1Planes = 32;                 // output planes per block
constexpr int kC1Rows = kC1Th + 2;            // staged rows of a plane: 6
constexpr int kC1Cols = kC1Tw + 16;           // staged columns, from ow0 − 8: 10 vectors of 8
constexpr int kC1Groups = kC1Rows * kC1Cols / 16;  // 16-position groups of the products: 30
constexpr int kC1Ld = kC1Rows * kC1Cols + 8;  // bf16 per staged channel: 976 bytes, an odd
                                              // number of 16-byte units (ldmatrix.trans
                                              // conflict-free)
constexpr int kC1Pw = kC1Tw + 4;              // P columns of a row: staged columns 6 … 73
constexpr int kC1Pt = kC1Rows * kC1Pw;        // P floats per tap: 408 ≡ 24 mod 32, so a
                                              // warp's float2 stores of 4 taps hit 32 banks
constexpr int kC1WLd = kC1Ci + 8;             // bf16 per weight row ([tap][ci]): 144 bytes
constexpr int kC1Smem = kC1Ci * kC1Ld * 2 + 27 * kC1Pt * 4 + 32 * kC1WLd * 2;  // 111,136 bytes:
                                                                                 // two blocks an SM

// out[od, oh, ow] = bias + Σ_tap Σ_ci w[0, ci, tap] · x[ci, od − qlo + kd,
// oh − 1 + kh, ow − 1 + kw] (× act′ at the output with dact), as
// conv3d_k3_kernel computes it with Cout = 1, for 8 ≤ Cin ≤ 64 and neither a
// prologue nor sums (c1_uses_tc). The products are a GEMM with the taps as M
// (27 of 32 rows), positions as N and channels as K: per input plane the
// block stages the plane's 6 rows × 80 columns of every channel as they lie
// ([ci][row][column], 16-byte cp.async from column ow0 − 8, zero outside the
// view, the image and Cin), and each warp computes P[tap, position] for
// 16-position groups, the weights' A fragments held in registers for the
// whole block and the positions' B fragments by ldmatrix.trans of the
// channel rows. P goes to shared memory as fp32 ([tap][row][column]); then
// each thread adds its voxel's 27 shifted values, P[tap][oy + dy][ox + dx],
// in a fixed order (the 9 taps of one dz at a time), into the accumulators of
// the three output planes the input plane reaches (dz = 0, 1, 2). An output
// plane is done after its third input plane: bias, act′, one rounding,
// store. A block walks 32 output planes, so each input plane is staged once
// per block, the next one's copy running under the current one's sums.
// Block blockIdx.x: column tile fastest, then row tile, then plane range;
// batch blockIdx.y. VEC: x's rows and strides are 16-byte aligned (W, xb, xc
// multiples of 8), so the staging copies 16-byte vectors; otherwise it loads
// element by element.
template <bool CHAIN, bool VEC>
__global__ void __launch_bounds__(kC1Threads, 2)
conv_c1_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ out, int cin, int H, int W,
                  int Do, ChainArgs ca) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);              // [ci][row][column]
  float* ps = reinterpret_cast<float*>(gs + kC1Ci * kC1Ld);  // [tap][row][column − 6]
  bf16* ws = reinterpret_cast<bf16*>(ps + 27 * kC1Pt);       // [tap (32)][ci]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_w = (W + kC1Tw - 1) / kC1Tw, tiles_h = (H + kC1Th - 1) / kC1Th;
  const int tile = static_cast<int>(blockIdx.x);
  const int ow0 = tile % tiles_w * kC1Tw;
  const int oh0 = tile / tiles_w % tiles_h * kC1Th;
  const int od0 = tile / (tiles_w * tiles_h) * kC1Planes;
  const long long b = blockIdx.y;
  const int n_out = Do - od0 < kC1Planes ? Do - od0 : kC1Planes;
  const int ks = (cin + 15) / 16;  // k-steps of the products
  const long long plane = static_cast<long long>(H) * W;
  const bf16* xb = x + b * ca.xb;

  // the weights, [tap][ci], zero past tap 26 and Cin; their A fragments stay
  // in registers
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(w);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(ws);
  for (int u = tid; u < 32 * kC1Ci; u += kC1Threads) {
    const int tap = u / kC1Ci, ci = u % kC1Ci;
    wsm[tap * kC1WLd + ci] = tap < 27 && ci < cin ? wg[ci * 27 + tap] : 0;
  }
  __syncthreads();
  uint32_t a[4][2][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (kk < ks) load_a(a[kk][mt], ws, kC1WLd, mt * 16, kk * 16, lane);

  // view plane p (inside the view) into gs: units of 8 columns of one row of
  // one channel
  auto stage = [&](int p) {
    const int units = ks * 16 * kC1Rows * (kC1Cols / 8);
    for (int u = tid; u < units; u += kC1Threads) {
      const int v = u % (kC1Cols / 8), r = u / (kC1Cols / 8) % kC1Rows;
      const int ci = u / (kC1Rows * (kC1Cols / 8));
      const int ih = oh0 - 1 + r, c = ow0 - 8 + 8 * v;
      const bool row_ok = ci < cin && ih >= 0 && ih < H;
      bf16* dst = gs + ci * kC1Ld + r * kC1Cols + 8 * v;
      const long long off = ci * ca.xc + p * plane + static_cast<long long>(ih) * W;
      if (VEC) {
        const bool ok = row_ok && c >= 0 && c < W;  // W % 8 = 0: all in or out
        cp_async16(dst, ok ? xb + off + c : x, ok ? 16 : 0);
      } else {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(xb) + off;
        uint32_t e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c0 = c + 2 * i, c1 = c0 + 1;
          const uint32_t lo = row_ok && c0 >= 0 && c0 < W ? src[c0] : 0;
          const uint32_t hi = row_ok && c1 >= 0 && c1 < W ? src[c1] : 0;
          e[i] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  };

  // P of the staged plane: warp w takes the 16-position groups w, w + 8, …
  // (group g: row g / 5, columns 16·(g % 5) …); the taps and columns the
  // sums read (tap < 27, columns 6 … 73) go to ps
  auto products = [&]() {
    for (int g = warp; g < kC1Groups; g += kC1Warps) {
      const int r = g / (kC1Cols / 16), c0 = g % (kC1Cols / 16) * 16;
      float acc[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ks) {
          uint32_t bf[4];
          load_b2(bf, gs, kC1Ld, kk * 16, r * kC1Cols + c0, lane);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma16816(acc[mt][0], a[kk][mt], bf[0], bf[1]);
            mma16816(acc[mt][1], a[kk][mt], bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tap = mt * 16 + (lane >> 2) + 8 * h;
            const int c = c0 + 8 * nt + 2 * (lane & 3);
            if (tap < 27 && c >= 6 && c < 6 + kC1Pw)
              *reinterpret_cast<float2*>(ps + tap * kC1Pt + r * kC1Pw + c - 6) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
    }
  };

  // this thread's output voxel: row oy, column ox of the tile, which reads
  // P[tap][oy + dy][ox + dx] (staged column ox + dx + 7)
  const int oy = tid / kC1Tw, ox = tid % kC1Tw;
  const int oh = oh0 + oy, ow = ow0 + ox;
  const bool inside = oh < H && ow < W;
  const float* pr = ps + oy * kC1Pw + ox + 1;
  const float bias0 = bias[0];
  auto store = [&](int od, float val) {
    if (!inside) return;
    val += bias0;
    const long long opix = od * plane + static_cast<long long>(oh) * W + ow;
    if constexpr (CHAIN) {
      if (ca.dact)
        val *= dact_f32(ca.dact, __bfloat162float(
                                     static_cast<const bf16*>(ca.dact_x)[b * ca.db + opix]));
    }
    out[b * Do * plane + opix] = __float2bfloat16_rn(val);
  };

  // input plane i of the block is view plane od0 − qlo + i; it reaches
  // output planes i − dz. acc0, acc1, acc2: output planes i − 2, i − 1, i.
  const int n_in = n_out + 2;
  auto in_view = [&](int i) {
    const int p = od0 - ca.qlo + i;
    return p >= 0 && p < ca.nv;
  };
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  if (in_view(0)) stage(od0 - ca.qlo);
  cp_async_commit();
  for (int i = 0; i < n_in; ++i) {
    const bool next = i + 1 < n_in && in_view(i + 1);
    if (in_view(i)) {  // block-uniform branch
      cp_async_wait<0>();
      __syncthreads();  // plane i is staged; the previous plane's P is no longer read
      products();
      __syncthreads();  // P is complete; the staging buffer is free
      if (next) stage(od0 - ca.qlo + i + 1);
      cp_async_commit();
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int off = t / 3 * kC1Pw + t % 3;
        s2 += pr[t * kC1Pt + off];         // dz = 0: output plane i
        s1 += pr[(9 + t) * kC1Pt + off];   // dz = 1: output plane i − 1
        s0 += pr[(18 + t) * kC1Pt + off];  // dz = 2: output plane i − 2
      }
      acc0 += s0;
      acc1 += s1;
      acc2 += s2;
    } else if (next) {  // the staging buffer is free: no plane was staged for i
      stage(od0 - ca.qlo + i + 1);
      cp_async_commit();
    }
    if (i >= 2) store(od0 + i - 2, acc0);
    acc0 = acc1;
    acc1 = acc2;
    acc2 = 0.f;
  }
  cp_async_wait<0>();
}

template <bool CHAIN>
int launch_c1_tc(const void* x, const void* w, const void* bias, void* out, long long batch,
                 int cin, int H, int W, int Do, const ChainArgs& ca, cudaStream_t stream) {
  const long long tiles = static_cast<long long>((Do + kC1Planes - 1) / kC1Planes) *
                          ((H + kC1Th - 1) / kC1Th) * ((W + kC1Tw - 1) / kC1Tw);
  if (cin > kC1Ci || tiles > 2147483647LL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 8 == 0 && ca.xb % 8 == 0 && ca.xc % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = vec ? conv_c1_tc_kernel<CHAIN, true> : conv_c1_tc_kernel<CHAIN, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kC1Smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)), kC1Threads, kC1Smem,
         stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   static_cast<const float*>(bias), static_cast<bf16*>(out), cin, H, W, Do, ca);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------ the one-input-channel B/H on the tensor cores ---

constexpr int kCiThreads = 256;                     // 8 warps
constexpr int kCiWarps = kCiThreads / 32;
constexpr int kCiTd = 4, kCiTh = 4, kCiTw = 64;     // output voxels per block: 1,024
constexpr int kCiPd = kCiTd + 2, kCiPh = kCiTh + 2; // staged planes and rows of a copy
// A copy is the block's input patch shifted by dx − 1 along W: copy dx, plane
// pd, row ph, column c holds act(x) at view plane od0 − qlo + pd, row
// oh0 − 1 + ph, column ow0 − 1 + dx + c. Its pitches make tap t = (dz, dy, dx)
// start 16·t bytes (mod 128) after tap 0 — rows 176 ≡ 48, planes 1,168 ≡ 16,
// copies 7,056 ≡ 16 (mod 128) — so the 8 taps of one ldmatrix phase hit 8
// different bank groups.
constexpr int kCiRow = 88;                          // bf16 per row: 64 columns + pad
constexpr int kCiPlane = 584;                       // bf16 per plane: 6 rows + pad
constexpr int kCiCopy = 3528;                       // bf16 per copy: 6 planes + pad
constexpr int kCiZero = 3 * kCiCopy;                // the zero rows of taps 27-31, from
                                                    // 16·27 ≡ 48 (mod 128) like tap 27's
constexpr int kCiZeroLen = 256;                     // bf16: room for every offset a row takes
constexpr int kCiOld = 24;                          // bf16 per channel row of a warp's output
                                                    // tile (16 columns + pad): 48 bytes
constexpr int kCiWLd = 40;                          // bf16 per weight row ([co][tap]): 80 bytes

template <int MT>
constexpr int c1in_smem() {  // xs copies + zero rows, weights, the warps' output tiles
  return (kCiZero + kCiZeroLen + MT * 16 * kCiWLd + kCiWarps * MT * 16 * kCiOld) * 2;
}

// The one-input-channel forwards' Σ/Σ² epilogue: each lane's sums of its
// fragment channels (co0 + 16·mt + lane / 4 + 8·half), the quad's voxels by
// shuffles, then the 8 warps in order into one partial per block and output
// channel. Block-uniform: every thread of the block calls it.
template <int MT>
__device__ __forceinline__ void c1in_block_sums(const float (&s1)[MT][2], const float (&s2)[MT][2],
                                                float (*red)[MT * 16][2], int co0, int cout,
                                                long long b, int tile, int n_co, float* partial) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = s1[mt][half], q = s2[mt][half];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad: the voxels of this row
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if ((lane & 3) == 0) {
        const int c = mt * 16 + (lane >> 2) + half * 8;
        red[warp][c][0] = s;
        red[warp][c][1] = q;
      }
    }
  __syncthreads();
  if (tid < 2 * MT * 16) {  // the warps in order, one partial per block
    const int c = tid / 2, k = tid % 2;
    if (co0 + c < cout) {
      float t = 0.f;
#pragma unroll
      for (int wi = 0; wi < kCiWarps; ++wi) t += red[wi][c][k];
      const long long nblk = gridDim.x / n_co;
      partial[((b * cout + co0 + c) * nblk + tile) * 2 + k] = t;
    }
  }
}

// out[co, voxel] = bias[co] + Σ_tap w[co, 0, tap] · act(x)[voxel + tap],
// as conv3d_k3_kernel computes it with one input channel, for Cout ≥ 8 and no
// act′ epilogue (c1in_uses_tc): the TPU kernel's own product
// (_conv_kernel_smallcin), M = Cout (MT 16-row tiles a block: 32 for Cout ≤
// 32, else 64 and ⌈Cout/64⌉ blocks a voxel tile), N = output voxels, K = the
// 27 taps padded to 32 (two k16 steps), on mma.sync m16n8k16 bf16 → fp32.
// The weights' A fragments stay in registers for the block. The alignment
// trap: a dx tap shifts x by one bf16 along W, so a B row (one tap, 8
// neighbouring voxels) is 16-byte aligned for only one dx; with one input
// channel there is nothing to stack channels-innermost. Way out: the block
// stages three copies of its input patch, each pre-shifted by dx − 1 (16-byte
// loads of x's rows, the shifts by byte permutes in registers, the act
// prologue in fp32 rounded to bf16 on the way), so every tap of 8 voxels is an
// aligned row and ldmatrix.trans gives the B fragments of both k steps in one
// x4 load; taps 27-31 read zero rows. The products are tiny (58 GFLOP for
// 1→64 at 256³); what bounds the kernel is writing the output, 32 or 64
// times the bytes of x. Epilogue: the accumulators start at the bias, each
// warp rounds its 16-column step once to bf16 into its own shared tile
// ([co][16 columns]), takes Σ/Σ² of the rounded values, and writes the tile
// back with 16-byte stores (32-byte rows per channel); Σ/Σ² by quad shuffles,
// then the 8 warps in order, one partial per block. Block blockIdx.x: Cout
// tile fastest, then the voxel tile (W fastest, then H, then D); batch
// blockIdx.y. Warp w: plane w / 2, rows 2·(w % 2) + {0, 1}, 64 columns each,
// in 16-column steps. VEC: W, the batch stride and x are 16-byte aligned, so
// x and the output move in 16-byte vectors; otherwise element by element.
template <int MT, bool CHAIN, bool VEC>
__global__ void __launch_bounds__(kCiThreads, 2)
conv_c1in_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ out, int cout, int H,
                    int W, int Do, int n_co, ChainArgs ca) {
  constexpr int CO = MT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // 3 copies, then the zero rows
  bf16* ws = xs + kCiZero + kCiZeroLen;                 // [co][tap]
  bf16* ot = ws + CO * kCiWLd;                   // [warp][co][16 columns]
  __shared__ float red[kCiWarps][CO][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_w = (W + kCiTw - 1) / kCiTw, tiles_h = (H + kCiTh - 1) / kCiTh;
  const int co0 = static_cast<int>(blockIdx.x % n_co) * CO;
  const int tile = static_cast<int>(blockIdx.x / n_co);
  const int ow0 = tile % tiles_w * kCiTw;
  const int oh0 = tile / tiles_w % tiles_h * kCiTh;
  const int od0 = tile / (tiles_w * tiles_h) * kCiTd;
  const long long b = blockIdx.y;
  const long long plane = static_cast<long long>(H) * W;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + b * ca.xb;

  // the weights, [co][tap], zero past tap 26 and Cout; the zero rows
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(w);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(ws);
  for (int u = tid; u < CO * 32; u += kCiThreads) {
    const int co = u / 32, tap = u % 32;
    wsm[co * kCiWLd + tap] = tap < 27 && co0 + co < cout ? wg[(co0 + co) * 27 + tap] : 0;
  }
  if (tid < kCiZeroLen / 8) reinterpret_cast<uint4*>(xs + kCiZero)[tid] = make_uint4(0u, 0u, 0u, 0u);

  // the three copies: unit (plane pd, row ph, 8-column chunk j) reads x's
  // vectors at columns ow0 − 8 + 8·{j, j + 1, j + 2} and writes chunk j of
  // each copy; zero outside the view's planes and the image
  for (int u = tid; u < kCiPd * kCiPh * 8; u += kCiThreads) {
    const int j = u % 8, r = u / 8, pd = r / kCiPh, ph = r % kCiPh;
    const int p = od0 - ca.qlo + pd, ih = oh0 - 1 + ph, c = ow0 - 8 + 8 * j;
    const bool row_ok = p >= 0 && p < ca.nv && ih >= 0 && ih < H;
    const unsigned short* src = xb + (row_ok ? p * plane + static_cast<long long>(ih) * W : 0);
    uint32_t v[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int ck = c + 8 * k;
      if (VEC) {
        const bool ok = row_ok && ck >= 0 && ck < W;  // W % 8 = 0: a vector is all in or out
        const uint4 q = ok ? *reinterpret_cast<const uint4*>(src + ck) : make_uint4(0u, 0u, 0u, 0u);
        v[k][0] = q.x, v[k][1] = q.y, v[k][2] = q.z, v[k][3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c0 = ck + 2 * i, c1 = c0 + 1;
          const uint32_t lo = row_ok && c0 >= 0 && c0 < W ? src[c0] : 0;
          const uint32_t hi = row_ok && c1 >= 0 && c1 < W ? src[c1] : 0;
          v[k][i] = lo | (hi << 16);
        }
      }
    }
    if constexpr (CHAIN) {
      if (ca.act) {  // the prologue, rounded to bf16; act(0) = 0 keeps the padding
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[k][i] = act_bf16x2(ca.act, v[k][i]);
      }
    }
    // copy 0: columns c + 7 … c + 14 (the last of vector j, then j + 1);
    // copy 1: vector j + 1; copy 2: columns c + 9 … c + 16
    bf16* dst = xs + pd * kCiPlane + ph * kCiRow + 8 * j;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(__byte_perm(v[0][3], v[1][0], 0x5432), __byte_perm(v[1][0], v[1][1], 0x5432),
                   __byte_perm(v[1][1], v[1][2], 0x5432), __byte_perm(v[1][2], v[1][3], 0x5432));
    *reinterpret_cast<uint4*>(dst + kCiCopy) = make_uint4(v[1][0], v[1][1], v[1][2], v[1][3]);
    *reinterpret_cast<uint4*>(dst + 2 * kCiCopy) =
        make_uint4(__byte_perm(v[1][0], v[1][1], 0x5432), __byte_perm(v[1][1], v[1][2], 0x5432),
                   __byte_perm(v[1][2], v[1][3], 0x5432), __byte_perm(v[1][3], v[2][0], 0x5432));
  }
  __syncthreads();

  uint32_t a[2][MT][4];  // [k step][16-row co tile]
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) load_a(a[kk][mt], ws, kCiWLd, mt * 16, kk * 16, lane);

  // this lane's row of the ldmatrix.trans B loads: tap `lane` of an 8-voxel
  // group (the 16-byte-aligned start of its row in its copy, or a zero row)
  const int vz = warp >> 1, vy0 = (warp & 1) * 2;
  const int tz = lane / 9, ty = (lane / 3) % 3, tx = lane % 3;
  const int wofs = vz * kCiPlane + vy0 * kCiRow;
  const bf16* lrow = lane < 27 ? xs + tx * kCiCopy + tz * kCiPlane + ty * kCiRow + wofs
                               : xs + kCiZero + (8 * (lane - 27) + wofs) % 64;

  // the fragment's channels: co0 + 16·mt + lane / 4 + 8·half
  float bco[MT][2], s1[MT][2], s2[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + mt * 16 + (lane >> 2) + half * 8;
      bco[mt][half] = co < cout ? bias[co] : 0.f;
      s1[mt][half] = s2[mt][half] = 0.f;
    }
  const long long oplane = plane;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const int od = od0 + vz;
  bf16* otw = ot + warp * CO * kCiOld;
  // the store's lanes: 16 channel rows × 2 chunks of 8 columns, so each
  // ldmatrix-like phase of 8 lanes reads 8 rows (conflict-free at 48 bytes)
  const int st_chunk = (lane >> 3) & 1, st_row = (lane & 7) | ((lane >> 4) << 3);

#pragma unroll 1
  for (int step = 0; step < 2 * kCiTw / 16; ++step) {
    const int vy = vy0 + step / (kCiTw / 16), c16 = step % (kCiTw / 16);
    const int oh = oh0 + vy, owb = ow0 + 16 * c16;
    float acc[2][MT][4];  // [8-voxel group][16-row co tile][fragment]
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t r[4];
      ldsm_x4_t(r, lrow + (step / (kCiTw / 16)) * kCiRow + 16 * c16 + 8 * q);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[q][mt][0] = acc[q][mt][1] = bco[mt][0];
        acc[q][mt][2] = acc[q][mt][3] = bco[mt][1];
        mma16816(acc[q][mt], a[0][mt], r[0], r[1]);
        mma16816(acc[q][mt], a[1][mt], r[2], r[3]);
      }
    }
    // round once, into the warp's tile; Σ/Σ² of the rounded values inside
    // the output
    const bool row_ok = od < Do && oh < H;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ow = owb + 8 * q + 2 * (lane & 3);
      const bool ok0 = row_ok && ow < W, ok1 = row_ok && ow + 1 < W;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t pk = pack_bf16x2(acc[q][mt][2 * half], acc[q][mt][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(otw + (mt * 16 + (lane >> 2) + half * 8) * kCiOld + 8 * q +
                                       2 * (lane & 3)) = pk;
          const float f0 = ok0 ? __uint_as_float(pk << 16) : 0.f;
          const float f1 = ok1 ? __uint_as_float(pk & 0xffff0000u) : 0.f;
          s1[mt][half] += f0 + f1;
          s2[mt][half] += f0 * f0 + f1 * f1;
        }
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < MT; ++it) {
      const int row = it * 16 + st_row, co = co0 + row;
      const int ow = owb + 8 * st_chunk;
      const uint4 val = *reinterpret_cast<const uint4*>(otw + row * kCiOld + 8 * st_chunk);
      if (!row_ok || co >= cout || ow >= W) continue;
      bf16* dst = out + (b * cout + co) * ovol + od * oplane + static_cast<long long>(oh) * W + ow;
      if (VEC) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        const uint32_t wv[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ow + e < W)
            dst[e] = __ushort_as_bfloat16(static_cast<unsigned short>(wv[e >> 1] >> (16 * (e & 1))));
      }
    }
    __syncwarp();  // the tile is read before the next step writes it
  }

  if constexpr (CHAIN) {
    if (ca.partial != nullptr)  // block-uniform branch
      c1in_block_sums<MT>(s1, s2, red, co0, cout, b, tile, n_co, ca.partial);
  }
}

// ------------------------ the one-input-channel C/I on the tensor cores ---

constexpr int kC2Td = 4, kC2Th = 4, kC2Tw = 32;             // output voxels per block: 512
constexpr int kC2Pd = 2 * kC2Td + 1, kC2Ph = 2 * kC2Th + 1;  // staged planes and rows: 9 each
// A copy holds one column parity of the block's input patch: copy 1 the even
// columns, 2·(ow0 + c) (tap dx = 1), copy 2 the odd ones, 2·(ow0 + c) + 1
// (dx = 2), copy 0 the odd ones shifted by one, 2·(ow0 + c) − 1 (dx = 0);
// plane pd, row ph of a copy hold act(x) at view plane 2·od0 − qlo + pd, row
// 2·oh0 − 1 + ph. Output column c of the tile reads column c of its tap's
// copy, so 8 neighbouring voxels of a tap are one aligned 16-byte row. The
// pitches put tap t = (dz, dy, dx) 16·(7t mod 8) bytes (mod 128) after tap
// 0 — rows 80 ≡ 16·5, planes 752 ≡ 16·7, copies 6,768 ≡ 16·7 (mod 128) — so
// the 8 taps of one ldmatrix phase hit 8 different bank groups.
constexpr int kC2Row = 40;                           // bf16 per row: 32 columns + pad
constexpr int kC2Plane = 376;                        // bf16 per plane: 9 rows + pad
constexpr int kC2Copy = 3384;                        // bf16 per copy: 9 planes
constexpr int kC2Zero = 10176;                       // the zero rows of taps 27-31: the first
                                                     // multiple of 64 bf16 (128 bytes) past the copies
constexpr int kC2ZeroLen = 192;                      // bf16: room for every offset a row takes
constexpr int kC2Old = 40;                           // bf16 per channel row of a warp's output
                                                     // tile (32 columns + pad): 80 bytes
static_assert(kC2Row >= kC2Tw && kC2Plane >= kC2Ph * kC2Row && kC2Copy >= kC2Pd * kC2Plane &&
                  kC2Zero >= 3 * kC2Copy && kC2Zero % 64 == 0,
              "the copies' pitches");

template <int MT>
constexpr int c1in_s2_smem() {  // xs copies + zero rows, weights, the warps' output tiles
  return (kC2Zero + kC2ZeroLen + MT * 16 * kCiWLd + kCiWarps * MT * 16 * kC2Old) * 2;
}

// out[co, od, oh, ow] = bias[co] + Σ_tap w[co, 0, tap] · act(x)[2·od + dz −
// qlo, 2·oh + dy − 1, 2·ow + dx − 1] for one input channel, Cout ≥ 8 and no
// act′ (c1in_uses_tc at stride 2): stage 1's 1→64 stem, _conv_fwd_s2 at Cin
// = 1, as conv_c1in_tc_kernel computes the stride-1 one: M = Cout (MT 16-row
// tiles a block: 32 for Cout ≤ 32, else 64 and ⌈Cout/64⌉ blocks a voxel
// tile), N = output voxels, K = the 27 taps padded to 32 (two k16 steps), on
// mma.sync m16n8k16 bf16 → fp32, the weights' A fragments in registers for
// the block. The alignment trap at stride 2: output column ow reads input
// columns 2·ow − 1, 2·ow and 2·ow + 1, so a B row (one tap, 8 neighbouring
// voxels) is every other input column. Way out: the block stages its input
// patch de-interleaved by column parity into three copies (16-byte loads of
// x's rows, the halves sorted by byte permutes, the act prologue in fp32
// rounded to bf16 on the way), and a tap's plane and row select 2·o + d − 1
// of the staged ones, so every tap of 8 voxels is an aligned row and
// ldmatrix.trans gives the B fragments of both k steps in one x4 load; taps
// 27-31 read zero rows. What bounds it is writing the output, Cout times
// the bytes of x / 8 (the stride-1 stem's finding): each warp rounds a row's
// 32 columns once to bf16 into its own shared tile ([co][32 columns]), takes
// Σ/Σ² of the rounded values, and writes 64-byte channel rows by 16-byte
// stores; Σ/Σ² by quad shuffles, then the 8 warps in order, one partial per
// block. Block blockIdx.x: Cout tile fastest, then the voxel tile (W fastest,
// then H, then D); batch blockIdx.y. Warp w: plane w / 2, rows 2·(w % 2) +
// {0, 1}, 32 columns each. VEC: W a multiple of 16, the batch stride and x
// 16-byte aligned, so x and the output move in 16-byte vectors; otherwise
// element by element.
template <int MT, bool CHAIN, bool VEC>
__global__ void __launch_bounds__(kCiThreads, 2)
conv_c1in_s2_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ out, int cout, int H,
                       int W, int Do, int n_co, ChainArgs ca) {
  constexpr int CO = MT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // 3 copies, then the zero rows
  bf16* ws = xs + kC2Zero + kC2ZeroLen;          // [co][tap]
  bf16* ot = ws + CO * kCiWLd;                   // [warp][co][32 columns]
  __shared__ float red[kCiWarps][CO][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tiles_w = (Wo + kC2Tw - 1) / kC2Tw, tiles_h = (Ho + kC2Th - 1) / kC2Th;
  const int co0 = static_cast<int>(blockIdx.x % n_co) * CO;
  const int tile = static_cast<int>(blockIdx.x / n_co);
  const int ow0 = tile % tiles_w * kC2Tw;
  const int oh0 = tile / tiles_w % tiles_h * kC2Th;
  const int od0 = tile / (tiles_w * tiles_h) * kC2Td;
  const long long b = blockIdx.y;
  const long long plane = static_cast<long long>(H) * W;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + b * ca.xb;

  // the weights, [co][tap], zero past tap 26 and Cout; the zero rows
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(w);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(ws);
  for (int u = tid; u < CO * 32; u += kCiThreads) {
    const int co = u / 32, tap = u % 32;
    wsm[co * kCiWLd + tap] = tap < 27 && co0 + co < cout ? wg[(co0 + co) * 27 + tap] : 0;
  }
  if (tid < kC2ZeroLen / 8) reinterpret_cast<uint4*>(xs + kC2Zero)[tid] = make_uint4(0u, 0u, 0u, 0u);

  // the three copies: unit (plane pd, row ph, chunk j of 8 output columns)
  // reads x's vectors at input columns 2·ow0 + 16·j + {−8, 0, 8} and writes
  // chunk j of each copy; zero outside the view's planes and the image
  for (int u = tid; u < kC2Pd * kC2Ph * (kC2Tw / 8); u += kCiThreads) {
    const int j = u % (kC2Tw / 8), r = u / (kC2Tw / 8), pd = r / kC2Ph, ph = r % kC2Ph;
    const int p = 2 * od0 - ca.qlo + pd, ih = 2 * oh0 - 1 + ph, c = 2 * ow0 + 16 * j - 8;
    const bool row_ok = p >= 0 && p < ca.nv && ih >= 0 && ih < H;
    const unsigned short* src = xb + (row_ok ? p * plane + static_cast<long long>(ih) * W : 0);
    uint32_t v[3][4];  // v[k][i]: input columns c + 8·k + 2·i (low half) and + 1 (high half)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int ck = c + 8 * k;
      if (VEC) {
        const bool ok = row_ok && ck >= 0 && ck < W;  // W % 8 = 0: a vector is all in or out
        const uint4 q = ok ? *reinterpret_cast<const uint4*>(src + ck) : make_uint4(0u, 0u, 0u, 0u);
        v[k][0] = q.x, v[k][1] = q.y, v[k][2] = q.z, v[k][3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c0 = ck + 2 * i, c1 = c0 + 1;
          const uint32_t lo = row_ok && c0 >= 0 && c0 < W ? src[c0] : 0;
          const uint32_t hi = row_ok && c1 >= 0 && c1 < W ? src[c1] : 0;
          v[k][i] = lo | (hi << 16);
        }
      }
    }
    if constexpr (CHAIN) {
      if (ca.act) {  // the prologue, rounded to bf16; act(0) = 0 keeps the padding
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[k][i] = act_bf16x2(ca.act, v[k][i]);
      }
    }
    // copy 0: the high halves from the last word of vector 0 on; copy 1: the
    // low halves of vectors 1 and 2; copy 2: their high halves
    bf16* dst = xs + pd * kC2Plane + ph * kC2Row + 8 * j;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(__byte_perm(v[0][3], v[1][0], 0x7632), __byte_perm(v[1][1], v[1][2], 0x7632),
                   __byte_perm(v[1][3], v[2][0], 0x7632), __byte_perm(v[2][1], v[2][2], 0x7632));
    *reinterpret_cast<uint4*>(dst + kC2Copy) =
        make_uint4(__byte_perm(v[1][0], v[1][1], 0x5410), __byte_perm(v[1][2], v[1][3], 0x5410),
                   __byte_perm(v[2][0], v[2][1], 0x5410), __byte_perm(v[2][2], v[2][3], 0x5410));
    *reinterpret_cast<uint4*>(dst + 2 * kC2Copy) =
        make_uint4(__byte_perm(v[1][0], v[1][1], 0x7632), __byte_perm(v[1][2], v[1][3], 0x7632),
                   __byte_perm(v[2][0], v[2][1], 0x7632), __byte_perm(v[2][2], v[2][3], 0x7632));
  }
  __syncthreads();

  uint32_t a[2][MT][4];  // [k step][16-row co tile]
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) load_a(a[kk][mt], ws, kCiWLd, mt * 16, kk * 16, lane);

  // this lane's row of the ldmatrix.trans B loads: tap `lane` of an 8-voxel
  // group (the 16-byte-aligned start of its row in its copy, or a zero row
  // in the same bank group, 16·(7·lane mod 8) bytes past tap 0's)
  const int vz = warp >> 1, vy0 = (warp & 1) * 2;
  const int tz = lane / 9, ty = (lane / 3) % 3, tx = lane % 3;
  const int wofs = 2 * vz * kC2Plane + 2 * vy0 * kC2Row;
  const bf16* lrow = lane < 27 ? xs + tx * kC2Copy + tz * kC2Plane + ty * kC2Row + wofs
                               : xs + kC2Zero + (8 * ((7 * lane) & 7) + wofs) % 64;

  // the fragment's channels: co0 + 16·mt + lane / 4 + 8·half
  float bco[MT][2], s1[MT][2], s2[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + mt * 16 + (lane >> 2) + half * 8;
      bco[mt][half] = co < cout ? bias[co] : 0.f;
      s1[mt][half] = s2[mt][half] = 0.f;
    }
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const int od = od0 + vz;
  bf16* otw = ot + warp * CO * kC2Old;
  // the store's lanes: 8 channel rows × 4 chunks of 8 columns, so each
  // 8-lane phase reads 8 rows (conflict-free at 80 bytes)
  const int st_chunk = lane >> 3, st_row = lane & 7;

#pragma unroll 1
  for (int step = 0; step < 2; ++step) {
    const int oh = oh0 + vy0 + step;
    const bool row_ok = od < Do && oh < Ho;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // 16 columns at a time
      float acc[2][MT][4];  // [8-voxel group][16-row co tile][fragment]
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t r[4];
        ldsm_x4_t(r, lrow + step * 2 * kC2Row + 16 * hh + 8 * q);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[q][mt][0] = acc[q][mt][1] = bco[mt][0];
          acc[q][mt][2] = acc[q][mt][3] = bco[mt][1];
          mma16816(acc[q][mt], a[0][mt], r[0], r[1]);
          mma16816(acc[q][mt], a[1][mt], r[2], r[3]);
        }
      }
      // round once, into the warp's tile; Σ/Σ² of the rounded values inside
      // the output
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 16 * hh + 8 * q + 2 * (lane & 3), ow = ow0 + col;
        const bool ok0 = row_ok && ow < Wo, ok1 = row_ok && ow + 1 < Wo;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t pk = pack_bf16x2(acc[q][mt][2 * half], acc[q][mt][2 * half + 1]);
            *reinterpret_cast<uint32_t*>(otw + (mt * 16 + (lane >> 2) + half * 8) * kC2Old + col) = pk;
            const float f0 = ok0 ? __uint_as_float(pk << 16) : 0.f;
            const float f1 = ok1 ? __uint_as_float(pk & 0xffff0000u) : 0.f;
            s1[mt][half] += f0 + f1;
            s2[mt][half] += f0 * f0 + f1 * f1;
          }
      }
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 2 * MT; ++it) {
      const int row = it * 8 + st_row, co = co0 + row;
      const int ow = ow0 + 8 * st_chunk;
      const uint4 val = *reinterpret_cast<const uint4*>(otw + row * kC2Old + 8 * st_chunk);
      if (!row_ok || co >= cout || ow >= Wo) continue;
      bf16* dst = out + (b * cout + co) * ovol + od * oplane + static_cast<long long>(oh) * Wo + ow;
      if (VEC) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        const uint32_t wv[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ow + e < Wo)
            dst[e] = __ushort_as_bfloat16(static_cast<unsigned short>(wv[e >> 1] >> (16 * (e & 1))));
      }
    }
    __syncwarp();  // the tile is read before the next step writes it
  }

  if constexpr (CHAIN) {
    if (ca.partial != nullptr)  // block-uniform branch
      c1in_block_sums<MT>(s1, s2, red, co0, cout, b, tile, n_co, ca.partial);
  }
}

// The one-input-channel forward at stride S: conv_c1in_tc_kernel (stride 1,
// 4 × 4 × 64 output voxels a block) or conv_c1in_s2_tc_kernel (stride 2,
// 4 × 4 × 32), MT = 2 (Cout tiles of 32) for Cout ≤ 32, else 4.
template <int S, int MT, bool CHAIN>
int launch_c1in_tc_mt(const void* x, const void* w, const void* bias, void* out,
                      long long batch, int cout, int H, int W, int Do, const ChainArgs& ca,
                      float* sums, cudaStream_t stream) {
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  constexpr int TD = S == 1 ? kCiTd : kC2Td, TH = S == 1 ? kCiTh : kC2Th;
  constexpr int TW = S == 1 ? kCiTw : kC2Tw;
  const long long tiles = static_cast<long long>((Do + TD - 1) / TD) * ((Ho + TH - 1) / TH) *
                          ((Wo + TW - 1) / TW);
  const int n_co = (cout + MT * 16 - 1) / (MT * 16);
  if (tiles * n_co > 2147483647LL || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // stride 2 also stores 16-byte vectors of the Wo = W / 2 columns
  const bool vec = W % (8 * S) == 0 && ca.xb % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (S == 1 || reinterpret_cast<uintptr_t>(out) % 16 == 0);
  auto kern = S == 1 ? (vec ? conv_c1in_tc_kernel<MT, CHAIN, true> : conv_c1in_tc_kernel<MT, CHAIN, false>)
                     : (vec ? conv_c1in_s2_tc_kernel<MT, CHAIN, true>
                            : conv_c1in_s2_tc_kernel<MT, CHAIN, false>);
  constexpr int smem = S == 1 ? c1in_smem<MT>() : c1in_s2_smem<MT>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles * n_co), static_cast<unsigned>(batch)), kCiThreads,
         smem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                         static_cast<const float*>(bias), static_cast<bf16*>(out), cout, H, W,
                         Do, n_co, ca);
  e = cudaGetLastError();
  if (e != cudaSuccess || ca.partial == nullptr) return static_cast<int>(e);
  const long long rows = batch * cout;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  sum_block_partials_kernel<<<static_cast<unsigned>(rows), kSumThreads, 0, stream>>>(
      ca.partial, sums, tiles, static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool CHAIN>
int launch_c1in_tc(const void* x, const void* w, const void* bias, void* out, long long batch,
                   int cout, int H, int W, int Do, const ChainArgs& ca, float* sums,
                   cudaStream_t stream) {
  return cout <= 32
             ? launch_c1in_tc_mt<S, 2, CHAIN>(x, w, bias, out, batch, cout, H, W, Do, ca, sums, stream)
             : launch_c1in_tc_mt<S, 4, CHAIN>(x, w, bias, out, batch, cout, H, W, Do, ca, sums, stream);
}

// ------------------------------------------- C and I on the tensor cores ---

constexpr int kS2Threads = 256;                  // 8 warps
constexpr int kS2Warps = kS2Threads / 32;
constexpr int kS2Co = 64;                        // output channels per block: M, four 16-row tiles
constexpr int kS2Ci = 16;                        // input channels per chunk: one k16 step a tap
constexpr int kS2Td = 2, kS2Th = 4, kS2Tw = 16;  // output voxels per block: 128
constexpr int kS2Ph = 2 * kS2Th + 1;             // patch rows per plane: 9
constexpr int kS2R = (2 * kS2Td + 1) * kS2Ph;    // patch rows: 5 planes × 9
constexpr int kS2Pw = 2 * kS2Tw + 1;             // patch columns: 33, the even ones (17) first
constexpr int kS2Pwe = kS2Tw + 1;
constexpr int kS2Nvec = 5;                       // 8-column vectors of a raw row, from column
                                                 // 2·ow0 − 8 through the patch's last, 2·ow0 + 31
constexpr int kS2Units = (kS2Ci / 8) * kS2Nvec * kS2R;  // staging units: 8 channels × 8 columns
constexpr int kS2Patch = kS2R * kS2Pw * kS2Ci;   // bf16, [row][position][16 ci]
constexpr int kS2Wts = 27 * kS2Co * kS2Ci;       // bf16, [tap][co][16 ci]
constexpr int kS2Smem = (kS2Patch + kS2Wts) * 2; // 102,816 bytes: two blocks an SM

// position of patch column pw within its row: the even columns, then the
// odd ones, so output voxel ox reads position ox + {0, 17, 1} at tap dx
__device__ __forceinline__ int s2_pcol(int pw) { return (pw & 1) * kS2Pwe + (pw >> 1); }

// Block (blockIdx.x, blockIdx.y): Cout tile blockIdx.x % n_co (fastest, so
// the Cout tiles of one voxel tile run together and share its rows in L2),
// voxel tile blockIdx.x / n_co (W fastest, then H, then D), batch
// blockIdx.y. wtc: the weights as [Cout tile][Cin chunk][tap][64 co][16 ci],
// zero-padded (ops/cuda/conv3d_k3.py: s2_tc_weights), so a chunk's weights
// are one contiguous 55 KB copy. VEC: x's rows and strides are 16-byte
// aligned (W, xb, xc multiples of 8), so the staging loads 16-byte vectors;
// otherwise element by element.
template <bool CHAIN, bool VEC>
__global__ void __launch_bounds__(kS2Threads, 2)
conv_tc_s2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wtc,
                  const float* __restrict__ bias, bf16* __restrict__ out, int cin, int cout,
                  int H, int W, int Do, int n_co, ChainArgs ca) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* patch = reinterpret_cast<bf16*>(smem_raw);
  bf16* wts = patch + kS2Patch;
  __shared__ float red[kS2Warps][kS2Co][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tiles_w = (Wo + kS2Tw - 1) / kS2Tw;
  const int tiles_h = (Ho + kS2Th - 1) / kS2Th;
  const int cot = static_cast<int>(blockIdx.x % n_co);
  const int co0 = cot * kS2Co;
  const int tile = static_cast<int>(blockIdx.x / n_co);
  const int od0 = tile / (tiles_w * tiles_h) * kS2Td;
  const int oh0 = tile / tiles_w % tiles_h * kS2Th;
  const int ow0 = tile % tiles_w * kS2Tw;
  const long long b = blockIdx.y;
  const long long plane = static_cast<long long>(H) * W;
  const bf16* xb = x + b * ca.xb;
  const int n_ci = (cin + kS2Ci - 1) / kS2Ci;
  const int p0 = 2 * od0 - ca.qlo;  // view plane of the patch's first plane
  const int ih0 = 2 * oh0 - 1, c_first = 2 * ow0 - 8;

  // warp w: output plane w / 4, row w % 4, columns 0-15 (two 8-voxel tiles).
  // This lane's row of the B loads: voxel ln, channel unit lk.
  const int vz = warp >> 2, vy = warp & 3;
  const int ln = (lane & 7) + ((lane >> 4) << 3);
  const int lk = (lane >> 3) & 1;
  const int arow = lane & 15, au = lane >> 4;  // this lane's row and unit of the A loads

  float acc[4][2][4];  // [16-row co tile][8-voxel tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int ch = 0; ch < n_ci; ++ch) {
    const int ci0 = ch * kS2Ci;
    __syncthreads();  // the previous chunk's patch and weights are no longer read
    // the chunk's weights, one contiguous copy
    const bf16* wsrc = wtc + (static_cast<long long>(cot) * n_ci + ch) * kS2Wts;
    for (int u = tid; u < kS2Wts / 8; u += kS2Threads)
      cp_async16(wts + s2_swz(u >> 1, u & 1), wsrc + u * 8, 16);
    cp_async_commit();
    // the patch: units of 8 channels × one 8-column vector of a raw row, two
    // a thread, all their loads in flight together; then an 8 × 8 register
    // transpose (byte permutes) into [position][ci], the prologue on the way
    // (act(0) = 0 keeps the padding); zero outside the view's planes, the
    // image and Cin
    for (int u0 = tid; u0 < kS2Units; u0 += 2 * kS2Threads) {
      uint32_t wv[2][8][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int u = u0 + t * kS2Threads;
        const int r = u % kS2R, v = (u / kS2R) % kS2Nvec, cg = u / (kS2R * kS2Nvec);
        const int p = p0 + r / kS2Ph, ih = ih0 + r % kS2Ph, c = c_first + 8 * v;
        const bool row_ok = u < kS2Units && p >= 0 && p < ca.nv && ih >= 0 && ih < H;
        const long long off = p * plane + static_cast<long long>(ih) * W + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ci = ci0 + cg * 8 + i;
          if (VEC) {
            const bool ok = row_ok && ci < cin && c >= 0 && c < W;  // W % 8 = 0: all in or out
            const uint4 q4 = ok ? *reinterpret_cast<const uint4*>(xb + ci * ca.xc + off)
                                : make_uint4(0u, 0u, 0u, 0u);
            wv[t][i][0] = q4.x, wv[t][i][1] = q4.y, wv[t][i][2] = q4.z, wv[t][i][3] = q4.w;
          } else {
            const unsigned short* src = reinterpret_cast<const unsigned short*>(xb) + ci * ca.xc + off;
            unsigned short e8[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              e8[e] = row_ok && ci < cin && c + e >= 0 && c + e < W ? src[e] : 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wv[t][i][j] = e8[2 * j] | (static_cast<uint32_t>(e8[2 * j + 1]) << 16);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int u = u0 + t * kS2Threads;
        if (u >= kS2Units) continue;
        const int r = u % kS2R, v = (u / kS2R) % kS2Nvec, cg = u / (kS2R * kS2Nvec);
        if constexpr (CHAIN) {
          if (ca.act) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) wv[t][i][j] = act_bf16x2(ca.act, wv[t][i][j]);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pw = 8 * v + e - 7;  // raw column 0 is input column 2·ow0 − 8
          if (pw < 0 || pw >= kS2Pw) continue;
          const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
          const int j = e >> 1;
          *reinterpret_cast<uint4*>(patch + s2_swz(r * kS2Pw + s2_pcol(pw), cg)) =
              make_uint4(__byte_perm(wv[t][0][j], wv[t][1][j], sel),
                         __byte_perm(wv[t][2][j], wv[t][3][j], sel),
                         __byte_perm(wv[t][4][j], wv[t][5][j], sel),
                         __byte_perm(wv[t][6][j], wv[t][7][j], sel));
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], wts + s2_swz(tap * kS2Co + mt * 16 + arow, au));
      const int idx = ((2 * vz + dz) * kS2Ph + 2 * vy + dy) * kS2Pw + ln +
                      (dx == 1 ? kS2Pwe : dx >> 1);
      uint32_t r[4];
      ldsm_x4(r, patch + s2_swz(idx, lk));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma16816(acc[mt][0], a[mt], r[0], r[1]);
        mma16816(acc[mt][1], a[mt], r[2], r[3]);
      }
    }
  }

  // epilogue on the fragments: acc[mt][nt][2·half + j] is output channel
  // co0 + 16·mt + lane / 4 + 8·half at column ow0 + 8·nt + 2·(lane % 4) + j
  // of row oh0 + vy, plane od0 + vz. Bias, round, store and sum.
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const int od = od0 + vz, oh = oh0 + vy;
  const bool row_ok = od < Do && oh < Ho;
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + mt * 16 + (lane >> 2) + half * 8;
      const float bco = co < cout ? bias[co] : 0.f;
      bf16* ob = out + (b * cout + co) * ovol + od * oplane + static_cast<long long>(oh) * Wo;
      float sa = 0.f, sq = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ow = ow0 + nt * 8 + 2 * (lane & 3);
        const bool ok0 = row_ok && co < cout && ow < Wo, ok1 = row_ok && co < cout && ow + 1 < Wo;
        const bf16 r0 = __float2bfloat16_rn(acc[mt][nt][2 * half] + bco);
        const bf16 r1 = __float2bfloat16_rn(acc[mt][nt][2 * half + 1] + bco);
        if (ok1 && (Wo & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(ob + ow) = __halves2bfloat162(r0, r1);
        } else {
          if (ok0) ob[ow] = r0;
          if (ok1) ob[ow + 1] = r1;
        }
        const float f0 = ok0 ? __bfloat162float(r0) : 0.f;  // the values the statistics see
        const float f1 = ok1 ? __bfloat162float(r1) : 0.f;
        sa += f0 + f1;
        sq += f0 * f0 + f1 * f1;
      }
      s1[mt][half] = sa;
      s2[mt][half] = sq;
    }
  if constexpr (CHAIN) {
    if (ca.partial != nullptr) {  // block-uniform branch
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float sa = s1[mt][half], sq = s2[mt][half];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {  // the quad: the voxels of this row
            sa += __shfl_xor_sync(0xffffffffu, sa, off);
            sq += __shfl_xor_sync(0xffffffffu, sq, off);
          }
          if ((lane & 3) == 0) {
            const int cc = mt * 16 + (lane >> 2) + half * 8;
            red[warp][cc][0] = sa;
            red[warp][cc][1] = sq;
          }
        }
      __syncthreads();
      if (tid < 2 * kS2Co) {  // the warps in order, one partial per block
        const int cc = tid / 2, k = tid % 2;
        if (co0 + cc < cout) {
          float t = 0.f;
#pragma unroll
          for (int wi = 0; wi < kS2Warps; ++wi) t += red[wi][cc][k];
          const long long nblk = gridDim.x / n_co;
          ca.partial[((b * cout + co0 + cc) * nblk + tile) * 2 + k] = t;
        }
      }
    }
  }
}

template <bool CHAIN>
int launch_tc_s2(const void* x, const void* wtc, const void* bias, void* out, long long batch,
                 int cin, int cout, int H, int W, int Do, const ChainArgs& ca, float* sums,
                 cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long tiles = static_cast<long long>((Do + kS2Td - 1) / kS2Td) *
                          ((Ho + kS2Th - 1) / kS2Th) * ((Wo + kS2Tw - 1) / kS2Tw);
  const int n_co = (cout + kS2Co - 1) / kS2Co;
  if (wtc == nullptr || tiles * n_co > 2147483647LL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 8 == 0 && ca.xb % 8 == 0 && ca.xc % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = vec ? conv_tc_s2_kernel<CHAIN, true> : conv_tc_s2_kernel<CHAIN, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kS2Smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles * n_co), static_cast<unsigned>(batch)), kS2Threads,
         kS2Smem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(wtc),
                            static_cast<const float*>(bias), static_cast<bf16*>(out), cin, cout,
                            H, W, Do, n_co, ca);
  e = cudaGetLastError();
  if (e != cudaSuccess || ca.partial == nullptr) return static_cast<int>(e);
  const long long rows = batch * cout;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  sum_block_partials_kernel<<<static_cast<unsigned>(rows), kSumThreads, 0, stream>>>(
      ca.partial, sums, tiles, static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- CUDA-core launches ---

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

// The instance a call takes, an explicit rule (no fallback): bf16 with Cin
// ≥ 8 and Cout ≥ 8 → the tensor cores (stride 1: conv_tc_kernel, 4 × 4 × 32
// output voxels a block; stride 2: conv_tc_s2_kernel, 2 × 4 × 16);
// everything else → the CUDA cores. The Python wrapper counts tensor-core
// launches by this rule (hvc_conv3d_k3_fwd_tc) and sizes the Σ/Σ² partials
// for the larger grid of the two instances (ops/cuda/conv3d_k3.py:
// fwd_partial_blocks), so either fits. CUDA-core tiles: stride 1 uses 8×32
// output voxels per block (256 threads); stride 2 uses 8×16 (128 threads),
// which keeps its 2×-wider input patch under the 48 KB of static shared
// memory.
bool fwd_uses_tc(int stride, bool bf16, int cin, int cout) {
  return (stride == 1 || stride == 2) && bf16 && cin >= 8 && cout >= 8;
}

// The one-output-channel call's instance, likewise explicit: bf16 at stride 1
// with Cout = 1, 8 ≤ Cin ≤ 64 and neither a prologue nor sums — the data
// gradient of a conv with one input channel (the stage-3 chains' 1→32 and
// 1→64 convs), Cin being g's channels — takes conv_c1_tc_kernel; the rest
// the CUDA cores (CO_T = 1). The wrapper reads it through
// hvc_conv3d_k3s1_c1_tc.
bool c1_uses_tc(int stride, bool bf16, int cin, int cout, int act, bool sums) {
  return stride == 1 && bf16 && cout == 1 && cin >= 8 && cin <= kC1Ci && act == 0 && !sums;
}

// The one-input-channel call's instance, likewise explicit: bf16 with Cin =
// 1, Cout ≥ 8 and no act′ epilogue, dense or chain, with or without the
// prologue and Σ/Σ² — at stride 1 the forward of the stage-3 chains' 1→32
// and 1→64 convs, which takes conv_c1in_tc_kernel, at stride 2 stage 1's
// 1→64 stem, which takes conv_c1in_s2_tc_kernel. It does not take the act′
// epilogue: no call of the main path with one input channel has it (that
// would be the data gradient of a conv with one output channel, which the
// cascade does not have), so such a call stays on the CUDA cores, as do fp32
// (TF32 would leave the fp32 tolerances) and Cin 2-7 (K = 27·Cin would need
// another layout of the copies). The wrapper reads it through
// hvc_conv3d_k3s{1,2}_c1in_tc.
bool c1in_uses_tc(int stride, bool bf16, int cin, int cout, int dact) {
  return (stride == 1 || stride == 2) && bf16 && cin == 1 && cout >= 8 && dact == 0;
}

template <int S, bool CHAIN, typename T>
int dispatch_t(const void* x, const void* w, const void* wtc, const void* bias, void* out,
               long long batch, int cin, int cout, int H, int W, int Do, const ChainArgs& ca,
               float* sums, cudaStream_t s) {
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  constexpr int TH = 8;
  constexpr int TW = S == 1 ? 32 : 16;
  if (fwd_uses_tc(S, std::is_same<T, __nv_bfloat16>::value, cin, cout)) {
    if constexpr (S == 1)
      return launch_tc<CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do, ca, sums, s);
    else
      return launch_tc_s2<CHAIN>(x, wtc, bias, out, batch, cin, cout, H, W, Do, ca, sums, s);
  }
  if constexpr (S == 1) {
    if (c1_uses_tc(S, std::is_same<T, __nv_bfloat16>::value, cin, cout, ca.act,
                   ca.partial != nullptr))
      return launch_c1_tc<CHAIN>(x, w, bias, out, batch, cin, H, W, Do, ca, s);
    if (c1in_uses_tc(S, std::is_same<T, __nv_bfloat16>::value, cin, cout, ca.dact))
      return launch_c1in_tc<1, CHAIN>(x, w, bias, out, batch, cout, H, W, Do, ca, sums, s);
    if (cout == 1 && cin >= 4)
      return launch<T, S, TH, TW, 4, 1, CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do, Ho,
                                               Wo, ca, sums, s);
  }
  if constexpr (S == 2) {
    if (c1in_uses_tc(S, std::is_same<T, __nv_bfloat16>::value, cin, cout, ca.dact))
      return launch_c1in_tc<2, CHAIN>(x, w, bias, out, batch, cout, H, W, Do, ca, sums, s);
  }
  if (cin < 4)
    return launch<T, S, TH, TW, 1, kCoTile, CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do,
                                                   Ho, Wo, ca, sums, s);
  return launch<T, S, TH, TW, 4, kCoTile, CHAIN>(x, w, bias, out, batch, cin, cout, H, W, Do,
                                                 Ho, Wo, ca, sums, s);
}

template <int S>
int dispatch(const void* x, const void* w, const void* wtc, const void* bias, void* out,
             long long batch, int cin, int cout, int nv, int H, int W, int Do, int qlo,
             long long xb, long long xc, int act, int dact, const void* dact_x, long long db,
             long long dc, void* partial, void* sums, int dtype, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || nv < 0 || H <= 0 || W <= 0 || Do <= 0 ||
      act < 0 || act > 2 || dact < 0 || dact > 2 || (dact != 0) != (dact_x != nullptr) ||
      (partial == nullptr) != (sums == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChainArgs ca{xb, xc, nv, qlo, act, dact, dact_x, db, dc, static_cast<float*>(partial)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sm = static_cast<float*>(sums);
  const bool chain = act != 0 || dact != 0 || partial != nullptr;
  if (dtype == 0)
    return chain ? dispatch_t<S, true, float>(x, w, wtc, bias, out, batch, cin, cout, H, W, Do, ca, sm, s)
                 : dispatch_t<S, false, float>(x, w, wtc, bias, out, batch, cin, cout, H, W, Do, ca, sm, s);
  if (dtype == 1)
    return chain ? dispatch_t<S, true, __nv_bfloat16>(x, w, wtc, bias, out, batch, cin, cout, H, W, Do, ca, sm, s)
                 : dispatch_t<S, false, __nv_bfloat16>(x, w, wtc, bias, out, batch, cin, cout, H, W, Do, ca, sm, s);
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
  return dispatch<1>(x, w, nullptr, bias, out, batch, cin, cout, nv, H, W, Do, qlo, xb, xc, act,
                     dact, dact_x, db, dc, partial, sums, dtype, stream);
}

// As hvc_conv3d_k3s1_fwd, plus wtc: the weights in the tensor-core
// instance's layout (Cout tiles of 64 × Cin chunks of 16 × 27 taps × 64 × 16,
// zero-padded), which that instance reads instead of w; null for a call on
// the CUDA cores.
extern "C" int hvc_conv3d_k3s2_fwd(const void* x, const void* w, const void* wtc,
                                   const void* bias, void* out, long long batch, int cin,
                                   int cout, int nv, int H, int W, int Do, int qlo, long long xb,
                                   long long xc, int act, int dact, const void* dact_x,
                                   long long db, long long dc, void* partial, void* sums,
                                   int dtype, void* stream) {
  if (dact != 0) return static_cast<int>(cudaErrorInvalidValue);  // stride-1 dgrad only
  return dispatch<2>(x, w, wtc, bias, out, batch, cin, cout, nv, H, W, Do, qlo, xb, xc, act,
                     dact, dact_x, db, dc, partial, sums, dtype, stream);
}

// 1 if hvc_conv3d_k3s{stride}_fwd runs a call with these channel counts and
// dtype (0 = float32, 1 = bfloat16) on the tensor cores, else 0: the rule of
// dispatch_t, which the wrapper counts tensor-core launches by.
extern "C" int hvc_conv3d_k3_fwd_tc(int stride, int cin, int cout, int dtype) {
  return fwd_uses_tc(stride, dtype == 1, cin, cout) ? 1 : 0;
}

// 1 if hvc_conv3d_k3s1_fwd runs a call with these channel counts, prologue
// (act code), Σ/Σ² epilogue (sums 0 or 1) and dtype on the one-output-channel
// tensor-core instance, else 0: the rule of dispatch_t, which the wrapper
// counts its launches by.
extern "C" int hvc_conv3d_k3s1_c1_tc(int cin, int cout, int act, int sums, int dtype) {
  return c1_uses_tc(1, dtype == 1, cin, cout, act, sums != 0) ? 1 : 0;
}

// 1 if hvc_conv3d_k3s1_fwd runs a call with these channel counts, act′
// epilogue (dact code) and dtype on the one-input-channel tensor-core
// instance, else 0: the rule of dispatch_t, which the wrapper counts its
// launches by.
extern "C" int hvc_conv3d_k3s1_c1in_tc(int cin, int cout, int dact, int dtype) {
  return c1in_uses_tc(1, dtype == 1, cin, cout, dact) ? 1 : 0;
}

// 1 if hvc_conv3d_k3s2_fwd runs a call with these channel counts, act′
// epilogue (dact code) and dtype on the one-input-channel tensor-core
// instance, else 0: the rule of dispatch_t, which the wrapper counts its
// launches by.
extern "C" int hvc_conv3d_k3s2_c1in_tc(int cin, int cout, int dact, int dtype) {
  return c1in_uses_tc(2, dtype == 1, cin, cout, dact) ? 1 : 0;
}
