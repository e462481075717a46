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
//   thread (on the CUDA cores) or one warp (on the tensor cores) and
//   stored once, with no atomics, so the result does not depend on launch
//   order (kernel D's dq is summed across blocks: it adds the key tiles'
//   shares into one accumulator in key-tile order).
// - The lse is the natural-log one kernel A stores; no base-2/LN2 bookkeeping
//   on the outputs, no 128-lane padding of d, no lse = 1e30 padded rows.
//   Bounds checks mask the ragged kv tail (L) and the ragged query tail (M).
//
// What bounds them on this card: at the main path's long shape (8 heads ×
// 32,768 × 32,768, d = 32) L does 3 and M 4 products of N²·d per head and
// both read a few MB, so both are compute-bound: the products on the tensor
// cores and one exp2 per score on the special-function units. Together they
// do 7 products where kernel D does 5: s and dp are computed in both.
//
// L and M each have two instances, by an explicit rule (dq_uses_tc and
// dkv_uses_tc, which the wrapper reads through hvc_flash_attention_bwd_dq_tc
// and hvc_flash_attention_bwd_dkv_tc; no fallback): bf16 on the tensor cores,
// fp32 on the CUDA cores (TF32 would leave the fp32 tolerances).
//
// L on the tensor cores (flash_bwd_dq_tc_kernel), queries as M, on the
// pattern of kernel A's flash_fwd_tc_kernel: a block of 4 warps owns 64 query
// rows, 16 a warp, whose q and dout fragments, −lse·log2e and delta stay in
// registers for the whole sweep; K and V tiles of 64 keys are double-buffered
// by cp.async (rows padded by 16 bytes: ldmatrix conflict-free). Per 16 keys
// of a tile a warp computes S = q·kᵀ and dP = dout·vᵀ (k and v rows the B
// operand as they lie), p = exp2(s·scale·log2e − lse·log2e) in one FFMA and
// one exp2 a score (0 past Nk on the ragged last tile), ds = p·(dp − delta)
// in fp32 rounded to bf16 (as _bwd_dq_kernel's ds.astype(k.dtype)), and
// dQ += dS·K with dS straight from the accumulator fragments as the A
// operand and K by ldmatrix.trans (as A's P·V takes V). dq stays in fp32
// registers for the whole sweep and is scaled and stored once; rows past Nq
// are not stored. No dS through shared memory, no atomics, no cross-block
// sum: bitwise repeatable by construction.
//
// On the tensor cores M is kernel D's body without its dq phase
// (flash_bwd_tc_kernel<D, false>, flash_bwd_tc.cuh): work items of one head's
// 128 keys, 16 a warp, k and v fragments and the dk and dv accumulators in
// registers, query tiles of 64 double-buffered by cp.async, Sᵀ = K·qᵀ and
// dPᵀ = V·doutᵀ, P and dS rounded to bf16 (as _bwd_dkv_kernel rounds them:
// pb = p.astype, ds = (...).astype) and taken as A operands straight from the
// accumulator fragments; one block per item. Its dk and dv are D's bits.
//
// At d = 128 (the wrapper zero-pads any other d ≤ 128 to 32, 64 or 128) the
// tensor-core L holds q, dout and dq fragments of 16 × 128 a warp: it is
// launched for 2 blocks an SM (255 registers a thread) and its 68 KB of
// double-buffered K and V is dynamic shared memory; M takes D's body at
// d = 128 (flash_bwd_tc.cuh); the fp32 L stages K and V tiles of 32 keys.
//
// L and M in fp32 run as fp32 FMAs on the CUDA cores (67 TFLOP/s peak): each
// thread owns one row (d = 32) or a half or a quarter of one (d = 64, 128, the
// parts combined with warp shuffles) and holds its slices of the row's operands and
// accumulators in registers; the other side's tile is staged once per block in
// shared memory as fp32 and read as float4 broadcasts, four FMAs per
// shared-memory load. These do not round p and ds.
//
// Layout: q, dout (BH, Nq, d), k and v (BH, Nk, d), contiguous, fp32 or bf16
// (the bf16 ones 16-byte aligned);
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
// memory read as float4 broadcasts; the TPR parts of a d = 64 or 128 row are
// neighbouring lanes and are combined with shuffles.
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
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
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

// keys per staged tile: 64, 32 at d = 128 (K and V tiles in 32 KB)
template <int D>
__host__ __device__ constexpr int dq_bkv() { return D == 128 ? 32 : 64; }

template <typename T, int D>
__global__ void __launch_bounds__(kDqRows * (D / kDh))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, long long nq,
                    long long nk, float scale) {
  constexpr int TPR = D / kDh;
  constexpr int NT = kDqRows * TPR;
  constexpr int kDqBkv = dq_bkv<D>();
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

// ------------------------------------------------ L on the tensor cores ---

constexpr int kDqTcWarps = 4;
constexpr int kDqTcThreads = 32 * kDqTcWarps;
constexpr int kDqTcRows = 16 * kDqTcWarps;  // query rows per block: 16 a warp
constexpr int kDqTcKv = 64;                 // keys per tile

// rows [r0, r0 + N) of a (rows, D) bf16 array into shared rows of LD, 16
// bytes a thread, zero-filled past `rows`
template <int D, int LD, int N>
__device__ __forceinline__ void load_rows_dq(bf16* dst, const bf16* src, long long r0,
                                             long long rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < N * kChunks; c += kDqTcThreads) {
    const int r = c / kChunks, k8 = (c % kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + k8, ok ? src + (r0 + r) * D + k8 : src, ok ? 16 : 0);
  }
}

// bf16 of one k or v tile: rows padded by 16 bytes
template <int D>
__host__ __device__ constexpr int dq_tc_tile() { return kDqTcKv * (D + 8); }

// ≤ 128 registers a thread at d = 32 (4 blocks an SM), ≤ 168 at d = 64, ≤ 255
// at d = 128; the four tiles in dynamic shared memory (68 KB at d = 128)
template <int D>
__global__ void __launch_bounds__(kDqTcThreads, D == 32 ? 4 : D == 64 ? 3 : 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, long long nq, long long nk, float scale) {
  constexpr int LD = D + 8;  // bf16 per shared row: 16 bytes of padding
  constexpr int KS = D / 16; // k-steps of q·kᵀ and dout·vᵀ
  constexpr int DT = D / 8;  // 8-column tiles of dq
  constexpr int TILE = dq_tc_tile<D>();  // bf16 of one k or v tile
  // k and v tiles of buffer b at base + 2b·TILE and base + (2b + 1)·TILE
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.y;
  const long long q0 = static_cast<long long>(blockIdx.x) * kDqTcRows;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;
  const int n_tiles = static_cast<int>((nk + kDqTcKv - 1) / kDqTcKv);

  // q and dout pass through tile 1's buffers (read once, before tile 1 is
  // copied), tile 0 into its own
  load_rows_dq<D, LD, kDqTcRows>(base + 2 * TILE, q + bh * nq * D, q0, nq, tid);
  load_rows_dq<D, LD, kDqTcRows>(base + 3 * TILE, dout + bh * nq * D, q0, nq, tid);
  load_rows_dq<D, LD, kDqTcKv>(base, kb, 0, nk, tid);
  load_rows_dq<D, LD, kDqTcKv>(base + TILE, vb, 0, nk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(qa[kk], base + 2 * TILE, LD, warp * 16, kk * 16, lane);
    load_a(da[kk], base + 3 * TILE, LD, warp * 16, kk * 16, lane);
  }
  // rows lane / 4 (h = 0) and lane / 4 + 8 (h = 1): −lse·log2e and delta;
  // −inf past Nq gives p = 0 there (its dq is not stored)
  float nl[2], de[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    const bool ok = row < nq;
    nl[h] = ok ? -lse[bh * nq + row] * kLog2e : -CUDART_INF_F;
    de[h] = ok ? delta[bh * nq + row] : 0.f;
  }
  float dqa[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  const float c = scale * kLog2e;
  __syncthreads();  // q and dout are in registers: tile 1's buffers are free

  for (int t = 0; t < n_tiles; ++t) {
    const bf16* ks = base + (t & 1) * 2 * TILE;
    const bf16* vs = ks + TILE;
    if (t + 1 < n_tiles) {  // the next tile, into the buffer tile t − 1 used
      bf16* nxt = base + ((t + 1) & 1) * 2 * TILE;
      load_rows_dq<D, LD, kDqTcKv>(nxt, kb, static_cast<long long>(t + 1) * kDqTcKv, nk, tid);
      load_rows_dq<D, LD, kDqTcKv>(nxt + TILE, vb, static_cast<long long>(t + 1) * kDqTcKv, nk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t is in shared memory
    const long long kv0 = static_cast<long long>(t) * kDqTcKv;
    const bool ragged = kv0 + kDqTcKv > nk;

    // 16 keys at a time: S = q·kᵀ and dP = dout·vᵀ (k and v rows the B
    // operand as they lie); element e of tile t2 is key 8·t2 + 2·(lane % 4)
    // + e % 2 of the 16, row lane / 4 + 8·(e / 2)
#pragma unroll
    for (int j = 0; j < kDqTcKv / 16; ++j) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int boff = (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, ks + boff + kk * 16);
        mma16816(s[0], qa[kk], b[0], b[1]);
        mma16816(s[1], qa[kk], b[2], b[3]);
        ldsm_x4(b, vs + boff + kk * 16);
        mma16816(dp[0], da[kk], b[0], b[1]);
        mma16816(dp[1], da[kk], b[2], b[3]);
      }
      // p = exp2(s·scale·log2e − lse·log2e), 0 past Nk; ds = p·(dp − delta)
      // rounded to bf16 (as _bwd_dq_kernel's ds.astype(k.dtype)): the A
      // fragment of dQ += dS·K as it lies
      uint32_t a[4];
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            float p = exp2f(fmaf(s[t2][2 * h + e2], c, nl[h]));
            if (ragged && kv0 + j * 16 + 8 * t2 + 2 * (lane & 3) + e2 >= nk) p = 0.f;
            ds[e2] = p * (dp[t2][2 * h + e2] - de[h]);
          }
          a[2 * t2 + h] = pack_bf16x2(ds[0], ds[1]);
        }
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t b[4];
        load_b2(b, ks, LD, j * 16, jd * 16, lane);
        mma16816(dqa[2 * jd], a, b[0], b[1]);
        mma16816(dqa[2 * jd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // tile t's buffers are no longer read: the next copy may reuse them
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= nq) continue;
    bf16* dst = dq + (bh * nq + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16x2(dqa[j][2 * h] * scale, dqa[j][2 * h + 1] * scale);
  }
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, long long bh, long long nq, long long nk,
                 float scale, cudaStream_t stream) {
  constexpr int smem = 4 * dq_tc_tile<D>() * 2;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((nq + kDqTcRows - 1) / kDqTcRows),
                  static_cast<unsigned>(bh));
  flash_bwd_dq_tc_kernel<D><<<grid, kDqTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
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

// The instance of L a call takes, likewise: bf16 on the tensor cores, fp32 on
// the CUDA cores; read through hvc_flash_attention_bwd_dq_tc.
bool dq_uses_tc(int dtype) { return dtype == 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout 16-byte aligned).
// head_dim: 32, 64 or 128. Returns a cudaError_t.
extern "C" int hvc_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, long long bh,
                                          long long nq, long long nk, int head_dim, int dtype,
                                          float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq_uses_tc(dtype)) {
    if (!sizes_ok(bh, nq, nk, kDqTcRows, nq)) return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (head_dim == 32) return launch_dq_tc<32>(q, k, v, dout, lse, delta, dq, bh, nq, nk, scale, s);
    if (head_dim == 64) return launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, bh, nq, nk, scale, s);
    if (head_dim == 128)
      return launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, bh, nq, nk, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!sizes_ok(bh, nq, nk, kDqRows, nq)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nq + kDqRows - 1) / kDqRows), static_cast<unsigned>(bh));
#define HVC_DQ(T, D)                                                                          \
  flash_bwd_dq_kernel<T, D><<<grid, kDqRows * (D / kDh), 0, s>>>(                              \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),            \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                             \
      static_cast<const float*>(delta), static_cast<T*>(dq), nq, nk, scale)
  if (dtype == 0 && head_dim == 32) {
    HVC_DQ(float, 32);
  } else if (dtype == 0 && head_dim == 64) {
    HVC_DQ(float, 64);
  } else if (dtype == 0 && head_dim == 128) {
    HVC_DQ(float, 128);
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
    if (head_dim == 128)
      return launch_bwd_tc<128, false>(q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk,
                                       dv, bh, nq, nk, scale, s);
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
  } else if (dtype == 0 && head_dim == 128) {
    HVC_DKV(float, 128);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HVC_DKV
  return static_cast<int>(cudaGetLastError());
}

// 1 if hvc_flash_attention_bwd_dkv runs a call of this dtype (0 = float32,
// 1 = bfloat16) on the tensor cores, else 0: the rule of its dispatch.
extern "C" int hvc_flash_attention_bwd_dkv_tc(int dtype) { return dkv_uses_tc(dtype) ? 1 : 0; }

// 1 if hvc_flash_attention_bwd_dq runs a call of this dtype on the tensor
// cores, else 0: the rule of its dispatch.
extern "C" int hvc_flash_attention_bwd_dq_tc(int dtype) { return dq_uses_tc(dtype) ? 1 : 0; }
