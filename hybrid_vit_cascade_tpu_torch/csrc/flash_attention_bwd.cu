// Kernel D: flash attention backward for Hopper (sm_90a).
//
// Replaces hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py::_bwd_pallas_fused
// (kernel body _bwd_fused_kernel): dq, dk and dv of out = softmax(q·kᵀ·scale)·v
// from one sweep, recomputing the probabilities from the forward's per-row
// log-sum-exp, with delta = Σ_d do·out precomputed per query row (the caller
// passes it, as _bwd_pallas_fused computes it before the pallas_call). The
// TPU kernel's grid runs in order, so it carries dq in VMEM across its key
// sweep; Hopper blocks run concurrently and in no order, so dq needs its own
// scheme here (below). The lse is the natural-log one kernel A stores; there
// is no base-2/LN2 bookkeeping, no 128-lane padding of d and no lse = 1e30
// padded rows: bounds checks and zero-filled loads mask the ragged tails.
//
// What bounds it on this card: at the main path's long shapes (8 heads ×
// 32,768 × 32,768, d = 32) it does 5 products of N²·d per head (s, dp, dv,
// dk, dq: 2.78 ms at the 989 TFLOP/s bf16 peak) and one exp2 per score
// (8.6e9 exp2 on the special-function units, 16 a clock per SM: 2.05 ms at
// 1.98 GHz); it reads a few MB, so it is compute-bound. Two instances, by an
// explicit rule (bwd_uses_tc, which the wrapper reads through
// hvc_flash_attention_bwd_tc; no fallback): bf16 on the tensor cores, fp32 on
// the CUDA cores (TF32 would leave the fp32 tolerances).
//
// bf16 on the tensor cores (flash_bwd_tc_kernel<D, true>, in flash_bwd_tc.cuh,
// which kernel M shares without its dq phase): FlashAttention-2's backward on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), work items of one head's 128
// keys with k, v, dk and dv in registers, query tiles of 64 double-buffered by
// cp.async, P and dS rounded to bf16 as the TPU kernel rounds them and taken
// as A operands straight from the accumulator fragments (one FFMA and one
// exp2 a score: the exp2 term above stays; the products, not the exps, share
// the warps' issue slots with it). The dq share dS·K goes through shared
// memory; dq is added without atomics and without per-group partials into
// one fp32 (BH, Nq, d) accumulator (32 MB at the hot shape, inside the 50 MB
// L2; the CUDA-core instance's G = 64 partials held 2.15 GB and re-read each
// from device memory), in key-tile order under a counter per (head, query
// tile), so two runs give the same bits, as the TPU kernel's grid-order sum
// does; a persistent grid takes the items in index order, so an item waits
// only on a lower, running one. The blocks of a head sweep its query tiles in
// the same order, a key tile behind another by about one tile's add. A last
// kernel scales the accumulator and casts it to bf16.
//
// fp32 on the CUDA cores (flash_bwd_kernel): a block owns a group of
// consecutive key tiles of 64 keys and takes them one after the other: for
// each it sweeps every query tile, one key row per thread (d = 32) or a half
// or a quarter of one (d = 64, 128: the parts combined with warp shuffles) holding its
// k, v, dk and dv slices in registers, the query tile's q, dout, lse and delta
// staged once per block in shared memory and read as float4 broadcasts (four
// FMAs per shared-memory load); the dq share ds·K is a small register-blocked
// product from shared memory, added into the group's own fp32 (BH, Nq, d)
// partial by a plain read-modify-write (the group's first tile writes it).
// Each partial element has one writer, which adds the key tiles in order, and
// a second small kernel adds the G partials in group order (repeatable bits).
// The caller picks G (about 4 blocks per SM; every group non-empty) and
// allocates the (G, BH, Nq, d) partials uninitialised. Its shared memory is
// dynamic: 41 KB at d = 32 and 64, 74 KB at d = 128.
//
// d = 128 (any other d ≤ 128 arrives zero-padded to 32, 64 or 128): the
// tensor-core instance keeps its tiles (128 keys an item, query tiles of 64,
// so the dq scratch and counters are sized as at d ≤ 64) but no longer holds
// the k and v fragments in registers: it reads them from shared memory at
// each use and takes a query tile's scores 32 queries at a time, so that dk
// and dv (128 fp32 registers a thread) fit in 255 registers (flash_bwd_tc.cuh).
//
// Layout: q (BH, Nq, d), k and v (BH, Nk, d), dout (BH, Nq, d), contiguous,
// fp32 or bf16 (the bf16 ones 16-byte aligned); lse and delta (BH, Nq) fp32;
// dq (BH, Nq, d), dk and dv (BH, Nk, d) in the input dtype. All offsets
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kBkv = 64;  // keys per key tile
constexpr int kDh = 32;   // columns owned by one thread

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

template <int D>
struct BwdShape {
  static constexpr int kTpr = D / kDh;                 // threads per key row
  static constexpr int kThreads = kBkv * kTpr;
  static constexpr int kBq = D == 32 ? 64 : 32;        // query rows per staged tile
  static constexpr int kColGroups = D / 4;             // float4 columns of dq
  static constexpr int kRows = kBq * kColGroups / kThreads;  // dq rows per thread
  static constexpr int kDss = kBkv + 1;                // ds row stride: conflict-free column reads
  // q, dout and ks tiles, ds, lse and delta, fp32, dynamic
  static constexpr int kSmem = (2 * kBq * D + kBkv * D + kBq * kDss + 2 * kBq) * 4;
};

// Grid (G, BH): block (grp, bh) takes key tiles grp·per … grp·per + per − 1
// (those below n_tiles) in order and writes dq_part[grp, bh].
template <typename T, int D>
__global__ void __launch_bounds__(BwdShape<D>::kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_part,
                 T* __restrict__ dk, T* __restrict__ dv, long long bhs, long long nq,
                 long long nk, long long per, float scale) {
  using S = BwdShape<D>;
  constexpr int TPR = S::kTpr;
  constexpr int NT = S::kThreads;
  constexpr int BQ = S::kBq;
  constexpr int CG = S::kColGroups;
  constexpr int RQ = S::kRows;
  constexpr int DSS = S::kDss;
  static_assert(RQ * (NT / CG) == BQ, "dq tile must cover the query tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // BQ × D
  float* dos = qs + BQ * D;                         // BQ × D
  float* ks = dos + BQ * D;                         // kBkv × D
  float* ds_s = ks + kBkv * D;                      // BQ × DSS
  float* lse_s = ds_s + BQ * DSS;                   // BQ
  float* delta_s = lse_s + BQ;                      // BQ

  const long long grp = blockIdx.x;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int jr = tid / TPR;         // key row within the tile
  const int c0 = (tid % TPR) * kDh;  // first column owned by this thread
  const float scale_log2 = scale * kLog2e;
  const int cg = tid % CG;  // dq phase: float4 column group
  const int rg = tid / CG;  // dq phase: row group

  const T* qb = q + bh * nq * D;
  const T* dob = dout + bh * nq * D;
  const T* kb = k + bh * nk * D;
  const T* vb = v + bh * nk * D;
  float* dqb = dq_part + (grp * bhs + bh) * nq * D;

  const long long n_tiles = (nk + kBkv - 1) / kBkv;
  const long long kt_end = min(n_tiles, (grp + 1) * per);
  for (long long kt = grp * per; kt < kt_end; ++kt) {
    const bool first = kt == grp * per;  // writes the partial; later tiles add to it
    const long long kv0 = kt * kBkv;
    const long long j = kv0 + jr;
    const bool jvalid = j < nk;

    float kr[kDh], vr[kDh], dkr[kDh], dvr[kDh];
    {
      const T* krow = kb + (jvalid ? j : 0) * D + c0;
      const T* vrow = vb + (jvalid ? j : 0) * D + c0;
#pragma unroll
      for (int c = 0; c < kDh; ++c) {
        kr[c] = jvalid ? to_f32(krow[c]) : 0.f;
        vr[c] = jvalid ? to_f32(vrow[c]) : 0.f;
        dkr[c] = 0.f;
        dvr[c] = 0.f;
      }
    }
    __syncthreads();  // the previous key tile's ks is no longer read
    for (int i = tid; i < kBkv * D; i += NT) {
      const bool in = kv0 + i / D < nk;
      ks[i] = in ? to_f32(kb[kv0 * D + i]) : 0.f;
    }

    for (long long q0 = 0; q0 < nq; q0 += BQ) {
      __syncthreads();  // the previous query tile is no longer read
      for (int i = tid; i < BQ * D; i += NT) {
        const bool in = q0 + i / D < nq;
        qs[i] = in ? to_f32(qb[q0 * D + i]) : 0.f;
        dos[i] = in ? to_f32(dob[q0 * D + i]) : 0.f;
      }
      for (int i = tid; i < BQ; i += NT) {
        const bool in = q0 + i < nq;
        // base 2, so p = exp2(s·scale·log2e − lse·log2e); +inf gives p = 0 on
        // the rows past Nq
        lse_s[i] = in ? lse[bh * nq + q0 + i] * kLog2e : CUDART_INF_F;
        delta_s[i] = in ? delta[bh * nq + q0 + i] : 0.f;
      }
      __syncthreads();

      for (int i = 0; i < BQ; ++i) {
        const float4* qrow = reinterpret_cast<const float4*>(qs + i * D + c0);
        const float4* drow = reinterpret_cast<const float4*>(dos + i * D + c0);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < kDh / 4; ++c4) {
          const float4 qq = qrow[c4];
          const float4 dd = drow[c4];
          s = fmaf(qq.x, kr[4 * c4 + 0], s);
          s = fmaf(qq.y, kr[4 * c4 + 1], s);
          s = fmaf(qq.z, kr[4 * c4 + 2], s);
          s = fmaf(qq.w, kr[4 * c4 + 3], s);
          dp = fmaf(dd.x, vr[4 * c4 + 0], dp);
          dp = fmaf(dd.y, vr[4 * c4 + 1], dp);
          dp = fmaf(dd.z, vr[4 * c4 + 2], dp);
          dp = fmaf(dd.w, vr[4 * c4 + 3], dp);
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) {  // the parts of a key row are neighbouring lanes
          s += __shfl_xor_sync(0xffffffffu, s, o);
          dp += __shfl_xor_sync(0xffffffffu, dp, o);
        }
        const float p = jvalid ? exp2f(fmaf(s, scale_log2, -lse_s[i])) : 0.f;
        const float ds = p * (dp - delta_s[i]);
#pragma unroll
        for (int c4 = 0; c4 < kDh / 4; ++c4) {
          const float4 qq = qrow[c4];
          const float4 dd = drow[c4];
          dvr[4 * c4 + 0] = fmaf(p, dd.x, dvr[4 * c4 + 0]);
          dvr[4 * c4 + 1] = fmaf(p, dd.y, dvr[4 * c4 + 1]);
          dvr[4 * c4 + 2] = fmaf(p, dd.z, dvr[4 * c4 + 2]);
          dvr[4 * c4 + 3] = fmaf(p, dd.w, dvr[4 * c4 + 3]);
          dkr[4 * c4 + 0] = fmaf(ds, qq.x, dkr[4 * c4 + 0]);
          dkr[4 * c4 + 1] = fmaf(ds, qq.y, dkr[4 * c4 + 1]);
          dkr[4 * c4 + 2] = fmaf(ds, qq.z, dkr[4 * c4 + 2]);
          dkr[4 * c4 + 3] = fmaf(ds, qq.w, dkr[4 * c4 + 3]);
        }
        if (c0 == 0) ds_s[i * DSS + jr] = ds;
      }
      __syncthreads();

      // dq[i, :] += scale · Σ_j ds[i, j] · k[j, :] for this key tile
      float acc[RQ][4];
#pragma unroll
      for (int r = 0; r < RQ; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int jj = 0; jj < kBkv; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + jj * D + cg * 4);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float d = ds_s[(rg * RQ + r) * DSS + jj];
          acc[r][0] = fmaf(d, kk.x, acc[r][0]);
          acc[r][1] = fmaf(d, kk.y, acc[r][1]);
          acc[r][2] = fmaf(d, kk.z, acc[r][2]);
          acc[r][3] = fmaf(d, kk.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const long long row = q0 + rg * RQ + r;
        if (row < nq) {
          float4* dst = reinterpret_cast<float4*>(dqb + row * D + cg * 4);
          float4 val = make_float4(acc[r][0] * scale, acc[r][1] * scale, acc[r][2] * scale,
                                   acc[r][3] * scale);
          if (!first) {
            const float4 old = *dst;
            val = make_float4(old.x + val.x, old.y + val.y, old.z + val.z, old.w + val.w);
          }
          *dst = val;
        }
      }
    }

    if (jvalid) {
      T* dkrow = dk + (bh * nk + j) * D + c0;
      T* dvrow = dv + (bh * nk + j) * D + c0;
#pragma unroll
      for (int c = 0; c < kDh; ++c) {
        dkrow[c] = from_f32<T>(dkr[c] * scale);
        dvrow[c] = from_f32<T>(dvr[c]);
      }
    }
  }
}

// dq[i] = Σ_g dq_part[g][i] in group order, cast to T.
template <typename T>
__global__ void sum_groups_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                                  long long n, int groups) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += dq_part[g * n + i];
  dq[i] = from_f32<T>(s);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq_part, void* dq, void* dk, void* dv, long long bh,
           long long nq, long long nk, int groups, float scale, cudaStream_t stream) {
  const long long n_tiles = (nk + kBkv - 1) / kBkv;
  const long long per = (n_tiles + groups - 1) / groups;
  // every group takes at least one key tile: its partial is written
  if (groups < 1 || groups > n_tiles || (groups - 1) * per >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = BwdShape<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(bh));
  flash_bwd_kernel<T, D><<<grid, BwdShape<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_part), static_cast<T*>(dk),
      static_cast<T*>(dv), bh, nq, nk, per, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = bh * nq * D;
  sum_groups_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<T*>(dq), n, groups);
  return static_cast<int>(cudaGetLastError());
}

// The instance a call takes, an explicit rule (no fallback): bf16 on the
// tensor cores, fp32 on the CUDA cores. The wrapper reads it through
// hvc_flash_attention_bwd_tc to size the scratch and count launches.
bool bwd_uses_tc(int dtype) { return dtype == 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32, 64 or 128. Scratch by instance
// (bwd_uses_tc): the tensor cores take dq_scratch as the fp32 (BH, Nq, d)
// accumulator and counters as 1 + BH·⌈Nq/64⌉ int32, all zero (groups is not
// read); the CUDA cores take dq_scratch as the G = groups partials
// (G·BH·Nq·d fp32; 1 ≤ G ≤ ⌈Nk/64⌉, every group non-empty) and do not read
// counters. Returns a cudaError_t.
extern "C" int hvc_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq_scratch, void* counters, void* dq, void* dk,
                                       void* dv, long long bh, long long nq, long long nk,
                                       int head_dim, int dtype, int groups, float scale,
                                       void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || bh * nq * head_dim / 256 > 2147483646LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_uses_tc(dtype)) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (head_dim == 32)
      return launch_bwd_tc<32, true>(q, k, v, dout, lse, delta, dq_scratch, counters, dq, dk, dv,
                                     bh, nq, nk, scale, s);
    if (head_dim == 64)
      return launch_bwd_tc<64, true>(q, k, v, dout, lse, delta, dq_scratch, counters, dq, dk, dv,
                                     bh, nq, nk, scale, s);
    if (head_dim == 128)
      return launch_bwd_tc<128, true>(q, k, v, dout, lse, delta, dq_scratch, counters, dq, dk,
                                      dv, bh, nq, nk, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define LAUNCH_BWD(T, D) \
  launch<T, D>(q, k, v, dout, lse, delta, dq_scratch, dq, dk, dv, bh, nq, nk, groups, scale, s)
  if (dtype == 0 && head_dim == 32) return LAUNCH_BWD(float, 32);
  if (dtype == 0 && head_dim == 64) return LAUNCH_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) return LAUNCH_BWD(float, 128);
#undef LAUNCH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 if hvc_flash_attention_bwd runs a call of this dtype (0 = float32, 1 =
// bfloat16) on the tensor cores, else 0: the rule of its dispatch.
extern "C" int hvc_flash_attention_bwd_tc(int dtype) { return bwd_uses_tc(dtype) ? 1 : 0; }
