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
// bf16 on the tensor cores (flash_bwd_tc_kernel), FlashAttention-2's backward
// on mma.sync m16n8k16 (bf16 in, fp32 accumulate). A work item is one head's
// key tile of 128 keys, 16 a warp over 8 warps; the warp's k and v fragments
// stay in registers and its dk and dv accumulate there across the sweep over
// the head's query tiles of 64 rows, whose q, dout, lse and delta are
// double-buffered in shared memory by cp.async. Per query tile, keys as M:
// Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ (q and dout rows are the B operand as they
// lie), p = exp2(s·scale·log2e − lse·log2e) (one FFMA and one exp2 a score:
// the exp2 term above stays; the products, not the exps, share the warps'
// issue slots with it), ds = p·(dp − delta); then dV += P·dout and dK += dS·q
// take P and dS, rounded to bf16 as the TPU kernel rounds them (pb = p.astype,
// dsb = ds.astype), straight from the first products' accumulator fragments
// as A operands, so P is never transposed. The dq share dS·K needs queries as
// M: dS goes once through shared memory as bf16 ([key][query]) and comes back
// by ldmatrix.trans; warp w computes 16 query rows × d/2 columns of it.
//
// dq without atomics and without per-group partials: one fp32 (BH, Nq, d)
// accumulator (32 MB at the hot shape, inside the 50 MB L2; the CUDA-core
// instance's G = 64 partials held 2.15 GB and re-read each from device
// memory). Its adds into a query tile's rows happen in key-tile order, so two
// runs give the same bits, as the TPU kernel's grid-order sum does: each
// (head, query tile) has an int32 counter, zeroed per call; the item of key
// tile kt waits until the counter reads kt (ld.acquire.gpu, one thread, then
// a barrier), writes (kt = 0) or read-modify-writes its share through L2
// (ld/st.cg), and publishes kt + 1 (fence, st.release.gpu). Items are handed
// out in increasing index kt·BH + bh by an atomic counter to a persistent
// grid (the blocks the occupancy calculator allows on every SM): the item an
// item waits on has a lower index, so it went to a block that is already
// running, and progress never depends on launch order or on how many blocks
// are resident. The blocks of a head sweep its query tiles in the same
// order, a key tile behind another by about one tile's add. A last kernel
// scales the accumulator and casts it to bf16.
//
// fp32 on the CUDA cores (flash_bwd_kernel): a block owns a group of
// consecutive key tiles of 64 keys and takes them one after the other: for
// each it sweeps every query tile, one key row per thread (d = 32) or half
// of one (d = 64, the two halves combined with one warp shuffle) holding its
// k, v, dk and dv slices in registers, the query tile's q, dout, lse and delta
// staged once per block in shared memory and read as float4 broadcasts (four
// FMAs per shared-memory load); the dq share ds·K is a small register-blocked
// product from shared memory, added into the group's own fp32 (BH, Nq, d)
// partial by a plain read-modify-write (the group's first tile writes it).
// Each partial element has one writer, which adds the key tiles in order, and
// a second small kernel adds the G partials in group order (repeatable bits).
// The caller picks G (about 4 blocks per SM; every group non-empty) and
// allocates the (G, BH, Nq, d) partials uninitialised.
//
// Layout: q (BH, Nq, d), k and v (BH, Nk, d), dout (BH, Nq, d), contiguous,
// fp32 or bf16 (the bf16 ones 16-byte aligned); lse and delta (BH, Nq) fp32;
// dq (BH, Nq, d), dk and dv (BH, Nk, d) in the input dtype. All offsets
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
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
  constexpr int DSS = kBkv + 1;  // ds row stride: conflict-free column reads
  static_assert(RQ * (NT / CG) == BQ, "dq tile must cover the query tile");

  __shared__ __align__(16) float qs[BQ * D];
  __shared__ __align__(16) float dos[BQ * D];
  __shared__ __align__(16) float ks[kBkv * D];
  __shared__ float ds_s[BQ * DSS];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

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
        if (TPR == 2) {  // the two halves of a key row are neighbouring lanes
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          dp += __shfl_xor_sync(0xffffffffu, dp, 1);
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
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(bh));
  flash_bwd_kernel<T, D><<<grid, BwdShape<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_part), static_cast<T*>(dk),
      static_cast<T*>(dv), bh, nq, nk, per, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = bh * nq * D;
  sum_groups_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<T*>(dq), n, groups);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- D on the tensor cores ---

constexpr int kTbWarps = 8;
constexpr int kTbThreads = kTbWarps * 32;
constexpr int kTbKeys = 16 * kTbWarps;  // keys per work item: 16 a warp
constexpr int kTbRows = 64;             // query rows per tile

template <int D>
struct TbShape {
  static constexpr int LD = D + 8;                // bf16 per q / k / v / dout row: 16 bytes of
                                                  // padding, ldmatrix conflict-free
  static constexpr int LDS = kTbRows + 8;         // bf16 per dS row ([key][query])
  static constexpr int KV = kTbKeys * LD;         // bf16, one of k, v
  static constexpr int QT = kTbRows * LD;         // bf16, one of q, dout, per buffer
  static constexpr int DS = kTbKeys * LDS;        // bf16
  static constexpr int SMEM = (2 * KV + 4 * QT + DS) * 2 + 4 * kTbRows * 4;  // + lse, delta × 2
  static constexpr int MIN_BLOCKS = D == 32 ? 2 : 1;  // ≤ 128 registers a thread at d = 32
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p reads `want` (acquire). The wait is bounded: the item waited
// on is always running (items go out in index order), so a wait of seconds
// is a fault, and a trap reports it as a launch failure instead of hanging
// the card.
__device__ __forceinline__ void wait_for(const int* p, int want) {
  if (ld_acquire(p) == want) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(p) != want) {
    if (global_ns() - t0 > 10000000000ULL) __trap();
  }
}

// rows [r0, r0 + N) of a (rows, D) bf16 array into shared rows of LD, 16
// bytes a thread, zero-filled past `rows`
template <int D, int LD, int N>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long r0,
                                          long long rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < N * kChunks; c += kTbThreads) {
    const int r = c / kChunks, k8 = (c % kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + k8, ok ? src + (r0 + r) * D + k8 : src, ok ? 16 : 0);
  }
}

// counters: [0] the next work item, then one per (head, query tile), all zero
// at launch. Item i is key tile i / BH of head i % BH.
template <int D>
__global__ void __launch_bounds__(kTbThreads, TbShape<D>::MIN_BLOCKS)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq_acc, int* __restrict__ counters, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int bhs, long long nq, long long nk, float scale) {
  using TS = TbShape<D>;
  constexpr int LD = TS::LD, LDS = TS::LDS;
  constexpr int KS = D / 16;  // k-steps of the products over d
  constexpr int DT = D / 8;   // 8-column tiles of dk, dv
  constexpr int QN = D / 16;  // 8-column tiles of a warp's dq share (d / 2 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // k, v; q and dout of buffer b at qs0 + b·QT, dos0 + b·QT; dS; lse and
  // delta of buffer b at lse0 + b·64, del0 + b·64
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TS::KV;
  bf16* qs0 = vs + TS::KV;
  bf16* dos0 = qs0 + 2 * TS::QT;
  bf16* dss = dos0 + 2 * TS::QT;
  float* lse0 = reinterpret_cast<float*>(dss + TS::DS);
  float* del0 = lse0 + 2 * kTbRows;
  __shared__ int item_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_qt = static_cast<int>((nq + kTbRows - 1) / kTbRows);
  const long long n_items = static_cast<long long>(bhs) * ((nk + kTbKeys - 1) / kTbKeys);
  const float c = scale * kLog2e;
  // this warp's share of the dq product: query rows 16·(warp / 2) …, columns
  // (warp % 2)·d/2 …
  const int mq = warp >> 1, n0 = (warp & 1) * (D / 2);

  for (;;) {
    if (tid == 0) item_s = atomicAdd(counters, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= n_items) break;
    const long long bh = item % bhs;
    const int kt = item / bhs;
    const long long k0 = static_cast<long long>(kt) * kTbKeys;
    const bf16* qb = q + bh * nq * D;
    const bf16* dob = dout + bh * nq * D;
    const float* lb = lse + bh * nq;
    const float* db = delta + bh * nq;
    int* tile_cnt = counters + 1 + bh * n_qt;

    // the query tile qt into buffer buf: q and dout rows, lse and delta, zero
    // past Nq (a zero row gives p = 1, but dp = delta = 0 there, so ds = 0, and
    // its dout row is zero, so it adds nothing to dv; its dq is not stored)
    auto stage = [&](int qt, int buf) {
      const long long r0 = static_cast<long long>(qt) * kTbRows;
      load_tile<D, LD, kTbRows>(qs0 + buf * TS::QT, qb, r0, nq, tid);
      load_tile<D, LD, kTbRows>(dos0 + buf * TS::QT, dob, r0, nq, tid);
      if (tid < 2 * kTbRows) {
        const int r = tid % kTbRows;
        const bool ok = r0 + r < nq;
        const float* src = tid < kTbRows ? lb : db;
        float* dst = (tid < kTbRows ? lse0 : del0) + buf * kTbRows;
        cp_async4(dst + r, ok ? src + r0 + r : src, ok ? 4 : 0);
      }
    };
    load_tile<D, LD, kTbKeys>(ks, k + bh * nk * D, k0, nk, tid);
    load_tile<D, LD, kTbKeys>(vs, v + bh * nk * D, k0, nk, tid);
    stage(0, 0);
    cp_async_commit();

    // keys of this thread's fragment rows; p is zero past Nk
    const bool key_ok[2] = {k0 + warp * 16 + (lane >> 2) < nk, k0 + warp * 16 + (lane >> 2) + 8 < nk};
    uint32_t kf[KS][4], vf[KS][4];
    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

    for (int qt = 0; qt < n_qt; ++qt) {
      const int buf = qt & 1;
      if (qt + 1 < n_qt) stage(qt + 1, buf ^ 1);  // into the buffer tile qt − 1 used
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile qt (and, the first time, k and v) is in shared memory
      const bf16* qsb = qs0 + buf * TS::QT;
      const bf16* dosb = dos0 + buf * TS::QT;
      const float* lse_s = lse0 + buf * kTbRows;
      const float* del_s = del0 + buf * kTbRows;
      if (qt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          load_a(kf[kk], ks, LD, warp * 16, kk * 16, lane);
          load_a(vf[kk], vs, LD, warp * 16, kk * 16, lane);
        }
      }

      // dPᵀ = V·doutᵀ, then Sᵀ = K·qᵀ two 8-query tiles at a time, each turned
      // into P and dS at once: element e of tile j is key lane / 4 + 8·(e / 2)
      // of the warp's 16, query 8j + 2·(lane % 4) + e % 2 of the tile
      float dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          uint32_t b[4];
          ldsm_x4(b, dosb + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         (((lane >> 3) & 1) << 3));
          mma16816(dp[2 * j2], vf[kk], b[0], b[1]);
          mma16816(dp[2 * j2 + 1], vf[kk], b[2], b[3]);
        }
      uint32_t pb[8][2], dsb[8][2];  // bf16 pairs [tile][row half]
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b[4];
          ldsm_x4(b, qsb + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         (((lane >> 3) & 1) << 3));
          mma16816(s[0], kf[kk], b[0], b[1]);
          mma16816(s[1], kf[kk], b[2], b[3]);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 2 * j2 + t;
          const int col = 8 * j + 2 * (lane & 3);
          const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 dl = *reinterpret_cast<const float2*>(del_s + col);
          const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
          const float de[2] = {dl.x, dl.y};
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = key_ok[e >> 1] ? exp2f(fmaf(s[t][e], c, nl[e & 1])) : 0.f;
            ds[e] = p[e] * (dp[j][e] - de[e & 1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            pb[j][h] = pack_bf16x2(p[2 * h], p[2 * h + 1]);
            dsb[j][h] = pack_bf16x2(ds[2 * h], ds[2 * h + 1]);
            *reinterpret_cast<uint32_t*>(dss + (warp * 16 + (lane >> 2) + 8 * h) * LDS + col) =
                dsb[j][h];
          }
        }
      }

      // dV += P·dout, dK += dS·q: queries 16·kk … are one k-step, the
      // fragments of tiles 2kk and 2kk + 1 its A operand
#pragma unroll
      for (int kk = 0; kk < kTbRows / 16; ++kk) {
        const uint32_t ap[4] = {pb[2 * kk][0], pb[2 * kk][1], pb[2 * kk + 1][0], pb[2 * kk + 1][1]};
        const uint32_t ad[4] = {dsb[2 * kk][0], dsb[2 * kk][1], dsb[2 * kk + 1][0],
                                dsb[2 * kk + 1][1]};
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          uint32_t b[4];
          load_b2(b, dosb, LD, kk * 16, jd * 16, lane);
          mma16816(dva[2 * jd], ap, b[0], b[1]);
          mma16816(dva[2 * jd + 1], ap, b[2], b[3]);
          load_b2(b, qsb, LD, kk * 16, jd * 16, lane);
          mma16816(dka[2 * jd], ad, b[0], b[1]);
          mma16816(dka[2 * jd + 1], ad, b[2], b[3]);
        }
      }
      __syncthreads();  // dS of all 128 keys is in shared memory

      // this item's dq share of query rows 16·mq … (keys as K): A = dSᵀ by
      // ldmatrix.trans of the [key][query] rows, B = k rows
      float dqa[QN][4];
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTbKeys / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4_t(a, dss + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + mq * 16 +
                         (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int jd = 0; jd < QN / 2; ++jd) {
          uint32_t b[4];
          load_b2(b, ks, LD, kk * 16, n0 + jd * 16, lane);
          mma16816(dqa[2 * jd], a, b[0], b[1]);
          mma16816(dqa[2 * jd + 1], a, b[2], b[3]);
        }
      }

      // add it in key-tile order: wait for key tile kt − 1's add to this tile
      int* cnt = tile_cnt + qt;
      if (tid == 0) wait_for(cnt, kt);
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = static_cast<long long>(qt) * kTbRows + mq * 16 + (lane >> 2) + 8 * h;
        if (row >= nq) continue;
        float* dst = dq_acc + (bh * nq + row) * D + n0 + 2 * (lane & 3);
        float2 old[QN];
        if (kt > 0) {
#pragma unroll
          for (int j = 0; j < QN; ++j) old[j] = __ldcg(reinterpret_cast<const float2*>(dst + 8 * j));
        }
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          float2 val = make_float2(dqa[j][2 * h], dqa[j][2 * h + 1]);
          if (kt > 0) val = make_float2(old[j].x + val.x, old[j].y + val.y);
          __stcg(reinterpret_cast<float2*>(dst + 8 * j), val);
        }
      }
      __syncthreads();  // every add of this block is issued; the buffers of tile qt are free
      if (tid == 0) {
        __threadfence();
        st_release(cnt, kt + 1);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long key = k0 + warp * 16 + (lane >> 2) + 8 * h;
      if (!key_ok[h]) continue;
      bf16* dkr = dk + (bh * nk + key) * D + 2 * (lane & 3);
      bf16* dvr = dv + (bh * nk + key) * D + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
            pack_bf16x2(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j) = pack_bf16x2(dva[j][2 * h], dva[j][2 * h + 1]);
      }
    }
  }
}

// dq[i] = bf16(dq_acc[i] · scale)
__global__ void scale_cast_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                                  long long n, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dq[i] = __float2bfloat16_rn(acc[i] * scale);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq_acc, void* counters, void* dq, void* dk, void* dv,
              long long bh, long long nq, long long nk, float scale, cudaStream_t stream) {
  using TS = TbShape<D>;
  const long long n_items = bh * ((nk + kTbKeys - 1) / kTbKeys);
  if (n_items > 2147483647LL || counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_tc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TS::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kTbThreads, TS::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid = n_items < static_cast<long long>(per_sm) * sms
                             ? n_items : static_cast<long long>(per_sm) * sms;
  kern<<<static_cast<unsigned>(grid), kTbThreads, TS::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<int*>(counters),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<int>(bh), nq, nk, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = bh * nq * D;
  scale_cast_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instance a call takes, an explicit rule (no fallback): bf16 on the
// tensor cores, fp32 on the CUDA cores. The wrapper reads it through
// hvc_flash_attention_bwd_tc to size the scratch and count launches.
bool bwd_uses_tc(int dtype) { return dtype == 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Scratch by instance
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
      return launch_tc<32>(q, k, v, dout, lse, delta, dq_scratch, counters, dq, dk, dv, bh, nq, nk,
                           scale, s);
    if (head_dim == 64)
      return launch_tc<64>(q, k, v, dout, lse, delta, dq_scratch, counters, dq, dk, dv, bh, nq, nk,
                           scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define LAUNCH_BWD(T, D) \
  launch<T, D>(q, k, v, dout, lse, delta, dq_scratch, dq, dk, dv, bh, nq, nk, groups, scale, s)
  if (dtype == 0 && head_dim == 32) return LAUNCH_BWD(float, 32);
  if (dtype == 0 && head_dim == 64) return LAUNCH_BWD(float, 64);
#undef LAUNCH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 if hvc_flash_attention_bwd runs a call of this dtype (0 = float32, 1 =
// bfloat16) on the tensor cores, else 0: the rule of its dispatch.
extern "C" int hvc_flash_attention_bwd_tc(int dtype) { return bwd_uses_tc(dtype) ? 1 : 0; }
