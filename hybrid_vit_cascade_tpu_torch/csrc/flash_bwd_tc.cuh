// The tensor-core flash attention backward for Hopper (sm_90a), shared by
// kernel D (flash_attention_bwd.cu: dq, dk and dv in one sweep) and kernel M
// (flash_attention_bwd_split.cu: dk and dv alone), one template on DQ.
//
// FlashAttention-2's backward on mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A work item is one head's key tile of 128 keys, 16 a warp over
// 8 warps; the warp's k and v fragments stay in registers and its dk and dv
// accumulate there across the sweep over the head's query tiles of 64 rows,
// whose q, dout, lse and delta are double-buffered in shared memory by
// cp.async. Per query tile, keys as M: Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ (q and dout
// rows are the B operand as they lie), p = exp2(s·scale·log2e − lse·log2e)
// (one FFMA and one exp2 a score), ds = p·(dp − delta); then dV += P·dout and
// dK += dS·q take P and dS, rounded to bf16 as the TPU kernels round them
// (pb = p.astype, ds = (...).astype), straight from the first products'
// accumulator fragments as A operands, so P is never transposed. dk and dv
// are stored once per item, each row by one warp: no reduction across blocks.
//
// DQ (kernel D): the dq share dS·K needs queries as M: dS goes once through
// shared memory as bf16 ([key][query]) and comes back by ldmatrix.trans; warp
// w computes 16 query rows × d/2 columns of it. dq without atomics and
// without per-group partials: one fp32 (BH, Nq, d) accumulator (32 MB at the
// hot shape, inside the 50 MB L2). Its adds into a query tile's rows happen
// in key-tile order, so two runs give the same bits, as the TPU kernel's
// grid-order sum does: each (head, query tile) has an int32 counter, zeroed
// per call; the item of key tile kt waits until the counter reads kt
// (ld.acquire.gpu, one thread, then a barrier), writes (kt = 0) or
// read-modify-writes its share through L2 (ld/st.cg), and publishes kt + 1
// (fence, st.release.gpu). Items are handed out in increasing index
// kt·BH + bh by an atomic counter to a persistent grid (the blocks the
// occupancy calculator allows on every SM): the item an item waits on has a
// lower index, so it went to a block that is already running, and progress
// never depends on launch order or on how many blocks are resident. A last
// kernel scales the accumulator and casts it to bf16.
//
// At d = 128 (the wrapper zero-pads any other d ≤ 128 to 32, 64 or 128) the
// tiles stay; dk and dv alone take 128 fp32 registers a thread, so the warp's
// k and v fragments are read from shared memory at each use instead of held
// in registers (KV_REGS), and a query tile's Sᵀ, dPᵀ, P and dS are taken 32
// queries at a time (QSUB = 2): one block an SM, 255 registers a thread.
//
// Without DQ (kernel M) none of that runs: no dS store, no dq product, no
// counters, no waits, and no dS buffer in shared memory. Each item has its
// own dk and dv rows and nothing to wait for, so a plain grid serves, one
// block per item (launch_bwd_tc), and the order of the items is free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
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
  // k, v, q and dout × 2 buffers, dS (DQ only), lse and delta × 2 buffers
  static constexpr int smem(bool dq) { return (2 * KV + 4 * QT + (dq ? DS : 0)) * 2 + 4 * kTbRows * 4; }
  static constexpr int MIN_BLOCKS = D == 32 ? 2 : 1;  // ≤ 128 registers a thread at d = 32
  static constexpr bool KV_REGS = D <= 64;  // k and v fragments held in registers
  static constexpr int QSUB = D <= 64 ? 1 : 2;  // parts of a query tile taken in turn
};

// The A fragment of k-step kk of this warp's 16 rows: from the registers it
// is held in (HELD), else by ldmatrix from the shared rows it came from.
template <bool HELD, int KS>
__device__ __forceinline__ void kv_frag(uint32_t (&a)[4], const uint32_t (&held)[KS][4],
                                        const bf16* s, int ld, int row0, int kk, int lane) {
  if constexpr (HELD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = held[kk][i];
  } else {
    load_a(a, s, ld, row0, kk * 16, lane);
  }
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

// Item i is key tile i / BH of head i % BH. DQ: counters [0] the next work
// item, then one per (head, query tile), all zero at launch; items are
// handed out by counters[0]. Without DQ, dq_acc and counters are not read
// and block b takes items b, b + grid, b + 2·grid, …
template <int D, bool DQ>
__global__ void __launch_bounds__(kTbThreads, TbShape<D>::MIN_BLOCKS)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq_acc, int* __restrict__ counters, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int bhs, long long nq, long long nk, float scale) {
  using TS = TbShape<D>;
  constexpr int LD = TS::LD, LDS = TS::LDS;
  constexpr int KS = D / 16;  // k-steps of the products over d
  constexpr int QS = kTbRows / TS::QSUB;  // queries of a part of a query tile
  constexpr int JT = QS / 8;              // its 8-query tiles
  constexpr int DT = D / 8;   // 8-column tiles of dk, dv
  constexpr int QN = D / 16;  // 8-column tiles of a warp's dq share (d / 2 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // k, v; q and dout of buffer b at qs0 + b·QT, dos0 + b·QT; dS (DQ); lse
  // and delta of buffer b at lse0 + b·64, del0 + b·64
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TS::KV;
  bf16* qs0 = vs + TS::KV;
  bf16* dos0 = qs0 + 2 * TS::QT;
  bf16* dss = dos0 + 2 * TS::QT;
  float* lse0 = reinterpret_cast<float*>(dss + (DQ ? TS::DS : 0));
  float* del0 = lse0 + 2 * kTbRows;
  __shared__ int item_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_qt = static_cast<int>((nq + kTbRows - 1) / kTbRows);
  const long long n_items = static_cast<long long>(bhs) * ((nk + kTbKeys - 1) / kTbKeys);
  const float c = scale * kLog2e;
  // this warp's share of the dq product: query rows 16·(warp / 2) …, columns
  // (warp % 2)·d/2 …
  const int mq = warp >> 1, n0 = (warp & 1) * (D / 2);

  for (long long it = blockIdx.x;; it += gridDim.x) {
    if constexpr (DQ) {
      if (tid == 0) item_s = atomicAdd(counters, 1);
      __syncthreads();
    }
    // without DQ the previous item's last tile ended on a barrier: its shared
    // memory is free
    const long long item = DQ ? item_s : it;
    if (item >= n_items) break;
    const long long bh = item % bhs;
    const int kt = item / bhs;
    const long long k0 = static_cast<long long>(kt) * kTbKeys;
    const bf16* qb = q + bh * nq * D;
    const bf16* dob = dout + bh * nq * D;
    const float* lb = lse + bh * nq;
    const float* db = delta + bh * nq;

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
      if (TS::KV_REGS && qt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          load_a(kf[kk], ks, LD, warp * 16, kk * 16, lane);
          load_a(vf[kk], vs, LD, warp * 16, kk * 16, lane);
        }
      }

#pragma unroll
      for (int sub = 0; sub < TS::QSUB; ++sub) {  // queries q0 … q0 + QS − 1 of the tile
        const int q0 = sub * QS;
        // dPᵀ = V·doutᵀ, then Sᵀ = K·qᵀ two 8-query tiles at a time, each turned
        // into P and dS at once: element e of tile j is key lane / 4 + 8·(e / 2)
        // of the warp's 16, query q0 + 8j + 2·(lane % 4) + e % 2 of the tile
        float dp[JT][4];
#pragma unroll
        for (int j = 0; j < JT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t va[4];
          kv_frag<TS::KV_REGS>(va, vf, vs, LD, warp * 16, kk, lane);
#pragma unroll
          for (int j2 = 0; j2 < JT / 2; ++j2) {
            uint32_t b[4];
            ldsm_x4(b, dosb + (q0 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           (((lane >> 3) & 1) << 3));
            mma16816(dp[2 * j2], va, b[0], b[1]);
            mma16816(dp[2 * j2 + 1], va, b[2], b[3]);
          }
        }
        uint32_t pb[JT][2], dsb[JT][2];  // bf16 pairs [tile][row half]
#pragma unroll
        for (int j2 = 0; j2 < JT / 2; ++j2) {
          float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t ka[4];
            kv_frag<TS::KV_REGS>(ka, kf, ks, LD, warp * 16, kk, lane);
            uint32_t b[4];
            ldsm_x4(b, qsb + (q0 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           (((lane >> 3) & 1) << 3));
            mma16816(s[0], ka, b[0], b[1]);
            mma16816(s[1], ka, b[2], b[3]);
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int j = 2 * j2 + t;
            const int col = q0 + 8 * j + 2 * (lane & 3);
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
              if constexpr (DQ)
                *reinterpret_cast<uint32_t*>(dss + (warp * 16 + (lane >> 2) + 8 * h) * LDS + col) =
                    dsb[j][h];
            }
          }
        }

        // dV += P·dout, dK += dS·q: queries q0 + 16·kk … are one k-step, the
        // fragments of tiles 2kk and 2kk + 1 its A operand
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk) {
          const uint32_t ap[4] = {pb[2 * kk][0], pb[2 * kk][1], pb[2 * kk + 1][0], pb[2 * kk + 1][1]};
          const uint32_t ad[4] = {dsb[2 * kk][0], dsb[2 * kk][1], dsb[2 * kk + 1][0],
                                  dsb[2 * kk + 1][1]};
#pragma unroll
          for (int jd = 0; jd < D / 16; ++jd) {
            uint32_t b[4];
            load_b2(b, dosb, LD, q0 + kk * 16, jd * 16, lane);
            mma16816(dva[2 * jd], ap, b[0], b[1]);
            mma16816(dva[2 * jd + 1], ap, b[2], b[3]);
            load_b2(b, qsb, LD, q0 + kk * 16, jd * 16, lane);
            mma16816(dka[2 * jd], ad, b[0], b[1]);
            mma16816(dka[2 * jd + 1], ad, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // DQ: dS of all 128 keys is in shared memory; else: tile qt's buffers are free

      if constexpr (DQ) {
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
        int* cnt = counters + 1 + bh * n_qt + qt;
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

// DQ (kernel D): dq, dk and dv, dq_acc and counters as flash_bwd_tc_kernel
// takes them, on a persistent grid, then the cast of dq. Without DQ (kernel
// M): dk and dv alone, one block per item; dq, dq_acc and counters unused.
template <int D, bool DQ>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dq_acc, void* counters, void* dq, void* dk, void* dv,
                  long long bh, long long nq, long long nk, float scale, cudaStream_t stream) {
  constexpr int smem = TbShape<D>::smem(DQ);
  const long long n_items = bh * ((nk + kTbKeys - 1) / kTbKeys);
  if (n_items > 2147483647LL || (DQ && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_tc_kernel<D, DQ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = n_items;  // M: one block per item
  if (DQ) {  // D: the blocks the occupancy calculator allows on every SM
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kTbThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (grid > static_cast<long long>(per_sm) * sms) grid = static_cast<long long>(per_sm) * sms;
  }
  kern<<<static_cast<unsigned>(grid), kTbThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<int*>(counters),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<int>(bh), nq, nk, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !DQ) return static_cast<int>(e);
  const long long n = bh * nq * D;
  scale_cast_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
