// Kernel family N: the implicit-GEMM conv probes on the tensor cores, for
// Hopper (sm_90a). Eight C entry points, one per TPU probe function:
//
//   hvc_probe_v1   scripts/bench_pallas_conv_probe.py::make_v1 (:62; body
//                  v1_kernel :56): out[m, N] = W[m, K] · P[K, N], weights as
//                  the M side. V1 is m = 32, the V0 control m = 256.
//   hvc_probe_v2   bench_pallas_conv_probe.py::v2 (:88; v2_kernel :81):
//                  out[N, 32] = Pᵀ[N, K] · Wᵀ[K, 32], spatial rows as M.
//   hvc_probe_v3   bench_pallas_conv_probe.py::v3 (:116; v3_kernel :104):
//                  out[32, N] = Σ_{t<27} W27[32t:32t+32, :64] · P[64t:64t+64, N],
//                  27 shifted K = 64 dots.
//   hvc_probe_v3p  scripts/bench_pallas_conv_probe2.py::v3p (:67; v3p_kernel
//                  :57): out[32, N] = Σ_{t<27} W27[32t:32t+32] · X[64, N], one X
//                  shared by every tap.
//   hvc_probe_v5   bench_pallas_conv_probe2.py::v5 (:92; v5_kernel :82):
//                  Σ_{t<14} W14[32t:32t+32, :128] · X2[128, N], pair-packed K = 128.
//   hvc_probe_v6   bench_pallas_conv_probe2.py::v6 (:120; v6_kernel :107):
//                  7 dots of W27p[128g:128g+128] · X (M = 128), each dot's 32-row
//                  groups summed into out[32, N]; the last dot keeps 3 groups.
//   hvc_probe_v4   bench_pallas_conv_probe2.py::v4 (:146; v4_kernel :135): one
//                  dot W27[864, 64] · X, then its 27 row groups summed.
//   hvc_probe_v8   bench_pallas_conv_probe2.py::v8 (:171; v8_kernel :161):
//                  Σ_{t<9} W9[32t:32t+32, :192] · X3[192, N], K = 192.
//
// Every operand is bf16, row-major and contiguous; products accumulate in
// fp32 on the tensor cores (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// fragments loaded from shared memory with ldmatrix; the helpers are in
// mma_sm90.cuh; V0, V1, V2, V3, V4 and V6 on wgmma.mma_async fed by TMA,
// helpers in wgmma_sm90.cuh) and the output is fp32.
// A call runs `repeats` passes, as the TPU probe's "arbitrary" r axis does:
// the r axis is a loop inside one launch. The grid is persistent (as many
// blocks as fit on the SMs) and walks the work items r·tiles + tile in order,
// so every pass sweeps all tiles before the next pass starts and each pass
// rewrites the whole output. Any N ≥ 1: the ragged last tile is zero-filled
// at the load and masked at the store; when N is not a multiple of 8 (a row
// of P or X not 16-byte aligned) the streamed operand is loaded element by
// element instead of by cp.async.
//
// What bounds it on this card, at the probes' shapes (N = 131,072, R = 64):
// every function is 2·32·1728·N multiply-adds per pass (V0 8×, V5 1792/1728×),
// so over R = 64 passes 0.938 ms at 989 TFLOP/s (V0 7.50 ms, V5 0.973 ms),
// with each input read once. But V1, V0, V2 and V3 stream P (Pᵀ), 453 MB,
// which does not fit the 50 MB L2: every pass re-reads it from device memory,
// 0.140 ms at 3.35 TB/s, a practical floor of 8.98 ms per call (V0 11.24 ms
// with its 8× larger output). X, X2 and X3 (16.8-50.3 MB) can stay in L2, so
// V3', V5, V6, V4 and V8 are bound by their products alone.
//
// Design. Four templates; the TPU's N_BLK = 2048 blocks and (8, 128) layout
// are not carried over. V0, V1, V3 (N a multiple of 8) and V2 run on wgmma
// fed by TMA (probe_gemm_wgmma, its comment has the design), V4 and V6 (N a
// multiple of 8) on wgmma with the weights resident as A and the tap sum
// folded in the accumulators (probe_tapsum_wgmma, likewise); the rest on
// mma.sync, the simplest tensor-core path (no TMA, no wgmma, no warp
// specialisation); what each variant probes is kept:
//
// - probe_gemm (V1 and V3 at a ragged N; the old V1, V2 and V3 instances,
//   which scripts/probe_variants.py still reaches): C[M, Nc] = A[M, K] · B[K, Nc],
//   both row-major in global memory, so the orientation is which array is A:
//   W (V1, V0, V3: M = Cout, the streamed P is B) or Pᵀ (V2: M = the spatial
//   rows, the 32-column Wᵀ is B). K runs in chunks of 64 through a 3-stage
//   cp.async ring of shared-memory tiles (rows padded by 8 bf16 so ldmatrix
//   is free of bank conflicts). V3 is V1 with the A chunk of K step t taken
//   from W27[32t:32t+32, :64]: one K = 64 dot per tap, accumulated in place.
//   Tiles: V1/V3 32 × 128 (4 warps of 32 × 32), an m > 32 call that the
//   wgmma rule does not take (N not a multiple of 8) 128 × 128 (8 warps of
//   64 × 32), V2 128 spatial rows × 32 (4 warps of 32 × 32).
// - probe_tapsum (V3', V5, V8, and V6 and V4 at a ragged N): the whole
//   weight array stays in shared memory for the block's life (115-129 KB,
//   the VMEM-resident weights of the TPU probe); per work item one X tile
//   [KD, BN] is staged
//   by cp.async, and each warp holds the B fragments of its columns for the
//   whole per-dot K in registers (KD/2 registers at 32 columns: 32 at
//   K = 64, 64 at K = 128, 96 at K = 192), so the taps reuse X from
//   registers and stream only the weights' A fragments. The next item's X
//   tile loads while the current one computes. Stacking taps into M: the
//   warps split each dot's GROUPS 32-row groups (V6: 4 warps along the
//   M = 128 dot, one group each; V4: 9 warps along the M = 864 dot, 3 groups
//   each, kept in separate accumulators and added in registers after the
//   dot), and the WARPS_M partial [32, BN] sums meet in shared memory in a
//   fixed order. V3', V5 and V8 (one 32-row group per dot) accumulate every
//   tap in one accumulator per warp, with no reduction. Tiles: V3'/V5/V8
//   32 × 256 (8 warps along N), V6 32 × 64 (4 × 2 warps), V4 32 × 32
//   (9 × 2 warps). The group of tap 27 in V6's last dot is skipped, not
//   computed and dropped.
// - probe_tapsum_wgmma (V4, V6 at N a multiple of 8): the weights resident
//   as wgmma's A, two taps to an m64 tile, rows permuted so that each
//   thread's accumulators hold one output element from two taps; every tile
//   chains into one accumulator (V4) or, by M = 128 dot, into two (V6), 32 ×
//   128 a work item, and one add per element after the chain
//   gives out[32, BN]: no reduction through shared memory, no cross-warp
//   step.
//
// Sums run in another order than the TPU's and the plain version's; the
// result is deterministic (no atomics; a rewrite of the output by a later
// pass stores the same values).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kBK = 64;      // K chunk of probe_gemm
constexpr int kStages = 3;   // cp.async ring depth of probe_gemm
constexpr int kPad = 8;      // bf16 padding per shared-memory row
constexpr int kGroup = 32;   // output rows per tap (Cout)

// One 16-byte chunk of a row of a row-major bf16 array into shared memory:
// the 8 elements at columns col..col+7 (src points at column col), zeros at
// columns ≥ cols. ALIGNED: the row length and the base are multiples of 8
// elements / 16 bytes, so a chunk is all in or all out and goes by cp.async;
// otherwise element by element.
template <bool ALIGNED>
__device__ __forceinline__ void load_chunk8(bf16* dst, const bf16* src, int col, int cols) {
  if (ALIGNED) {
    cp_async16(dst, src, col < cols ? 16 : 0);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = col + e < cols ? s[e] : 0;
    uint4 packed;
    packed.x = v[0] | (uint32_t(v[1]) << 16);
    packed.y = v[2] | (uint32_t(v[3]) << 16);
    packed.z = v[4] | (uint32_t(v[5]) << 16);
    packed.w = v[6] | (uint32_t(v[7]) << 16);
    *reinterpret_cast<uint4*>(dst) = packed;
  }
}

// out[r, c], out[r, c + 1] of a row-major fp32 array (rows × cols, ld).
__device__ __forceinline__ void store_pair(float* out, long long ld, int rows, int cols, int r,
                                           int c, float v0, float v1) {
  if (r >= rows || c >= cols) return;
  float* p = out + (long long)r * ld + c;
  if (c + 1 < cols && (ld & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (c + 1 < cols) p[1] = v1;
  }
}

// ------------------------------------------------------------ probe_gemm ---

// C[M, Nc] = A[M, K] · B[K, Nc] for `repeats` passes (K a multiple of 64).
// TAP_A (V3): A is W27 (27·32 × 64) and K step t reads its rows 32t..32t+31,
// so M must be 32. B_ALIGNED: Nc (= ldb) is a multiple of 8. M_INNER: a
// pass walks the M tiles of one N tile together (tile = n·tiles_m + m), so
// the blocks in flight share B tiles; otherwise every N tile of M tile 0
// comes first (tile = m·tiles_n + n), the hvc_probe_v1 instance's walk.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool TAP_A, bool B_ALIGNED,
          bool M_INNER = false>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    probe_gemm(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ C,
               int M, int Nc, int K, int repeats) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int LDA = kBK + kPad, LDB = BN + kPad;
  constexpr int A_STAGE = BM * LDA, B_STAGE = kBK * LDB;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + kStages * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (Nc + BN - 1) / BN;
  const long long per_pass = (long long)tiles_m * tiles_n;
  const long long items = per_pass * repeats;
  const int KC = K / kBK;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long tile = it % per_pass;
    const int m0 = int(M_INNER ? tile % tiles_m : tile / tiles_n) * BM;
    const int n0 = int(M_INNER ? tile / tiles_m : tile % tiles_n) * BN;

    auto load_stage = [&](int kc, int stage) {
      bf16* a = sA + stage * A_STAGE;
      for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
        const int r = c / (kBK / 8), k8 = (c % (kBK / 8)) * 8;
        const int gr = m0 + r;
        const bool ok = gr < M;
        const bf16* src = TAP_A ? A + ((long long)(kc * kGroup + r) * kBK + k8)
                                : A + ((long long)gr * K + (long long)kc * kBK + k8);
        cp_async16(a + r * LDA + k8, ok ? src : A, ok ? 16 : 0);
      }
      bf16* b = sB + stage * B_STAGE;
      for (int c = tid; c < kBK * (BN / 8); c += kThreads) {
        const int r = c / (BN / 8), n8 = (c % (BN / 8)) * 8;
        const int gc = n0 + n8;
        const bf16* src = B + ((long long)(kc * kBK + r) * Nc + gc);
        load_chunk8<B_ALIGNED>(b + r * LDB + n8, gc < Nc ? src : B, gc, Nc);
      }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KC) load_stage(s, s);
      cp_async_commit();
    }
    for (int kc = 0; kc < KC; ++kc) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int pf = kc + kStages - 1;
      if (pf < KC) load_stage(pf, pf % kStages);
      cp_async_commit();
      const bf16* a = sA + (kc % kStages) * A_STAGE;
      const bf16* b = sB + (kc % kStages) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) load_a(af[i], a, LDA, wm * WM + i * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bfr[4];
          load_b2(bfr, b, LDB, kk, wn * WN + j * 8, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma16816(acc[i][j], af[i], bfr[0], bfr[1]);
            mma16816(acc[i][j + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next item's first chunks

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = m0 + wm * WM + i * 16 + (lane >> 2);
        const int c = n0 + wn * WN + j * 8 + (lane & 3) * 2;
        store_pair(C, Nc, M, Nc, r, c, acc[i][j][0], acc[i][j][1]);
        store_pair(C, Nc, M, Nc, r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
  }
}

// ---------------------------------------------------------- probe_tapsum ---

// out[32, N] = Σ_{t<TAPS} W[32t:32t+32, :KD] · X[KD, N] for `repeats` passes,
// computed as NDOTS dots of GROUPS·32 weight rows each (dot d holds taps
// d·GROUPS + g). WARPS_M warps split a dot's groups, GROUPS / WARPS_M each.
template <int KD, int NDOTS, int GROUPS, int TAPS, int WARPS_M, int WARPS_N, int WN,
          bool X_ALIGNED>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    probe_tapsum(const bf16* __restrict__ W, const bf16* __restrict__ X, float* __restrict__ out,
                 int N, int repeats) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int GPW = GROUPS / WARPS_M;
  constexpr int BN = WARPS_N * WN, NT = WN / 8, KS = KD / 16;
  constexpr int W_ROWS = NDOTS * GROUPS * kGroup;
  constexpr int LDW = KD + kPad, LDX = BN + kPad;
  static_assert(GROUPS % WARPS_M == 0 && WN % 16 == 0 && KD % 16 == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sW = reinterpret_cast<bf16*>(smem_raw);
  bf16* sX = sW + W_ROWS * LDW;
  float* sRed = reinterpret_cast<float*>(sX + KD * LDX);  // (WARPS_M - 1) × 32 × BN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long per_pass = (N + BN - 1) / BN;
  const long long items = per_pass * repeats;

  auto load_x = [&](long long item) {
    const int n0 = int(item % per_pass) * BN;
    for (int c = tid; c < KD * (BN / 8); c += kThreads) {
      const int r = c / (BN / 8), n8 = (c % (BN / 8)) * 8;
      const int gc = n0 + n8;
      const bf16* src = X + ((long long)r * N + gc);
      load_chunk8<X_ALIGNED>(sX + r * LDX + n8, gc < N ? src : X, gc, N);
    }
  };

  if ((long long)blockIdx.x < items) {
    for (int c = tid; c < W_ROWS * (KD / 8); c += kThreads) {
      const int r = c / (KD / 8), k8 = (c % (KD / 8)) * 8;
      cp_async16(sW + r * LDW + k8, W + (long long)r * KD + k8, 16);
    }
    load_x(blockIdx.x);
  }
  cp_async_commit();

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int n0 = int(it % per_pass) * BN;
    cp_async_wait<0>();
    __syncthreads();  // this item's X tile (and, the first time, W) in shared memory

    uint32_t bx[KS][NT][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bfr[4];
        load_b2(bfr, sX, LDX, ks * 16, wn * WN + j * 8, lane);
        bx[ks][j][0] = bfr[0];
        bx[ks][j][1] = bfr[1];
        bx[ks][j + 1][0] = bfr[2];
        bx[ks][j + 1][1] = bfr[3];
      }
    __syncthreads();  // every warp holds its X fragments: the tile is free
    if (it + gridDim.x < items) load_x(it + gridDim.x);
    cp_async_commit();

    float acc[GPW][2][NT][4];
#pragma unroll
    for (int g = 0; g < GPW; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][i][j][e] = 0.f;

#pragma unroll 1
    for (int d = 0; d < NDOTS; ++d) {
#pragma unroll
      for (int g = 0; g < GPW; ++g) {
        const int t = d * GROUPS + wm * GPW + g;  // tap; its weight rows are 32t..32t+31
        if (t >= TAPS) continue;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t af[4];
            load_a(af, sW, LDW, t * kGroup + i * 16, ks * 16, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j) mma16816(acc[g][i][j], af, bx[ks][j][0], bx[ks][j][1]);
          }
      }
    }

    // the warp's groups, then the WARPS_M warps' partials, in a fixed order
#pragma unroll
    for (int g = 1; g < GPW; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][i][j][e] += acc[g][i][j][e];
    if (WARPS_M > 1) {
      if (wm > 0) {
        float* red = sRed + (wm - 1) * kGroup * BN;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int r = i * 16 + (lane >> 2), c = wn * WN + j * 8 + (lane & 3) * 2;
            red[r * BN + c] = acc[0][i][j][0];
            red[r * BN + c + 1] = acc[0][i][j][1];
            red[(r + 8) * BN + c] = acc[0][i][j][2];
            red[(r + 8) * BN + c + 1] = acc[0][i][j][3];
          }
      }
      __syncthreads();
      if (wm == 0) {
        for (int p = 0; p < WARPS_M - 1; ++p) {
          const float* red = sRed + p * kGroup * BN;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int r = i * 16 + (lane >> 2), c = wn * WN + j * 8 + (lane & 3) * 2;
              acc[0][i][j][0] += red[r * BN + c];
              acc[0][i][j][1] += red[r * BN + c + 1];
              acc[0][i][j][2] += red[(r + 8) * BN + c];
              acc[0][i][j][3] += red[(r + 8) * BN + c + 1];
            }
        }
      }
    }
    if (wm == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r = i * 16 + (lane >> 2), c = n0 + wn * WN + j * 8 + (lane & 3) * 2;
          store_pair(out, N, kGroup, N, r, c, acc[0][i][j][0], acc[0][i][j][1]);
          store_pair(out, N, kGroup, N, r + 8, c, acc[0][i][j][2], acc[0][i][j][3]);
        }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------ probe_gemm_wgmma ---

// C[M, Nc] fp32 = A[M, K] · B[K, Nc] on wgmma for `repeats` passes, A bf16
// row-major (K a multiple of 64). Four instances of one template, each a
// TPU probe's orientation:
//
// - V0 (make_v1 at m = 256; WgV0): A = W, B = P read MN-major (the [K][N]
//   rows of P as they lie), 256 rows × 128 columns a work item.
// - V1 (make_v1 at m = 32; WgV1): A = W, its 32 rows the top half of one m64
//   tile (the TMA box is 64 rows: rows 32-63 lie outside W and are filled
//   with zeros, their products dropped at the store), B = P MN-major, 64 rows
//   × 256 columns a work item. Half of each product is waste: the measured
//   cost of Cout = 32 as wgmma's M.
// - V3 (v3; WgV3): V1's instance with W27 tap-major: K chunk t is tap t, so
//   its A box is the 64 rows from row 32t of W27 (864 × 64), not the 64 k
//   from column 64t of W. Rows 32-63 of the box are tap t + 1's weights (for
//   t = 26 past row 863: zeros from TMA); their products land in accumulator
//   rows 32-63, which the store box clips as it does V1's. The bound and the
//   floor are V1's: every pass streams P (1728 × N) and rewrites the output.
// - V2 (v2; WgV2): A = Pᵀ (spatial rows as M, K-major), B = Wᵀ with Cout = 32
//   as wgmma's N, 256 rows × 32 columns a work item. Wᵀ (110,592 bytes at K
//   = 1728) stays in shared memory for the block's life, as the TPU kernel
//   keeps its W block at index (0, 0): the block's threads copy it once at
//   the start, transposed to K-major rows of 64 k, 128-byte swizzled. Its
//   variant WgV2Streamed instead streams a 4 KB chunk of W (32 × K, K-major:
//   the caller passes the transpose) beside each A chunk, which leaves room
//   for a deeper ring.
//
// What bounds each is moving bytes: P (Pᵀ), 453 MB at N = 131,072, does not
// fit the 50 MB L2 and is read from device memory every pass, and every pass
// writes the output: 64 × 469.9 MB / 3.35 TB/s = 8.98 ms for V1 and V2 (V0
// 11.24 ms with its 8× larger output), while the products take 0.938 ms at
// 989 TFLOP/s (V0 7.50). So the design keeps as many bytes in flight as
// shared memory holds and spends no thread on a load. One producer warpgroup
// (one thread of it) keeps a ring of STAGES K chunks of 64 loading by TMA,
// each into 128-byte-swizzled shared memory (A: one box of the item's rows ×
// 64 k; B: MN-major boxes of 64 k × 64 columns, or a K-major box of the
// item's columns × 64 k), completion on the chunk's `full` mbarrier. CONS
// consumer warpgroups each own MT m64 tiles × NT n-blocks of WN columns (V0:
// two warpgroups of 128 rows × 128; V1, V3: one of 64 × 256; V2: two of 128 × 32)
// and issue, per k16 step, one wgmma.mma_async m64n{WN}k16 per tile (A
// K-major from its rows, B by descriptor), MT·NT·WN/2 fp32 accumulators a
// thread, then free the chunk (its `empty` mbarrier, one arrival per
// consumer) as soon as its products are done. Epilogue: each consumer
// writes 64 rows × 32 columns of its accumulators at a time into its own 8 KB
// buffer, in the 128-byte swizzle of one TMA store box (conflict-free float2
// writes from the fragments), and one thread stores it by TMA, which clips
// the ragged edge (and V1's and V3's rows 32-63); the buffer is reused once the store
// has read it. Persistent grid walking the work items r·tiles + tile in
// order, N-major (tile = n·tiles_m + m), so every pass re-reads P from global
// memory and rewrites the whole output, as the TPU probe's r axis does.
// Deterministic: every output element is one fixed chain of fp32 products.
constexpr int kWgBK = 64;      // a chunk's K: one 128-byte row of bf16
constexpr int kWgBox = 64;     // bf16 columns of an MN-major load box: 128 bytes
constexpr int kWgOutBox = 32;  // fp32 columns of a store box: 128 bytes
constexpr int kWgOutBytes = 64 * kWgOutBox * 4;  // 8 KB a consumer: one [64][32] box
constexpr int kWgTile = 64 * 128;                // an m64 tile's (or MN-major box's) 64 rows
constexpr int kWgSmemMax = 232448;               // the card's shared memory a block
// Descriptor strides (bytes): every operand steps 8 rows (M or N rows of a
// K-major tile, k rows of an MN-major one) by one 1024-byte swizzle atom; an
// MN-major B's next 64-column box follows a whole box of kWgBK 128-byte rows.
constexpr uint32_t kWgSbo = 8 * 128;
constexpr uint32_t kWgLboB = kWgBK * 128;
constexpr uint32_t kWgLboA = 16;  // unused by a swizzled K-major operand

enum WgB { kBStreamMN = 0, kBStreamK = 1, kBResidentK = 2 };  // where B comes from

// TAP_A (V3): A is W27 tap-major, K chunk t's box its rows 32t … 32t + 63.
template <int CONS_, int MT_, int NT_, int WN_, int STAGES_, int BMODE_, bool TAP_A_ = false>
struct WgCfg {
  static constexpr int CONS = CONS_, MT = MT_, NT = NT_, WN = WN_, STAGES = STAGES_,
                       BMODE = BMODE_;
  static constexpr bool TAP_A = TAP_A_;
  static constexpr int BM = CONS * MT * 64;  // rows of a work item
  static constexpr int BN = NT * WN;         // columns of a work item
  static constexpr int ABytes = BM * 128;    // A rows [BM][64 k], swizzled
  // B: BN / 64 MN-major boxes [64 k][64 n], or one K-major box [BN][64 k]
  static constexpr int BBytes = BMODE == kBResidentK ? 0 : BN * 128;
  static constexpr int StageBytes = ABytes + BBytes;
  static constexpr int Threads = (CONS + 1) * 128;
  static constexpr int TRANS_B = BMODE == kBStreamMN;
  // alignment slack, ring, resident B (K × BN bf16), epilogue, barriers
  static constexpr int smem(int k) {
    return 1024 + STAGES * StageBytes + (BMODE == kBResidentK ? k * BN * 2 : 0) +
           CONS * kWgOutBytes + 2 * STAGES * 8;
  }
  static_assert((WN == 128 || WN == 32) && WN % kWgOutBox == 0 && BM <= 256 && StageBytes % 1024 == 0,
                "an m64n128 or m64n32 product, whole store boxes, one TMA box of A rows");
  static_assert(BMODE != kBStreamMN || WN % kWgBox == 0, "whole MN-major B boxes");
  static_assert(!TAP_A || BM == 64, "a tap-major A box is one m64 tile");
};
using WgV0 = WgCfg<2, 2, 1, 128, 4, kBStreamMN>;   // 214,080 bytes of shared memory
using WgV1 = WgCfg<1, 1, 2, 128, 5, kBStreamMN>;   // 214,096
using WgV3 = WgCfg<1, 1, 2, 128, 5, kBStreamMN, true>;  // 214,096
using WgV2 = WgCfg<2, 2, 1, 32, 3, kBResidentK>;   // 226,352 at K = 1728
using WgV2Streamed = WgCfg<2, 2, 1, 32, 5, kBStreamK>;  // 201,808
static_assert(WgV0::smem(1728) <= kWgSmemMax && WgV1::smem(1728) <= kWgSmemMax &&
                  WgV3::smem(1728) <= kWgSmemMax && WgV2::smem(1728) <= kWgSmemMax &&
                  WgV2Streamed::smem(1728) <= kWgSmemMax,
              "the card's shared memory");

template <int WN, int TRANS_B>
__device__ __forceinline__ void wgmma_tile(float (&d)[WN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (WN == 128)
    wgmma_m64n128k16<TRANS_B>(d, da, db, scale_d);
  else
    wgmma_m64n32k16<TRANS_B>(d, da, db, scale_d);
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::Threads, 1)
    probe_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c, const bf16* __restrict__ b_res,
                     int M, int Nc, int K, int repeats) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, MT = Cfg::MT, NT = Cfg::NT, WN = Cfg::WN;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* bres = smem + STAGES * Cfg::StageBytes;  // resident B: K / 64 blocks [BN][64 k]
  unsigned char* outs = bres + (Cfg::BMODE == kBResidentK ? K * BN * 2 : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + Cfg::CONS * kWgOutBytes);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (Nc + BN - 1) / BN;
  const long long per_pass = (long long)tiles_m * tiles_n;
  const long long items = per_pass * repeats;
  const int KC = K / kWgBK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Cfg::CONS);
    }
    mbar_fence_init();
  }
  if constexpr (Cfg::BMODE == kBResidentK) {
    // B (K × BN, row-major: the [k][n] rows of Wᵀ) into K-major swizzled
    // rows: 8 k of one column n a 16-byte chunk, a warp's 32 threads on 32
    // neighbouring columns of the same k rows
    const unsigned short* src = reinterpret_cast<const unsigned short*>(b_res);
    for (int c = tid; c < (K / 8) * BN; c += Cfg::Threads) {
      const int n = c % BN, k8 = c / BN;
      const unsigned short* e = src + (long long)k8 * 8 * BN + n;
      uint4 v;
      v.x = e[0] | (uint32_t(e[BN]) << 16);
      v.y = e[2 * BN] | (uint32_t(e[3 * BN]) << 16);
      v.z = e[4 * BN] | (uint32_t(e[5 * BN]) << 16);
      v.w = e[6 * BN] | (uint32_t(e[7 * BN]) << 16);
      *reinterpret_cast<uint4*>(bres + (k8 / 8) * (BN * 128) + sw128_offset(n, k8 % 8)) = v;
    }
    fence_proxy_async_shared();  // the products read it through the async proxy
  }
  __syncthreads();

  if (wg == Cfg::CONS) {  // the producer
    if (lt == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const long long tile = it % per_pass;
        const int m0 = int(tile % tiles_m) * BM, n0 = int(tile / tiles_m) * BN;
        for (int kc = 0; kc < KC; ++kc) {
          mbar_wait(&empty[s], phase ^ 1);  // the consumers freed this chunk (free at first)
          unsigned char* st = smem + s * Cfg::StageBytes;
          mbar_arrive_expect_tx(&full[s], Cfg::StageBytes);
          if constexpr (Cfg::TAP_A)
            tma_load_2d(st, &map_a, &full[s], 0, kc * kGroup + m0);  // tap kc's rows, then kc + 1's
          else
            tma_load_2d(st, &map_a, &full[s], kc * kWgBK, m0);
          if constexpr (Cfg::BMODE == kBStreamMN) {
#pragma unroll
            for (int b = 0; b < BN / kWgBox; ++b)
              tma_load_2d(st + Cfg::ABytes + b * kWgTile, &map_b, &full[s], n0 + b * kWgBox,
                          kc * kWgBK);
          } else if constexpr (Cfg::BMODE == kBStreamK) {
            tma_load_2d(st + Cfg::ABytes, &map_b, &full[s], kc * kWgBK, n0);
          }
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer: m64 tiles MT·wg … MT·wg + MT - 1 of each work item, all its columns
  float acc[MT * NT][WN / 2];
  unsigned char* out = outs + wg * kWgOutBytes;
  const int warp = lt / 32, lane = lt % 32;
  int s = 0;
  uint32_t phase = 0;
  bool stored = false;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long tile = it % per_pass;
    const int m0 = int(tile % tiles_m) * BM, n0 = int(tile / tiles_m) * BN;
#pragma unroll
    for (int t = 0; t < MT * NT; ++t) wgmma_fence_acc(acc[t]);
    for (int kc = 0; kc < KC; ++kc) {
      mbar_wait(&full[s], phase);
      const uint32_t a0 = smem_u32(smem + s * Cfg::StageBytes) + wg * MT * kWgTile;
      const uint32_t b0 = Cfg::BMODE == kBResidentK
                              ? smem_u32(bres + kc * (BN * 128))
                              : smem_u32(smem + s * Cfg::StageBytes + Cfg::ABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < MT * NT; ++t) {
          const int i = t / NT, j = t % NT;  // m64 tile i, n-block j
          const uint64_t da = wgmma_desc(a0 + i * kWgTile + kk * 32, kWgLboA, kWgSbo);
          const uint64_t db =
              Cfg::TRANS_B ? wgmma_desc(b0 + j * (WN / kWgBox) * kWgTile + kk * 16 * 128, kWgLboB, kWgSbo)
                           : wgmma_desc(b0 + j * WN * 128 + kk * 32, kWgLboA, kWgSbo);
          wgmma_tile<WN, Cfg::TRANS_B>(acc[t], da, db, kc > 0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();  // this chunk's products are done: free it for the producer
      if (lt == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) s = 0, phase ^= 1;
    }
#pragma unroll
    for (int t = 0; t < MT * NT; ++t) wgmma_fence_acc(acc[t]);

#pragma unroll
    for (int t = 0; t < MT * NT; ++t)
#pragma unroll
      for (int h = 0; h < WN / kWgOutBox; ++h) {  // columns kWgOutBox·h … of tile t
        if (stored && lt == 0) tma_store_wait_read<0>();  // the last store has read the buffer
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kWgOutBox / 2; jj += 2) {
          // accumulators q, q + 1 (q = jj + the round's first): row 16·warp + lane /
          // 4 + 8·(q % 4 / 2), columns 8·(q / 4) + 2·(lane % 4) + {0, 1} of the
          // tile, c of them local to the round
          const int q = h * kWgOutBox / 2 + jj;
          const int row = 16 * warp + lane / 4 + 8 * ((jj % 4) / 2);
          const int c = 8 * (jj / 4) + 2 * (lane % 4);
          *reinterpret_cast<float2*>(out + sw128_offset(row, c / 4) + (lane % 2) * 8) =
              make_float2(acc[t][q], acc[t][q + 1]);
        }
        fence_proxy_async_shared();
        bar_sync(1 + wg, 128);
        if (lt == 0) {
          tma_store_2d(&map_c, out, n0 + (t % NT) * WN + h * kWgOutBox,
                       m0 + (wg * MT + t / NT) * 64);
          tma_store_commit();
        }
        stored = true;
      }
  }
  if (lt == 0) tma_store_wait<0>();
}

// --------------------------------------------------- probe_tapsum_wgmma ---

// out[32, N] fp32 = Σ_{t<27} W[32t:32t+32, :64] · X[64, N] on wgmma for
// `repeats` passes, every tap's products on the tensor cores (V4: W = W27,
// 864 × 64; V6: W = W27p, 896 × 64, its 28th row group never read). The
// taps are stacked in M, two to an m64 tile, and their sum is folded in the
// accumulators, with no shared-memory reduction:
//
// - The weights stay in shared memory for the block's life as the A operand
//   (the TPU kernel's VMEM-resident W): kTapTiles = 14 m64 tiles, 896 rows ×
//   64 k, 114,688 bytes, K-major and 128-byte swizzled. The block's threads
//   copy them once at the start, permuted: row 16·w + h of tile i holds tap
//   2i + h / 8, output row 8·w + h % 8 (zeros for tap 27, which V4 lacks
//   and V6 drops). A consumer thread of warp w holds accumulator rows 16·w +
//   lane / 4 (e = 0, 1 of each 8-column block) and 16·w + lane / 4 + 8 (e =
//   2, 3), so its e = 0 and e = 2 are one output element, output row 8·w +
//   lane / 4, summed over the even and the odd taps of the tiles chained into
//   the accumulator: out = e0 + e2 (and e1 + e3), added once after the chain.
// - X streams by TMA from L2 (16.8 MB at N = 131,072) as V1 streams P:
//   MN-major boxes of 64 k × 64 columns. K = 64 is one ring stage, so one
//   stage is one whole work item of BN columns, and every m64 tile of the
//   item reuses it.
// - Two consumer warpgroups take alternate work items of the block, each
//   from SPC ring stages of its own (a stage is only ever read by one
//   consumer, so the barriers' phases count per stage), and issue per item
//   the 14 tiles × 4 k16 steps as one batch of wgmma.mma_async m64n128k16,
//   ACCS accumulators of 64 fp32 a thread. Tile i chains into accumulator
//   i % ACCS: V4 one chain over all 14 tiles; V6 two chains (ACCS = 2), its
//   7 M = 128 dots g, tile 2g into the first and 2g + 1 into the second,
//   summed once after the chain. Both at BN = 128 with three stages a
//   consumer (at BN = 256 only one stage a consumer fits beside W, and on an
//   H100 V4 read the same so, within the spread of three runs: PERF.md).
//   One consumer's fold and stores overlap the other's products. The
//   producer warpgroup (one thread of it issues the loads) gives registers
//   to the consumers (setmaxnreg).
// - Epilogue: the folded 32 output rows × 32 fp32 columns at a time into one
//   of the consumer's two 4 KB store boxes (128-byte swizzle, float2 writes),
//   stored by TMA, which clips the ragged last N tile (loads past N are
//   zeros); a box is rewritten once the store before last has read it.
//
// What bounds it: the products, 2·32·1728·N a pass (0.938 ms over R = 64 at
// N = 131,072 and 989 TFLOP/s). The 14th tile's zero half (tap 27) adds
// 1/27: 0.973 ms at peak. X and the output (16.8 MB each) stay in L2.
// Deterministic: every output element is one fixed chain of fp32 products.
constexpr int kTaps = 27;                         // taps summed (V6: row groups 0-26)
constexpr int kTapTiles = 14;                     // m64 tiles of two taps each
constexpr int kTapOutBytes = kGroup * kWgOutBox * 4;  // a store box: [32 rows][32 fp32]
constexpr int kTapProducerRegs = 40, kTapConsumerRegs = 232;  // registers a thread (setmaxnreg)

// CONS consumer warpgroups, ACCS accumulator chains, SPC ring stages a
// consumer; BN = 128 columns (one n128 block) a work item.
template <int CONS_, int ACCS_, int SPC_>
struct WgTapCfg {
  static constexpr int CONS = CONS_, ACCS = ACCS_, SPC = SPC_;
  static constexpr int BN = 128;                     // columns of a work item
  static constexpr int StageBytes = BN * 128;        // X: BN / 64 boxes [64 k][64 n]
  static constexpr int Threads = (CONS + 1) * 128;
  // alignment slack, resident W, ring, two store boxes a consumer, barriers
  static constexpr int Smem = 1024 + kTapTiles * kWgTile + CONS * SPC * StageBytes +
                              CONS * 2 * kTapOutBytes + 2 * CONS * SPC * 8;
  static_assert(kTapTiles % ACCS == 0 && ACCS * 64 <= 128 &&
                    (CONS * kTapConsumerRegs + kTapProducerRegs) * 128 <= 65536,
                "whole M = 64·ACCS dots; the SM's registers for the warpgroups' budgets");
  static_assert(Smem <= kWgSmemMax, "the card's shared memory");
};
using WgV4 = WgTapCfg<2, 1, 3>;  // 230,496 bytes of shared memory
using WgV6 = WgTapCfg<2, 2, 3>;  // 230,496

template <class Cfg>
__global__ void __launch_bounds__(Cfg::Threads, 1)
    probe_tapsum_wgmma(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_c, const bf16* __restrict__ w,
                       int N, int repeats) {
  constexpr int CONS = Cfg::CONS, ACCS = Cfg::ACCS, SPC = Cfg::SPC, BN = Cfg::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* wres = smem;                                  // kTapTiles tiles [64][64 k]
  unsigned char* ring = wres + kTapTiles * kWgTile;            // consumer c's stages c·SPC …
  unsigned char* outs = ring + CONS * SPC * Cfg::StageBytes;   // two store boxes a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + CONS * 2 * kTapOutBytes);
  uint64_t* empty = full + CONS * SPC;

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const long long per_pass = (N + BN - 1) / BN;
  const long long items = per_pass * repeats;

  if (tid == 0) {
    for (int s = 0; s < CONS * SPC; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  // W into the resident tiles, permuted: tile i row r = 16·wr + h holds tap
  // 2i + h / 8, output row 8·wr + h % 8; a thread copies one 16-byte chunk (8 k)
  for (int c = tid; c < kTapTiles * 64 * 8; c += Cfg::Threads) {
    const int i = c / 512, r = c / 8 % 64, k8 = c % 8;
    const int tap = 2 * i + r % 16 / 8, orow = 8 * (r / 16) + r % 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (tap < kTaps)
      v = *reinterpret_cast<const uint4*>(w + (long long)(tap * kGroup + orow) * kWgBK + k8 * 8);
    *reinterpret_cast<uint4*>(wres + i * kWgTile + sw128_offset(r, k8)) = v;
  }
  fence_proxy_async_shared();  // the products read it through the async proxy
  __syncthreads();

  if (wg == CONS) {  // the producer: block item li goes to consumer li % CONS
    setmaxnreg_dec<kTapProducerRegs>();
    if (lt == 0) {
      long long li = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x, ++li) {
        const long long lj = li / CONS;  // the consumer's own item count
        const int s = int(li % CONS) * SPC + int(lj % SPC);
        mbar_wait(&empty[s], uint32_t(lj / SPC & 1) ^ 1);  // its consumer freed it (free at first)
        unsigned char* st = ring + s * Cfg::StageBytes;
        mbar_arrive_expect_tx(&full[s], Cfg::StageBytes);
        const int n0 = int(it % per_pass) * BN;
#pragma unroll
        for (int b = 0; b < BN / kWgBox; ++b)
          tma_load_2d(st + b * kWgTile, &map_x, &full[s], n0 + b * kWgBox, 0);
      }
    }
  } else {  // a consumer: block items wg, wg + CONS, …
    setmaxnreg_inc<kTapConsumerRegs>();
    float acc[ACCS][64];
    unsigned char* out = outs + wg * 2 * kTapOutBytes;
    const int warp = lt / 32, lane = lt % 32;
    const uint32_t w0 = smem_u32(wres);
    int stores = 0;
    long long lj = 0;
    for (long long it = blockIdx.x + (long long)wg * gridDim.x; it < items;
         it += (long long)CONS * gridDim.x, ++lj) {
      const int s = wg * SPC + int(lj % SPC);
      const int n0 = int(it % per_pass) * BN;
#pragma unroll
      for (int a = 0; a < ACCS; ++a) wgmma_fence_acc(acc[a]);
      mbar_wait(&full[s], uint32_t(lj / SPC & 1));
      const uint32_t x0 = smem_u32(ring + s * Cfg::StageBytes);
      wgmma_fence();
#pragma unroll
      for (int d = 0; d < kTapTiles / ACCS; ++d)  // dot d: tiles d·ACCS … (M = 64·ACCS)
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
          for (int a = 0; a < ACCS; ++a) {
            const uint64_t da =
                wgmma_desc(w0 + (d * ACCS + a) * kWgTile + kk * 32, kWgLboA, kWgSbo);
            const uint64_t db = wgmma_desc(x0 + kk * 16 * 128, kWgLboB, kWgSbo);
            wgmma_m64n128k16<1>(acc[a], da, db, d > 0 || kk > 0);
          }
      wgmma_commit();
      wgmma_wait<0>();  // the item's products are done: free its stage for the producer
      if (lt == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int a = 0; a < ACCS; ++a) wgmma_fence_acc(acc[a]);

      // the chains, in order, into the first
#pragma unroll
      for (int a = 1; a < ACCS; ++a)
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[0][q] += acc[a][q];
#pragma unroll
      for (int h = 0; h < BN / kWgOutBox; ++h) {  // columns 32·h …
        unsigned char* box = out + (stores & 1) * kTapOutBytes;
        if (lt == 0) tma_store_wait_read<1>();  // the store before last has read this box
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int cb = 0; cb < kWgOutBox / 8; ++cb) {
          // column block 4h + cb: accumulators q … q + 3, e0 + e2 and e1 + e3
          // at output row 8·warp + lane / 4, box columns 8·cb + 2·(lane % 4)
          const int q = 4 * (h * kWgOutBox / 8 + cb);
          const int c = 8 * cb + 2 * (lane % 4);
          *reinterpret_cast<float2*>(box + sw128_offset(8 * warp + lane / 4, c / 4) +
                                     (lane % 2) * 8) =
              make_float2(acc[0][q] + acc[0][q + 2], acc[0][q + 1] + acc[0][q + 3]);
        }
        fence_proxy_async_shared();
        bar_sync(1 + wg, 128);
        if (lt == 0) {
          tma_store_2d(&map_c, box, n0 + h * kWgOutBox, 0);
          tma_store_commit();
        }
        ++stores;
      }
    }
    if (lt == 0) tma_store_wait<0>();
  }
}

// ---------------------------------------------------------------- launches ---

// A persistent launch: as many blocks as fit on the SMs, at most `items`.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kern)(KArgs...), int threads, int smem, long long items,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (items <= 0) return cudaSuccess;
  const long long cap = (long long)sms * per_sm;
  const int grid = int(items < cap ? items : cap);
  kern<<<grid, threads, smem, stream>>>(static_cast<KArgs>(args)...);
  return cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool TAP_A, bool B_ALIGNED,
          bool M_INNER = false>
cudaError_t gemm(const void* a, const void* b, void* c, int M, int Nc, int K, int repeats,
                 cudaStream_t stream) {
  constexpr int smem = kStages * (BM * (kBK + kPad) + kBK * (BN + kPad)) * 2;
  const long long items =
      (long long)((M + BM - 1) / BM) * ((Nc + BN - 1) / BN) * (long long)repeats;
  return launch(probe_gemm<BM, BN, WARPS_M, WARPS_N, TAP_A, B_ALIGNED, M_INNER>,
                WARPS_M * WARPS_N * 32, smem, items, stream, static_cast<const bf16*>(a),
                static_cast<const bf16*>(b), static_cast<float*>(c), M, Nc, K, repeats);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool TAP_A, bool M_INNER = false>
cudaError_t gemm_any(const void* a, const void* b, void* c, int M, int Nc, int K, int repeats,
                     int aligned, cudaStream_t stream) {
  return aligned
             ? gemm<BM, BN, WARPS_M, WARPS_N, TAP_A, true, M_INNER>(a, b, c, M, Nc, K, repeats,
                                                                   stream)
             : gemm<BM, BN, WARPS_M, WARPS_N, TAP_A, false, M_INNER>(a, b, c, M, Nc, K, repeats,
                                                                    stream);
}

template <int KD, int NDOTS, int GROUPS, int TAPS, int WARPS_M, int WARPS_N, int WN>
cudaError_t tapsum(const void* w, const void* x, void* out, int n, int repeats, int aligned,
                   cudaStream_t stream) {
  constexpr int BN = WARPS_N * WN;
  constexpr int smem = (NDOTS * GROUPS * kGroup * (KD + kPad) + KD * (BN + kPad)) * 2 +
                       (WARPS_M - 1) * kGroup * BN * 4;
  const long long items = (long long)((n + BN - 1) / BN) * repeats;
  const int threads = WARPS_M * WARPS_N * 32;
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* xp = static_cast<const bf16*>(x);
  float* op = static_cast<float*>(out);
  return aligned
             ? launch(probe_tapsum<KD, NDOTS, GROUPS, TAPS, WARPS_M, WARPS_N, WN, true>, threads,
                      smem, items, stream, wp, xp, op, n, repeats)
             : launch(probe_tapsum<KD, NDOTS, GROUPS, TAPS, WARPS_M, WARPS_N, WN, false>, threads,
                      smem, items, stream, wp, xp, op, n, repeats);
}


// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a row-major rows × cols array of `type` (elem bytes an
// element) cut into boxes of box_rows × box_cols, 128-byte swizzled in
// shared memory; out-of-bounds reads are zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                long long rows, long long cols, int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma instance Cfg on A (M × K; with TAP_A, W27: K / 64 taps of 32
// rows × 64, M ≤ 32) and B: the [K][Nc] rows of P (kBStreamMN), W as Nc = BN
// rows of K (kBStreamK) or Wᵀ as K rows of Nc = BN (kBResidentK, read by the
// threads, no tensor map). The tensor maps need 16-byte row pitches (K a
// multiple of 64; Nc of 8 for an MN-major B, of 4 for the fp32 output) and
// 16-byte aligned bases.
template <class Cfg>
cudaError_t gemm_wgmma(const void* a, const void* b, void* c, int M, int Nc, int K, int repeats,
                       cudaStream_t stream) {
  const int smem = Cfg::smem(K);
  if (M < 1 || Nc < 1 || K < kWgBK || K % kWgBK != 0 || Nc % 4 != 0 || smem > kWgSmemMax ||
      (Cfg::BMODE == kBStreamMN ? Nc % 8 != 0 : Nc != Cfg::BN) ||
      (Cfg::TAP_A && M > kGroup) || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || reinterpret_cast<uintptr_t>(c) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc;
  const long long a_rows = Cfg::TAP_A ? (long long)(K / kWgBK) * kGroup : M;
  if (!tensor_map(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, a_rows, Cfg::TAP_A ? kWgBK : K,
                  Cfg::BM, kWgBK) ||
      !tensor_map(&mc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, c, M, Nc, 64, kWgOutBox))
    return cudaErrorInvalidValue;
  if (Cfg::BMODE == kBResidentK)
    mb = ma;  // unused
  else if (!(Cfg::BMODE == kBStreamMN
                 ? tensor_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, K, Nc, kWgBK, kWgBox)
                 : tensor_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, Nc, K, Cfg::BN, kWgBK)))
    return cudaErrorInvalidValue;
  const long long items =
      (long long)((M + Cfg::BM - 1) / Cfg::BM) * ((Nc + Cfg::BN - 1) / Cfg::BN) * (long long)repeats;
  return launch(probe_gemm_wgmma<Cfg>, Cfg::Threads, smem, items, stream, ma, mb, mc,
                static_cast<const bf16*>(b), M, Nc, K, repeats);
}

// The wgmma tap-sum instance Cfg on w (W27 864 × 64, or W27p 896 × 64: the
// first 864 rows read) and x (64 × n): the tensor maps need 16-byte row
// pitches (n a multiple of 8) and 16-byte aligned bases.
template <class Cfg>
cudaError_t tapsum_wgmma(const void* w, const void* x, void* out, int n, int repeats,
                         cudaStream_t stream) {
  if (n < 1 || n % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mc;
  if (!tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, kWgBK, n, kWgBK, kWgBox) ||
      !tensor_map(&mc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, kGroup, n, kGroup, kWgOutBox))
    return cudaErrorInvalidValue;
  const long long items = (long long)((n + Cfg::BN - 1) / Cfg::BN) * repeats;
  return launch(probe_tapsum_wgmma<Cfg>, Cfg::Threads, Cfg::Smem, items, stream, mx, mc,
                static_cast<const bf16*>(w), n, repeats);
}

// The instances of hvc_probe_v1 (make_v1: out (m, n) = w (m, k) · p (k, n)).
enum V1Instance {
  kV1MmaNarrow = 0,  // mma.sync, 32 × 128 tiles (V1's before wgmma)
  kV1MmaWide = 1,    // mma.sync, 128 × 128 tiles, every N tile of M tile 0 first
  kV1WgmmaV0 = 2,    // WgV0: 256 × 128 work items
  kV1WgmmaM32 = 3,   // WgV1: W's rows in one m64 tile, 64 × 256 work items
  kV1MmaWideMInner = 4,  // kV1MmaWide with the M tiles of an N tile walked together
};

// The rule of hvc_probe_v1, an instance code: with 16-byte row pitches of P
// and the output for the tensor maps (n a multiple of 8), rows in whole m64
// tiles (V0) take WgV0 and at most 32 rows (V1) WgV1; otherwise at most 32
// rows take the 32 × 128 mma.sync tiles, more the 128 × 128 ones.
int v1_instance(int m, int n) {
  if (n % 8 == 0 && m % 64 == 0) return kV1WgmmaV0;
  if (n % 8 == 0 && m <= 32) return kV1WgmmaM32;
  return m <= 32 ? kV1MmaNarrow : kV1MmaWide;
}

cudaError_t run_v1(int instance, const void* w, const void* p, void* out, int m, int k, int n,
                   int repeats, int aligned, cudaStream_t s) {
  switch (instance) {
    case kV1MmaNarrow: return gemm_any<32, 128, 1, 4, false>(w, p, out, m, n, k, repeats, aligned, s);
    case kV1MmaWide: return gemm_any<128, 128, 2, 4, false>(w, p, out, m, n, k, repeats, aligned, s);
    case kV1WgmmaV0: return gemm_wgmma<WgV0>(w, p, out, m, n, k, repeats, s);
    case kV1WgmmaM32: return gemm_wgmma<WgV1>(w, p, out, m, n, k, repeats, s);
    case kV1MmaWideMInner:
      return gemm_any<128, 128, 2, 4, false, true>(w, p, out, m, n, k, repeats, aligned, s);
  }
  return cudaErrorInvalidValue;
}

// The instances of hvc_probe_v2 (v2: out (n, 32) = pt (n, k) · wt (k, 32)).
enum V2Instance {
  kV2Mma = 0,            // mma.sync, 128 spatial rows × 32 tiles (V2's before wgmma)
  kV2Wgmma = 1,          // WgV2: wt resident in shared memory
  kV2WgmmaStreamed = 2,  // WgV2Streamed: w (32 × k, the transpose of wt) streamed by chunks
};
constexpr int kV2MaxK = (kWgSmemMax - WgV2::smem(0)) / (2 * WgV2::BN) / kWgBK * kWgBK;  // 1792

// The rule of hvc_probe_v2, an instance code: every call whose wt fits in
// shared memory beside the ring (k ≤ kV2MaxK, the probe's 1728 included)
// takes WgV2, at any n (the tensor maps' pitches, 2k bytes of pt and 128 of
// the output, are multiples of 16); none other (-1).
int v2_instance(int k, int n) {
  (void)n;
  return k >= kWgBK && k % kWgBK == 0 && k <= kV2MaxK ? kV2Wgmma : -1;
}

cudaError_t run_v2(int instance, const void* pt, const void* w, void* out, int k, int n,
                   int repeats, cudaStream_t s) {
  switch (instance) {
    case kV2Mma: return gemm<128, 32, 4, 1, false, true>(pt, w, out, n, 32, k, repeats, s);
    case kV2Wgmma: return gemm_wgmma<WgV2>(pt, w, out, n, 32, k, repeats, s);
    case kV2WgmmaStreamed: return gemm_wgmma<WgV2Streamed>(pt, w, out, n, 32, k, repeats, s);
  }
  return cudaErrorInvalidValue;
}

// The instances of hvc_probe_v3 (v3: out (32, n) = Σ_t w27[32t:32t+32] ·
// p[64t:64t+64]).
enum V3Instance {
  kV3Mma = 0,    // mma.sync, 32 × 128 tiles (V3's before wgmma)
  kV3Wgmma = 1,  // WgV3: V1's wgmma instance, A boxes of W27 tap-major
};

// The rule of hvc_probe_v3, an instance code: with 16-byte row pitches of P
// and the output for the tensor maps (n a multiple of 8) WgV3, otherwise the
// 32 × 128 mma.sync tiles.
int v3_instance(int n) { return n % 8 == 0 ? kV3Wgmma : kV3Mma; }

cudaError_t run_v3(int instance, const void* w27, const void* p, void* out, int n, int repeats,
                   int aligned, cudaStream_t s) {
  switch (instance) {
    case kV3Mma:
      return gemm_any<32, 128, 1, 4, true>(w27, p, out, kGroup, n, 27 * kBK, repeats, aligned, s);
    case kV3Wgmma: return gemm_wgmma<WgV3>(w27, p, out, kGroup, n, 27 * kWgBK, repeats, s);
  }
  return cudaErrorInvalidValue;
}

// The instances of hvc_probe_v4 (v4: one M = 864 dot w27 · x, its 27 row
// groups summed) and hvc_probe_v6 (v6: 7 M = 128 dots of w27p · x, 27 of
// their 28 row groups summed).
enum V4Instance {
  kV4Mma = 0,    // probe_tapsum, 32 × 32 tiles, 9 × 2 warps (V4's before wgmma)
  kV4Wgmma = 1,  // WgV4: W resident as A, one accumulator chain, 32 × 128 a work item
};
enum V6Instance {
  kV6Mma = 0,    // probe_tapsum, 32 × 64 tiles, 4 × 2 warps (V6's before wgmma)
  kV6Wgmma = 1,  // WgV6: W resident as A, M = 128 dots in two chains, 32 × 128 a work item
};

// The rules of hvc_probe_v4 and hvc_probe_v6, instance codes: with 16-byte
// row pitches of X and the output for the tensor maps (n a multiple of 8)
// the wgmma instance, otherwise probe_tapsum on mma.sync.
int v4_instance(int n) { return n % 8 == 0 ? kV4Wgmma : kV4Mma; }
int v6_instance(int n) { return n % 8 == 0 ? kV6Wgmma : kV6Mma; }

cudaError_t run_v4(int instance, const void* w27, const void* x, void* out, int n, int repeats,
                   int aligned, cudaStream_t s) {
  switch (instance) {
    case kV4Mma: return tapsum<64, 1, 27, 27, 9, 2, 16>(w27, x, out, n, repeats, aligned, s);
    case kV4Wgmma: return tapsum_wgmma<WgV4>(w27, x, out, n, repeats, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run_v6(int instance, const void* w27p, const void* x, void* out, int n, int repeats,
                   int aligned, cudaStream_t s) {
  switch (instance) {
    case kV6Mma: return tapsum<64, 7, 4, 27, 4, 2, 32>(w27p, x, out, n, repeats, aligned, s);
    case kV6Wgmma: return tapsum_wgmma<WgV6>(w27p, x, out, n, repeats, s);
  }
  return cudaErrorInvalidValue;
}
}  // namespace

// Entry points: bf16 operands, row-major and contiguous, 16-byte aligned
// bases; `aligned` = 1 when N is a multiple of 8. Each returns the launch's
// cudaError_t (0 = success) and does not synchronise.
extern "C" {

// out (m, n) fp32 = w (m, k) · p (k, n); k a multiple of 64; on the instance
// hvc_probe_v1_rule names.
int hvc_probe_v1(const void* w, const void* p, void* out, int m, int k, int n, int repeats,
                 int aligned, void* stream) {
  return run_v1(v1_instance(m, n), w, p, out, m, k, n, repeats, aligned,
                static_cast<cudaStream_t>(stream));
}

// The instance code hvc_probe_v1 runs a call of these sizes on (V1Instance:
// 0 32 × 128 mma.sync, 1 128 × 128 mma.sync, 2 WgV0, 3 WgV1), the rule the
// wrapper counts its launches by.
int hvc_probe_v1_rule(int m, int k, int n) {
  (void)k;
  return v1_instance(m, n);
}

// hvc_probe_v1 on a named instance (V1Instance), for comparing them
// (scripts/probe_variants.py); a wgmma instance needs its tensor maps'
// pitches (n a multiple of 8).
int hvc_probe_v1_instance(const void* w, const void* p, void* out, int m, int k, int n,
                          int repeats, int aligned, int instance, void* stream) {
  return run_v1(instance, w, p, out, m, k, n, repeats, aligned, static_cast<cudaStream_t>(stream));
}

// out (n, 32) fp32 = pt (n, k) · wt (k, 32); k a multiple of 64, at most
// kV2MaxK; on the instance hvc_probe_v2_rule names.
int hvc_probe_v2(const void* pt, const void* wt, void* out, int k, int n, int repeats,
                 void* stream) {
  return run_v2(v2_instance(k, n), pt, wt, out, k, n, repeats, static_cast<cudaStream_t>(stream));
}

// The instance code hvc_probe_v2 runs a call of these sizes on (V2Instance;
// -1: none, the call is refused).
int hvc_probe_v2_rule(int k, int n) { return v2_instance(k, n); }

// hvc_probe_v2 on a named instance (V2Instance), for comparing them
// (scripts/probe_variants.py): w is wt (k, 32) for 0 and 1, its transpose
// (32, k) for 2.
int hvc_probe_v2_instance(const void* pt, const void* w, void* out, int k, int n, int repeats,
                          int instance, void* stream) {
  return run_v2(instance, pt, w, out, k, n, repeats, static_cast<cudaStream_t>(stream));
}

// out (32, n) = Σ_{t<27} w27[32t:32t+32] (32, 64) · p[64t:64t+64] (64, n); p (1728, n);
// on the instance hvc_probe_v3_rule names.
int hvc_probe_v3(const void* w27, const void* p, void* out, int n, int repeats, int aligned,
                 void* stream) {
  return run_v3(v3_instance(n), w27, p, out, n, repeats, aligned,
                static_cast<cudaStream_t>(stream));
}

// The instance code hvc_probe_v3 runs a call of n columns on (V3Instance: 0
// mma.sync, 1 WgV3), the rule the wrapper counts its launches by.
int hvc_probe_v3_rule(int n) { return v3_instance(n); }

// hvc_probe_v3 on a named instance (V3Instance), for comparing them
// (scripts/probe_variants.py); the wgmma instance needs n a multiple of 8.
int hvc_probe_v3_instance(const void* w27, const void* p, void* out, int n, int repeats,
                          int aligned, int instance, void* stream) {
  return run_v3(instance, w27, p, out, n, repeats, aligned, static_cast<cudaStream_t>(stream));
}

// out (32, n) = Σ_{t<27} w27[32t:32t+32] (32, 64) · x (64, n)
int hvc_probe_v3p(const void* w27, const void* x, void* out, int n, int repeats, int aligned,
                  void* stream) {
  return tapsum<64, 27, 1, 27, 1, 8, 32>(w27, x, out, n, repeats, aligned,
                                         static_cast<cudaStream_t>(stream));
}

// out (32, n) = Σ_{t<14} w14[32t:32t+32] (32, 128) · x2 (128, n)
int hvc_probe_v5(const void* w14, const void* x2, void* out, int n, int repeats, int aligned,
                 void* stream) {
  return tapsum<128, 14, 1, 14, 1, 8, 32>(w14, x2, out, n, repeats, aligned,
                                          static_cast<cudaStream_t>(stream));
}

// out (32, n) = Σ_{t<27} w27p[32t:32t+32] · x, as 7 dots of M = 128; w27p (896, 64);
// on the instance hvc_probe_v6_rule names.
int hvc_probe_v6(const void* w27p, const void* x, void* out, int n, int repeats, int aligned,
                 void* stream) {
  return run_v6(v6_instance(n), w27p, x, out, n, repeats, aligned,
                static_cast<cudaStream_t>(stream));
}

// The instance code hvc_probe_v6 runs a call of n columns on (V6Instance: 0
// mma.sync, 1 WgV6), the rule the wrapper counts its launches by.
int hvc_probe_v6_rule(int n) { return v6_instance(n); }

// hvc_probe_v6 on a named instance (V6Instance), for comparing them
// (scripts/probe_variants.py); the wgmma instance needs n a multiple of 8.
int hvc_probe_v6_instance(const void* w27p, const void* x, void* out, int n, int repeats,
                          int aligned, int instance, void* stream) {
  return run_v6(instance, w27p, x, out, n, repeats, aligned, static_cast<cudaStream_t>(stream));
}

// out (32, n) = Σ_{t<27} rows 32t..32t+31 of w27 (864, 64) · x, one M = 864 dot;
// on the instance hvc_probe_v4_rule names.
int hvc_probe_v4(const void* w27, const void* x, void* out, int n, int repeats, int aligned,
                 void* stream) {
  return run_v4(v4_instance(n), w27, x, out, n, repeats, aligned,
                static_cast<cudaStream_t>(stream));
}

// The instance code hvc_probe_v4 runs a call of n columns on (V4Instance: 0
// mma.sync, 1 WgV4), the rule the wrapper counts its launches by.
int hvc_probe_v4_rule(int n) { return v4_instance(n); }

// hvc_probe_v4 on a named instance (V4Instance), for comparing them
// (scripts/probe_variants.py); the wgmma instances need n a multiple of 8.
int hvc_probe_v4_instance(const void* w27, const void* x, void* out, int n, int repeats,
                          int aligned, int instance, void* stream) {
  return run_v4(instance, w27, x, out, n, repeats, aligned, static_cast<cudaStream_t>(stream));
}

// out (32, n) = Σ_{t<9} w9[32t:32t+32] (32, 192) · x3 (192, n)
int hvc_probe_v8(const void* w9, const void* x3, void* out, int n, int repeats, int aligned,
                 void* stream) {
  return tapsum<192, 9, 1, 9, 1, 8, 32>(w9, x3, out, n, repeats, aligned,
                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
