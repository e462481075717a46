// Kernel A: flash attention forward for Hopper (sm_90a).
//
// Replaces hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py::_flash_fwd_padded
// (kernel body _fwd_kernel): out = softmax(q·kᵀ·scale)·v with an online softmax
// over KV tiles, fp32 running max / sum / accumulator, no score matrix in device
// memory, and a per-row log-sum-exp. The TPU kernel stores the lse in base 2;
// this one stores it in base e (natural log), which is what a caller of the
// forward alone can use directly.
//
// Not carried over from the TPU kernel: the 128-lane padding of d and the
// "ones-lane" padded into V. Both work around the TPU's (8, 128) tiling; here
// d is a template parameter (32, 64 or 128; the wrapper zero-pads any other
// d ≤ 128 to the next of these), and the tensor-core path takes the same row
// sum from an all-ones operand of its own (the CUDA-core path sums in a
// register).
//
// What bounds it on this card: at the main path's long shapes (8 heads ×
// 32,768 queries × 32,768 keys, d = 32) the work is 4·N²·d flops per head and
// the inputs are a few MB, so the kernel is compute-bound: the products on
// the tensor cores (1.1 ms at 989 TFLOP/s) and one exp2 per score on the
// special-function units (16 a clock per SM: 8.6e9 exp2 take ~2 ms at 132
// SMs × 1.98 GHz), the larger of the two. Two instances, by an explicit rule
// (no fallback): bf16 on the tensor cores, fp32 on the CUDA cores (TF32 would
// leave the fp32 tolerances).
//
// bf16 on the tensor cores (flash_fwd_tc_kernel), FlashAttention-2's forward
// on mma.sync m16n8k16 (bf16 in, fp32 accumulate): a block of 4 warps owns
// 64 query rows, each warp 16, whose q fragments stay in registers for the
// whole loop (d/16 k-steps); K and V tiles of 64 keys are double-buffered in
// shared memory by cp.async (rows padded by 16 bytes: ldmatrix
// conflict-free), the next tile's copy running under the current one's work.
// Per tile a warp computes its 16 × 64 scores S = q·kᵀ (ldmatrix of K rows as
// the B operand), masks keys past Nk on the ragged last tile, takes the row
// max with quad shuffles, and forms p = exp2(S·scale·log2e − m) in one FFMA
// and one exp2 per score; p is rounded to bf16, and the row sum that
// normalizes the output adds those rounded values on the tensor cores, as
// the TPU kernel's ones-lane sums p.astype(v.dtype): one more mma per 16 keys,
// P against an all-ones B fragment, which leaves every row's sum in all four
// lanes of its quad (no ALU work per score, no shuffles). A second row sum
// adds p unrounded (one FADD a score) for the lse, so the lse keeps the
// plain version's fp32 meaning that D, L and M read. The score fragments are
// the A fragments of the next product as they lie, so O += P·V takes them
// from registers (V by ldmatrix.trans). The rows of the output are written
// once, divided by the rounded row sum; lse = (m + log2 l_exact)·ln 2.
// wgmma (64-row warpgroup tiles) and a polynomial exp2 on the FMA units,
// which FlashAttention-3 uses to get under the exp2 term, are not used.
//
// At d = 128 the tensor-core instance holds a 16 × 128 fp32 accumulator and
// the q fragments a warp (96 registers a thread): it is launched for 2 blocks
// an SM (255 registers a thread) where d ≤ 64 takes 4, and its 87 KB of
// shared memory is dynamic.
//
// fp32 on the CUDA cores (flash_fwd_kernel): fp32 FMAs, one query row per
// thread (d = 128: half a row, the two halves' dot products combined with one
// warp shuffle), with q, the accumulator and one tile of scores held in registers;
// K and V tiles staged once per block in shared memory and read as float4
// broadcasts, so four FMAs are issued per shared-memory load; one exp2 per
// score, with log2(e) folded into the q pre-scale.
//
// Layout: q (BH, Nq, d), k and v (BH, Nk, d), contiguous, fp32 or bf16 (the
// bf16 ones 16-byte aligned). out (BH, Nq, d) in the input dtype, lse (BH, Nq)
// fp32. Ragged Nq and Nk are masked. All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"

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

// TPR threads per query row (neighbouring lanes), each owning DH = D / TPR
// columns of q and of the accumulator.
template <typename T, int D, int BKV, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, long long nq, long long nk,
                 float scale_log2) {
  constexpr int DH = D / TPR;
  static_assert(DH % 4 == 0, "a thread's columns must be a multiple of 4");
  __shared__ __align__(16) float ks[BKV * D];
  __shared__ __align__(16) float vs[BKV * D];

  const long long bh = blockIdx.y;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / TPR) + threadIdx.x / TPR;
  const int c0 = (threadIdx.x % TPR) * DH;  // first column owned by this thread
  const bool valid = row < nq;
  const T* qrow = q + (bh * nq + (valid ? row : 0)) * D + c0;
  const T* kb = k + bh * nk * D;
  const T* vb = v + bh * nk * D;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) {
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
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D + c0);
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DH / 4; ++c4) {
        const float4 kk = kr[c4];
        dot = fmaf(qr[4 * c4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[j] = j < n_valid ? dot : -CUDART_INF_F;
      m_new = fmaxf(m_new, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite here and
    // exp2(-inf) = 0 clears the (empty) state on the first tile.
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D + c0);
#pragma unroll
      for (int c4 = 0; c4 < DH / 4; ++c4) {
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
    T* orow = out + (bh * nq + row) * D + c0;
#pragma unroll
    for (int c = 0; c < DH; ++c) orow[c] = from_f32<T>(acc[c] * inv);
    if (c0 == 0) lse[bh * nq + row] = (m + log2f(l)) * kLn2;
  }
}

template <typename T, int D, int BKV, int TPR>
void launch(const void* q, const void* k, const void* v, void* out, void* lse, long long bh,
            long long nq, long long nk, float scale, cudaStream_t stream) {
  constexpr int rows = kThreads / TPR;  // query rows per block
  const dim3 grid(static_cast<unsigned>((nq + rows - 1) / rows), static_cast<unsigned>(bh));
  flash_fwd_kernel<T, D, BKV, TPR><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), nq, nk, scale * kLog2e);
}

// ------------------------------------------------- A on the tensor cores ---

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKv = 64;               // keys per tile

template <int D>
struct FwdTcShape {
  static constexpr int LD = D + 8;  // bf16 per shared row: 16 bytes of padding
  // q, then K and V × 2 buffers, dynamic (d = 128: 87,040 bytes)
  static constexpr int SMEM = (kTcRows + 4 * kTcKv) * LD * 2;
  // ≤ 128 registers a thread at d ≤ 64 (4 blocks an SM), ≤ 255 at d = 128
  static constexpr int MIN_BLOCKS = D <= 64 ? 4 : 2;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [r0, r0 + n) of a (rows, D) bf16 array into shared memory rows of LD,
// 16 bytes a thread, zero-filled past `rows`
template <int D, int LD, int N>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long r0,
                                          long long rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < N * kChunks; c += kTcWarps * 32) {
    const int r = c / kChunks, k8 = (c % kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + k8, ok ? src + (r0 + r) * D + k8 : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32, FwdTcShape<D>::MIN_BLOCKS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                    long long nq, long long nk, float scale_log2) {
  constexpr int LD = FwdTcShape<D>::LD;
  constexpr int KS = D / 16; // k-steps of q·kᵀ
  constexpr int DT = D / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks[2] = {qs + kTcRows * LD, qs + (kTcRows + kTcKv) * LD};
  bf16* vs[2] = {qs + (kTcRows + 2 * kTcKv) * LD, qs + (kTcRows + 3 * kTcKv) * LD};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.y;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTcRows;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;
  const int n_tiles = static_cast<int>((nk + kTcKv - 1) / kTcKv);

  load_rows<D, LD, kTcRows>(qs, q + bh * nq * D, q0, nq, tid);
  load_rows<D, LD, kTcKv>(ks[0], kb, 0, nk, tid);
  load_rows<D, LD, kTcKv>(vs[0], vb, 0, nk, tid);
  cp_async_commit();

  uint32_t qa[KS][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of rows lane/4 and lane/4 + 8,
                                                // base-2 units (scores × scale·log2e)
  float lr[4] = {0.f, 0.f, 0.f, 0.f};  // row sums of the rounded p, by the ones product:
                                      // rows lane/4 (0, 1) and lane/4 + 8 (2, 3)
  float le[2] = {0.f, 0.f};            // this thread's share of the row sums of p, for the lse
  constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 ones

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile, into the buffer tile t − 1 used
      load_rows<D, LD, kTcKv>(ks[buf ^ 1], kb, static_cast<long long>(t + 1) * kTcKv, nk, tid);
      load_rows<D, LD, kTcKv>(vs[buf ^ 1], vb, static_cast<long long>(t + 1) * kTcKv, nk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and, the first time, q) is in shared memory
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) load_a(qa[kk], qs, LD, warp * 16, kk * 16, lane);
    }

    // S = q·kᵀ: s[j] holds keys 8j + 2·(lane % 4) + {0, 1} of rows lane / 4
    // (e = 0, 1) and lane / 4 + 8 (e = 2, 3)
    float s[kTcKv / 8][4];
#pragma unroll
    for (int j = 0; j < kTcKv / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < kTcKv / 16; ++j2) {
        uint32_t b[4];
        ldsm_x4(b, ks[buf] + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                       (((lane >> 3) & 1) << 3));
        mma16816(s[2 * j2], qa[kk], b[0], b[1]);
        mma16816(s[2 * j2 + 1], qa[kk], b[2], b[3]);
      }
    const long long kv0 = static_cast<long long>(t) * kTcKv;
    if (kv0 + kTcKv > nk) {  // the ragged last tile (it holds at least one key)
#pragma unroll
      for (int j = 0; j < kTcKv / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + 8 * j + 2 * (lane & 3) + (e & 1) >= nk) s[j][e] = -CUDART_INF_F;
    }

    // the online softmax, per row half h (row lane / 4 + 8h)
    float alpha[2], mneg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kTcKv / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);  // finite: the tile has a key
      alpha[h] = exp2f(m[h] - m_new);                    // 0 on the first tile
      m[h] = m_new;
      mneg[h] = -m_new;
    }
    uint32_t p[kTcKv / 8][2];  // bf16 pairs of p: [j][h]
    float es[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTcKv / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(fmaf(s[j][2 * h], scale_log2, mneg[h]));
        const float p1 = exp2f(fmaf(s[j][2 * h + 1], scale_log2, mneg[h]));
        p[j][h] = pack_bf16(p0, p1);
        es[h] += p0 + p1;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) le[h] = le[h] * alpha[h] + es[h];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    lr[0] *= alpha[0];
    lr[1] *= alpha[0];
    lr[2] *= alpha[1];
    lr[3] *= alpha[1];

    // O += P·V: keys 16·kk … 16·kk + 15 are one k-step; the score fragments
    // of key tiles 2kk and 2kk + 1 are its A fragment
#pragma unroll
    for (int kk = 0; kk < kTcKv / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
      mma16816(lr, a, kOnes, kOnes);  // the rounded row sums, in every column
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t b[4];
        load_b2(b, vs[buf], LD, kk * 16, jd * 16, lane);
        mma16816(o[2 * jd], a, b[0], b[1]);
        mma16816(o[2 * jd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // tile t's buffers are no longer read: the next copy may reuse them
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    le[h] += __shfl_xor_sync(0xffffffffu, le[h], 1);
    le[h] += __shfl_xor_sync(0xffffffffu, le[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= nq) continue;
    const float inv = 1.f / lr[2 * h];
    bf16* orow = out + (bh * nq + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    if ((lane & 3) == 0) lse[bh * nq + row] = (m[h] + log2f(le[h])) * kLn2;
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, void* lse, long long bh,
              long long nq, long long nk, float scale, cudaStream_t stream) {
  constexpr int smem = FwdTcShape<D>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((nq + kTcRows - 1) / kTcRows), static_cast<unsigned>(bh));
  flash_fwd_tc_kernel<D><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), nq, nk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; q, k, v 16-byte
// aligned). head_dim: 32, 64 or 128. Returns a cudaError_t.
extern "C" int hvc_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, long long bh, long long nq, long long nk,
                                       int head_dim, int dtype, float scale, void* stream) {
  // the smallest row block of any instance: 64 rows (tensor cores; d = 128 on the CUDA cores)
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || (nq + kTcRows - 1) / kTcRows > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (head_dim == 32) return launch_tc<32>(q, k, v, out, lse, bh, nq, nk, scale, s);
    if (head_dim == 64) return launch_tc<64>(q, k, v, out, lse, bh, nq, nk, scale, s);
    if (head_dim == 128) return launch_tc<128>(q, k, v, out, lse, bh, nq, nk, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && head_dim == 32) {
    launch<float, 32, 64, 1>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else if (dtype == 0 && head_dim == 64) {
    launch<float, 64, 32, 1>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else if (dtype == 0 && head_dim == 128) {
    launch<float, 128, 32, 2>(q, k, v, out, lse, bh, nq, nk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
