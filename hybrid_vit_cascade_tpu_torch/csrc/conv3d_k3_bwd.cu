// Kernels E, F and G: gradients of the 3×3×3 convolution (padding 1), and
// their chain forms J and K, for Hopper (sm_90a).
//
//   E  stride-1 weight gradient. Replaces
//      hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py::_wgrad (body _wgrad_kernel).
//   F  stride-2 data gradient. Replaces
//      hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py::_dgrad_s2 (body _dgrad_kernel).
//   G  stride-2 weight gradient. Replaces
//      hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py::_wgrad_s2 (body _wgrad_kernel).
//   J  F with the chain options of _dgrad_s2: the output-plane window
//      (out_window) and the act′ epilogue (dact).
//   K  E and G with the chain options of _wgrad / _wgrad_s2: the input-plane
//      window and the activation prologue replayed (act).
//
// (The stride-1 data gradient is kernel B/H itself, run on the output
// gradient with channel-transposed, tap-flipped weights, as the TPU package
// does.)
//
// The input side is addressed as in csrc/conv3d_k3.cu: output plane o of the
// conv reads planes S·o + {0, 1, 2} of a virtual D-slab whose plane q is
// plane q − qlo of the view x (nv planes, batch/channel strides xb/xc), zero
// outside the view. The dense conv is qlo = 1 over all D planes. Semantics
// are then those of torch.nn.grad.conv3d_weight / conv3d_input for
// F.conv3d(slab, w, stride=S, padding=(0, 1, 1)):
//   dW[co, ci, dz, dy, dx] = Σ_{b, oz, oy, ox} g[b, co, oz, oy, ox] ·
//                            act(slab[b, ci, S·oz+dz, S·oy+dy−1, S·ox+dx−1])
//   dx[b, ci, q, iy, ix]   = act′(x…) · Σ_{co, taps with S·o + d = q} g[b, co, o…] · w[co, ci, d…]
// for the view's planes q only (the window: dx is never written outside it),
// with zero padding, fp32 accumulation, dW in fp32 and dx in the input dtype.
//
// Not carried over from the TPU kernels: the flat (H·W)-lane layout, the
// g-shifting by lane rolls, the even/odd plane split and the selection-matrix
// packing (_sel_matrix) of the stride-2 kernels, and the "arbitrary" grid
// that accumulates dW into one resident output block. Hopper runs blocks
// concurrently, so the weight gradients split the B·D·H·W reduction over
// blocks (split-K): each block writes its fp32 partial sum, and a second
// small kernel adds the partials in a fixed order — deterministic, so the
// card-vs-plain check is stable.
//
// What bounds them on this card: the hot weight gradient (64→32 at 256³,
// 1.86 TFLOP) is compute-bound; the hot stride-2 data gradient (32→64, dx of
// 256³ from g of 128³: 0.23 TFLOP = 0.23 ms at the bf16 peak, 1.34 GB of g,
// weights and dx = 0.40 ms) is bound by its bytes; the 1-channel ones (1→32,
// 1→64 at 256³) are bound by reading the 32/64-channel output gradient. The
// chain options add work per staged input value (K's prologue) or per
// written output value (J's act′), not per product, so J and K keep those
// bounds; J's epilogue is a template flag, so F compiles without it.
//   E/G/K, four instances, picked by an explicit rule (wgrad_instance, which
//        the wrapper reads through hvc_conv3d_k3_wgrad_tc): bf16 calls with
//        Cin ≥ 8 take the tensor cores, bf16 stride-1 calls with Cin = 1 (the
//        1→32 / 1→64 convs, bound by reading g) the one-input-channel
//        tensor-core instance (wgrad_c1in_tc_kernel: taps as N, three
//        pre-shifted copies of x; its comment has the design), bf16 stride-2
//        calls with Cin = 1 (stage 1's 1→64 stem) its stride-2 form
//        (wgrad_c1in_s2_tc_kernel: three copies by column parity), fp32 calls
//        (TF32 would leave the fp32 tolerances) and Cin 2-7 the CUDA cores.
//   E/G/K on the tensor cores (wgrad_tc_kernel): the GEMM dW[co, (ci, tap)] =
//        Σ_voxel g[co, voxel] · x_tap[voxel, ci], M = Cout (32 a block),
//        N = 32 input channels × 27 taps, K = output voxels, on mma.sync
//        m16n8k16 bf16 → fp32 (the shape PR 5's probe measured at 424.5
//        TF/s: Cout = 32 as M, no taps stacked into M; wgmma's 64-row M would
//        waste half of a 32-channel Cout tile). Nine warps, warp w holding the
//        taps (w / 3, w % 3, dx = 0..2) for all 32 × 32 (co, ci): 96 fp32
//        accumulators a thread. A block walks its split's tiles (every
//        splits-th one, so a wave's blocks work on neighbouring tiles) of
//        TD × TH × 16 output voxels (4 × 4 × 16 at stride 1, 2 × 2 × 16 at stride 2);
//        each tile row is one K step of 16 voxels. The alignment trap: a tap
//        shifts the input by one bf16 (2 bytes) along W, so in x's NCDHW
//        layout the B rows of dx = 0 and 2 are not 16-byte aligned and
//        neither ldmatrix nor cp.async takes them. Way out: the input patch is
//        staged channels-innermost, [position][32 ci] (80-byte rows), so every
//        tap, at stride 1 or 2, is a per-lane row address of ldmatrix.trans
//        and every row stays aligned; at stride 2 the even and odd patch
//        columns are kept apart, so 16 neighbouring voxels read 16
//        consecutive positions. The transpose is paid once per staged value:
//        cp.async brings x's rows as they lie ([ci][row][8-column vectors],
//        16-byte aligned from column S·ow0 − 8, the halo columns inside the
//        outer vectors), and an 8 × 8 register transpose (byte permutes)
//        writes the patch, replaying the act prologue in fp32 rounded to bf16
//        on the way. g, the A operand, is staged by cp.async as it lies
//        ([co][voxel]), double-buffered; the next tile's copies run under the
//        current tile's products. The accumulators are flushed into the
//        split's partial every 16,384 voxels (round-to-nearest adds): the
//        tensor cores' own fp32 accumulation truncates, and one chain over a
//        split's whole share left the fp32 tolerance at 256³. Cin is zero-padded to 32 and Cout masked at
//        the staging; unaligned views (W or Wo not a multiple of 8, odd
//        strides) stage element by element instead of by cp.async.
//   E/G/K on the CUDA cores (wgrad_kernel): a block owns 32 output channels
//        × 4 input channels × 27 taps of dW (one 4-channel group per thread ×
//        4 (ci, tap) columns) and walks its share of 8×16 output-voxel tiles;
//        per tile it stages the output gradient as [voxel][32 channels] and
//        the input patch (halo zero-filled) in shared memory, so each voxel
//        costs one float4 broadcast of g plus one load per column for 16 FMAs.
//   Both write one fp32 partial per split of the voxel tiles; a second small
//   kernel adds the partials in split order (no atomics: repeatable bits).
//   F/J, four instances, picked by an explicit rule (dgrad_s2_instance,
//        which the wrapper reads through hvc_conv3d_k3s2_dgrad_tc): bf16 with
//        Cin ≥ 8 and Cout ≥ 8 takes the tensor cores; bf16 with one dx
//        channel, 8 ≤ Cout ≤ 64 and no act′ (stage 1's 1→64 stem, bound by
//        reading g) the one-dx-channel tensor cores (dgrad_s2_c1_tc_kernel:
//        taps as M, P[tap, g position] in shared memory, a parity gather; its
//        comment has the design), the same call in fp32 its CUDA-core form
//        (dgrad_s2_c1_f32_kernel: the same walk, P in fp32 FMAs); the rest of
//        fp32 (TF32 would leave the fp32 tolerances) and of bf16 the CUDA
//        cores.
//   F/J on the tensor cores (dgrad_s2_tc_kernel): dx splits into 8 parity
//        classes by the (z, y, x) parity of the voxel; a voxel at even index
//        takes tap d = 1 along that dim, one at odd index d ∈ {0, 2}, so the
//        classes take 1, 2, 2, 4, 2, 4, 4 and 8 of the 27 taps, and each is a
//        stride-1 GEMM over g: M = 32 dx channels (two m16 tiles), N = the
//        class's voxels, K = Cout × its taps, on mma.sync m16n8k16 bf16 →
//        fp32. A block owns 2 planes (paired by their padding-1 index iz =
//        view plane + qlo − 1, the even one first, so a slab starting at any
//        qlo is covered) × 8 rows × 32 columns of dx (512 voxels, 64 a class)
//        and walks Cout in chunks of 16. g's 2 × 5 × 17 patch is staged
//        channels-innermost, [position][16 co] in swizzled 32-byte rows, so
//        every tap is a per-lane row address of an ldmatrix B load (a tap
//        shifts g by one bf16, the alignment trap of the NCDHW layout): g's
//        rows arrive as they lie by 16-byte cp.async copies (unit stride: no
//        even/odd split) and an 8 × 8 register transpose writes the patch.
//        The chunk's weights arrive pre-arranged [tap][32 ci][16 co] (the A
//        operand) as one 27 KB cp.async copy; both copies of the next chunk
//        run under the current one's products (76 KB, two blocks an SM,
//        ≤ 128 registers a thread). Warp w takes class
//        row w % 4, all 16 class columns, of the classes {7, 0, 1, 2} (w < 4:
//        8 + 1 + 2 + 2 taps) or {3, 4, 5, 6} (4 + 2 + 4 + 4): every warp does
//        13 or 14 taps with 64 accumulators a thread, 2 A and 1 B
//        ldmatrix.x4 for 4 mma a tap.
//        Epilogue: the classes' accumulators interleave back into dx order in
//        a 66 KB fp32 tile that takes the staging's place, then each thread
//        writes 8 dx columns of a row with one 16-byte store, J's act′(x)
//        read by the same 16-byte vectors and applied in fp32 before the one
//        rounding to bf16. Each dx element has one writer: repeatable bits.
//   F/J on the CUDA cores (dgrad_s2_kernel): one input voxel per thread and
//        32 input channels per block in registers (fewer dx channels pad
//        them; the stem's one, without act′, takes its own instance in either
//        dtype); per chunk of 8 output
//        channels the block stages the 2×5×17 output-gradient patch its 8×32
//        input tile reads and the chunk's weights [co][tap][ci] (rows padded
//        to 36 floats against bank conflicts) in shared memory. Each voxel
//        visits only the taps its parity selects (1 or 2 per dim), each tap
//        one g load and eight float4 weight broadcasts for 32 FMAs.
//
// Layout: x (B, Cin, D, H, W), g (B, Cout, Do, Ho, Wo) with Do = (D − 1)/S + 1,
// w (Cout, Cin, 3, 3, 3), all contiguous and in one dtype (fp32 or bf16).
// All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

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

// ------------------------------------------------------------ E and G ---

constexpr int kWgThreads = 256;
constexpr int kWgCo = 32;  // output channels per block
constexpr int kWgTh = 8;   // output-voxel tile rows
constexpr int kWgTw = 16;  // output-voxel tile columns

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

template <typename T, int S, int CI_C>
__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
             int cin, int cout, int nv, int qlo, long long xbs, long long xcs, int act, int H,
             int W, int Do, int Ho, int Wo, long long n_tiles, long long tiles_per_split) {
  constexpr int NV = kWgTh * kWgTw;
  constexpr int PH = (kWgTh - 1) * S + 3;
  constexpr int PW = (kWgTw - 1) * S + 3;
  constexpr int PATCH = 3 * PH * PW;
  constexpr int NN = CI_C * 27;          // (ci, tap) columns of the block
  constexpr int NPT = (NN + 31) / 32;    // columns per thread
  __shared__ float xs[CI_C * PATCH];
  __shared__ __align__(16) float gs[NV * kWgCo];  // [voxel][channel]

  const int co0 = blockIdx.y * kWgCo;
  const int ci0 = blockIdx.z * CI_C;
  const int quad = threadIdx.x / 32;  // output channels co0 + 4·quad … +3
  const int slot = threadIdx.x % 32;  // columns slot, slot + 32, …

  int xoff[NPT];
  bool nvalid[NPT];
#pragma unroll
  for (int t = 0; t < NPT; ++t) {
    const int n = slot + 32 * t;
    const int cl = n / 27;
    const int tap = n - cl * 27;
    nvalid[t] = n < NN && ci0 + cl < cin;
    xoff[t] = nvalid[t] ? cl * PATCH + (tap / 9) * PH * PW + ((tap / 3) % 3) * PW + tap % 3 : 0;
  }
  float acc[NPT][4];
#pragma unroll
  for (int t = 0; t < NPT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int tiles_w = (Wo + kWgTw - 1) / kWgTw;
  const int tiles_hw = ((Ho + kWgTh - 1) / kWgTh) * tiles_w;
  const long long plane = static_cast<long long>(H) * W;
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const long long t_begin = blockIdx.x * tiles_per_split;
  const long long t_end = min(n_tiles, t_begin + tiles_per_split);

  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int thw = static_cast<int>(tile % tiles_hw);
    const long long bd = tile / tiles_hw;
    const int od = static_cast<int>(bd % Do);
    const long long b = bd / Do;
    const int tile_h = thw / tiles_w;
    const int tile_w = thw % tiles_w;
    const int p0 = od * S - qlo;  // view plane of the patch origin
    const int ih0 = tile_h * kWgTh * S - 1;
    const int iw0 = tile_w * kWgTw * S - 1;
    const T* xb = x + b * xbs;
    const T* gb = g + (b * cout + co0) * ovol + od * oplane;

    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < CI_C * PATCH; i += kWgThreads) {
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
      if (ci < cin && p >= 0 && p < nv && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        val = to_f32(xb[ci * xcs + p * plane + static_cast<long long>(ih) * W + iw]);
        if (act) val = to_f32(from_f32<T>(act_f32(act, val)));  // the forward's prologue
      }
      xs[i] = val;
    }
    for (int i = threadIdx.x; i < NV * kWgCo; i += kWgThreads) {
      const int co = i % kWgCo;
      const int vv = i / kWgCo;
      const int oh = tile_h * kWgTh + vv / kWgTw;
      const int ow = tile_w * kWgTw + vv % kWgTw;
      float val = 0.f;
      if (co0 + co < cout && oh < Ho && ow < Wo)
        val = to_f32(gb[co * ovol + static_cast<long long>(oh) * Wo + ow]);
      gs[i] = val;
    }
    __syncthreads();

#pragma unroll 4
    for (int vv = 0; vv < NV; ++vv) {
      const float4 gg = *reinterpret_cast<const float4*>(gs + vv * kWgCo + 4 * quad);
      const int base = (vv / kWgTw) * S * PW + (vv % kWgTw) * S;
#pragma unroll
      for (int t = 0; t < NPT; ++t) {
        const float xv = xs[xoff[t] + base];
        acc[t][0] = fmaf(xv, gg.x, acc[t][0]);
        acc[t][1] = fmaf(xv, gg.y, acc[t][1]);
        acc[t][2] = fmaf(xv, gg.z, acc[t][2]);
        acc[t][3] = fmaf(xv, gg.w, acc[t][3]);
      }
    }
  }

  // partial[split][co][ci][tap]
  const long long n_out = static_cast<long long>(cout) * cin * 27;
  float* pb = partial + blockIdx.x * n_out;
#pragma unroll
  for (int t = 0; t < NPT; ++t) {
    if (!nvalid[t]) continue;
    const int n = slot + 32 * t;
    const int ci = ci0 + n / 27;
    const int tap = n % 27;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = co0 + 4 * quad + e;
      if (co < cout) pb[(static_cast<long long>(co) * cin + ci) * 27 + tap] = acc[t][e];
    }
  }
}

// ------------------------------------------- E, G and K on the tensor cores ---

constexpr int kTcWarps = 9;                // warp w: taps (dz, dy) = (w / 3, w % 3), dx = 0, 1, 2
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcCo = 32;                  // output channels per block: M
constexpr int kTcCi = 32;                  // input channels per block: N = 32 × 27 taps
constexpr int kTcTw = 16;                  // tile columns: one K step of 16 voxels per tile row
constexpr int kTcPld = kTcCi + 8;          // bf16 per patch position: 80 B, an odd number of
                                           // 16-byte units, so 8 consecutive positions hit
                                           // 8 different bank groups (ldmatrix conflict-free)

template <int S>
struct TcShape {
  static constexpr int TD = S == 1 ? 4 : 2;  // output planes per tile
  static constexpr int TH = S == 1 ? 4 : 2;  // output rows per tile
  static constexpr int TW = kTcTw;
  static constexpr int NV = TD * TH * TW;    // output voxels per tile: the tile's K
  static constexpr int PD = (TD - 1) * S + 3, PH = (TH - 1) * S + 3, PW = (TW - 1) * S + 3;
  static constexpr int R = PD * PH;          // rows of the input patch
  // A raw row: the 8-column vectors from input column S·ow0 − 8 (aligned)
  // through the patch's last column S·ow0 + (TW − 1)·S + 1.
  static constexpr int NVEC = ((TW - 1) * S + 9) / 8 + 1;
  static constexpr int PWE = S == 1 ? PW : TW + 1;  // S = 2: even columns, then odd ones
  static constexpr int PWP = PW | 1;                // positions per patch row, odd
  static constexpr int GLD = NV + 8;                // bf16 per output channel of the g tile
  static constexpr int RAW = kTcCi * NVEC * R * 8;  // bf16, [ci][vector][row][8]
  static constexpr int PATCH = R * PWP * kTcPld;    // bf16, [row][position][ci]
  static constexpr int GT = kTcCo * GLD;            // bf16, one of two buffers, [co][voxel]
  static constexpr int SMEM = (RAW + PATCH + 2 * GT) * 2;
  // Tiles between two flushes of the accumulators into the split's partial:
  // 16,384 voxels. The tensor cores add into an fp32 accumulator with
  // truncation, so its error grows with the chain's length times its
  // magnitude; shorter chains, added into the partial with round-to-nearest,
  // stay within the fp32 tolerance of the plain version at 16.7 M voxels (one
  // chain over a whole split's ~254 K voxels did not).
  static constexpr int FLUSH = 16384 / NV;
  // position of patch column pw within its row: S = 2 keeps the even and the
  // odd columns apart, so the taps of 16 neighbouring output voxels read 16
  // consecutive positions at either stride
  static __device__ __forceinline__ int pcol(int pw) {
    return S == 1 ? pw : (pw & 1) * PWE + (pw >> 1);
  }
};

__device__ __forceinline__ uint32_t act_bf16x2(int act, uint32_t w) {
  const float lo = act_f32(act, __uint_as_float(w << 16));
  const float hi = act_f32(act, __uint_as_float(w & 0xffff0000u));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Block b of the 1-D grid: input-channel chunk b % n_ci (fastest, so the
// chunks that read the same g tiles run together and share them in L2),
// output-channel tile (b / n_ci) % n_co, split b / (n_ci · n_co) taking the
// tiles split, split + splits, split + 2·splits, … in that order, so the
// blocks of a wave work on neighbouring tiles and share their halo rows in
// L2. VEC: x's rows and strides and g's rows are
// 16-byte aligned (W, Wo, xbs, xcs multiples of 8), so the staging copies go
// by cp.async; otherwise element by element.
template <int S, bool VEC>
__global__ void __launch_bounds__(kTcThreads, 1)
wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                float* __restrict__ partial, int cin, int cout, int nv, int qlo, long long xbs,
                long long xcs, int act, int H, int W, int Do, int Ho, int Wo, int n_ci, int n_co,
                int n_tiles, int splits) {
  using TS = TcShape<S>;
  constexpr int TD = TS::TD, TH = TS::TH, TW = TS::TW, R = TS::R, PH = TS::PH, NVEC = TS::NVEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);
  bf16* patch = raw + TS::RAW;
  bf16* gsm = patch + TS::PATCH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci0 = static_cast<int>(blockIdx.x % n_ci) * kTcCi;
  const int co0 = static_cast<int>((blockIdx.x / n_ci) % n_co) * kTcCo;
  const long long split = blockIdx.x / (n_ci * n_co);
  const int tiles_w = (Wo + TW - 1) / TW;
  const int tiles_h = (Ho + TH - 1) / TH;
  const int tiles_d = (Do + TD - 1) / TD;
  const long long plane = static_cast<long long>(H) * W;
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;

  // Stage tile `tile`: the raw input rows (channels ci0 … ci0 + 31, zero
  // outside the view's planes, the image and Cin) and the g tile (zero
  // outside the output and Cout) into gdst.
  auto issue = [&](int tile, bf16* gdst) {
    const int tx = tile % tiles_w;
    int rest = tile / tiles_w;
    const int ty = rest % tiles_h;
    rest /= tiles_h;
    const int tz = rest % tiles_d;
    const long long b = rest / tiles_d;
    const int od0 = tz * TD, oh0 = ty * TH, ow0 = tx * TW;
    const int p0 = od0 * S - qlo;  // view plane of the patch's first plane
    const int ih0 = oh0 * S - 1;
    const int c_first = ow0 * S - 8;
    const bf16* xb = x + b * xbs;
    // consecutive threads take consecutive vectors of a row: the warp reads
    // whole row segments (full 32-byte sectors)
    for (int u = tid; u < kTcCi * NVEC * R; u += kTcThreads) {
      const int v = u % NVEC;
      const int r = (u / NVEC) % R;
      const int ci = u / (R * NVEC);
      const int p = p0 + r / PH, ih = ih0 + r % PH, c = c_first + 8 * v;
      const bool row_ok = ci0 + ci < cin && p >= 0 && p < nv && ih >= 0 && ih < H;
      bf16* dst = raw + ((ci * NVEC + v) * R + r) * 8;
      if (VEC) {
        const bool ok = row_ok && c >= 0 && c < W;  // W % 8 = 0: a vector is all in or out
        const bf16* src = ok ? xb + (ci0 + ci) * xcs + p * plane + static_cast<long long>(ih) * W + c : x;
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        unsigned short e8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ce = c + e;
          e8[e] = row_ok && ce >= 0 && ce < W
                      ? __bfloat16_as_ushort(xb[(ci0 + ci) * xcs + p * plane +
                                                static_cast<long long>(ih) * W + ce])
                      : 0;
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(e8[0] | (uint32_t(e8[1]) << 16), e8[2] | (uint32_t(e8[3]) << 16),
                       e8[4] | (uint32_t(e8[5]) << 16), e8[6] | (uint32_t(e8[7]) << 16));
      }
    }
    const bf16* gb = g + (b * cout + co0) * ovol;
    for (int u = tid; u < kTcCo * TD * TH * (TW / 8); u += kTcThreads) {
      const int h8 = u % (TW / 8);
      const int vy = (u / (TW / 8)) % TH;
      const int vz = (u / (TW / 8 * TH)) % TD;
      const int co = u / (TW / 8 * TH * TD);
      const int od = od0 + vz, oh = oh0 + vy, ow = ow0 + 8 * h8;
      bf16* dst = gdst + co * TS::GLD + (vz * TH + vy) * TW + 8 * h8;
      const bool row_ok = co0 + co < cout && od < Do && oh < Ho;
      const long long off = co * ovol + od * oplane + static_cast<long long>(oh) * Wo + ow;
      if (VEC) {
        const bool ok = row_ok && ow < Wo;  // Wo % 8 = 0
        cp_async16(dst, ok ? gb + off : g, ok ? 16 : 0);
      } else {
        unsigned short e8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          e8[e] = row_ok && ow + e < Wo ? __bfloat16_as_ushort(gb[off + e]) : 0;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(e8[0] | (uint32_t(e8[1]) << 16), e8[2] | (uint32_t(e8[3]) << 16),
                       e8[4] | (uint32_t(e8[5]) << 16), e8[6] | (uint32_t(e8[7]) << 16));
      }
    }
  };

  // raw [ci][vector][row][8 columns] → patch [row][position][ci]: each unit
  // is 8 channels × 8 columns, transposed in registers (byte permutes), the
  // prologue applied on the way. Consecutive threads take consecutive rows,
  // so the 16-byte reads and writes of a quarter warp are conflict-free.
  auto transpose = [&]() {
    for (int u = tid; u < (kTcCi / 8) * NVEC * R; u += kTcThreads) {
      const int r = u % R;
      const int v = (u / R) % NVEC;
      const int cg = u / (R * NVEC);
      uint32_t w[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 t = *reinterpret_cast<const uint4*>(
            raw + ((static_cast<long long>(cg * 8 + i) * NVEC + v) * R + r) * 8);
        w[i][0] = t.x, w[i][1] = t.y, w[i][2] = t.z, w[i][3] = t.w;
      }
      if (act) {  // the forward's prologue, rounded to bf16; act(0) = 0 keeps the padding
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = act_bf16x2(act, w[i][j]);
      }
      bf16* prow = patch + static_cast<long long>(r) * TS::PWP * kTcPld + cg * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int pw = 8 * v + e - 7;  // raw column 0 is input column S·ow0 − 8
        if (pw < 0 || pw >= TS::PW) continue;
        const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
        const int j = e >> 1;
        *reinterpret_cast<uint4*>(prow + TS::pcol(pw) * kTcPld) =
            make_uint4(__byte_perm(w[0][j], w[1][j], sel), __byte_perm(w[2][j], w[3][j], sel),
                       __byte_perm(w[4][j], w[5][j], sel), __byte_perm(w[6][j], w[7][j], sel));
      }
    }
  };

  const int dz = warp / 3, dy = warp % 3;
  // this lane's row of the ldmatrix.trans B loads: output column ltx of a
  // tile row, channels lci … lci + 7 of a 16-channel group
  const int ltx = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lci = (lane >> 4) << 3;
  int lpos[3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) lpos[dx] = TS::pcol(ltx * S + dx) * kTcPld + lci;

  float acc[3][4][2][4];  // [dx][8-channel column tile][16-row co tile][fragment]
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][c][e] = 0.f;

  // partial[split][co][ci][tap], as the CUDA-core instance writes it: the
  // first flush stores, the later ones add (each element has one writer).
  // Written out in place: a lambda capturing acc put it in local memory.
  const long long n_out = static_cast<long long>(cout) * cin * 27;
  float* pb = partial + split * n_out;
// Per dx: the 32 old values are loaded first, all in flight together, then
// added and stored (one load, add and store at a time would wait on device
// memory 96 times a flush).
#define HVC_TC_FLUSH(FIRST)                                                                     \
  _Pragma("unroll") for (int dx = 0; dx < 3; ++dx) {                                            \
    float old[4][2][4];                                                                         \
    _Pragma("unroll") for (int nt = 0; nt < 4; ++nt)                                            \
    _Pragma("unroll") for (int mt = 0; mt < 2; ++mt)                                            \
    _Pragma("unroll") for (int f = 0; f < 4; ++f) {                                             \
      const int co = co0 + mt * 16 + (lane >> 2) + (f >> 1) * 8;                                \
      const int ci = ci0 + nt * 8 + (lane & 3) * 2 + (f & 1);                                    \
      old[nt][mt][f] = !(FIRST) && co < cout && ci < cin                                        \
          ? pb[(static_cast<long long>(co) * cin + ci) * 27 + dz * 9 + dy * 3 + dx] : 0.f;      \
    }                                                                                           \
    _Pragma("unroll") for (int nt = 0; nt < 4; ++nt)                                            \
    _Pragma("unroll") for (int mt = 0; mt < 2; ++mt)                                            \
    _Pragma("unroll") for (int f = 0; f < 4; ++f) {                                             \
      const int co = co0 + mt * 16 + (lane >> 2) + (f >> 1) * 8;                                \
      const int ci = ci0 + nt * 8 + (lane & 3) * 2 + (f & 1);                                    \
      if (co < cout && ci < cin)                                                                \
        pb[(static_cast<long long>(co) * cin + ci) * 27 + dz * 9 + dy * 3 + dx] =               \
            old[nt][mt][f] + acc[dx][nt][mt][f];                                                \
      acc[dx][nt][mt][f] = 0.f;                                                                 \
    }                                                                                           \
  }

  const int first_tile = static_cast<int>(split);
  if (first_tile < n_tiles) {
    issue(first_tile, gsm);
  } else {
    HVC_TC_FLUSH(true)  // an empty split writes zeros
  }
  cp_async_commit();
  int buf = 0;
  int done = 0;
  for (int tile = first_tile; tile < n_tiles; tile += splits) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's raw rows and g landed; the patch is no longer read
    transpose();
    __syncthreads();  // the patch is ready; the raw rows are free
    if (tile + splits < n_tiles) issue(tile + splits, gsm + (buf ^ 1) * TS::GT);
    cp_async_commit();
    const bf16* gt = gsm + buf * TS::GT;
#pragma unroll 1
    for (int vz = 0; vz < TD; ++vz) {
#pragma unroll
      for (int vy = 0; vy < TH; ++vy) {
        const int k0 = (vz * TH + vy) * TW;
        uint32_t a[2][4];
        load_a(a[0], gt, TS::GLD, 0, k0, lane);
        load_a(a[1], gt, TS::GLD, 16, k0, lane);
        const bf16* prow =
            patch + static_cast<long long>((vz * S + dz) * PH + vy * S + dy) * TS::PWP * kTcPld;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int c16 = 0; c16 < 2; ++c16) {
            uint32_t bfr[4];
            ldsm_x4_t(bfr, prow + lpos[dx] + c16 * 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma16816(acc[dx][2 * c16][mt], a[mt], bfr[0], bfr[1]);
              mma16816(acc[dx][2 * c16 + 1][mt], a[mt], bfr[2], bfr[3]);
            }
          }
      }
    }
    buf ^= 1;
    ++done;
    if (done % TS::FLUSH == 0 || tile + splits >= n_tiles) {
      HVC_TC_FLUSH(done <= TS::FLUSH)
    }
  }
  cp_async_wait<0>();
#undef HVC_TC_FLUSH
}

// out[i] = Σ_s partial[s][i], in split order.
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * n + i];
  out[i] = s;
}

// -------------------- E/K at stride 1 with one input channel on the tensor cores ---

constexpr int kW1Warps = 8;
constexpr int kW1Threads = kW1Warps * 32;
constexpr int kW1Co = 32;                           // output channels per block: M, two 16-row tiles
constexpr int kW1Td = 2, kW1Th = 2, kW1Tw = 64;     // output voxels per tile: 256, 16 K steps of 16
constexpr int kW1Nv = kW1Td * kW1Th * kW1Tw;
constexpr int kW1R = (kW1Td + 2) * (kW1Th + 2);     // input rows a tile reads: 4 planes × 4
constexpr int kW1Nvec = kW1Tw / 8 + 2;              // 8-column vectors of a raw row, from ow0 − 8
// Copy dx of the tile's input patch, shifted by dx − 1 along W: plane pd, row
// ph, column c holds act(x) at view plane od0 − qlo + pd, row oh0 − 1 + ph,
// column ow0 − 1 + dx + c. The pitches — rows 176 ≡ 48, planes 784 ≡ 16,
// copies 3,216 ≡ 16 bytes (mod 128) — start tap t = (dz, dy, dx) 16·t bytes
// (mod 128) after tap 0, so the 8 taps of one ldmatrix phase hit 8 different
// bank groups.
constexpr int kW1Row = 88;                          // bf16 per row: 64 columns + pad
constexpr int kW1Plane = 392;                       // bf16 per plane: 4 rows + pad
constexpr int kW1Copy = 1608;                       // bf16 per copy: 4 planes + pad
constexpr int kW1Zero = 3 * kW1Copy;                // the zero rows of taps 27-31, from
                                                    // 16·27 ≡ 48 (mod 128) like tap 27's
constexpr int kW1ZeroLen = 256;                     // bf16: room for every offset a row takes
constexpr int kW1Stages = 3;                        // tiles staged at once: two in flight
constexpr int kW1Gld = kW1Nv + 8;                   // bf16 per channel of the g tile: 528 bytes
constexpr int kW1Gt = kW1Co * kW1Gld;               // bf16, one stage's g tile, [co][voxel]
constexpr int kW1Raw = kW1R * kW1Nvec * 8;          // bf16, one stage's raw rows, [row][vector][8]
constexpr int kW1Smem =                             // 72,624 bytes: three blocks an SM
    (kW1Stages * (kW1Gt + kW1Raw) + kW1Zero + kW1ZeroLen) * 2 + kW1Co * 32 * 4;
// Tiles between two flushes: a warp's accumulators then hold 16,384 voxels'
// products, the chain length wgrad_tc_kernel flushes at (TcShape::FLUSH).
constexpr int kW1Flush = 16384 / (kW1Nv / kW1Warps);

// dW[co, 0, tap] = Σ_{b, voxel} g[b, co, voxel] · act(slab)[voxel + tap],
// the 1-channel weight gradient, as wgrad_kernel computes it: the GEMM
// dW[co, tap] = Σ_voxel g[co, voxel] · x_tap[voxel] with M = Cout (32 a
// block), N = the 27 taps padded to 32, K = output voxels, on mma.sync
// m16n8k16 bf16 → fp32 (the TPU kernel's _wgrad_kernel contracts the stitched
// x with g over voxels the same way). What bounds it is reading g, 32 or 64
// times the bytes of x. g, the A operand, is staged by 16-byte cp.async as it
// lies ([co][voxel]) in a ring of three stages: the next two tiles' copies
// run under the current tile's products, and three blocks an SM keep ~100 KB
// of g in flight.
// The alignment trap: a dx tap shifts x by one bf16 along W, so a B row (one
// tap, 8 neighbouring voxels) is 16-byte aligned for only one dx, and one
// input channel leaves nothing to stack channels-innermost. Way out: x's raw
// rows arrive by cp.async as they lie (8-column vectors from column ow0 − 8),
// and a pass writes three copies of the patch pre-shifted by dx − 1 (byte
// permutes in registers, the act prologue in fp32 rounded to bf16 on the way),
// so every tap of 8 voxels is an aligned row and ldmatrix gives the B
// fragments of two taps' n8 tiles in one x4 load; taps 27-31 read zero rows.
// A tile is 2 planes × 2 rows × 64 columns of output voxels; warp w takes its
// K steps 2w, 2w + 1 (plane w / 4, row (w / 2) % 2, columns 32·(w % 2) …) with
// all 32 × 32 (co, tap) in 32 fp32 accumulators a thread. A block walks its
// split's tiles (every splits-th one, so a wave's blocks work on neighbouring
// tiles). Every kW1Flush tiles and after the last, the warps add their
// accumulators in warp order into a shared 32 × 27 sum (round-to-nearest
// fp32 adds: the tensor cores' own accumulation truncates), which goes into
// the split's partial (the first flush stores, the later ones add; each
// element has one writer). Block b of the 1-D grid: Cout tile b % n_co,
// split b / n_co. VEC: x's rows and batch stride and g's rows are 16-byte
// aligned (W a multiple of 8), so the copies go by cp.async; otherwise
// element by element.
template <bool VEC>
__global__ void __launch_bounds__(kW1Threads, 3)
wgrad_c1in_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ partial, int cout, int nv, int qlo, long long xbs,
                     int act, int H, int W, int Do, int n_co, int n_tiles, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gsm = reinterpret_cast<bf16*>(smem_raw);  // the stages' g tiles
  bf16* raws = gsm + kW1Stages * kW1Gt;            // the stages' raw rows
  bf16* xs = raws + kW1Stages * kW1Raw;            // 3 copies, then the zero rows
  float* red = reinterpret_cast<float*>(xs + kW1Zero + kW1ZeroLen);  // [co][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = static_cast<int>(blockIdx.x % n_co) * kW1Co;
  const int split = static_cast<int>(blockIdx.x / n_co);
  const int Ho = H, Wo = W;
  const int tiles_w = (Wo + kW1Tw - 1) / kW1Tw;
  const int tiles_h = (Ho + kW1Th - 1) / kW1Th;
  const int tiles_d = (Do + kW1Td - 1) / kW1Td;
  const long long plane = static_cast<long long>(H) * W;
  const long long ovol = static_cast<long long>(Do) * plane;

  if (tid < kW1ZeroLen / 8)
    reinterpret_cast<uint4*>(xs + kW1Zero)[tid] = make_uint4(0u, 0u, 0u, 0u);

  // Stage tile `tile` into stage `st`: the raw input rows (zero outside the
  // view's planes and the image) and the g tile (zero outside the output and
  // Cout).
  auto issue = [&](int tile, int st) {
    bf16* raw = raws + st * kW1Raw;
    bf16* gdst = gsm + st * kW1Gt;
    const int tx = tile % tiles_w;
    int rest = tile / tiles_w;
    const int ty = rest % tiles_h;
    rest /= tiles_h;
    const int tz = rest % tiles_d;
    const long long b = rest / tiles_d;
    const int od0 = tz * kW1Td, oh0 = ty * kW1Th, ow0 = tx * kW1Tw;
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + b * xbs;
    for (int u = tid; u < kW1R * kW1Nvec; u += kW1Threads) {
      const int v = u % kW1Nvec, r = u / kW1Nvec;
      const int p = od0 - qlo + r / (kW1Th + 2), ih = oh0 - 1 + r % (kW1Th + 2);
      const int c = ow0 - 8 + 8 * v;
      const bool row_ok = p >= 0 && p < nv && ih >= 0 && ih < H;
      const unsigned short* src = xb + (row_ok ? p * plane + static_cast<long long>(ih) * W : 0);
      bf16* dst = raw + (r * kW1Nvec + v) * 8;
      if (VEC) {
        const bool ok = row_ok && c >= 0 && c < W;  // W % 8 = 0: a vector is all in or out
        cp_async16(dst, ok ? src + c : reinterpret_cast<const unsigned short*>(x), ok ? 16 : 0);
      } else {
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
    const bf16* gb = g + (b * cout + co0) * ovol;
    for (int u = tid; u < kW1Co * kW1Td * kW1Th * (kW1Tw / 8); u += kW1Threads) {
      const int v = u % (kW1Tw / 8), rr = (u / (kW1Tw / 8)) % (kW1Td * kW1Th);
      const int co = u / (kW1Td * kW1Th * (kW1Tw / 8));
      const int od = od0 + rr / kW1Th, oh = oh0 + rr % kW1Th, ow = ow0 + 8 * v;
      bf16* dst = gdst + co * kW1Gld + rr * kW1Tw + 8 * v;
      const bool row_ok = co0 + co < cout && od < Do && oh < Ho;
      const long long off = co * ovol + od * plane + static_cast<long long>(oh) * Wo + ow;
      if (VEC) {
        const bool ok = row_ok && ow < Wo;  // Wo % 8 = 0
        cp_async16(dst, ok ? gb + off : g, ok ? 16 : 0);
      } else {
        const unsigned short* gs = reinterpret_cast<const unsigned short*>(gb) + off;
        uint32_t e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = row_ok && ow + 2 * i < Wo ? gs[2 * i] : 0;
          const uint32_t hi = row_ok && ow + 2 * i + 1 < Wo ? gs[2 * i + 1] : 0;
          e[i] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  };

  // raw rows → the three copies: unit (row r, 8-column chunk j) reads raw
  // vectors j, j + 1, j + 2 and writes chunk j of each copy (copy 0: raw
  // columns 8j + 7 …, copy 1: vector j + 1, copy 2: raw columns 8j + 9 …),
  // the prologue applied on the way (act(0) = 0 keeps the padding)
  auto shift = [&](const bf16* raw) {
    for (int u = tid; u < kW1R * (kW1Tw / 8); u += kW1Threads) {
      const int j = u % (kW1Tw / 8), r = u / (kW1Tw / 8);
      const uint4* src = reinterpret_cast<const uint4*>(raw + (r * kW1Nvec + j) * 8);
      const uint4 q0 = src[0], q1 = src[1], q2 = src[2];
      uint32_t v[6] = {q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
      if (act) {
#pragma unroll
        for (int i = 0; i < 6; ++i) v[i] = act_bf16x2(act, v[i]);
      }
      bf16* dst = xs + (r / (kW1Th + 2)) * kW1Plane + (r % (kW1Th + 2)) * kW1Row + 8 * j;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(__byte_perm(v[0], v[1], 0x5432), __byte_perm(v[1], v[2], 0x5432),
                     __byte_perm(v[2], v[3], 0x5432), __byte_perm(v[3], v[4], 0x5432));
      *reinterpret_cast<uint4*>(dst + kW1Copy) = make_uint4(v[1], v[2], v[3], v[4]);
      *reinterpret_cast<uint4*>(dst + 2 * kW1Copy) =
          make_uint4(__byte_perm(v[1], v[2], 0x5432), __byte_perm(v[2], v[3], 0x5432),
                     __byte_perm(v[3], v[4], 0x5432), __byte_perm(v[4], v[5], 0x5432));
    }
  };

  // This lane's rows of the two ldmatrix B loads of a K step (taps 0-15, then
  // 16-31): tap 16·p + (lane % 8) + 8·(lane / 16), columns + 8·((lane / 8) % 2)
  // of the warp's 16-voxel step (its copy's row, or a zero row).
  const int vz = warp >> 2, vy = (warp >> 1) & 1, c0 = (warp & 1) * 32;
  const int wofs = vz * kW1Plane + vy * kW1Row + c0 + 8 * ((lane >> 3) & 1);
  const bf16* lrow[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int tap = 16 * p + (lane & 7) + 8 * (lane >> 4);
    lrow[p] = tap < 27 ? xs + (tap % 3) * kW1Copy + (tap / 9) * kW1Plane + ((tap / 3) % 3) * kW1Row + wofs
                       : xs + kW1Zero + 8 * (tap - 27) + wofs % 64;
  }

  float acc[2][4][4];  // [16-row co tile][8-tap column tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  float* pb = partial + static_cast<long long>(split) * cout * 27;
  if (split >= n_tiles) {  // an empty split writes zeros
    for (int u = tid; u < kW1Co * 27; u += kW1Threads)
      if (co0 + u / 27 < cout) pb[(co0 + u / 27) * 27 + u % 27] = 0.f;
    return;
  }
  issue(split, 0);
  cp_async_commit();
  if (split + splits < n_tiles) issue(split + splits, 1);
  cp_async_commit();
  int st = 0, done = 0;
  for (int tile = split; tile < n_tiles; tile += splits) {
    cp_async_wait<kW1Stages - 2>();
    __syncthreads();  // this tile's raw rows and g landed; the copies are no longer read
    shift(raws + st * kW1Raw);
    __syncthreads();  // the copies are ready; the previous tile's stage is free
    const int ahead = tile + (kW1Stages - 1) * splits;
    if (ahead < n_tiles) issue(ahead, (st + kW1Stages - 1) % kW1Stages);
    cp_async_commit();
    const bf16* gt = gsm + st * kW1Gt;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k0 = (2 * warp + kk) * 16;  // the step's voxels in the g tile
      uint32_t a[2][4], bfr[2][4];
      load_a(a[0], gt, kW1Gld, 0, k0, lane);
      load_a(a[1], gt, kW1Gld, 16, k0, lane);
      ldsm_x4(bfr[0], lrow[0] + 16 * kk);
      ldsm_x4(bfr[1], lrow[1] + 16 * kk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma16816(acc[mt][2 * p], a[mt], bfr[p][0], bfr[p][1]);
          mma16816(acc[mt][2 * p + 1], a[mt], bfr[p][2], bfr[p][3]);
        }
    }
    st = (st + 1) % kW1Stages;
    ++done;
    if (done % kW1Flush == 0 || tile + splits >= n_tiles) {
      // the warps in order into red[co][tap], then red into the partial
      for (int wi = 0; wi < kW1Warps; ++wi) {
        if (warp == wi) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                const int co = mt * 16 + (lane >> 2) + (f >> 1) * 8;
                const int tap = nt * 8 + (lane & 3) * 2 + (f & 1);
                red[co * 32 + tap] = (wi == 0 ? 0.f : red[co * 32 + tap]) + acc[mt][nt][f];
                acc[mt][nt][f] = 0.f;
              }
        }
        __syncthreads();
      }
      for (int u = tid; u < kW1Co * 27; u += kW1Threads) {
        const int co = u / 27, tap = u % 27;
        if (co0 + co < cout) {
          float* dst = pb + (co0 + co) * 27 + tap;
          *dst = (done <= kW1Flush ? 0.f : *dst) + red[co * 32 + tap];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------- G/K at stride 2 with one input channel on the tensor cores ---
//
// Tiles for 32³ outputs (the 1→64 stem of stage 1 at 64³): 2 planes × 4 rows
// × 32 columns, one output row of 32 voxels (two K steps of 16) a warp, so
// Wo = 32 is one tile wide (the stride-1 instance's 64-column tile would be
// half empty) and a 32³ output is 16 × 8 tiles a batch element.
constexpr int kW2Td = 2, kW2Th = 4, kW2Tw = 32;     // output voxels per tile: 256, 16 K steps of 16
constexpr int kW2Nv = kW2Td * kW2Th * kW2Tw;
constexpr int kW2Pd = 2 * kW2Td + 1, kW2Ph = 2 * kW2Th + 1;  // staged planes and rows: 5 and 9
constexpr int kW2R = kW2Pd * kW2Ph;                 // raw input rows a tile reads: 45
constexpr int kW2Nvec = 2 * kW2Tw / 8 + 1;          // 8-column vectors of a raw row, from 2·ow0 − 8
// Copy dx holds one column parity of the tile's input patch, as
// conv_c1in_s2_tc_kernel's copies do: copy 1 the even columns, 2·(ow0 + c)
// (tap dx = 1), copy 2 the odd ones, 2·(ow0 + c) + 1 (dx = 2), copy 0 the
// odd ones shifted by one, 2·(ow0 + c) − 1 (dx = 0); plane pd, row ph of a
// copy hold act(x) at view plane 2·od0 − qlo + pd, row 2·oh0 − 1 + ph. The
// pitches — rows 80 ≡ 16·5, planes 752 ≡ 16·7, copies 3,824 ≡ 16·7 bytes
// (mod 128) — start tap t = (dz, dy, dx) 16·(7t mod 8) bytes (mod 128) after
// tap 0, so the 8 taps of one ldmatrix phase hit 8 different bank groups.
constexpr int kW2Row = 40;                          // bf16 per row: 32 columns + pad
constexpr int kW2Plane = 376;                       // bf16 per plane: 9 rows + pad
constexpr int kW2Copy = 1912;                       // bf16 per copy: 5 planes + pad
constexpr int kW2Zero = 5760;                       // the zero rows of taps 27-31: the first
                                                    // multiple of 64 bf16 (128 bytes) past the copies
constexpr int kW2ZeroLen = 128;                     // bf16: room for every offset a row takes
constexpr int kW2Stages = 3;                        // tiles staged at once: two in flight
constexpr int kW2Gld = kW2Nv + 8;                   // bf16 per channel of the g tile: 528 bytes
constexpr int kW2Gt = kW1Co * kW2Gld;               // bf16, one stage's g tile, [co][voxel]
constexpr int kW2Raw = kW2R * kW2Nvec * 8;          // bf16, one stage's raw rows, [row][vector][8]
constexpr int kW2Smem =                             // 86,000 bytes: two blocks an SM
    (kW2Stages * (kW2Gt + kW2Raw) + kW2Zero + kW2ZeroLen) * 2 + kW1Co * 32 * 4;
// Tiles between two flushes: 16,384 voxels a warp, as the stride-1 instance.
constexpr int kW2Flush = 16384 / (kW2Nv / kW1Warps);
static_assert(kW2Row >= kW2Tw && kW2Plane >= kW2Ph * kW2Row && kW2Copy >= kW2Pd * kW2Plane &&
                  kW2Zero >= 3 * kW2Copy && kW2Zero % 64 == 0 && kW2Td * kW2Th == kW1Warps,
              "the copies' pitches; one output row a warp");

// dW[co, 0, tap] = Σ_{b, voxel} g[b, co, voxel] · act(slab)[2·voxel + tap −
// (0, 1, 1)], the stride-2 weight gradient with one input channel — stage
// 1's 1→64 stem, _wgrad_s2 at Cin = 1 — as wgrad_c1in_tc_kernel computes the
// stride-1 one: the GEMM dW[co, tap] = Σ_voxel g[co, voxel] · x_tap[voxel]
// with M = Cout (32 a block, two 16-row tiles), N = the 27 taps padded to 32,
// K = output voxels, on mma.sync m16n8k16 bf16 → fp32. What bounds it is
// reading g, 64 times the bytes of the strided x. g, the A operand, is
// staged by 16-byte cp.async as it lies ([co][voxel]) in a ring of three
// stages, the next two tiles' copies under the current tile's products. The
// alignment trap at stride 2: output column ow reads input columns 2·ow − 1,
// 2·ow and 2·ow + 1, so a B row (one tap, 8 neighbouring voxels) is every
// other input column. Way out: x's raw rows arrive by cp.async as they lie
// (8-column vectors from column 2·ow0 − 8) and a pass sorts them by column
// parity into three copies (byte permutes in registers, the act prologue in
// fp32 rounded to bf16 on the way), so every tap of 8 voxels is an aligned
// row and ldmatrix gives the B fragments of two taps' n8 tiles in one x4
// load; taps 27-31 read zero rows. Warp w takes output plane w / 4, row w %
// 4 of the tile, K steps 2w and 2w + 1, all 32 × 32 (co, tap) in 32 fp32
// accumulators a thread. A block walks its split's tiles (every splits-th
// one). Every kW2Flush tiles and after the last, the warps add their
// accumulators in warp order into a shared 32 × 27 sum (round-to-nearest
// fp32 adds), which goes into the split's partial (the first flush stores,
// the later ones add; one writer an element): deterministic, bitwise
// repeatable. Block b of the 1-D grid: Cout tile b % n_co, split b / n_co.
// VEC: x's rows and batch stride and g's rows are 16-byte aligned (W a
// multiple of 16, so Wo a multiple of 8), so the copies go by cp.async;
// otherwise element by element.
template <bool VEC>
__global__ void __launch_bounds__(kW1Threads, 2)
wgrad_c1in_s2_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        float* __restrict__ partial, int cout, int nv, int qlo, long long xbs,
                        int act, int H, int W, int Do, int n_co, int n_tiles, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gsm = reinterpret_cast<bf16*>(smem_raw);  // the stages' g tiles
  bf16* raws = gsm + kW2Stages * kW2Gt;            // the stages' raw rows
  bf16* xs = raws + kW2Stages * kW2Raw;            // 3 copies, then the zero rows
  float* red = reinterpret_cast<float*>(xs + kW2Zero + kW2ZeroLen);  // [co][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = static_cast<int>(blockIdx.x % n_co) * kW1Co;
  const int split = static_cast<int>(blockIdx.x / n_co);
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tiles_w = (Wo + kW2Tw - 1) / kW2Tw;
  const int tiles_h = (Ho + kW2Th - 1) / kW2Th;
  const int tiles_d = (Do + kW2Td - 1) / kW2Td;
  const long long plane = static_cast<long long>(H) * W;
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;

  if (tid < kW2ZeroLen / 8)
    reinterpret_cast<uint4*>(xs + kW2Zero)[tid] = make_uint4(0u, 0u, 0u, 0u);

  // Stage tile `tile` into stage `st`: the raw input rows (zero outside the
  // view's planes and the image) and the g tile (zero outside the output and
  // Cout).
  auto issue = [&](int tile, int st) {
    bf16* raw = raws + st * kW2Raw;
    bf16* gdst = gsm + st * kW2Gt;
    const int tx = tile % tiles_w;
    int rest = tile / tiles_w;
    const int ty = rest % tiles_h;
    rest /= tiles_h;
    const int tz = rest % tiles_d;
    const long long b = rest / tiles_d;
    const int od0 = tz * kW2Td, oh0 = ty * kW2Th, ow0 = tx * kW2Tw;
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + b * xbs;
    for (int u = tid; u < kW2R * kW2Nvec; u += kW1Threads) {
      const int v = u % kW2Nvec, r = u / kW2Nvec;
      const int p = 2 * od0 - qlo + r / kW2Ph, ih = 2 * oh0 - 1 + r % kW2Ph;
      const int c = 2 * ow0 - 8 + 8 * v;
      const bool row_ok = p >= 0 && p < nv && ih >= 0 && ih < H;
      const unsigned short* src = xb + (row_ok ? p * plane + static_cast<long long>(ih) * W : 0);
      bf16* dst = raw + (r * kW2Nvec + v) * 8;
      if (VEC) {
        const bool ok = row_ok && c >= 0 && c < W;  // W % 8 = 0: a vector is all in or out
        cp_async16(dst, ok ? src + c : reinterpret_cast<const unsigned short*>(x), ok ? 16 : 0);
      } else {
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
    const bf16* gb = g + (b * cout + co0) * ovol;
    for (int u = tid; u < kW1Co * kW2Td * kW2Th * (kW2Tw / 8); u += kW1Threads) {
      const int v = u % (kW2Tw / 8), rr = (u / (kW2Tw / 8)) % (kW2Td * kW2Th);
      const int co = u / (kW2Td * kW2Th * (kW2Tw / 8));
      const int od = od0 + rr / kW2Th, oh = oh0 + rr % kW2Th, ow = ow0 + 8 * v;
      bf16* dst = gdst + co * kW2Gld + rr * kW2Tw + 8 * v;
      const bool row_ok = co0 + co < cout && od < Do && oh < Ho;
      const long long off = co * ovol + od * oplane + static_cast<long long>(oh) * Wo + ow;
      if (VEC) {
        const bool ok = row_ok && ow < Wo;  // Wo % 8 = 0
        cp_async16(dst, ok ? gb + off : g, ok ? 16 : 0);
      } else {
        const unsigned short* gs = reinterpret_cast<const unsigned short*>(gb) + off;
        uint32_t e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = row_ok && ow + 2 * i < Wo ? gs[2 * i] : 0;
          const uint32_t hi = row_ok && ow + 2 * i + 1 < Wo ? gs[2 * i + 1] : 0;
          e[i] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  };

  // raw rows → the three copies: unit (row r, chunk j of 8 output columns)
  // reads raw vectors 2j, 2j + 1, 2j + 2 (input columns 2·ow0 + 16j − 8 …)
  // and writes chunk j of each copy — copy 0 the high halves from the last
  // word of vector 2j on, copy 1 the low halves of vectors 2j + 1 and 2j + 2,
  // copy 2 their high halves — the prologue applied on the way (act(0) = 0
  // keeps the padding)
  auto shift = [&](const bf16* raw) {
    for (int u = tid; u < kW2R * (kW2Tw / 8); u += kW1Threads) {
      const int j = u % (kW2Tw / 8), r = u / (kW2Tw / 8);
      const uint4* src = reinterpret_cast<const uint4*>(raw + (r * kW2Nvec + 2 * j) * 8);
      const uint4 q0 = src[0], q1 = src[1], q2 = src[2];
      uint32_t v[3][4] = {{q0.x, q0.y, q0.z, q0.w}, {q1.x, q1.y, q1.z, q1.w},
                          {q2.x, q2.y, q2.z, q2.w}};
      if (act) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[k][i] = act_bf16x2(act, v[k][i]);
      }
      bf16* dst = xs + (r / kW2Ph) * kW2Plane + (r % kW2Ph) * kW2Row + 8 * j;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(__byte_perm(v[0][3], v[1][0], 0x7632), __byte_perm(v[1][1], v[1][2], 0x7632),
                     __byte_perm(v[1][3], v[2][0], 0x7632), __byte_perm(v[2][1], v[2][2], 0x7632));
      *reinterpret_cast<uint4*>(dst + kW2Copy) =
          make_uint4(__byte_perm(v[1][0], v[1][1], 0x5410), __byte_perm(v[1][2], v[1][3], 0x5410),
                     __byte_perm(v[2][0], v[2][1], 0x5410), __byte_perm(v[2][2], v[2][3], 0x5410));
      *reinterpret_cast<uint4*>(dst + 2 * kW2Copy) =
          make_uint4(__byte_perm(v[1][0], v[1][1], 0x7632), __byte_perm(v[1][2], v[1][3], 0x7632),
                     __byte_perm(v[2][0], v[2][1], 0x7632), __byte_perm(v[2][2], v[2][3], 0x7632));
    }
  };

  // This lane's rows of the two ldmatrix B loads of a K step (taps 0-15, then
  // 16-31): tap 16·p + (lane % 8) + 8·(lane / 16), columns + 8·((lane / 8) % 2)
  // of the warp's 16-voxel step: plane 2·pz + dz, row 2·py + dy of copy dx
  // (or a zero row in the same bank group, 16·(7t mod 8) bytes past tap 0's)
  const int pz = warp / kW2Th, py = warp % kW2Th;
  const int wofs = 2 * pz * kW2Plane + 2 * py * kW2Row + 8 * ((lane >> 3) & 1);
  const bf16* lrow[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = 16 * p + (lane & 7) + 8 * (lane >> 4);  // the lane's tap
    lrow[p] = t < 27 ? xs + (t % 3) * kW2Copy + (t / 9) * kW2Plane + ((t / 3) % 3) * kW2Row + wofs
                     : xs + kW2Zero + (8 * ((7 * t) & 7) + wofs) % 64;
  }

  float acc[2][4][4];  // [16-row co tile][8-tap column tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  float* pb = partial + static_cast<long long>(split) * cout * 27;
  if (split >= n_tiles) {  // an empty split writes zeros
    for (int u = tid; u < kW1Co * 27; u += kW1Threads)
      if (co0 + u / 27 < cout) pb[(co0 + u / 27) * 27 + u % 27] = 0.f;
    return;
  }
  issue(split, 0);
  cp_async_commit();
  if (split + splits < n_tiles) issue(split + splits, 1);
  cp_async_commit();
  int st = 0, done = 0;
  for (int tile = split; tile < n_tiles; tile += splits) {
    cp_async_wait<kW2Stages - 2>();
    __syncthreads();  // this tile's raw rows and g landed; the copies are no longer read
    shift(raws + st * kW2Raw);
    __syncthreads();  // the copies are ready; the previous tile's stage is free
    const int ahead = tile + (kW2Stages - 1) * splits;
    if (ahead < n_tiles) issue(ahead, (st + kW2Stages - 1) % kW2Stages);
    cp_async_commit();
    const bf16* gt = gsm + st * kW2Gt;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = warp * kW2Tw + 16 * ks;  // the step's voxels in the g tile
      uint32_t a[2][4], bfr[2][4];
      load_a(a[0], gt, kW2Gld, 0, k0, lane);
      load_a(a[1], gt, kW2Gld, 16, k0, lane);
      ldsm_x4(bfr[0], lrow[0] + 16 * ks);
      ldsm_x4(bfr[1], lrow[1] + 16 * ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma16816(acc[mt][2 * p], a[mt], bfr[p][0], bfr[p][1]);
          mma16816(acc[mt][2 * p + 1], a[mt], bfr[p][2], bfr[p][3]);
        }
    }
    st = (st + 1) % kW2Stages;
    ++done;
    if (done % kW2Flush == 0 || tile + splits >= n_tiles) {
      // the warps in order into red[co][tap], then red into the partial
      for (int wi = 0; wi < kW1Warps; ++wi) {
        if (warp == wi) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                const int r = (mt * 16 + (lane >> 2) + (f >> 1) * 8) * 32 +  // [co][tap]
                              nt * 8 + (lane & 3) * 2 + (f & 1);
                red[r] = (wi == 0 ? 0.f : red[r]) + acc[mt][nt][f];
                acc[mt][nt][f] = 0.f;
              }
        }
        __syncthreads();
      }
      for (int u = tid; u < kW1Co * 27; u += kW1Threads) {
        const int co = u / 27, tap = u % 27;
        if (co0 + co < cout) {
          float* dst = pb + (co0 + co) * 27 + tap;
          *dst = (done <= kW2Flush ? 0.f : *dst) + red[co * 32 + tap];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// out[i] = Σ_s partial[s][i] in a fixed order, for many splits of a small
// dW: warp y of a block adds the splits y, y + 8, … of 32 neighbouring
// elements, then the 8 warps' sums are added in warp order.
__global__ void __launch_bounds__(256)
sum_split_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int n,
                          int splits) {
  __shared__ float part[8][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int k = threadIdx.y; k < splits; k += 8) s += partial[static_cast<long long>(k) * n + i];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += part[y][threadIdx.x];
    out[i] = t;
  }
}

template <typename T, int S, int CI_C>
int launch_wgrad(const void* x, const void* g, void* partial, void* out, long long batch,
                 int cin, int cout, int nv, int qlo, long long xb, long long xc, int act, int H,
                 int W, int Do, int splits, cudaStream_t stream) {
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  const long long n_tiles = batch * Do * static_cast<long long>((Ho + kWgTh - 1) / kWgTh) *
                            ((Wo + kWgTw - 1) / kWgTw);
  const int n_co = (cout + kWgCo - 1) / kWgCo;
  const int n_ci = (cin + CI_C - 1) / CI_C;
  if (splits < 1 || splits > n_tiles || n_co > 65535 || n_ci > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per = (n_tiles + splits - 1) / splits;
  wgrad_kernel<T, S, CI_C><<<dim3(splits, n_co, n_ci), kWgThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(partial), cin,
      cout, nv, qlo, xb, xc, act, H, W, Do, Ho, Wo, n_tiles, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(cout) * cin * 27;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool VEC>
int launch_wgrad_tc(const void* x, const void* g, void* partial, void* out, long long batch,
                    int cin, int cout, int nv, int qlo, long long xb, long long xc, int act, int H,
                    int W, int Do, int splits, cudaStream_t stream) {
  using TS = TcShape<S>;
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  const long long n_tiles = batch * static_cast<long long>((Do + TS::TD - 1) / TS::TD) *
                            ((Ho + TS::TH - 1) / TS::TH) * ((Wo + TS::TW - 1) / TS::TW);
  const int n_co = (cout + kTcCo - 1) / kTcCo;
  const int n_ci = (cin + kTcCi - 1) / kTcCi;
  if (splits < 1 || splits > n_tiles || n_tiles > 2147483647LL ||
      static_cast<long long>(splits) * n_co * n_ci > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wgrad_tc_kernel<S, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TS::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(splits * n_co * n_ci), kTcThreads, TS::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(partial),
      cin, cout, nv, qlo, xb, xc, act, H, W, Do, Ho, Wo, n_ci, n_co, static_cast<int>(n_tiles),
      splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(cout) * cin * 27;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgrad_c1in_tc(const void* x, const void* g, void* partial, void* out, long long batch,
                         int cout, int nv, int qlo, long long xb, int act, int H, int W, int Do,
                         int splits, cudaStream_t stream) {
  const long long n_tiles = batch * static_cast<long long>((Do + kW1Td - 1) / kW1Td) *
                            ((H + kW1Th - 1) / kW1Th) * ((W + kW1Tw - 1) / kW1Tw);
  const int n_co = (cout + kW1Co - 1) / kW1Co;
  if (splits < 1 || splits > n_tiles || n_tiles > 2147483647LL ||
      static_cast<long long>(splits) * n_co > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 && W % 8 == 0 && xb % 8 == 0;
  auto kern = vec ? wgrad_c1in_tc_kernel<true> : wgrad_c1in_tc_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kW1Smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(splits * n_co), kW1Threads, kW1Smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(partial),
      cout, nv, qlo, xb, act, H, W, Do, n_co, static_cast<int>(n_tiles), splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = cout * 27;
  sum_split_partials_kernel<<<static_cast<unsigned>((n + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgrad_c1in_s2_tc(const void* x, const void* g, void* partial, void* out,
                            long long batch, int cout, int nv, int qlo, long long xb, int act,
                            int H, int W, int Do, int splits, cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long n_tiles = batch * static_cast<long long>((Do + kW2Td - 1) / kW2Td) *
                            ((Ho + kW2Th - 1) / kW2Th) * ((Wo + kW2Tw - 1) / kW2Tw);
  const int n_co = (cout + kW1Co - 1) / kW1Co;
  if (splits < 1 || splits > n_tiles || n_tiles > 2147483647LL ||
      static_cast<long long>(splits) * n_co > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 && W % 16 == 0 && xb % 8 == 0;
  auto kern = vec ? wgrad_c1in_s2_tc_kernel<true> : wgrad_c1in_s2_tc_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kW2Smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(splits * n_co), kW1Threads, kW2Smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(partial),
      cout, nv, qlo, xb, act, H, W, Do, n_co, static_cast<int>(n_tiles), splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = cout * 27;
  sum_split_partials_kernel<<<static_cast<unsigned>((n + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// The instance a call takes, an explicit rule (no fallback): 1, bf16 with
// Cin ≥ 8 → the tensor cores (wgrad_tc_kernel); 2, bf16 at stride 1 with
// Cin = 1 (the stage-3 chains' 1→32 and 1→64 convs, bound by reading g) → the
// one-input-channel tensor-core instance (wgrad_c1in_tc_kernel; Cin 2-7 would
// need another layout of its copies); 3, bf16 at stride 2 with Cin = 1 (stage
// 1's 1→64 stem, bound by reading g) → its stride-2 form
// (wgrad_c1in_s2_tc_kernel); 0, fp32 (tensor cores would mean TF32, outside
// the fp32 tolerances) and Cin 2-7 → the CUDA-core wgrad_kernel. The wrapper
// reads it through hvc_conv3d_k3_wgrad_tc to count launches and size the
// split (ops/cuda/conv3d_k3.py: wgrad_instance states it for the CPU).
int wgrad_instance(int stride, bool bf16, int cin) {
  if (!bf16) return 0;
  if (cin >= 8) return 1;
  if (cin != 1) return 0;
  return stride == 1 ? 2 : 3;
}

template <int S>
int dispatch_wgrad(const void* x, const void* g, void* partial, void* out, long long batch,
                   int cin, int cout, int nv, int qlo, long long xb, long long xc, int act,
                   int H, int W, int Do, int dtype, int splits, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || nv < 0 || H <= 0 || W <= 0 || Do <= 0 ||
      act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int instance = wgrad_instance(S, dtype == 1, cin);
  if (instance == 2)
    return launch_wgrad_c1in_tc(x, g, partial, out, batch, cout, nv, qlo, xb, act, H, W, Do,
                                splits, s);
  if (instance == 3)
    return launch_wgrad_c1in_s2_tc(x, g, partial, out, batch, cout, nv, qlo, xb, act, H, W, Do,
                                   splits, s);
  if (instance == 1) {
    const int Wo = (W - 1) / S + 1;
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0 && W % 8 == 0 && Wo % 8 == 0 &&
                     xb % 8 == 0 && xc % 8 == 0;
    return vec ? launch_wgrad_tc<S, true>(x, g, partial, out, batch, cin, cout, nv, qlo, xb, xc,
                                          act, H, W, Do, splits, s)
               : launch_wgrad_tc<S, false>(x, g, partial, out, batch, cin, cout, nv, qlo, xb, xc,
                                           act, H, W, Do, splits, s);
  }
  const bool small = cin < 4;
#define LAUNCH_WGRAD(T, C) \
  launch_wgrad<T, S, C>(x, g, partial, out, batch, cin, cout, nv, qlo, xb, xc, act, H, W, Do, splits, s)
  if (dtype == 0) return small ? LAUNCH_WGRAD(float, 1) : LAUNCH_WGRAD(float, 4);
  if (dtype == 1) return small ? LAUNCH_WGRAD(__nv_bfloat16, 1) : LAUNCH_WGRAD(__nv_bfloat16, 4);
#undef LAUNCH_WGRAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------- F ---

constexpr int kDgTh = 8;        // input-voxel tile rows
constexpr int kDgTw = 32;       // input-voxel tile columns (one warp per row)
constexpr int kDgCi = 32;       // dx channels per block, in registers
constexpr int kDgCoC = 8;       // output-gradient channels per shared-memory chunk
constexpr int kDgWRow = 36;     // padded [co][tap] row of 32 ci weights
constexpr int kDgGh = kDgTh / 2 + 1;
constexpr int kDgGw = kDgTw / 2 + 1;
constexpr int kDgGPatch = 2 * kDgGh * kDgGw;

template <typename T, bool DACT>
__global__ void __launch_bounds__(kDgTh * kDgTw)
dgrad_s2_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx, int cin,
                int cout, int nv, int qlo, int H, int W, int Do, int Ho, int Wo, int n_ci_groups,
                int dact, const T* __restrict__ dact_x, long long db, long long dc) {
  constexpr int NT = kDgTh * kDgTw;
  __shared__ float gsm[kDgCoC * kDgGPatch];
  __shared__ __align__(16) float wsm[kDgCoC * 27 * kDgWRow];

  const int tiles_w = (W + kDgTw - 1) / kDgTw;
  const int tile_h = blockIdx.x / tiles_w;
  const int tile_w = blockIdx.x % tiles_w;
  const int pv = blockIdx.y;         // dx plane (of the view)
  const int iz = pv + qlo - 1;       // its input plane in padding-1 terms: S·o + d − 1 = iz
  const long long b = blockIdx.z / n_ci_groups;
  const int ci0 = (blockIdx.z % n_ci_groups) * kDgCi;
  const int ty = threadIdx.x / kDgTw;
  const int tx = threadIdx.x % kDgTw;
  const int iy0 = tile_h * kDgTh;
  const int ix0 = tile_w * kDgTw;
  const int iy = iy0 + ty;
  const int ix = ix0 + tx;
  // Output coordinates that can reach this tile: oz ∈ {iz/2, iz/2 + 1},
  // oy ∈ [iy0/2, iy0/2 + kDgTh/2], ox ∈ [ix0/2, ix0/2 + kDgTw/2].
  const int oz0 = iz >> 1;  // floor, iz may be −1
  const int oy0 = iy0 >> 1;
  const int ox0 = ix0 >> 1;

  // Taps by parity: i = 2·o + d − 1. Even i: d = 1, o = i/2. Odd i: d = 0,
  // o = (i+1)/2 and d = 2, o = (i−1)/2. Offsets are relative to oz0/oy0/ox0.
  int nz, zd[2], zp[2];
  if ((iz & 1) == 0) { nz = 1; zd[0] = 1; zp[0] = 0; zd[1] = 0; zp[1] = 0; }
  else { nz = 2; zd[0] = 0; zp[0] = 1; zd[1] = 2; zp[1] = 0; }
  int ny, yd[2], yp[2];
  if ((ty & 1) == 0) { ny = 1; yd[0] = 1; yp[0] = ty / 2; yd[1] = 0; yp[1] = 0; }
  else { ny = 2; yd[0] = 0; yp[0] = (ty + 1) / 2; yd[1] = 2; yp[1] = (ty - 1) / 2; }
  int nx, xd[2], xp[2];
  if ((tx & 1) == 0) { nx = 1; xd[0] = 1; xp[0] = tx / 2; xd[1] = 0; xp[1] = 0; }
  else { nx = 2; xd[0] = 0; xp[0] = (tx + 1) / 2; xd[1] = 2; xp[1] = (tx - 1) / 2; }

  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const T* gb = g + b * cout * ovol;

  float acc[kDgCi];
#pragma unroll
  for (int c = 0; c < kDgCi; ++c) acc[c] = 0.f;

  for (int co0 = 0; co0 < cout; co0 += kDgCoC) {
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < kDgCoC * kDgGPatch; i += NT) {
      const int cl = i / kDgGPatch;
      const int r = i - cl * kDgGPatch;
      const int pz = r / (kDgGh * kDgGw);
      const int r2 = r - pz * (kDgGh * kDgGw);
      const int py = r2 / kDgGw;
      const int px = r2 - py * kDgGw;
      const int co = co0 + cl;
      const int oz = oz0 + pz;
      const int oy = oy0 + py;
      const int ox = ox0 + px;
      float val = 0.f;
      if (co < cout && oz >= 0 && oz < Do && oy < Ho && ox < Wo)
        val = to_f32(gb[co * ovol + oz * oplane + static_cast<long long>(oy) * Wo + ox]);
      gsm[i] = val;
    }
    for (int i = threadIdx.x; i < kDgCoC * 27 * kDgCi; i += NT) {
      const int cil = i % kDgCi;
      const int t = i / kDgCi;
      const int tap = t % 27;
      const int col = t / 27;
      const int co = co0 + col;
      const int ci = ci0 + cil;
      wsm[t * kDgWRow + cil] = (co < cout && ci < cin)
                                   ? to_f32(w[(static_cast<long long>(co) * cin + ci) * 27 + tap])
                                   : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int cl = 0; cl < kDgCoC; ++cl) {
      const float* gp = gsm + cl * kDgGPatch;
      const float* wp = wsm + cl * 27 * kDgWRow;
      // constant trip counts with early exits keep the tap tables in registers
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a >= nz) break;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (c >= ny) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e >= nx) break;
            const float gv = gp[(zp[a] * kDgGh + yp[c]) * kDgGw + xp[e]];
            const float4* wr =
                reinterpret_cast<const float4*>(wp + (zd[a] * 9 + yd[c] * 3 + xd[e]) * kDgWRow);
#pragma unroll
            for (int c4 = 0; c4 < kDgCi / 4; ++c4) {
              const float4 ww = wr[c4];
              acc[4 * c4 + 0] = fmaf(gv, ww.x, acc[4 * c4 + 0]);
              acc[4 * c4 + 1] = fmaf(gv, ww.y, acc[4 * c4 + 1]);
              acc[4 * c4 + 2] = fmaf(gv, ww.z, acc[4 * c4 + 2]);
              acc[4 * c4 + 3] = fmaf(gv, ww.w, acc[4 * c4 + 3]);
            }
          }
        }
      }
    }
  }

  if (iy < H && ix < W) {
    const long long plane = static_cast<long long>(H) * W;
    const long long vol = static_cast<long long>(nv) * plane;
    const long long pix = pv * plane + static_cast<long long>(iy) * W + ix;
    T* ob = dx + (b * cin + ci0) * vol + pix;
#pragma unroll
    for (int c = 0; c < kDgCi; ++c) {
      if (ci0 + c >= cin) continue;
      float a = acc[c];
      if constexpr (DACT) a *= dact_f32(dact, to_f32(dact_x[b * db + (ci0 + c) * dc + pix]));
      ob[c * vol] = from_f32<T>(a);
    }
  }
}

template <typename T, bool DACT>
int launch_dgrad_s2(const void* g, const void* w, void* dx, long long batch, int cin, int cout,
                    int nv, int qlo, int H, int W, int Do, int dact, const void* dact_x,
                    long long db, long long dc, cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const int n_ci = (cin + kDgCi - 1) / kDgCi;
  const long long tiles = static_cast<long long>((H + kDgTh - 1) / kDgTh) * ((W + kDgTw - 1) / kDgTw);
  if (tiles > 2147483647LL || nv > 65535 || batch * n_ci > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(nv),
                  static_cast<unsigned>(batch * n_ci));
  dgrad_s2_kernel<T, DACT><<<grid, kDgTh * kDgTw, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx), cin, cout, nv,
      qlo, H, W, Do, Ho, Wo, n_ci, dact, static_cast<const T*>(dact_x), db, dc);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------- F and J on the tensor cores ---

constexpr int kDtThreads = 256;              // 8 warps
constexpr int kDtCi = 32;                    // dx channels per block: M, two 16-row tiles
constexpr int kDtCo = 16;                    // g channels per chunk: one k16 step a tap
constexpr int kDtTy = 8, kDtTx = 32;         // dx rows and columns per block, in 2 planes
constexpr int kDtGh = kDtTy / 2 + 1;         // g rows the block reads: 5
constexpr int kDtGw = kDtTx / 2 + 1;         // g columns: 17
constexpr int kDtGvec = 3;                   // 8-column vectors of a g row, from ox0
constexpr int kDtRaw = 2 * kDtGh * kDtGvec;  // vectors of a channel's raw g rows: 30
constexpr int kDtWts = 27 * kDtCi * kDtCo;   // bf16, a chunk's weights [tap][ci][co]
constexpr int kDtGraw = kDtCo * kDtRaw * 8;  // bf16, its raw g rows [co][row][vector]
constexpr int kDtGp = 2 * kDtGh * kDtGw * kDtCo;  // bf16, its g patch [position][co]
constexpr int kDtVox = 2 * kDtTy * kDtTx;    // dx voxels of a block: 512
constexpr int kDtEld = kDtVox + 8;           // fp32 per channel of the epilogue tile
// 76,096 bytes: two chunks' weights and raw g rows and the patch; after the
// last chunk the epilogue tile (66,560 bytes) takes their place
constexpr int kDtSmem = (2 * (kDtWts + kDtGraw) + kDtGp) * 2;
static_assert(kDtCi * kDtEld * 4 <= kDtSmem, "the epilogue tile must fit the staging");

// The products of parity class C = 4·pz + 2·py + px for this warp's row uy
// of the class, columns 0-15: acc[mt][nt] += W_tap[16·mt …][co] · g_tap[co][8·nt …]
// over the class's taps. Along a dimension a voxel at even index 2u (the
// block's first plane, row and column are even) takes tap d = 1 from g index
// u; one at odd index 2u + 1 takes d = 0 from u + 1 and d = 2 from u.
template <int C>
__device__ __forceinline__ void dgrad_tc_class(float (&acc)[2][2][4], const bf16* wts,
                                               const bf16* gp, int uy, int lane) {
  constexpr int pz = C >> 2, py = (C >> 1) & 1, px = C & 1;
  const int ln = (lane & 7) + ((lane >> 4) << 3), lk = (lane >> 3) & 1;  // B rows: voxel, k unit
  const int arow = lane & 15, au = lane >> 4;                           // A rows: channel, k unit
#pragma unroll
  for (int a = 0; a <= pz; ++a)
#pragma unroll
    for (int c = 0; c <= py; ++c)
#pragma unroll
      for (int e = 0; e <= px; ++e) {
        const int dz = pz ? 2 * a : 1, dy = py ? 2 * c : 1, dx = px ? 2 * e : 1;
        const int tap = dz * 9 + dy * 3 + dx;
        // g plane, row and column offsets of the tap: 1 where d = 0
        const int pos = ((dz == 0) * kDtGh + uy + (dy == 0)) * kDtGw + (dx == 0) + ln;
        uint32_t a0[4], a1[4], b[4];
        ldsm_x4(a0, wts + s2_swz(tap * kDtCi + arow, au));
        ldsm_x4(a1, wts + s2_swz(tap * kDtCi + 16 + arow, au));
        ldsm_x4(b, gp + s2_swz(pos, lk));
        mma16816(acc[0][0], a0, b[0], b[1]);
        mma16816(acc[0][1], a0, b[2], b[3]);
        mma16816(acc[1][0], a1, b[0], b[1]);
        mma16816(acc[1][1], a1, b[2], b[3]);
      }
}

// Class C's accumulators into the epilogue tile [ci][z][y][x] (fp32):
// acc[mt][nt][e] is channel 16·mt + lane / 4 + 8·(e / 2) at class column
// 8·nt + 2·(lane % 4) + e % 2, i.e. dx column 2·that + px, row 2·uy + py,
// plane pz.
template <int C>
__device__ __forceinline__ void dgrad_tc_put(const float (&acc)[2][2][4], float* eb, int uy,
                                             int lane) {
  constexpr int pz = C >> 2, py = (C >> 1) & 1, px = C & 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int x = 2 * (8 * nt + 2 * (lane & 3) + (e & 1)) + px;
        eb[ci * kDtEld + (pz * kDtTy + 2 * uy + py) * kDtTx + x] = acc[mt][nt][e];
      }
}

// Block b of the 1-D grid: Cin tile b % n_ci (fastest: the tiles that read
// the same g patch run together), then dx column tile, row tile, plane pair,
// batch. The block's planes are iz0 and iz0 + 1 in padding-1 terms (iz = view
// plane + qlo − 1), iz0 even, so g planes oz0 = iz0 / 2 and oz0 + 1 reach
// them; view planes outside [0, nv) are not written. wtc: the weights as
// [Cin tile][Cout chunk][tap][32 ci][16 co], zero-padded
// (ops/cuda/conv3d_k3.py: s2_dgrad_tc_weights). VEC: g's, dx's and x's rows
// and strides are 16-byte aligned (W a multiple of 16), so g is read and dx
// written (x read) by 16-byte vectors; otherwise element by element.
template <bool DACT, bool VEC>
__global__ void __launch_bounds__(kDtThreads, 2)
dgrad_s2_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ wtc,
                   bf16* __restrict__ dx, int cin, int cout, int nv, int qlo, int H, int W, int Do,
                   int n_ci, int n_tx, int n_ty, int n_tz, int dact, const bf16* __restrict__ dact_x,
                   long long db, long long dc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wbuf = reinterpret_cast<bf16*>(smem_raw);  // two chunks' weights
  bf16* graw = wbuf + 2 * kDtWts;                  // two chunks' raw g rows
  bf16* gp = graw + 2 * kDtGraw;                   // the chunk's g patch
  float* eb = reinterpret_cast<float*>(smem_raw);  // after the last chunk: the epilogue tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  long long rest = blockIdx.x;
  const int cit = static_cast<int>(rest % n_ci);
  rest /= n_ci;
  const int tx = static_cast<int>(rest % n_tx);
  rest /= n_tx;
  const int ty = static_cast<int>(rest % n_ty);
  rest /= n_ty;
  const int iz0 = ((qlo - 1) & ~1) + 2 * static_cast<int>(rest % n_tz);
  const long long b = rest / n_tz;
  const int oz0 = iz0 >> 1, oy0 = ty * (kDtTy / 2), ox0 = tx * (kDtTx / 2);
  const int n_co = (cout + kDtCo - 1) / kDtCo;
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const long long ovol = static_cast<long long>(Do) * oplane;
  const bf16* gb = g + b * cout * ovol;
  const bf16* wsrc = wtc + static_cast<long long>(cit) * n_co * kDtWts;

  // chunk ch's weights, one contiguous copy
  auto issue_w = [&](int ch, bf16* dst) {
    const bf16* src = wsrc + static_cast<long long>(ch) * kDtWts;
    for (int u = tid; u < kDtWts / 8; u += kDtThreads)
      cp_async16(dst + s2_swz(u >> 1, u & 1), src + u * 8, 16);
  };
  // chunk ch's raw g rows: [co][row][vector] of 8 columns, 2 planes × 5 rows ×
  // 3 vectors from column ox0, zero outside g and Cout; VEC: cp.async, so the
  // next chunk's rows land under the current chunk's products
  auto issue_g = [&](int ch, bf16* dst) {
    for (int u = tid; u < kDtCo * kDtRaw; u += kDtThreads) {
      const int v = u % kDtGvec, r = (u / kDtGvec) % (2 * kDtGh), co = ch * kDtCo + u / kDtRaw;
      const int oz = oz0 + r / kDtGh, oy = oy0 + r % kDtGh, c = ox0 + 8 * v;
      const bool row_ok = co < cout && oz >= 0 && oz < Do && oy < Ho;
      const long long off = co * ovol + oz * oplane + static_cast<long long>(oy) * Wo + c;
      if (VEC) {
        const bool ok = row_ok && c < Wo;  // Wo % 8 = 0: a vector is all in or out
        cp_async16(dst + u * 8, ok ? gb + off : g, ok ? 16 : 0);
      } else {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(gb) + off;
        unsigned short e8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) e8[e] = row_ok && c + e < Wo ? src[e] : 0;
        *reinterpret_cast<uint4*>(dst + u * 8) =
            make_uint4(e8[0] | (uint32_t(e8[1]) << 16), e8[2] | (uint32_t(e8[3]) << 16),
                       e8[4] | (uint32_t(e8[5]) << 16), e8[6] | (uint32_t(e8[7]) << 16));
      }
    }
  };
  // raw rows → the patch [position][16 co]: units of 8 channels × one vector,
  // an 8 × 8 register transpose (byte permutes), 4 columns at a time (16
  // words live beside the accumulators)
  auto transpose_g = [&](const bf16* raw) {
    for (int u = tid; u < (kDtCo / 8) * kDtRaw; u += kDtThreads) {
      const int rv = u % kDtRaw, cg = u / kDtRaw;
      const int v = rv % kDtGvec, r = rv / kDtGvec;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t wv[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint2 q2 =
              *reinterpret_cast<const uint2*>(raw + ((cg * 8 + i) * kDtRaw + rv) * 8 + 4 * half);
          wv[i][0] = q2.x, wv[i][1] = q2.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * v + 4 * half + e;
          if (col >= kDtGw) continue;
          const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
          const int j = e >> 1;
          *reinterpret_cast<uint4*>(gp + s2_swz(r * kDtGw + col, cg)) =
              make_uint4(__byte_perm(wv[0][j], wv[1][j], sel), __byte_perm(wv[2][j], wv[3][j], sel),
                         __byte_perm(wv[4][j], wv[5][j], sel), __byte_perm(wv[6][j], wv[7][j], sel));
        }
      }
    }
  };

  // warp w: class row uy = w % 4, all 16 columns of the 4 classes of its
  // group: {7, 0, 1, 2} (8 + 1 + 2 + 2 taps) for w < 4, {3, 4, 5, 6}
  // (4 + 2 + 4 + 4) for the others, so every warp does 13 or 14 of the 27
  // taps with 64 accumulators a thread
  const int uy = warp & 3;
  const bool grp1 = warp >= 4;
  float acc[4][2][2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][mt][nt][e] = 0.f;

  issue_w(0, wbuf);
  issue_g(0, graw);
  cp_async_commit();
  for (int ch = 0; ch < n_co; ++ch) {
    __syncthreads();  // chunk ch − 1 is no longer read: the patch and its buffers are free
    if (ch + 1 < n_co) {
      issue_w(ch + 1, wbuf + ((ch + 1) & 1) * kDtWts);
      issue_g(ch + 1, graw + ((ch + 1) & 1) * kDtGraw);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch's weights and raw g rows are in shared memory
    transpose_g(graw + (ch & 1) * kDtGraw);
    __syncthreads();  // its patch is ready
    const bf16* wts = wbuf + (ch & 1) * kDtWts;
    if (grp1) {
      dgrad_tc_class<3>(acc[0], wts, gp, uy, lane);
      dgrad_tc_class<4>(acc[1], wts, gp, uy, lane);
      dgrad_tc_class<5>(acc[2], wts, gp, uy, lane);
      dgrad_tc_class<6>(acc[3], wts, gp, uy, lane);
    } else {
      dgrad_tc_class<7>(acc[0], wts, gp, uy, lane);
      dgrad_tc_class<0>(acc[1], wts, gp, uy, lane);
      dgrad_tc_class<1>(acc[2], wts, gp, uy, lane);
      dgrad_tc_class<2>(acc[3], wts, gp, uy, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the staging buffers are no longer read: the epilogue tile takes them
  if (grp1) {
    dgrad_tc_put<3>(acc[0], eb, uy, lane);
    dgrad_tc_put<4>(acc[1], eb, uy, lane);
    dgrad_tc_put<5>(acc[2], eb, uy, lane);
    dgrad_tc_put<6>(acc[3], eb, uy, lane);
  } else {
    dgrad_tc_put<7>(acc[0], eb, uy, lane);
    dgrad_tc_put<0>(acc[1], eb, uy, lane);
    dgrad_tc_put<1>(acc[2], eb, uy, lane);
    dgrad_tc_put<2>(acc[3], eb, uy, lane);
  }
  __syncthreads();

  // dx rows out of the tile, 8 columns a thread: act′(x) at the voxel in fp32
  // (DACT), one rounding to bf16, 16-byte stores (VEC)
  const long long plane = static_cast<long long>(H) * W;
  const long long vol = static_cast<long long>(nv) * plane;
  for (int u = tid; u < kDtCi * kDtVox / 8; u += kDtThreads) {
    const int x8 = u % (kDtTx / 8), y = (u / (kDtTx / 8)) % kDtTy;
    const int z = (u / (kDtTx / 8 * kDtTy)) % 2, ci = u / (kDtVox / 8);
    const int c = cit * kDtCi + ci;
    const int pv = iz0 + z - (qlo - 1), iy = ty * kDtTy + y, ix = tx * kDtTx + 8 * x8;
    if (c >= cin || pv < 0 || pv >= nv || iy >= H || ix >= W) continue;
    const float4* src = reinterpret_cast<const float4*>(eb + ci * kDtEld + (z * kDtTy + y) * kDtTx + 8 * x8);
    const float4 lo = src[0], hi = src[1];
    float val[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const long long pix = pv * plane + static_cast<long long>(iy) * W + ix;
    if constexpr (DACT) {
      const bf16* xs = dact_x + b * db + c * dc + pix;
      if (VEC) {
        const uint4 q4 = *reinterpret_cast<const uint4*>(xs);
        const uint32_t w4[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          val[2 * j] *= dact_f32(dact, __uint_as_float(w4[j] << 16));
          val[2 * j + 1] *= dact_f32(dact, __uint_as_float(w4[j] & 0xffff0000u));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ix + e < W) val[e] *= dact_f32(dact, __bfloat162float(xs[e]));
      }
    }
    bf16* dst = dx + (b * cin + c) * vol + pix;
    if (VEC) {
      uint32_t w4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w4[j] = pack_bf16x2(val[2 * j], val[2 * j + 1]);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (ix + e < W) dst[e] = __float2bfloat16_rn(val[e]);
    }
  }
}

template <bool DACT>
int launch_dgrad_s2_tc(const void* g, const void* wtc, void* dx, long long batch, int cin,
                       int cout, int nv, int qlo, int H, int W, int Do, int dact,
                       const void* dact_x, long long db, long long dc, cudaStream_t stream) {
  const int n_ci = (cin + kDtCi - 1) / kDtCi;
  const int n_tx = (W + kDtTx - 1) / kDtTx, n_ty = (H + kDtTy - 1) / kDtTy;
  const int iz_first = (qlo - 1) & ~1, iz_end = qlo - 1 + nv;  // even start; one past the last
  const int n_tz = (iz_end - iz_first + 1) / 2;
  const long long blocks = batch * n_tz * static_cast<long long>(n_ty) * n_tx * n_ci;
  if (wtc == nullptr || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   (!DACT || (reinterpret_cast<uintptr_t>(dact_x) % 16 == 0 && db % 8 == 0 &&
                              dc % 8 == 0));
  auto kern = vec ? dgrad_s2_tc_kernel<DACT, true> : dgrad_s2_tc_kernel<DACT, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kDtSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(blocks), kDtThreads, kDtSmem, stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(wtc), static_cast<bf16*>(dx), cin,
      cout, nv, qlo, H, W, Do, n_ci, n_tx, n_ty, n_tz, dact, static_cast<const bf16*>(dact_x), db,
      dc);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------- F/J with one dx channel on the tensor cores ---

constexpr int kF1Threads = 256;                // 8 warps
constexpr int kF1Warps = kF1Threads / 32;
constexpr int kF1Co = 64;                      // g channels a block holds: the rule's most
constexpr int kF1Ty = 4, kF1Tx = 32;           // g rows × columns per block: 8 × 64 dx voxels a plane
constexpr int kF1Np = 8;                       // g planes a block walks: 16 dx planes
constexpr int kF1Rows = kF1Ty + 1;             // staged g rows: the tile's and one halo row
constexpr int kF1Cols = kF1Tx + 8;             // staged g columns from ox0: the tile's and a
                                               // vector holding the halo column
constexpr int kF1Ld = kF1Rows * kF1Cols;       // bf16 per staged channel: 400 bytes, an odd number
                                               // of 16-byte units (ldmatrix.trans conflict-free)
constexpr int kF1Groups = (kF1Ld + 15) / 16;   // 16-position groups of the products: 13
constexpr int kF1Buf = kF1Co * kF1Ld + 8;      // bf16 per staging buffer: + the last group's
                                               // over-read past the last channel
constexpr int kF1Pt = 232;                     // P floats per tap: ≥ 16 · 13 positions, ≡ 8 mod 32,
                                               // so a half-warp's float2 stores of 4 taps hit 32 banks
constexpr int kF1WLd = kF1Co + 8;              // bf16 per weight row ([tap][co]): 144 bytes
constexpr int kF1Smem = 2 * kF1Buf * 2 + 27 * kF1Pt * 4 + 32 * kF1WLd * 2;  // 80,896 bytes:
                                                                          // two blocks an SM
static_assert(2 * kF1Ty == kF1Warps && kF1Tx == 32, "one warp a dx row, one lane a g column");

// The dz part of dx row ry's two columns 2u (even) and 2u + 1 (odd) from P
// ([tap][staged position], PT floats a tap, COLS positions a staged g row),
// its dy terms in order: along each dimension an even dx index 2v takes d =
// 1 from g index v, an odd one 2v + 1 takes d = 0 from v + 1, then d = 2 from
// v; so row ry takes dy = 1 from g row ry / 2 (even) or dy = 0 from row (ry +
// 1) / 2, then dy = 2 from row (ry − 1) / 2 (odd).
template <int PT, int COLS>
__device__ __forceinline__ void c1_part(const float* ps, int dz, int ry, int u, float& se,
                                        float& so) {
  const int ny = 1 + (ry & 1);
  const int dy0 = ry & 1 ? 0 : 1, r0 = (ry + 1) >> 1, r1 = (ry - 1) >> 1;
  se = so = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= ny) break;
    const int dy = k ? 2 : dy0, r = k ? r1 : r0;
    const float* pr = ps + (dz * 9 + dy * 3) * PT + r * COLS + u;
    se += pr[PT];
    so += pr[1] + pr[2 * PT];
  }
}

// The one-dx-channel kernels' walk over g planes ozs … ozs + kF1Np (the
// design is in dgrad_s2_c1_tc_kernel's comment): stage(oz, buf) starts the
// copies of g plane oz into staging buffer buf (0 or 1) and products(buf)
// writes P ([tap][position], PT floats a tap, COLS positions a staged row)
// of that buffer's plane; each thread gathers its dx row ry's two columns
// 2u, 2u + 1 from P (c1_part) and store(iz, even, odd) writes them to dx
// plane iz (padding-1 index).
template <int PT, int COLS, class Stage, class Products, class Store>
__device__ __forceinline__ void c1_walk(int ozs, int Do, const float* ps, int ry, int u,
                                        const Stage& stage, const Products& products,
                                        const Store& store) {
  auto in_g = [&](int oz) { return oz >= 0 && oz < Do; };
  if (in_g(ozs)) stage(ozs, 0);
  cp_async_commit();
  float pend_e = 0.f, pend_o = 0.f;  // dz = 2 parts of dx plane 2·oz + 1
  for (int i = 0; i <= kF1Np; ++i) {
    const int oz = ozs + i;
    if (i < kF1Np && in_g(oz + 1)) stage(oz + 1, (i + 1) & 1);
    cp_async_commit();
    float e0 = 0.f, o0 = 0.f, e1 = 0.f, o1 = 0.f, e2 = 0.f, o2 = 0.f;
    if (in_g(oz)) {  // block-uniform branch
      cp_async_wait<1>();
      __syncthreads();  // plane oz is staged; the previous plane's P is no longer read
      products(i & 1);
      __syncthreads();  // P is complete
      c1_part<PT, COLS>(ps, 0, ry, u, e0, o0);
      if (i < kF1Np) {
        c1_part<PT, COLS>(ps, 1, ry, u, e1, o1);
        c1_part<PT, COLS>(ps, 2, ry, u, e2, o2);
      }
    }
    if (i > 0) store(2 * oz - 1, pend_e + e0, pend_o + o0);
    if (i < kF1Np) store(2 * oz, e1, o1);
    pend_e = e2;
    pend_o = o2;
  }
  cp_async_wait<0>();
}

// dx[iz, iy, ix] = Σ_{co, taps with 2·o + d − 1 = i along each dim} g[co, o] ·
// w[co, 0, tap] for one dx channel, 8 ≤ Cout ≤ 64 and no act′ epilogue
// (dgrad_s2_instance 2): _dgrad_s2's product with the taps as M. What bounds
// it: reading g (Cout times the bytes of dx / 8 · 2); the products are tiny.
// The 32-channel layout of dgrad_s2_kernel would pad M from 1 to 32. Here
// the products are a GEMM per g plane, P[tap, o] = Σ_co w[co, tap] · g[co, o],
// M = the 27 taps padded to 32 (two m16 tiles), K = Cout (≤ 4 k16 steps),
// N = the plane's staged g positions (5 rows × 40 columns from (oy0, ox0):
// the block's 4 × 32 and the halo row and column the odd dx rows and columns
// read): the weights' A fragments stay in registers for the block, g's
// channel rows arrive by 16-byte cp.async as they lie ([co][row][column],
// zero outside g and Cout, two buffers: the next plane lands under the
// current one's products and sums), the B fragments come by ldmatrix.trans
// and P goes to shared memory in fp32 ([tap][position]). Then each thread
// gathers two dx columns of one dx row from P by the parity rule of
// dgrad_s2_kernel: along each dimension an even index 2u takes d = 1 from g
// index u, an odd one 2u + 1 takes d = 0 from u + 1 and d = 2 from u. A
// block walks g planes ozs … ozs + 8: g plane oz gives dx plane 2·oz (dz = 1)
// whole, dx plane 2·oz − 1 its dz = 0 part (added to the dz = 2 part plane
// oz − 1 left), and keeps its own dz = 2 part for dx plane 2·oz + 1; so each
// g plane is staged once per block. The sums run in a fixed order and each dx
// element has one writer (no atomics: two runs give the same bits); one
// rounding to bf16, two columns a 32-bit store, a warp's 64 columns one
// 128-byte row segment. Block blockIdx.x: column tile fastest, then row tile,
// then plane range (g planes from ((qlo − 1) & ~1) / 2, so the first dx plane
// is even in padding-1 terms, iz = view plane + qlo − 1); batch blockIdx.y.
// Warp w: dx row 2·oy0 + w; lane u: dx columns 2·(ox0 + u) and + 1. VEC: g's
// rows are 16-byte aligned (Wo a multiple of 8) and dx's rows 4-byte aligned
// (W even), so g arrives by cp.async and dx leaves in pairs; otherwise
// element by element.
template <bool VEC>
__global__ void __launch_bounds__(kF1Threads, 2)
dgrad_s2_c1_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                      bf16* __restrict__ dx, int cout, int nv, int qlo, int H, int W, int Do,
                      int n_tx, int n_ty) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gbuf = reinterpret_cast<bf16*>(smem_raw);        // two planes' [co][row][column]
  float* ps = reinterpret_cast<float*>(gbuf + 2 * kF1Buf);  // [tap][position]
  bf16* ws = reinterpret_cast<bf16*>(ps + 27 * kF1Pt);     // [tap (32)][co]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tile = static_cast<int>(blockIdx.x);
  const int ox0 = tile % n_tx * kF1Tx;
  const int oy0 = tile / n_tx % n_ty * kF1Ty;
  const int ozs = (((qlo - 1) & ~1) >> 1) + tile / (n_tx * n_ty) * kF1Np;
  const long long b = blockIdx.y;
  const int ks = (cout + 15) / 16;  // k-steps of the products
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const bf16* gb = g + b * cout * Do * oplane;

  // the weights, [tap][co], zero past tap 26 and Cout; their A fragments stay
  // in registers. The padding past the last channel of each buffer is zeroed.
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(w);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(ws);
  for (int u = tid; u < 32 * kF1Co; u += kF1Threads) {
    const int tap = u / kF1Co, co = u % kF1Co;
    wsm[tap * kF1WLd + co] = tap < 27 && co < cout ? wg[co * 27 + tap] : 0;
  }
  if (tid < 2) reinterpret_cast<uint4*>(gbuf + tid * kF1Buf + kF1Co * kF1Ld)[0] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  uint32_t a[4][2][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (kk < ks) load_a(a[kk][mt], ws, kF1WLd, mt * 16, kk * 16, lane);

  // g plane oz into buffer buf: units of 8 columns of one row of one channel
  auto stage = [&](int oz, int buf) {
    bf16* dst = gbuf + buf * kF1Buf;
    const int units = ks * 16 * kF1Rows * (kF1Cols / 8);
    for (int u = tid; u < units; u += kF1Threads) {
      const int v = u % (kF1Cols / 8), r = u / (kF1Cols / 8) % kF1Rows;
      const int co = u / (kF1Rows * (kF1Cols / 8));
      const int oy = oy0 + r, c = ox0 + 8 * v;
      const bool row_ok = co < cout && oy < Ho;
      bf16* d = dst + co * kF1Ld + r * kF1Cols + 8 * v;
      const long long off = (static_cast<long long>(co) * Do + oz) * oplane +
                            static_cast<long long>(oy) * Wo;
      if (VEC) {
        const bool ok = row_ok && c < Wo;  // Wo % 8 = 0: a vector is all in or out
        cp_async16(d, ok ? gb + off + c : g, ok ? 16 : 0);
      } else {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(gb) + off;
        uint32_t e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c0 = c + 2 * i, c1 = c0 + 1;
          const uint32_t lo = row_ok && c0 < Wo ? src[c0] : 0;
          const uint32_t hi = row_ok && c1 < Wo ? src[c1] : 0;
          e[i] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(d) = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  };

  // P of the staged plane: warp w takes the 16-position groups w, w + 8; the
  // taps < 27 go to ps (the last group's positions past 199 are never read)
  auto products = [&](int buf) {
    const bf16* src = gbuf + buf * kF1Buf;
    for (int gi = warp; gi < kF1Groups; gi += kF1Warps) {
      const int n0 = gi * 16;
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
          load_b2(bf, src, kF1Ld, kk * 16, n0, lane);
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
            if (tap < 27)
              *reinterpret_cast<float2*>(ps + tap * kF1Pt + n0 + 8 * nt + 2 * (lane & 3)) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
    }
  };

  // this thread's dx row ry = warp and g column u
  const int ry = warp, u = lane;
  const int iy = 2 * oy0 + ry, ix = 2 * (ox0 + u);
  const long long plane = static_cast<long long>(H) * W;
  bf16* dxb = dx + b * nv * plane + static_cast<long long>(iy) * W + ix;
  auto store = [&](int iz, float ve, float vo) {
    const int pv = iz - (qlo - 1);
    if (pv < 0 || pv >= nv || iy >= H || ix >= W) return;
    bf16* dst = dxb + pv * plane;
    if (VEC) {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(ve, vo);
    } else {
      dst[0] = __float2bfloat16_rn(ve);
      if (ix + 1 < W) dst[1] = __float2bfloat16_rn(vo);
    }
  };

  c1_walk<kF1Pt, kF1Cols>(ozs, Do, ps, ry, u, stage, products, store);
}

// The one-dx-channel instances' grid: blocks of kF1Ty × kF1Tx g positions
// (n_tx column tiles fastest, then n_ty row tiles) and kF1Np g planes.
long long dgrad_s2_c1_tiles(int nv, int qlo, int H, int W, int& n_tx, int& n_ty) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  n_tx = (Wo + kF1Tx - 1) / kF1Tx;
  n_ty = (Ho + kF1Ty - 1) / kF1Ty;
  const int iz_lo = (qlo - 1) & ~1, iz_hi = qlo - 1 + nv;  // even start; one past the last
  const int n_tz = (iz_hi - iz_lo + 2 * kF1Np - 1) / (2 * kF1Np);
  return static_cast<long long>(n_tz) * n_ty * n_tx;
}

int launch_dgrad_s2_c1_tc(const void* g, const void* w, void* dx, long long batch, int cout,
                          int nv, int qlo, int H, int W, int Do, cudaStream_t stream) {
  int n_tx = 0, n_ty = 0;
  const long long tiles = dgrad_s2_c1_tiles(nv, qlo, H, W, n_tx, n_ty);
  const int Wo = (W - 1) / 2 + 1;
  if (cout > kF1Co || tiles > 2147483647LL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Wo % 8 == 0 && W % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 4 == 0;
  auto kern = vec ? dgrad_s2_c1_tc_kernel<true> : dgrad_s2_c1_tc_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kF1Smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)), kF1Threads, kF1Smem,
         stream>>>(static_cast<const bf16*>(g), static_cast<const bf16*>(w),
                   static_cast<bf16*>(dx), cout, nv, qlo, H, W, Do, n_tx, n_ty);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------- F/J with one dx channel in fp32 on the CUDA cores ---

constexpr int kF1fCols = 36;                // staged g columns from ox0: the tile's 32 and the halo
                                            // column, in 16-byte vectors (9)
constexpr int kF1fLd = kF1Rows * kF1fCols;  // floats per staged channel: 180 (720 bytes)
constexpr int kF1fTaps = 7;                 // taps a warp's products take: 4 groups, 28 ≥ 27
constexpr int kF1fPos = 3;                  // staged positions a lane's products take
constexpr int kF1fHalf = 32 * kF1fPos;      // positions a warp's products take: half a plane's
constexpr int kF1fPt = 2 * kF1fHalf;        // P floats per tap: 192 ≥ 180 positions
constexpr int kF1fTail = kF1fPt - kF1fLd;   // the last channel's over-read: 12 floats
constexpr int kF1fBuf = kF1Co * kF1fLd + kF1fTail;  // floats per staging buffer
constexpr int kF1fWLd = 4 * 8;              // floats per weight row: tap 7·group + j at 8·group + j
constexpr int kF1fSmem = (2 * kF1fBuf + 27 * kF1fPt + kF1Co * kF1fWLd) * 4;  // 121,184 bytes:
                                                                             // one block an SM
static_assert(kF1fCols % 4 == 0 && kF1fCols > kF1Tx && 4 * kF1fTaps >= 27 && kF1fPt >= kF1fLd &&
                  kF1fTaps < 8 && kF1Warps == 2 * 4,
              "whole vectors holding the halo column; 4 tap groups × 2 position halves = 8 warps");

// dgrad_s2_c1_tc_kernel's function in fp32 (dgrad_s2_instance 3): dx of one
// dx channel from g and w in fp32, 8 ≤ Cout ≤ 64, no act′ — it replaces
// hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py::_dgrad_s2 at one input
// channel, the stem's data gradient when the step runs in fp32. What
// bounds it: reading g (8 × 1→64, g 32³ → dx 64³: 67.1 MB of g and 8.4 MB of
// dx, 0.0225 ms at 3.35 TB/s; its 453 M useful multiply-adds take 0.0135 ms
// at the 67 TFLOP/s fp32 rate). TF32 tensor cores would leave the fp32
// tolerance, so the products run on the CUDA cores in fp32 FMAs; the
// 32-channel layout of dgrad_s2_kernel would pad them 32-fold. The block,
// its walk of 8 g planes, the staged window (5 g rows × 36 columns from
// (oy0, ox0), zero outside g), P[tap, position] in shared memory and the
// parity gather and store are dgrad_s2_c1_tc_kernel's; only the staging's
// element type and the product step differ. Each g plane's channels arrive
// by 16-byte cp.async as they lie ([co][row][column], two buffers: the next
// plane lands under the current one's products and sums). Products P =
// W[27 taps × Cout] · G[Cout × 192 positions]: warp w takes taps 7·(w % 4) …
// + 6 (tap 27 of the last group is zero and not stored) and positions 96·(w /
// 4) + lane + {0, 32, 64}, 21 fp32 accumulators a thread; per g channel, in
// ascending order, it reads one g value per position (a warp's 32
// neighbouring floats) and its 7 weights as two float4 broadcasts of one
// [co][tap] row. Positions 180-191 read the next channel's first values (or
// the buffer's zeroed tail) and land in P where the gather never reads. The
// sums run in a fixed order and each dx element has one writer: no atomics,
// two runs give the same bits. VEC: g's rows are 16-byte aligned (Wo a
// multiple of 4) and dx's 8-byte aligned (W even), so g arrives by cp.async
// and dx leaves in pairs; otherwise element by element.
template <bool VEC>
__global__ void __launch_bounds__(kF1Threads, 1)
dgrad_s2_c1_f32_kernel(const float* __restrict__ g, const float* __restrict__ w,
                       float* __restrict__ dx, int cout, int nv, int qlo, int H, int W, int Do,
                       int n_tx, int n_ty) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* gbuf = reinterpret_cast<float*>(smem_raw);  // two planes' [co][row][column]
  float* ps = gbuf + 2 * kF1fBuf;                    // [tap][position]
  float* ws = ps + 27 * kF1fPt;                      // [co][group · 8 + j]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tile = static_cast<int>(blockIdx.x);
  const int ox0 = tile % n_tx * kF1Tx;
  const int oy0 = tile / n_tx % n_ty * kF1Ty;
  const int ozs = (((qlo - 1) & ~1) >> 1) + tile / (n_tx * n_ty) * kF1Np;
  const long long b = blockIdx.y;
  const long long oplane = static_cast<long long>(Ho) * Wo;
  const float* gb = g + b * cout * Do * oplane;

  // the weights, zero past tap 26; the buffers' tails past the last channel
  for (int u = tid; u < kF1Co * kF1fWLd; u += kF1Threads) {
    const int co = u / kF1fWLd, grp = u % kF1fWLd / 8, j = u % 8, tap = kF1fTaps * grp + j;
    ws[u] = co < cout && j < kF1fTaps && tap < 27 ? w[co * 27 + tap] : 0.f;
  }
  if (tid < 2 * kF1fTail) gbuf[tid / kF1fTail * kF1fBuf + kF1Co * kF1fLd + tid % kF1fTail] = 0.f;

  // g plane oz into buffer buf: units of 4 columns of one row of one channel
  auto stage = [&](int oz, int buf) {
    float* dst = gbuf + buf * kF1fBuf;
    const int units = cout * kF1Rows * (kF1fCols / 4);
    for (int u = tid; u < units; u += kF1Threads) {
      const int v = u % (kF1fCols / 4), r = u / (kF1fCols / 4) % kF1Rows;
      const int co = u / (kF1Rows * (kF1fCols / 4));
      const int oy = oy0 + r, c = ox0 + 4 * v;
      const bool row_ok = oy < Ho;
      float* d = dst + co * kF1fLd + r * kF1fCols + 4 * v;
      const float* src = gb + (static_cast<long long>(co) * Do + oz) * oplane +
                         static_cast<long long>(oy) * Wo;
      if (VEC) {
        const bool ok = row_ok && c < Wo;  // Wo % 4 = 0: a vector is all in or out
        cp_async16(d, ok ? src + c : g, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = row_ok && c + e < Wo ? src[c + e] : 0.f;
      }
    }
  };

  // P of the staged plane: warp w's taps 7·grp … and positions 96·half + lane …
  const int grp = warp % 4, half = warp / 4;
  auto products = [&](int buf) {
    const float* src = gbuf + buf * kF1fBuf;
    float acc[kF1fTaps][kF1fPos];
#pragma unroll
    for (int j = 0; j < kF1fTaps; ++j)
#pragma unroll
      for (int k = 0; k < kF1fPos; ++k) acc[j][k] = 0.f;
    const float* gp = src + half * kF1fHalf + lane;
    const float4* wp = reinterpret_cast<const float4*>(ws + 8 * grp);
#pragma unroll 4
    for (int co = 0; co < cout; ++co) {
      const float4 wa = wp[co * (kF1fWLd / 4)], wb = wp[co * (kF1fWLd / 4) + 1];
      const float wv[kF1fTaps] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z};
      float gv[kF1fPos];
#pragma unroll
      for (int k = 0; k < kF1fPos; ++k) gv[k] = gp[co * kF1fLd + 32 * k];
#pragma unroll
      for (int j = 0; j < kF1fTaps; ++j)
#pragma unroll
        for (int k = 0; k < kF1fPos; ++k) acc[j][k] = fmaf(wv[j], gv[k], acc[j][k]);
    }
#pragma unroll
    for (int j = 0; j < kF1fTaps; ++j) {
      const int tap = kF1fTaps * grp + j;
      if (tap < 27)
#pragma unroll
        for (int k = 0; k < kF1fPos; ++k)
          ps[tap * kF1fPt + half * kF1fHalf + lane + 32 * k] = acc[j][k];
    }
  };

  // this thread's dx row ry = warp and g column u
  const int ry = warp, u = lane;
  const int iy = 2 * oy0 + ry, ix = 2 * (ox0 + u);
  const long long plane = static_cast<long long>(H) * W;
  float* dxb = dx + b * nv * plane + static_cast<long long>(iy) * W + ix;
  auto store = [&](int iz, float ve, float vo) {
    const int pv = iz - (qlo - 1);
    if (pv < 0 || pv >= nv || iy >= H || ix >= W) return;
    float* dst = dxb + pv * plane;
    if (VEC) {
      *reinterpret_cast<float2*>(dst) = make_float2(ve, vo);
    } else {
      dst[0] = ve;
      if (ix + 1 < W) dst[1] = vo;
    }
  };

  c1_walk<kF1fPt, kF1fCols>(ozs, Do, ps, ry, u, stage, products, store);
}

int launch_dgrad_s2_c1_f32(const void* g, const void* w, void* dx, long long batch, int cout,
                           int nv, int qlo, int H, int W, int Do, cudaStream_t stream) {
  int n_tx = 0, n_ty = 0;
  const long long tiles = dgrad_s2_c1_tiles(nv, qlo, H, W, n_tx, n_ty);
  if (cout > kF1Co || tiles > 2147483647LL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Wo = (W - 1) / 2 + 1;
  const bool vec = Wo % 4 == 0 && W % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 8 == 0;
  auto kern = vec ? dgrad_s2_c1_f32_kernel<true> : dgrad_s2_c1_f32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kF1fSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)), kF1Threads, kF1fSmem,
         stream>>>(static_cast<const float*>(g), static_cast<const float*>(w),
                   static_cast<float*>(dx), cout, nv, qlo, H, W, Do, n_tx, n_ty);
  return static_cast<int>(cudaGetLastError());
}

// The instance a call takes, an explicit rule (no fallback): 1, bf16 with Cin
// ≥ 8 and Cout ≥ 8 → the tensor cores (dgrad_s2_tc_kernel); 2, bf16 with one
// dx channel, 8 ≤ Cout ≤ 64 and no act′ epilogue — the data gradient of
// stage 1's 1→64 stem — → the one-dx-channel tensor cores
// (dgrad_s2_c1_tc_kernel; act′ would be the backward of a prologue, which
// the stem's input, the broadcast initial volume, has not); 3, the same call
// in fp32 → its CUDA-core form (dgrad_s2_c1_f32_kernel); 0, the rest of
// fp32 (tensor cores would mean TF32, outside the fp32 tolerances) and of
// bf16 → the CUDA-core dgrad_s2_kernel. The wrapper reads it through
// hvc_conv3d_k3s2_dgrad_tc (ops/cuda/conv3d_k3.py: dgrad_s2_instance states it
// for the CPU).
int dgrad_s2_instance(bool bf16, int cin, int cout, int dact) {
  if (!bf16) return cin == 1 && cout >= 8 && cout <= kF1Co && dact == 0 ? 3 : 0;
  if (cin >= 8 && cout >= 8) return 1;
  return cin == 1 && cout >= 8 && cout <= kF1Co && dact == 0 ? 2 : 0;
}

}  // namespace

// Kernels E/K (stride 1) and G/K (stride 2): dW (Cout, Cin, 3, 3, 3) fp32
// into `out`, through `partial` (splits × Cout × Cin × 27 fp32 scratch), from
// the input view x (nv planes, strides xb/xc, slab offset qlo, prologue act)
// and g (B, Cout, Do, Ho, Wo) contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int hvc_conv3d_k3s1_wgrad(const void* x, const void* g, void* partial, void* out,
                                     long long batch, int cin, int cout, int nv, int H, int W,
                                     int Do, int qlo, long long xb, long long xc, int act,
                                     int dtype, int splits, void* stream) {
  return dispatch_wgrad<1>(x, g, partial, out, batch, cin, cout, nv, qlo, xb, xc, act, H, W, Do,
                           dtype, splits, stream);
}

extern "C" int hvc_conv3d_k3s2_wgrad(const void* x, const void* g, void* partial, void* out,
                                     long long batch, int cin, int cout, int nv, int H, int W,
                                     int Do, int qlo, long long xb, long long xc, int act,
                                     int dtype, int splits, void* stream) {
  return dispatch_wgrad<2>(x, g, partial, out, batch, cin, cout, nv, qlo, xb, xc, act, H, W, Do,
                           dtype, splits, stream);
}

// Kernels F/J: dx (B, Cin, nv, H, W) contiguous, the gradient of the view's
// planes, from g (B, Cout, Do, Ho, Wo); dact/dact_x/db/dc: act′ epilogue
// (dact_x at dx's geometry with batch/channel strides db/dc). wtc: the
// weights in the tensor-core instance's layout (Cin tiles of 32 × Cout chunks
// of 16 × 27 taps × 32 × 16, zero-padded), which that instance reads instead
// of w; null for a call on the CUDA cores.
extern "C" int hvc_conv3d_k3s2_dgrad(const void* g, const void* w, const void* wtc, void* dx,
                                     long long batch, int cin, int cout, int nv, int H, int W,
                                     int Do, int qlo, int dact, const void* dact_x, long long db,
                                     long long dc, int dtype, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || nv <= 0 || H <= 0 || W <= 0 || Do <= 0 ||
      dact < 0 || dact > 2 || (dact != 0) != (dact_x != nullptr) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int instance = dgrad_s2_instance(dtype == 1, cin, cout, dact);
  if (instance == 2) return launch_dgrad_s2_c1_tc(g, w, dx, batch, cout, nv, qlo, H, W, Do, s);
  if (instance == 3) return launch_dgrad_s2_c1_f32(g, w, dx, batch, cout, nv, qlo, H, W, Do, s);
  if (instance == 1)
    return dact ? launch_dgrad_s2_tc<true>(g, wtc, dx, batch, cin, cout, nv, qlo, H, W, Do, dact,
                                           dact_x, db, dc, s)
                : launch_dgrad_s2_tc<false>(g, wtc, dx, batch, cin, cout, nv, qlo, H, W, Do, dact,
                                            dact_x, db, dc, s);
#define LAUNCH_DGRAD(T, A) \
  launch_dgrad_s2<T, A>(g, w, dx, batch, cin, cout, nv, qlo, H, W, Do, dact, dact_x, db, dc, s)
  if (dtype == 0) return dact ? LAUNCH_DGRAD(float, true) : LAUNCH_DGRAD(float, false);
  if (dtype == 1) return dact ? LAUNCH_DGRAD(__nv_bfloat16, true) : LAUNCH_DGRAD(__nv_bfloat16, false);
#undef LAUNCH_DGRAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance hvc_conv3d_k3s2_dgrad runs a call with these channel counts
// (Cin of dx, Cout of g), act′ epilogue (dact code) and dtype (0 = float32,
// 1 = bfloat16) on: 0 the CUDA cores, 1 the tensor cores (Cin ≥ 8), 2 the
// one-dx-channel tensor cores, 3 the one-dx-channel CUDA-core form in fp32;
// the rule of its dispatch, which the wrapper counts launches by.
extern "C" int hvc_conv3d_k3s2_dgrad_tc(int cin, int cout, int dact, int dtype) {
  return dgrad_s2_instance(dtype == 1, cin, cout, dact);
}

// The instance hvc_conv3d_k3s{stride}_wgrad runs a call with this Cin and
// dtype (0 = float32, 1 = bfloat16) on: 0 the CUDA cores, 1 the tensor cores
// (Cin ≥ 8), 2 the one-input-channel tensor-core instance at stride 1, 3 its
// stride-2 form; the rule of dispatch_wgrad, which the wrapper counts
// launches by and sizes the split for.
extern "C" int hvc_conv3d_k3_wgrad_tc(int stride, int cin, int dtype) {
  return wgrad_instance(stride, dtype == 1, cin);
}
