// Tensor-core building blocks shared by the port's mma.sync kernels (the
// conv probes in conv_probe.cu, the tensor-core conv and its gradients in
// conv3d_k3.cu and conv3d_k3_bwd.cu, the tensor-core flash forward and
// backward): cp.async copies, ldmatrix fragment loads, the m16n8k16
// bf16 → fp32 product, bf16 packing and the swizzle of 32-byte channel rows.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, zero-filled beyond src_bytes (0 or 16).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
// 4 bytes global → shared, zero-filled beyond src_bytes (0 or 4).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a · b on one 16×8×16 tile (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16×16 tile at (row0, k0) of a row-major shared array.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int row0, int k0,
                                       int lane) {
  ldsm_x4(a, s + (row0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// Two fp32 values rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Element offset of 16-byte unit u (channels 8u … 8u + 7) of 32-byte bf16
// row `row` (a patch position or a weight row, 16 channels): the two units
// swap places in every other group of four rows, so the 8 consecutive rows
// an ldmatrix reads hit 8 different bank groups wherever they start,
// without padding.
__device__ __forceinline__ int s2_swz(int row, int u) {
  return row * 16 + ((u ^ ((row >> 2) & 1)) << 3);
}

// B fragments of two 16×8 tiles at (k0, n0) and (k0, n0 + 8) of a row-major
// [K][N] shared array: {b0, b1} of the first, then of the second.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0,
                                        int lane) {
  ldsm_x4_t(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3));
}

}  // namespace
