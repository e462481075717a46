// Hopper (sm_90a) building blocks for warpgroup matrix products fed by the
// Tensor Memory Accelerator, shared by the port's wgmma kernels (the V0-V4
// and V6 probes in conv_probe.cu): the 128-byte swizzle address, the
// wgmma shared-memory matrix descriptor, mbarriers, register rebalancing
// between warpgroups, TMA tile loads and
// stores, wgmma's fence, commit and wait, and the m64n128k16 and m64n32k16
// bf16 → fp32 products. The tensor maps
// themselves are built on the host with libcuda's cuTensorMapEncodeTiled,
// which cudaGetDriverEntryPoint reaches without linking libcuda (cuda.h is
// included for its types only).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// Byte offset of 16-byte chunk `chunk` (0-7) of 128-byte row `row` in a tile
// that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with the
// 128-byte swizzle layout: the chunk index XOR the row's index mod 8, so the
// 8 rows of one column of chunks lie in 8 different bank groups. The tile's
// base is 1024-byte aligned (the pattern repeats every 8 rows).
__host__ __device__ constexpr uint32_t sw128_offset(uint32_t row, uint32_t chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// The wgmma matrix descriptor of an operand tile in shared memory with the
// 128-byte swizzle: bits 0-13 the start address / 16, 16-29 the leading
// byte offset / 16, 32-45 the stride byte offset / 16, 49-51 the base offset
// (0: every tile starts 1024-byte aligned), 62-63 the layout (1: 128-byte
// swizzle). For a K-major operand (rows of 64 bf16 along K) the stride byte
// offset is the distance between 8-row groups and the leading one is unused;
// for an MN-major operand (rows of 64 bf16 along M or N, one row per k) the
// leading byte offset steps to the next 64-element block along M or N and the
// stride byte offset to the next group of 8 k rows. A k16 step of a K-major
// tile advances the start address by 32 bytes inside the swizzled row.
constexpr uint64_t kDescLayoutSw128 = 1;
__host__ __device__ constexpr uint64_t wgmma_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                                  uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | (kDescLayoutSw128 << 62);
}

// ------------------------------------------------------------- mbarriers ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA) and the block
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The calling warpgroup's registers a thread: a producer that only issues
// TMA gives some back (dec), consumers holding accumulators take them (inc).
// All four warps of the warpgroup execute it; the paths after it must not
// reconverge, or the compiler ignores it.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ------------------------------------------------------------------- TMA ---

// The 2-D box at (c0 innermost, c1) of `map` into shared memory; completion
// (its bytes) is reported to `bar`. Out-of-bounds elements are zero-filled.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// The shared-memory box at `src` to (c0, c1) of `map`; out-of-bounds elements
// are not written. Tracked by the bulk groups below.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N committed store groups still read their shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N committed store groups still pending
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's shared-memory writes before the async proxy's reads
// (a TMA store of what the thread wrote)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------------- wgmma ---

// Before the first wgmma of a batch: the warpgroup's register and shared
// memory writes are visible to the products.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed wgmma groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// this point (the accumulators belong to the in-flight products until
// wgmma_wait returns).
template <int R>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 × 128 fp32, 64 a thread of the warpgroup) = A (64 × 16) · B (16 ×
// 128) + (scale_d ? d : 0), both bf16 in shared memory by descriptor. A is
// K-major; B is MN-major when TRANS_B = 1 (rows of n, one per k: a row-major
// [K][N] operand), K-major when 0. Thread t of the warpgroup holds, for
// column block j / 4 (8 columns) and e = j % 4, row 16·(t / 32) + (t % 32) /
// 4 + 8·(e / 2), column 8·(j / 4) + 2·(t % 4) + e % 2.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The same at N = 32 (16 fp32 a thread, the first 16 of the layout above):
// d (64 × 32) = A (64 × 16) · B (16 × 32) + (scale_d ? d : 0).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

}  // namespace
