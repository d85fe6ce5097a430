// Hopper building blocks shared by the tensor-core kernels
// (flash_attention.cu: K2, K3; moe_runs.cu: K1, K4, K5): 16-byte cp.async
// copies into shared memory, ldmatrix fragment loads, the bf16 mma.sync
// m16n8k16 with float32 sums and the s8 mma.sync m16n8k32 with s32 sums.
//
// Fragments (lane = 4 g + t): an A fragment a[4] of a row-major 16 x 16
// tile holds (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..);
// a B fragment (b0, b1) of a 16 x 8 tile holds (k = 2t..2t+1, n = g) and
// (k = 2t + 8.., n = g); a C fragment c[4] of a 16 x 8 tile holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). In s8 m16n8k32 each register
// holds four k-neighbours, lowest k in the lowest byte: A (g, 4t..4t+3),
// (g + 8, 4t..), (g, 16 + 4t..), (g + 8, 16 + 4t..); B (k = 4t..4t+3,
// n = g), (k = 16 + 4t.., n = g); C as above, in s32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zeros when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8. Plain: lane (g, t) gets row g, columns 2t..2t+1 of each;
// .trans: rows 2t..2t+1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . (b0, b1): one 16 x 8 x 16 bf16 product into float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . (b0, b1): one 16 x 8 x 32 s8 product into s32 sums (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
