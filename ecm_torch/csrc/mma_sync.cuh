// Warp-level tensor-core and async-copy instructions as small device
// functions (header only): bf16 mma.sync m16n8k16 with f32 accumulation,
// ldmatrix from shared memory, and cp.async from global to shared memory.
// The kernels around them are plain C++ on shared-memory pointers.
//
// Fragment layouts (g = lane / 4, t = lane % 4), each register two bf16:
//   A 16x16 row-major: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                      a2 (row g, k 2t+8..),  a3 (row g+8, k 2t+8..)
//   B 16x8 col-major:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C/D 16x8 f32:      d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g+8, same)
// ldmatrix_x4: lane l gives the address of row l % 8 of 8x8 matrix l / 8
// (8 bf16, 16 bytes); register m of lane l receives matrix m, row l / 4,
// elements 2 (l % 4) and 2 (l % 4) + 1.

#pragma once

#include <cuda_runtime.h>

namespace ecm {
namespace ptx {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// d += A * B for one m16n8k16 tile
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; row: this lane's row address
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16 bytes from global src to shared dst, asynchronously; dst is zero-filled
// and src not read when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ptx
}  // namespace ecm
