// The PTX primitives of the tensor-core tiles in residual_tower.cu and
// window_attention.cu, each behind a small device function: the warp-wide
// bf16 product with f32 accumulators, the shared-memory fragment loads that
// feed it, the asynchronous global-to-shared copies with their group wait,
// and the block's dynamic shared memory.
//
// tests/cuda_emu/tower_mma.cuh is a CPU stand-in with the same names and
// the same semantics, so that g++ can compile and run the kernels.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" with
// .bf16; g = lane / 4, t = lane % 4; the lower-indexed element of a pair
// sits in the lower 16 bits of its register):
//   A (16 x 16, row):  a[0] = A[g][2t, 2t+1]     a[1] = A[g+8][2t, 2t+1]
//                      a[2] = A[g][2t+8, 2t+9]   a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):   b0 = B[2t, 2t+1][g]       b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8):     d[0], d[1] = D[g][2t, 2t+1]
//                      d[2], d[3] = D[g+8][2t, 2t+1]
// ldmatrix .x4 loads four 8 x 8 matrices of 16-bit values; lanes 8j..8j+7
// give the addresses of matrix j's rows (16 contiguous bytes each), and
// lane l receives row l/4, columns 2(l%4), 2(l%4)+1 of each matrix in r[j]
// (with .trans: rows 2(l%4), 2(l%4)+1 of column l/4).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a . b
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// 16 bytes, both addresses 16-byte aligned; L2 only (.cg)
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

// 4 bytes, both addresses 4-byte aligned (.ca: the only form of this size)
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The block's dynamic shared memory (the launch's third argument), 16-byte
// aligned
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char dynamic_smem_bytes[];
  return dynamic_smem_bytes;
}
