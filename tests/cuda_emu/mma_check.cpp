// Holds the stand-ins of tower_mma.cuh against a plain matrix product
// (tests/test_torch_tower_source.py::test_mma_stand_in_matches_matmul).
// One warp computes D = A . B for A (16 x 16) and B (16 x 16) given
// row-major in f32 (exact bf16 values), as two m16n8k16 products, and
// writes D (16 x 16) row-major. The operands reach the fragments in one of
// three ways, each written here from the PTX ISA's layouts and not from the
// tower kernels:
//   mode 0  registers filled element by element by the fragment layout;
//   mode 1  ldmatrix of A stored (row, k) and ldmatrix.trans of B stored
//           (k, n) in shared memory (the conv tile's loads);
//   mode 2  ldmatrix.trans of A stored transposed, (k, row) (the wgrad
//           tile's load of its A), B as in mode 1;
//   mode 3  as mode 1, the operands first rounded to bf16 in global memory
//           and copied into the block's dynamic shared memory 4 bytes at a
//           time by cp_async_4 (the window attention's loads).
#include "cuda_runtime.h"
#include "tower_mma.cuh"

namespace {

uint16_t bits(float v) { return __float2bfloat16(v).bits; }

uint32_t pack(float lo, float hi) { return (uint32_t)bits(lo) | (uint32_t)bits(hi) << 16; }

constexpr int kStride = 24;  // bf16 elements per shared-memory row

__nv_bfloat16 g_ab[2][256];  // mode 3: A and B as bf16 in "global" memory

void mma_check_kernel(const float* A, const float* B, float* D, int mode) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  uint32_t a[4], b[2][2];
  if (mode == 0) {
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i % 2), k = 2 * t + 8 * (i / 2);
      a[i] = pack(A[row * 16 + k], A[row * 16 + k + 1]);
    }
    for (int n8 = 0; n8 < 2; ++n8)
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * t + 8 * h, n = 8 * n8 + g;
        b[n8][h] = pack(B[k * 16 + n], B[(k + 1) * 16 + n]);
      }
  } else {
    auto* sa = reinterpret_cast<__nv_bfloat16*>(dynamic_smem());
    auto* sb = sa + 16 * kStride;
    if (mode == 3) {
      for (int i = lane; i < 256; i += 32) {
        g_ab[0][i] = __float2bfloat16(A[i]);
        g_ab[1][i] = __float2bfloat16(B[i]);
      }
      __syncthreads();
      for (int i = lane; i < 128; i += 32) {  // a pair of one row each
        const int r = 2 * i / 16, c = 2 * i % 16;
        cp_async_4(sa + r * kStride + c, &g_ab[0][2 * i]);
        cp_async_4(sb + r * kStride + c, &g_ab[1][2 * i]);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int i = lane; i < 256; i += 32) {
        const int r = i / 16, c = i % 16;
        // mode 2 keeps A as (k, row): element A[r][c] at row c, column r
        sa[mode == 1 ? r * kStride + c : c * kStride + r] = __float2bfloat16(A[i]);
        sb[r * kStride + c] = __float2bfloat16(B[i]);
      }
    }
    __syncthreads();
    // matrix j = lane / 8, its row lane % 8; A's matrices in register
    // order (rows 0-7 | 8-15) x (k 0-7 | 8-15), row-half fastest
    const int j = lane / 8, r = lane % 8;
    if (mode != 2) {
      ldmatrix_x4(a, sa + (r + 8 * (j % 2)) * kStride + 8 * (j / 2));
    } else {
      ldmatrix_x4_trans(a, sa + (r + 8 * (j / 2)) * kStride + 8 * (j % 2));
    }
    // B's matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), ...
    uint32_t q[4];
    ldmatrix_x4_trans(q, sb + (r + 8 * (j % 2)) * kStride + 8 * (j / 2));
    b[0][0] = q[0];
    b[0][1] = q[1];
    b[1][0] = q[2];
    b[1][1] = q[3];
  }
  for (int n8 = 0; n8 < 2; ++n8) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16_16816(d, a, b[n8][0], b[n8][1]);
    for (int i = 0; i < 4; ++i)
      D[(g + 8 * (i / 2)) * 16 + 8 * n8 + 2 * t + i % 2] = d[i];
  }
}

}  // namespace

extern "C" int mma_check(const float* A, const float* B, float* D, int mode) {
  emu_launch(mma_check_kernel, dim3(1), dim3(32), 2 * 16 * kStride * 2, nullptr,
             A, B, D, mode);
  return cudaGetLastError();
}
