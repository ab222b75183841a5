// A CPU stand-in for srgan_tpu_torch/csrc/tower_mma.cuh (see cuda_runtime.h
// beside it). The warp-wide primitives are warp-cooperative, like
// __shfl_xor_sync there: each lane publishes its operands (fragment
// registers, or a row address for ldmatrix) to a per-warp slot array, the
// warp meets at its barrier, and each lane then builds its own result by
// the PTX ISA's documented layouts (written out in the header this file
// stands in for). cp.async is a plain copy and its wait does nothing.
// The block's dynamic shared memory is the runtime stand-in's one buffer.
// tests/cuda_emu/mma_check.cpp holds these against a matrix product.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

inline uint32_t emu_frag[1024][6];
inline const void* emu_rows[1024];

inline float emu_bf16_bits(uint32_t reg, int half) {
  return __bfloat162float(__nv_bfloat16{(uint16_t)(reg >> (16 * half))});
}

inline void emu_warp_sync() { emu_warp_barrier[threadIdx.x / 32]->arrive_and_wait(); }

// d += a . b; the 16 products of each output are summed in double (they
// are exact), then added to the f32 accumulator once
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1) {
  const int t = threadIdx.x, w0 = t / 32 * 32, lane = t % 32;
  for (int i = 0; i < 4; ++i) emu_frag[t][i] = a[i];
  emu_frag[t][4] = b0;
  emu_frag[t][5] = b1;
  emu_warp_sync();
  // A[row][k] lives in lane (row % 8) * 4 + (k % 8) / 2, register
  // (row / 8) + 2 * (k / 8), half k % 2; B[k][n] in lane n * 4 + (k % 8) / 2,
  // register b0 for k < 8 else b1, half k % 2
  auto A = [&](int row, int k) {
    return emu_bf16_bits(emu_frag[w0 + (row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k % 2);
  };
  auto B = [&](int k, int n) {
    return emu_bf16_bits(emu_frag[w0 + n * 4 + (k % 8) / 2][4 + k / 8], k % 2);
  };
  const int g = lane / 4, tq = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * tq + i % 2;
    double s = 0.0;
    for (int k = 0; k < 16; ++k) s += (double)A(row, k) * (double)B(k, col);
    d[i] += (float)s;
  }
  emu_warp_sync();
}

inline void emu_ldmatrix_x4(uint32_t (&r)[4], const void* row, bool trans) {
  const int t = threadIdx.x, w0 = t / 32 * 32, lane = t % 32;
  emu_rows[t] = row;
  emu_warp_sync();
  for (int j = 0; j < 4; ++j) {
    uint16_t e[2];
    for (int h = 0; h < 2; ++h) {
      const int rr = trans ? 2 * (lane % 4) + h : lane / 4;
      const int cc = trans ? lane / 4 : 2 * (lane % 4) + h;
      std::memcpy(&e[h], static_cast<const uint16_t*>(emu_rows[w0 + 8 * j + rr]) + cc, 2);
    }
    r[j] = (uint32_t)e[0] | (uint32_t)e[1] << 16;
  }
  emu_warp_sync();
}

inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) { emu_ldmatrix_x4(r, row, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) { emu_ldmatrix_x4(r, row, true); }

inline void cp_async_16(void* smem, const void* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async_4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

inline unsigned char* dynamic_smem() { return tower_smem; }
