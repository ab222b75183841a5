// A CPU stand-in for the part of the CUDA runtime that the sources of
// srgan_tpu_torch/csrc/ use, so that g++ can compile them and the tests can
// run their kernels on the CPU (tests/test_torch_tower_source.py,
// tests/test_torch_recon_source.py). Blocks run one at a time; each CUDA
// thread is a std::thread, __syncthreads is a std::barrier over the block,
// the warp shuffles exchange through a per-warp slot array. Dynamic shared
// memory is one static buffer, filled with garbage before every block as
// the card leaves it. Static __shared__ arrays need -DEMU_STATIC_SHARED:
// they become function-level statics, one for all the threads of the
// running block (a source that declares `extern __shared__`, which cannot
// be static, is compiled without it). The card has kEmuSms SMs. A launch
// is written `emu_launch(kernel, grid, block, smem, stream, args...)`: the
// tests rewrite each `kernel<<<...>>>(` so.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#ifdef EMU_STATIC_SHARED
#define __shared__ static
#else
#define __shared__
#endif
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 4 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
constexpr int kEmuSms = 2;

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::barrier<>* emu_warp_barrier[32];
inline double emu_slots[1024];
inline int emu_error = 0;
alignas(16) inline unsigned char tower_smem[1 << 20];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barrier[threadIdx.x / 32]->arrive_and_wait();
}

// the card's rsqrtf is within 2 ulp of 1/sqrt; this one rounds twice
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }

// v of lane src(lane) of the warp; every lane of the warp must call it
template <typename V, typename Src>
V emu_shfl(V v, Src src) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  emu_slots[t] = (double)v;
  emu_warp_barrier[w]->arrive_and_wait();
  const V r = (V)emu_slots[w * 32 + src(lane)];
  emu_warp_barrier[w]->arrive_and_wait();
  return r;
}

template <typename V>
V __shfl_xor_sync(unsigned, V v, int lane_mask) {
  return emu_shfl(v, [&](int l) { return l ^ lane_mask; });
}
// a lane with no source lane in the warp gets its own value
template <typename V>
V __shfl_up_sync(unsigned, V v, unsigned delta) {
  return emu_shfl(v, [&](int l) { return l >= (int)delta ? l - (int)delta : l; });
}
template <typename V>
V __shfl_down_sync(unsigned, V v, unsigned delta) {
  return emu_shfl(v, [&](int l) { return l + (int)delta < 32 ? l + (int)delta : l; });
}

// A kernel's dynamic shared memory limit, set by cudaFuncSetAttribute and
// kept for its later launches, as the card keeps it
inline std::map<const void*, size_t> emu_smem_limits;

template <typename K>
int cudaFuncSetAttribute(K kernel, cudaFuncAttribute, int bytes) {
  emu_smem_limits[reinterpret_cast<const void*>(kernel)] = bytes;
  return cudaSuccess;
}
inline int cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kEmuSms;
  return cudaSuccess;
}
inline int cudaGetLastError() {
  const int e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(int e) { return e ? "launch refused" : "no error"; }

// Refuses what the card refuses (too many threads, too much shared memory
// without the attribute, grid limits), then runs every block in order
// (x fastest). The block's threads are made once per launch: between two
// blocks they meet at the block barrier while thread 0 moves blockIdx on
// and refills shared memory with garbage.
template <typename... KArgs, typename... Args>
void emu_launch(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                cudaStream_t, Args... args) {
  const unsigned nt = block.x * block.y * block.z;
  const auto limit = emu_smem_limits.find(reinterpret_cast<const void*>(kernel));
  if (nt > 1024 || nt % 32 || smem > sizeof(tower_smem) ||
      (smem > 48 * 1024 && (limit == emu_smem_limits.end() || smem > limit->second)) ||
      grid.y > 65535 || grid.z > 65535) {
    emu_error = cudaErrorLaunchFailure;
    return;
  }
  gridDim = grid;
  blockDim = block;
  std::barrier<> bar(nt);
  emu_block_barrier = &bar;
  for (unsigned w = 0; w < nt / 32; ++w) emu_warp_barrier[w] = new std::barrier<>(32);
  const unsigned blocks = grid.x * grid.y * grid.z;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned i = 0; i < blocks; ++i) {
        if (t == 0) {
          blockIdx = dim3(i % grid.x, i / grid.x % grid.y, i / (grid.x * grid.y));
          std::memset(tower_smem, 0xAB, smem);
        }
        bar.arrive_and_wait();
        kernel(args...);
        bar.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
  for (unsigned w = 0; w < nt / 32; ++w) delete emu_warp_barrier[w];
}
