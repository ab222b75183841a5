// Hopper kernels for GroupNorm's forward where no gradient flows through it
// (serving, scoring): flax's nn.GroupNorm, statistics in f32 arithmetic over
// an fp64 reduction, normalise, scale and bias in f32, one rounding to the
// input's dtype (the model's compute dtype, f32 or bf16) at the store.
//
// No TPU kernel is replaced: the JAX package leaves GroupNorm to XLA. Here
// it replaces x.float() -> torch.native_group_norm -> .to(compute dtype),
// whose moments kernel (RowwiseMomentsCUDAKernel) gives each (image, group)
// row one block. At batch 1 that is N*G = 8 blocks for 132 SMs: a 4K
// serving request (LR 540x960, F=64, G=8) has rows of 4.15 M values, and
// each norm took ~3.4 ms to read 133 MB (the f32 copy) that the card
// streams in ~40 us.
//
// What bounds them on an H100 SXM: bytes. Each element is read twice (the
// stats pass, then the apply pass) and written once, with < 10 flops; at
// the serving shape in bf16 that is 3 x 66.4 MB = 199 MB, ~59 us at 3.35
// TB/s. The design cuts every row into chunks of kChunk values, so the
// card has enough blocks in flight whatever the batch:
//   - group_norm_stats_kernel: one block a (row, chunk), 1-D grid with the
//     chunk fastest (~507 x 8 = 4,056 blocks at the serving shape). Each
//     thread issues its kPerThread values as 16-byte loads (8 bf16 or 4
//     f32) before it sums any, sums x and x^2 in f32 over them in a fixed
//     order, and the block adds the threads' sums in fp64 in a fixed tree
//     (warp shuffles, then the warps in order) into one (sum x, sum x^2)
//     partial a block.
//   - group_norm_finalize_kernel: one block a row adds its partials in a
//     fixed order in fp64 and writes the row's mean and (biased, clamped)
//     variance as flax's _normalize takes them, E[x^2] - E[x]^2.
//   - group_norm_apply_kernel: elementwise over the same (row, chunk)
//     blocks, 16-byte loads issued first, then (x - mean) * rsqrt(var +
//     eps) * scale[c] + bias[c] in f32, rounded once at the store. The
//     channel of a vector comes from one division a vector; a vector that
//     crosses a channel boundary steps to the next channel in the loop.
// The chunk length is a constant, so the partition, and with it every
// sum's order, depends only on the shape: no float atomics, and two calls
// give the same bits.
//
// Rows (n, g) are contiguous in NCHW: C/G channels of H*W values. The
// 16-byte path needs every row to start 16-byte aligned (the row length a
// multiple of the vector and aligned tensors); other inputs take the same
// kernels with scalar loads and stores (VEC = false), the same values a
// thread in the same order, so the same bits. The caller picks; the entry
// points refuse the vector path on misaligned input.
//
// Plain C interface for ctypes (srgan_tpu_torch/ops/cuda/group_norm_kernel.py).
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 32;                   // values a thread, each pass
constexpr int kChunk = kThreads * kPerThread;    // 8,192 values a block
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename U>
__device__ __forceinline__ U from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// N elements moved by one load or store of sizeof(E) * N <= 16 bytes.
template <typename E, int N>
struct alignas(sizeof(E) * N) Pack {
  E v[N];
};

// Values [j, j + N) of a row of L values, as floats; zero past the row's
// end. VEC: one aligned load of the whole vector (the row length is a
// multiple of N, so a vector is wholly inside or outside the row).
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ row, int64_t j,
                                         int64_t L, float (&out)[N]) {
  if (VEC) {
    if (j < L) {
      const Pack<T, N> p = *reinterpret_cast<const Pack<T, N>*>(row + j);
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = to_f(p.v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = j + k < L ? to_f(row[j + k]) : 0.f;
  }
}

// The sums of the block's threads in a fixed order, in thread 0's v: a
// shuffle tree within each warp, then the warps in order.
template <int K>
__device__ void block_sum(double (&v)[K]) {
  __shared__ double warp_sums[K][kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(kFull, v[k], o);
  }
  if (threadIdx.x % 32 == 0) {
    for (int k = 0; k < K; ++k) warp_sums[k][threadIdx.x / 32] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) {
      v[k] = 0.0;
      for (int w = 0; w < kWarps; ++w) v[k] += warp_sums[k][w];
    }
  }
}

// The first value of a thread's i-th vector within its chunk: the block's
// threads take adjacent vectors, so a warp's loads are contiguous.
template <int N>
__device__ __forceinline__ int64_t vector_start(int64_t chunk_start, int i) {
  return chunk_start + (int64_t)(i * kThreads + (int)threadIdx.x) * N;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_stats_kernel(const T* __restrict__ x, int64_t L, int chunks,
                        double* __restrict__ partials) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kLoads = kPerThread / N;
  const int64_t row = blockIdx.x / chunks;
  const int64_t start = (int64_t)(blockIdx.x % chunks) * kChunk;
  const T* xr = x + row * L;
  float v[kLoads][N];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) load_vec<T, N, VEC>(xr, vector_start<N>(start, i), L, v[i]);
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s += v[i][k];
      q += v[i][k] * v[i][k];
    }
  }
  double d[2] = {(double)s, (double)q};
  block_sum<2>(d);
  if (threadIdx.x == 0) {
    partials[2 * (int64_t)blockIdx.x] = d[0];
    partials[2 * (int64_t)blockIdx.x + 1] = d[1];
  }
}

// stats[2 * row] = mean, stats[2 * row + 1] = max(0, E[x^2] - mean^2), from
// the row's partials added in chunk order.
__global__ void __launch_bounds__(kThreads)
group_norm_finalize_kernel(const double* __restrict__ partials, int chunks,
                           double n, float* __restrict__ stats) {
  const double* p = partials + 2 * (int64_t)blockIdx.x * chunks;
  double d[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    d[0] += p[2 * i];
    d[1] += p[2 * i + 1];
  }
  block_sum<2>(d);
  if (threadIdx.x == 0) {
    const double mean = d[0] / n;
    stats[2 * blockIdx.x] = (float)mean;
    stats[2 * blockIdx.x + 1] = (float)fmax(d[1] / n - mean * mean, 0.0);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_apply_kernel(const T* __restrict__ x, int64_t L, int chunks, int hw,
                        int groups, int cg, const float* __restrict__ stats,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float eps,
                        T* __restrict__ y) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kLoads = kPerThread / N;
  const int64_t row = blockIdx.x / chunks;
  const int64_t start = (int64_t)(blockIdx.x % chunks) * kChunk;
  const T* xr = x + row * L;
  T* yr = y + row * L;
  float v[kLoads][N];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) load_vec<T, N, VEC>(xr, vector_start<N>(start, i), L, v[i]);
  const float mean = stats[2 * row];
  const float rstd = rsqrtf(stats[2 * row + 1] + eps);
  const float* sc = scale + (row % groups) * cg;
  const float* bi = bias + (row % groups) * cg;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int64_t j = vector_start<N>(start, i);
    if (j >= L) break;  // a thread's vectors ascend: the rest are past the row
    int c = (int)j / hw;
    int next = (c + 1) * hw;  // the first value of channel c + 1
    float mul = rstd * sc[c], add = bi[c];
    Pack<T, N> out;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int jk = (int)j + k;
      if (!VEC && jk >= L) break;
      if (jk >= next) {  // at most one boundary a value: hw >= 1
        ++c;
        next += hw;
        mul = rstd * sc[c];
        add = bi[c];
      }
      out.v[k] = from_f<T>((v[i][k] - mean) * mul + add);
      if (!VEC) yr[jk] = out.v[k];
    }
    if (VEC) *reinterpret_cast<Pack<T, N>*>(yr + j) = out;
  }
}

// ------------------------------------------------------------- host ----

enum Dtype { kF32 = 0, kBF16 = 1 };

bool aligned(const void* p, int64_t L, int n) {
  return L % n == 0 && (uintptr_t)p % 16 == 0;
}

// rows * chunks blocks, each row's values indexable by int
bool valid_shape(int64_t rows, int64_t L) {
  if (rows < 1 || L < 1 || L > INT32_MAX - kChunk) return false;
  return rows * ((L + kChunk - 1) / kChunk) <= INT32_MAX;
}

template <typename T>
void launch_stats(const void* x, int64_t rows, int64_t L, int vec,
                  double* partials, cudaStream_t stream) {
  const int chunks = (int)((L + kChunk - 1) / kChunk);
  auto kernel = vec ? group_norm_stats_kernel<T, true> : group_norm_stats_kernel<T, false>;
  kernel<<<(unsigned)(rows * chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), L, chunks, partials);
}

template <typename T>
void launch_apply(const void* x, int64_t rows, int64_t L, int hw, int groups,
                  int vec, const float* stats, const float* scale,
                  const float* bias, float eps, void* y, cudaStream_t stream) {
  const int chunks = (int)((L + kChunk - 1) / kChunk);
  auto kernel = vec ? group_norm_apply_kernel<T, true> : group_norm_apply_kernel<T, false>;
  kernel<<<(unsigned)(rows * chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), L, chunks, hw, groups, (int)(L / hw), stats,
      scale, bias, eps, static_cast<T*>(y));
}

}  // namespace

extern "C" {

// Chunks a row of L values is cut into: the partials hold 2 doubles each.
int group_norm_chunks(long long L) {
  return (int)((L + kChunk - 1) / kChunk);
}

const char* group_norm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The stats pass over rows rows of L values of x (dtype kF32 or kBF16):
// partials (rows x group_norm_chunks(L) x 2 doubles) = each chunk's
// (sum x, sum x^2). vec: 1 for 16-byte loads (refused unless every row
// starts 16-byte aligned), 0 for scalar loads.
int group_norm_stats(const void* x, int dtype, long long rows, long long L,
                     int vec, double* partials, cudaStream_t stream) {
  if (!valid_shape(rows, L)) return (int)cudaErrorInvalidValue;
  if (vec && !aligned(x, L, 8)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: launch_stats<float>(x, rows, L, vec, partials, stream); break;
    case kBF16: launch_stats<bf16>(x, rows, L, vec, partials, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// stats (rows x 2 floats: mean, variance) from the stats pass's partials.
int group_norm_finalize(const double* partials, long long rows, long long L,
                        float* stats, cudaStream_t stream) {
  if (!valid_shape(rows, L)) return (int)cudaErrorInvalidValue;
  group_norm_finalize_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(
      partials, group_norm_chunks(L), (double)L, stats);
  return (int)cudaGetLastError();
}

// The apply pass: y = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c],
// row r = n * groups + g holding channels g * (L / hw) ... of hw values
// each; x and y of dtype (kF32 or kBF16), scale and bias f32. vec as for
// group_norm_stats, for x and y.
int group_norm_apply(const void* x, int dtype, long long rows, long long L, int hw,
                     int groups, int vec, const float* stats, const float* scale,
                     const float* bias, float eps, void* y, cudaStream_t stream) {
  if (!valid_shape(rows, L) || hw < 1 || L % hw || groups < 1 || rows % groups) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec && !(aligned(x, L, 8) && aligned(y, L, 8))) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      launch_apply<float>(x, rows, L, hw, groups, vec, stats, scale, bias, eps, y, stream);
      break;
    case kBF16:
      launch_apply<bf16>(x, rows, L, hw, groups, vec, stats, scale, bias, eps, y, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
