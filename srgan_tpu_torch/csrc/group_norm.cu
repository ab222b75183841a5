// Hopper kernels for the model's GroupNorm: flax's nn.GroupNorm, statistics
// in f32 arithmetic over an fp64 reduction, normalise, scale and bias in
// f32, one rounding to the input's dtype (the model's compute dtype, f32 or
// bf16) at the store; and, for channels-last input, its backward.
//
// No TPU kernel is replaced: the JAX package leaves GroupNorm to XLA. Here
// they replace x.float() -> torch.native_group_norm -> .to(compute dtype)
// and that chain's backward. Torch's kernels want NCHW-contiguous f32 input:
// around every norm of a channels-last model they cost a transpose, an f32
// copy of the input (saved for the backward too), and the casts back, and
// every conv after them then got NCHW input, which cuDNN transposed on the
// way into and out of its NHWC kernels. Their moments kernel
// (RowwiseMomentsCUDAKernel) gives each (image, group) row one block: at
// batch 1 that is N*G = 8 blocks for 132 SMs.
//
// What bounds them on an H100 SXM: bytes. The forward reads each element
// twice (the sums, then the normalise) and writes it once, with < 10
// flops; the backward reads x and dy twice and writes dx once. Two layouts:
//
// NCHW (group_norm_stats/finalize/apply; inference on NCHW-contiguous
// input). Rows (n, g) are contiguous: C/G channels of H*W values. Every row
// is cut into chunks of kChunk values, so the card has enough blocks in
// flight whatever the batch (~507 x 8 = 4,056 blocks at a 4K request):
//   - group_norm_stats_kernel: one block a (row, chunk), 1-D grid with the
//     chunk fastest. Each thread issues its kPerThread values as 16-byte
//     loads (8 bf16 or 4 f32) before it sums any, sums x and x^2 in f32 over
//     them in a fixed order, and the block adds the threads' sums in fp64 in
//     a fixed tree (warp shuffles, then the warps in order) into one (sum x,
//     sum x^2) partial a block.
//   - group_norm_finalize_kernel: one block a row adds its partials in a
//     fixed order in fp64 and writes the row's mean and (biased, clamped)
//     variance as flax's _normalize takes them, E[x^2] - E[x]^2.
//   - group_norm_apply_kernel: elementwise over the same (row, chunk)
//     blocks, 16-byte loads issued first, then (x - mean) * rsqrt(var +
//     eps) * scale[c] + bias[c] in f32, rounded once at the store. The
//     channel of a vector comes from one division a vector; a vector that
//     crosses a channel boundary steps to the next channel in the loop.
//
// NHWC (group_norm_nhwc_*; every call on channels-last input, with or
// without a gradient). A pixel's C values are contiguous, so a group's
// values at one pixel are C/G consecutive values: at C = 64, G = 8 in bf16
// one 16-byte vector, and eight neighbouring threads cover a pixel's
// 128-byte row. A block takes a chunk of kIters * pps pixels of one image;
// its threads are pps pixel lanes of vp = ceil(C / V) slots, slot v the V
// channels [vV, vV + V) (V = 16 / sizeof(T)), so thread t reads the t-th
// vector of each of its kIters steps and a warp's loads are contiguous. A
// thread's channels are the same at every step: it keeps its scale, bias,
// mean and rstd in registers, and its sums a channel.
//   - group_norm_nhwc_sums_kernel: each thread sums, a channel, x and x^2
//     (forward) or dy and dy * xhat (backward, xhat = (x - mean) * rstd as
//     the forward computed it) in f32 over its kIters values, the block
//     adds the pixel lanes in order in fp64, and writes one partial a
//     (image, chunk, channel).
//   - group_norm_nhwc_finalize_kernel (forward): one block an (image,
//     group) adds its chunks' partials of the group's channels in a fixed
//     order and writes mean and variance as the NCHW finalise does.
//   - group_norm_nhwc_apply_kernel: y = (x - mean) * (rstd * scale[c]) +
//     bias[c], as the NCHW apply.
//   - group_norm_nhwc_bwd_finalize_kernel: one block an (image, group):
//     A[n, c] = sum dy, B[n, c] = sum dy * xhat over the chunks in order,
//     and the group's coefficients c1 = sum_c scale[c] A[n, c] / M, c2 =
//     sum_c scale[c] B[n, c] / M (M = C/G * H*W values a group);
//     group_norm_nhwc_bwd_params_kernel: dbias[c] = sum_n A[n, c], dscale[c]
//     = sum_n B[n, c], f32, the images in order.
//   - group_norm_nhwc_bwd_apply_kernel: dx = rstd * (scale[c] * dy - c1 -
//     xhat * c2), rounded once to x's dtype, the rounding point of the
//     cast's backward on torch's route.
// The backward saves x in its dtype and the (N, G) mean and variance, no
// f32 copy.
//
// Chunk lengths are constants of the shape, so the partition, and with it
// every sum's order, depends only on the shape: no float atomics, and two
// calls give the same bits. The 16-byte path needs every row (NCHW) or
// pixel (NHWC) to start 16-byte aligned (its length a multiple of the
// vector and aligned tensors); other inputs take the same kernels with
// scalar loads and stores (VEC = false), the same values a thread in the
// same order, so the same bits. The caller picks; the entry points refuse
// the vector path on misaligned input.
//
// Plain C interface for ctypes (srgan_tpu_torch/ops/cuda/group_norm_kernel.py).
// Every entry point returns cudaGetLastError() after its launches.

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

// ------------------------------------------------------------- NHWC ----

constexpr int kIters = 8;  // pixel steps a thread, each pass

// Where a thread of an NHWC block works. The block is chunk (blockIdx.x %
// chunks) of image n; the thread is pixel lane t / vp (idle at pps and
// past) and slot t % vp, the channels [c0, c0 + width). Its i-th value
// vector starts at base + i * step, for i < steps (the pixels inside the
// image).
template <int V>
struct NhwcThread {
  int n, c0, width, steps;
  int64_t base, step;
  __device__ __forceinline__ NhwcThread(int hw, int c, int chunks) {
    const int vp = (c + V - 1) / V, pps = kThreads / vp;
    const int lane = (int)threadIdx.x / vp;
    n = (int)blockIdx.x / chunks;
    c0 = ((int)threadIdx.x % vp) * V;
    width = c - c0 < V ? c - c0 : V;
    const int64_t p = (int64_t)((int)blockIdx.x % chunks) * pps * kIters + lane;
    const int64_t left = lane < pps && p < hw ? (hw - p + pps - 1) / pps : 0;
    steps = left < kIters ? (int)left : kIters;
    base = ((int64_t)n * hw + p) * c + c0;
    step = (int64_t)pps * c;
  }
};

// A slot's values; zero past the thread's channels. VEC: one aligned
// 16-byte access (every pixel starts aligned, and width is V).
template <typename T, int V, bool VEC>
__device__ __forceinline__ Pack<T, V> load_slot(const T* __restrict__ src, int width) {
  Pack<T, V> p;
  if (VEC) {
    p = *reinterpret_cast<const Pack<T, V>*>(src);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p.v[k] = k < width ? src[k] : from_f<T>(0.f);
  }
  return p;
}

template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_slot(T* __restrict__ dst, int width, const Pack<T, V>& p) {
  if (VEC) {
    *reinterpret_cast<Pack<T, V>*>(dst) = p;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k < width) dst[k] = p.v[k];
    }
  }
}

// The (image, group) row of each of a thread's channels (the last channel
// stands in past the end: its values are zero and never stored).
template <int V>
__device__ __forceinline__ void slot_rows(const NhwcThread<V>& th, int c, int cg, int (&row)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = th.c0 + k < c ? th.c0 + k : c - 1;
    row[k] = th.n * (c / cg) + ch / cg;
  }
}

// partials[(blockIdx.x * c + ch) * 2 + {0, 1}] = the block's sums of
// channel ch: (x, x^2), or with BWD (dy, dy * xhat).
template <typename T, bool VEC, bool BWD>
__global__ void __launch_bounds__(kThreads)
group_norm_nhwc_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy, int hw,
                            int c, int cg, int chunks, const float* __restrict__ stats,
                            float eps, double* __restrict__ partials) {
  constexpr int V = 16 / sizeof(T);
  __shared__ __align__(16) float sums[2][kThreads * V];
  const NhwcThread<V> th(hw, c, chunks);
  Pack<T, V> xs[kIters], ds[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (i < th.steps) {
      xs[i] = load_slot<T, V, VEC>(x + th.base + i * th.step, th.width);
      if (BWD) ds[i] = load_slot<T, V, VEC>(dy + th.base + i * th.step, th.width);
    }
  }
  float mean[V], rstd[V];
  if (BWD) {
    int row[V];
    slot_rows<V>(th, c, cg, row);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mean[k] = stats[2 * row[k]];
      rstd[k] = rsqrtf(stats[2 * row[k] + 1] + eps);
    }
  }
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (i >= th.steps) break;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float a = to_f(xs[i].v[k]);
      if (BWD) {
        const float d = to_f(ds[i].v[k]);
        s[k] += d;
        q[k] += d * ((a - mean[k]) * rstd[k]);
      } else {
        s[k] += a;
        q[k] += a * a;
      }
    }
  }
  // 16-byte stores: a thread's V sums are V adjacent floats
#pragma unroll
  for (int k = 0; k < V; k += 4) {
    reinterpret_cast<float4*>(sums[0] + threadIdx.x * V)[k / 4] =
        make_float4(s[k], s[k + 1], s[k + 2], s[k + 3]);
    reinterpret_cast<float4*>(sums[1] + threadIdx.x * V)[k / 4] =
        make_float4(q[k], q[k + 1], q[k + 2], q[k + 3]);
  }
  __syncthreads();
  // channel ch of pixel lane l sits at l * vp * V + ch: the lanes in order
  const int stride = (c + V - 1) / V * V, lanes = kThreads / ((c + V - 1) / V);
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    double a = 0.0, b = 0.0;
    for (int l = 0; l < lanes; ++l) {
      a += sums[0][l * stride + ch];
      b += sums[1][l * stride + ch];
    }
    double* out = partials + 2 * ((int64_t)blockIdx.x * c + ch);
    out[0] = a;
    out[1] = b;
  }
}

// stats[2 * row] = mean, stats[2 * row + 1] = max(0, E[x^2] - mean^2) of
// row = n * groups + g, from its channels' partials, chunk by chunk.
__global__ void __launch_bounds__(kThreads)
group_norm_nhwc_finalize_kernel(const double* __restrict__ partials, int chunks, int c,
                                int cg, double count, float* __restrict__ stats) {
  const int groups = c / cg, n = (int)blockIdx.x / groups, g = (int)blockIdx.x % groups;
  double d[2] = {0.0, 0.0};
  for (int64_t i = threadIdx.x; i < (int64_t)chunks * cg; i += kThreads) {
    const double* p = partials + 2 * (((int64_t)n * chunks + i / cg) * c + g * cg + i % cg);
    d[0] += p[0];
    d[1] += p[1];
  }
  block_sum<2>(d);
  if (threadIdx.x == 0) {
    const double mean = d[0] / count;
    stats[2 * blockIdx.x] = (float)mean;
    stats[2 * blockIdx.x + 1] = (float)fmax(d[1] / count - mean * mean, 0.0);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_nhwc_apply_kernel(const T* __restrict__ x, int hw, int c, int cg, int chunks,
                             const float* __restrict__ stats,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias, float eps,
                             T* __restrict__ y) {
  constexpr int V = 16 / sizeof(T);
  const NhwcThread<V> th(hw, c, chunks);
  Pack<T, V> xs[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (i < th.steps) xs[i] = load_slot<T, V, VEC>(x + th.base + i * th.step, th.width);
  }
  int row[V];
  slot_rows<V>(th, c, cg, row);
  float mean[V], mul[V], add[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = th.c0 + k < c ? th.c0 + k : c - 1;
    mean[k] = stats[2 * row[k]];
    mul[k] = rsqrtf(stats[2 * row[k] + 1] + eps) * scale[ch];
    add[k] = bias[ch];
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (i >= th.steps) break;
    Pack<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = from_f<T>((to_f(xs[i].v[k]) - mean[k]) * mul[k] + add[k]);
    store_slot<T, V, VEC>(y + th.base + i * th.step, th.width, out);
  }
}

// Block row = n * groups + g: ab[(n * c + ch) * 2 + {0, 1}] = (sum dy, sum
// dy * xhat) of channel ch over the image, its chunks in order;
// coef[2 * row + {0, 1}] = sum over the group's channels of scale[ch] * each,
// / count.
__global__ void __launch_bounds__(kThreads)
group_norm_nhwc_bwd_finalize_kernel(const double* __restrict__ partials, int chunks, int c,
                                    int cg, const float* __restrict__ scale, double count,
                                    double* __restrict__ ab, float* __restrict__ coef) {
  __shared__ double part[2][kThreads];
  const int groups = c / cg, n = (int)blockIdx.x / groups, g = (int)blockIdx.x % groups;
  const int t = threadIdx.x;
  double s[2] = {0.0, 0.0};  // this thread's channels' scale * sums
  for (int k0 = 0; k0 < cg; k0 += kThreads) {
    // the block's threads as lanes x width channels: each lane sums every
    // lanes-th chunk
    const int width = cg - k0 < kThreads ? cg - k0 : kThreads, lanes = kThreads / width;
    const int lane = t / width, ch = g * cg + k0 + t % width;
    double a = 0.0, b = 0.0;
    if (lane < lanes) {
      for (int i = lane; i < chunks; i += lanes) {
        const double* p = partials + 2 * (((int64_t)n * chunks + i) * c + ch);
        a += p[0];
        b += p[1];
      }
    }
    part[0][t] = a;
    part[1][t] = b;
    __syncthreads();
    if (t < width) {
      a = b = 0.0;
      for (int l = 0; l < lanes; ++l) {
        a += part[0][l * width + t];
        b += part[1][l * width + t];
      }
      ab[2 * ((int64_t)n * c + ch)] = a;
      ab[2 * ((int64_t)n * c + ch) + 1] = b;
      s[0] += (double)scale[ch] * a;
      s[1] += (double)scale[ch] * b;
    }
    __syncthreads();
  }
  block_sum<2>(s);
  if (t == 0) {
    coef[2 * blockIdx.x] = (float)(s[0] / count);
    coef[2 * blockIdx.x + 1] = (float)(s[1] / count);
  }
}

// dbias[ch] = sum_n ab[n, ch, 0], dscale[ch] = sum_n ab[n, ch, 1], the
// images in order.
__global__ void __launch_bounds__(kThreads)
group_norm_nhwc_bwd_params_kernel(const double* __restrict__ ab, int images, int c,
                                  float* __restrict__ dscale, float* __restrict__ dbias) {
  const int ch = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  if (ch >= c) return;
  double a = 0.0, b = 0.0;
  for (int n = 0; n < images; ++n) {
    a += ab[2 * ((int64_t)n * c + ch)];
    b += ab[2 * ((int64_t)n * c + ch) + 1];
  }
  dbias[ch] = (float)a;
  dscale[ch] = (float)b;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
group_norm_nhwc_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, int hw,
                                 int c, int cg, int chunks,
                                 const float* __restrict__ stats,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ coef, float eps,
                                 T* __restrict__ dx) {
  constexpr int V = 16 / sizeof(T);
  const NhwcThread<V> th(hw, c, chunks);
  Pack<T, V> xs[kIters], ds[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (i < th.steps) {
      xs[i] = load_slot<T, V, VEC>(x + th.base + i * th.step, th.width);
      ds[i] = load_slot<T, V, VEC>(dy + th.base + i * th.step, th.width);
    }
  }
  int row[V];
  slot_rows<V>(th, c, cg, row);
  float mean[V], rstd[V], gam[V], c1[V], c2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = th.c0 + k < c ? th.c0 + k : c - 1;
    mean[k] = stats[2 * row[k]];
    rstd[k] = rsqrtf(stats[2 * row[k] + 1] + eps);
    gam[k] = scale[ch];
    c1[k] = coef[2 * row[k]];
    c2[k] = coef[2 * row[k] + 1];
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (i >= th.steps) break;
    Pack<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = (to_f(xs[i].v[k]) - mean[k]) * rstd[k];
      out.v[k] = from_f<T>(rstd[k] * (gam[k] * to_f(ds[i].v[k]) - c1[k] - xh * c2[k]));
    }
    store_slot<T, V, VEC>(dx + th.base + i * th.step, th.width, out);
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

// NHWC: the chunks an image is cut into (vp slots a pixel take the
// block's threads as pps = kThreads / vp pixel lanes, kIters steps each);
// -1 for a shape the kernels do not take (more slots than threads, or a
// grid past 2^31 blocks)
template <typename T>
int64_t nhwc_chunks(int64_t n, int64_t hw, int64_t c, int64_t groups) {
  constexpr int V = 16 / sizeof(T);
  if (n < 1 || hw < 1 || hw > INT32_MAX || c < 1 || groups < 1 || c % groups) return -1;
  const int64_t vp = (c + V - 1) / V;
  if (vp > kThreads) return -1;
  const int64_t pix = kThreads / vp * kIters;
  const int64_t chunks = (hw + pix - 1) / pix;
  return n * chunks <= INT32_MAX ? chunks : -1;
}

int64_t nhwc_chunks(int dtype, int64_t n, int64_t hw, int64_t c, int64_t groups) {
  switch (dtype) {
    case kF32: return nhwc_chunks<float>(n, hw, c, groups);
    case kBF16: return nhwc_chunks<bf16>(n, hw, c, groups);
    default: return -1;
  }
}

template <typename T>
bool nhwc_aligned(const void* p, int64_t c) {
  return c % (16 / sizeof(T)) == 0 && (uintptr_t)p % 16 == 0;
}

template <typename T>
void launch_nhwc_forward(const void* x, int64_t n, int64_t hw, int c, int groups, int vec,
                         double* partials, float* stats, const float* scale,
                         const float* bias, float eps, void* y, cudaStream_t stream) {
  const int chunks = (int)nhwc_chunks<T>(n, hw, c, groups), cg = c / groups;
  const unsigned blocks = (unsigned)(n * chunks);
  auto sums = vec ? group_norm_nhwc_sums_kernel<T, true, false>
                  : group_norm_nhwc_sums_kernel<T, false, false>;
  sums<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), nullptr, (int)hw, c, cg,
                                        chunks, nullptr, eps, partials);
  group_norm_nhwc_finalize_kernel<<<(unsigned)(n * groups), kThreads, 0, stream>>>(
      partials, chunks, c, cg, (double)cg * (double)hw, stats);
  auto apply = vec ? group_norm_nhwc_apply_kernel<T, true> : group_norm_nhwc_apply_kernel<T, false>;
  apply<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), (int)hw, c, cg, chunks,
                                         stats, scale, bias, eps, static_cast<T*>(y));
}

template <typename T>
void launch_nhwc_backward(const void* x, const void* dy, int64_t n, int64_t hw, int c,
                          int groups, int vec, const float* stats, const float* scale,
                          float eps, double* partials, double* ab, float* coef,
                          float* dscale, float* dbias, void* dx, cudaStream_t stream) {
  const int chunks = (int)nhwc_chunks<T>(n, hw, c, groups), cg = c / groups;
  const unsigned blocks = (unsigned)(n * chunks);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  auto sums = vec ? group_norm_nhwc_sums_kernel<T, true, true>
                  : group_norm_nhwc_sums_kernel<T, false, true>;
  sums<<<blocks, kThreads, 0, stream>>>(xt, dyt, (int)hw, c, cg, chunks, stats, eps, partials);
  group_norm_nhwc_bwd_finalize_kernel<<<(unsigned)(n * groups), kThreads, 0, stream>>>(
      partials, chunks, c, cg, scale, (double)cg * (double)hw, ab, coef);
  group_norm_nhwc_bwd_params_kernel<<<(unsigned)((c + kThreads - 1) / kThreads), kThreads, 0,
                                      stream>>>(ab, (int)n, c, dscale, dbias);
  auto apply = vec ? group_norm_nhwc_bwd_apply_kernel<T, true>
                   : group_norm_nhwc_bwd_apply_kernel<T, false>;
  apply<<<blocks, kThreads, 0, stream>>>(xt, dyt, (int)hw, c, cg, chunks, stats, scale, coef,
                                         eps, static_cast<T*>(dx));
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

// NHWC (channels-last) input: x holds n images of hw pixels of c channels,
// a pixel's channels contiguous; groups of c / groups channels. The chunks
// an image is cut into, or -1 for a shape the kernels refuse. The
// partials hold n x chunks x c x 2 doubles.
int group_norm_nhwc_chunks(int dtype, long long n, long long hw, int c, int groups) {
  return (int)nhwc_chunks(dtype, n, hw, c, groups);
}

// The forward: the sums pass, the finalise into stats (n * groups x 2
// floats: mean, variance) and the apply pass into y, of x's dtype (kF32 or
// kBF16); scale and bias f32. vec: 1 for 16-byte accesses (refused unless c
// is a multiple of 16 bytes' values and x and y are 16-byte aligned), 0
// for scalar ones.
int group_norm_nhwc_forward(const void* x, int dtype, long long n, long long hw, int c,
                            int groups, int vec, double* partials, float* stats,
                            const float* scale, const float* bias, float eps, void* y,
                            cudaStream_t stream) {
  if (nhwc_chunks(dtype, n, hw, c, groups) < 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      if (vec && !(nhwc_aligned<float>(x, c) && nhwc_aligned<float>(y, c))) break;
      launch_nhwc_forward<float>(x, n, hw, c, groups, vec, partials, stats, scale, bias, eps,
                                 y, stream);
      return (int)cudaGetLastError();
    case kBF16:
      if (vec && !(nhwc_aligned<bf16>(x, c) && nhwc_aligned<bf16>(y, c))) break;
      launch_nhwc_forward<bf16>(x, n, hw, c, groups, vec, partials, stats, scale, bias, eps,
                                y, stream);
      return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of group_norm_nhwc_forward at x, from dy (x's layout and
// dtype) and the forward's stats: dx (x's dtype), dscale and dbias (c f32
// each). Scratch: partials as the forward's, ab (n x c x 2 doubles), coef
// (n * groups x 2 floats). vec as for the forward, for x, dy and dx.
int group_norm_nhwc_backward(const void* x, const void* dy, int dtype, long long n,
                             long long hw, int c, int groups, int vec, const float* stats,
                             const float* scale, float eps, double* partials, double* ab,
                             float* coef, float* dscale, float* dbias, void* dx,
                             cudaStream_t stream) {
  if (nhwc_chunks(dtype, n, hw, c, groups) < 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      if (vec && !(nhwc_aligned<float>(x, c) && nhwc_aligned<float>(dy, c) &&
                   nhwc_aligned<float>(dx, c))) break;
      launch_nhwc_backward<float>(x, dy, n, hw, c, groups, vec, stats, scale, eps, partials,
                                  ab, coef, dscale, dbias, dx, stream);
      return (int)cudaGetLastError();
    case kBF16:
      if (vec && !(nhwc_aligned<bf16>(x, c) && nhwc_aligned<bf16>(dy, c) &&
                   nhwc_aligned<bf16>(dx, c))) break;
      launch_nhwc_backward<bf16>(x, dy, n, hw, c, groups, vec, stats, scale, eps, partials,
                                 ab, coef, dscale, dbias, dx, stream);
      return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
