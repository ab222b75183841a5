// Hopper kernels for the reconstruction loss (edge-weighted L1 + masked TV),
// the training objective's non-matmul hot path.
//
// They replace the Pallas TPU kernels of
// srgan_tpu/ops/pallas/recon_loss_kernel.py:
//
//   K1 edge_stats_kernel  <- _edge_stats_kernel (:114)   Sobel +-5 edge map of
//      hr, max(|Kx*hr|, |Ky*hr|), zero padding; per-block sums of e and e^2.
//      edge_stats_finalize turns them into the mean and the Bessel std.
//   K2 loss_sums_kernel   <- _loss_sums_kernel  (:144)   recomputes e, maps it
//      to clip((e-mean)/std*0.2+1, 0, 2); per-block sums of |hr-sr|*e, e and
//      |DIFF*sr|*(1-e). loss_sums_finalize gives edge_loss and relu(tv mean).
//   K3 grad_kernel        <- _grad_kernel       (:188)   d loss / d sr =
//      -sign(hr-sr)*e*c_edge + DIFF (x) (sign(DIFF*sr)*(1-e))*c_tv, with a
//      2-cell halo; hr gets no gradient.
//
// What bounds them on an H100 SXM: bytes. At the flagship shape (HR
// 512x1024, batch 12, C=3, fp32: 75.5 MB per tensor) each reads its inputs
// once and does < 80 flops per element, far under the 67 TFLOP/s fp32 rate:
//
//   kernel  bytes                       bound at 3.35 TB/s
//   K1      75.5 MB (hr)                ~22.5 us
//   K2      151 MB  (hr, sr)            ~45 us
//   K3      226.5 MB (hr, sr, dsr out)  ~68 us
//
// Design. The TPU kernels walk (plane, 128-row strip) on a sequential grid
// and accumulate in SMEM scalars. Here blocks run in parallel: each block
// takes a (row strip x column tile) of one image with all C channels, staged
// in shared memory in the global NHWC order with a 1-cell halo (K1, K2) or
// a 2-cell halo (K3), so the rows it reads are contiguous and coalesced and
// no plane transpose or padding copy is made. Each block writes its partial
// sums to a [n_blocks, k] fp64 buffer; a one-block finalise launch sums them
// in a fixed order. No float atomics: results are the same from run to run.
// The scalars stay on the device (no host sync); K3 reads c_edge and c_tv
// from the incoming gradients in device memory.
//
// Plain C interface for ctypes (srgan_tpu_torch/ops/cuda/recon_loss_kernel.py).
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdTileH = 16;
constexpr int kFwdTileW = 64;
constexpr int kBwdTileH = 16;
constexpr int kBwdTileW = 32;
constexpr int kMaxChannels = 4;

// Stage rows [gy0, gy0+ROWS) x columns [gx0, gx0+COLS) of image b, all C
// channels, into shared memory in the NHWC order: row r holds COLS*C
// floats. Cells outside the image are zero (the stencils' zero padding).
// C and the tile sizes are compile-time, so every index division below is
// a multiply-shift.
template <int C, int ROWS, int COLS>
__device__ void stage_tile(float* __restrict__ s, const float* __restrict__ g,
                           int b, int H, int W, int gy0, int gx0) {
  constexpr int rw = COLS * C;
  for (int i = threadIdx.x; i < ROWS * rw; i += kThreads) {
    const int r = i / rw;
    const int j = i - r * rw;
    const int gy = gy0 + r;
    const int gx = gx0 + j / C;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = g[((int64_t)b * H + gy) * (int64_t)W * C + (int64_t)gx0 * C + j];
    }
    s[i] = v;
  }
}

// p points at a centre cell; RS is the row stride and C the column stride.
template <int C, int RS>
__device__ __forceinline__ float sobel_edge(const float* p) {
  const float a00 = p[-RS - C], a01 = p[-RS], a02 = p[-RS + C];
  const float a10 = p[-C], a12 = p[C];
  const float a20 = p[RS - C], a21 = p[RS], a22 = p[RS + C];
  // SOBEL_X rows are (-5, 0, 5); SOBEL_Y is its transpose
  const float gx = 5.f * ((a02 - a00) + (a12 - a10) + (a22 - a20));
  const float gy = 5.f * ((a20 - a00) + (a21 - a01) + (a22 - a02));
  return fmaxf(fabsf(gx), fabsf(gy));
}

// DIFF_KERNEL: unit centre, -1/8 on the 8 neighbours (symmetric, so its
// correlation equals its convolution: K3 reuses it for the transpose).
template <int C, int RS>
__device__ __forceinline__ float diff_stencil(const float* p) {
  const float ring = p[-RS - C] + p[-RS] + p[-RS + C] + p[-C] + p[C] +
                     p[RS - C] + p[RS] + p[RS + C];
  return p[0] - 0.125f * ring;
}

__device__ __forceinline__ float normalize_edge(float e, float mean, float std) {
  return fminf(fmaxf((e - mean) / std * 0.2f + 1.f, 0.f), 2.f);
}

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// Deterministic tree sum over the block's kThreads threads; every thread
// gets the totals back in v.
template <int K>
__device__ void block_sum(double (&v)[K]) {
  __shared__ double red[K][kThreads];
  for (int k = 0; k < K; ++k) red[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int k = 0; k < K; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + s];
    }
    __syncthreads();
  }
  for (int k = 0; k < K; ++k) v[k] = red[k][0];
}

template <int K>
__device__ void store_partials(double* partials, const double (&v)[K]) {
  if (threadIdx.x == 0) {
    const int64_t blk =
        ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    for (int k = 0; k < K; ++k) partials[blk * K + k] = v[k];
  }
}

template <int K>
__device__ void sum_partials(const double* partials, int n_blocks,
                             double (&v)[K]) {
  for (int k = 0; k < K; ++k) v[k] = 0.0;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) {
    for (int k = 0; k < K; ++k) v[k] += partials[(int64_t)i * K + k];
  }
  block_sum<K>(v);
}

// ---------------------------------------------------------------- K1 ----

template <int C>
__global__ void __launch_bounds__(kThreads)
edge_stats_kernel(const float* __restrict__ hr, int H, int W,
                  double* __restrict__ partials) {
  constexpr int RS = (kFwdTileW + 2) * C;
  constexpr int TW = kFwdTileW * C;
  __shared__ float s_hr[(kFwdTileH + 2) * RS];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kFwdTileH;
  const int x0 = blockIdx.x * kFwdTileW;
  stage_tile<C, kFwdTileH + 2, kFwdTileW + 2>(s_hr, hr, b, H, W, y0 - 1, x0 - 1);
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < kFwdTileH * TW; i += kThreads) {
    const int r = i / TW;
    const int j = i - r * TW;
    if (y0 + r >= H || x0 + j / C >= W) continue;
    const float e = sobel_edge<C, RS>(s_hr + (r + 1) * RS + C + j);
    s1 += e;
    s2 += e * e;
  }
  double v[2] = {s1, s2};
  block_sum<2>(v);
  store_partials<2>(partials, v);
}

// stats = [mean, std, sum(e_normalized), tv mean]; K1 fills the first two
// and zeroes the rest.
__global__ void __launch_bounds__(kThreads)
edge_stats_finalize(const double* __restrict__ partials, int n_blocks,
                    double count, float* __restrict__ stats) {
  double v[2];
  sum_partials<2>(partials, n_blocks, v);
  if (threadIdx.x == 0) {
    const double mean = v[0] / count;
    const double var = (v[1] - count * mean * mean) / (count - 1.0);
    stats[0] = (float)mean;
    stats[1] = (float)sqrt(fmax(var, 0.0));
    stats[2] = 0.f;
    stats[3] = 0.f;
  }
}

// ---------------------------------------------------------------- K2 ----

template <int C>
__global__ void __launch_bounds__(kThreads)
loss_sums_kernel(const float* __restrict__ hr, const float* __restrict__ sr,
                 int H, int W, const float* __restrict__ stats,
                 double* __restrict__ partials) {
  constexpr int RS = (kFwdTileW + 2) * C;
  constexpr int TW = kFwdTileW * C;
  __shared__ float s_hr[(kFwdTileH + 2) * RS];
  __shared__ float s_sr[(kFwdTileH + 2) * RS];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kFwdTileH;
  const int x0 = blockIdx.x * kFwdTileW;
  stage_tile<C, kFwdTileH + 2, kFwdTileW + 2>(s_hr, hr, b, H, W, y0 - 1, x0 - 1);
  stage_tile<C, kFwdTileH + 2, kFwdTileW + 2>(s_sr, sr, b, H, W, y0 - 1, x0 - 1);
  __syncthreads();

  const float mean = stats[0], std = stats[1];
  float wdiff = 0.f, esum = 0.f, tv = 0.f;
  for (int i = threadIdx.x; i < kFwdTileH * TW; i += kThreads) {
    const int r = i / TW;
    const int j = i - r * TW;
    if (y0 + r >= H || x0 + j / C >= W) continue;
    const int o = (r + 1) * RS + C + j;
    const float e = normalize_edge(sobel_edge<C, RS>(s_hr + o), mean, std);
    wdiff += fabsf(s_hr[o] - s_sr[o]) * e;
    esum += e;
    tv += fabsf(diff_stencil<C, RS>(s_sr + o)) * (1.f - e);
  }
  double v[3] = {wdiff, esum, tv};
  block_sum<3>(v);
  store_partials<3>(partials, v);
}

__global__ void __launch_bounds__(kThreads)
loss_sums_finalize(const double* __restrict__ partials, int n_blocks,
                   double count, float* __restrict__ stats,
                   float* __restrict__ edge_loss, float* __restrict__ tv_loss) {
  double v[3];
  sum_partials<3>(partials, n_blocks, v);
  if (threadIdx.x == 0) {
    const double tv_mean = v[2] / count;
    stats[2] = (float)v[1];
    stats[3] = (float)tv_mean;
    *edge_loss = (float)(v[0] / v[1]);
    *tv_loss = (float)fmax(tv_mean, 0.0);
  }
}

// ---------------------------------------------------------------- K3 ----

template <int C>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ hr, const float* __restrict__ sr,
            int H, int W, float count, const float* __restrict__ stats,
            const float* __restrict__ g_edge, const float* __restrict__ g_tv,
            float* __restrict__ dsr) {
  constexpr int IN_ROWS = kBwdTileH + 4;      // inputs: 2-cell halo
  constexpr int RS_IN = (kBwdTileW + 4) * C;
  constexpr int F_ROWS = kBwdTileH + 2;       // field: 1-cell halo
  constexpr int RS_F = (kBwdTileW + 2) * C;
  constexpr int TW = kBwdTileW * C;
  __shared__ float s_hr[IN_ROWS * RS_IN];
  __shared__ float s_sr[IN_ROWS * RS_IN];
  __shared__ float s_inner[F_ROWS * RS_F];
  __shared__ float s_e[F_ROWS * RS_F];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kBwdTileH;
  const int x0 = blockIdx.x * kBwdTileW;
  stage_tile<C, IN_ROWS, kBwdTileW + 4>(s_hr, hr, b, H, W, y0 - 2, x0 - 2);
  stage_tile<C, IN_ROWS, kBwdTileW + 4>(s_sr, sr, b, H, W, y0 - 2, x0 - 2);
  __syncthreads();

  const float mean = stats[0], std = stats[1];
  const float c_edge = g_edge[0] / stats[2];
  const float c_tv = stats[3] > 0.f ? g_tv[0] / count : 0.f;  // relu gate

  // The field sign(DIFF*sr)*(1-e) on the tile plus a 1-cell ring; cells
  // outside the image are zero (no TV term exists there).
  for (int i = threadIdx.x; i < F_ROWS * RS_F; i += kThreads) {
    const int r = i / RS_F;
    const int j = i - r * RS_F;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + j / C;
    float inner = 0.f, e = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int o = (r + 1) * RS_IN + C + j;
      e = normalize_edge(sobel_edge<C, RS_IN>(s_hr + o), mean, std);
      inner = sgn(diff_stencil<C, RS_IN>(s_sr + o)) * (1.f - e);
    }
    s_inner[i] = inner;
    s_e[i] = e;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kBwdTileH * TW; i += kThreads) {
    const int r = i / TW;
    const int j = i - r * TW;
    const int gy = y0 + r;
    if (gy >= H || x0 + j / C >= W) continue;
    const int of = (r + 1) * RS_F + C + j;
    const int oi = (r + 2) * RS_IN + 2 * C + j;
    const float g_tv_v = diff_stencil<C, RS_F>(s_inner + of) * c_tv;
    const float g_e = -sgn(s_hr[oi] - s_sr[oi]) * s_e[of] * c_edge;
    dsr[((int64_t)b * H + gy) * (int64_t)W * C + (int64_t)x0 * C + j] =
        g_e + g_tv_v;
  }
}

dim3 fwd_grid(int B, int H, int W) {
  return dim3((W + kFwdTileW - 1) / kFwdTileW, (H + kFwdTileH - 1) / kFwdTileH,
              B);
}

int fwd_blocks(int B, int H, int W) {
  const dim3 g = fwd_grid(B, H, W);
  return (int)(g.x * g.y * g.z);
}

// Calls fn with std::integral_constant<int, C> for C in 1..kMaxChannels,
// then returns cudaGetLastError().
template <typename Fn>
int with_channels(int B, int H, int W, int C, Fn&& fn) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: fn(std::integral_constant<int, 1>{}); break;
    case 2: fn(std::integral_constant<int, 2>{}); break;
    case 3: fn(std::integral_constant<int, 3>{}); break;
    case 4: fn(std::integral_constant<int, 4>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of K1 and K2: the partials buffers hold 2 and 3 doubles per block.
int recon_fwd_blocks(int B, int H, int W) { return fwd_blocks(B, H, W); }

const char* recon_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int recon_edge_stats(const float* hr, int B, int H, int W, int C,
                     double* partials, float* stats, cudaStream_t stream) {
  const double count = (double)B * H * W * C;
  return with_channels(B, H, W, C, [&](auto c) {
    edge_stats_kernel<decltype(c)::value>
        <<<fwd_grid(B, H, W), kThreads, 0, stream>>>(hr, H, W, partials);
    edge_stats_finalize<<<1, kThreads, 0, stream>>>(
        partials, fwd_blocks(B, H, W), count, stats);
  });
}

int recon_loss_sums(const float* hr, const float* sr, int B, int H, int W,
                    int C, double* partials, float* stats, float* edge_loss,
                    float* tv_loss, cudaStream_t stream) {
  const double count = (double)B * H * W * C;
  return with_channels(B, H, W, C, [&](auto c) {
    loss_sums_kernel<decltype(c)::value>
        <<<fwd_grid(B, H, W), kThreads, 0, stream>>>(hr, sr, H, W, stats,
                                                     partials);
    loss_sums_finalize<<<1, kThreads, 0, stream>>>(
        partials, fwd_blocks(B, H, W), count, stats, edge_loss, tv_loss);
  });
}

int recon_loss_grad(const float* hr, const float* sr, int B, int H, int W,
                    int C, const float* stats, const float* g_edge,
                    const float* g_tv, float* dsr, cudaStream_t stream) {
  const float count = (float)((double)B * H * W * C);
  const dim3 grid((W + kBwdTileW - 1) / kBwdTileW,
                  (H + kBwdTileH - 1) / kBwdTileH, B);
  return with_channels(B, H, W, C, [&](auto c) {
    grad_kernel<decltype(c)::value><<<grid, kThreads, 0, stream>>>(
        hr, sr, H, W, count, stats, g_edge, g_tv, dsr);
  });
}

}  // extern "C"
