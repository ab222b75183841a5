// Hopper kernels for the reconstruction loss (edge-weighted L1 + masked TV),
// the training objective's non-matmul hot path.
//
// They replace the Pallas TPU kernels of
// srgan_tpu/ops/pallas/recon_loss_kernel.py:
//
//   K1 edge_stats_kernel  <- _edge_stats_kernel (:114)   Sobel +-5 edge map of
//      hr, max(|Kx*hr|, |Ky*hr|), zero padding; per-block sums of e and e^2.
//      partials_totals<2> sums them, edge_stats_finalize turns the totals
//      into the mean and the Bessel std.
//   K2 loss_sums_kernel   <- _loss_sums_kernel  (:144)   recomputes e, maps it
//      to clip((e-mean)/std*0.2+1, 0, 2); per-block sums of |hr-sr|*e, e and
//      |DIFF*sr|*(1-e). partials_totals<3> sums them, loss_sums_finalize
//      gives edge_loss and relu(tv mean).
//   K3 grad_kernel        <- _grad_kernel       (:188)   d loss / d sr =
//      -sign(hr-sr)*e*c_edge + DIFF (x) (sign(DIFF*sr)*(1-e))*c_tv; hr gets
//      no gradient.
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
// All three are streaming row-band stencils. Staged 2-D tiles held them at
// a third of their bound: scalar loads issued only in a staging phase (no
// loads in flight while a block computed or reduced), a 256-thread barrier
// tree in every block (K1: 6,144 of them, and a finalise over as many
// partials), ~20 (K2) and ~37 (K3) shared-memory accesses an element, above
// what the SM's 32 words a clock serve at the bound, and 1.16x / 1.41x
// halo cells. Here:
//   - A warp owns a band of 32 float4 columns of the flat NHWC row (W*C
//     floats), one float4 a lane, and walks down a run of rows. It reads
//     each input row once, by 16-byte loads straight into registers,
//     rows in flight beyond the three it computes on (K2, K3: 3; K1: 7).
//   - Registers carry the vertical window: each lane keeps rows y-1, y, y+1
//     of its 4 floats in a ring of register slots, each new row in the
//     slot of the row it no longer needs, the loop unrolled around the
//     ring so that no moves shift the window. The 3x3 stencils are
//     separable into column sums (Sobel-x and DIFF: the sum of the three
//     rows; Sobel-y: row y+1 minus row y-1) and a horizontal pass over the
//     neighbours +-C floats away (the adjacent pixel, C <= 4), which come
//     from the lane itself or from the adjacent lane by __shfl_up/down.
//     Per element: ~3 shuffles in K1 (two column sums), ~4.5 in K2 (three),
//     ~6 in K3 (and the field's), no shared memory. The three share one
//     Sobel (raw_edge).
//   - K1 reads one tensor where K2 and K3 read two, so with the same ring
//     it would keep half their bytes in flight: ~25 KB an SM at 3 rows
//     ahead and 16 warps, about what 3.35 TB/s needs at ~1 us of loaded
//     DRAM latency. Its ring depth and blocks an SM (kStatsSlots,
//     kStatsBlocksPerSm) are its own: 10 slots, ~56 KB an SM. Timed side
//     by side on an H100 (scripts/torch_k1_variants.py), 8-12 slots and 6
//     slots at 6 blocks an SM land within 1.5 % of each other, 6 slots at
//     4 blocks 4 % slower, 2-3 blocks an SM (longer runs) 2-17 % slower.
//   - K3 forms the field sign(DIFF*sr)*(1-e) of row y when input row y+1
//     arrives, keeps three field rows and e of the row before in
//     registers, and writes dsr row y-1 with 16-byte stores: no second
//     pass and no ring recompute.
//   - Bands overlap by halo lanes: one a side in K1 and K2 (their stencils
//     reach one lane), two in K3 (the field's stencil on top of the
//     inputs'). The warp's end lanes read past it and give garbage; the
//     halo lanes only feed their neighbours. The vertical halo is 2 (K1,
//     K2) or 4 (K3) rows a run of ~40-80 rows.
//   - The launch fills the card once: kBlocksPerSm (K1: kStatsBlocksPerSm)
//     blocks of kBandWarps warps an SM (__launch_bounds__ guarantees they
//     fit). Each band's B*H rows are cut into equal runs, one a warp, a
//     run crossing into the next image where it must; consecutive warps
//     take adjacent bands of the same rows. No tail wave.
//   - Rows must start 16-byte aligned for the float4 path ((W*C) % 4 == 0
//     and 16-byte aligned tensors); other inputs take the same kernel with
//     scalar loads and stores (VEC = false). The caller picks; the entry
//     points refuse the vector path on misaligned input.
// Sums (K1, K2): each lane adds its row's fp32 sums to fp64 accumulators
// every row; then a fixed-order shuffle tree, one shared pass over the
// block's warps, and one partial a block; a one-block totals launch sums
// the ~530 partials in a fixed order into fp64 totals (and the count), and a
// one-thread finalise launch turns totals into the scalars. Training across
// processes sums the ranks' totals between the two (an all_gather, then a
// sum in rank order), so the statistics and losses are the global batch's;
// one process finalises its own. No float atomics: two calls give the same
// bits. The scalars stay on the device (no host sync); K3 reads c_edge and
// c_tv from the incoming gradients and the count from stats, in device
// memory.
//
// The member axis (the vmap pool executor, srgan_tpu_torch/training/
// stacked_pool.py): N generators' SR batches against one HR batch. K1 runs
// once on hr (the shared edge map); K2 and K3 take a member index,
// blockIdx.y, and each member's blocks run the single-member launch's
// partition of its sr (same runs, same fixed-order fp64 sums, one partial a
// block in its own stretch of the partials), so member i's losses and dsr
// are the bits of a launch on sr[i] alone. The totals stage runs one block a
// member, the finalise one thread a member: (N, 4) totals, (N, 5) stats
// (K1's mean, std and count copied into every row, K2's Σe and TV mean per
// member: the relu gate is a member's own), (N,) losses. K3 reads member
// i's stats row and its cotangents g_edge[i], g_tv[i]. The single-member
// entry points are the N = 1 launches of the same kernels.
//
// Plain C interface for ctypes (srgan_tpu_torch/ops/cuda/recon_loss_kernel.py).
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a finalise block
constexpr int kMaxChannels = 4;

// (e - mean) / std * 0.2 + 1, clipped to [0, 2]; scale = 0.2 / std, so
// that the per-element division becomes a multiply
__device__ __forceinline__ float normalize_edge(float e, float mean, float scale) {
  return fminf(fmaxf((e - mean) * scale + 1.f, 0.f), 2.f);
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
    for (int k = 0; k < K; ++k) partials[(int64_t)blockIdx.x * K + k] = v[k];
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

// ------------------------------------------------------------ row bands ----

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBandWarps = 4;                  // warps a block
constexpr int kBandThreads = 32 * kBandWarps;
constexpr int kBlocksPerSm = 4;                // K2, K3 resident: <= 128 registers
// Input rows a lane holds: the window y-1, y, y+1 and the kSlots - 3 rows
// after it, in flight. They sit in a ring of registers, row r in slot
// (r - first row) % kSlots, and the row loop is unrolled kSlots steps, so
// every index is a constant and no register moves shift the window.
constexpr int kSlots = 6;                      // K2, K3
// K1's own: one input ring, so more rows in flight. A build may set them
// (-DK1_SLOTS=, -DK1_BLOCKS_PER_SM=) to time variants side by side.
#ifndef K1_SLOTS
#define K1_SLOTS 10
#endif
#ifndef K1_BLOCKS_PER_SM
#define K1_BLOCKS_PER_SM 4
#endif
constexpr int kStatsSlots = K1_SLOTS;
constexpr int kStatsBlocksPerSm = K1_BLOCKS_PER_SM;
constexpr int kMinRun = 8;                     // rows a warp, at least
constexpr int kSumsHalo = 1;                   // halo lanes a side: K1, K2
constexpr int kGradHalo = 2;                   // K3

// A lane's 4 consecutive floats of one row.
struct V4 {
  float v[4];
};

// Floats [4q, 4q+4) of row r of an image of rw floats a row; zero outside
// the row and for rows outside [0, last] (the stencils' zero padding, and
// no load past what the run needs). VEC: one 16-byte load.
template <bool VEC>
__device__ __forceinline__ V4 load_row(const float* __restrict__ img, int r,
                                       int last, int q, int rw) {
  V4 a = {{0.f, 0.f, 0.f, 0.f}};
  const int j = 4 * q;
  if (r < 0 || r > last || j < 0 || j >= rw) return a;
  const float* p = img + (int64_t)r * rw + j;
  if (VEC) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    a.v[0] = t.x;
    a.v[1] = t.y;
    a.v[2] = t.z;
    a.v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + k < rw) a.v[k] = p[k];
    }
  }
  return a;
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ img, int r, int q,
                                          int rw, const V4& a,
                                          const bool (&own)[4]) {
  if (VEC) {
    // rw % 4 == 0: a lane owns all four floats or none
    if (own[0]) {
      *reinterpret_cast<float4*>(img + (int64_t)r * rw + 4 * q) =
          make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (own[k]) img[(int64_t)r * rw + 4 * q + k] = a.v[k];
    }
  }
}

// Each float's neighbours C floats (one pixel) to the left and to the
// right along the row: from the lane itself or, across the float4's edge,
// from the adjacent lane (C shuffles each way). The warp's end lanes get
// values from the wrong side: they are halo lanes.
template <int C>
__device__ __forceinline__ void row_neighbours(const V4& x, V4& l, V4& r) {
  V4 from_l, from_r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    from_l.v[k] = k >= 4 - C ? __shfl_up_sync(kFull, x.v[k], 1) : 0.f;
    from_r.v[k] = k < C ? __shfl_down_sync(kFull, x.v[k], 1) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    l.v[k] = (k >= C ? x : from_l).v[(k + 4 - C) & 3];
    r.v[k] = (k + C < 4 ? x : from_r).v[(k + C) & 3];
  }
}

// The raw Sobel edge map max(|Kx*hr|, |Ky*hr|) of the centre row of the
// window (rows a, b, c of hr), per float. Two column sums cross lanes.
template <int C>
__device__ __forceinline__ V4 raw_edge(const V4& ha, const V4& hb, const V4& hc) {
  V4 sh, dh;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sh.v[k] = ha.v[k] + hb.v[k] + hc.v[k];
    dh.v[k] = hc.v[k] - ha.v[k];
  }
  V4 shl, shr, dhl, dhr, e;
  row_neighbours<C>(sh, shl, shr);
  row_neighbours<C>(dh, dhl, dhr);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // SOBEL_X rows are (-5, 0, 5); SOBEL_Y is its transpose
    const float gx = 5.f * (shr.v[k] - shl.v[k]);
    const float gy = 5.f * (dhl.v[k] + dh.v[k] + dhr.v[k]);
    e.v[k] = fmaxf(fabsf(gx), fabsf(gy));
  }
  return e;
}

// Per float of the centre row of the window (rows a, b, c of hr and sr):
// the normalised edge map e and DIFF*sr. Three column sums cross lanes.
template <int C>
__device__ __forceinline__ void edge_and_diff(const V4& ha, const V4& hb,
                                              const V4& hc, const V4& sa,
                                              const V4& sb, const V4& sc,
                                              float mean, float scale, V4& e,
                                              V4& d) {
  e = raw_edge<C>(ha, hb, hc);
  V4 ss, ssl, ssr;
#pragma unroll
  for (int k = 0; k < 4; ++k) ss.v[k] = sa.v[k] + sb.v[k] + sc.v[k];
  row_neighbours<C>(ss, ssl, ssr);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e.v[k] = normalize_edge(e.v[k], mean, scale);
    // DIFF_KERNEL: unit centre, -1/8 on the 8 neighbours
    const float ring = (ssl.v[k] + ssr.v[k]) + (sa.v[k] + sc.v[k]);
    d.v[k] = sb.v[k] - 0.125f * ring;
  }
}

// The block's totals of v in thread 0, in a fixed order: a shuffle tree in
// each warp, then the warps in turn.
template <int K>
__device__ __forceinline__ void band_block_sum(double (&v)[K]) {
  __shared__ double red[kBandWarps][K];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], m);
  }
  if (threadIdx.x % 32 == 0) {
    for (int k = 0; k < K; ++k) red[threadIdx.x / 32][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) {
      for (int i = 1; i < kBandWarps; ++i) v[k] += red[i][k];
    }
  }
}

// The current device's SM count, asked of the runtime once a device.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> counts[kMaxDevices];  // 0: not asked yet
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) sms = counts[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = std::max(sms, 1);
    if (cached) counts[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// Each band's B*H rows (its images one after another) cut into equal
// runs, one a warp, so that the launch fills every SM once. Consecutive
// warps take adjacent bands of the same rows: a block reads 4 bands'
// width of each row together, and neighbours share their halo sectors.
struct Runs {
  int blocks;
  int rows;   // a warp's run
  int bands;
};

Runs band_runs(int B, int H, int W, int C, int halo, int blocks_per_sm) {
  const int64_t vecs = ((int64_t)W * C + 3) / 4;
  const int64_t bands = (vecs + 31 - 2 * halo) / (32 - 2 * halo);
  const int64_t rows = (int64_t)B * H;
  const int64_t warps = (int64_t)sm_count() * blocks_per_sm * kBandWarps;
  const int64_t runs = std::max<int64_t>(1, warps / bands);
  const int64_t run = std::max<int64_t>(kMinRun, (rows + runs - 1) / runs);
  const int64_t used = bands * ((rows + run - 1) / run);
  return {(int)((used + kBandWarps - 1) / kBandWarps), (int)run, (int)bands};
}

Runs stats_runs(int B, int H, int W, int C) {
  return band_runs(B, H, W, C, kSumsHalo, kStatsBlocksPerSm);
}

Runs sums_runs(int B, int H, int W, int C) {
  return band_runs(B, H, W, C, kSumsHalo, kBlocksPerSm);
}

// Walks the warp's run of rows: calls seg(band, image, y0, y1) for each
// stretch of it inside one image.
template <typename Seg>
__device__ __forceinline__ void for_each_stretch(int B, int H, int run,
                                                 int bands, Seg&& seg) {
  const int64_t w = (int64_t)blockIdx.x * kBandWarps + threadIdx.x / 32;
  const int band = (int)(w % bands);
  const int64_t rows = (int64_t)B * H;
  int64_t t = w / bands * run;
  const int64_t end = t + run < rows ? t + run : rows;
  while (t < end) {
    const int b = (int)(t / H);
    const int y0 = (int)(t - (int64_t)b * H);
    const int y1 = end - t < H - y0 ? y0 + (int)(end - t) : H;
    seg(band, b, y0, y1);
    t += y1 - y0;
  }
}

// Whether a lane of band-position q, in a warp with halo lanes a side,
// owns each of its 4 floats of a row of rw floats.
__device__ __forceinline__ void owned(int lane, int halo, int q, int rw,
                                      bool (&own)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    own[k] = lane >= halo && lane < 32 - halo && q >= 0 && 4 * q + k < rw;
  }
}

// ---------------------------------------------------------------- K1 ----

template <int C, bool VEC>
__global__ void __launch_bounds__(kBandThreads, kStatsBlocksPerSm)
edge_stats_kernel(const float* __restrict__ hr, int B, int H, int W, int run,
                  int bands, double* __restrict__ partials) {
  constexpr int kOut = 32 - 2 * kSumsHalo;
  const int lane = threadIdx.x % 32;
  const int rw = W * C;
  double v[2] = {0.0, 0.0};
  for_each_stretch(B, H, run, bands, [&](int band, int b, int y0, int y1) {
    const int q = band * kOut - kSumsHalo + lane;
    bool own[4];
    owned(lane, kSumsHalo, q, rw, own);
    const float* hb = hr + (int64_t)b * H * rw;
    const int last = min(y1, H - 1);
    // slot i: row y0 - 1 + i, then every kStatsSlots rows on
    V4 h[kStatsSlots];
#pragma unroll
    for (int i = 0; i < kStatsSlots; ++i) {
      h[i] = load_row<VEC>(hb, y0 - 1 + i, last, q, rw);
    }
    for (int y0s = y0; y0s < y1; y0s += kStatsSlots) {
#pragma unroll
      for (int i = 0; i < kStatsSlots; ++i) {
        const int y = y0s + i;
        if (y >= y1) break;
        const V4 e = raw_edge<C>(h[i], h[(i + 1) % kStatsSlots],
                                 h[(i + 2) % kStatsSlots]);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (own[k]) {
            s1 += e.v[k];
            s2 += e.v[k] * e.v[k];
          }
        }
        v[0] += s1;
        v[1] += s2;
        // row y-1 is done with: its slot takes row y-1+kStatsSlots
        h[i] = load_row<VEC>(hb, y - 1 + kStatsSlots, last, q, rw);
      }
    }
  });
  band_block_sum<2>(v);
  store_partials<2>(partials, v);
}

// The totals stage of K1 and K2: the block partials summed in a fixed order
// into K doubles, and the element count after them. A process group sums the
// ranks' totals (fp64, in rank order) between this stage and the finalise.
// One block a member (blockIdx.x): its n_blocks partials, its K + 1 totals.
template <int K>
__global__ void __launch_bounds__(kThreads)
partials_totals(const double* __restrict__ partials, int n_blocks, double count,
                double* __restrict__ totals) {
  partials += (int64_t)blockIdx.x * n_blocks * K;
  totals += (int64_t)blockIdx.x * (K + 1);
  double v[K];
  sum_partials<K>(partials, n_blocks, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) totals[k] = v[k];
    totals[K] = count;
  }
}

// stats = [mean, std, sum(e_normalized), tv mean, count]; K1's finalise fills
// mean, std and count from its totals [sum e, sum e^2, count] and zeroes the
// rest. The finalises run on one thread of a one-warp launch.
__global__ void edge_stats_finalize(const double* __restrict__ totals,
                                    float* __restrict__ stats) {
  if (threadIdx.x != 0) return;
  const double count = totals[2];
  const double mean = totals[0] / count;
  const double var = (totals[1] - count * mean * mean) / (count - 1.0);
  stats[0] = (float)mean;
  stats[1] = (float)sqrt(fmax(var, 0.0));
  stats[2] = 0.f;
  stats[3] = 0.f;
  stats[4] = (float)count;
}

// ---------------------------------------------------------------- K2 ----

template <int C, bool VEC>
__global__ void __launch_bounds__(kBandThreads, kBlocksPerSm)
loss_sums_kernel(const float* __restrict__ hr, const float* __restrict__ sr,
                 int B, int H, int W, int run, int bands,
                 const float* __restrict__ stats, double* __restrict__ partials) {
  constexpr int kOut = 32 - 2 * kSumsHalo;
  const int lane = threadIdx.x % 32;
  const int rw = W * C;
  // member blockIdx.y: its sr and its stretch of the partials
  sr += (int64_t)blockIdx.y * B * H * rw;
  partials += (int64_t)blockIdx.y * gridDim.x * 3;
  const float mean = stats[0], scale = 0.2f / stats[1];
  double v[3] = {0.0, 0.0, 0.0};
  for_each_stretch(B, H, run, bands, [&](int band, int b, int y0, int y1) {
    const int q = band * kOut - kSumsHalo + lane;
    bool own[4];
    owned(lane, kSumsHalo, q, rw, own);
    const int64_t plane = (int64_t)b * H * rw;
    const float* hb = hr + plane;
    const float* sb = sr + plane;
    const int last = min(y1, H - 1);
    // slot i: row y0 - 1 + i, then every kSlots rows on
    V4 h[kSlots], s[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      h[i] = load_row<VEC>(hb, y0 - 1 + i, last, q, rw);
      s[i] = load_row<VEC>(sb, y0 - 1 + i, last, q, rw);
    }
    for (int y0s = y0; y0s < y1; y0s += kSlots) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int y = y0s + i;
        if (y >= y1) break;
        const int w0 = i, w1 = (i + 1) % kSlots, w2 = (i + 2) % kSlots;
        V4 e, d;
        edge_and_diff<C>(h[w0], h[w1], h[w2], s[w0], s[w1], s[w2], mean, scale, e, d);
        float wdiff = 0.f, esum = 0.f, tv = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (own[k]) {
            wdiff += fabsf(h[w1].v[k] - s[w1].v[k]) * e.v[k];
            esum += e.v[k];
            tv += fabsf(d.v[k]) * (1.f - e.v[k]);
          }
        }
        v[0] += wdiff;
        v[1] += esum;
        v[2] += tv;
        // row y-1 is done with: its slot takes row y-1+kSlots
        h[w0] = load_row<VEC>(hb, y - 1 + kSlots, last, q, rw);
        s[w0] = load_row<VEC>(sb, y - 1 + kSlots, last, q, rw);
      }
    }
  });
  band_block_sum<3>(v);
  store_partials<3>(partials, v);
}

// From K2's totals [sum |hr-sr|*e, sum e, sum tv, count], one thread a
// member: member m's stats row is K1's (base) with its own [2:4]. With one
// member, base may be stats itself.
__global__ void loss_sums_finalize(const double* __restrict__ totals,
                                   const float* base, float* stats,
                                   float* __restrict__ edge_loss,
                                   float* __restrict__ tv_loss, int members) {
  for (int m = threadIdx.x; m < members; m += blockDim.x) {
    const double* t = totals + 4 * m;
    float* s = stats + 5 * m;
    const double tv_mean = t[2] / t[3];
    s[0] = base[0];
    s[1] = base[1];
    s[4] = base[4];
    s[2] = (float)t[1];
    s[3] = (float)tv_mean;
    edge_loss[m] = (float)(t[0] / t[1]);
    tv_loss[m] = (float)fmax(tv_mean, 0.0);
  }
}

// ---------------------------------------------------------------- K3 ----

template <int C, bool VEC>
__global__ void __launch_bounds__(kBandThreads, kBlocksPerSm)
grad_kernel(const float* __restrict__ hr, const float* __restrict__ sr,
            int B, int H, int W, int run, int bands,
            const float* __restrict__ stats, const float* __restrict__ g_edge,
            const float* __restrict__ g_tv, float* __restrict__ dsr) {
  constexpr int kOut = 32 - 2 * kGradHalo;
  const int lane = threadIdx.x % 32;
  const int rw = W * C;
  // member blockIdx.y: its sr, dsr, stats row and cotangents
  const int m = blockIdx.y;
  sr += (int64_t)m * B * H * rw;
  dsr += (int64_t)m * B * H * rw;
  stats += 5 * m;
  const float mean = stats[0], scale = 0.2f / stats[1];
  const float c_edge = g_edge[m] / stats[2];
  const float c_tv = stats[3] > 0.f ? g_tv[m] / stats[4] : 0.f;  // relu gate
  for_each_stretch(B, H, run, bands, [&](int band, int b, int y0, int y1) {
    const int q = band * kOut - kGradHalo + lane;
    bool in_row[4], own[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      in_row[k] = q >= 0 && 4 * q + k < rw;
      own[k] = in_row[k] && lane >= kGradHalo && lane < 32 - kGradHalo;
    }
    const int64_t plane = (int64_t)b * H * rw;
    const float* hb = hr + plane;
    const float* sb = sr + plane;
    const int last = min(y1 + 1, H - 1);
    // slot i: input row y0 - 2 + i, field row y0 - 1 + i, then every
    // kSlots rows on; e of row y in ev[(y - y0 + 1) % 2]
    static_assert(kSlots >= 3 && kSlots % 2 == 0, "field and e rings");
    V4 h[kSlots], s[kSlots], f[kSlots] = {}, ev[2] = {};
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      h[i] = load_row<VEC>(hb, y0 - 2 + i, last, q, rw);
      s[i] = load_row<VEC>(sb, y0 - 2 + i, last, q, rw);
    }
    for (int y0s = y0 - 1; y0s <= y1; y0s += kSlots) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int y = y0s + i;  // the field row this step forms
        if (y > y1) break;
        const int w0 = i, w1 = (i + 1) % kSlots, w2 = (i + 2) % kSlots;
        V4 e, d;
        edge_and_diff<C>(h[w0], h[w1], h[w2], s[w0], s[w1], s[w2], mean, scale, e, d);
        // the field sign(DIFF*sr)*(1-e), zero outside the image (no TV term
        // exists there)
        const bool row_in = y >= 0 && y < H;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          f[w0].v[k] = row_in && in_row[k] ? sgn(d.v[k]) * (1.f - e.v[k]) : 0.f;
        }
        if (y > y0) {  // dsr row y-1: field rows y-2 .. y are complete
          const V4& f0 = f[(i + kSlots - 2) % kSlots];
          const V4& f1 = f[(i + kSlots - 1) % kSlots];
          const V4& f2 = f[w0];
          const V4& e1 = ev[(i + 1) % 2];
          V4 sf, sfl, sfr, out;
#pragma unroll
          for (int k = 0; k < 4; ++k) sf.v[k] = f0.v[k] + f1.v[k] + f2.v[k];
          row_neighbours<C>(sf, sfl, sfr);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // DIFF is symmetric: its transpose is itself
            const float ring = (sfl.v[k] + sfr.v[k]) + (f0.v[k] + f2.v[k]);
            const float g_tv_v = (f1.v[k] - 0.125f * ring) * c_tv;
            const float g_e = -sgn(h[w0].v[k] - s[w0].v[k]) * e1.v[k] * c_edge;
            out.v[k] = g_e + g_tv_v;
          }
          store_row<VEC>(dsr + plane, y - 1, q, rw, out, own);
        }
        ev[i % 2] = e;
        // input row y-1 is done with: its slot takes row y-1+kSlots
        h[w0] = load_row<VEC>(hb, y - 1 + kSlots, last, q, rw);
        s[w0] = load_row<VEC>(sb, y - 1 + kSlots, last, q, rw);
      }
    }
  });
}

// ------------------------------------------------------------- host ----

// The float4 path needs every row to start 16-byte aligned.
bool vector_rows(int W, int C, std::initializer_list<const void*> ptrs) {
  if ((W * C) % 4) return false;
  for (const void* p : ptrs) {
    if ((uintptr_t)p % 16) return false;
  }
  return true;
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

// Blocks of K1: its partials buffer holds 2 doubles per block.
int recon_stats_blocks(int B, int H, int W, int C) {
  return stats_runs(B, H, W, C).blocks;
}

// Blocks of K2: its partials buffer holds 3 doubles per block.
int recon_sums_blocks(int B, int H, int W, int C) {
  return sums_runs(B, H, W, C).blocks;
}

const char* recon_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1 and its totals stage: totals = [sum e, sum e^2, count]. vec: 1 for the
// float4 path (refused unless vector_rows), 0 for scalar loads; the partials
// buffer holds recon_stats_blocks * 2 doubles.
int recon_edge_stats(const float* hr, int B, int H, int W, int C, int vec,
                     double* partials, double* totals, cudaStream_t stream) {
  if (vec && !vector_rows(W, C, {hr})) return (int)cudaErrorInvalidValue;
  const double count = (double)B * H * W * C;
  return with_channels(B, H, W, C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    const Runs runs = stats_runs(B, H, W, kC);
    auto kernel = vec ? edge_stats_kernel<kC, true> : edge_stats_kernel<kC, false>;
    kernel<<<runs.blocks, kBandThreads, 0, stream>>>(hr, B, H, W, runs.rows,
                                                     runs.bands, partials);
    partials_totals<2><<<1, kThreads, 0, stream>>>(partials, runs.blocks, count,
                                                   totals);
  });
}

// K1's finalise: stats (5 floats) from totals, this rank's or the group's.
int recon_edge_stats_finalize(const double* totals, float* stats,
                              cudaStream_t stream) {
  edge_stats_finalize<<<1, 32, 0, stream>>>(totals, stats);
  return (int)cudaGetLastError();
}

// K2 and its totals stage over N members' sr (N, B, H, W, C) against one hr:
// totals = N x [sum |hr-sr|*e, sum e, sum tv, count]. vec as for
// recon_edge_stats; the partials buffer holds N * recon_sums_blocks * 3
// doubles; stats is K1's.
int recon_loss_sums_pooled(const float* hr, const float* sr, int N, int B,
                           int H, int W, int C, int vec, double* partials,
                           const float* stats, double* totals,
                           cudaStream_t stream) {
  if (vec && !vector_rows(W, C, {hr, sr})) return (int)cudaErrorInvalidValue;
  if (N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  const double count = (double)B * H * W * C;
  return with_channels(B, H, W, C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    const Runs runs = sums_runs(B, H, W, kC);
    auto kernel = vec ? loss_sums_kernel<kC, true> : loss_sums_kernel<kC, false>;
    kernel<<<dim3(runs.blocks, N), kBandThreads, 0, stream>>>(
        hr, sr, B, H, W, runs.rows, runs.bands, stats, partials);
    partials_totals<3><<<N, kThreads, 0, stream>>>(partials, runs.blocks, count,
                                                   totals);
  });
}

// The one-member launch: totals = [sum |hr-sr|*e, sum e, sum tv, count].
int recon_loss_sums(const float* hr, const float* sr, int B, int H, int W,
                    int C, int vec, double* partials, const float* stats,
                    double* totals, cudaStream_t stream) {
  return recon_loss_sums_pooled(hr, sr, 1, B, H, W, C, vec, partials, stats,
                                totals, stream);
}

// K2's finalise over N members: edge_loss[m], tv_loss[m] and stats row m
// (N x 5 floats: K1's base stats with member m's [2:4]) from totals.
int recon_loss_sums_finalize_pooled(const double* totals, const float* base,
                                    float* stats, float* edge_loss,
                                    float* tv_loss, int N,
                                    cudaStream_t stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  loss_sums_finalize<<<1, 32, 0, stream>>>(totals, base, stats, edge_loss,
                                           tv_loss, N);
  return (int)cudaGetLastError();
}

// The one-member finalise: edge_loss, tv_loss and stats[2:4] in place.
int recon_loss_sums_finalize(const double* totals, float* stats,
                             float* edge_loss, float* tv_loss,
                             cudaStream_t stream) {
  return recon_loss_sums_finalize_pooled(totals, stats, stats, edge_loss,
                                         tv_loss, 1, stream);
}

// K3 over N members: dsr[m] from sr[m], stats row m and g_edge[m], g_tv[m];
// the count of c_tv is the row's [4], the group's where the stats are.
int recon_loss_grad_pooled(const float* hr, const float* sr, int N, int B,
                           int H, int W, int C, int vec, const float* stats,
                           const float* g_edge, const float* g_tv, float* dsr,
                           cudaStream_t stream) {
  if (vec && !vector_rows(W, C, {hr, sr, dsr})) return (int)cudaErrorInvalidValue;
  if (N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  return with_channels(B, H, W, C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    const Runs runs = band_runs(B, H, W, kC, kGradHalo, kBlocksPerSm);
    auto kernel = vec ? grad_kernel<kC, true> : grad_kernel<kC, false>;
    kernel<<<dim3(runs.blocks, N), kBandThreads, 0, stream>>>(
        hr, sr, B, H, W, runs.rows, runs.bands, stats, g_edge, g_tv, dsr);
  });
}

// The one-member K3.
int recon_loss_grad(const float* hr, const float* sr, int B, int H, int W,
                    int C, int vec, const float* stats, const float* g_edge,
                    const float* g_tv, float* dsr, cudaStream_t stream) {
  return recon_loss_grad_pooled(hr, sr, 1, B, H, W, C, vec, stats, g_edge,
                                g_tv, dsr, stream);
}

}  // extern "C"
