// Hopper kernels for SwinIR's windowed self-attention (Liang et al.,
// arXiv:2108.10257; the official models/network_swinir.py WindowAttention),
// forward and backward, with the window partition, the cyclic shift and the
// shifted layers' region mask folded into the kernels' addressing.
//
// No TPU kernel is replaced: the JAX package has no attention. Torch's fused
// scaled_dot_product_attention cannot take this shape (a head dim of 30, an
// additive bias a head and a window) and would fall back to its unfused math
// path, which writes every window's 64 x 64 score tile to device memory (50.3
// M scores a layer at batch 32 of 64 x 64 LR images) and whose gemms share
// their names with every Linear of the model. These kernels keep the scores
// on chip and run under names of their own (window_attn_*).
//
// What bounds them on an H100 SXM: bytes. A window of N = 64 tokens does
// 4 N^2 d flops a head forward against 4 N d values moved (q, k, v, O), 128
// flops a value; the card's balance in bf16 is ~295 flops a byte. At
// SwinIR-M's step (32 x 4096 tokens, 6 heads of 30, bf16) the forward moves
// 189 MB (0.056 ms at 3.35 TB/s) and the backward 377 MB (0.113 ms). Two
// designs, picked by qkv's dtype:
//
// bf16: the tensor cores (mma.sync m16n8k16, tower_mma.cuh). Tensor cores
// would round an f32 input to bf16 or TF32, so f32 keeps the CUDA cores.
// The op's contract holds in bf16 too: q, k, v and dO are bf16 already, so
// their products are exact in the f32 accumulators; P and dS are f32
// intermediates, fed to the tensor cores as two bf16 terms each (hi =
// bf16(x), lo = bf16(x - hi), two mmas a product, ~16 bits of mantissa).
// A block takes one head and walks kWindowsPerBlock windows, heads fastest
// in the grid so that the blocks that read one window's token rows run
// together; the block's warps keep their rows' bias in registers for all
// its windows, and the next window's rows are copied into shared memory
// (4-byte cp.async: a head's 30 values are 60 bytes at a 4-byte offset)
// while this one is worked on. Tiles are padded to 32 values and 16-token
// multiples with zeros; padded keys score -inf.
//   - window_attn_fwd_mma_kernel: a warp a slab of 16 query rows: S = q.k^T
//     on the tensor cores, then * scale + bias + mask, the softmax in
//     registers (a row's 64 scores on the 4 lanes of a quad), O = P.v from
//     the accumulators' registers; writes O and the rows' log-sum-exp.
//   - window_attn_bwd_mma_kernel: one pass a (window, head), two warps a
//     slab (a half of the keys each). P is recomputed from the
//     log-sum-exp; dP = dO.v^T; D_i = sum_j P_ij dP_ij (equal to dO_i.O_i,
//     so O is not read); dS = P (dP - D), summed into the block's dBias in
//     registers; P and dS go to shared memory, and each warp then takes 16
//     rows and 16 values of dq = scale dS.k, dk = scale dS^T.q and dv =
//     P^T.dO, the transposed operands through ldmatrix.trans. The block
//     writes its windows' dBias partial.
// What bounds them now is latency: a warp's chain of products, softmax
// and shuffles, with 16 warps on an SM (four blocks forward, two
// backward, by registers and shared memory).
//
// f32: the CUDA cores, the first version of these kernels:
//   - window_attn_fwd_kernel: one block a (window, head), one thread a query
//     token. k and v of the window go to shared memory as f32 rows
//     zero-padded to 32, which every thread reads by 16-byte broadcasts;
//     each thread holds its q row and its 64 scores in registers, S =
//     q.k^T * scale + bias[head] + mask, a softmax in f32, O = P v / l, and
//     writes O and the row's log-sum-exp, never P.
//   - window_attn_bwd_kernel: one block a (head, group of kWindowsPerBlock
//     windows), walked in order. P is recomputed from the saved
//     log-sum-exp. Phase 1, a thread a query row i (q_i, dO_i in registers,
//     k and v shared): dP_ij = dO_i.v_j, dS_ij = P_ij (dP_ij - D_i) with
//     D_i = dO_i.O_i, dq_i = scale * sum_j dS_ij k_j. Phase 2, a thread a
//     key column j (k_j, v_j in registers, q and dO shared), recomputing P
//     and dS by the same products: dk_j = scale * sum_i dS_ij q_i, dv_j =
//     sum_i P_ij dO_i, and dBias[:, j] += dS[:, j] over the group's windows,
//     in shared memory. Each block writes its group's dBias partial; no
//     float atomics.
//   - window_attn_dbias_kernel (both designs): one thread a (head, i, j)
//     adds the groups' partials in order, in fp64.
// The partition depends only on the shape, so two calls give the same bits.
//
// Layout. qkv is the qkv Linear's output (B, H*W, 3C) in image order, C =
// heads * head_dim, [q | k | v] each head-major; O and dO are (B, H*W, C).
// Window w = (b, wy, wx), b slowest, token r = (ty, tx) of the rolled image
// (y, x) = (wy*ws + ty, wx*ws + tx), which reads pixel ((y + shift) % H,
// (x + shift) % W): torch.roll by -shift, window_partition, and back. In a
// shifted layer, tokens of different regions of the rolled image (rows
// [0, H - ws), [H - ws, H - shift), [H - shift, H), and the same in x) add
// -100 to their score, as the official calculate_mask builds it. bias is
// (heads, N, N) f32, the relative position table already gathered.
//
// Plain C interface for ctypes (srgan_tpu_torch/ops/cuda/window_attention_kernel.py).
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tower_mma.cuh"

namespace {

constexpr int kTokens = 64;          // a window's most tokens (window side <= 8)
constexpr int kThreads = kTokens;    // a thread a token
constexpr int kHeadDim = 32;         // the largest head dim taken; rows are zero-padded to it
constexpr int kVec = kHeadDim / 4;   // float4s a row
constexpr int kWindowsPerBlock = 8;  // windows a block walks for its head (not the f32 forward)
constexpr float kMaskValue = -100.f;
constexpr int kMaxDevices = 64;

enum { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

struct Geometry {
  int batch, height, width, window, shift, heads, head_dim;
  float scale;
};

// The region (0, 1, 2) of rolled coordinate y of an extent of size.
__device__ __forceinline__ int region(int y, int size, const Geometry& g) {
  return y < size - g.window ? 0 : (y < size - g.shift ? 1 : 2);
}

// Token r of window w: its row in the (B * H * W) token rows, and its region
// label in a shifted layer (0 in a plain one).
__device__ __forceinline__ long long token_row(const Geometry& g, long long w, int r,
                                               int* label) {
  const int nx = g.width / g.window, ny = g.height / g.window;
  const long long b = w / ((long long)nx * ny);
  const int rem = (int)(w - b * nx * ny);
  const int y = rem / nx * g.window + r / g.window;
  const int x = rem % nx * g.window + r % g.window;
  *label = g.shift ? region(y, g.height, g) * 3 + region(x, g.width, g) : 0;
  const int sy = (y + g.shift) % g.height, sx = (x + g.shift) % g.width;
  return (b * g.height + sy) * g.width + sx;
}

// a.b over a row held in registers and a row of shared memory, 16 bytes a
// load (every thread of the block reads the same row: one broadcast each)
__device__ __forceinline__ float dot(const float* a, const float* row) {
  const float4* b = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float4 v = b[k];
    s = fmaf(a[4 * k], v.x, s);
    s = fmaf(a[4 * k + 1], v.y, s);
    s = fmaf(a[4 * k + 2], v.z, s);
    s = fmaf(a[4 * k + 3], v.w, s);
  }
  return s;
}

// acc += c * row, the row in shared memory
__device__ __forceinline__ void axpy(float c, const float* row, float* acc) {
  const float4* b = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float4 v = b[k];
    acc[4 * k] = fmaf(c, v.x, acc[4 * k]);
    acc[4 * k + 1] = fmaf(c, v.y, acc[4 * k + 1]);
    acc[4 * k + 2] = fmaf(c, v.z, acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(c, v.w, acc[4 * k + 3]);
  }
}

// Score (i, j) of a window: q_i.k_j * scale + bias + the mask, q_i in
// registers, k_j a shared row. The forward and both phases of the backward
// compute every score by this one function, the same products in the same
// order (a row in registers or in shared memory holds the same floats).
__device__ __forceinline__ float score(const float* q_i, const float* k_j, float bias,
                                       bool same_region, const Geometry& g) {
  const float s = fmaf(dot(q_i, k_j), g.scale, bias);
  return same_region ? s : s + kMaskValue;
}

// One head's d values of a token row, zero-padded to kHeadDim. Every
// loop over a row's values runs to the constant kHeadDim (a bound of d would
// index the register arrays at run time and put them in local memory).
__device__ __forceinline__ void load_row(const float* src, int d, float* dst) {
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k) dst[k] = k < d ? src[k] : 0.f;
}

__device__ __forceinline__ void store_row(const float* src, float* dst) {
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k) dst[k] = src[k];
}

__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                           Geometry g, float* __restrict__ out, float* __restrict__ lse) {
  __shared__ __align__(16) float s_k[kTokens][kHeadDim];
  __shared__ __align__(16) float s_v[kTokens][kHeadDim];
  __shared__ int s_label[kTokens];
  const long long w = blockIdx.x;
  const int h = blockIdx.y, i = threadIdx.x;
  const int n = g.window * g.window, d = g.head_dim, c = g.heads * d;
  float q[kHeadDim], row_buf[kHeadDim];
  long long row = 0;
  int label = 0;
  if (i < n) {
    row = token_row(g, w, i, &label);
    const float* src = qkv + row * 3 * c + h * d;
    load_row(src, d, q);
    load_row(src + c, d, row_buf);
    store_row(row_buf, s_k[i]);
    load_row(src + 2 * c, d, row_buf);
    store_row(row_buf, s_v[i]);
    s_label[i] = label;
  }
  __syncthreads();
  if (i >= n) return;
  const float* b_row = bias + ((long long)h * n + i) * n;
  float p[kTokens];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTokens; ++j)
    if (j < n) {
      p[j] = score(q, s_k[j], b_row[j], s_label[j] == label, g);
      m = fmaxf(m, p[j]);
    }
  float l = 0.f;
  float o[kHeadDim];
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k) o[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kTokens; ++j)
    if (j < n) {
      const float e = expf(p[j] - m);
      l += e;
      axpy(e, s_v[j], o);
    }
  const float inv = 1.f / l;
  float* dst = out + row * c + h * d;
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k)
    if (k < d) dst[k] = o[k] * inv;
  lse[(w * g.heads + h) * n + i] = m + logf(l);
}

// The two phases share two arrays of shared rows: k and v while each thread
// walks its query row (phase 1), then q and dO while it walks its key column
// (phase 2). dBias's column of each thread is in shared memory, [r][j] with
// j the thread: the threads of a warp touch consecutive words.
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ out,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ bias, Geometry g, long long windows,
                           float* __restrict__ dqkv, float* __restrict__ partials) {
  __shared__ __align__(16) float s_a[kTokens][kHeadDim];
  __shared__ __align__(16) float s_b[kTokens][kHeadDim];
  __shared__ float s_dbias[kTokens][kTokens];
  __shared__ float s_lse[kTokens];
  __shared__ float s_delta[kTokens];
  __shared__ int s_label[kTokens];
  const int h = blockIdx.y, i = threadIdx.x;
  const int n = g.window * g.window, d = g.head_dim, c = g.heads * d;
  const float* bias_h = bias + (long long)h * n * n;
  for (int r = 0; r < kTokens; ++r) s_dbias[r][i] = 0.f;
  for (int t = 0; t < kWindowsPerBlock; ++t) {
    const long long w = (long long)blockIdx.x * kWindowsPerBlock + t;
    if (w >= windows) break;  // the same for every thread of the block
    long long row = 0;
    int label = 0;
    float x[kHeadDim], y[kHeadDim], acc[kHeadDim];  // q_i and dO_i, then k_i and v_i
    if (i < n) {
      row = token_row(g, w, i, &label);
      const float* src = qkv + row * 3 * c + h * d;
      load_row(src + c, d, acc);
      store_row(acc, s_a[i]);
      load_row(src + 2 * c, d, acc);
      store_row(acc, s_b[i]);
      load_row(src, d, x);
      load_row(dout + row * c + h * d, d, y);
      load_row(out + row * c + h * d, d, acc);
      float delta = 0.f;
#pragma unroll
      for (int k = 0; k < kHeadDim; ++k) delta = fmaf(y[k], acc[k], delta);
      s_delta[i] = delta;
      s_lse[i] = lse[(w * g.heads + h) * n + i];
      s_label[i] = label;
    }
    __syncthreads();
    float* dq = dqkv + row * 3 * c + h * d;
    if (i < n) {
      // phase 1: query row i: dq_i = scale * sum_j dS_ij k_j
#pragma unroll
      for (int k = 0; k < kHeadDim; ++k) acc[k] = 0.f;
      const float lse_i = s_lse[i], delta_i = s_delta[i];
      for (int j = 0; j < n; ++j) {
        const float p = expf(score(x, s_a[j], bias_h[i * n + j], s_label[j] == label, g) - lse_i);
        const float ds = p * (dot(y, s_b[j]) - delta_i);
        axpy(ds, s_a[j], acc);
      }
#pragma unroll
      for (int k = 0; k < kHeadDim; ++k)
        if (k < d) dq[k] = acc[k] * g.scale;
    }
    __syncthreads();  // every thread is done with k and v
    if (i < n) {
      store_row(x, s_a[i]);
      store_row(y, s_b[i]);
    }
    __syncthreads();
    if (i < n) {
      // phase 2: key column i: dk_i = scale * sum_r dS_ri q_r, dv_i = sum_r
      // P_ri dO_r, dBias[:, i] += dS[:, i]
      const float* src = qkv + row * 3 * c + h * d;
      load_row(src + c, d, x);
      load_row(src + 2 * c, d, y);
      float dv[kHeadDim];
#pragma unroll
      for (int k = 0; k < kHeadDim; ++k) acc[k] = dv[k] = 0.f;
      for (int r = 0; r < n; ++r) {
        // score(q_r, k_i): the same products as phase 1's, a*b == b*a
        const float p = expf(score(x, s_a[r], bias_h[r * n + i], s_label[r] == label, g) -
                             s_lse[r]);
        const float ds = p * (dot(y, s_b[r]) - s_delta[r]);
        axpy(ds, s_a[r], acc);
        axpy(p, s_b[r], dv);
        s_dbias[r][i] += ds;
      }
#pragma unroll
      for (int k = 0; k < kHeadDim; ++k)
        if (k < d) {
          dq[c + k] = acc[k] * g.scale;
          dq[2 * c + k] = dv[k];
        }
    }
    __syncthreads();  // before the next window overwrites shared memory
  }
  if (i < n) {
    float* dst = partials + ((long long)blockIdx.x * g.heads + h) * n * n + i;
    for (int r = 0; r < n; ++r) dst[r * n] = s_dbias[r][i];
  }
}

__global__ void __launch_bounds__(256)
    window_attn_dbias_kernel(const float* __restrict__ partials, int groups, int size,
                             float* __restrict__ dbias) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= size) return;
  double s = 0.0;
  for (int b = 0; b < groups; ++b) s += (double)partials[(long long)b * size + e];
  dbias[e] = (float)s;
}

// ------------------------------------------------------------------------
// The tensor-core route (bf16 qkv). A block takes one head and walks
// kWindowsPerBlock windows; a slab of 16 query rows of a window is one
// warp's in the forward and two warps' in the backward. Shared memory holds
// each window's q, k, v (and dO) rows of the head as bf16 tiles, rows padded
// to 32 values with zeros, and the token rows padded to a multiple of 16;
// the next window's tiles are copied in (cp.async) while the warps work on
// this one. Each warp keeps its rows' bias in registers in the accumulator
// layout, loaded once for the block's windows.

constexpr int kSlab = 16;     // rows a warp takes: an mma tile's rows
// bf16 a tile row: 80 bytes, so that the 8 rows an ldmatrix reads hit
// distinct banks; a row of P or dS: 144 bytes, likewise
constexpr int kStride = 40;
constexpr int kPStride = 72;
constexpr int kTileBytes = kTokens * kStride * 2;
constexpr int kPBytes = kTokens * kPStride * 2;

// Byte offsets of shared memory: the tiles of two windows ([2][kParts]
// [kTokens][kStride] bf16), for the backward P hi, P lo, dS hi and dS lo
// ([kTokens][kPStride] bf16 each), then the token rows ([2][kTokens] long long),
// region labels ([2][kTokens] int), whether each window's regions are mixed
// ([2] int) and, for the backward, the rows' log-sum-exp ([2][kTokens]
// float) and the two halves of each row's D ([2][kTokens] float).
template <int kParts, bool kBackward>
struct MmaSmem {
  static constexpr int kP = 2 * kParts * kTileBytes;
  static constexpr int kRows = kP + (kBackward ? 4 * kPBytes : 0);
  static constexpr int kLabels = kRows + 2 * kTokens * 8;
  static constexpr int kMixed = kLabels + 2 * kTokens * 4;
  static constexpr int kLse = kMixed + 2 * 4;
  static constexpr int kDelta = kLse + (kBackward ? 2 * kTokens * 4 : 0);
  static constexpr int kBytes = kDelta + (kBackward ? 2 * kTokens * 4 : 0);
};

// (lo, hi) rounded to bf16 and packed, lo in the low half (one cvt)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo + O(2^-16 x): each an operand of its own mma, so that an f32
// intermediate (P, dS) enters a product with about 16 bits of mantissa
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = bf16_pair(a, b);
  lo = bf16_pair(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

// The A fragments (hi and lo) of k-step kk from a 16 x 64 tile held in the
// accumulator layout, x[j] the n-tile of columns 8j..8j+7
__device__ __forceinline__ void a_from_acc(const float (&x)[kTokens / 8][4], int kk,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pair(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split_pair(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split_pair(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split_pair(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// Values col, col + 1 of a head's row in device memory, col < d; a pair
// fits whole where `pairs` (d even)
__device__ __forceinline__ void store_pair(bf16* dst, int col, int d, bool pairs, float a,
                                           float b) {
  if (col >= d) return;
  if (pairs) {
    *reinterpret_cast<uint32_t*>(dst + col) = bf16_pair(a, b);
  } else {
    dst[col] = __float2bfloat16(a);
    if (col + 1 < d) dst[col + 1] = __float2bfloat16(b);
  }
}

// A window's place: image b, row wy and column wx of windows
struct WindowPos {
  int b, wy, wx;
};

__device__ __forceinline__ WindowPos window_pos(const Geometry& g, long long w) {
  const int nx = g.width / g.window, ny = g.height / g.window;
  const long long b = w / ((long long)nx * ny);
  const int rem = (int)(w - b * nx * ny);
  return {(int)b, rem / nx, rem % nx};
}

// the next window, row-major within an image
__device__ __forceinline__ void next_window(const Geometry& g, WindowPos& p) {
  if (++p.wx == g.width / g.window) {
    p.wx = 0;
    if (++p.wy == g.height / g.window) {
      p.wy = 0;
      ++p.b;
    }
  }
}

// The window's token rows and region labels, as token_row gives them, into
// one slot of the tables, a thread a token, and whether its regions are
// mixed: in a shifted layer, the windows of the rolled image's last row or
// column of windows (elsewhere every token is of region 0)
__device__ __forceinline__ void window_rows(const Geometry& g, const WindowPos& p, int n,
                                            long long* s_row, int* s_label, int* s_mixed) {
  const int r = threadIdx.x;
  if (r == 0)
    *s_mixed = g.shift && (p.wy == g.height / g.window - 1 || p.wx == g.width / g.window - 1);
  if (r >= n) return;
  const int y = p.wy * g.window + r / g.window, x = p.wx * g.window + r % g.window;
  s_label[r] = g.shift ? region(y, g.height, g) * 3 + region(x, g.width, g) : 0;
  const int sy = y + g.shift < g.height ? y + g.shift : y + g.shift - g.height;
  const int sx = x + g.shift < g.width ? x + g.shift : x + g.shift - g.width;
  s_row[r] = ((long long)p.b * g.height + sy) * g.width + sx;
}

// The head's values of the window's token rows into the tiles of one
// buffer, a warp a token row at a time, a lane a unit: part p < 3 is q, k
// or v of qkv, part 3 (the backward's) dO. A unit is 4 bytes copied by
// cp.async where `pairs` (an even d and 4-byte aligned tensors), else one
// value copied at once.
template <int kParts>
__device__ __forceinline__ void load_tiles(const bf16* qkv, const bf16* dout, const Geometry& g,
                                           int h, int n, bool pairs, const long long* s_row,
                                           bf16* tiles) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int d = g.head_dim, c = g.heads * d, per = pairs ? 2 : 1, units = d / per;
  // this lane's units k of every token row (at most 4 x 32 = 4 parts x 32
  // values): source, pitch and tile offset, or -1 past the parts
  const bf16* src[4];
  int pitch[4], dst[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int u = lane + 32 * k, p = u / units, e = (u - p * units) * per;
    dst[k] = p < kParts ? p * kTokens * kStride + e : -1;
    src[k] = p < 3 ? qkv + p * c + h * d + e : p < kParts ? dout + h * d + e : qkv;
    pitch[k] = p < 3 ? 3 * c : c;
  }
  for (int r = warp; r < n; r += warps) {
    const long long row = s_row[r];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (dst[k] < 0) continue;
      bf16* to = tiles + dst[k] + r * kStride;
      const bf16* from = src[k] + row * pitch[k];
      if (pairs) {
        cp_async_4(to, from);
      } else {
        *to = *from;
      }
    }
  }
}

// Zero the tiles of both buffers: their padding stays zero, as the loads
// write only the n x d values (a padded key's v row must be finite: its P is
// 0, and 0 x NaN is NaN)
__device__ __forceinline__ void clear_tiles(bf16* tiles, int bytes) {
  uint32_t* words = reinterpret_cast<uint32_t*>(tiles);
  for (int e = threadIdx.x; e < bytes / 4; e += blockDim.x) words[e] = 0u;
}

// bias[h] at this lane's places of its warp's score tile, rows i0..i0+15
// and keys j0..j0 + 8 kTiles - 1 (0 past n)
template <int kTiles>
__device__ __forceinline__ void load_bias(const float* bias, int h, int n, int i0, int j0,
                                          float (&b)[kTiles][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + lane / 4 + 8 * (e / 2), col = j0 + 8 * j + 2 * (lane % 4) + e % 2;
      b[j][e] = i < n && col < n ? bias[((long long)h * n + i) * n + col] : 0.f;
    }
}

// The warp's scores q_i.k_j * scale + bias (+ the mask between regions),
// rows i0..i0+15 and keys j0..j0 + 8 tiles - 1, -inf at padded keys, in the
// accumulator layout: s[j] is the n-tile of keys j0 + 8j.., s[j][0..1] row
// i0 + lane / 4, s[j][2..3] row i0 + lane / 4 + 8, keys j0 + 8j + 2 (lane %
// 4) + (0, 1); -inf in the tiles from `tiles` on. The labels are read only
// where the window's regions are `mixed`.
template <int kTiles>
__device__ __forceinline__ void scores(const bf16* s_q, const bf16* s_k, const int* s_label,
                                       bool mixed, const float (&bias)[kTiles][4], int i0,
                                       int j0, int tiles, int n, const Geometry& g,
                                       float (&s)[kTiles][4]) {
  const int lane = threadIdx.x % 32;
  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldmatrix_x4(qa[ks], s_q + (i0 + lane % 16) * kStride + 16 * ks + 8 * (lane / 16));
  const int label0 = mixed ? s_label[i0 + lane / 4] : 0;
  const int label1 = mixed ? s_label[i0 + lane / 4 + 8] : 0;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < tiles) {
      // keys j0 + 8j.. by 4 x 8 values: B of both k-steps
      uint32_t kb[4];
      ldmatrix_x4(kb, s_k + (j0 + 8 * j + lane % 8) * kStride + 8 * (lane / 8));
      mma_bf16_16816(acc, qa[0], kb[0], kb[1]);
      if (g.head_dim > 16) mma_bf16_16816(acc, qa[1], kb[2], kb[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j0 + 8 * j + 2 * (lane % 4) + e % 2;
      float v = fmaf(acc[e], g.scale, bias[j][e]);
      if (mixed && col < n && s_label[col] != (e < 2 ? label0 : label1)) v += kMaskValue;
      s[j][e] = col < n && j < tiles ? v : -INFINITY;
    }
  }
}

// The sum of v over the quad of lanes that holds a row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// acc += A . X[:, 16 dh0 .. 16 (dh0 + kHalves) - 1] over the padded tokens:
// A the warp's 16 x npad tile, given a k-step at a time by `a_frag(kk, hi,
// lo)` as its hi and lo terms, X (npad x 32) a tile of shared rows read by
// ldmatrix.trans; acc[n] is the n-tile of values 16 dh0 + 8n..
template <int kHalves, typename AFrag>
__device__ __forceinline__ void product(AFrag a_frag, const bf16* x, int npad, int dh0, int d,
                                        float (&acc)[2 * kHalves][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < kTokens / 16; ++kk) {
    if (16 * kk >= npad) break;
    uint32_t hi[4], lo[4];
    a_frag(kk, hi, lo);
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) {
      const int dh = dh0 + hh;
      if (16 * dh >= d) break;
      uint32_t xb[4];
      ldmatrix_x4_trans(xb, x + (16 * kk + lane % 8 + 8 * (lane / 8 % 2)) * kStride + 16 * dh +
                                8 * (lane / 16));
      mma_bf16_16816(acc[2 * hh], hi, xb[0], xb[1]);
      mma_bf16_16816(acc[2 * hh], lo, xb[0], xb[1]);
      mma_bf16_16816(acc[2 * hh + 1], hi, xb[2], xb[3]);
      mma_bf16_16816(acc[2 * hh + 1], lo, xb[2], xb[3]);
    }
  }
}

// Rows i0 + lane / 4 (+ 8) of an accumulator tile of values col0.., times
// `scale`, to head h's values of their token rows (pitch elements apart)
template <int kTilesD>
__device__ __forceinline__ void store_rows(const float (&acc)[kTilesD][4], float scale, int i0,
                                           int col0, int n, const long long* s_row, bf16* base,
                                           long long pitch, int d, bool pairs) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + lane / 4 + 8 * half;
    if (i >= n) continue;
    bf16* dst = base + s_row[i] * pitch;
#pragma unroll
    for (int dt = 0; dt < kTilesD; ++dt)
      store_pair(dst, col0 + 8 * dt + 2 * (lane % 4), d, pairs, acc[dt][2 * half] * scale,
                 acc[dt][2 * half + 1] * scale);
  }
}

// four blocks an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kTokens * 2, 4)
    window_attn_fwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                               Geometry g, long long windows, bool pairs, bf16* __restrict__ out,
                               float* __restrict__ lse) {
  using S = MmaSmem<3, false>;
  unsigned char* smem = dynamic_smem();
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  long long* s_row = reinterpret_cast<long long*>(smem + S::kRows);
  int* s_label = reinterpret_cast<int*>(smem + S::kLabels);
  int* s_mixed = reinterpret_cast<int*>(smem + S::kMixed);
  const int h = blockIdx.x % g.heads, lane = threadIdx.x % 32;
  const long long w0 = (long long)(blockIdx.x / g.heads) * kWindowsPerBlock;
  const int count = (int)min((long long)kWindowsPerBlock, windows - w0);
  const int n = g.window * g.window, npad = (n + kSlab - 1) / kSlab * kSlab;
  const int d = g.head_dim, c = g.heads * d, i0 = threadIdx.x / 32 * kSlab;
  clear_tiles(tiles, S::kP);
  float bias_r[kTokens / 8][4];
  load_bias(bias, h, n, i0, 0, bias_r);
  __syncthreads();
  WindowPos pos = window_pos(g, w0);
  window_rows(g, pos, n, s_row, s_label, s_mixed);
  __syncthreads();
  load_tiles<3>(qkv, nullptr, g, h, n, pairs, s_row, tiles);
  cp_async_commit();
  for (int t = 0; t < count; ++t) {
    const int b = t & 1;
    if (t + 1 < count) {  // the next window's copies, into the other buffer
      next_window(g, pos);
      window_rows(g, pos, n, s_row + (b ^ 1) * kTokens, s_label + (b ^ 1) * kTokens,
                  s_mixed + (b ^ 1));
      __syncthreads();
      load_tiles<3>(qkv, nullptr, g, h, n, pairs, s_row + (b ^ 1) * kTokens,
                    tiles + (b ^ 1) * 3 * kTokens * kStride);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this window's copies have landed
    __syncthreads();
    const bf16* s_q = tiles + b * 3 * kTokens * kStride;
    const long long* rows = s_row + b * kTokens;
    float s[kTokens / 8][4];
    scores(s_q, s_q + kTokens * kStride, s_label + b * kTokens, s_mixed[b] != 0, bias_r, i0, 0,
           npad / 8, n, g, s);
    float m[2], l[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTokens / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      m[half] = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTokens / 8; ++j)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[j][e] = expf(s[j][e] - m[half]);
          sum += s[j][e];
        }
      l[half] = quad_sum(sum);
    }
    float o[4][4] = {};
    product<2>([&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) { a_from_acc(s, kk, hi, lo); },
               s_q + 2 * kTokens * kStride, npad, 0, d, o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float inv = 1.f / l[half];
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        o[dt][2 * half] *= inv;
        o[dt][2 * half + 1] *= inv;
      }
      const int i = i0 + lane / 4 + 8 * half;
      if (i < n && lane % 4 == 0)
        lse[((w0 + t) * g.heads + h) * n + i] = m[half] + logf(l[half]);
    }
    store_rows(o, 1.f, i0, 0, n, rows, out + h * d, c, d, pairs);
    __syncthreads();  // before the next copies overwrite this buffer
  }
}

// One pass a (window, head), eight warps a window of 64 tokens (two a
// slab of 16 query rows). Phase 1: the warp of rows i0..i0+15 and keys
// j0..j0+31 recomputes its scores, P = exp(S - lse) and dP = dO.v^T; D_i =
// sum_j P_ij dP_ij (= dO_i.O_i, without reading O) adds the two warps'
// halves of the row through shared memory in a fixed order; dS = P (dP -
// D) goes to the block's dBias (registers), and P and dS to shared memory
// (hi and lo). Phase 2: the warp of slab r0 and 16 of the head's values
// computes dq = scale dS.k, dk = scale dS^T.q and dv = P^T.dO for those
// rows and values, A from shared memory (the transposed ones by
// ldmatrix.trans). Two blocks an SM (shared memory): at most 128 registers.
__global__ void __launch_bounds__(kTokens * 4, 2)
    window_attn_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ bias,
                               Geometry g, long long windows, bool pairs,
                               bf16* __restrict__ dqkv, float* __restrict__ partials) {
  using S = MmaSmem<4, true>;
  unsigned char* smem = dynamic_smem();
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  bf16* s_ph = reinterpret_cast<bf16*>(smem + S::kP);  // then P lo, dS hi, dS lo
  bf16* s_pl = s_ph + kTokens * kPStride;
  bf16* s_dsh = s_pl + kTokens * kPStride;
  bf16* s_dsl = s_dsh + kTokens * kPStride;
  long long* s_row = reinterpret_cast<long long*>(smem + S::kRows);
  int* s_label = reinterpret_cast<int*>(smem + S::kLabels);
  int* s_mixed = reinterpret_cast<int*>(smem + S::kMixed);
  float* s_lse = reinterpret_cast<float*>(smem + S::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + S::kDelta);  // [2][kTokens]
  const int h = blockIdx.x % g.heads, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long group = blockIdx.x / g.heads, w0 = group * kWindowsPerBlock;
  const int count = (int)min((long long)kWindowsPerBlock, windows - w0);
  const int n = g.window * g.window, npad = (n + kSlab - 1) / kSlab * kSlab;
  const int d = g.head_dim, c = g.heads * d, slabs = npad / kSlab;
  const int i0 = warp % slabs * kSlab, half = warp / slabs;  // both phases' rows; keys or values
  const int j0 = half * npad / 2, ktiles = npad / 16;     // phase 1's keys: 8 tiles a window
  const int r0 = i0 + lane / 4;                            // this lane's rows: r0, r0 + 8
  clear_tiles(tiles, S::kP);
  float bias_r[kTokens / 16][4], dbias[kTokens / 16][4] = {};
  load_bias(bias, h, n, i0, j0, bias_r);
  __syncthreads();
  auto load = [&](int t, int b) {
    load_tiles<4>(qkv, dout, g, h, n, pairs, s_row + b * kTokens,
                  tiles + b * 4 * kTokens * kStride);
    const int r = threadIdx.x;
    if (r < n) cp_async_4(s_lse + b * kTokens + r, lse + ((w0 + t) * g.heads + h) * n + r);
  };
  WindowPos pos = window_pos(g, w0);
  window_rows(g, pos, n, s_row, s_label, s_mixed);
  __syncthreads();
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < count; ++t) {
    const int b = t & 1;
    if (t + 1 < count) {
      next_window(g, pos);
      window_rows(g, pos, n, s_row + (b ^ 1) * kTokens, s_label + (b ^ 1) * kTokens,
                  s_mixed + (b ^ 1));
      __syncthreads();
      load(t + 1, b ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* s_q = tiles + b * 4 * kTokens * kStride;
    const bf16* s_k = s_q + kTokens * kStride;
    const bf16* s_v = s_k + kTokens * kStride;
    const bf16* s_do = s_v + kTokens * kStride;
    const long long* rows = s_row + b * kTokens;
    float p[kTokens / 16][4], ds[kTokens / 16][4];
    scores(s_q, s_k, s_label + b * kTokens, s_mixed[b] != 0, bias_r, i0, j0, ktiles, n, g, p);
    const float lse0 = s_lse[b * kTokens + r0], lse1 = s_lse[b * kTokens + r0 + 8];
    uint32_t da[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldmatrix_x4(da[ks], s_do + (i0 + lane % 16) * kStride + 16 * ks + 8 * (lane / 16));
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTokens / 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r0 + 8;
        p[j][e] = i < n ? expf(p[j][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        ds[j][e] = 0.f;
      }
      if (j < ktiles) {
        uint32_t vb[4];
        ldmatrix_x4(vb, s_v + (j0 + 8 * j + lane % 8) * kStride + 8 * (lane / 8));
        mma_bf16_16816(ds[j], da[0], vb[0], vb[1]);
        if (d > 16) mma_bf16_16816(ds[j], da[1], vb[2], vb[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e / 2] = fmaf(p[j][e], ds[j][e], delta[e / 2]);
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
    if (lane % 4 == 0) {
      s_delta[half * kTokens + r0] = delta[0];
      s_delta[half * kTokens + r0 + 8] = delta[1];
    }
    __syncthreads();  // both halves of every row's D
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = r0 + 8 * hr;
      const float dd = s_delta[i] + s_delta[kTokens + i];
#pragma unroll
      for (int j = 0; j < kTokens / 16; ++j) {
        float* dsj = ds[j];
        dsj[2 * hr] = p[j][2 * hr] * (dsj[2 * hr] - dd);
        dsj[2 * hr + 1] = p[j][2 * hr + 1] * (dsj[2 * hr + 1] - dd);
        dbias[j][2 * hr] += dsj[2 * hr];
        dbias[j][2 * hr + 1] += dsj[2 * hr + 1];
        const int at = i * kPStride + j0 + 8 * j + 2 * (lane % 4);
        if (j < ktiles) {
          uint32_t hi, lo;
          split_pair(p[j][2 * hr], p[j][2 * hr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_ph + at) = hi;
          *reinterpret_cast<uint32_t*>(s_pl + at) = lo;
          split_pair(dsj[2 * hr], dsj[2 * hr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_dsh + at) = hi;
          *reinterpret_cast<uint32_t*>(s_dsl + at) = lo;
        }
      }
    }
    __syncthreads();  // every warp's P and dS are in shared memory
    if (16 * half < d) {
      // rows i0..i0+15 of dq (query rows) and of dk, dv (key rows), values
      // 16 half..: A = dS for dq, P^T and dS^T (row j of A is column j)
      auto rows_of = [=](const bf16* hi_tile, const bf16* lo_tile) {
        return [=](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          const int at = (i0 + lane % 16) * kPStride + 16 * kk + 8 * (lane / 16);
          ldmatrix_x4(hi, hi_tile + at);
          ldmatrix_x4(lo, lo_tile + at);
        };
      };
      auto columns_of = [=](const bf16* hi_tile, const bf16* lo_tile) {
        return [=](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          const int at =
              (16 * kk + lane % 8 + 8 * (lane / 16)) * kPStride + i0 + 8 * (lane / 8 % 2);
          ldmatrix_x4_trans(hi, hi_tile + at);
          ldmatrix_x4_trans(lo, lo_tile + at);
        };
      };
      float acc[2][4] = {};
      product<1>(rows_of(s_dsh, s_dsl), s_k, npad, half, d, acc);
      store_rows(acc, g.scale, i0, 16 * half, n, rows, dqkv + h * d, 3 * c, d, pairs);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e / 4][e % 4] = 0.f;
      product<1>(columns_of(s_dsh, s_dsl), s_q, npad, half, d, acc);
      store_rows(acc, g.scale, i0, 16 * half, n, rows, dqkv + c + h * d, 3 * c, d, pairs);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e / 4][e % 4] = 0.f;
      product<1>(columns_of(s_ph, s_pl), s_do, npad, half, d, acc);
      store_rows(acc, 1.f, i0, 16 * half, n, rows, dqkv + 2 * c + h * d, 3 * c, d, pairs);
    }
    __syncthreads();  // before the next copies overwrite this buffer, and P, dS and D
  }
  float* dst = partials + (group * g.heads + h) * n * n;
#pragma unroll
  for (int j = 0; j < kTokens / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e / 2), col = j0 + 8 * j + 2 * (lane % 4) + e % 2;
      if (i < n && col < n && j < ktiles) dst[i * n + col] = dbias[j][e];
    }
}

bool valid(const Geometry& g) {
  return g.batch >= 1 && g.window >= 1 && g.window * g.window <= kTokens &&
         g.height >= g.window && g.width >= g.window && g.height % g.window == 0 &&
         g.width % g.window == 0 && g.shift >= 0 && g.shift < g.window && g.heads >= 1 &&
         g.heads <= 65535 && g.head_dim >= 1 && g.head_dim <= kHeadDim &&
         (long long)g.height * g.width * g.batch < (1LL << 40);
}

long long windows_of(const Geometry& g) {
  return (long long)g.batch * (g.height / g.window) * (g.width / g.window);
}

Geometry geometry(int batch, int height, int width, int window, int shift, int heads,
                  int head_dim, float scale) {
  Geometry g;
  g.batch = batch;
  g.height = height;
  g.width = width;
  g.window = window;
  g.shift = shift;
  g.heads = heads;
  g.head_dim = head_dim;
  g.scale = scale;
  return g;
}

int groups_of(long long windows) {
  return (int)((windows + kWindowsPerBlock - 1) / kWindowsPerBlock);
}

void launch_dbias(const float* partials, int groups, const Geometry& g, float* dbias,
                  cudaStream_t stream) {
  const int size = g.heads * g.window * g.window * g.window * g.window;
  window_attn_dbias_kernel<<<(size + 255) / 256, 256, 0, stream>>>(partials, groups, size,
                                                                    dbias);
}

void launch_forward_simt(const float* qkv, const float* bias, const Geometry& g, float* out,
                         float* lse, cudaStream_t stream) {
  const dim3 grid((unsigned)windows_of(g), g.heads);
  window_attn_fwd_kernel<<<grid, kThreads, 0, stream>>>(qkv, bias, g, out, lse);
}

void launch_backward_simt(const float* qkv, const float* out, const float* dout,
                          const float* lse, const float* bias, const Geometry& g, float* dqkv,
                          float* partials, float* dbias, cudaStream_t stream) {
  const long long windows = windows_of(g);
  const int groups = groups_of(windows);
  const dim3 grid(groups, g.heads);
  window_attn_bwd_kernel<<<grid, kThreads, 0, stream>>>(qkv, out, dout, lse, bias, g, windows,
                                                        dqkv, partials);
  launch_dbias(partials, groups, g, dbias, stream);
}

// The tensor-core kernels: a block a (head, group of windows), heads
// fastest, so that the blocks that share a window's token rows run together
bool mma_fits(const Geometry& g) {
  return (long long)groups_of(windows_of(g)) * g.heads < (1LL << 31);
}

// a warp a slab of 16 query rows in the forward, two in the backward
unsigned mma_threads(const Geometry& g) {
  return 32 * ((g.window * g.window + kSlab - 1) / kSlab);
}

bool aligned4(const void* p) { return (uintptr_t)p % 4 == 0; }

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device: asked of the runtime once a device, not at every launch
template <typename K>
void allow_smem(K kernel, int bytes, std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_relaxed)) return;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cached) done[dev].store(true, std::memory_order_relaxed);
}

void launch_forward_mma(const bf16* qkv, const float* bias, const Geometry& g, bf16* out,
                        float* lse, cudaStream_t stream) {
  const long long windows = windows_of(g);
  const bool pairs = g.head_dim % 2 == 0 && aligned4(qkv) && aligned4(out);
  const int bytes = MmaSmem<3, false>::kBytes;
  static std::atomic<bool> done[kMaxDevices];
  allow_smem(window_attn_fwd_mma_kernel, bytes, done);
  window_attn_fwd_mma_kernel<<<(unsigned)(groups_of(windows) * g.heads), mma_threads(g), bytes,
                               stream>>>(qkv, bias, g, windows, pairs, out, lse);
}

void launch_backward_mma(const bf16* qkv, const bf16* dout, const float* lse, const float* bias,
                         const Geometry& g, bf16* dqkv, float* partials, float* dbias,
                         cudaStream_t stream) {
  const long long windows = windows_of(g);
  const int groups = groups_of(windows);
  const bool pairs = g.head_dim % 2 == 0 && aligned4(qkv) && aligned4(dout) && aligned4(dqkv);
  const int bytes = MmaSmem<4, true>::kBytes;
  static std::atomic<bool> done[kMaxDevices];
  allow_smem(window_attn_bwd_mma_kernel, bytes, done);
  window_attn_bwd_mma_kernel<<<(unsigned)(groups * g.heads), 2 * mma_threads(g), bytes,
                               stream>>>(
      qkv, dout, lse, bias, g, windows, pairs, dqkv, partials);
  launch_dbias(partials, groups, g, dbias, stream);
}

}  // namespace

extern "C" {

const char* window_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The backward's dBias partials: groups_of(windows) x heads x N x N floats.
int window_attn_groups(int batch, int height, int width, int window) {
  const Geometry g = geometry(batch, height, width, window, 0, 1, 1, 1.f);
  return valid(g) ? groups_of(windows_of(g)) : -1;
}

// out (B, H*W, C) and lse (windows x heads x N) from qkv (B, H*W, 3C), dtype
// kF32 (the CUDA-core kernels) or kBF16 (the tensor-core kernels), and bias
// (heads, N, N) f32.
int window_attn_forward(const void* qkv, int dtype, const float* bias, int batch, int height,
                        int width, int window, int shift, int heads, int head_dim,
                        float scale, void* out, float* lse, cudaStream_t stream) {
  const Geometry g = geometry(batch, height, width, window, shift, heads, head_dim, scale);
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      launch_forward_simt(static_cast<const float*>(qkv), bias, g, static_cast<float*>(out),
                          lse, stream);
      break;
    case kBF16:
      if (!mma_fits(g)) return (int)cudaErrorInvalidValue;
      launch_forward_mma(static_cast<const bf16*>(qkv), bias, g, static_cast<bf16*>(out), lse,
                         stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dqkv (qkv's shape and dtype) and dbias (heads, N, N) f32 from the forward's
// inputs and outputs and dout (out's shape and dtype); partials: scratch of
// window_attn_groups(...) x heads x N x N floats.
int window_attn_backward(const void* qkv, const void* out, const void* dout, const float* lse,
                         const float* bias, int dtype, int batch, int height, int width,
                         int window, int shift, int heads, int head_dim, float scale,
                         void* dqkv, float* partials, float* dbias, cudaStream_t stream) {
  const Geometry g = geometry(batch, height, width, window, shift, heads, head_dim, scale);
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      launch_backward_simt(static_cast<const float*>(qkv), static_cast<const float*>(out),
                           static_cast<const float*>(dout), lse, bias, g,
                           static_cast<float*>(dqkv), partials, dbias, stream);
      break;
    case kBF16:  // the tensor-core backward does not read O
      if (!mma_fits(g)) return (int)cudaErrorInvalidValue;
      launch_backward_mma(static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), lse,
                          bias, g, static_cast<bf16*>(dqkv), partials, dbias, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
