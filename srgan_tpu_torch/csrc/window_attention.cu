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
// flops a value; the card's balance in bf16 is ~295 flops a byte. This first
// version runs on CUDA cores in f32 (tensor cores are later work):
//   - window_attn_fwd_kernel: one block a (window, head), one thread a query
//     token. k and v of the window go to shared memory as f32 rows
//     zero-padded to 32, which every thread reads by 16-byte broadcasts;
//     each thread holds its q row and its 64 scores in registers, S =
//     q.k^T * scale + bias[head] + mask, a softmax in f32, O = P v / l, and
//     writes O (the input's dtype) and the row's log-sum-exp, never P.
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
//   - window_attn_dbias_kernel: one thread a (head, i, j) adds the groups'
//     partials in order, in fp64.
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

namespace {

constexpr int kTokens = 64;          // a window's most tokens (window side <= 8)
constexpr int kThreads = kTokens;    // a thread a token
constexpr int kHeadDim = 32;         // the largest head dim taken; rows are zero-padded to it
constexpr int kVec = kHeadDim / 4;   // float4s a row
constexpr int kWindowsPerBlock = 8;  // backward: windows a block walks for its head
constexpr float kMaskValue = -100.f;

enum { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename U>
__device__ __forceinline__ U from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

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

// One head's d values of a token row as f32, zero-padded to kHeadDim. Every
// loop over a row's values runs to the constant kHeadDim (a bound of d would
// index the register arrays at run time and put them in local memory).
template <typename T>
__device__ __forceinline__ void load_row(const T* src, int d, float* dst) {
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k) dst[k] = k < d ? to_f(src[k]) : 0.f;
}

__device__ __forceinline__ void store_row(const float* src, float* dst) {
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k) dst[k] = src[k];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                           Geometry g, T* __restrict__ out, float* __restrict__ lse) {
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
    const T* src = qkv + row * 3 * c + h * d;
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
  T* dst = out + row * c + h * d;
#pragma unroll
  for (int k = 0; k < kHeadDim; ++k)
    if (k < d) dst[k] = from_f<T>(o[k] * inv);
  lse[(w * g.heads + h) * n + i] = m + logf(l);
}

// The two phases share two arrays of shared rows: k and v while each thread
// walks its query row (phase 1), then q and dO while it walks its key column
// (phase 2). dBias's column of each thread is in shared memory, [r][j] with
// j the thread: the threads of a warp touch consecutive words.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ bias, Geometry g, long long windows,
                           T* __restrict__ dqkv, float* __restrict__ partials) {
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
      const T* src = qkv + row * 3 * c + h * d;
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
    T* dq = dqkv + row * 3 * c + h * d;
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
        if (k < d) dq[k] = from_f<T>(acc[k] * g.scale);
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
      const T* src = qkv + row * 3 * c + h * d;
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
          dq[c + k] = from_f<T>(acc[k] * g.scale);
          dq[2 * c + k] = from_f<T>(dv[k]);
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

template <typename T>
void launch_forward(const void* qkv, const float* bias, const Geometry& g, void* out,
                    float* lse, cudaStream_t stream) {
  const dim3 grid((unsigned)windows_of(g), g.heads);
  window_attn_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), bias, g, static_cast<T*>(out), lse);
}

template <typename T>
void launch_backward(const void* qkv, const void* out, const void* dout, const float* lse,
                     const float* bias, const Geometry& g, void* dqkv, float* partials,
                     float* dbias, cudaStream_t stream) {
  const long long windows = windows_of(g);
  const int groups = groups_of(windows);
  const dim3 grid(groups, g.heads);
  window_attn_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(out), static_cast<const T*>(dout),
      lse, bias, g, windows, static_cast<T*>(dqkv), partials);
  const int size = g.heads * g.window * g.window * g.window * g.window;
  window_attn_dbias_kernel<<<(size + 255) / 256, 256, 0, stream>>>(partials, groups, size,
                                                                    dbias);
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
// kF32 or kBF16, and bias (heads, N, N) f32.
int window_attn_forward(const void* qkv, int dtype, const float* bias, int batch, int height,
                        int width, int window, int shift, int heads, int head_dim,
                        float scale, void* out, float* lse, cudaStream_t stream) {
  const Geometry g = geometry(batch, height, width, window, shift, heads, head_dim, scale);
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: launch_forward<float>(qkv, bias, g, out, lse, stream); break;
    case kBF16: launch_forward<bf16>(qkv, bias, g, out, lse, stream); break;
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
      launch_backward<float>(qkv, out, dout, lse, bias, g, dqkv, partials, dbias, stream);
      break;
    case kBF16:
      launch_backward<bf16>(qkv, out, dout, lse, bias, g, dqkv, partials, dbias, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
