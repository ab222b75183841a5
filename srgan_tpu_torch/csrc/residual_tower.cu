// Hopper kernels for the fused residual tower: N blocks of
// conv3x3 (no bias) -> GroupNorm(8, eps 1e-6) -> ReLU -> conv3x3 -> GroupNorm
// -> +skip, with activations NHWC and weights HWIO (N, 3, 3, F, F).
//
// They replace the Pallas TPU kernels of
// srgan_tpu/ops/pallas/residual_tower_kernel.py:
//
//   K4 tower_forward  <- _make_fwd_kernel._fwd_kernel (:208, pallas_call :353)
//   K5 tower_backward <- _make_bwd_kernel._bwd_kernel (:248, pallas_call :393)
//
// What bounds them on an H100 SXM: arithmetic. At the flagship tower shape
// (N=16, F=64, batch 12, 128x256) one 3x3 conv is 2*32768*9*64*64 =
// 2.416 GFLOP per image, 32 convs per image: the forward is 927.7 GFLOP,
// against ~0.2 GB of inputs and outputs (0.06 ms at 3.35 TB/s).
//   K4: 13.85 ms in f32 (67 TFLOP/s, CUDA cores), 0.94 ms in bf16 (989
//       TFLOP/s, dense tensor cores).
//   K5: at least 3x the forward (one replay, dgrad, wgrad): 2,783 GFLOP,
//       41.5 ms in f32, 2.81 ms in bf16.
// Two sets of tiles, chosen by the compute dtype in forward_blocks and
// backward_blocks:
//   f32   conv_kernel / wgrad_kernel: FMA on the CUDA cores (TF32 stays
//         off), so the f32 bound is the one they can approach. An H100 SM
//         issues four warp-wide FFMA a clock but serves about one shared-
//         memory wavefront a clock, twice the FMA per wavefront of an A100
//         SM: a SIMT tile is held back by the shared-memory loads behind
//         each FMA, and by staging that its products wait for. So each
//         thread reuses every loaded value many times from registers: the
//         conv 45 loads per 576 FMA (a 4 x 4 pixel block x 4 channels, the
//         9 taps' weights of one input channel held in registers), the
//         wgrad 3 float4 loads per 96 FMA (3 taps x 4 F_in x 8 F_out, the
//         input window sliding along a pixel row). Both stage their f32
//         operands by cp.async into two buffers, the next step's copies in
//         flight during this step's products, one barrier a step. Where the
//         operand is r = relu(GN1(c1)) (conv2 and its weight gradient), each
//         thread applies GN1 + ReLU in place to the elements it copied, once
//         they have landed. Both tiles then run at ~64 % of the fp32 rate
//         with loops of almost only FFMA (PERF.md); what holds them there
//         is not measured (no ncu on the machine with the card).
//   bf16  conv_tc_kernel / wgrad_tc_kernel: every conv and weight gradient
//         of the mode, the dX convs included, on the tensor cores with
//         mma.sync m16n8k16 (bf16 operands, f32 accumulators), fed by
//         ldmatrix from shared memory staged in bf16. cp.async brings the
//         bf16 sources (weights, the bf16 carry) and double-buffers the
//         conv's per-tap weights; f32 sources (c1 with GN1, dc) are loaded
//         four float4 a thread at a time and rounded while staged. The PTX
//         sits behind the small device functions of tower_mma.cuh. Every
//         tensor-core operand is already an exact bf16 value (the bf16
//         carry, the weights the wrapper rounds, round(relu(GN1)), dc
//         rounded by gn_bwd_apply), so these tiles change only the
//         summation order, not the rounding.
//   With the tensor cores, bytes set the bf16 mode's floor: c1, c2 and dc
//   stay f32 in device memory. At the flagship shape one f32 activation is
//   101 MB, a bf16 one 50 MB; per block the forward reads the bf16 input
//   twice (conv1, skip), writes c1 and reads it back (conv2), writes c2 and
//   reads it back (GN2 + skip), and writes the next input: 0.55 GB a block,
//   8.9 GB for K4 (2.6 ms at 3.35 TB/s); K5, with the replay, the
//   GroupNorm backward's passes and dc, moves ~39 GB (11.5 ms). The tiles
//   run at 2-3x that floor: few warps an SM (3 conv blocks, 2 wgrad blocks
//   of 8 warps), with staging, products and epilogue separated by
//   barriers. The next step is wgmma with TMA and warp-specialised
//   pipelines, then c1/c2 kept on chip (a block's conv1 -> GN1 -> conv2
//   fused per image strip, the statistics in a second pass).
//
// Design. The TPU kernel keeps one image's whole (H, W, F) activation in
// VMEM and loops over the blocks on chip. A Hopper SM has 227 KB of shared
// memory, and each GroupNorm needs statistics over the whole image before
// any output of its block can be normalised. So the C entry points run a
// host loop over the blocks, a few launches per block, each launch on the
// caller's stream with no host sync:
//
//   conv_kernel      (f32) implicit-GEMM 3x3 conv. A block owns 16 columns
//                    x 1024 / F rows (16 x 16 pixels at F = 64) and all F
//                    outputs; a thread owns a 4 x 4 pixel block x 4 output
//                    channels. K = 9 * F_in is staged kChunkC = 8 input
//                    channels at a time: the (tile + halo) patch and the 9
//                    taps' weight rows. Per input channel a thread holds the
//                    9 taps' weights in registers and reads its 6 x 6
//                    activations once, row by row. The operand can be
//                    relu(GN1(c1)) (conv2 reads c1; r is never written).
//                    The epilogue writes per-(image, group) tile sums of c
//                    and c^2 in fp64, or adds a residual (dX).
//   conv_tc_kernel   (bf16) the same conv on the tensor cores: a block owns
//                    8 rows x 16 columns = 128 pixels (M), all F outputs
//                    (N), K = 9 * F. It stages the (10 x 18) x F patch once
//                    in bf16, with the same on-the-fly activation, and the
//                    taps' F x F weights one tap at a time in two buffers
//                    (the next tap's copy in flight during this tap's
//                    products). Warp w owns tile row w: 16 pixels x F
//                    outputs, F/8 m16n8 accumulators. Rows are padded by 16
//                    bytes, so ldmatrix reads them without bank conflicts.
//                    The epilogue goes through shared memory and then is
//                    conv_kernel's: f32 stores, the residual, fp64 sums.
//   gn_stats         fixed-order sum of those partials: mean and
//                    rsqrt(E[c^2] - E[c]^2 + 1e-6) per (image, group).
//   gn_skip          carry = round(GN2(c2) + a) in the compute dtype.
//   gn_bwd_*         the GroupNorm backward (_gn_bwd, :153-169): per
//                    (image, channel) sums of dout and dout*z in fp64
//                    partials, a one-block fixed-order finalise (dscale,
//                    dbias and the group means), then dc elementwise.
//   wgrad_kernel     (f32) dW[tap] = patch(input)^T . dc, K = every pixel
//                    of every image. A block of 12 warps at F = 64 walks a
//                    chunk of 8 x 16 pixel tiles; each tile's (10 x 18) x F
//                    input patch and its 128 x F_out slice of dc are staged
//                    once and serve all 9 taps. A lane owns one tap row di,
//                    its 3 taps x 4 F_in x 8 F_out (96 accumulators), and
//                    walks each tile row left to right: the input pixels
//                    its taps read at x are those at x - 1 one step
//                    earlier. F_out is split across blocks only at F = 128.
//                    Per-chunk f32 partials (<= kMaxWgradChunks chunks,
//                    1,536 pixels each at the flagship shape), summed in
//                    chunk order by wgrad_reduce.
//   wgrad_tc_kernel  (bf16) the same GEMM on the tensor cores. A block
//                    walks a chunk of 8 x 16 pixel tiles; each tile's
//                    (10 x 18) x F input patch and its 128 x F_out slice of
//                    dc are staged once in bf16 (two buffers: the next
//                    tile is staged before this one's products, its
//                    cp.async copies in flight during them) and serve all
//                    9 taps, which are shifts of the patch read with
//                    ldmatrix.trans. F_out is split across blocks (32 or 16
//                    columns each), not taps: a warp owns one 16 x 16
//                    (F_in, F_out) tile for its taps, 9 x 8 accumulators at
//                    F = 64. Per-chunk f32 partials, then wgrad_reduce.
//   dX               the forward's conv tile on flipped, transposed taps.
//
// No float atomics anywhere: results are the same from run to run. A
// persistent cooperative kernel with grid-wide syncs would save the
// launches, but every phase here is a whole-image reduction followed by a
// whole-image pass, which separate launches express directly and which
// keeps each kernel checkable on its own.
//
// K5 replays the forward once with K4's own launches and rounding schedule
// (the backward must evaluate the gradients at the forward's points), and
// keeps what the replay makes: each block's input in the compute dtype,
// c1, c2 (f32) and the statistics. Going back then costs dgrad + wgrad
// only: 3x the forward's arithmetic, where the JAX kernel replays each
// block a second time (4x). Scratch at the flagship shape: 15 block inputs
// (1.51 GB f32, 0.76 GB bf16) + c1 and c2 for 16 blocks (3.22 GB) + four
// f32 activation buffers (0.40 GB).
//
// Rounding follows the JAX kernels: conv operands (activations, weights,
// and in the backward dc) in the compute dtype; accumulation, statistics,
// GroupNorm and the carried gradient in f32.
//
// Plain C interface for ctypes (srgan_tpu_torch/ops/cuda/
// residual_tower_kernel.py). Every entry point returns cudaGetLastError()
// after its last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tower_mma.cuh"

extern __shared__ __align__(16) unsigned char tower_smem[];

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;          // GroupNorm groups
constexpr double kEps = 1e-6;       // flax GroupNorm default
constexpr int kTileW = 16;          // conv tiles: output tile width in pixels
constexpr int kChanPerThread = 8;   // conv_tc epilogue: channels per thread
constexpr int kChunkC = 8;          // conv: input channels staged per step
constexpr int kWgRows = 8;          // wgrad: pixel tile rows
constexpr int kWgCols = 16;         // wgrad: pixel tile columns
constexpr int kWgPix = kWgRows * kWgCols;
constexpr int kMaxWgradChunks = 256;
constexpr int kMaxRedChunks = 32;
constexpr int kStatThreads = 128;
constexpr int kTcRows = kWarps;           // tensor-core tiles: a row per warp
constexpr int kTcPix = kTcRows * kTileW;  // 128 pixels
constexpr int kTcPatchH = kTcRows + 2;
constexpr int kTcPatchW = kTileW + 2;
constexpr int kMaxTcChunks = 128;         // wgrad_tc: pixel-tile chunks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// (c - mean) * inv * scale + bias, the GroupNorm affine of the JAX kernel;
// the forward's ReLU and the backward's mask both read it from here.
__device__ __forceinline__ float gn_affine(float c, float mean, float inv,
                                           float s, float b) {
  return (c - mean) * inv * s + b;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// ------------------------------------------------------------- conv ----

// s[py, px, 0:C] = src[b, gy0 + py, gx0 + px, c0 : c0 + C] (an activation
// of F channels) for a ROWS x COLS rectangle, pixel rows STRIDE floats
// apart, zero outside the image: 16 bytes a cp.async, NT threads sharing
// the copies (the caller commits and waits). NT is a multiple of C / 4, so
// a thread copies the same 4 channels of every pixel it copies.
template <int F, int C, int ROWS, int COLS, int STRIDE, int NT>
__device__ __forceinline__ void copy_rect(const float* __restrict__ src, int b,
                                          int H, int W, int gy0, int gx0, int c0,
                                          float* s) {
  constexpr int kPer = C / 4;
  static_assert(NT % kPer == 0, "channels");
  const int cv = threadIdx.x % kPer * 4;
  for (int pix = threadIdx.x / kPer; pix < ROWS * COLS; pix += NT / kPer) {
    const int py = pix / COLS;
    const int gy = gy0 + py;
    const int gx = gx0 + pix - py * COLS;
    float* dst = s + pix * STRIDE + cv;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      cp_async_16(dst, src + (((int64_t)b * H + gy) * W + gx) * F + c0 + cv);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The same rectangle once this thread's copies have landed: each thread
// turns the elements it copied into relu(GN(v)) in place, with gn(c) =
// (mean, inv, scale, bias) of channel c read once for its 4 channels;
// outside the image they stay zero, the conv's padding.
template <int C, int ROWS, int COLS, int STRIDE, int NT, typename Gn>
__device__ __forceinline__ void gn_relu_rect(float* s, Gn gn, int H, int W,
                                             int gy0, int gx0, int c0) {
  constexpr int kPer = C / 4;
  const int cv = threadIdx.x % kPer * 4;
  float4 q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = gn(c0 + cv + j);
  for (int pix = threadIdx.x / kPer; pix < ROWS * COLS; pix += NT / kPer) {
    const int py = pix / COLS;
    const int gy = gy0 + py;
    const int gx = gx0 + pix - py * COLS;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    float4* p = reinterpret_cast<float4*>(s + pix * STRIDE + cv);
    float v[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = fmaxf(gn_affine(v[j], q[j].x, q[j].y, q[j].z, q[j].w), 0.f);
    *p = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int F>
struct ConvShape {
  static constexpr int kCoGroups = F / 4;                   // 4 channels a thread
  static constexpr int kPixGroups = kThreads / kCoGroups;   // 64..8 blocks of 4 x 4
  static constexpr int kTileH = kPixGroups / 4 * 4;  // rows of 4 blocks, 4 pixels high
  static constexpr int kPatchH = kTileH + 2;
  static constexpr int kPatchW = kTileW + 2;
  // 16-byte pixels for cp.async; at F = 64 a warp's two 4 x 4 blocks read
  // 4 pixels = 48 floats apart, in distinct banks
  static constexpr int kPixStride = kChunkC + 4;
  static constexpr int kInFloats = kPatchH * kPatchW * kPixStride;
  static constexpr int kWFloats = 9 * kChunkC * F;  // (tap, ci) rows of F
  static constexpr int kBufFloats = kInFloats + kWFloats;
  // a thread's 4 channels fall in 1 group, or in 2 at F = 16
  static constexpr int kGroupSize = F / kGroups;
  static constexpr int kSlotChans = kGroupSize < 4 ? kGroupSize : 4;
  static constexpr int kSlots = 4 / kSlotChans;
  static constexpr int kWarpCo = kCoGroups < 32 ? kCoGroups : 32;  // in a warp
  static constexpr size_t kStatOffset = 2 * (size_t)kBufFloats * sizeof(float);
  static constexpr size_t kGnOffset =  // GN_IN: the image's GN1 by channel
      kStatOffset + (size_t)kWarps * kWarpCo * kSlots * 2 * sizeof(double);
  static constexpr size_t kSmemBytes = kGnOffset + (size_t)F * sizeof(float4);
  static_assert(kTileH * kTileW == kPixGroups * 16, "tile");
  static_assert(F % kChunkC == 0 && kChunkC % 4 == 0 && kBufFloats % 4 == 0, "F");
};

// out[b, y, x, :] = sum_{tap, ci} act(in[b, y+di-1, x+dj-1, ci]) w[tap, ci, :]
// with act = identity (GN_IN false) or relu(GN(c)) (GN_IN true), zero
// outside the image. Then, if stat_partials: per-(tile, group) fp64 sums
// of out and out^2; if add: out += add. A thread owns a 4 x 4 pixel block
// x 4 channels; per input channel it holds the 9 taps' weights in
// registers and reads its (6 x 6) activations once, row by row: 45 loads
// per 576 FMA. Two blocks an SM (<= 128 registers) at F >= 32: 79, 71 and
// 97 KB of shared memory at F = 32, 64 and 128. At F = 16 the tile is 64 x
// 16 pixels and takes 124.5 KB, so one block an SM, and its activation
// reads meet 4-way bank conflicts (2-way at F = 32); the model's width is
// 64.
template <int F, bool GN_IN>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ in, const float* __restrict__ w,
            const float* __restrict__ gn_stats, const float* __restrict__ gn_s,
            const float* __restrict__ gn_b, int H, int W,
            float* __restrict__ out, const float* __restrict__ add,
            double* __restrict__ stat_partials) {
  using S = ConvShape<F>;
  constexpr int kChunks = F / kChunkC;
  float* s_buf = reinterpret_cast<float*>(tower_smem);
  double* s_stat = reinterpret_cast<double*>(tower_smem + S::kStatOffset);
  float4* s_gn = reinterpret_cast<float4*>(tower_smem + S::kGnOffset);

  const int tid = threadIdx.x;
  const int co_grp = tid % S::kCoGroups;
  const int pg = tid / S::kCoGroups;
  const int by = pg / 4 * 4;  // the thread's 4 x 4 block in the tile
  const int bx = pg % 4 * 4;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * S::kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int nG = gridDim.z * kGroups;  // stats: [mean(B*G), inv(B*G)]

  // input channels [ci0, ci0 + kChunkC): the patch, and the taps' rows of w
  auto stage = [&](int ci0, float* s) {
    copy_rect<F, kChunkC, S::kPatchH, S::kPatchW, S::kPixStride, kThreads>(
        in, b, H, W, y0 - 1, x0 - 1, ci0, s);
    float* sw = s + S::kInFloats;
    constexpr int kRowVec = F / 4;
    for (int i = tid; i < 9 * kChunkC * kRowVec; i += kThreads) {
      const int r = i / kRowVec;  // tap * kChunkC + ci
      const int tap = r / kChunkC;
      const int c = (i - r * kRowVec) * 4;
      cp_async_16(sw + r * F + c, w + ((int64_t)tap * F + ci0 + r - tap * kChunkC) * F + c);
    }
  };
  // the chunk in buffer s, once this thread's copies have landed
  auto activate = [&](int ci0, float* s) {
    cp_async_wait<0>();
    if (GN_IN)
      gn_relu_rect<kChunkC, S::kPatchH, S::kPatchW, S::kPixStride, kThreads>(
          s, [&](int c) { return s_gn[c]; }, H, W, y0 - 1, x0 - 1, ci0);
  };
  if (GN_IN) {  // uniform over the block
    for (int c = tid; c < F; c += kThreads) {
      const int g = b * kGroups + c / S::kGroupSize;
      s_gn[c] = make_float4(gn_stats[g], gn_stats[nG + g], gn_s[c], gn_b[c]);
    }
    __syncthreads();
  }

  float acc[4][4][4];  // [row][column][channel]
#pragma unroll
  for (int y = 0; y < 4; ++y)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[y][x][c] = 0.f;

  stage(0, s_buf);
  cp_async_commit();
  activate(0, s_buf);
#pragma unroll 1
  for (int k = 0; k < kChunks; ++k) {
    float* s = s_buf + (k % 2) * S::kBufFloats;
    float* next = s_buf + ((k + 1) % 2) * S::kBufFloats;
    __syncthreads();  // chunk k in place; the other buffer (k - 1) consumed
    if (k + 1 < kChunks) {  // the next chunk, in flight during this one
      stage((k + 1) * kChunkC, next);
      cp_async_commit();
    }
    const float* a_base = s + (by * S::kPatchW + bx) * S::kPixStride;
    const float* w_base = s + S::kInFloats + 4 * co_grp;
#pragma unroll 1
    for (int ci = 0; ci < kChunkC; ++ci) {
      float wv[9][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4 q = *reinterpret_cast<const float4*>(w_base + (tap * kChunkC + ci) * F);
        wv[tap][0] = q.x;
        wv[tap][1] = q.y;
        wv[tap][2] = q.z;
        wv[tap][3] = q.w;
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {  // patch row r feeds output rows r - di
        float a[6];
#pragma unroll
        for (int p = 0; p < 6; ++p)
          a[p] = a_base[(r * S::kPatchW + p) * S::kPixStride + ci];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          if (r - di < 0 || r - di > 3) continue;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r - di][x][c] += a[x + dj] * wv[di * 3 + dj][c];
        }
      }
    }
    if (k + 1 < kChunks) activate((k + 1) * kChunkC, next);
  }

  // epilogue: store, and the group sums of this tile
  double st[S::kSlots][2];
#pragma unroll
  for (int q = 0; q < S::kSlots; ++q) st[q][0] = st[q][1] = 0.0;
  const int co = 4 * co_grp;
#pragma unroll
  for (int yy = 0; yy < 4; ++yy) {
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const int y = y0 + by + yy;
      const int x = x0 + bx + xx;
      if (y < H && x < W) {
        const int64_t off = (((int64_t)b * H + y) * W + x) * F + co;
        float v[4] = {acc[yy][xx][0], acc[yy][xx][1], acc[yy][xx][2], acc[yy][xx][3]};
        if (add != nullptr) {
          const float4 r = *reinterpret_cast<const float4*>(add + off);
          v[0] += r.x;
          v[1] += r.y;
          v[2] += r.z;
          v[3] += r.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[c / S::kSlotChans][0] += (double)v[c];
          st[c / S::kSlotChans][1] += (double)v[c] * (double)v[c];
        }
        *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  if (stat_partials == nullptr) return;  // uniform over the block

  // threads of one warp with the same co_grp differ in the lane bits above
  // log2(kWarpCo): reduce over those, in a fixed butterfly order
#pragma unroll
  for (int q = 0; q < S::kSlots; ++q) {
#pragma unroll
    for (int m = S::kWarpCo; m < 32; m *= 2) {
      st[q][0] += __shfl_xor_sync(0xffffffffu, st[q][0], m);
      st[q][1] += __shfl_xor_sync(0xffffffffu, st[q][1], m);
    }
  }
  const int lane = tid % 32;
  const int warp = tid / 32;
  if (lane < S::kWarpCo) {  // co_grp == lane here
#pragma unroll
    for (int q = 0; q < S::kSlots; ++q) {
      double* d = s_stat + ((warp * S::kWarpCo + lane) * S::kSlots + q) * 2;
      d[0] = st[q][0];
      d[1] = st[q][1];
    }
  }
  __syncthreads();
  if (tid < kGroups) {
    double s = 0.0, ss = 0.0;
    for (int wp = 0; wp < kWarps; ++wp)
      for (int l = 0; l < S::kWarpCo; ++l)
        for (int q = 0; q < S::kSlots; ++q) {
          // lane l holds co_grp l: kCoGroups divides 32
          if ((4 * l + q * S::kSlotChans) / S::kGroupSize != tid) continue;
          const double* d = s_stat + ((wp * S::kWarpCo + l) * S::kSlots + q) * 2;
          s += d[0];
          ss += d[1];
        }
    const int64_t tile =
        ((int64_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    stat_partials[(tile * kGroups + tid) * 2] = s;
    stat_partials[(tile * kGroups + tid) * 2 + 1] = ss;
  }
}

// stats[g] = mean, stats[B*G + g] = rsqrt(var + eps), g = (image, group),
// from the conv's tile partials, summed in tile order. One block per g.
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const double* __restrict__ partials, int tiles, double count,
                float* __restrict__ stats) {
  double* red = reinterpret_cast<double*>(tower_smem);
  const int g = blockIdx.x;  // b * kGroups + group
  const int b = g / kGroups;
  const int grp = g - b * kGroups;
  double s = 0.0, ss = 0.0;
  for (int t = threadIdx.x; t < tiles; t += kStatThreads) {
    const double* p = partials + (((int64_t)b * tiles + t) * kGroups + grp) * 2;
    s += p[0];
    ss += p[1];
  }
  red[threadIdx.x] = s;
  red[kStatThreads + threadIdx.x] = ss;
  __syncthreads();
  for (int h = kStatThreads / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) {
      red[threadIdx.x] += red[threadIdx.x + h];
      red[kStatThreads + threadIdx.x] += red[kStatThreads + threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double mean = red[0] / count;
    const double var = red[kStatThreads] / count - mean * mean;
    stats[g] = (float)mean;
    stats[gridDim.x + g] = (float)(1.0 / sqrt(var + kEps));
  }
}

// ----------------------------------------------------- elementwise ----

// out = round(GN2(c2) + a) in the carry's dtype. Grid (x, B).
template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
gn_skip_kernel(const float* __restrict__ c2, const float* __restrict__ stats,
               const float* __restrict__ s, const float* __restrict__ bias,
               const T* __restrict__ a, int hwf, T* __restrict__ out) {
  const int b = blockIdx.y;
  const int nG = gridDim.y * kGroups;
  const int64_t base = (int64_t)b * hwf;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < hwf;
       i += gridDim.x * kThreads) {
    const int c = i % F;
    const int g = b * kGroups + c / (F / kGroups);
    const float v = gn_affine(c2[base + i], stats[g], stats[nG + g], s[c],
                              bias[c]) + to_f(a[base + i]);
    out[base + i] = from_f<T>(v);
  }
}

// The GroupNorm backward reads dout = src (MASK false) or, behind the
// ReLU, dout = src where GN(c) > 0 else 0 (MASK true), and z = (c-mean)*inv.
template <bool MASK>
__device__ __forceinline__ void gn_dout_z(float src, float c, float mean,
                                          float inv, float s, float bias,
                                          float& dout, float& z) {
  z = (c - mean) * inv;
  dout = src;
  if (MASK && !(gn_affine(c, mean, inv, s, bias) > 0.f)) dout = 0.f;
}

// partials[b, chunk, c] = (sum dout, sum dout*z) over a chunk of pixels
// of image b. Grid (chunks, B).
template <int F, bool MASK>
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const float* __restrict__ src, const float* __restrict__ c,
                     const float* __restrict__ stats, const float* __restrict__ s,
                     const float* __restrict__ bias, int hw,
                     double* __restrict__ partials) {
  constexpr int kLanes = kThreads / F;
  double* red = reinterpret_cast<double*>(tower_smem);
  const int b = blockIdx.y;
  const int nG = gridDim.y * kGroups;
  const int ch = threadIdx.x % F;
  const int lane = threadIdx.x / F;
  const int g = b * kGroups + ch / (F / kGroups);
  const float mean = stats[g], inv = stats[nG + g], sc = s[ch], bi = bias[ch];
  const int per = (hw + gridDim.x - 1) / gridDim.x;
  const int p0 = blockIdx.x * per;
  const int p1 = min(p0 + per, hw);
  double sd = 0.0, sdz = 0.0;
  for (int p = p0 + lane; p < p1; p += kLanes) {
    const int64_t i = ((int64_t)b * hw + p) * F + ch;
    float dout, z;
    gn_dout_z<MASK>(src[i], c[i], mean, inv, sc, bi, dout, z);
    sd += (double)dout;
    sdz += (double)dout * (double)z;
  }
  red[2 * threadIdx.x] = sd;
  red[2 * threadIdx.x + 1] = sdz;
  __syncthreads();
  if (lane == 0) {
    for (int l = 1; l < kLanes; ++l) {
      sd += red[2 * (l * F + ch)];
      sdz += red[2 * (l * F + ch) + 1];
    }
    double* out = partials + (((int64_t)b * gridDim.x + blockIdx.x) * F + ch) * 2;
    out[0] = sd;
    out[1] = sdz;
  }
}

// One block: per-(image, channel) sums in chunk order (into sums), then
// dbias[c] = sum_b sum dout, dscale[c] = sum_b sum dout*z, and per (image,
// group) m = (mean_g(dout*s), mean_g(dout*s*z)).
__global__ void __launch_bounds__(kThreads)
gn_bwd_finalize_kernel(const double* __restrict__ partials, int B, int F,
                       int chunks, const float* __restrict__ s, double count,
                       double* __restrict__ sums, float* __restrict__ dscale,
                       float* __restrict__ dbias, float* __restrict__ m) {
  for (int i = threadIdx.x; i < B * F; i += kThreads) {
    const int b = i / F;
    const int ch = i - b * F;
    double sd = 0.0, sdz = 0.0;
    for (int k = 0; k < chunks; ++k) {
      const double* p = partials + (((int64_t)b * chunks + k) * F + ch) * 2;
      sd += p[0];
      sdz += p[1];
    }
    sums[2 * i] = sd;
    sums[2 * i + 1] = sdz;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < F; ch += kThreads) {
    double db = 0.0, ds = 0.0;
    for (int b = 0; b < B; ++b) {
      db += sums[2 * (b * F + ch)];
      ds += sums[2 * (b * F + ch) + 1];
    }
    dbias[ch] = (float)db;
    dscale[ch] = (float)ds;
  }
  const int gs = F / kGroups;
  for (int i = threadIdx.x; i < B * kGroups; i += kThreads) {
    const int b = i / kGroups;
    const int grp = i - b * kGroups;
    double mdz = 0.0, mdzz = 0.0;
    for (int ch = grp * gs; ch < (grp + 1) * gs; ++ch) {
      mdz += (double)s[ch] * sums[2 * (b * F + ch)];
      mdzz += (double)s[ch] * sums[2 * (b * F + ch) + 1];
    }
    m[2 * i] = (float)(mdz / count);
    m[2 * i + 1] = (float)(mdzz / count);
  }
}

// dc = inv * (dout*s - mean_g(dz) - z*mean_g(dz*z)), rounded to the compute
// dtype (the JAX kernel rounds dc for both of its matmuls). Grid (x, B).
template <int F, bool MASK>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply_kernel(const float* __restrict__ src, const float* __restrict__ c,
                    const float* __restrict__ stats, const float* __restrict__ s,
                    const float* __restrict__ bias, const float* __restrict__ m,
                    int hwf, int round, float* __restrict__ dc) {
  const int b = blockIdx.y;
  const int nG = gridDim.y * kGroups;
  const int64_t base = (int64_t)b * hwf;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < hwf;
       i += gridDim.x * kThreads) {
    const int ch = i % F;
    const int g = b * kGroups + ch / (F / kGroups);
    const float inv = stats[nG + g];
    float dout, z;
    gn_dout_z<MASK>(src[base + i], c[base + i], stats[g], inv, s[ch], bias[ch],
                    dout, z);
    float v = inv * (dout * s[ch] - m[2 * g] - z * m[2 * g + 1]);
    if (round) v = round_bf16(v);
    dc[base + i] = v;
  }
}

// ------------------------------------------------------------ wgrad ----

template <int F>
struct WgradShape {
  static constexpr int kCB = F == 128 ? 32 : F;  // F_out a block
  static constexpr int kSplits = F / kCB;
  // a lane: one tap row di, its 3 taps x 4 F_in x 8 F_out (4c.. and
  // kCB/2 + 4c..); where fewer than 32 lanes cover a tap row, lanes that
  // split the tile rows
  static constexpr int kCiGroups = F / 4;
  static constexpr int kCoGroups = kCB / 8;
  static constexpr int kLanes = kCiGroups * kCoGroups;
  static constexpr int kPhases = kLanes < 32 ? 32 / kLanes : 1;
  static constexpr int kThreads = 3 * kLanes * kPhases;  // 384 at F = 64, 128
  static constexpr int kPatchH = kWgRows + 2;
  static constexpr int kPatchW = kWgCols + 2;
  static constexpr int kPatchFloats = kPatchH * kPatchW * F;
  static constexpr int kBufFloats = kPatchFloats + kWgPix * kCB;
  static constexpr size_t kSmemBytes = 2 * (size_t)kBufFloats * sizeof(float);
  static_assert(kThreads % 32 == 0 && kWgRows % kPhases == 0, "lanes");
};

// partial[chunk, tap, ci, s * kCB : (s + 1) * kCB] = sum over the chunk's
// pixels p of act(in[p shifted by tap, ci]) * dc[p, co]; act as in
// conv_kernel. Grid (chunks, kSplits): block (c, s) walks 8 x 16 pixel
// tiles [c * per_chunk, (c + 1) * per_chunk) of the (B, H/8, W/16) grid.
// A lane walks each tile row of its phase from left to right: the input
// pixels its three taps read at x are those at x - 1 of the step before,
// so a step loads one float4 of input and two of dc for 96 FMA. 12 warps
// an SM (<= 168 registers); 158 KB of shared memory at F = 64, 217 KB at
// F = 128.
template <int F, bool GN_IN>
__global__ void __launch_bounds__(WgradShape<F>::kThreads, 384 / WgradShape<F>::kThreads)
wgrad_kernel(const float* __restrict__ in, const float* __restrict__ gn_stats,
             const float* __restrict__ gn_s, const float* __restrict__ gn_b,
             const float* __restrict__ dc, int B, int H, int W, int per_chunk,
             float* __restrict__ partial) {
  using S = WgradShape<F>;
  float* s_buf = reinterpret_cast<float*>(tower_smem);
  const int t_id = threadIdx.x;
  const int co_grp = t_id % S::kCoGroups;
  const int ci_grp = t_id / S::kCoGroups % S::kCiGroups;
  const int phase = t_id / S::kLanes % S::kPhases;
  const int di = t_id / (S::kLanes * S::kPhases);
  const int co_base = blockIdx.y * S::kCB;
  const int tiles_x = (W + kWgCols - 1) / kWgCols;
  const int tiles_y = (H + kWgRows - 1) / kWgRows;
  const int t_begin = blockIdx.x * per_chunk;
  const int t_end = min(t_begin + per_chunk, B * tiles_x * tiles_y);

  // tile t: its image and the pixel at its top left
  auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / (tiles_x * tiles_y);
    const int r = t - b * tiles_x * tiles_y;
    y0 = r / tiles_x * kWgRows;
    x0 = r % tiles_x * kWgCols;
  };
  // tile t's (10 x 18) x F input patch and its 128 x kCB slice of dc
  auto stage = [&](int t, float* s) {
    int b, y0, x0;
    origin(t, b, y0, x0);
    copy_rect<F, F, S::kPatchH, S::kPatchW, F, S::kThreads>(in, b, H, W, y0 - 1,
                                                            x0 - 1, 0, s);
    copy_rect<F, S::kCB, kWgRows, kWgCols, S::kCB, S::kThreads>(
        dc, b, H, W, y0, x0, co_base, s + S::kPatchFloats);
  };
  // tile t in buffer s, once this thread's copies have landed
  auto activate = [&](int t, float* s) {
    cp_async_wait<0>();
    if (GN_IN) {
      int b, y0, x0;
      origin(t, b, y0, x0);
      auto gn = [&](int c) {
        const int g = b * kGroups + c / (F / kGroups);
        return make_float4(gn_stats[g], gn_stats[B * kGroups + g], gn_s[c], gn_b[c]);
      };
      gn_relu_rect<F, S::kPatchH, S::kPatchW, F, S::kThreads>(s, gn, H, W, y0 - 1,
                                                              x0 - 1, 0);
    }
  };

  float acc[3][4][8];  // [dj][F_in][F_out]
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][i][c] = 0.f;

  if (t_begin < t_end) {
    stage(t_begin, s_buf);
    cp_async_commit();
    activate(t_begin, s_buf);
  }
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    float* s = s_buf + ((t - t_begin) % 2) * S::kBufFloats;
    float* next = s_buf + ((t + 1 - t_begin) % 2) * S::kBufFloats;
    __syncthreads();  // tile t in place; the other buffer (t - 1) consumed
    if (t + 1 < t_end) {  // the next tile, in flight during this one
      stage(t + 1, next);
      cp_async_commit();
    }
#pragma unroll 1
    for (int y = phase; y < kWgRows; y += S::kPhases) {
      const float* ar = s + (y + di) * S::kPatchW * F + 4 * ci_grp;
      const float* dr = s + S::kPatchFloats + y * kWgCols * S::kCB + 4 * co_grp;
      float4 win[3];  // input pixels x, x + 1, x + 2 of the patch row
      win[0] = *reinterpret_cast<const float4*>(ar);
      win[1] = *reinterpret_cast<const float4*>(ar + F);
#pragma unroll
      for (int x = 0; x < kWgCols; ++x) {
        win[2] = *reinterpret_cast<const float4*>(ar + (x + 2) * F);
        const float4 d0 = *reinterpret_cast<const float4*>(dr + x * S::kCB);
        const float4 d1 = *reinterpret_cast<const float4*>(dr + x * S::kCB + S::kCB / 2);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float av[4] = {win[j].x, win[j].y, win[j].z, win[j].w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[j][i][c] += av[i] * dv[c];
        }
        win[0] = win[1];
        win[1] = win[2];
      }
    }
    if (t + 1 < t_end) activate(t + 1, next);
  }

  // the phases' sums, in a fixed butterfly order (lanes differ above
  // log2(kLanes))
#pragma unroll
  for (int m = S::kLanes; m < S::kLanes * S::kPhases; m *= 2)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[j][i][c] += __shfl_xor_sync(0xffffffffu, acc[j][i][c], m);
  if (phase != 0) return;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float* out = partial + ((int64_t)blockIdx.x * 9 + di * 3 + j) * F * F +
                 co_base + 4 * co_grp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* o = out + (4 * ci_grp + i) * F;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[j][i][0], acc[j][i][1], acc[j][i][2], acc[j][i][3]);
      *reinterpret_cast<float4*>(o + S::kCB / 2) =
          make_float4(acc[j][i][4], acc[j][i][5], acc[j][i][6], acc[j][i][7]);
    }
  }
}

// dw[e] = sum over chunks, in chunk order, of partial[chunk, e].
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ partial, int chunks, int n,
                    float* __restrict__ dw) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += (double)partial[(int64_t)k * n + e];
  dw[e] = (float)s;
}

// ----------------------------------------------- tensor-core tiles ----

struct alignas(8) Bf16x4 {
  bf16 v[4];
};

// A row of C bf16 values in shared memory takes C + 8: rows then start 16
// bytes apart modulo 128, so the 8 rows that one ldmatrix phase reads fall
// in 8 distinct 16-byte bank groups (C a multiple of 8).
template <int C>
__host__ __device__ constexpr int tc_stride() { return C + 8; }

// s[py, px, 0:C] = act(in[b, gy0 + py, gx0 + px, c0 : c0 + C]) in bf16 for
// a ROWS x COLS rectangle, zero outside the image, pixel rows `stride`
// apart; act as in conv_kernel, its rounding that of the bf16 store. A bf16
// source without GN comes in by cp.async (the caller commits and waits),
// an f32 one through registers, kBatch float4 loads in flight per thread.
template <int F, int C, int ROWS, int COLS, typename Tin, bool GN_IN>
__device__ __forceinline__ void stage_rect(
    const Tin* __restrict__ in, const float* __restrict__ gn_stats,
    const float* __restrict__ gn_s, const float* __restrict__ gn_b, int nG,
    int b, int H, int W, int gy0, int gx0, int c0, bf16* s, int stride) {
  constexpr bool kAsync = std::is_same<Tin, bf16>::value && !GN_IN;
  static_assert(kAsync || std::is_same<Tin, float>::value, "source type");
  constexpr int kVec = kAsync ? 8 : 4;  // channels per step
  constexpr int kPer = C / kVec;
  constexpr int kN = ROWS * COLS * kPer;
  constexpr int kBatch = 4;
  // element i: pixel i / kPer of the rectangle, channels from (i % kPer) * kVec
  auto locate = [&](int i, bf16*& dst, int64_t& src) {
    const int pix = i / kPer;
    const int cv = (i - pix * kPer) * kVec;
    const int py = pix / COLS;
    const int gy = gy0 + py;
    const int gx = gx0 + pix - py * COLS;
    dst = s + pix * stride + cv;
    src = (((int64_t)b * H + gy) * W + gx) * F + c0 + cv;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  if constexpr (kAsync) {
    for (int i = threadIdx.x; i < kN; i += kThreads) {
      bf16* dst;
      int64_t src;
      if (locate(i, dst, src)) {
        cp_async_16(dst, in + src);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < kN; i0 += kBatch * kThreads) {
      float4 q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // the loads first, then the stores
        const int i = i0 + u * kThreads;
        bf16* dst;
        int64_t src;
        q[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < kN && locate(i, dst, src))
          q[u] = *reinterpret_cast<const float4*>(in + src);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= kN) break;
        bf16* dst;
        int64_t src;
        const bool inside = locate(i, dst, src);
        float v[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
        if (GN_IN && inside) {
          const int c = c0 + (i % kPer) * kVec;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int g = b * kGroups + (c + j) / (F / kGroups);
            v[j] = fmaxf(gn_affine(v[j], gn_stats[g], gn_stats[nG + g],
                                   gn_s[c + j], gn_b[c + j]), 0.f);
          }
        }
        Bf16x4 o;
#pragma unroll
        for (int j = 0; j < 4; ++j) o.v[j] = __float2bfloat16(v[j]);
        *reinterpret_cast<Bf16x4*>(dst) = o;
      }
    }
  }
}

template <int F>
struct TcConvShape {
  static constexpr int kStride = tc_stride<F>();
  static constexpr int kTapElems = F * kStride;  // one tap's (F_in, F_out)
  static constexpr size_t kTapOffset =
      align16((size_t)kTcPatchH * kTcPatchW * kStride * sizeof(bf16));
  static constexpr size_t kStageBytes = kTapOffset + 2 * kTapElems * sizeof(bf16);
  static constexpr int kOutStride = F + 4;  // the f32 tile of the epilogue
  static constexpr size_t kOutBytes = (size_t)kTcPix * kOutStride * sizeof(float);
  // the epilogue's thread layout: pixel groups x channel groups of 8
  // adjacent channels
  static constexpr int kCoGroups = F / kChanPerThread;
  static constexpr int kPixGroups = kThreads / kCoGroups;
  static constexpr int kPixPerThread = kTcPix / kPixGroups;
  static constexpr int kGroupSize = F / kGroups;
  static constexpr int kSlotChans = kGroupSize < kChanPerThread ? kGroupSize
                                                                : kChanPerThread;
  static constexpr int kSlots = kChanPerThread / kSlotChans;
  static constexpr size_t kStatOffset =
      align16(kStageBytes > kOutBytes ? kStageBytes : kOutBytes);
  static constexpr size_t kSmemBytes =
      kStatOffset + (size_t)kWarps * kCoGroups * kSlots * 2 * sizeof(double);
  static_assert(kTcPix % kPixGroups == 0 && F % 16 == 0, "tile");
};

// w (9, F_in, F_out) bf16, tap `tap`, into s by cp.async (16 bytes a copy)
template <int F>
__device__ __forceinline__ void stage_tap(const bf16* __restrict__ w, int tap,
                                          bf16* s) {
  constexpr int kPer = F / 8;
  for (int i = threadIdx.x; i < F * kPer; i += kThreads) {
    const int ci = i / kPer;
    const int cv = (i - ci * kPer) * 8;
    cp_async_16(s + ci * tc_stride<F>() + cv, w + ((int64_t)tap * F + ci) * F + cv);
  }
}

// conv_kernel's function on the tensor cores; w (9, F_in, F_out) bf16.
// Three blocks an SM up to F = 64 (<= 85 registers, 45 KB of shared memory
// at F = 64); F = 128 takes 118 KB, one block.
template <int F, typename Tin, bool GN_IN>
__global__ void __launch_bounds__(kThreads, F <= 64 ? 3 : 1)
conv_tc_kernel(const Tin* __restrict__ in, const bf16* __restrict__ w,
               const float* __restrict__ gn_stats, const float* __restrict__ gn_s,
               const float* __restrict__ gn_b, int H, int W,
               float* __restrict__ out, const float* __restrict__ add,
               double* __restrict__ stat_partials) {
  using S = TcConvShape<F>;
  bf16* s_patch = reinterpret_cast<bf16*>(tower_smem);
  bf16* s_tap = reinterpret_cast<bf16*>(tower_smem + S::kTapOffset);
  float* s_out = reinterpret_cast<float*>(tower_smem);  // after the products
  double* s_stat = reinterpret_cast<double*>(tower_smem + S::kStatOffset);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTcRows;
  const int x0 = blockIdx.x * kTileW;
  const int nG = gridDim.z * kGroups;

  stage_rect<F, F, kTcPatchH, kTcPatchW, Tin, GN_IN>(
      in, gn_stats, gn_s, gn_b, nG, b, H, W, y0 - 1, x0 - 1, 0, s_patch,
      S::kStride);
  stage_tap<F>(w, 0, s_tap);
  cp_async_commit();

  // lane l gives the address of row l % 8 of matrix l / 8. A (pixels x
  // F_in, ldmatrix): matrices (pixels 0-7, k 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15) = a[0..3]. B (F_in x F_out, ldmatrix.trans of the
  // row-major taps): (k 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
  // 8-15) = b0, b1 of two n8 tiles.
  const int lrow = lane % 8 + 8 * ((lane / 8) % 2);
  const int lcol = 8 * (lane / 16);
  float acc[F / 8][4];
#pragma unroll
  for (int j = 0; j < F / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) {  // the next tap's weights, in flight during this one
      stage_tap<F>(w, tap + 1, s_tap + ((tap + 1) % 2) * S::kTapElems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int di = tap / 3;
    const int dj = tap - di * 3;
    const bf16* a_row =
        s_patch + ((warp + di) * kTcPatchW + lrow + dj) * S::kStride + lcol;
    const bf16* b_row = s_tap + (tap % 2) * S::kTapElems + lrow * S::kStride + lcol;
#pragma unroll
    for (int k0 = 0; k0 < F; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_row + k0);
#pragma unroll
      for (int n = 0; n < F / 16; ++n) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, b_row + k0 * S::kStride + 16 * n);
        mma_bf16_16816(acc[2 * n], a, bq[0], bq[1]);
        mma_bf16_16816(acc[2 * n + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this tap's buffer is consumed
  }

  // the f32 tile through shared memory: d[0], d[1] = (pixel g, channels
  // 2t, 2t+1) and d[2], d[3] = (pixel g + 8, same), g = lane / 4, t = lane % 4
  {
    float* o = s_out + (warp * kTileW + lane / 4) * S::kOutStride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      o[8 * j] = acc[j][0];
      o[8 * j + 1] = acc[j][1];
      o[8 * S::kOutStride + 8 * j] = acc[j][2];
      o[8 * S::kOutStride + 8 * j + 1] = acc[j][3];
    }
  }
  __syncthreads();

  // conv_kernel's epilogue: store, residual, the group sums of this tile
  const int co_grp = tid % S::kCoGroups;
  const int pg = tid / S::kCoGroups;
  const int co0 = co_grp * kChanPerThread;
  double st[S::kSlots][2];
#pragma unroll
  for (int q = 0; q < S::kSlots; ++q) st[q][0] = st[q][1] = 0.0;
#pragma unroll
  for (int k = 0; k < S::kPixPerThread; ++k) {
    const int p = pg + k * S::kPixGroups;
    const int y = y0 + p / kTileW;
    const int x = x0 + p % kTileW;
    if (y < H && x < W) {
      const int64_t off = (((int64_t)b * H + y) * W + x) * F + co0;
      const float* src = s_out + p * S::kOutStride + co0;
      float v[kChanPerThread];
#pragma unroll
      for (int j = 0; j < kChanPerThread; ++j) {
        v[j] = src[j];
        if (add != nullptr) v[j] += add[off + j];
        st[j / S::kSlotChans][0] += (double)v[j];
        st[j / S::kSlotChans][1] += (double)v[j] * (double)v[j];
      }
      reinterpret_cast<float4*>(out + off)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(out + off)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  if (stat_partials == nullptr) return;  // uniform over the block

#pragma unroll
  for (int q = 0; q < S::kSlots; ++q) {
#pragma unroll
    for (int m = S::kCoGroups; m < 32; m *= 2) {
      st[q][0] += __shfl_xor_sync(0xffffffffu, st[q][0], m);
      st[q][1] += __shfl_xor_sync(0xffffffffu, st[q][1], m);
    }
  }
  if (lane < S::kCoGroups) {  // lane == co_grp here
#pragma unroll
    for (int q = 0; q < S::kSlots; ++q) {
      double* d = s_stat + ((warp * S::kCoGroups + lane) * S::kSlots + q) * 2;
      d[0] = st[q][0];
      d[1] = st[q][1];
    }
  }
  __syncthreads();
  if (tid < kGroups) {
    double s = 0.0, ss = 0.0;
    for (int wp = 0; wp < kWarps; ++wp)
      for (int c = 0; c < S::kCoGroups; ++c)
        for (int q = 0; q < S::kSlots; ++q) {
          const int g = (c * kChanPerThread + q * S::kSlotChans) / S::kGroupSize;
          if (g != tid) continue;
          const double* d = s_stat + ((wp * S::kCoGroups + c) * S::kSlots + q) * 2;
          s += d[0];
          ss += d[1];
        }
    const int64_t tile =
        ((int64_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    stat_partials[(tile * kGroups + tid) * 2] = s;
    stat_partials[(tile * kGroups + tid) * 2 + 1] = ss;
  }
}

template <int F>
struct TcWgradShape {
  static constexpr int kCB = F == 128 ? 16 : (F < 32 ? F : 32);  // F_out a block
  static constexpr int kSplits = F / kCB;
  static constexpr int kMT = F / 16;   // F_in tiles of 16
  static constexpr int kNB = kCB / 16; // F_out tiles of 16 in a block
  static constexpr int kPairs = kMT * kNB;
  static constexpr int kWarpsPerPair = kWarps / kPairs;
  static constexpr int kTaps = (9 + kWarpsPerPair - 1) / kWarpsPerPair;  // a warp's
  static constexpr int kStride = tc_stride<F>();
  static constexpr int kDcStride = tc_stride<kCB>();
  static constexpr size_t kDcOffset =
      align16((size_t)kTcPatchH * kTcPatchW * kStride * sizeof(bf16));
  static constexpr size_t kBufBytes =
      align16(kDcOffset + (size_t)kTcPix * kDcStride * sizeof(bf16));
  static constexpr size_t kSmemBytes = 2 * kBufBytes;
  static_assert(kPairs <= kWarps && kWarps % kPairs == 0, "warps");
};

// Tile t of the (B, H/8, W/16) grid of 8 x 16 pixel tiles, into buffer s:
// its (10 x 18) x F input patch, activated, and its 128 x kCB slice of dc.
template <int F, typename Tin, bool GN_IN>
__device__ __forceinline__ void stage_wgrad_tile(
    const Tin* __restrict__ in, const float* __restrict__ gn_stats,
    const float* __restrict__ gn_s, const float* __restrict__ gn_b,
    const float* __restrict__ dc, int B, int H, int W, int tiles_x,
    int tiles_y, int t, int co_base, unsigned char* s) {
  using S = TcWgradShape<F>;
  const int b = t / (tiles_x * tiles_y);
  const int r = t - b * tiles_x * tiles_y;
  const int y0 = r / tiles_x * kTcRows;
  const int x0 = r % tiles_x * kTileW;
  stage_rect<F, F, kTcPatchH, kTcPatchW, Tin, GN_IN>(
      in, gn_stats, gn_s, gn_b, B * kGroups, b, H, W, y0 - 1, x0 - 1, 0,
      reinterpret_cast<bf16*>(s), S::kStride);
  stage_rect<F, S::kCB, kTcRows, kTileW, float, false>(
      dc, nullptr, nullptr, nullptr, 0, b, H, W, y0, x0, co_base,
      reinterpret_cast<bf16*>(s + S::kDcOffset), S::kDcStride);
}

// wgrad_kernel's function on the tensor cores. Grid (chunks, kSplits):
// block (c, s) sums tiles [c * per_chunk, (c + 1) * per_chunk) into
// partial[c, tap, ci, s * kCB : (s + 1) * kCB] for every tap.
template <int F, typename Tin, bool GN_IN>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: <= 128 registers
wgrad_tc_kernel(const Tin* __restrict__ in, const float* __restrict__ gn_stats,
                const float* __restrict__ gn_s, const float* __restrict__ gn_b,
                const float* __restrict__ dc, int B, int H, int W, int per_chunk,
                float* __restrict__ partial) {
  using S = TcWgradShape<F>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int co_base = blockIdx.y * S::kCB;
  const int pair = warp % S::kPairs;
  const int mt = pair % S::kMT;          // this warp's 16 F_in
  const int nb = pair / S::kMT;          // and 16 F_out of the block's kCB
  const int tap0 = warp / S::kPairs * S::kTaps;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTcRows - 1) / kTcRows;
  const int t_begin = blockIdx.x * per_chunk;
  const int t_end = min(t_begin + per_chunk, B * tiles_x * tiles_y);

  // A (F_in x pixels) = the patch shifted by the tap, read with
  // ldmatrix.trans: matrices (ci 0-7, px 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15) = a[0..3], lane l addressing pixel l % 8 + 8 (l / 16) at
  // channel offset 8 ((l / 8) % 2). B (pixels x F_out) = dc, as the conv's
  // weights.
  const int a_pix = lane % 8 + 8 * (lane / 16);
  const int a_ch = mt * 16 + 8 * ((lane / 8) % 2);
  const int b_pix = lane % 8 + 8 * ((lane / 8) % 2);
  const int b_ch = nb * 16 + 8 * (lane / 16);
  float acc[S::kTaps][2][4];
#pragma unroll
  for (int k = 0; k < S::kTaps; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][h][i] = 0.f;

  if (t_begin < t_end)
    stage_wgrad_tile<F, Tin, GN_IN>(in, gn_stats, gn_s, gn_b, dc, B, H, W,
                                    tiles_x, tiles_y, t_begin, co_base, tower_smem);
  cp_async_commit();
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) % 2;
    if (t + 1 < t_end) {  // the next tile, in flight during this one
      stage_wgrad_tile<F, Tin, GN_IN>(in, gn_stats, gn_s, gn_b, dc, B, H, W,
                                      tiles_x, tiles_y, t + 1, co_base,
                                      tower_smem + (1 - buf) * S::kBufBytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* patch = reinterpret_cast<const bf16*>(tower_smem + buf * S::kBufBytes);
    const bf16* dcs = reinterpret_cast<const bf16*>(tower_smem + buf * S::kBufBytes +
                                                    S::kDcOffset);
#pragma unroll 1
    for (int row = 0; row < kTcRows; ++row) {  // K: 16 pixels a step
      uint32_t bq[4];
      ldmatrix_x4_trans(bq, dcs + (row * kTileW + b_pix) * S::kDcStride + b_ch);
#pragma unroll
      for (int k = 0; k < S::kTaps; ++k) {
        const int tap = tap0 + k;
        if (tap < 9) {  // uniform over the warp
          const int di = tap / 3;
          const int dj = tap - di * 3;
          uint32_t a[4];
          ldmatrix_x4_trans(
              a, patch + ((row + di) * kTcPatchW + a_pix + dj) * S::kStride + a_ch);
          mma_bf16_16816(acc[k][0], a, bq[0], bq[1]);
          mma_bf16_16816(acc[k][1], a, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed
  }

  float* out = partial + (int64_t)blockIdx.x * 9 * F * F;
  const int ci = mt * 16 + lane / 4;
  const int co = co_base + nb * 16 + 2 * (lane % 4);
#pragma unroll
  for (int k = 0; k < S::kTaps; ++k) {
    const int tap = tap0 + k;
    if (tap >= 9) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[((int64_t)tap * F + ci + 8 * (i / 2)) * F + co + 8 * h + i % 2] =
            acc[k][h][i];
  }
}

// ------------------------------------------------------------- host ----

template <int F>
dim3 conv_grid(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW,
              (H + ConvShape<F>::kTileH - 1) / ConvShape<F>::kTileH, B);
}

template <int F>
int conv_tiles(int H, int W) {
  const dim3 g = conv_grid<F>(1, H, W);
  return (int)(g.x * g.y);
}

int red_chunks(int H, int W) {
  const int hw = H * W;
  const int c = (hw + 63) / 64;
  return c < kMaxRedChunks ? c : kMaxRedChunks;
}

// `tiles` pixel tiles in at most max_chunks chunks: tiles per chunk and
// the chunk count
void split_tiles(int tiles, int max_chunks, int* per, int* chunks) {
  const int n = tiles < max_chunks ? tiles : max_chunks;
  *per = (tiles + n - 1) / n;
  *chunks = (tiles + *per - 1) / *per;
}

// the f32 wgrad's 8 x 16 pixel tiles
void wgrad_split(int B, int H, int W, int* per, int* chunks) {
  const int tiles =
      B * ((H + kWgRows - 1) / kWgRows) * ((W + kWgCols - 1) / kWgCols);
  split_tiles(tiles, kMaxWgradChunks, per, chunks);
}

dim3 elementwise_grid(int B, int64_t hwf) {
  int64_t x = (hwf + kThreads - 1) / kThreads;
  if (x > 1024) x = 1024;
  return dim3((unsigned)x, B);
}

template <int F, bool GN_IN>
void launch_conv(const float* in, const float* w, const float* gn_stats,
                 const float* gn_s, const float* gn_b, int B, int H, int W,
                 float* out, const float* add, double* stat_partials,
                 cudaStream_t st) {
  constexpr size_t smem = ConvShape<F>::kSmemBytes;
  auto kernel = conv_kernel<F, GN_IN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<conv_grid<F>(B, H, W), kThreads, smem, st>>>(
      in, w, gn_stats, gn_s, gn_b, H, W, out, add, stat_partials);
}

void launch_stats(const double* partials, int B, int tiles, double count,
                  float* stats, cudaStream_t st) {
  gn_stats_kernel<<<B * kGroups, kStatThreads,
                    2 * kStatThreads * sizeof(double), st>>>(partials, tiles,
                                                            count, stats);
}

void launch_wgrad_reduce(const float* partial, int chunks, int F, float* dw,
                         cudaStream_t st) {
  const int n = 9 * F * F;
  wgrad_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, chunks, n, dw);
}

template <int F, bool GN_IN>
void launch_wgrad(const float* in, const float* gn_stats, const float* gn_s,
                  const float* gn_b, const float* dc, int B, int H, int W,
                  float* partial, float* dw, cudaStream_t st) {
  constexpr size_t smem = WgradShape<F>::kSmemBytes;
  int per, chunks;
  wgrad_split(B, H, W, &per, &chunks);
  auto kernel = wgrad_kernel<F, GN_IN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(chunks, WgradShape<F>::kSplits), WgradShape<F>::kThreads, smem,
             st>>>(
      in, gn_stats, gn_s, gn_b, dc, B, H, W, per, partial);
  launch_wgrad_reduce(partial, chunks, F, dw, st);
}

dim3 tc_conv_grid(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTcRows - 1) / kTcRows, B);
}

int tc_conv_tiles(int H, int W) {
  const dim3 g = tc_conv_grid(1, H, W);
  return (int)(g.x * g.y);
}

// 8 x 16 pixel tiles per wgrad_tc chunk, and the chunk count
void tc_wgrad_split(int B, int H, int W, int* per, int* chunks) {
  split_tiles(B * tc_conv_tiles(H, W), kMaxTcChunks, per, chunks);
}

template <int F, typename Tin, bool GN_IN>
void launch_conv_tc(const Tin* in, const bf16* w, const float* gn_stats,
                    const float* gn_s, const float* gn_b, int B, int H, int W,
                    float* out, const float* add, double* stat_partials,
                    cudaStream_t st) {
  constexpr size_t smem = TcConvShape<F>::kSmemBytes;
  auto kernel = conv_tc_kernel<F, Tin, GN_IN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<tc_conv_grid(B, H, W), kThreads, smem, st>>>(
      in, w, gn_stats, gn_s, gn_b, H, W, out, add, stat_partials);
}

template <int F, typename Tin, bool GN_IN>
void launch_wgrad_tc(const Tin* in, const float* gn_stats, const float* gn_s,
                     const float* gn_b, const float* dc, int B, int H, int W,
                     float* partial, float* dw, cudaStream_t st) {
  constexpr size_t smem = TcWgradShape<F>::kSmemBytes;
  int per, chunks;
  tc_wgrad_split(B, H, W, &per, &chunks);
  auto kernel = wgrad_tc_kernel<F, Tin, GN_IN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(chunks, TcWgradShape<F>::kSplits), kThreads, smem, st>>>(
      in, gn_stats, gn_s, gn_b, dc, B, H, W, per, partial);
  launch_wgrad_reduce(partial, chunks, F, dw, st);
}

// The tiles by compute dtype T: f32 on the CUDA cores, bf16 on the tensor
// cores (weights w in T).
template <typename T>
constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

template <int F, typename T, typename Tin, bool GN_IN>
void conv(const Tin* in, const T* w, const float* gn_stats, const float* gn_s,
          const float* gn_b, int B, int H, int W, float* out, const float* add,
          double* stat_partials, cudaStream_t st) {
  if constexpr (is_bf16<T>()) {
    launch_conv_tc<F, Tin, GN_IN>(in, w, gn_stats, gn_s, gn_b, B, H, W, out,
                                  add, stat_partials, st);
  } else {
    launch_conv<F, GN_IN>(in, w, gn_stats, gn_s, gn_b, B, H, W, out, add,
                          stat_partials, st);
  }
}

template <int F, typename T, typename Tin, bool GN_IN>
void wgrad(const Tin* in, const float* gn_stats, const float* gn_s,
           const float* gn_b, const float* dc, int B, int H, int W,
           float* partial, float* dw, cudaStream_t st) {
  if constexpr (is_bf16<T>()) {
    launch_wgrad_tc<F, Tin, GN_IN>(in, gn_stats, gn_s, gn_b, dc, B, H, W,
                                   partial, dw, st);
  } else {
    launch_wgrad<F, GN_IN>(in, gn_stats, gn_s, gn_b, dc, B, H, W, partial, dw,
                           st);
  }
}

// The forward over N blocks. a(n) is block n's input: x for n = 0, else
// a slice of `carry` (all N - 1 kept when `save`, else two in turn); c1,
// c2 and stats likewise per block when `save`, else one slot. The last
// block writes y; with y null (the backward's replay) it is skipped.
template <int F, typename T>
void forward_blocks(const T* x, T* y, const T* w1, const float* s1,
                    const float* b1, const T* w2, const float* s2,
                    const float* b2, int N, int B, int H, int W, bool save,
                    T* carry, float* c1, float* c2, float* stats,
                    double* partials, cudaStream_t st) {
  const int64_t act = (int64_t)B * H * W * F;
  const int hwf = H * W * F;
  const int tiles = is_bf16<T>() ? tc_conv_tiles(H, W) : conv_tiles<F>(H, W);
  const double count = (double)H * W * (F / kGroups);
  const int nst = 4 * B * kGroups;  // mean1, inv1, mean2, inv2
  auto a_at = [&](int n) -> T* {
    return carry + (int64_t)(save ? n - 1 : (n - 1) % 2) * act;
  };
  for (int n = 0; n < N; ++n) {
    const T* a = n == 0 ? x : a_at(n);
    float* c1n = c1 + (save ? n * act : 0);
    float* c2n = c2 + (save ? n * act : 0);
    float* st1 = stats + (save ? n * nst : 0);
    float* st2 = st1 + 2 * B * kGroups;
    const int64_t wo = (int64_t)n * 9 * F * F;
    conv<F, T, T, false>(a, w1 + wo, nullptr, nullptr, nullptr, B, H, W, c1n,
                         nullptr, partials, st);
    launch_stats(partials, B, tiles, count, st1, st);
    conv<F, T, float, true>(c1n, w2 + wo, st1, s1 + n * F, b1 + n * F, B, H, W,
                            c2n, nullptr, partials, st);
    launch_stats(partials, B, tiles, count, st2, st);
    T* out = n == N - 1 ? y : a_at(n + 1);
    if (out != nullptr) {
      gn_skip_kernel<F, T><<<elementwise_grid(B, hwf), kThreads, 0, st>>>(
          c2n, st2, s2 + n * F, b2 + n * F, a, hwf, out);
    }
  }
}

struct BwdScratch {
  void* carry;      // N - 1 block inputs, compute dtype
  float* c1;        // N x act
  float* c2;        // N x act
  float* stats;     // N x 4 x B x G
  double* partials; // tower_partials_doubles
  double* sums;     // B x F x 2
  float* m;         // B x G x 2
  float* dc;        // act
  float* dr;        // act
  float* da;        // 2 x act
  float* wpart;     // tower_wgrad_floats
};

template <int F, bool MASK>
void gn_backward(const float* src, const float* c, const float* stats,
                 const float* s, const float* bias, int B, int H, int W,
                 bool round, const BwdScratch& k, float* dscale, float* dbias,
                 cudaStream_t st) {
  const int chunks = red_chunks(H, W);
  const int hwf = H * W * F;
  gn_bwd_reduce_kernel<F, MASK><<<dim3(chunks, B), kThreads,
                                  2 * kThreads * sizeof(double), st>>>(
      src, c, stats, s, bias, H * W, k.partials);
  gn_bwd_finalize_kernel<<<1, kThreads, 0, st>>>(
      k.partials, B, F, chunks, s, (double)H * W * (F / kGroups), k.sums,
      dscale, dbias, k.m);
  gn_bwd_apply_kernel<F, MASK><<<elementwise_grid(B, hwf), kThreads, 0, st>>>(
      src, c, stats, s, bias, k.m, hwf, round ? 1 : 0, k.dc);
}

template <int F, typename T>
void backward_blocks(const float* dy, const T* x, const T* w1,
                     const float* s1, const float* b1, const T* w2,
                     const float* s2, const float* b2, const T* wt1,
                     const T* wt2, int N, int B, int H, int W, float* dx,
                     float* dw1, float* ds1, float* db1, float* dw2,
                     float* ds2, float* db2, const BwdScratch& k,
                     cudaStream_t st) {
  const int64_t act = (int64_t)B * H * W * F;
  const int nst = 4 * B * kGroups;
  const bool round = is_bf16<T>();  // dc, a conv operand, in the compute dtype
  T* carry = static_cast<T*>(k.carry);
  forward_blocks<F, T>(x, nullptr, w1, s1, b1, w2, s2, b2, N, B, H, W, true,
                       carry, k.c1, k.c2, k.stats, k.partials, st);
  const float* da = dy;
  for (int n = N - 1; n >= 0; --n) {
    const T* a = n == 0 ? x : carry + (int64_t)(n - 1) * act;
    const float* c1n = k.c1 + n * act;
    const float* c2n = k.c2 + n * act;
    const float* st1 = k.stats + n * nst;
    const float* st2 = st1 + 2 * B * kGroups;
    const int64_t wo = (int64_t)n * 9 * F * F;
    // GN2, then conv2's weights (its input r rebuilt from c1) and input
    gn_backward<F, false>(da, c2n, st2, s2 + n * F, b2 + n * F, B, H, W,
                          round, k, ds2 + n * F, db2 + n * F, st);
    wgrad<F, T, float, true>(c1n, st1, s1 + n * F, b1 + n * F, k.dc, B, H, W,
                             k.wpart, dw2 + wo, st);
    conv<F, T, float, false>(k.dc, wt2 + wo, nullptr, nullptr, nullptr, B, H,
                             W, k.dr, nullptr, nullptr, st);
    // the ReLU mask and GN1, then conv1's weights and input, plus the skip
    gn_backward<F, true>(k.dr, c1n, st1, s1 + n * F, b1 + n * F, B, H, W,
                         round, k, ds1 + n * F, db1 + n * F, st);
    wgrad<F, T, T, false>(a, nullptr, nullptr, nullptr, k.dc, B, H, W, k.wpart,
                          dw1 + wo, st);
    float* out = n == 0 ? dx : k.da + (n % 2) * act;
    conv<F, T, float, false>(k.dc, wt1 + wo, nullptr, nullptr, nullptr, B, H,
                             W, out, da, nullptr, st);
    da = out;
  }
}

// Calls fn with std::integral_constant<int, F> for F in {16, 32, 64, 128},
// then returns cudaGetLastError().
template <typename Fn>
int with_features(int N, int B, int H, int W, int F, Fn&& fn) {
  if (N < 1 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (F) {
    case 16: fn(std::integral_constant<int, 16>{}); break;
    case 32: fn(std::integral_constant<int, 32>{}); break;
    case 64: fn(std::integral_constant<int, 64>{}); break;
    case 128: fn(std::integral_constant<int, 128>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int partials_doubles(int B, int H, int W, int F) {
  int tiles = 0;  // per image, of the f32 conv tile
  switch (F) {
    case 16: tiles = conv_tiles<16>(H, W); break;
    case 32: tiles = conv_tiles<32>(H, W); break;
    case 64: tiles = conv_tiles<64>(H, W); break;
    case 128: tiles = conv_tiles<128>(H, W); break;
    default: return -1;
  }
  const int tc = tc_conv_tiles(H, W);
  const int conv = B * (tiles > tc ? tiles : tc) * kGroups * 2;
  const int red = B * red_chunks(H, W) * F * 2;
  return conv > red ? conv : red;
}

}  // namespace

extern "C" {

const char* tower_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Sizes of the scratch buffers the wrapper allocates, enough for either
// dtype: the fp64 partials (conv tile sums or GroupNorm-backward chunk
// sums) and the f32 wgrad partials; -1 for an F the source does not
// instantiate.
int tower_partials_doubles(int B, int H, int W, int F) {
  return partials_doubles(B, H, W, F);
}

int tower_wgrad_floats(int B, int H, int W, int F) {
  int per, chunks, tc_chunks;
  wgrad_split(B, H, W, &per, &chunks);
  tc_wgrad_split(B, H, W, &per, &tc_chunks);
  return (chunks > tc_chunks ? chunks : tc_chunks) * 9 * F * F;
}

// K4. x and y (B, H, W, F) and w1, w2 (N, 9, F, F) in the compute dtype
// (bf16 if `bf16`, else f32); s1, b1, s2, b2 (N, F) f32. Scratch: carry
// (2 activations, compute dtype), c1 and c2 (one f32 activation each),
// stats (4*B*8 f32), partials.
int tower_forward(const void* x, void* y, const void* w1, const float* s1,
                  const float* b1, const void* w2, const float* s2,
                  const float* b2, int N, int B, int H, int W, int F, int bf16,
                  void* carry, float* c1, float* c2, float* stats,
                  double* partials, cudaStream_t stream) {
  return with_features(N, B, H, W, F, [&](auto f) {
    constexpr int kF = decltype(f)::value;
    auto run = [&](auto t) {
      using T = decltype(t);
      forward_blocks<kF, T>(static_cast<const T*>(x), static_cast<T*>(y),
                            static_cast<const T*>(w1), s1, b1,
                            static_cast<const T*>(w2), s2, b2, N, B, H, W,
                            false, static_cast<T*>(carry), c1, c2, stats,
                            partials, stream);
    };
    if (bf16) run(__nv_bfloat16{}); else run(0.f);
  });
}

// K5. dy f32 and x (compute dtype) (B, H, W, F); w1, w2 as for K4; wt1,
// wt2 the same taps flipped and transposed (the dX conv's weights), in
// the compute dtype. Outputs, all f32: dx (B, H, W, F), dw1, dw2 (N, 9,
// F, F), ds1, db1, ds2, db2 (N, F). Scratch as listed in BwdScratch.
int tower_backward(const float* dy, const void* x, const void* w1,
                   const float* s1, const float* b1, const void* w2,
                   const float* s2, const float* b2, const void* wt1,
                   const void* wt2, int N, int B, int H, int W, int F,
                   int bf16, float* dx, float* dw1, float* ds1, float* db1,
                   float* dw2, float* ds2, float* db2, void* carry, float* c1,
                   float* c2, float* stats, double* partials, double* sums,
                   float* m, float* dc, float* dr, float* da, float* wpart,
                   cudaStream_t stream) {
  const BwdScratch k{carry, c1, c2, stats, partials, sums, m, dc, dr, da, wpart};
  return with_features(N, B, H, W, F, [&](auto f) {
    constexpr int kF = decltype(f)::value;
    auto run = [&](auto t) {
      using T = decltype(t);
      backward_blocks<kF, T>(
          dy, static_cast<const T*>(x), static_cast<const T*>(w1), s1, b1,
          static_cast<const T*>(w2), s2, b2, static_cast<const T*>(wt1),
          static_cast<const T*>(wt2), N, B, H, W, dx, dw1, ds1, db1, dw2, ds2,
          db2, k, stream);
    };
    if (bf16) run(__nv_bfloat16{}); else run(0.f);
  });
}

}  // extern "C"
