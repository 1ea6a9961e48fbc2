// K6: the eval-mode ResnetBlock1d with BatchNorm folded into its
// convolutions, in one pass per tile of frames.
//
// Replaces _fused_1d_kernel, freesound_classification_tpu/ops/
// pallas_resnet1d.py (reached through resnet_block_1d_infer). The 2d blocks
// (K4/K5, K7) run on the convolution core of conv_blocks.cu.
//
// Per frame t of a (B, C, T) bf16 map, with folded bf16 weights w1 (C x C),
// w2 (3 x C x C), w3 (C x C), float32 biases b and PReLU slopes a
// (prelu(v) = v >= 0 ? v : a v):
//   h1[t] = bf16(prelu(x[t] w1 + b1, a1)) inside [0, T), 0 outside it
//   h2[t] = bf16(prelu(sum_taps h1[t + tap - 1] w2[tap] + b2, a2))
//   y[t]  = bf16(prelu((h2[t] w3 + b3) + x[t], a3))
// Products are bf16 x bf16 with float32 sums (the TPU kernel's rounding
// points). SAME padding is on h1: a halo frame outside the clip reads
// h1 = 0, not prelu(b1) of a zero x.
//
// Design. One block of eight warps per tile of up to 64 frames. The block
// loads x over the tile plus a one-frame halo into shared memory as rows of
// channels (leading dimension cp + 16, so that every row starts on a
// 32-byte boundary), computes h1 over the halo rows, then h2 over the band
// of the tile's rows, then y. Every tap is a constant row offset, and each
// convolution is a product of rows by a weight matrix on the bf16 tensor
// cores (nvcuda::wmma m16n16k16, float32 accumulators). Weights stream from
// global memory and L2; the warps share out (16-channel column strip, pair
// of 16-row tiles) items, each reusing a weight fragment over its two row
// tiles and loading the next fragment while the tensor cores run the
// current one. Each row's frame offset (or -1 off the clip), the biases and
// the slopes are put in shared memory once per block, so the epilogues do
// no index arithmetic and no global loads: x stays in shared memory for the
// residual, h2 has rows of its own, and y is staged in h1's rows (dead by
// then) and stored with neighbouring threads on neighbouring addresses in
// the map's own layout.
//
// Bound. At the hierarchical path's block0 (B 128, C 64, T 215) the block
// moves 7 MB and does 1.1 GFLOP. This version has no TMA, wgmma or
// pipelining: weight fragments come straight from L2 and the tensor cores
// wait on them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 2;  // 16-row tiles that share one weight fragment

struct Geometry {
  int channels;  // C
  int cp;        // C rounded up to 16: the weights' padded width
  int ld;        // shared rows' leading dimension, cp + 16
  int length;    // T
  int tile;      // frames per tile
  int tiles;     // tiles per clip
  int n_halo;    // halo frames: tile + 2
  int m_rows;    // band rows, a multiple of 16
  int r1;        // shared rows of x (and h1), a multiple of 16
  long long sb, sc, st;  // element strides of x and out
  int channel_fast;      // sc == 1: lanes walk channels, else frames
};

// halo row q -> its frame's offset in the clip, or -1 off the clip (or past
// the halo)
__device__ long long halo_offset(const Geometry& g, int t0, int q) {
  if (q >= g.n_halo) return -1;
  const int t = t0 - 1 + q;
  if (t < 0 || t >= g.length) return -1;
  return t * g.st;
}

// the output at halo row `row` -> its offset in the clip, or -1 for the
// halo rows, rows past the tile and frames past the clip
__device__ long long center_offset(const Geometry& g, int t0, int row) {
  if (row < 1 || row >= g.tile + 1) return -1;
  const int t = t0 - 1 + row;
  if (t >= g.length) return -1;
  return t * g.st;
}

using WeightFragment =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : __fmul_rn(a, v);
}

// acc[i] += the products of one step (tap, channels k0..k0+15) for the
// row tiles m0 + i: a's rows shifted by the tap's offset times the weight
// fragment fb.
__device__ __forceinline__ void step_products(
    const Geometry& g, const __nv_bfloat16* a, int a_base, int taps,
    int n_tiles, int m0, int step, const WeightFragment& fb,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc) {
  const int k_steps = g.cp / 16;
  const int off = taps == 1 ? 0 : step / k_steps - 1;
  const int k0 = (step % k_steps) * 16;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    if (m0 + i < n_tiles) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(
          fa, a + static_cast<long long>(a_base + (m0 + i) * 16 + off) * g.ld
                  + k0,
          g.ld);
      wmma::mma_sync(acc[i], fa, fb, acc[i]);
    }
  }
}

// For every item (16-channel column strip n, group of kGroup 16-row tiles
// from m0) of this warp, over the rows [0, n_rows): acc = sum over taps and
// channels of a[(row + a_base + tap - 1) * ld + c] * w[(tap * cp + c) * cp
// + col] (taps 1: the tap offset is 0), then epi(row, col, value) over each
// tile, one element per call (lane e of the tile: row e / 16, col e % 16).
// A step is one (tap, 16 channels); its weight fragment, 16 rows of 32
// bytes cp apart at w + 16 step cp + 16 n, is loaded while the step before
// it runs on the tensor cores.
template <typename Epilogue>
__device__ __forceinline__ void conv_rows(const Geometry& g,
                                          const __nv_bfloat16* a, int a_base,
                                          int taps, int n_rows,
                                          const __nv_bfloat16* __restrict__ w,
                                          float* stage, Epilogue epi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = n_rows / 16;
  const int n_strips = g.cp / 16;
  const int n_items = n_strips * ((n_tiles + kGroup - 1) / kGroup);
  const int steps = taps * n_strips;  // taps x (cp / 16) channel steps
  for (int item = warp; item < n_items; item += kWarps) {
    const int n = item % n_strips;
    const int m0 = (item / n_strips) * kGroup;
    const __nv_bfloat16* wn = w + n * 16;
    const long long step_stride = 16LL * g.cp;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) wmma::fill_fragment(acc[i], 0.f);
    WeightFragment f0, f1;
    wmma::load_matrix_sync(f0, wn, g.cp);
#pragma unroll 1
    for (int s = 0; s < steps; s += 2) {
      if (s + 1 < steps)
        wmma::load_matrix_sync(f1, wn + (s + 1) * step_stride, g.cp);
      step_products(g, a, a_base, taps, n_tiles, m0, s, f0, acc);
      if (s + 2 < steps)
        wmma::load_matrix_sync(f0, wn + (s + 2) * step_stride, g.cp);
      if (s + 1 < steps)
        step_products(g, a, a_base, taps, n_tiles, m0, s + 1, f1, acc);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (m0 + i < n_tiles) {
        wmma::store_matrix_sync(stage, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 256; e += 32)
          epi((m0 + i) * 16 + e / 16, n * 16 + e % 16, stage[e]);
        __syncwarp();
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resnet_block_1d_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w1,
                       const __nv_bfloat16* __restrict__ w2,
                       const __nv_bfloat16* __restrict__ w3,
                       const float* __restrict__ bias,   // (3, cp): b1-b3
                       const float* __restrict__ slope,  // (3, cp): a1-a3
                       __nv_bfloat16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // r1 rows
  __nv_bfloat16* h1 = xs + g.r1 * g.ld;  // r1 rows: h1, then y
  __nv_bfloat16* h2 = h1 + g.r1 * g.ld;  // m_rows rows
  float* stages = reinterpret_cast<float*>(h2 + g.m_rows * g.ld);
  float* stage = stages + (threadIdx.x / 32) * 256;
  float* vec = stages + kWarps * 256;  // b1, b2, b3, a1, a2, a3: 6 x cp
  long long* halo_at = reinterpret_cast<long long*>(vec + 6 * g.cp);  // r1
  long long* out_at = halo_at + g.r1;  // m_rows

  const int b = blockIdx.x / g.tiles;
  const int t0 = (blockIdx.x % g.tiles) * g.tile;
  const __nv_bfloat16* xb = x + b * g.sb;
  __nv_bfloat16* ob = out + b * g.sb;

  for (int i = threadIdx.x; i < 3 * g.cp; i += kThreads) {
    vec[i] = bias[i];
    vec[3 * g.cp + i] = slope[i];
  }
  for (int q = threadIdx.x; q < g.r1; q += kThreads)
    halo_at[q] = halo_offset(g, t0, q);
  for (int j = threadIdx.x; j < g.m_rows; j += kThreads)
    out_at[j] = center_offset(g, t0, 1 + j);
  __syncthreads();

  // x over the halo rows; zeros off the clip and past C
  for (int idx = threadIdx.x; idx < g.r1 * g.cp; idx += kThreads) {
    const int q = g.channel_fast ? idx / g.cp : idx % g.r1;
    const int k = g.channel_fast ? idx % g.cp : idx / g.r1;
    const long long at = halo_at[q];
    xs[q * g.ld + k] = k < g.channels && at >= 0 ? xb[k * g.sc + at]
                                                 : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  // h1 over every halo row: zero off the clip (SAME padding of conv2)
  conv_rows(g, xs, 0, 1, g.r1, w1, stage, [&](int q, int k, float v) {
    h1[q * g.ld + k] = __float2bfloat16_rn(
        halo_at[q] >= 0 ? prelu(__fadd_rn(v, vec[k]), vec[3 * g.cp + k])
                        : 0.f);
  });
  __syncthreads();

  // h2 over the band
  conv_rows(g, h1, 1, 3, g.m_rows, w2, stage, [&](int j, int k, float v) {
    h2[j * g.ld + k] = __float2bfloat16_rn(
        prelu(__fadd_rn(v, vec[g.cp + k]), vec[4 * g.cp + k]));
  });
  __syncthreads();  // h1 is dead from here on: y takes its rows

  // y = prelu(h2 w3 + b3 + x), x from its halo row 1 + j
  conv_rows(g, h2, 0, 1, g.m_rows, w3, stage, [&](int j, int k, float v) {
    const float y = __fadd_rn(__fadd_rn(v, vec[2 * g.cp + k]),
                              __bfloat162float(xs[(1 + j) * g.ld + k]));
    h1[j * g.ld + k] = __float2bfloat16_rn(prelu(y, vec[5 * g.cp + k]));
  });
  __syncthreads();

  // the band's frames to the map, in its own layout
  for (int idx = threadIdx.x; idx < g.m_rows * g.channels;
       idx += kThreads) {
    const int j = g.channel_fast ? idx / g.channels : idx % g.m_rows;
    const int k = g.channel_fast ? idx % g.channels : idx / g.m_rows;
    const long long at = out_at[j];
    if (at >= 0) ob[k * g.sc + at] = h1[j * g.ld + k];
  }
}

}  // namespace

// x, out: bf16 maps (B, C, T) with element strides sb, sc, st (out has x's
// strides). w1, w3: (cp, cp) bf16; w2: (3, cp, cp) bf16, tap-major (t-1, t,
// t+1); rows are input channels, zero past C. bias, slope: (3, cp) float32,
// zero past C. All weights contiguous on the current device. The tile
// geometry is the caller's (ops/kernels.resnet_block_1d_tiles): m_rows and
// r1 must cover every row the taps read. stream: a cudaStream_t. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int resnet_block_1d_launch(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* bias, const void* slope, void* out, int n_batch,
    int channels, int cp, int length, long long sb, long long sc,
    long long st, int tile, int m_rows, int r1, void* stream) {
  Geometry g;
  g.channels = channels;
  g.cp = cp;
  g.ld = cp + 16;
  g.length = length;
  g.tile = tile;
  g.tiles = (length + tile - 1) / tile;
  g.n_halo = tile + 2;
  g.m_rows = m_rows;
  g.r1 = r1;
  g.sb = sb;
  g.sc = sc;
  g.st = st;
  g.channel_fast = sc == 1;
  const size_t smem =
      static_cast<size_t>(2 * r1 + m_rows) * g.ld * sizeof(__nv_bfloat16) +
      (kWarps * 256 + 6 * cp) * sizeof(float) +
      static_cast<size_t>(r1 + m_rows) * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      resnet_block_1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(n_batch) * g.tiles;
  resnet_block_1d_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(bias),
      static_cast<const float*>(slope), static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
