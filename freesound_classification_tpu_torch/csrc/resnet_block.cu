// K4, K5 and K6: the eval-mode resnet block with BatchNorm folded into its
// convolutions, in one pass per tile of positions; and K7, the backbone's
// eval-mode BasicBlock, on the same machinery (see basic_block_kernel).
//
// Replaces three TPU kernels that compute one function in two layouts:
//   K6  _fused_1d_kernel  freesound_classification_tpu/ops/pallas_resnet1d.py
//       (ResnetBlock1d, 3 taps; reached through resnet_block_1d_infer)
//   K4  _fused_kernel     freesound_classification_tpu/ops/pallas_resnet.py
//       (ResnetBlock2d, 3x3 taps, flat padded rows; use_pallas_kernel="v1")
//   K5  _fused_t_kernel   the same file (transposed layout; use_pallas_kernel
//       True). K4's and K5's layouts are TPU sublane artifacts: on Hopper one
//       2d instantiation serves both.
//
// Per position p of a (B, C, T) or (B, C, H, W) bf16 map, with folded bf16
// weights w1 (C x C), w2 (taps x C x C), w3 (C x C), float32 biases b and
// PReLU slopes a (prelu(v) = v >= 0 ? v : a v):
//   h1[p] = bf16(prelu(x[p] w1 + b1, a1)) inside the map, 0 outside it
//   h2[p] = bf16(prelu(sum_taps h1[p + tap] w2[tap] + b2, a2))
//   y[p]  = bf16(prelu((h2[p] w3 + b3) + x[p], a3))
// Products are bf16 x bf16 with float32 sums (the TPU kernels' rounding
// points). SAME padding is on h1: a halo position outside the map reads
// h1 = 0, not prelu(b1) of a zero x.
//
// Design. One block of eight warps per tile of output positions: a 1d tile
// of up to 64 frames, or a 2d tile of tile_h x tile_w pixels. The block
// loads x over the tile plus a one-position halo into shared memory as flat
// rows of channels (leading dimension cp + 16, so that every row starts on a
// 32-byte boundary), computes h1 over the halo rows, then h2 over a band of
// "center" rows, then y. In the flat layout every tap is a constant row
// offset (K4's idea: 2d rows are tile_w + 2 wide, so the tap (dh, dw) is
// (dh - 1)(tile_w + 2) + (dw - 1) rows away), and each convolution is a
// product of flat rows by a weight matrix on the bf16 tensor cores
// (nvcuda::wmma m16n16k16, float32 accumulators). The band's rows that fall
// on halo columns are computed and dropped. Weights stream from global
// memory and L2 (w2 is 4.4 MB at 486 channels in 2d, beyond shared memory);
// the warps share out (16-channel column strip, pair of 16-row tiles)
// items, each reusing a weight fragment over its two row tiles and loading
// the next fragment while the tensor cores run the current one. Each row's position in the map (or -1 off
// it), the biases and the slopes are put in shared memory once per block,
// so the epilogues do no index arithmetic and no global loads: x stays in
// shared memory for the residual, h2 has rows of its own, and y is staged
// in h1's rows (dead by then) and stored with neighbouring threads on
// neighbouring addresses in the map's own layout.
//
// Bound. At the hierarchical path's block0 (B 128, C 64, T 215) the block
// moves 7 MB and does 1.1 GFLOP; at the 2d path's block0 (B 128, C 64,
// 64 x 215) 0.45 GB and 158 GFLOP, about 0.135 ms of memory traffic at
// 3.35 TB/s against 0.16 ms of bf16 tensor-core work at 989 TFLOP/s. This
// version has no TMA, wgmma or pipelining: weight fragments come straight
// from L2 and the tensor cores wait on them.

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
  int height, width;  // the map (1d: height 1)
  int tile_h, tile_w;
  int tiles_h, tiles_w;
  int halo;    // x's halo: 1 (resnet block) or 2 (basic block)
  int wp;      // tile_w + 2 halo: halo row width
  int n_halo;  // halo positions: wp (1d) or (tile_h + 2 halo) wp (2d)
  int base;    // flat halo index of the band's first row: 1 or wp + 1
  int m_rows;  // band rows, a multiple of 16
  int m_out;   // basic block: output band rows, a multiple of 16
  int r1;      // shared rows of x (and h1), a multiple of 16
  long long sb, sc, sh, sw;  // element strides of x and out
  int channel_fast;          // sc == 1: lanes walk channels, else positions
};

template <int kTaps>
__device__ __forceinline__ int tap_offset(const Geometry& g, int tap) {
  if (kTaps == 3) return tap - 1;
  return (tap / 3 - 1) * g.wp + (tap % 3 - 1);
}

// halo row q -> its offset in the image (hh sh + ww sw), or -1 off the map
// (or past the halo)
template <int kTaps>
__device__ long long halo_offset(const Geometry& g, int h0, int w0, int q) {
  if (q >= g.n_halo) return -1;
  const int hh = kTaps == 3 ? 0 : h0 - g.halo + q / g.wp;
  const int ww = kTaps == 3 ? w0 - 1 + q : w0 - g.halo + q % g.wp;
  if (hh < 0 || hh >= g.height || ww < 0 || ww >= g.width) return -1;
  return hh * g.sh + ww * g.sw;
}

// the output at flat halo index `flat` -> its offset in the image, or -1 for
// halo columns, rows past the tile and positions past the map
template <int kTaps>
__device__ long long center_offset(const Geometry& g, int h0, int w0,
                                   int flat) {
  const int row = kTaps == 3 ? g.halo : flat / g.wp;
  const int col = kTaps == 3 ? flat : flat % g.wp;
  if (row < g.halo || row >= g.tile_h + g.halo || col < g.halo ||
      col >= g.tile_w + g.halo)
    return -1;
  const int hh = kTaps == 3 ? 0 : h0 - g.halo + row;
  const int ww = w0 - g.halo + col;
  if (hh >= g.height || ww >= g.width) return -1;
  return hh * g.sh + ww * g.sw;
}

using WeightFragment =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : __fmul_rn(a, v);
}

// acc[i] += the products of one step (tap, channels k0..k0+15) for the
// row tiles m0 + i: a's rows shifted by the tap's offset times the weight
// fragment fb.
template <int kTaps>
__device__ __forceinline__ void step_products(
    const Geometry& g, const __nv_bfloat16* a, int a_base, int taps,
    int n_tiles, int m0, int step, const WeightFragment& fb,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc) {
  const int k_steps = g.cp / 16;
  const int off = taps == 1 ? 0 : tap_offset<kTaps>(g, step / k_steps);
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
// channels of a[(row + a_base + offset(tap)) * ld + c]
// * w[(tap * cp + c) * cp + col], then epi(row, col, value) over each
// tile, one element per call (lane e of the tile: row e / 16, col e % 16).
// A step is one (tap, 16 channels); its weight fragment is loaded while the
// step before it runs on the tensor cores. In w's plain layout (kTiled
// false) the fragment is 16 rows of 32 bytes cp apart, w + 16 step cp +
// 16 n; tiled (K7), w holds each fragment as 512 contiguous bytes, step-
// major, w + 256 (step cp / 16 + n), which a warp reads in four full
// 128-byte lines instead of sixteen 32-byte sectors.
template <int kTaps, bool kTiled, typename Epilogue>
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
    const __nv_bfloat16* wn = w + n * (kTiled ? 256 : 16);
    const long long step_stride = kTiled ? 256LL * n_strips : 16LL * g.cp;
    const int ldw = kTiled ? 16 : g.cp;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) wmma::fill_fragment(acc[i], 0.f);
    WeightFragment f0, f1;
    wmma::load_matrix_sync(f0, wn, ldw);
#pragma unroll 1
    for (int s = 0; s < steps; s += 2) {
      if (s + 1 < steps)
        wmma::load_matrix_sync(f1, wn + (s + 1) * step_stride, ldw);
      step_products<kTaps>(g, a, a_base, taps, n_tiles, m0, s, f0, acc);
      if (s + 2 < steps)
        wmma::load_matrix_sync(f0, wn + (s + 2) * step_stride, ldw);
      if (s + 1 < steps)
        step_products<kTaps>(g, a, a_base, taps, n_tiles, m0, s + 1, f1,
                             acc);
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

template <int kTaps>
__global__ void __launch_bounds__(kThreads)
resnet_block_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ w2,
                    const __nv_bfloat16* __restrict__ w3,
                    const float* __restrict__ bias,   // (3, cp): b1, b2, b3
                    const float* __restrict__ slope,  // (3, cp): a1, a2, a3
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

  const int per_image = g.tiles_h * g.tiles_w;
  const int b = blockIdx.x / per_image;
  const int t = blockIdx.x % per_image;
  const int h0 = (t / g.tiles_w) * g.tile_h;
  const int w0 = (t % g.tiles_w) * g.tile_w;
  const __nv_bfloat16* xb = x + b * g.sb;
  __nv_bfloat16* ob = out + b * g.sb;

  for (int i = threadIdx.x; i < 3 * g.cp; i += kThreads) {
    vec[i] = bias[i];
    vec[3 * g.cp + i] = slope[i];
  }
  for (int q = threadIdx.x; q < g.r1; q += kThreads)
    halo_at[q] = halo_offset<kTaps>(g, h0, w0, q);
  for (int j = threadIdx.x; j < g.m_rows; j += kThreads)
    out_at[j] = center_offset<kTaps>(g, h0, w0, g.base + j);
  __syncthreads();

  // x over the halo rows; zeros off the map and past C
  for (int idx = threadIdx.x; idx < g.r1 * g.cp; idx += kThreads) {
    const int q = g.channel_fast ? idx / g.cp : idx % g.r1;
    const int k = g.channel_fast ? idx % g.cp : idx / g.r1;
    const long long at = halo_at[q];
    xs[q * g.ld + k] = k < g.channels && at >= 0 ? xb[k * g.sc + at]
                                                 : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  // h1 over every halo row: zero off the map (SAME padding of conv2)
  conv_rows<kTaps, false>(g, xs, 0, 1, g.r1, w1, stage,
                   [&](int q, int k, float v) {
                     h1[q * g.ld + k] = __float2bfloat16_rn(
                         halo_at[q] >= 0
                             ? prelu(__fadd_rn(v, vec[k]), vec[3 * g.cp + k])
                             : 0.f);
                   });
  __syncthreads();

  // h2 over the band
  conv_rows<kTaps, false>(g, h1, g.base, kTaps, g.m_rows, w2, stage,
                   [&](int j, int k, float v) {
                     h2[j * g.ld + k] = __float2bfloat16_rn(prelu(
                         __fadd_rn(v, vec[g.cp + k]), vec[4 * g.cp + k]));
                   });
  __syncthreads();  // h1 is dead from here on: y takes its rows

  // y = prelu(h2 w3 + b3 + x), x from its halo row base + j
  conv_rows<kTaps, false>(g, h2, 0, 1, g.m_rows, w3, stage,
                   [&](int j, int k, float v) {
                     const float y = __fadd_rn(
                         __fadd_rn(v, vec[2 * g.cp + k]),
                         __bfloat162float(xs[(g.base + j) * g.ld + k]));
                     h1[j * g.ld + k] =
                         __float2bfloat16_rn(prelu(y, vec[5 * g.cp + k]));
                   });
  __syncthreads();

  // the band's output positions to the map, in its own layout
  for (int idx = threadIdx.x; idx < g.m_rows * g.channels;
       idx += kThreads) {
    const int j = g.channel_fast ? idx / g.channels : idx % g.m_rows;
    const int k = g.channel_fast ? idx % g.channels : idx / g.m_rows;
    const long long at = out_at[j];
    if (at >= 0) ob[k * g.sc + at] = h1[j * g.ld + k];
  }
}

template <int kTaps>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           const void* bias, const void* slope, void* out, int n_batch,
           const Geometry& g, void* stream) {
  const size_t smem =
      static_cast<size_t>(2 * g.r1 + g.m_rows) * g.ld *
          sizeof(__nv_bfloat16) +
      (kWarps * 256 + 6 * g.cp) * sizeof(float) +
      static_cast<size_t>(g.r1 + g.m_rows) * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      resnet_block_kernel<kTaps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(n_batch) * g.tiles_h * g.tiles_w;
  resnet_block_kernel<kTaps><<<blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(bias),
      static_cast<const float*>(slope), static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}


// K7: the backbone's eval-mode stride-1 identity BasicBlock with BatchNorm
// folded (replaces _basic_t_kernel, freesound_classification_tpu/ops/
// pallas_backbone.py). Per position p of a (B, C, H, W) bf16 map, with
// folded bf16 weights w1, w2 (9 taps x C x C) and float32 biases b1, b2:
//   h1[p] = bf16(relu(sum_taps x[p + tap] w1[tap] + b1)) inside the map,
//           0 outside it
//   y[p]  = bf16(relu((sum_taps h1[p + tap] w2[tap] + b2) + x[p]))
// as the TPU kernel rounds: x, the weights and h1 bf16, sums float32.
//
// SAME padding is on h1, so a tile's h1 is computed over the tile plus a
// one-position halo, from x over the tile plus a halo of 2: x is held in
// flat rows tile_w + 4 wide (wp), h1 over a band of m_rows flat rows that
// starts at x's row wp + 1 (the map position (h0 - 1, w0 - 1)), and y over
// a band of m_out rows that starts at h1's row wp + 1 (the tile's first
// position). Band rows on halo columns are computed and dropped; h1 rows
// off the map are written as 0. y goes from the epilogue straight to the
// map (x stays live for the residual, so it has no rows to be staged in).
__global__ void __launch_bounds__(kThreads)
basic_block_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ bias,  // (2, cp): b1, b2
                   __nv_bfloat16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // r1 rows
  __nv_bfloat16* h1 = xs + g.r1 * g.ld;                          // m_rows
  float* stages = reinterpret_cast<float*>(h1 + g.m_rows * g.ld);
  float* stage = stages + (threadIdx.x / 32) * 256;
  float* vec = stages + kWarps * 256;  // b1, b2: 2 x cp
  long long* halo_at = reinterpret_cast<long long*>(vec + 2 * g.cp);  // r1
  long long* out_at = halo_at + g.r1;                                 // m_out

  const int per_image = g.tiles_h * g.tiles_w;
  const int b = blockIdx.x / per_image;
  const int t = blockIdx.x % per_image;
  const int h0 = (t / g.tiles_w) * g.tile_h;
  const int w0 = (t % g.tiles_w) * g.tile_w;
  const __nv_bfloat16* xb = x + b * g.sb;
  __nv_bfloat16* ob = out + b * g.sb;
  const int y_base = 2 * g.wp + 2;  // x's flat row of y's band row 0

  for (int i = threadIdx.x; i < 2 * g.cp; i += kThreads) vec[i] = bias[i];
  for (int q = threadIdx.x; q < g.r1; q += kThreads)
    halo_at[q] = halo_offset<9>(g, h0, w0, q);
  for (int j = threadIdx.x; j < g.m_out; j += kThreads)
    out_at[j] = center_offset<9>(g, h0, w0, y_base + j);
  __syncthreads();

  // x over the tile plus a halo of 2; zeros off the map and past C
  for (int idx = threadIdx.x; idx < g.r1 * g.cp; idx += kThreads) {
    const int q = g.channel_fast ? idx / g.cp : idx % g.r1;
    const int k = g.channel_fast ? idx % g.cp : idx / g.r1;
    const long long at = halo_at[q];
    xs[q * g.ld + k] = k < g.channels && at >= 0 ? xb[k * g.sc + at]
                                                 : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  // h1 over the band: zero off the map (SAME padding of conv2)
  conv_rows<9, true>(g, xs, g.base, 9, g.m_rows, w1, stage,
               [&](int j, int k, float v) {
                 h1[j * g.ld + k] = __float2bfloat16_rn(
                     halo_at[g.base + j] >= 0 ? fmaxf(__fadd_rn(v, vec[k]), 0.f)
                                              : 0.f);
               });
  __syncthreads();

  // y = relu((conv2(h1) + b2) + x) to the map
  conv_rows<9, true>(g, h1, g.wp + 1, 9, g.m_out, w2, stage,
               [&](int j, int k, float v) {
                 const long long at = out_at[j];
                 if (k < g.channels && at >= 0) {
                   const float y = __fadd_rn(
                       __fadd_rn(v, vec[g.cp + k]),
                       __bfloat162float(xs[(y_base + j) * g.ld + k]));
                   ob[k * g.sc + at] = __float2bfloat16_rn(fmaxf(y, 0.f));
                 }
               });
}

}  // namespace

// x, out: bf16 maps (B, C, H, W) with element strides sb, sc, sh, sw (out
// has x's strides; 1d maps pass H = 1, sh = 0). w1, w3: (cp, cp) bf16;
// w2: (taps, cp, cp) bf16, tap-major (1d: t-1, t, t+1; 2d: 3 dh + dw);
// rows are input channels, zero past C. bias, slope: (3, cp) float32, zero
// past C. All weights contiguous on the current device. taps is 3 or 9; the
// tile geometry is the caller's (ops/kernels.py), and r1 and m_rows must
// cover every row the taps read. stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int resnet_block_launch(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* bias, const void* slope, void* out, int taps, int n_batch,
    int channels, int cp, int height, int width, long long sb, long long sc,
    long long sh, long long sw, int tile_h, int tile_w, int m_rows, int r1,
    void* stream) {
  Geometry g;
  g.channels = channels;
  g.cp = cp;
  g.ld = cp + 16;
  g.height = height;
  g.width = width;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_h = (height + tile_h - 1) / tile_h;
  g.tiles_w = (width + tile_w - 1) / tile_w;
  g.halo = 1;
  g.wp = tile_w + 2;
  g.n_halo = taps == 3 ? g.wp : (tile_h + 2) * g.wp;
  g.base = taps == 3 ? 1 : g.wp + 1;
  g.m_rows = m_rows;
  g.m_out = 0;
  g.r1 = r1;
  g.sb = sb;
  g.sc = sc;
  g.sh = sh;
  g.sw = sw;
  g.channel_fast = sc == 1;
  if (taps == 3)
    return launch<3>(x, w1, w2, w3, bias, slope, out, n_batch, g, stream);
  if (taps == 9)
    return launch<9>(x, w1, w2, w3, bias, slope, out, n_batch, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7. x, out: bf16 maps (B, C, H, W) with element strides sb, sc, sh, sw
// (out has x's strides). w1, w2: bf16 (9, cp, cp) matrices, tap 3 dh + dw,
// rows input channels, zero past C, tiled: (9 cp / 16, cp / 16, 16, 16),
// fragment (step, strip) = rows 16 step.., columns 16 strip..; bias: (2,
// cp) float32 (b1, b2), zero past C;
// all contiguous on the current device. The tile geometry is the caller's
// (ops/kernels.py basic_block_tiles): the h1 band of m_rows rows and the y
// band of m_out rows, and r1 x rows, must cover every row the taps read.
// stream: a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int basic_block_launch(
    const void* x, const void* w1, const void* w2, const void* bias,
    void* out, int n_batch, int channels, int cp, int height, int width,
    long long sb, long long sc, long long sh, long long sw, int tile_h,
    int tile_w, int m_rows, int m_out, int r1, void* stream) {
  Geometry g;
  g.channels = channels;
  g.cp = cp;
  g.ld = cp + 16;
  g.height = height;
  g.width = width;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_h = (height + tile_h - 1) / tile_h;
  g.tiles_w = (width + tile_w - 1) / tile_w;
  g.halo = 2;
  g.wp = tile_w + 4;
  g.n_halo = (tile_h + 4) * g.wp;
  g.base = g.wp + 1;
  g.m_rows = m_rows;
  g.m_out = m_out;
  g.r1 = r1;
  g.sb = sb;
  g.sc = sc;
  g.sh = sh;
  g.sw = sw;
  g.channel_fast = sc == 1;
  const size_t smem =
      static_cast<size_t>(r1 + m_rows) * g.ld * sizeof(__nv_bfloat16) +
      (kWarps * 256 + 2 * cp) * sizeof(float) +
      static_cast<size_t>(r1 + m_out) * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      basic_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(n_batch) * g.tiles_h * g.tiles_w;
  basic_block_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
