// K3: phase-vocoder resynthesis, the output-domain half of the PV stretch in
// the augmentation chain's pitch step.
//
// Replaces the TPU kernel _pv_resynth_kernel of
// freesound_classification_tpu/ops/pallas_kernels.py (reached there through
// _pv_resynth and pv_resynth_pallas from ops/pv.py).
//
// Per row b and synthesis frame k in [0, rows), rows = t_out + r - 1,
// r = n_fft / hop, pos = k * rate[b] in float32:
//   mag_k  = lerp of mag[b, :, f] at min(pos, t_in - 1)
//   dphi_k = dphi[b, floor(min(pos, t_in - 2)), f]
//   phase  = phase0 plus the exclusive running sum of dphi_k, in 128-frame
//            tiles: inside a tile the sum starts from 0 and is added to the
//            tile's carry, then wrapped to (-pi, pi]; the carry moves by the
//            tile's whole sum and is wrapped too (the TPU kernel's order: an
//            unwrapped float32 sum would reach ~1e5 rad and lose ~1e-2 rad)
//   re, im = bf16(mag_k * cos(phase)), bf16(mag_k * sin(phase))
//   syn_k  = bf16(re @ icos + im @ isin)     bf16 x bf16, float32 sums
//   out[b, j, :] = sum_o syn_{j-o}[o*hop : (o+1)*hop]     (overlap-add)
// The window-squared normalization and the crop stay in PyTorch.
//
// Design. The TPU kernel carries the phase from one grid step to the next.
// Hopper's blocks run in no order, so the carry is rebuilt inside each block
// instead, in four launches:
//   1. pv_tile_sum_kernel: one thread per (row, tile, bin) sums its tile's
//      128 picked dphi values, sequentially from 0;
//   2. pv_phase_kernel: one thread per (row, tile, bin) folds the earlier
//      tiles' sums into the carry (at most rows/128 steps), then walks its
//      128 frames: magnitude lerp, phase, sincos, bf16 re/im written as one
//      row of the synthesis product's A (B * rows, 2 * bins_pad);
//   3. pv_synth_kernel: A @ [icos; isin] on the bf16 tensor cores
//      (nvcuda::wmma m16n16k16, float32 accumulators), 128 x 128 block tiles,
//      rounded to bf16 on the way out;
//   4. pv_ola_kernel: one thread per output sample sums its r frame chunks,
//      no atomics, so the result does not depend on block order.
// Every elementwise step is rounded on its own (__fmul_rn, __fadd_rn, ...:
// no FMA contraction), as the plain PyTorch version computes it, except the
// phase wrap's one explicit fmaf.
//
// Bound. At the chain's shape (48 rows, rows = 1729 frames, F = 513,
// n_fft = 1024) the synthesis product is 2 * 48 * 1729 * 1026 * 1024 = 174
// GFLOP of bf16, about 0.18 ms at 989 TFLOP/s; the bytes (mag and dphi read
// once, 340 MB; the float32 output, 85 MB) take about 0.13 ms. The tensor
// cores bound it. This first version stages tiles through shared memory
// with plain loads (no TMA, no wgmma, no pipelining) and keeps A and the
// synthesis frames in HBM between launches; fusing the phase step into the
// product's A loads and the overlap-add into its epilogue is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kTile = 128;  // frames per phase tile: the TPU kernel's _PV_TM
constexpr int kBinThreads = 128;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915493667125702f;  // float32(1 / kTwoPi)

// GEMM tiling: 8 warps as 4 (rows) x 2 (cols), each a 32 x 64 tile of
// 2 x 4 wmma fragments.
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kPad = 8;  // bf16 row padding of the shared tiles (16 bytes)

__device__ __forceinline__ float wrap_phase(float x) {
  // x - 2 pi floor(x / 2 pi + 1/2), to (-pi, pi]: the quotient as a product
  // with the rounded reciprocal and the difference as one fused
  // multiply-add, as XLA evaluates the TPU kernel's expression (the
  // difference's rounding matters: |x| reaches ~1e5 rad inside a tile)
  const float turns = floorf(__fadd_rn(__fmul_rn(x, kInvTwoPi), 0.5f));
  return fmaf(-kTwoPi, turns, x);
}

__device__ __forceinline__ long long dphi_row(int k, float rate, int t_in) {
  const float pos = __fmul_rn(static_cast<float>(k), rate);
  return static_cast<long long>(
      floorf(fminf(fmaxf(pos, 0.f), static_cast<float>(t_in - 2))));
}

__global__ void __launch_bounds__(kBinThreads)
pv_tile_sum_kernel(const float* __restrict__ dphi,
                   const float* __restrict__ rate,
                   float* __restrict__ tile_sum, int t_in, int n_bins,
                   int rows, int n_tiles) {
  const int f = blockIdx.x * kBinThreads + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (f >= n_bins) return;
  const float r = rate[b];
  const float* d = dphi + static_cast<long long>(b) * (t_in - 1) * n_bins + f;
  const int k_end = min((t + 1) * kTile, rows);
  float s = 0.f;
  for (int k = t * kTile; k < k_end; ++k)
    s = __fadd_rn(s, d[dphi_row(k, r, t_in) * n_bins]);
  tile_sum[(static_cast<long long>(b) * n_tiles + t) * n_bins + f] = s;
}

__global__ void __launch_bounds__(kBinThreads)
pv_phase_kernel(const float* __restrict__ mag, const float* __restrict__ dphi,
                const float* __restrict__ phase0,
                const float* __restrict__ rate,
                const float* __restrict__ tile_sum,
                __nv_bfloat16* __restrict__ a, int t_in, int n_bins,
                int bins_pad, int rows, int n_tiles) {
  const int f = blockIdx.x * kBinThreads + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (f >= bins_pad) return;
  const int k0 = t * kTile;
  const int k_end = min(k0 + kTile, rows);
  const long long lda = 2LL * bins_pad;
  __nv_bfloat16* a_row = a + static_cast<long long>(b) * rows * lda + f;
  if (f >= n_bins) {  // the product's zero padding columns
    for (int k = k0; k < k_end; ++k) {
      a_row[k * lda] = __float2bfloat16_rn(0.f);
      a_row[k * lda + bins_pad] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const float r = rate[b];
  float carry = phase0[static_cast<long long>(b) * n_bins + f];
  const float* sums = tile_sum + static_cast<long long>(b) * n_tiles * n_bins
                      + f;
  for (int tt = 0; tt < t; ++tt)
    carry = wrap_phase(__fadd_rn(carry, sums[static_cast<long long>(tt)
                                             * n_bins]));

  const float* m = mag + static_cast<long long>(b) * t_in * n_bins + f;
  const float* d = dphi + static_cast<long long>(b) * (t_in - 1) * n_bins + f;
  const float last = static_cast<float>(t_in - 1);
  float s = 0.f;  // exclusive running sum inside the tile
  for (int k = k0; k < k_end; ++k) {
    const float pos = __fmul_rn(static_cast<float>(k), r);
    const float pm = fminf(fmaxf(pos, 0.f), last);
    const float fl = floorf(pm);
    const float frac = __fsub_rn(pm, fl);
    const long long i0 = static_cast<long long>(fl);
    const long long i1 = min(i0 + 1, static_cast<long long>(t_in - 1));
    const float mg = __fadd_rn(__fmul_rn(__fsub_rn(1.f, frac), m[i0 * n_bins]),
                               __fmul_rn(frac, m[i1 * n_bins]));
    const float phi = wrap_phase(__fadd_rn(carry, s));
    s = __fadd_rn(s, d[dphi_row(k, r, t_in) * n_bins]);
    float sn, cs;
    sincosf(phi, &sn, &cs);
    a_row[k * lda] = __float2bfloat16_rn(__fmul_rn(mg, cs));
    a_row[k * lda + bins_pad] = __float2bfloat16_rn(__fmul_rn(mg, sn));
  }
}

// c (m x n) = a (m x k) @ bm (k x n), bf16 row-major, float32 accumulation,
// rounded to bf16. k is a multiple of kBK and n of kBN; rows past m are
// masked.
__global__ void __launch_bounds__(kGemmThreads)
pv_synth_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ bm,
                __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(32) __nv_bfloat16 a_s[kBM][kBK + kPad];
  __shared__ __align__(32) __nv_bfloat16 b_s[kBK][kBN + kPad];
  __shared__ __align__(32) float c_s[kGemmThreads / 32][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // rows wm * 32 .. +32 of the block tile
  const int wn = warp % 2;  // cols wn * 64 .. +64
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // 16-byte vectors: the A tile is 128 x 32 (512 vectors), B 32 x 128
#pragma unroll
    for (int v = threadIdx.x; v < kBM * kBK / 8; v += kGemmThreads) {
      const int row = v / (kBK / 8);
      const int col = (v % (kBK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < m)
        val = *reinterpret_cast<const uint4*>(
            a + static_cast<long long>(m0 + row) * k + k0 + col);
      *reinterpret_cast<uint4*>(&a_s[row][col]) = val;
    }
#pragma unroll
    for (int v = threadIdx.x; v < kBK * kBN / 8; v += kGemmThreads) {
      const int row = v / (kBN / 8);
      const int col = (v % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&b_s[row][col]) =
          *reinterpret_cast<const uint4*>(
              bm + static_cast<long long>(k0 + row) * n + n0 + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &a_s[wm * 32 + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &b_s[kk][wn * 64 + j * 16], kBN + kPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 float fragment at a time, then
  // writes it as bf16, 8 values (16 bytes) per lane
  float* stage = c_s[warp];
  const int r = lane / 2;
  const int cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + cc;
      if (gm < m) {
        uint32_t packed[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 two = __floats2bfloat162_rn(
              stage[r * 16 + cc + 2 * q], stage[r * 16 + cc + 2 * q + 1]);
          packed[q] = *reinterpret_cast<const uint32_t*>(&two);
        }
        *reinterpret_cast<uint4*>(c + static_cast<long long>(gm) * n + gn) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(256)
pv_ola_kernel(const __nv_bfloat16* __restrict__ syn, float* __restrict__ out,
              int rows, int ldc, int hop, int r, long long total) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= total) return;
  const int col = static_cast<int>(idx % hop);
  const long long bj = idx / hop;
  const int j = static_cast<int>(bj % rows);
  const long long first = (bj - j) * ldc;  // row b's first frame
  float acc = 0.f;
  for (int o = 0; o < r && o <= j; ++o)
    acc = __fadd_rn(acc, __bfloat162float(
                             syn[first + static_cast<long long>(j - o) * ldc
                                 + o * hop + col]));
  out[idx] = acc;
}

}  // namespace

// mag: (B, t_in, F) f32; dphi: (B, t_in - 1, F) f32; phase0: (B, F) f32;
// rate: (B,) f32; basis: (2 * bins_pad, n_pad) bf16 = [icos; isin], zero
// padded; scratch tile_sum: (B, n_tiles, F) f32, a: (B * rows, 2 * bins_pad)
// bf16, syn: (B * rows, n_pad) bf16; out: (B, rows, hop) f32. All contiguous
// on the current device; bins_pad a multiple of 16, n_pad of 128,
// r * hop <= n_pad, t_in >= 2, B <= 65535. stream: a cudaStream_t. Returns
// the first failing launch's cudaError_t (0 on success).
extern "C" int pv_resynth_launch(const void* mag, const void* dphi,
                                 const void* phase0, const void* rate,
                                 const void* basis, void* tile_sum, void* a,
                                 void* syn, void* out, int n_batch, int t_in,
                                 int n_bins, int bins_pad, int n_pad, int hop,
                                 int r, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (rows + kTile - 1) / kTile;
  cudaError_t err;

  const dim3 sum_grid((n_bins + kBinThreads - 1) / kBinThreads, n_tiles,
                      n_batch);
  pv_tile_sum_kernel<<<sum_grid, kBinThreads, 0, s>>>(
      static_cast<const float*>(dphi), static_cast<const float*>(rate),
      static_cast<float*>(tile_sum), t_in, n_bins, rows, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 phase_grid((bins_pad + kBinThreads - 1) / kBinThreads, n_tiles,
                        n_batch);
  pv_phase_kernel<<<phase_grid, kBinThreads, 0, s>>>(
      static_cast<const float*>(mag), static_cast<const float*>(dphi),
      static_cast<const float*>(phase0), static_cast<const float*>(rate),
      static_cast<const float*>(tile_sum), static_cast<__nv_bfloat16*>(a),
      t_in, n_bins, bins_pad, rows, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int m = n_batch * rows;
  const dim3 gemm_grid(n_pad / kBN, (m + kBM - 1) / kBM);
  pv_synth_kernel<<<gemm_grid, kGemmThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(basis),
      static_cast<__nv_bfloat16*>(syn), m, n_pad, 2 * bins_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long total = static_cast<long long>(m) * hop;
  pv_ola_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(syn), static_cast<float*>(out), rows,
      n_pad, hop, r, total);
  return static_cast<int>(cudaGetLastError());
}
