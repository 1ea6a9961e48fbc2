// K9: magnitude of a bf16 [re | im] spectrum -> mel projection -> log(+1e-4),
// the tail of the fast featurization (one bf16 cat-DFT product per block
// offset, then this kernel).
//
// Replaces the TPU kernel _mel_log_split_kernel of
// scripts/probe_dft_context.py (its pallas_call in fast_featurize).
//
//   mag[r, f]    = bf16(sqrt(bf16(bf16(re^2) + bf16(im^2))))
//   out[b, m, t] = log(sum_f mag[(b, t), f] * fb_t[f, m] + 1e-4)
//
// re, im and fb_t are bf16; the magnitude rounds to bf16 after each of its
// four operations, as the TPU kernel's bf16 arithmetic does (each is done in
// float32 and rounded once: float32 has more than 2 x 8 + 2 bits, so the
// double rounding gives the correctly rounded bf16 result); the products of
// bf16 values are exact in float32 and summed in float32; out is float32.
//
// Layouts. spec is a contiguous (B, T, W) bf16 tensor, re at columns [0, F)
// and im at [im_offset, im_offset + F) of each frame's row (the port uses
// im_offset = F; the TPU probe padded each half to 1152 lanes). Row r = b T
// + t lies at r W, so frames lie back to back across clips. The filterbank
// comes as each band's range of bins [band_lo[m], band_hi[m]) (the first to
// the last non-zero bin) and its weights over that range, packed from the
// start of row m of a (M, F) float32 array (kernels.mel_band_pack, cached
// per filterbank). out is written as (B, M, T), the model's input layout.
//
// Bound. Bytes. At the probe's shape (64 clips x 431 frames, F = 1025,
// M = 128) the spectrum is 113 MB read once and the output 14 MB written
// once: ~0.038 ms at 3.35 TB/s. The mel filterbank is sparse (2,014 of its
// 131,200 entries are non-zero), so the sums over the bands' ranges are
// ~0.1 GFLOP of float32 and the magnitudes ~0.1 more, far below the bytes.
//
// Design. The TPU kernel multiplies the dense filterbank on its matrix unit;
// here, as K1 (csrc/mel_log.cu) does, each band is summed over its range
// only. One block per 4-frame tile of rows b T + t, so tiles span clips. The
// tile is one contiguous run of 4 W bf16 values: the block copies the
// 16-byte-aligned span that encloses it into shared memory with cp.async
// (16 bytes a thread, neighbouring threads on neighbouring chunks, every
// chunk in flight at once: 16 KB a block at W = 2050, eight blocks an SM),
// whatever im_offset is. Each magnitude is then computed once, from its re
// and im in shared memory, into its re's place, in few instructions: the
// products and the sum as bf16 instructions and the square root
// approximate, each rounded so that the result is the correctly rounded one
// (see magnitude()). Each of the 256 threads takes a (band, frame) pair,
// four neighbouring threads the 4 frames of one band, bands interleaved so
// that every thread sums narrow and wide bands alike, and sums the band's
// packed weights against the frame's magnitudes over the band's range, so
// the log-mel is written along T. A band with an empty range gives
// log(1e-4). Any filterbank gives the plain twin's result up to float32
// summation order: only entries outside a band's range, all zero, are
// skipped.
//
// What sets the time (PERF.md, section 6): the bytes take ~0.038 ms at the
// probe's shape, the band sums ~0.018 and the magnitudes ~0.006 more, and
// the blocks' arithmetic overlaps other blocks' copies only in part. With
// exact float32 steps the magnitudes took 0.010 ms more; 8-frame tiles
// were 3% slower; persistent blocks that copy their next tile while
// computing one (three or six an SM) took ~0.11 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFrames = 4;     // rows (frames) per block
constexpr int kThreads = 256;
constexpr int kBandRows = kThreads / kFrames;  // bands summed at once
constexpr float kLogEps = 1e-4f;

// bf16(sqrt(bf16(bf16(re^2) + bf16(im^2)))), equal to the plain twin's
// four float32 steps each rounded to bf16 once (a float32 step rounded to
// bf16 is correctly rounded: 24 >= 2 x 8 + 2 bits). The products and the sum
// are correctly rounded bf16 instructions. The square root of a bf16 value
// lies at least 2^-19 of itself away from every bf16 rounding midpoint
// (tests/test_torch_kernel_layouts.py checks every bf16 value), and
// sqrt.approx.f32 errs by far less, so rounding it to bf16 gives the
// correctly rounded root too.
__device__ __forceinline__ __nv_bfloat16 magnitude(__nv_bfloat16 re,
                                                   __nv_bfloat16 im) {
  const __nv_bfloat16 sum = __hadd(__hmul_rn(re, re), __hmul_rn(im, im));
  float root;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(root) : "f"(__bfloat162float(sum)));
  return __float2bfloat16_rn(root);
}

__global__ void __launch_bounds__(kThreads)
mel_log_split_kernel(const __nv_bfloat16* __restrict__ spec, int width,
                     int im_offset, const float* __restrict__ packed,
                     const int* __restrict__ band_lo,
                     const int* __restrict__ band_hi, float* __restrict__ out,
                     int n_rows, int n_freq, int n_frames, int n_mel) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kFrames;
  const int n_t = min(kFrames, n_rows - r0);

  // the tile's run, from the 16-byte chunk that holds its first value to the
  // one that holds its last (both inside the tensor's allocation)
  const uintptr_t run = reinterpret_cast<uintptr_t>(
      spec + static_cast<long long>(r0) * width);
  const uintptr_t base = run & ~static_cast<uintptr_t>(15);
  const int n_chunks = static_cast<int>(
      (run + 2ull * n_t * width - base + 15) / 16);
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  for (int c = tid; c < n_chunks; c += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     s_base + 16 * c),
                 "l"(base + 16ull * c)
                 : "memory");
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
  __syncthreads();
  __nv_bfloat16* tile =
      reinterpret_cast<__nv_bfloat16*>(smem) + (run - base) / 2;

  // |S| of (frame t, bin f) into the place of its re, (t, f) stepped along
  // kThreads elements at a time
  {
    const int dt = kThreads / n_freq;
    const int df = kThreads - dt * n_freq;
    int t = tid / n_freq;
    int f = tid - t * n_freq;
    while (t < n_t) {
      __nv_bfloat16* row = tile + t * width;
      row[f] = magnitude(row[f], row[im_offset + f]);
      f += df;
      t += dt;
      if (f >= n_freq) {
        f -= n_freq;
        ++t;
      }
    }
  }
  __syncthreads();

  const int tt = tid % kFrames;
  if (tt >= n_t) return;
  const int r = r0 + tt;
  const int b = r / n_frames;
  const __nv_bfloat16* mag = tile + tt * width;
  float* row_out = out + static_cast<long long>(b) * n_mel * n_frames
                   + (r - b * n_frames);
  for (int m = tid / kFrames; m < n_mel; m += kBandRows) {
    const int lo = __ldg(band_lo + m);
    const int n = __ldg(band_hi + m) - lo;
    const float* w = packed + static_cast<long long>(m) * n_freq;
    const __nv_bfloat16* x = mag + lo;
    float acc = 0.f;
    for (int j = 0; j < n; ++j)
      acc = fmaf(__ldg(w + j), __bfloat162float(x[j]), acc);
    row_out[static_cast<long long>(m) * n_frames] = logf(acc + kLogEps);
  }
}

}  // namespace

// spec: (B, T, W) bf16 contiguous, re at [0, F) and im at [im_offset,
// im_offset + F) of each row, n_rows = B T; packed: (M, F) float32
// contiguous, band m's weights over [band_lo[m], band_hi[m]) from the start
// of its row; band_lo/hi: (M,) int32 (lo >= hi for a band with no non-zero
// entry); out: (B, M, T) float32 contiguous; all on the current device.
// n_blocks = ceil(n_rows / 4) and smem = 4 W 2 + 14 bytes rounded up to 16
// of shared memory (the chunks that enclose a tile starting up to 14 bytes
// into its first), from kernels.split_plan. stream: a
// cudaStream_t. Returns the first failing call's cudaError_t (0 on
// success).
extern "C" int mel_log_split_launch(const void* spec, int width,
                                    int im_offset, const void* packed,
                                    const void* band_lo, const void* band_hi,
                                    void* out, int n_rows, int n_freq,
                                    int n_frames, int n_mel, int n_blocks,
                                    int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mel_log_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  mel_log_split_kernel<<<n_blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(spec), width, im_offset,
      static_cast<const float*>(packed), static_cast<const int*>(band_lo),
      static_cast<const int*>(band_hi), static_cast<float*>(out), n_rows,
      n_freq, n_frames, n_mel);
  return static_cast<int>(cudaGetLastError());
}
