// K1: fused magnitude -> mel projection -> log(+1e-4), the log-mel frontend's
// tail.
//
// Replaces the TPU kernel _mel_log_kernel of
// freesound_classification_tpu/ops/pallas_kernels.py (reached there through
// _mel_project_log_2d and mel_project_log_ri).
//
//   out[b, m, t] = log(sum_f fb[m, f] * |S[b, f, t]| + 1e-4),  fp32 accumulation
//
// Layouts. S is read in place from torch.stft's complex (B, F, T) output as
// interleaved (re, im) float pairs, through its strides. torch.stft lays that
// tensor out frame-major, (B, T, F) in memory, so the loads walk F: there is
// no split into real and imaginary arrays (a workaround the TPU runtime needed
// because it could not take complex64), no padding to the TPU's (8, 128)
// tiles, and no contiguous copy. out is written as (B, M, T), which is already
// the model's input layout, so no transpose pass follows.
//
// Bound. Bytes. At the main path's shape (B = 128 clips of 10 s at 44.1 kHz,
// mel_2048_1024_128: F = 1025, M = 128, T = 431) the spectrum is 452 MB and
// the output 28 MB, 0.14 ms at 3.35 TB/s. A mel filterbank is sparse: each
// band covers a narrow range of bins (2-64 at this shape; 2,014 of its
// 131,200 entries are non-zero), so the product over each band's range is
// ~0.5 GFLOP, far below the bytes. A dense loop over all F bins for every
// band would be 14.5 GFLOP of fp32 FMA, 0.22 ms at 67 TFLOP/s: above the
// bound by itself, which is why this design does not do it.
//
// Design. One block per (8-frame tile, clip). The block stages |S| of all F
// bins of its frames in shared memory once (8 x 1025 x 4 B = 32.8 KB, small
// enough that several blocks share an SM and one block's loads overlap
// another's sums; 16-frame tiles left fewer blocks and more idle bytes):
// each magnitude is computed once. torch.stft's frames lie back to back, so
// a tile is one contiguous run of 8 x F complex values, read 16 bytes (two
// bins) a load with neighbouring threads on neighbouring bytes and eight
// loads in flight per thread (other strides take 8-byte loads). Then each of
// the 256 threads takes a (band, frame) pair and sums only over the band's
// range [band_lo[m], band_hi[m]), the first to the last non-zero bin, which
// the wrapper computes from fb on the device on every call; a band with no
// non-zero entry has an empty range and gives log(1e-4). Eight neighbouring
// threads take the 8 frames of one band, so the log-mel is written along T.
// Any fb gives the plain twin's result up to fp32 summation order: only
// entries outside a band's range, all zero, are skipped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFrames = 8;    // frames per block
constexpr int kThreads = 256;
constexpr int kBandRows = kThreads / kFrames;  // bands summed at once
constexpr int kUnroll = 8;    // spectrum loads in flight per thread
constexpr float kLogEps = 1e-4f;

__global__ void __launch_bounds__(kThreads)
mel_log_kernel(const float2* __restrict__ spec, long long stride_b,
               long long stride_f, long long stride_t,
               const float* __restrict__ fb, const int* __restrict__ band_lo,
               const int* __restrict__ band_hi, float* __restrict__ out,
               int n_freq, int n_frames, int n_mel) {
  extern __shared__ float mag_s[];  // [kFrames][n_freq]: |S| of the frames

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kFrames;
  const int n_t = min(kFrames, n_frames - t0);
  const float2* clip = spec + blockIdx.y * stride_b + t0 * stride_t;

  // stage |S| of element e = t * n_freq + f of the tile at mag_s[e]
  const int total = n_t * n_freq;
  if (stride_f == 1 && stride_t == n_freq) {
    // frames back to back (torch.stft's layout): the tile is one run of
    // total complex values, read 16 bytes (two bins) a load after at most
    // one 8-byte value that puts the loads on a 16-byte boundary
    const int head = (reinterpret_cast<uintptr_t>(clip) & 15) ? 1 : 0;
    const int pairs = (total - head) / 2;
    const float4* run = reinterpret_cast<const float4*>(clip + head);
    for (int v0 = tid; v0 < pairs; v0 += kThreads * kUnroll) {
      float4 z[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        z[u] = v0 + u * kThreads < pairs ? run[v0 + u * kThreads]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = head + 2 * (v0 + u * kThreads);
        if (e < total) {
          mag_s[e] = sqrtf(z[u].x * z[u].x + z[u].y * z[u].y);
          mag_s[e + 1] = sqrtf(z[u].z * z[u].z + z[u].w * z[u].w);
        }
      }
    }
    if (tid == 0) {  // the unpaired values at either end
      if (head) {
        const float2 z = clip[0];
        mag_s[0] = sqrtf(z.x * z.x + z.y * z.y);
      }
      if ((total - head) % 2) {
        const float2 z = clip[total - 1];
        mag_s[total - 1] = sqrtf(z.x * z.x + z.y * z.y);
      }
    }
  } else {
    // any strides: kThreads apart per thread, (t, f) stepped along
    const int dt = kThreads / n_freq;
    const int df = kThreads - dt * n_freq;
    int t = tid / n_freq;
    int f = tid - t * n_freq;
    for (int e0 = tid; e0 < total; e0 += kThreads * kUnroll) {
      float2 z[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        z[u] = e0 + u * kThreads < total ? clip[t * stride_t + f * stride_f]
                                         : make_float2(0.f, 0.f);
        f += df;
        t += dt;
        if (f >= n_freq) {
          f -= n_freq;
          ++t;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) mag_s[e] = sqrtf(z[u].x * z[u].x + z[u].y * z[u].y);
      }
    }
  }
  __syncthreads();

  const int tt = tid % kFrames;
  if (tt >= n_t) return;
  const float* mag_t = mag_s + tt * n_freq;
  float* clip_out =
      out + static_cast<long long>(blockIdx.y) * n_mel * n_frames + t0 + tt;
  for (int m = tid / kFrames; m < n_mel; m += kBandRows) {
    const float* w = fb + static_cast<long long>(m) * n_freq;
    const int hi = band_hi[m];
    float acc = 0.f;
    for (int k = band_lo[m]; k < hi; ++k)
      acc = fmaf(__ldg(w + k), mag_t[k], acc);
    clip_out[static_cast<long long>(m) * n_frames] = logf(acc + kLogEps);
  }
}

}  // namespace

// spec: complex64 (B, F, T) as (re, im) float pairs with element strides
// stride_b/stride_f/stride_t; fb: (M, F) float32 contiguous; band_lo/hi:
// (M,) int32, each band's first non-zero bin and one past its last (lo >= hi
// for a band with none); out: (B, M, T) float32 contiguous; all on the
// current device. 8 * F * 4 bytes of shared memory (F <= 7264); B <= 65535.
// stream: a cudaStream_t. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mel_log_launch(const void* spec, long long stride_b,
                              long long stride_f, long long stride_t,
                              const void* fb, const void* band_lo,
                              const void* band_hi, void* out, int n_batch,
                              int n_freq, int n_frames, int n_mel,
                              void* stream) {
  const int smem = kFrames * n_freq * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mel_log_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, n_batch);
  mel_log_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), stride_b, stride_f, stride_t,
      static_cast<const float*>(fb), static_cast<const int*>(band_lo),
      static_cast<const int*>(band_hi), static_cast<float*>(out), n_freq,
      n_frames, n_mel);
  return static_cast<int>(cudaGetLastError());
}
