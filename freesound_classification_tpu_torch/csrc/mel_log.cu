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
// Bound. At the main path's shape (B = 128 clips of 10 s at 44.1 kHz,
// mel_2048_1024_128: F = 1025, M = 128, T = 431) the product is ~14.5 GFLOP
// of fp32 FMA against ~0.45 GB of spectrum read once: ~32 FLOP per byte, so
// the fp32 FMA rate of the CUDA cores (no tensor cores in fp32), not HBM
// bandwidth, bounds it.
//
// Design. One block per (64-frame tile, 64-band tile, clip). A loop over F in
// chunks of 32 bins computes each |S| once into shared memory and stages the
// matching filterbank slice beside it; each of the 256 threads keeps a 4 x 4
// register tile of accumulators fed by float4 shared-memory reads. The ragged
// F = 1025 and T edges are masked to zero on load and skipped on store.
// Later work: wgmma/TMA, and skipping the filterbank's all-zero (m, f) ranges
// (each mel band covers a narrow range of bins).

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;  // mel bands per block
constexpr int kBN = 64;  // frames per block
constexpr int kBK = 32;  // frequency bins per chunk
constexpr int kTM = 4;   // bands per thread
constexpr int kTN = 4;   // frames per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kLoadRows = kThreads / kBK;           // 8 tile rows per pass
// Row padding of the shared tiles: loads walk k across a warp, so rows of
// kBM + 4 floats spread a warp's stores over 8 banks instead of 1, and keep
// each row 16-byte aligned for the float4 reads.
constexpr int kPad = 4;
constexpr float kLogEps = 1e-4f;

__global__ void __launch_bounds__(kThreads)
mel_log_kernel(const float2* __restrict__ spec, long long stride_b,
               long long stride_f, long long stride_t,
               const float* __restrict__ fb, float* __restrict__ out,
               int n_freq, int n_frames, int n_mel) {
  __shared__ __align__(16) float fb_s[kBK][kBM + kPad];   // fb[m0+m, f0+k]
  __shared__ __align__(16) float mag_s[kBK][kBN + kPad];  // |S[b, f0+k, t0+t]|

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const float2* clip = spec + static_cast<long long>(blockIdx.z) * stride_b;

  // compute mapping: a 4 x 4 tile of (band, frame) outputs per thread
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  // load mapping: neighbouring threads take neighbouring frequency bins, the
  // contiguous axis of both torch.stft's output and the (M, F) filterbank
  const int lk = tid % kBK;
  const int lr = tid / kBK;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < n_freq; f0 += kBK) {
    const int f = f0 + lk;
    const bool f_ok = f < n_freq;
#pragma unroll
    for (int r = lr; r < kBN; r += kLoadRows) {
      const int t = t0 + r;
      float mag = 0.f;
      if (f_ok && t < n_frames) {
        const float2 z = clip[f * stride_f + t * stride_t];
        mag = sqrtf(z.x * z.x + z.y * z.y);
      }
      mag_s[lk][r] = mag;
    }
#pragma unroll
    for (int r = lr; r < kBM; r += kLoadRows) {
      const int m = m0 + r;
      fb_s[lk][r] = (f_ok && m < n_mel)
                        ? fb[static_cast<long long>(m) * n_freq + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&fb_s[k][ty * kTM]);
      const float4 s = *reinterpret_cast<const float4*>(&mag_s[k][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float sv[kTN] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], sv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* clip_out =
      out + static_cast<long long>(blockIdx.z) * n_mel * n_frames;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= n_mel) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int t = t0 + tx * kTN + j;
      if (t < n_frames)
        clip_out[static_cast<long long>(m) * n_frames + t] =
            logf(acc[i][j] + kLogEps);
    }
  }
}

}  // namespace

// spec: complex64 (B, F, T) as (re, im) float pairs with element strides
// stride_b/stride_f/stride_t; fb: (M, F) float32 contiguous; out: (B, M, T)
// float32 contiguous; all on the current device. stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success). B <= 65535.
extern "C" int mel_log_launch(const void* spec, long long stride_b,
                              long long stride_f, long long stride_t,
                              const void* fb, void* out, int n_batch,
                              int n_freq, int n_frames, int n_mel,
                              void* stream) {
  const dim3 grid((n_frames + kBN - 1) / kBN, (n_mel + kBM - 1) / kBM, n_batch);
  mel_log_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), stride_b, stride_f, stride_t,
      static_cast<const float*>(fb), static_cast<float*>(out), n_freq,
      n_frames, n_mel);
  return static_cast<int>(cudaGetLastError());
}
