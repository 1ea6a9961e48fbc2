// K2: per-row linear-interpolation resample, the playback-rate change of the
// augmentation chain's speed/pitch step.
//
// Replaces the TPU kernel _resample_kernel of
// freesound_classification_tpu/ops/pallas_kernels.py (reached there through
// _resample_pallas and resample_linear_pallas).
//
//   pos = i * factor[b]                          (float32)
//   out[b, i] = (1 - frac) * w[b, i0] + frac * w[b, i0 + 1],
//   i0 = floor(pos), frac = pos - i0, w[b, j] = 0 for j >= L
//
// The TPU kernel builds triangle-weight masks and contracts them on its
// matrix unit because the TPU has no fast gather. On Hopper this is a direct
// two-tap gather: each thread computes four neighbouring outputs and stores
// them as one float4. Source positions grow monotonically with i, so a
// warp's taps fall in a few neighbouring cache lines and L1/L2 serve them.
//
// Arithmetic. Each product and the sum are rounded on their own
// (__fmul_rn/__fadd_rn: no FMA contraction), as the plain PyTorch version
// computes them.
//
// Bound. One read of the wave and one write of the output, 8 bytes per
// sample: at the chain's shape (48 rows x 441000 samples) 169 MB, about
// 0.05 ms at 3.35 TB/s. The HBM rate bounds it; there is no reuse to win.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // outputs per thread, one float4 store

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ wave,
                const float* __restrict__ factor, float* __restrict__ out,
                int length, int vector_store) {
  const int row = blockIdx.y;
  const float f = factor[row];
  const float* src = wave + static_cast<long long>(row) * length;
  float* dst = out + static_cast<long long>(row) * length;
  const int i_base = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i_base >= length) return;

  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float pos = __fmul_rn(static_cast<float>(i_base + j), f);
    const float fl = floorf(pos);
    const float frac = __fsub_rn(pos, fl);
    const long long i0 = static_cast<long long>(fl);
    const float w0 = i0 < length ? __ldg(src + i0) : 0.f;
    const float w1 = i0 + 1 < length ? __ldg(src + i0 + 1) : 0.f;
    v[j] = __fadd_rn(__fmul_rn(__fsub_rn(1.f, frac), w0),
                     __fmul_rn(frac, w1));
  }
  if (vector_store && i_base + kPerThread <= length) {
    *reinterpret_cast<float4*>(dst + i_base) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (i_base + j < length) dst[i_base + j] = v[j];
  }
}

}  // namespace

// wave: (B, L) float32 contiguous; factor: (B,) float32; out: (B, L) float32
// contiguous; all on the current device. stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). B <= 65535, L < 2^24 (positions
// i are exact in float32).
extern "C" int resample_launch(const void* wave, const void* factor,
                               void* out, int n_batch, int length,
                               void* stream) {
  const int per_block = kThreads * kPerThread;
  const dim3 grid((length + per_block - 1) / per_block, n_batch);
  // rows start 16-byte aligned when L is a multiple of 4 (torch allocations
  // are 256-byte aligned)
  const int vector_store = (length % 4) == 0;
  resample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(factor),
      static_cast<float*>(out), length, vector_store);
  return static_cast<int>(cudaGetLastError());
}
