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
//   out[b, i] = 0 where pos >= lengths[b]        (when lengths are given)
//
// The mask is the effects chain's (ops/augment.resample_rate): source
// positions at or past a row's valid length read 0. It is applied in the
// store, so the chain makes no passes of its own after the kernel, and a
// masked output loads no taps. With lengths = L it changes nothing: every
// tap at pos >= L already reads 0.
//
// Domain. Each block checks its row's factor against (0, max_factor] (the
// TPU kernel's domain) on the card, so the wrapper makes no host sync. A
// factor outside it ends the run: the row's first block prints the row and
// the factor and fails a device-side assert (then traps, should asserts be
// compiled out); the row's other blocks return. Nothing is caught.
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
// Bound. The HBM rate; there is no reuse to win. The output is written
// once, and a row's samples are read once up to the last tap it loads:
// floor((L - 1) f) + 1 and, masked, lengths[b]. At the chain's shape (48
// rows x 441000 samples) that is at most 169 MB, about 0.05 ms at
// 3.35 TB/s, and ~147 MB for its masked call (chip_smoke.py counts it from
// each run's inputs).

#include <cuda_runtime.h>

#include <cassert>
#include <cstdio>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // outputs per thread, one float4 store

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ wave,
                const float* __restrict__ factor,
                const int* __restrict__ lengths, float* __restrict__ out,
                int length, int vector_store, float max_factor) {
  const int row = blockIdx.y;
  const float f = factor[row];
  if (!(f > 0.f && f <= max_factor)) {  // NaN fails too
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      printf("resample_kernel: row %d has factor %.9g outside (0, %.9g]\n",
             row, f, max_factor);
      assert(f > 0.f && f <= max_factor);
      __trap();
    }
    return;
  }
  const float* src = wave + static_cast<long long>(row) * length;
  float* dst = out + static_cast<long long>(row) * length;
  const int i_base = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i_base >= length) return;
  // positions at or past the valid length give 0 (the float32 comparison
  // of ops/augment.py: pos < float(lengths[b]))
  const float valid = lengths != nullptr ? __int2float_rn(lengths[row])
                                         : static_cast<float>(length);

  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float pos = __fmul_rn(static_cast<float>(i_base + j), f);
    if (!(pos < valid)) {
      v[j] = 0.f;
      continue;
    }
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

// wave: (B, L) float32 contiguous; factor: (B,) float32, each in
// (0, max_factor] (checked on the card); lengths: (B,) int32 valid lengths,
// or null for no mask; out: (B, L) float32 contiguous; all on the current
// device. stream: a cudaStream_t. Returns the cudaError_t of the launch (0
// on success). B <= 65535, L < 2^24 (positions i are exact in float32).
extern "C" int resample_launch(const void* wave, const void* factor,
                               const void* lengths, void* out, int n_batch,
                               int length, float max_factor, void* stream) {
  const int per_block = kThreads * kPerThread;
  const dim3 grid((length + per_block - 1) / per_block, n_batch);
  // rows start 16-byte aligned when L is a multiple of 4 (torch allocations
  // are 256-byte aligned)
  const int vector_store = (length % 4) == 0;
  resample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(factor),
      static_cast<const int*>(lengths), static_cast<float*>(out), length,
      vector_store, max_factor);
  return static_cast<int>(cudaGetLastError());
}
