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
// double rounding gives the correctly rounded bf16 result); the sum is float32
// on the tensor cores; out is float32.
//
// Layouts. spec is (B, T, W) bf16 with a contiguous last axis: re at columns
// [0, F) and im at [im_offset, im_offset + F) of each frame's row (the port
// uses im_offset = F; the TPU probe padded each half to 1152 lanes). fb_t is
// (F, M) bf16 contiguous. out is written as (B, M, T), the model's input
// layout, so the probe's trailing swapaxes pass disappears.
//
// Bound. At the probe's shape (64 clips x 431 frames, F = 1025, M = 128) the
// spectrum is 113 MB read once and the output 14 MB written once: ~0.038 ms
// at 3.35 TB/s. The product is 7.2 GFLOP of bf16, ~0.007 ms at 989 TFLOP/s.
// Bytes bound it.
//
// Design. One block per (64-frame tile, 128-band tile, clip), so with M = 128
// every spectrum element is read once. A loop over F in chunks of 16 bins
// (F = 1025 is zero-masked to 1040): each thread holds in registers its 4
// (frame, bin) pairs of re and im (neighbouring threads on neighbouring bins)
// and 8 bands of one fb_t row (one 16-byte load); it turns them into the bf16
// magnitudes and the fb_t slice of a shared-memory buffer, the block syncs
// once, the thread starts the next chunk's loads, and the 8 warps multiply
// the buffer on the tensor cores (nvcuda::wmma bf16 m16n16k16, float32
// accumulators; each warp a 16-frame x 64-band strip) while those loads are
// in flight. Two buffers alternate, so one barrier a chunk suffices. The
// epilogue stages the accumulators band-major in shared memory (reusing the
// buffers' space) and writes log(x + 1e-4) along t. Measured at the probe's
// shape on an H100: 0.152 ms, 4x the bound (a first version that loaded,
// synced and multiplied in turn took 0.257). Later work: more bytes in
// flight (cp.async or TMA stages; the im half sits at an odd offset).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;     // frames per block
constexpr int kBands = 128;   // mel bands per block
constexpr int kChunk = 16;    // frequency bins per step: one wmma k-step
constexpr int kThreads = 256; // 8 warps
constexpr int kRowsPerPass = kThreads / kChunk;  // 16
constexpr int kPairs = kRows / kRowsPerPass;     // 4 (frame, bin) a thread
constexpr int kMagLd = kChunk + 8;  // bf16 row stride of a magnitude tile
constexpr int kFbLd = kBands + 8;   // bf16 row stride of an fb_t tile
constexpr int kOutLd = kRows + 4;   // float row stride of the output stage
constexpr int kMagBytes = kRows * kMagLd * 2;
constexpr int kFbBytes = kChunk * kFbLd * 2;
constexpr int kBufBytes = 2 * (kMagBytes + kFbBytes);
constexpr int kStageBytes = kBands * kOutLd * 4;
constexpr int kSmemBytes = kStageBytes > kBufBytes ? kStageBytes : kBufBytes;
constexpr float kLogEps = 1e-4f;
static_assert(kThreads == kChunk * (kBands / 8), "one fb_t load a thread");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ __nv_bfloat16 magnitude(__nv_bfloat16 re,
                                                   __nv_bfloat16 im) {
  const float r = __bfloat162float(re);
  const float i = __bfloat162float(im);
  return __float2bfloat16_rn(
      sqrtf(bf16_round(bf16_round(r * r) + bf16_round(i * i))));
}

// 4 blocks an SM (64 registers): the probe shape's 448 blocks in one wave
__global__ void __launch_bounds__(kThreads, 4)
mel_log_split_kernel(const __nv_bfloat16* __restrict__ spec,
                     long long stride_b, long long stride_t, int im_offset,
                     const __nv_bfloat16* __restrict__ fb_t,
                     float* __restrict__ out, int n_freq, int n_frames,
                     int n_mel) {
  // two (magnitude, fb_t) buffers in the loop; after it, the output stage
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  float(*stage)[kOutLd] = reinterpret_cast<float(*)[kOutLd]>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int t0 = blockIdx.x * kRows;
  const int m0 = blockIdx.y * kBands;
  const __nv_bfloat16* clip =
      spec + static_cast<long long>(blockIdx.z) * stride_b;

  // each warp: frames 16 * (warp % 4).., bands 64 * (warp / 4)..
  const int row_tile = warp % 4;
  const int band_tile = (warp / 4) * 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  // this thread's bin and frames of a magnitude tile, and row and 8 bands
  // of an fb_t tile
  const int lk = tid % kChunk;
  const int lr = tid / kChunk;
  const int fb_row = tid / (kBands / 8);
  const int fb_band = (tid % (kBands / 8)) * 8;
  const bool fb_band_ok = m0 + fb_band < n_mel;  // n_mel % 8 == 0

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  __nv_bfloat16 re[kPairs], im[kPairs];
  uint4 fb = make_uint4(0, 0, 0, 0);
  auto load = [&](int f0) {
    const int f = f0 + lk;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int t = t0 + lr + i * kRowsPerPass;
      re[i] = zero;
      im[i] = zero;
      if (f < n_freq && t < n_frames) {
        const __nv_bfloat16* row = clip + t * stride_t;
        re[i] = row[f];
        im[i] = row[im_offset + f];
      }
    }
    const int fk = f0 + fb_row;
    fb = (fk < n_freq && fb_band_ok)
             ? *reinterpret_cast<const uint4*>(
                   fb_t + static_cast<long long>(fk) * n_mel + m0 + fb_band)
             : make_uint4(0, 0, 0, 0);
  };

  const int n_chunks = (n_freq + kChunk - 1) / kChunk;
  load(0);
  for (int c = 0; c < n_chunks; ++c) {
    unsigned char* buf = smem + (c & 1) * (kMagBytes + kFbBytes);
    __nv_bfloat16(*mag_s)[kMagLd] =
        reinterpret_cast<__nv_bfloat16(*)[kMagLd]>(buf);
    __nv_bfloat16(*fb_s)[kFbLd] =
        reinterpret_cast<__nv_bfloat16(*)[kFbLd]>(buf + kMagBytes);
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
      mag_s[lr + i * kRowsPerPass][lk] = magnitude(re[i], im[i]);
    *reinterpret_cast<uint4*>(&fb_s[fb_row][fb_band]) = fb;
    __syncthreads();
    if (c + 1 < n_chunks) load((c + 1) * kChunk);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::load_matrix_sync(fa, &mag_s[row_tile * 16][0], kMagLd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fbf;
      wmma::load_matrix_sync(fbf, &fb_s[0][(band_tile + j) * 16], kFbLd);
      wmma::mma_sync(acc[j], fa, fbf, acc[j]);
    }
  }
  __syncthreads();  // every warp is done with the buffers the stage reuses

  // stage[band][frame]: a column-major store of each (frame, band) fragment
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&stage[(band_tile + j) * 16][row_tile * 16],
                            acc[j], kOutLd, wmma::mem_col_major);
  __syncthreads();
  float* clip_out = out + static_cast<long long>(blockIdx.z) * n_mel * n_frames;
  for (int i = tid; i < kBands * kRows; i += kThreads) {
    const int band = i / kRows;
    const int frame = i % kRows;
    const int m = m0 + band;
    const int t = t0 + frame;
    if (m < n_mel && t < n_frames)
      clip_out[static_cast<long long>(m) * n_frames + t] =
          logf(stage[band][frame] + kLogEps);
  }
}

}  // namespace

// spec: (B, T, W) bf16, last axis contiguous, element strides stride_b and
// stride_t, re at [0, F) and im at [im_offset, im_offset + F) of each row;
// fb_t: (F, M) bf16 contiguous, 16-byte aligned, M % 8 == 0; out: (B, M, T)
// float32 contiguous; all on the current device. stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success). B <= 65535.
extern "C" int mel_log_split_launch(const void* spec, long long stride_b,
                                    long long stride_t, int im_offset,
                                    const void* fb_t, void* out, int n_batch,
                                    int n_freq, int n_frames, int n_mel,
                                    void* stream) {
  const dim3 grid((n_frames + kRows - 1) / kRows,
                  (n_mel + kBands - 1) / kBands, n_batch);
  mel_log_split_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(spec), stride_b, stride_t, im_offset,
      static_cast<const __nv_bfloat16*>(fb_t), static_cast<float*>(out),
      n_freq, n_frames, n_mel);
  return static_cast<int>(cudaGetLastError());
}
