// K8: the 2d CNN's eval-mode block0 head in one pass: bn_in -> conv3x3
// (SAME) -> 2x2 max-pool -> bn_out -> PReLU, with the full-resolution conv
// map never written.
//
// Replaces _head_kernel (freesound_classification_tpu/ops/pallas_head.py),
// which packs the input into per-row phase planes so that the TPU's matrix
// unit computes both pooling phases of a conv row from lane rolls. Here the
// 2x2 window of conv outputs behind each pooled output is computed directly.
//
// Per pooled output (b, d, ho, wo), with a = bf16(x * s_in + t_in) inside
// the map and 0 outside it (the SAME zeros are zeros of bn_in(x)), and
// bf16 kernel values w:
//   conv(r, c) = sum_{taps, ci} a[ci, r + dh - 1, c + dw - 1] w[tap, ci, d]
//   y = bf16(prelu(max_{r in 2ho+{0,1}, c in 2wo+{0,1}} conv(r, c)
//                  * scale[d] + shift[d], alpha[d]))
// Products of bf16 values are exact in float32, so the float32 FMAs give the
// TPU kernel's bf16 x bf16 -> float32 sums (in another order).
//
// Why no tensor cores: the contraction is 9 taps x C_in <= 4 channels (18
// at block0). A wmma tile would pad K to 16 or 32 and still need the input
// rearranged into rows of 18; the work is 2 x 4 x 18 FLOP per output
// against 2 bytes written, so the output stream bounds the kernel
// (~0.08 ms at the path's block0 against ~0.02 ms of bf16 work), and
// float32 FMAs on the CUDA cores are enough.
//
// Design. One block of 256 threads per (clip, 8 pooled rows, 32 pooled
// columns). The block stages bn_in(x) over the 18 input rows and 66 input
// columns its outputs read, bf16-rounded, in shared memory; each thread
// owns one output channel d (its 9 x C_in weights and the affine in
// registers) and walks the tile's outputs two columns at a time, so that
// neighbouring threads write neighbouring channels of a channels_last
// output. A first version with one pooled row per block spent most of its
// time waiting on each block's staging loads (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;            // pooled columns per block
constexpr int kTileH = 8;             // pooled rows per block
constexpr int kCols = 2 * kTileW + 2;  // input columns per block
constexpr int kRows = 2 * kTileH + 2;  // input rows per block

struct HeadGeometry {
  int height, width, h_out, w_out, tiles_h, tiles_w, depth;
  long long sb, sc, sh, sw;      // x's element strides
  long long osb, osc, osh, osw;  // out's element strides
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int kCin, typename T>
__global__ void __launch_bounds__(kThreads)
conv_head_kernel(const T* __restrict__ x, const float* __restrict__ s_in,
                 const float* __restrict__ t_in,
                 const __nv_bfloat16* __restrict__ w,  // (9, kCin, depth)
                 const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 const float* __restrict__ alpha,
                 __nv_bfloat16* __restrict__ out, HeadGeometry g) {
  __shared__ __align__(16) float patch[kCin][kRows][kCols];

  const int strip = blockIdx.x % g.tiles_w;
  const int rest = blockIdx.x / g.tiles_w;
  const int ho0 = (rest % g.tiles_h) * kTileH;
  const int b = rest / g.tiles_h;
  const int wo0 = strip * kTileW;
  const int r0 = 2 * ho0 - 1;  // the first input row the outputs read
  const int c0 = 2 * wo0 - 1;  // the first input column
  const T* xb = x + b * g.sb;

  for (int i = threadIdx.x; i < kCin * kRows * kCols; i += kThreads) {
    const int col = i % kCols;
    const int r = (i / kCols) % kRows;
    const int ci = i / (kRows * kCols);
    const int hh = r0 + r;
    const int ww = c0 + col;
    float v = 0.f;
    if (hh >= 0 && hh < g.height && ww >= 0 && ww < g.width) {
      const float xv = load(xb + ci * g.sc + hh * g.sh + ww * g.sw);
      v = __bfloat162float(__float2bfloat16_rn(
          __fadd_rn(__fmul_rn(xv, s_in[ci]), t_in[ci])));
    }
    patch[ci][r][col] = v;
  }
  __syncthreads();

  const int per_pass = kThreads / g.depth;  // columns walked side by side
  const int d = threadIdx.x % g.depth;
  const int lane_col = threadIdx.x / g.depth;
  if (lane_col >= per_pass) return;
  float wr[9 * kCin];
#pragma unroll
  for (int i = 0; i < 9 * kCin; ++i) wr[i] = __bfloat162float(w[i * g.depth + d]);
  const float s_out = scale[d], t_out = shift[d], a = alpha[d];
  __nv_bfloat16* ob = out + b * g.osb + d * g.osc;

  // two pooled columns (wo, wo + 1) of a pooled row a step: their 4 x 6
  // input window is read as float2 pairs, 12 shared loads per channel for
  // 8 conv outputs
  for (int item = lane_col; item < kTileH * kTileW / 2; item += per_pass) {
    const int i_row = item / (kTileW / 2);
    const int j = 2 * (item % (kTileW / 2));
    const int ho = ho0 + i_row;
    const int wo = wo0 + j;
    if (ho >= g.h_out) break;
    if (wo >= g.w_out) continue;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ci = 0; ci < kCin; ++ci) {
      float p[4][6];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 6; c += 2) {
          const float2 v =
              *reinterpret_cast<const float2*>(
                  &patch[ci][2 * i_row + r][2 * j + c]);
          p[r][c] = v.x;
          p[r][c + 1] = v.y;
        }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 4; ++dx)
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
              acc[dy][dx] = fmaf(p[dy + kh][dx + kw],
                                 wr[(kh * 3 + kw) * kCin + ci], acc[dy][dx]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (wo + half < g.w_out) {
        const float m =
            fmaxf(fmaxf(acc[0][2 * half], acc[0][2 * half + 1]),
                  fmaxf(acc[1][2 * half], acc[1][2 * half + 1]));
        const float y = __fadd_rn(__fmul_rn(m, s_out), t_out);
        ob[ho * g.osh + (wo + half) * g.osw] =
            __float2bfloat16_rn(y >= 0.f ? y : __fmul_rn(a, y));
      }
    }
  }
}

template <int kCin, typename T>
int launch(const void* x, const void* s_in, const void* t_in, const void* w,
           const void* scale, const void* shift, const void* alpha, void* out,
           int n_batch, const HeadGeometry& g, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>(n_batch) * g.tiles_h * g.tiles_w;
  conv_head_kernel<kCin, T><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(s_in),
      static_cast<const float*>(t_in), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(alpha), static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cin(int c_in, const void* x, const void* s_in, const void* t_in,
               const void* w, const void* scale, const void* shift,
               const void* alpha, void* out, int n_batch,
               const HeadGeometry& g, void* stream) {
  switch (c_in) {
    case 1:
      return launch<1, T>(x, s_in, t_in, w, scale, shift, alpha, out, n_batch,
                          g, stream);
    case 2:
      return launch<2, T>(x, s_in, t_in, w, scale, shift, alpha, out, n_batch,
                          g, stream);
    case 3:
      return launch<3, T>(x, s_in, t_in, w, scale, shift, alpha, out, n_batch,
                          g, stream);
    case 4:
      return launch<4, T>(x, s_in, t_in, w, scale, shift, alpha, out, n_batch,
                          g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: a (B, C_in, H, W) map, float32 (x_bf16 = 0) or bf16 (1), element
// strides sb, sc, sh, sw. s_in, t_in: (C_in,) float32; w: (9, C_in, depth)
// bf16, tap 3 dh + dw; scale, shift, alpha: (depth,) float32; all contiguous
// on the current device. out: bf16 (B, depth, H / 2, W / 2) with element
// strides osb, osc, osh, osw. 1 <= C_in <= 4, H and W >= 2, depth <= 256.
// stream: a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int conv_head_launch(
    const void* x, int x_bf16, const void* s_in, const void* t_in,
    const void* w, const void* scale, const void* shift, const void* alpha,
    void* out, int n_batch, int c_in, int height, int width, int depth,
    long long sb, long long sc, long long sh, long long sw, long long osb,
    long long osc, long long osh, long long osw, void* stream) {
  if (depth < 1 || depth > kThreads || height < 2 || width < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadGeometry g;
  g.height = height;
  g.width = width;
  g.h_out = height / 2;
  g.w_out = width / 2;
  g.tiles_h = (g.h_out + kTileH - 1) / kTileH;
  g.tiles_w = (g.w_out + kTileW - 1) / kTileW;
  g.depth = depth;
  g.sb = sb;
  g.sc = sc;
  g.sh = sh;
  g.sw = sw;
  g.osb = osb;
  g.osc = osc;
  g.osh = osh;
  g.osw = osw;
  if (x_bf16)
    return launch_cin<__nv_bfloat16>(c_in, x, s_in, t_in, w, scale, shift,
                                     alpha, out, n_batch, g, stream);
  return launch_cin<float>(c_in, x, s_in, t_in, w, scale, shift, alpha, out,
                           n_batch, g, stream);
}
