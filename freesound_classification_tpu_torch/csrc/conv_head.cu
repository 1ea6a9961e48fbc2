// K8: the 2d CNN's eval-mode block0 head in one pass: bn_in -> conv3x3
// (SAME) -> 2x2 max-pool -> bn_out -> PReLU, with the full-resolution conv
// map never written.
//
// Replaces _head_kernel (freesound_classification_tpu/ops/pallas_head.py),
// which packs the input into per-row phase planes so that the TPU's matrix
// unit computes both pooling phases of a conv row from lane rolls. Here the
// 2x2 window of conv outputs behind each pooled output meets in one
// thread's accumulators.
//
// Per pooled output (b, d, ho, wo), with a = bf16(x * s_in + t_in) inside
// the map and 0 outside it (the SAME zeros are zeros of bn_in(x)), and
// bf16 kernel values w:
//   conv(r, c) = sum_{taps, ci} a[ci, r + dh - 1, c + dw - 1] w[tap, ci, d]
//   y = bf16(prelu(max_{r in 2ho+{0,1}, c in 2wo+{0,1}} conv(r, c)
//                  * scale[d] + shift[d], alpha[d]))
// Products of bf16 values are exact in float32, so the tensor cores' float32
// sums give the TPU kernel's bf16 x bf16 -> float32 sums (in another order).
//
// Bound. At the 2d path's block0 (B 128, 2 x 128 x 431 -> 64 x 64 x 215)
// the function reads 28 MB and writes 225 MB of bf16 channels_last output:
// 0.076 ms at 3.35 TB/s. Its 16 GFLOP (9 taps x 2 channels x 4 conv
// outputs per pooled output and channel) take 0.24 ms as float32 FMAs at
// 67 TFLOP/s, so on the CUDA cores the arithmetic, not the bytes, bounds
// it (the first version here, 0.56 ms). On the tensor cores, with K padded
// to 24, the 22 GFLOP take 0.02 ms at the bf16 rate: under the bytes.
//
// Design. The conv is an implicit matrix product on mma.sync bf16 with
// float32 accumulators, taken transposed: M = output channels, N = conv
// positions, K = 9 taps x CP channels (C_in rounded up to even, so that
// each k pair is one tap's two channels: one 32-bit shared load), run as
// m16n8k16 steps and one m16n8k8 for the last 2 or 4 k (K 24 at block0).
// The A operand is the packed weights (kernels.pack_conv_head: the (K,
// depth) operand): a warp keeps one 32-channel slice, so its A fragments
// and its channels' scale, shift and alpha stay in registers for the whole
// kernel, at 80 registers (three blocks an SM). Column n of an n8 tile is
// conv position (dy, n % 2) of pooled output n / 2, and the tiles of dy 0
// and 1 take the same A fragments: each pooled output's four positions
// land in one thread's accumulators, and the pool is three fmaxf. A block
// of eight warps walks tiles of 8 x 32 pooled outputs of one clip
// (persistent, as many blocks as fit the SMs): it reads the next tile's
// input into registers while it computes this one, stages bn_in(x) over
// the tile's 18 x 66 input pixels as bf16 pairs (rows of 81 pixels, so
// that the B fragments' loads hit distinct banks), and writes the pooled
// bf16 results to a staging tile in shared memory, which one thread hands
// to TMA as depth / 16 boxes of 16 channels x 8 x 32 pooled outputs
// (cp.async.bulk.tensor; TMA leaves out what lies past the map): the
// output stream runs while the warps compute the next tile.
//
// What holds it back (PERF.md, section 6): the items' ~70 warp
// instructions per 4 pooled outputs x 32 channels, over half of them the
// epilogue (three fmaxf, the affine and PReLU per output). Two blocks an SM
// (more registers: 64-channel slices, or the weights in shared memory) and
// four (64 registers) were both slower.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked:
                   // its encoder comes from the runtime's entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 8;              // pooled rows per tile
constexpr int kTileW = 32;             // pooled columns per tile
constexpr int kPix = kTileH * kTileW;  // pooled outputs per tile
constexpr int kRows = 2 * kTileH + 2;  // input rows a tile reads
constexpr int kCols = 2 * kTileW + 2;  // input columns a tile reads
constexpr int kLdP = 81;               // patch row in pixels: 17 mod 32

struct HeadGeometry {
  int height, width, h_out, w_out, tiles_h, tiles_w, n_tiles, depth, c_in;
  long long sb, sc, sh, sw;  // x's element strides
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ unsigned pack(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16 x 16, row-major) b (16 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row-major) b (8 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4],
                                            const unsigned (&a)[2],
                                            unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// TMA: out's 16-channel boxes of the tile, from shared memory
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c, int wo,
                                          int ho, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(map),
      "r"(c), "r"(wo), "r"(ho), "r"(b),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(src)))
      : "memory");
}

// Shared memory: the staging tile (depth / 16 boxes of kPix pixels x 16
// channels of bf16: TMA's boxes, and the epilogue's 2-byte stores hit
// distinct banks) and the patch (kRows x kLdP pixels of CP / 2 words).
// ops/kernels.head_plan computes the same size.
template <int CP>
__host__ __device__ constexpr int smem_bytes(int depth) {
  return kPix * depth * 2 + kRows * kLdP * (CP / 2) * 4;
}

// One thread's share of a tile's input pixels, read ahead of bn_in: pixel
// threadIdx.x + it kThreads of the tile's kRows x kCols, its CP channels
template <int CP>
struct Raw {
  static constexpr int kIters = (kRows * kCols + kThreads - 1) / kThreads;
  float v[kIters][CP];
};

__device__ __forceinline__ void tile_origin(const HeadGeometry& g, int tile,
                                            int& b, int& ho0, int& wo0) {
  const int rest = tile / g.tiles_w;
  wo0 = (tile - rest * g.tiles_w) * kTileW;
  ho0 = (rest % g.tiles_h) * kTileH;
  b = rest / g.tiles_h;
}

// x over the tile's input pixels (2 ho0 - 1 .., 2 wo0 - 1 ..) into registers
template <int CP, typename T>
__device__ __forceinline__ void read_tile(Raw<CP>& raw, const T* x,
                                          const HeadGeometry& g, int tile) {
  int b, ho0, wo0;
  tile_origin(g, tile, b, ho0, wo0);
  const T* xb = x + b * g.sb;
#pragma unroll
  for (int it = 0; it < Raw<CP>::kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kCols, c = i - r * kCols;
    const int hh = 2 * ho0 - 1 + r, ww = 2 * wo0 - 1 + c;
    const bool in = i < kRows * kCols && hh >= 0 && hh < g.height &&
                    ww >= 0 && ww < g.width;
#pragma unroll
    for (int ci = 0; ci < CP; ++ci)
      raw.v[it][ci] = in && ci < g.c_in
                          ? load(xb + hh * g.sh + ww * g.sw + ci * g.sc)
                          : 0.f;
  }
}

// bn_in of the read pixels, bf16 pairs, into the patch: zeros off the map
// (the SAME padding of bn_in(x)) and past C_in
template <int CP>
__device__ __forceinline__ void write_patch(unsigned* patch, const Raw<CP>& raw,
                                            const float* __restrict__ s_in,
                                            const float* __restrict__ t_in,
                                            const HeadGeometry& g, int tile) {
  int b, ho0, wo0;
  tile_origin(g, tile, b, ho0, wo0);
#pragma unroll
  for (int it = 0; it < Raw<CP>::kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < kRows * kCols) {
      const int r = i / kCols, c = i - r * kCols;
      const int hh = 2 * ho0 - 1 + r, ww = 2 * wo0 - 1 + c;
      const bool in = hh >= 0 && hh < g.height && ww >= 0 && ww < g.width;
      unsigned short v[CP] = {};
#pragma unroll
      for (int ci = 0; ci < CP; ++ci)
        if (in && ci < g.c_in)
          v[ci] = __bfloat16_as_ushort(__float2bfloat16_rn(
              __fadd_rn(__fmul_rn(raw.v[it][ci], s_in[ci]), t_in[ci])));
#pragma unroll
      for (int p = 0; p < CP / 2; ++p)
        patch[(r * kLdP + c) * (CP / 2) + p] =
            v[2 * p] | (static_cast<unsigned>(v[2 * p + 1]) << 16);
    }
  }
}

template <int CP, typename T>
__global__ void __launch_bounds__(kThreads, 3)
    conv_head_kernel(const T* __restrict__ x, const float* __restrict__ s_in,
                     const float* __restrict__ t_in,
                     const bf16* __restrict__ w,  // (K, depth)
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const float* __restrict__ alpha,
                     const __grid_constant__ CUtensorMap out,
                     HeadGeometry g) {
  // K = 9 CP: kK16 steps of 16, then one of 8 (the last 2 or 4 k and zeros)
  constexpr int kK16 = 9 * CP / 16;
  constexpr int kWords = CP / 2;  // 32-bit words a pixel: channel pairs
  static_assert(9 * CP - 16 * kK16 <= 8, "one k8 step ends K");
  extern __shared__ __align__(128) unsigned char smem[];
  const int depth = g.depth;
  bf16* stage = reinterpret_cast<bf16*>(smem);
  unsigned* patch = reinterpret_cast<unsigned*>(smem + kPix * depth * 2);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, q = lane % 4;
  // 32-channel slices: warp w keeps slice w % n_slices (its A fragments
  // and epilogue constants in registers) and walks every n_slices-th warp's
  // share of the groups
  const int n_slices = (depth + 31) / 32;
  const int slice = warp % n_slices;
  const int n_warps = (kWarps - slice + n_slices - 1) / n_slices;
  const int n_mt = min(2, (depth - 32 * slice) / 16);  // its m16 tiles
  // A = the operand's transpose, channels x K: fragment (mt, ks) of this
  // lane holds rows (channels) 32 slice + 16 mt + l / 4 (+ 8), k 16 ks +
  // 2 (l % 4) (+ 1, + 8, + 9); the k8 step's k 16 kK16 + 2 (l % 4) (+ 1)
  unsigned wa[2][kK16][4], wa8[2][2];
  float ep[3][2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ch = 32 * slice + 16 * mt + gq + 8 * r;
      const bool ok = mt < n_mt;
#pragma unroll
      for (int ks = 0; ks < kK16; ++ks)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const bf16* col = w + (16 * ks + 8 * hi + 2 * q) * depth + ch;
          wa[mt][ks][2 * hi + r] = ok ? pack(col[0], col[depth]) : 0u;
        }
      const bf16* col = w + (16 * kK16 + 2 * q) * depth + ch;
      wa8[mt][r] = ok ? pack(col[0], col[depth]) : 0u;
      ep[0][mt][r] = ok ? scale[ch] : 0.f;
      ep[1][mt][r] = ok ? shift[ch] : 0.f;
      ep[2][mt][r] = ok ? alpha[ch] : 0.f;
    }
  }
  // this lane's B words: k pair j is channels (2j % CP, + 1) of tap
  // 2j / CP, at (dh, dw) = (tap / 3, tap % 3) from the patch pixel of the
  // conv position; -1 past the 9 CP real k
  auto word = [&](int k) {
    const int tap = k / CP;
    return k < 9 * CP
               ? ((tap / 3) * kLdP + tap % 3) * kWords + (k % CP) / 2
               : -1;
  };
  int boff[kK16][2];
#pragma unroll
  for (int ks = 0; ks < kK16; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      boff[ks][hi] = word(16 * ks + 8 * hi + 2 * q);
  const int boff8 = word(16 * kK16 + 2 * q);

  Raw<CP> raw;
  if (blockIdx.x < g.n_tiles) read_tile<CP, T>(raw, x, g, blockIdx.x);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    write_patch<CP>(patch, raw, s_in, t_in, g, tile);
    if (threadIdx.x == 0)  // the last tile's stores have read the stage
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();  // the patch is in; the stage is free
    // the next tile's input is in flight while this one computes
    if (tile + gridDim.x < g.n_tiles)
      read_tile<CP, T>(raw, x, g, tile + gridDim.x);

    // groups of 4 pooled outputs in a pooled row; column n of an n8 tile
    // is conv position (dy, dx = n % 2) of pooled output n / 2, so lane
    // l / 4's B column is pooled output l / 8, and accumulators (c0, c1)
    // and (c2, c3) of lane l are pooled output l % 4 at dx 0 and 1, of
    // channels 32 slice + 16 mt + l / 4 and + 8
#pragma unroll 1
    for (int grp = warp / n_slices; grp < kPix / 4; grp += n_warps) {
      const int hl = grp / (kTileW / 4), pc0 = (grp % (kTileW / 4)) * 4;
      float m[2][2];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const unsigned* px = patch + ((2 * hl + dy) * kLdP + 2 * pc0 + gq) *
                                         kWords;
        unsigned b[kK16][2];
#pragma unroll
        for (int ks = 0; ks < kK16; ++ks)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) b[ks][hi] = px[boff[ks][hi]];
        const unsigned b8 = boff8 >= 0 ? px[boff8] : 0u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < n_mt) {
            float acc[4] = {};
#pragma unroll
            for (int ks = 0; ks < kK16; ++ks)
              mma_bf16(acc, wa[mt][ks], b[ks][0], b[ks][1]);
            mma_bf16_k8(acc, wa8[mt], b8);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float v = fmaxf(acc[2 * r], acc[2 * r + 1]);
              m[mt][r] = dy == 0 ? v : fmaxf(m[mt][r], v);
            }
          }
        }
      }
      // box 2 slice + mt, pixel hl kTileW + pc0 + q, channel 8 r + l / 4
      bf16* px_out = stage + (2 * slice * kPix + hl * kTileW + pc0 + q) * 16 +
                     gq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < n_mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float v = __fadd_rn(__fmul_rn(m[mt][r], ep[0][mt][r]),
                                      ep[1][mt][r]);
            px_out[mt * kPix * 16 + 8 * r] = __float2bfloat16_rn(
                v >= 0.f ? v : __fmul_rn(ep[2][mt][r], v));
          }
        }
      }
    }
    // the stage's generic stores before TMA's reads of it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the stage is complete; the patch is free

    // the tile's boxes to out, each a 16-channel slab of 8 x 32 pooled
    // outputs; TMA leaves out what lies past the map
    if (threadIdx.x == 0) {
      int b, ho0, wo0;
      tile_origin(g, tile, b, ho0, wo0);
      for (int box = 0; box < depth / 16; ++box)
        tma_store(&out, stage + box * kPix * 16, 16 * box, wo0, ho0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (threadIdx.x == 0)  // every store written before the block ends
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// out (B, H / 2, W / 2, depth in memory) as TMA's 4d tensor, innermost
// first: {depth, W / 2, H / 2, B}, boxes of {16, kTileW, kTileH, 1}
cudaError_t out_map(CUtensorMap* map, void* out, int n_batch,
                    const HeadGeometry& g, long long osb, long long osh,
                    long long osw) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(g.depth), static_cast<cuuint64_t>(g.w_out),
      static_cast<cuuint64_t>(g.h_out), static_cast<cuuint64_t>(n_batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(osw) * 2,
                                 static_cast<cuuint64_t>(osh) * 2,
                                 static_cast<cuuint64_t>(osb) * 2};
  const cuuint32_t box[4] = {16, kTileW, kTileH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int CP, typename T>
int launch(const void* x, const void* s_in, const void* t_in, const void* w,
           const void* scale, const void* shift, const void* alpha,
           const CUtensorMap& out, const HeadGeometry& g, int smem,
           void* stream) {
  if (smem != smem_bytes<CP>(g.depth))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_head_kernel<CP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = g.n_tiles < sms * per_sm ? g.n_tiles : sms * per_sm;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(s_in),
      static_cast<const float*>(t_in), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(alpha), out, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cp(const void* x, const void* s_in, const void* t_in,
              const void* w, const void* scale, const void* shift,
              const void* alpha, const CUtensorMap& out, const HeadGeometry& g,
              int smem, void* stream) {
  if (g.c_in <= 2)
    return launch<2, T>(x, s_in, t_in, w, scale, shift, alpha, out, g, smem,
                        stream);
  return launch<4, T>(x, s_in, t_in, w, scale, shift, alpha, out, g, smem,
                      stream);
}

}  // namespace

// x: a (B, C_in, H, W) map, float32 (x_bf16 = 0) or bf16 (1), element
// strides sb, sc, sh, sw. s_in, t_in: (C_in,) float32; w: the packed
// operand, bf16 (K, depth) with K = 16 ceil(9 CP / 16) rows, row tap CP +
// ci (CP = C_in rounded up to even), zero for ci >= C_in and past 9 CP;
// scale, shift, alpha: (depth,) float32; all contiguous on the current
// device. out: bf16 (B, depth, H / 2, W / 2), channels contiguous, element
// strides osb, osh, osw (multiples of 8, 16-byte aligned: TMA's strides).
// 1 <= C_in <= 4, H and W >= 2, depth a multiple of 16 in [16, 128]; n_tiles
// = B x tiles of 8 x 32 pooled outputs; smem: the kernel's shared bytes
// (ops/kernels.head_plan). stream: a cudaStream_t. Returns the cudaError_t
// of the launch.
extern "C" int conv_head_launch(
    const void* x, int x_bf16, const void* s_in, const void* t_in,
    const void* w, const void* scale, const void* shift, const void* alpha,
    void* out, int n_batch, int c_in, int height, int width, int depth,
    long long sb, long long sc, long long sh, long long sw, long long osb,
    long long osh, long long osw, int smem, void* stream) {
  if (depth < 16 || depth > 128 || depth % 16 || height < 2 || width < 2 ||
      c_in < 1 || c_in > 4 || osb % 8 || osh % 8 || osw % 8 ||
      reinterpret_cast<unsigned long long>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadGeometry g;
  g.height = height;
  g.width = width;
  g.h_out = height / 2;
  g.w_out = width / 2;
  g.tiles_h = (g.h_out + kTileH - 1) / kTileH;
  g.tiles_w = (g.w_out + kTileW - 1) / kTileW;
  g.n_tiles = n_batch * g.tiles_h * g.tiles_w;
  g.depth = depth;
  g.c_in = c_in;
  g.sb = sb;
  g.sc = sc;
  g.sh = sh;
  g.sw = sw;
  CUtensorMap map;
  const cudaError_t err = out_map(&map, out, n_batch, g, osb, osh, osw);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_bf16)
    return launch_cp<bf16>(x, s_in, t_in, w, scale, shift, alpha, map, g,
                           smem, stream);
  return launch_cp<float>(x, s_in, t_in, w, scale, shift, alpha, map, g,
                          smem, stream);
}
