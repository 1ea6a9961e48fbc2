// K4/K5, K6 and K7: the eval-mode residual blocks with BatchNorm folded, on
// one tensor-core convolution core (an implicit matrix product).
//
// Replaces four TPU kernels:
//   K7  _basic_t_kernel  freesound_classification_tpu/ops/pallas_backbone.py
//       (the backbone's stride-1 identity BasicBlock)
//   K4  _fused_kernel    freesound_classification_tpu/ops/pallas_resnet.py
//       (ResnetBlock2d, flat padded rows; use_pallas_kernel="v1")
//   K5  _fused_t_kernel  the same file (the transposed layout;
//       use_pallas_kernel True). K4's and K5's layouts are TPU sublane
//       artifacts: on Hopper one kernel serves both.
//   K6  _fused_1d_kernel freesound_classification_tpu/ops/pallas_resnet1d.py
//       (ResnetBlock1d: K4/K5's function on a (B, C, T) map, 3 taps)
//
// Functions, on a (B, C, H, W) map; x, the weights, h1, h2 and y bf16, sums
// float32 (the TPU kernels' rounding points):
//   K7:    h1 = bf16(relu(conv3x3(x, w1) + b1)), 0 off the map
//          y  = bf16(relu((conv3x3(h1, w2) + b2) + x))
//   K4/K5: h1 = bf16(prelu(x w1 + b1, a1)), 0 off the map
//          h2 = bf16(prelu(conv3x3(h1, w2) + b2, a2))
//          y  = bf16(prelu((h2 w3 + b3) + x, a3))
//   K6:    K4/K5's, with H = 1, W = T and conv3 (taps t - 1, t, t + 1)
// SAME padding is on h1: a tap off the map reads h1 = 0, not the block's
// function of a zero x; a 1d row's taps read 0 past its own clip's ends,
// never the next clip's first frame.
//
// Design. A convolution over a map of channel rows is a matrix product:
// M = B H W positions, K = taps x channels, N = output channels. The rows
// of M run over all clips of the batch, so a tile of positions spans clips
// where the map is small; each row's tap reads its own clip or a zero (the
// row's (h, w) plus the tap is checked against the map). One CTA of eight
// warps computes a BM x BN tile: 256 x 64 where the block has 64 channels
// or fewer, else 128 x 128 (the K4/K5 tail takes 64 positions at small
// maps). K runs in chunks of one tap x 32 channels through a ring of three
// stages in shared memory (64 channels and two stages for the 128-column
// tiles): cp.async (16 bytes a thread, zero-filled off the map, past the
// channels and past the weights' rows) brings the A chunk (gathered rows
// of the map, read in place through its strides) and the B chunk (the
// chunk's weight rows x BN columns) ahead of the tensor cores. Every
// staged weight chunk serves all BM rows of the tile. The warps read the
// stage through ldmatrix (B transposed) into mma.sync m16n8k16 bf16 with
// float32 accumulators; each warp holds a 32-row block of the tile, BN /
// (8 / (BM / 32)) wide. The core streams 2.7-3.2 TB/s from L2 at every
// stage of K7 (A gathered nine times, once a tap; B once per tile).
// 256-row tiles at 64 channels halve B's part, which made K7's stage 0 12%
// faster; 64-channel chunks made the 128-column tiles 4-21% faster (half
// the barriers); caching A in L1 (cp.async.ca) did not help, nor did
// loading each tile's A once as a window of every row its taps reach (4.9x
// less A traffic): L2 does not bound the core; the issue of mma.sync and
// its ldmatrix loads is the suspect (140 TFLOP/s at K7's stage 0).
//
// No halo is recomputed. K7 is two launches in one wrapper call: conv1 +
// b1 + relu written as bf16 h1 (B, H, W, cp) to device memory, then conv2
// + b2 + x + relu; the second launch reads h1 with zeros off the map, which
// is SAME padding on h1. K4/K5 is two launches too: h1 = prelu(x w1 + b1)
// to device memory, then the tail: per tile of positions, h2 over all of
// the block's channels into shared memory (bf16, zero past C), then h2 w3
// + b3 + x and the PReLU to the map; h2 never leaves the CTA. K6 runs the
// same two launches with the tail's three taps where the tail's grid fills
// the 132 SMs. At its small maps (the hierarchical model's deeper blocks:
// 768-6784 positions of 144-486 channels) the tail would be 12-106 tiles
// of 64 positions, each streaming every weight; there K6 is three
// launches, h1, h2 (through device memory, < 1 MB) and y, each tiled over
// positions and columns (64 x 128, 64 x 64 or 32 x 64, the largest whose
// grid fills the card), so that the weights are split across blocks. Each
// of those launches takes 10-21 us on the card for 0.4-1.1 GFLOP: at these
// sizes the launches' latency, not the tensor cores, bounds K6.
//
// Bound. The function moves x in and y out (56.6 MB each at K7's stage 0,
// B 128, 64 x 32 x 108; 225 MB at K4/K5's block0, B 128, 64 x 64 x 215)
// and does 65 GFLOP (K7, every stage) or 158 GFLOP (K4/K5 block0): the
// tensor cores bound it (0.066 ms and 0.16 ms at 989 TFLOP/s). K6 does
// 1.1-1.8 GFLOP on 3-7 MB a block shape: 0.002 ms. This design
// adds the h1 round trip (a write and a read of x's size), and mma.sync
// reaches a part of the card's bf16 rate that only wgmma reaches in full.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // eight warps

// A map of channel rows: position (b, h, w), channel c at
// ptr[b sb + h sh + w sw + c]. Channels [0, channels) are read (a multiple
// of 8, 16-byte aligned rows); past them the loads give zeros.
struct Map {
  const bf16* ptr;
  long long sb, sh, sw;
  int channels;
};

struct Shape {
  int height, width;
  int m_total;  // positions: B H W
  int cp;       // the weights' padded width: rows per tap and columns
};

// out[m, n] = act((acc + bias[n]) + res[m, n]) for n < n_valid (no res
// term when res is null; act relu when slope is null, else PReLU), 0 for
// n_valid <= n < n_write. pairs: out and res take aligned column pairs.
struct Epilogue {
  const float* bias;
  const float* slope;
  const bf16* res;
  long long rsb, rsh, rsw;
  bf16* out;
  long long osb, osh, osw;
  int n_valid, n_write;
  int pairs;
};

// A tile of BM positions x BN channels. K runs in chunks of kBK channels of
// one tap through a ring of kStages: 32 x 3 for the 64-column tiles (cp <=
// 64, where two blocks an SM must fit), 64 x 2 for the 128-column ones
// (half the barriers), 64 x 3 for the 32-row tile (whose A chunk is then
// one 16-byte segment a thread). A rows of kBK + 8 and B rows of BN + 8
// elements put ldmatrix's eight rows on distinct banks. A warp computes 32
// rows x kWN columns: kNT n8 tiles, 1 (the 32 x 64 tile) or even.
template <int BM, int BN>
struct Tile {
  static constexpr int kBK = BN == 64 && BM >= 64 ? 32 : 64;
  static constexpr int kStages = BN == 64 ? 3 : 2;
  static constexpr int kLdA = kBK + 8;
  static constexpr int kWarpsM = BM / 32;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWN = BN / kWarpsN;  // a warp's columns
  static constexpr int kNT = kWN / 8;       // its n8 tiles
  static constexpr int kLdB = BN + 8;       // B rows of the ring
  static constexpr int kStageA = BM * kLdA;
  static constexpr int kStageB = kBK * kLdB;
  static constexpr int kStage = kStageA + kStageB;  // elements
  static constexpr int kARows = BM * (kBK / 8) / kThreads;
  static constexpr int kBSegs = kBK * (BN / 8) / kThreads;
  static_assert((kNT == 1 || kNT % 2 == 0) && kARows >= 1 && kBSegs >= 1,
                "tile shape");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : __fmul_rn(a, v);
}

// The A rows of a CTA's tile that this thread loads: rows t / kSegs + i
// kThreads / kSegs of the tile, the 8-channel segment t % kSegs of every
// chunk. Each row keeps its position's offset in the map (-1 past M) and
// its (h, w) for the taps' bounds.
template <int BM, int kBK>
struct Gather {
  static constexpr int kLdA = kBK + 8;
  static constexpr int kSegs = kBK / 8;  // 16-byte segments of a chunk row
  static constexpr int kRows = BM * kSegs / kThreads;
  long long at[kRows];
  int h[kRows], w[kRows];

  __device__ __forceinline__ void init(const Map& x, const Shape& s, int m0) {
    const int hw = s.height * s.width;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + threadIdx.x / kSegs + i * (kThreads / kSegs);
      at[i] = -1;
      h[i] = w[i] = 0;
      if (m < s.m_total) {
        const int b = m / hw, r = m - b * hw;
        h[i] = r / s.width;
        w[i] = r - h[i] * s.width;
        at[i] = b * x.sb + h[i] * x.sh + w[i] * x.sw;
      }
    }
  }

  // the chunk (tap, channels c0 .. c0 + kBK - 1) into the A stage. Taps:
  // 1 (1x1), 3 (1d, along w: dw = tap - 1), 9 (3x3: tap 3 dh + dw)
  template <int kTaps>
  __device__ __forceinline__ void load(bf16* sa, const Map& x, const Shape& s,
                                       int tap, int c0) const {
    static_assert(kTaps == 1 || kTaps == 3 || kTaps == 9, "taps");
    const int dh = kTaps == 9 ? tap / 3 - 1 : 0;
    const int dw = kTaps == 9 ? tap % 3 - 1 : kTaps == 3 ? tap - 1 : 0;
    const int seg = threadIdx.x % kSegs;
    const int c = c0 + seg * 8;
    const long long shift = dh * x.sh + dw * x.sw + c;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int hh = h[i] + dh, ww = w[i] + dw;
      const bool ok = at[i] >= 0 && c < x.channels && hh >= 0 &&
                      hh < s.height && ww >= 0 && ww < s.width;
      cp_async16(
          sa + (threadIdx.x / kSegs + i * (kThreads / kSegs)) * kLdA + seg * 8,
          ok ? x.ptr + at[i] + shift : x.ptr, ok);
    }
  }
};

// weight rows c0 .. c0 + kBK - 1 of tap `tap` of w (taps x cp x cp, input
// channels on rows), columns n0 .. n0 + BN - 1, into the B stage; zeros past
// cp
template <int BM, int BN>
__device__ __forceinline__ void load_b(bf16* sb, const bf16* w, int cp,
                                       int tap, int c0, int n0) {
  constexpr int kBK = Tile<BM, BN>::kBK;
  constexpr int kSegs = BN / 8;  // 16-byte segments of a row
#pragma unroll
  for (int j = 0; j < kBK * kSegs / kThreads; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx / kSegs, seg = idx % kSegs;
    const int k = c0 + r, n = n0 + seg * 8;
    const bool ok = k < cp && n < cp;
    cp_async16(sb + r * (BN + 8) + seg * 8,
               ok ? w + (static_cast<long long>(tap) * cp + k) * cp + n : w,
               ok);
  }
}

// acc += the product over n_chunks K chunks: load(stage, kc) issues chunk
// kc's copies into a ring stage (and commits nothing), a_frag(stage, kc, kk,
// mt) is this lane's ldmatrix row address of the A fragment (m tile mt of
// the warp, k16 step kk of the chunk). The ring is free again on return.
template <int BM, int BN, class Load, class AFrag>
__device__ __forceinline__ void gemm(float (&acc)[2][Tile<BM, BN>::kNT][4],
                                     int n_chunks, bf16* ring, Load load,
                                     AFrag a_frag) {
  using T = Tile<BM, BN>;
  const int lane = threadIdx.x % 32;
  const int wn = (threadIdx.x / 32) % T::kWarpsN;
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_chunks) load(ring + s * T::kStage, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // chunk kc is in; every warp is done with kc - 1
    const int next = kc + T::kStages - 1;
    if (next < n_chunks) load(ring + (next % T::kStages) * T::kStage, next);
    cp_async_commit();
    const bf16* stage = ring + (kc % T::kStages) * T::kStage;
    const bf16* sb = stage + T::kStageA;
#pragma unroll
    for (int kk = 0; kk < T::kBK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], a_frag(stage, kc, kk, mt));
#pragma unroll
      for (int p = 0; p < T::kNT / 2; ++p) {
        // k rows kk + (lane & 15), columns of the n8 tiles 2p and 2p + 1
        unsigned b[4];
        ldmatrix_x4_trans(b, sb + (kk + (lane & 15)) * T::kLdB +
                                 wn * T::kWN + p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
      if constexpr (T::kNT % 2 == 1) {  // the last n8 tile on its own
        unsigned b[2];
        ldmatrix_x2_trans(b, sb + (kk + (lane & 15)) * T::kLdB +
                                 wn * T::kWN + (T::kNT - 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][T::kNT - 1], a[mt], b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile's accumulators through the epilogue to the map. Accumulator
// (mt, nt, 2 half + j) of lane l: row 32 wm + 16 mt + 8 half + l / 4,
// column wn kWN + 8 nt + 2 (l % 4) + j.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(
    const float (&acc)[2][Tile<BM, BN>::kNT][4], const Shape& s,
    const Epilogue& e, int m0, int n0) {
  using T = Tile<BM, BN>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int hw = s.height * s.width;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mt * 16 + half * 8 + lane / 4;
      if (m >= s.m_total) continue;
      const int b = m / hw, r = m - b * hw;
      const int h = r / s.width, w = r - h * s.width;
      bf16* out = e.out + b * e.osb + h * e.osh + w * e.osw;
      const bf16* res =
          e.res == nullptr ? nullptr : e.res + b * e.rsb + h * e.rsh + w * e.rsw;
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const int n = n0 + wn * T::kWN + nt * 8 + 2 * (lane % 4);
        if (n >= e.n_write) continue;
        float x2[2] = {0.f, 0.f};
        if (res != nullptr) {
          if (e.pairs && n + 1 < e.n_valid) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + n));
            x2[0] = v.x;
            x2[1] = v.y;
          } else {
            if (n < e.n_valid) x2[0] = __bfloat162float(res[n]);
            if (n + 1 < e.n_valid) x2[1] = __bfloat162float(res[n + 1]);
          }
        }
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n + j;
          float v = 0.f;
          if (c < e.n_valid) {
            v = __fadd_rn(acc[mt][nt][2 * half + j], e.bias[c]);
            if (res != nullptr) v = __fadd_rn(v, x2[j]);
            v = e.slope == nullptr ? fmaxf(v, 0.f) : prelu(v, e.slope[c]);
          }
          y[j] = v;
        }
        if (e.pairs && n + 1 < e.n_write) {
          *reinterpret_cast<__nv_bfloat162*>(out + n) =
              __floats2bfloat162_rn(y[0], y[1]);
        } else {
          out[n] = __float2bfloat16_rn(y[0]);
          if (n + 1 < e.n_write) out[n + 1] = __float2bfloat16_rn(y[1]);
        }
      }
    }
  }
}

// One convolution (kTaps 9: 3x3 SAME; 1: 1x1) of the map x by w (kTaps x
// cp x cp) through the epilogue: CTA (blockIdx.x, blockIdx.y) computes
// positions BM blockIdx.x .. and columns BN blockIdx.y ..
template <int BM, int BN, int kTaps>
__global__ void __launch_bounds__(kThreads, 2)
    conv_kernel(Map x, const bf16* __restrict__ w, Shape s, Epilogue e) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32, wm = threadIdx.x / 32 / T::kWarpsN;
  constexpr int kBK = T::kBK;
  const int kct = (s.cp + kBK - 1) / kBK;  // K chunks per tap
  Gather<BM, kBK> g;
  g.init(x, s, m0);
  float acc[2][T::kNT][4] = {};
  gemm<BM, BN>(
      acc, kTaps * kct, ring,
      [&](bf16* stage, int kc) {
        const int tap = kc / kct, c0 = (kc - tap * kct) * kBK;
        g.template load<kTaps>(stage, x, s, tap, c0);
        load_b<BM, BN>(stage + T::kStageA, w, s.cp, tap, c0, n0);
      },
      [&](const bf16* stage, int, int kk, int mt) {
        return stage + (wm * 32 + mt * 16 + (lane & 15)) * T::kLdA + kk +
               (lane >> 4) * 8;
      });
  store_tile<BM, BN>(acc, s, e, m0, n0);
}

// The resnet blocks' tail over BM positions: h2 = prelu(conv(h1, w2) + b2,
// a2) (kTaps 9: K4/K5's 3x3; 3: K6's 1d taps) for every column into shared
// memory (zero past cp), then y = prelu((h2 w3 + b3) + x, a3) through the
// epilogue e (bias b3, slope a3, res x).
template <int BM, int BN, int kTaps>
__global__ void __launch_bounds__(kThreads, 2)
    resnet_tail_kernel(Map h1, const bf16* __restrict__ w2,
                       const bf16* __restrict__ w3,
                       const float* __restrict__ b2,
                       const float* __restrict__ a2, Shape s, Epilogue e) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* h2 = ring + T::kStages * T::kStage;
  constexpr int kBK = T::kBK;
  const int kct = (s.cp + kBK - 1) / kBK;
  const int kpad = kct * kBK, ldh = kpad + 8;  // h2's columns and row
  const int m0 = blockIdx.x * BM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  Gather<BM, kBK> g;
  g.init(h1, s, m0);
#pragma unroll 1
  for (int n0 = 0; n0 < kpad; n0 += BN) {
    float acc[2][T::kNT][4] = {};
    gemm<BM, BN>(
        acc, kTaps * kct, ring,
        [&](bf16* stage, int kc) {
          const int tap = kc / kct, c0 = (kc - tap * kct) * kBK;
          g.template load<kTaps>(stage, h1, s, tap, c0);
          load_b<BM, BN>(stage + T::kStageA, w2, s.cp, tap, c0, n0);
        },
        [&](const bf16* stage, int, int kk, int mt) {
          return stage + (wm * 32 + mt * 16 + (lane & 15)) * T::kLdA + kk +
                 (lane >> 4) * 8;
        });
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + mt * 16 + half * 8 + lane / 4;
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt) {
          const int n = n0 + wn * T::kWN + nt * 8 + 2 * (lane % 4);
          if (n >= kpad) continue;
          float y[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            y[j] = n + j < s.cp
                       ? prelu(__fadd_rn(acc[mt][nt][2 * half + j], b2[n + j]),
                               a2[n + j])
                       : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(h2 + row * ldh + n) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
  }
  __syncthreads();  // h2 complete
#pragma unroll 1
  for (int n0 = 0; n0 < e.n_write; n0 += BN) {
    float acc[2][T::kNT][4] = {};
    gemm<BM, BN>(
        acc, kct, ring,
        [&](bf16* stage, int kc) {
          load_b<BM, BN>(stage + T::kStageA, w3, s.cp, 0, kc * kBK, n0);
        },
        [&](const bf16*, int kc, int kk, int mt) {
          return h2 + (wm * 32 + mt * 16 + (lane & 15)) * ldh + kc * kBK + kk +
                 (lane >> 4) * 8;
        });
    store_tile<BM, BN>(acc, s, e, m0, n0);
  }
}

// Raise the kernel's dynamic shared memory limit to smem bytes, once per
// kernel and device: the call costs host time on every launch otherwise.
template <auto kKernel>
cudaError_t allow_smem(int smem) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && allowed[device] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kDevices) allowed[device] = smem;
  return err;
}

template <int BM, int BN>
constexpr int ring_bytes() {
  return Tile<BM, BN>::kStages * Tile<BM, BN>::kStage * 2;
}

template <int BM, int BN, int kTaps>
cudaError_t launch_conv(const Map& x, const bf16* w, const Shape& s,
                        const Epilogue& e, int smem, cudaStream_t stream) {
  if (smem < ring_bytes<BM, BN>()) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<conv_kernel<BM, BN, kTaps>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.m_total + BM - 1) / BM, (e.n_write + BN - 1) / BN);
  conv_kernel<BM, BN, kTaps><<<grid, kThreads, smem, stream>>>(x, w, s, e);
  return cudaGetLastError();
}

// A launch's tiles (ops/kernels.conv_plan, small_map_plan): 256 x 64 and
// 128 x 128 for K7's 3x3 convolutions and the blocks' 1x1 h1; 64 x 128,
// 64 x 64 and 32 x 64 for K6's small maps (1x1 and 1d taps), which need
// more, smaller tiles to fill the card
template <int kTaps>
cudaError_t launch_conv_plan(int bm, int bn, const Map& x, const bf16* w,
                             const Shape& s, const Epilogue& e, int smem,
                             cudaStream_t stream) {
  if constexpr (kTaps != 3) {
    if (bm == 256 && bn == 64)
      return launch_conv<256, 64, kTaps>(x, w, s, e, smem, stream);
    if (bm == 128 && bn == 128)
      return launch_conv<128, 128, kTaps>(x, w, s, e, smem, stream);
  }
  if constexpr (kTaps != 9) {
    if (bm == 64 && bn == 128)
      return launch_conv<64, 128, kTaps>(x, w, s, e, smem, stream);
    if (bm == 64 && bn == 64)
      return launch_conv<64, 64, kTaps>(x, w, s, e, smem, stream);
    if (bm == 32 && bn == 64)
      return launch_conv<32, 64, kTaps>(x, w, s, e, smem, stream);
  }
  return cudaErrorInvalidValue;
}

template <int BM, int BN, int kTaps>
cudaError_t launch_tail(const Map& h1, const bf16* w2, const bf16* w3,
                        const float* b2, const float* a2, const Shape& s,
                        const Epilogue& e, int smem, cudaStream_t stream) {
  constexpr int kBK = Tile<BM, BN>::kBK;
  const int kpad = (s.cp + kBK - 1) / kBK * kBK;
  if (smem < ring_bytes<BM, BN>() + BM * (kpad + 8) * 2)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem<resnet_tail_kernel<BM, BN, kTaps>>(smem);
  if (err != cudaSuccess) return err;
  resnet_tail_kernel<BM, BN, kTaps>
      <<<(s.m_total + BM - 1) / BM, kThreads, smem, stream>>>(h1, w2, w3, b2,
                                                             a2, s, e);
  return cudaGetLastError();
}

// the tail's tiles (ops/kernels.tail_plan)
template <int kTaps>
cudaError_t launch_tail_plan(int bm, int bn, const Map& h1, const bf16* w2,
                             const bf16* w3, const float* b2, const float* a2,
                             const Shape& s, const Epilogue& e, int smem,
                             cudaStream_t stream) {
  if (bm == 256 && bn == 64)
    return launch_tail<256, 64, kTaps>(h1, w2, w3, b2, a2, s, e, smem, stream);
  if (bm == 128 && bn == 128)
    return launch_tail<128, 128, kTaps>(h1, w2, w3, b2, a2, s, e, smem,
                                        stream);
  if (bm == 64 && bn == 64)
    return launch_tail<64, 64, kTaps>(h1, w2, w3, b2, a2, s, e, smem, stream);
  if (bm == 64 && bn == 128)
    return launch_tail<64, 128, kTaps>(h1, w2, w3, b2, a2, s, e, smem, stream);
  return cudaErrorInvalidValue;
}

Map rows_of(const void* p, long long sb, long long sh, long long sw,
            int channels) {
  return Map{static_cast<const bf16*>(p), sb, sh, sw, channels};
}

// One launch of a plan: its tiles' rows and columns and shared bytes.
struct Launch {
  int bm, bn, smem;
};

// The folded resnet block (K4/K5: kTaps 9; K6: 3) on the map xm into out
// (element strides osb, osh, osw, contiguous channels). h1 = prelu(x w1 +
// b1, a1) to the scratch h1 (B, H, W, cp); then either the tail (two
// launches: h2 in shared memory), or, with three launches, h2 = prelu(conv(
// h1, w2) + b2, a2) to the scratch h2 (B, H, W, cp) and y = prelu((h2 w3 +
// b3) + x, a3), each tiled over positions and columns.
template <int kTaps>
cudaError_t resnet_block(const Map& xm, const bf16* w1, const bf16* w2,
                         const bf16* w3, const float* b, const float* a,
                         bf16* h1, bf16* h2, bf16* out, long long osb,
                         long long osh, long long osw, int pairs,
                         const Shape& s, int channels, int n_launches,
                         const Launch* plan, cudaStream_t st) {
  const int cp = s.cp;
  const long long hsw = cp, hsh = hsw * s.width, hsb = hsh * s.height;
  const Epilogue e1{b, a, nullptr, 0, 0, 0, h1, hsb, hsh, hsw, cp, cp, 1};
  cudaError_t err =
      launch_conv_plan<1>(plan[0].bm, plan[0].bn, xm, w1, s, e1,
                          plan[0].smem, st);
  if (err != cudaSuccess) return err;
  const Map hm = rows_of(h1, hsb, hsh, hsw, cp);
  const Epilogue ey{b + 2 * cp, a + 2 * cp, xm.ptr, xm.sb, xm.sh, xm.sw,
                    out, osb, osh, osw, channels, channels, pairs};
  if (n_launches == 2)
    return launch_tail_plan<kTaps>(plan[1].bm, plan[1].bn, hm, w2, w3,
                                   b + cp, a + cp, s, ey, plan[1].smem, st);
  if (n_launches != 3 || h2 == nullptr) return cudaErrorInvalidValue;
  const Epilogue e2{b + cp, a + cp, nullptr, 0, 0, 0, h2, hsb, hsh, hsw,
                    cp, cp, 1};
  err = launch_conv_plan<kTaps>(plan[1].bm, plan[1].bn, hm, w2, s, e2,
                                plan[1].smem, st);
  if (err != cudaSuccess) return err;
  return launch_conv_plan<1>(plan[2].bm, plan[2].bn,
                             rows_of(h2, hsb, hsh, hsw, cp), w3, s, ey,
                             plan[2].smem, st);
}

}  // namespace

// K7. x: the block's input as channel rows (element strides sb, sh, sw;
// channels contiguous, x_channels of them readable: a multiple of 8, every
// row 16-byte aligned). w1, w2: bf16 (9, cp, cp), tap 3 dh + dw, input
// channels on rows, zero past C; bias: float32 (2, cp), b1 then b2, zero
// past C. h1: scratch bf16 (B, H, W, cp), contiguous. out: (B, C, H, W)
// bf16 with element strides osb, osh, osw and contiguous channels. pairs:
// x and out rows take aligned 4-byte column pairs. bm, bn: the tiles'
// positions and columns (256 x 64 or 128 x 128); smem: the ring's bytes
// (ops/kernels.conv_plan). stream: a cudaStream_t. Returns the first
// cudaError_t of the two launches (0 on success).
extern "C" int basic_block_launch(
    const void* x, long long sb, long long sh, long long sw, int x_channels,
    const void* w1, const void* w2, const void* bias, void* h1, void* out,
    long long osb, long long osh, long long osw, int pairs, int n_batch,
    int channels, int cp, int height, int width, int bm, int bn, int smem,
    void* stream) {
  const Shape s{height, width, n_batch * height * width, cp};
  const long long hsw = cp, hsh = hsw * width, hsb = hsh * height;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  bf16* h = static_cast<bf16*>(h1);
  const Map xm = rows_of(x, sb, sh, sw, x_channels);
  const Epilogue e1{b, nullptr, nullptr, 0, 0, 0, h, hsb, hsh, hsw,
                    cp, cp, 1};
  cudaError_t err = launch_conv_plan<9>(
      bm, bn, xm, static_cast<const bf16*>(w1), s, e1, smem, st);
  if (err != cudaSuccess) return err;
  const Epilogue e2{b + cp, nullptr, xm.ptr, sb, sh, sw,
                    static_cast<bf16*>(out), osb, osh, osw,
                    channels, channels, pairs};
  return launch_conv_plan<9>(bm, bn, rows_of(h1, hsb, hsh, hsw, cp),
                             static_cast<const bf16*>(w2), s, e2, smem, st);
}

// K4/K5. x, h1, out, pairs: as basic_block_launch. w1, w3: bf16 (cp, cp);
// w2: bf16 (9, cp, cp), tap 3 dh + dw; input channels on rows, zero past C.
// bias, slope: float32 (3, cp), (b1, b2, b3) and (a1, a2, a3), zero past C.
// bm, bn, smem: the h1 launch's tiles and ring bytes; tail_bm, tail_bn,
// tail_smem: the tail's (ops/kernels.tail_plan). Returns the first
// cudaError_t of the two launches.
extern "C" int resnet_block_2d_launch(
    const void* x, long long sb, long long sh, long long sw, int x_channels,
    const void* w1, const void* w2, const void* w3, const void* bias,
    const void* slope, void* h1, void* out, long long osb, long long osh,
    long long osw, int pairs, int n_batch, int channels, int cp, int height,
    int width, int bm, int bn, int smem, int tail_bm, int tail_bn,
    int tail_smem, void* stream) {
  const Shape s{height, width, n_batch * height * width, cp};
  const Launch plan[2] = {{bm, bn, smem}, {tail_bm, tail_bn, tail_smem}};
  return resnet_block<9>(
      rows_of(x, sb, sh, sw, x_channels), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
      static_cast<const float*>(bias), static_cast<const float*>(slope),
      static_cast<bf16*>(h1), nullptr, static_cast<bf16*>(out), osb, osh,
      osw, pairs, s, channels, 2, plan, static_cast<cudaStream_t>(stream));
}

// K6, on a (B, C, T) map: the core with H = 1 and W = T. x: channel rows
// (element strides sb per clip, st per frame; as basic_block_launch). w1,
// w3: bf16 (cp, cp); w2: bf16 (3, cp, cp), taps t - 1, t, t + 1; bias,
// slope: as resnet_block_2d_launch. h1, h2: scratch bf16 (B, T, cp),
// contiguous (h2 unused, may be null, with two launches). out: bf16 with
// element strides osb, ost and contiguous channels. n_launches: 2 (h1,
// then the tail) or 3 (h1, h2, y: small maps); bm*, bn*, smem*: each
// launch's tiles and shared bytes (ops/kernels.resnet_block_1d_plan).
// Returns the first cudaError_t of the launches.
extern "C" int resnet_block_1d_launch(
    const void* x, long long sb, long long st, int x_channels,
    const void* w1, const void* w2, const void* w3, const void* bias,
    const void* slope, void* h1, void* h2, void* out, long long osb,
    long long ost, int pairs, int n_batch, int channels, int cp, int length,
    int n_launches, int bm0, int bn0, int smem0, int bm1, int bn1, int smem1,
    int bm2, int bn2, int smem2, void* stream) {
  const Shape s{1, length, n_batch * length, cp};
  const Launch plan[3] = {
      {bm0, bn0, smem0}, {bm1, bn1, smem1}, {bm2, bn2, smem2}};
  return resnet_block<3>(
      rows_of(x, sb, 0, st, x_channels), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
      static_cast<const float*>(bias), static_cast<const float*>(slope),
      static_cast<bf16*>(h1), static_cast<bf16*>(h2),
      static_cast<bf16*>(out), osb, 0, ost, pairs, s, channels, n_launches,
      plan, static_cast<cudaStream_t>(stream));
}
