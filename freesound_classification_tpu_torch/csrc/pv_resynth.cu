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
//            tiles: inside a tile the sum starts from 0, left to right, and
//            is added to the tile's carry, then wrapped to (-pi, pi]; the
//            carry moves by the tile's whole sum and is wrapped too (the TPU
//            kernel's order: an unwrapped float32 sum would reach ~1e5 rad
//            and lose ~1e-2 rad)
//   re, im = bf16(mag_k * cos(phase)), bf16(mag_k * sin(phase))
//   syn_k  = bf16(re @ icos + im @ isin)     bf16 x bf16, float32 sums
//   out[b, j, :] = sum_o syn_{j-o}[o*hop : (o+1)*hop], o = 0 .. r-1 in order,
//                  in float32                                (overlap-add)
// The window-squared normalization and the crop stay in PyTorch.
//
// Bound. Operations. At the chain's shape (48 rows, rows = 1729 frames,
// F = 513, n_fft = 1024, hop = 256) the synthesis product is 174 GFLOP of
// bf16, 0.18 ms at 989 TFLOP/s; the bytes the function needs (mag and dphi
// read once, 340 MB; the float32 rows, 85 MB) take 0.13 ms.
//
// Design. The TPU kernel keeps picks, phase, product and overlap-add of a
// 128-frame tile in VMEM and carries the phase from one grid step to the
// next. Here A (the product's bf16 re/im rows) and the synthesis frames never
// reach device memory, in three launches:
//   1. pv_tile_sum_kernel: one thread per (row, 128-frame tile, bin) sums its
//      tile's picked dphi left to right from 0 and keeps the running sum
//      every 16 frames (the last is the tile's whole sum, the carry's step),
//      so that every unit below starts from the same float32 partial sums
//      as the plain twin, in any block order.
//   2. pv_resynth_kernel: one block of two warpgroups per (row, 64 frames,
//      half a phase tile). It folds the earlier tiles' sums into each bin's
//      carry, then builds A (64 x 2 bins_pad bf16, 135 KB at F = 513) in
//      shared memory: magnitude lerp, dphi pick, exclusive sum, sincosf and
//      bf16 rounding, in units of (16 frames, bin), so that 256 threads
//      share the 513 sequential sums evenly; a unit starts from launch 1's
//      sum at its first frame and loads its 48 taps, whose positions the
//      block works out once per frame, before it sums. The
//      product then runs on wgmma (m64n128k16, one warpgroup per 128
//      columns) with A and B read from shared memory without swizzle. B is
//      the padded [icos; isin] basis, laid out by the wrapper as a sequence
//      of 16 KB stages (32 k x 256 columns, in wgmma's core-matrix order),
//      streamed by cp.async.bulk into a ring of five on mbarriers; the first
//      stages load while A is built. The columns go one overlap-add offset o
//      at a time (hop <= 256 columns, zero padded): each offset's
//      accumulators are rounded to bf16 into a staging tile, 16 rows at a
//      time, and thread c adds column c of frame i into its own running sum
//      of output row i + o, in the order o = 0 .. 3.
//   3. pv_ola_fix_kernel: output rows 64h .. 64h + 2 also take the previous
//      block's last three frames. Block h - 1 writes those six bf16 terms to
//      a (B, blocks, 6, hop) spill, and this pass adds them, in order, to the
//      partial rows block h wrote: no float atomics, the plain twin's order.
// Every elementwise step is rounded on its own (__fmul_rn, __fadd_rn, ...:
// no FMA contraction), as the plain PyTorch version computes it, except the
// phase wrap's one explicit fmaf. From device memory: the picked dphi in
// launch 1 and again with mag in launch 2, the output rows, and the small
// sums and spill, ~0.6 GB against the function's 0.43; each block streams
// the whole basis (2.2 MB) from L2, ~2.9 GB in all, which with the A build
// keeps it ~5x over its bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>
#include <cstdio>

namespace {

constexpr int kTile = 128;     // frames per phase tile: the TPU kernel's _PV_TM
constexpr int kRows = 64;      // frames per block: one wgmma M
constexpr int kPartRows = 16;  // frames per unit of A's elementwise build
constexpr int kR = 4;          // overlap-add offsets: n_fft / hop
constexpr int kCols = 256;     // synthesis columns per offset: hop, padded
constexpr int kThreads = 256;  // two warpgroups, 128 columns each
constexpr int kKc = 32;        // product depth per pipeline stage
constexpr int kStages = 5;
constexpr int kStageBytes = kCols * kKc * 2;  // 16 KB of bf16
constexpr int kSynPitch = kCols + 8;  // bf16 pitch of the staging rows
constexpr int kSlots = kTile / kPartRows;  // running sums kept per tile
constexpr int kSpill = kR * (kR - 1) / 2;  // terms a block hands to the next
constexpr int kSumThreads = 128;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915493667125702f;  // float32(1 / kTwoPi)

static_assert(kTile % kRows == 0 && kRows % kPartRows == 0, "tiling");

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

// spill slot of (output row q of the next block, offset o), o > q
__host__ __device__ constexpr int spill_slot(int q, int o) {
  return q * (kR - 1) - q * (q - 1) / 2 + (o - q - 1);
}

// ---- wgmma, mbarrier and bulk-copy helpers (sm_90a) -----------------------

// A shared-memory matrix descriptor without swizzle: 8 x 16-byte core
// matrices, ``lbo`` bytes apart along K and ``sbo`` bytes apart along M/N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

#define PV_ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 float32, wgmma's fragment layout) (+)= A (64 x 16) @ B
// (16 x 128), both bf16 K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PV_ACC8(0), PV_ACC8(8), PV_ACC8(16), PV_ACC8(24), PV_ACC8(32),
        PV_ACC8(40), PV_ACC8(48), PV_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef PV_ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching the accumulators while wgmma owns them
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of ``parity`` to complete; a stage that never lands
// (a fault in the copy) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries > (1u << 24)) __trap();
  }
}

// one stage of the basis, global -> shared, completing on ``bar``
__device__ __forceinline__ void load_stage(uint32_t dst, const void* src,
                                           uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(kStageBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(kStageBytes), "r"(bar)
      : "memory");
}

// byte offset of A[m][k] (64 rows, K-major core matrices, K groups outer)
__device__ __forceinline__ int a_offset(int m, int k) {
  return (((k >> 3) * (kRows / 8) + (m >> 3)) << 7) + ((m & 7) << 4)
         + ((k & 7) << 1);
}

// ---- launch 1: per-tile sums ---------------------------------------------

// It also checks each row's rate against (0, max_rate] (the TPU kernel's
// domain) on the card, so the wrapper makes no host sync: a rate outside it
// ends the run before the later launches, as the row's first block prints
// the row and the rate and fails a device-side assert (then traps, should
// asserts be compiled out); the row's other blocks return.
__global__ void __launch_bounds__(kSumThreads)
pv_tile_sum_kernel(const float* __restrict__ dphi,
                   const float* __restrict__ rate, float* __restrict__ sums,
                   int t_in, int n_bins, int rows, int n_tiles,
                   float max_rate) {
  const int f = blockIdx.x * kSumThreads + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const float r = rate[b];
  if (!(r > 0.f && r <= max_rate)) {  // NaN fails too
    if (blockIdx.x == 0 && t == 0 && threadIdx.x == 0) {
      printf("pv_resynth: pv_tile_sum_kernel: row %d has rate %.9g outside "
             "(0, %.9g]\n", b, r, max_rate);
      assert(r > 0.f && r <= max_rate);
      __trap();
    }
    return;
  }
  if (f >= n_bins) return;
  const float* d = dphi + static_cast<long long>(b) * (t_in - 1) * n_bins + f;
  const int k0 = t * kTile;
  float* out = sums + (static_cast<long long>(b) * n_tiles + t) * kSlots
                          * n_bins + f;
  float s = 0.f;
  int k = k0;
  // slot j: the sum after 16 (j + 1) frames, the exclusive sum where unit
  // j + 1 of A starts; the last slot is the tile's whole sum, the carry's
  // step
  for (int slot = 0; slot < kSlots; ++slot) {
    const int k_stop = min(k0 + (slot + 1) * kPartRows, rows);
    for (; k < k_stop; ++k) s = __fadd_rn(s, d[dphi_row(k, r, t_in) * n_bins]);
    out[static_cast<long long>(slot) * n_bins] = s;
  }
}

// ---- launch 2: A in shared memory, the product on wgmma, overlap-add ------

__global__ void __launch_bounds__(kThreads, 1)
pv_resynth_kernel(const float* __restrict__ mag,
                  const float* __restrict__ dphi,
                  const float* __restrict__ phase0,
                  const float* __restrict__ rate,
                  const __nv_bfloat16* __restrict__ basis,
                  const float* __restrict__ sums,
                  __nv_bfloat16* __restrict__ spill, float* __restrict__ out,
                  int t_in, int n_bins, int bins_pad,
                  int hop, int rows, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k_dim = 2 * bins_pad;
  unsigned char* stages = smem;
  unsigned char* a_s = stages + kStages * kStageBytes;
  __nv_bfloat16* syn_s =
      reinterpret_cast<__nv_bfloat16*>(a_s + kRows * k_dim * 2);
  float* carry_s = reinterpret_cast<float*>(syn_s + kPartRows * kSynPitch);
  // each frame's taps, the same for every bin: the lerp's fraction and the
  // offsets in the row of its two magnitudes and of its dphi pick
  float* frac_s = carry_s + bins_pad;
  int* m0_s = reinterpret_cast<int*>(frac_s + kRows);
  int* m1_s = m0_s + kRows;
  int* d_s = m1_s + kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(d_s + kRows);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int n_steps = kR * (k_dim / kKc);
  const uint32_t stage_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(stages));
  const uint32_t a_addr = static_cast<uint32_t>(__cvta_generic_to_shared(a_s));
  const uint32_t bar_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(bars));

  // the basis streams in from the start: its first stages load while A is
  // built below
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar_addr + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < n_steps; ++s)
      load_stage(stage_addr + s * kStageBytes,
                 basis + static_cast<long long>(s) * (kStageBytes / 2),
                 bar_addr + 8 * s);
  }

  const float r = rate[b];
  const float last = static_cast<float>(t_in - 1);
  if (tid < kRows) {
    const int k = min(k0 + tid, rows - 1);  // past rows: zeros below
    const float pm = fminf(fmaxf(__fmul_rn(static_cast<float>(k), r), 0.f),
                           last);
    const float fl = floorf(pm);
    frac_s[tid] = __fsub_rn(pm, fl);
    const int j0 = static_cast<int>(fl);
    m0_s[tid] = j0 * n_bins;
    m1_s[tid] = min(j0 + 1, t_in - 1) * n_bins;
    d_s[tid] = static_cast<int>(dphi_row(k, r, t_in)) * n_bins;
  }

  // each bin's carry at this block's tile
  const int tile = k0 / kTile;
  const float* tile_sums = sums + static_cast<long long>(b) * n_tiles
                                      * kSlots * n_bins;
  for (int f = tid; f < n_bins; f += kThreads) {
    float carry = phase0[static_cast<long long>(b) * n_bins + f];
    for (int tt = 0; tt < tile; ++tt)
      carry = wrap_phase(__fadd_rn(
          carry, tile_sums[(static_cast<long long>(tt) * kSlots + kSlots - 1)
                           * n_bins + f]));
    carry_s[f] = carry;
  }
  __syncthreads();

  // A: units of (16 frames, bin); re in columns [0, bins_pad), im after.
  // A unit starts from its tile's running sum at its first frame (launch
  // 1's slot) and loads its 16 frames' taps before the sequential sums.
  const float* m_row = mag + static_cast<long long>(b) * t_in * n_bins;
  const float* d_row = dphi + static_cast<long long>(b) * (t_in - 1) * n_bins;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int u = tid; u < (kRows / kPartRows) * bins_pad; u += kThreads) {
    const int part = u / bins_pad;
    const int f = u - part * bins_pad;
    const int i0 = part * kPartRows;
    if (f >= n_bins || k0 + i0 >= rows) {
#pragma unroll
      for (int i = i0; i < i0 + kPartRows; ++i) {
        *reinterpret_cast<__nv_bfloat16*>(a_s + a_offset(i, f)) = zero;
        *reinterpret_cast<__nv_bfloat16*>(a_s + a_offset(i, bins_pad + f)) =
            zero;
      }
      continue;
    }
    const int slot = (k0 + i0) % kTile / kPartRows;  // units before, in tile
    float s = slot == 0 ? 0.f
                        : tile_sums[(static_cast<long long>(tile) * kSlots
                                     + slot - 1) * n_bins + f];
    const float carry = carry_s[f];
    float m0[kPartRows], m1[kPartRows], dd[kPartRows];
#pragma unroll
    for (int i = 0; i < kPartRows; ++i) {
      m0[i] = m_row[m0_s[i0 + i] + f];
      m1[i] = m_row[m1_s[i0 + i] + f];
      dd[i] = d_row[d_s[i0 + i] + f];
    }
#pragma unroll
    for (int i = 0; i < kPartRows; ++i) {
      float re = 0.f, im = 0.f;
      if (k0 + i0 + i < rows) {
        const float fr = frac_s[i0 + i];
        const float mg = __fadd_rn(__fmul_rn(__fsub_rn(1.f, fr), m0[i]),
                                   __fmul_rn(fr, m1[i]));
        const float phi = wrap_phase(__fadd_rn(carry, s));
        s = __fadd_rn(s, dd[i]);
        float sn, cs;
        sincosf(phi, &sn, &cs);
        re = __fmul_rn(mg, cs);
        im = __fmul_rn(mg, sn);
      }
      *reinterpret_cast<__nv_bfloat16*>(a_s + a_offset(i0 + i, f)) =
          __float2bfloat16_rn(re);
      *reinterpret_cast<__nv_bfloat16*>(a_s + a_offset(i0 + i, bins_pad + f)) =
          __float2bfloat16_rn(im);
    }
  }
  // A was written by ordinary stores; wgmma reads it through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;  // this warpgroup's 128 columns of each offset
  const int nq = k_dim / kKc;
  float acc[64];
  float run[kRows];      // column tid of output rows k0 .. k0 + 63
  __nv_bfloat16 tail[kSpill];  // column tid of the next block's terms
#pragma unroll
  for (int i = 0; i < kRows; ++i) run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSpill; ++i) tail[i] = __float2bfloat16_rn(0.f);

  const int lane = tid & 31;
  const int warp = (tid & 127) >> 5;  // its accumulators: rows 16 warp + ...
  const int frag_row = lane >> 2;
  const int frag_col = wg * 128 + (lane & 3) * 2;
  int step = 0;
#pragma unroll
  for (int o = 0; o < kR; ++o) {
    for (int q = 0; q < nq; ++q, ++step) {
      const int st = step % kStages;
      mbar_wait(bar_addr + 8 * st, (step / kStages) & 1);
      wgmma_fence();
      const uint32_t b_base = stage_addr + st * kStageBytes + wg * 16 * 128;
#pragma unroll
      for (int j = 0; j < kKc / 16; ++j)
        wgmma_m64n128k16(
            acc,
            smem_desc(a_addr + (q * (kKc / 16) + j) * 2 * (kRows / 8) * 128,
                      (kRows / 8) * 128, 128),
            smem_desc(b_base + j * 2 * (kCols / 8) * 128, (kCols / 8) * 128,
                      128),
            (q | j) != 0);
      wgmma_commit();
      // the previous step's products are done: its stage can refill
      wgmma_wait<1>();
      fence_acc(acc);
      __syncthreads();
      if (tid == 0 && step >= 1 && step - 1 + kStages < n_steps) {
        const int s = (step - 1) % kStages;
        load_stage(stage_addr + s * kStageBytes,
                   basis + static_cast<long long>(step - 1 + kStages)
                               * (kStageBytes / 2),
                   bar_addr + 8 * s);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // offset o's synthesis frames, rounded to bf16, through the staging
    // tile 16 rows at a time: warp w of each warpgroup holds rows 16 w ..
#pragma unroll
    for (int w = 0; w < kRows / kPartRows; ++w) {
      if (warp == w) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(
              syn_s + frag_row * kSynPitch + frag_col + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              syn_s + (frag_row + 8) * kSynPitch + frag_col + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < kPartRows; ++ii) {
        const int i = w * kPartRows + ii;
        const __nv_bfloat16 v = syn_s[ii * kSynPitch + tid];
        if (i + o < kRows)
          run[i + o] = __fadd_rn(run[i + o], __bfloat162float(v));
        else
          tail[spill_slot(i + o - kRows, o)] = v;
      }
      __syncthreads();  // the staging tile is free for the next rows
    }
  }

  if (tid < hop) {
    float* col = out + (static_cast<long long>(b) * rows + k0) * hop + tid;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (k0 + i < rows) col[static_cast<long long>(i) * hop] = run[i];
    if (k0 + kRows < rows) {
      __nv_bfloat16* sp = spill + (static_cast<long long>(b) * gridDim.x
                                   + blockIdx.x) * kSpill * hop + tid;
#pragma unroll
      for (int p = 0; p < kSpill; ++p) sp[p * hop] = tail[p];
    }
  }
}

// ---- launch 3: the rows that span two blocks -------------------------------

__global__ void __launch_bounds__(kCols)
pv_ola_fix_kernel(const __nv_bfloat16* __restrict__ spill,
                  float* __restrict__ out, int rows, int hop, int n_blocks) {
  const int c = threadIdx.x;
  if (c >= hop) return;
  const int h = blockIdx.x + 1;
  const int b = blockIdx.y;
  const __nv_bfloat16* sp = spill + (static_cast<long long>(b) * n_blocks
                                     + h - 1) * kSpill * hop + c;
  for (int q = 0; q < kR - 1; ++q) {
    const int g = h * kRows + q;
    if (g >= rows) return;
    float* o = out + (static_cast<long long>(b) * rows + g) * hop + c;
    float acc = *o;
    for (int oo = q + 1; oo < kR; ++oo)
      acc = __fadd_rn(acc, __bfloat162float(sp[spill_slot(q, oo) * hop]));
    *o = acc;
  }
}

}  // namespace

// mag: (B, t_in, F) f32; dphi: (B, t_in - 1, F) f32; phase0: (B, F) f32;
// rate: (B,) f32, each in (0, max_rate] (checked on the card);
// basis_tiles: the padded basis as 4 x (2 bins_pad / 32)
// stages of 256 x 32 bf16 (kernels.pv_basis_tiles); scratch sums:
// (B, n_tiles, 8, F) f32 and spill: (B, n_blocks, 6, hop) bf16, n_tiles =
// ceil(rows / 128), n_blocks = ceil(rows / 64); out: (B, rows, hop) f32. All
// contiguous on the current device; bins_pad a multiple of 16 with F <=
// bins_pad <= 528 (shared memory), hop <= 256, n_fft / hop = 4, t_in >= 2,
// B <= 65535. stream: a cudaStream_t. Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int pv_resynth_launch(const void* mag, const void* dphi,
                                 const void* phase0, const void* rate,
                                 const void* basis_tiles, void* sums,
                                 void* spill, void* out, int n_batch,
                                 int t_in, int n_bins, int bins_pad, int hop,
                                 int rows, float max_rate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (rows + kTile - 1) / kTile;
  const int n_blocks = (rows + kRows - 1) / kRows;
  cudaError_t err;

  const dim3 sum_grid((n_bins + kSumThreads - 1) / kSumThreads, n_tiles,
                      n_batch);
  pv_tile_sum_kernel<<<sum_grid, kSumThreads, 0, s>>>(
      static_cast<const float*>(dphi), static_cast<const float*>(rate),
      static_cast<float*>(sums), t_in, n_bins, rows, n_tiles, max_rate);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem = kStages * kStageBytes + kRows * 2 * bins_pad * 2
                   + kPartRows * kSynPitch * 2 + bins_pad * 4 + kRows * 16
                   + kStages * 8;
  if ((err = cudaFuncSetAttribute(pv_resynth_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  pv_resynth_kernel<<<dim3(n_blocks, n_batch), kThreads, smem, s>>>(
      static_cast<const float*>(mag), static_cast<const float*>(dphi),
      static_cast<const float*>(phase0), static_cast<const float*>(rate),
      static_cast<const __nv_bfloat16*>(basis_tiles),
      static_cast<const float*>(sums), static_cast<__nv_bfloat16*>(spill),
      static_cast<float*>(out), t_in, n_bins, bins_pad, hop, rows, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (n_blocks > 1) {
    pv_ola_fix_kernel<<<dim3(n_blocks - 1, n_batch), kCols, 0, s>>>(
        static_cast<const __nv_bfloat16*>(spill), static_cast<float*>(out),
        rows, hop, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
