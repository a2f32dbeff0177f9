// DSen2 residual blocks on Hopper (sm_90a), written by hand:
//
//     out = x + scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)
//
// on NHWC [B, H, W, C] activations with SAME zero padding and f32 sums.
//
// Replaces two TPU kernels: fused_resblock_chain (dsen2_tpu/ops/pallas/
// resblock_chain.py:194, pallas_call at :239) and fused_resblock
// (dsen2_tpu/ops/pallas/resblock.py:151, pallas_call at :179). Both wrappers
// (ops/resblock_chain.py, ops/resblock.py) run a block as two launches of
// one implicit-GEMM 3x3 conv kernel with two epilogues:
//   conv1: t = relu(conv(x) + b1), written as bf16 planes (hi, plus lo at
//          bf16x3) -- the values PR 3's fused kernel kept in shared memory;
//   conv2: out = x + scale * (conv(t) + b2), the residual in f32; when another
//          block follows, also the bf16 planes of out, which that block's
//          conv1 reads. The first block's planes come from split_kernel.
// PASSES = 1 is one bf16 pass (the "default" class); PASSES = 3 is bf16x3:
// hi = bf16(v), lo = bf16(v - hi) for activations and weights, and each
// k-step sums hi*hi + lo*hi + hi*lo into one f32 accumulator ("high").
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 2 * 9 * C^2 flop per
// pixel per conv, x3 at bf16x3. At [64,128,128,128] one block is 0.625 ms of
// operations at "default" and 1.875 ms at "high"; the function's own bytes
// (x in, out back) are 0.32 ms in f32, so operations bound it. This design
// also moves t and the planes through HBM (about 16 B per element per block
// at "default", 0.64 ms, and 24 B at "high", 0.96 ms), so at "default" it
// cannot reach the operations bound; the split is chosen anyway (limit 4).
//
// One CTA = one 16 x 16 output-pixel tile x 128 output channels (M = 256,
// N = 128); C = 256 runs two such N halves per pixel tile. A persistent grid
// of one CTA per SM walks the tiles. K = 9 taps x C input channels, taken in
// chunks of 64 channels (one 128-byte row per pixel) and taps.
// Threads: 384 = two consumer warpgroups (128 pixel rows each, two m64
// wgmmas per k16 step, 128 f32 accumulators per thread, setmaxnreg 224) and
// one producer warpgroup (setmaxnreg 56): its 128 threads copy the windows,
// its thread 0 the weight slices.
//
// Shared memory (bytes; the limit per block is 232,448):
//                       PASSES = 1          PASSES = 3
//   weight ring         8 x 16,384          2 x 32,768   (1024-aligned stages)
//   window ring         2 x 41,472          2 x 82,944   (18 x 18 px x 128 B x planes)
//   mbarriers           20 x 8              8 x 8
//   sum                 214,176             231,488      (+ alignment slack, checked)
//
// The five limits of PR 3's kernel and what this one does about each:
// 1. mma.sync m16n8k16 -> wgmma.mma_async m64n128k16. A (activations) comes
//    from registers, loaded by ldmatrix at the tap's shifted pixel address
//    (the 3x3 shift makes A's rows non-contiguous, which a shared-memory
//    descriptor cannot express); B (weights) comes from shared memory through
//    a K-major 128-byte-swizzle descriptor. bf16x3 issues three wgmmas per
//    k-step into one accumulator. A registers are double-buffered: a step's
//    ldmatrix writes the set whose wgmmas wgmma.wait_group<1> has retired.
// 2. Weights: the host packs them once per call straight into the swizzled
//    layout the descriptor reads (ops/resblock_chain.py, pack_weights); a
//    1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) moves each
//    (chunk, tap) slice into a ring stage, guarded by full/empty mbarriers.
//    Each staged slice serves 256 output pixels (PR 3: 64). L2 -> SM weight
//    bytes per block at [64,128,128,128]: 4,096 tiles x 2 convs x 294,912 B
//    = 2.42 GB at "default", 4.83 GB at "high" (PR 3: 11.8 / 23.6 GB).
// 3. Overlap: the producer warpgroup loads the activation window by cp.async
//    with zero fill (that is the SAME padding), completed on an mbarrier by
//    cp.async.mbarrier.arrive.noinc, into a ring of two 64-channel windows:
//    the next chunk, or the next tile's first chunk, lands while the current
//    one is multiplied; the weight ring runs ahead the same way, and the
//    epilogue of one tile overlaps the copies of the next. The epilogue does
//    not overlap the tensor cores: both consumer warpgroups run it at once.
//    That, not the copies, is what holds this design back (PERF.md, PR 4:
//    scripts/diagnose_resblock_torch.py measures each part by ablation).
// 4. Waste: two convs per block instead of one fused tile, so no halo
//    recompute and no padded M rows: 256 MMA rows buy 256 output pixels
//    (PR 3: 320 for 256). Zero fill of conv2's window masks t outside the
//    image. A fused tile with bf16x3 planes of both windows does not fit
//    232,448 B at a 16 x 16 tile, and an 8 x 16 one brings back the halo.
// 5. Host: packing happens once per wrapper call for all K blocks, and the
//    shared-memory attribute is set once per instantiation and device.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                           // output tile: 16 x 16 pixels
constexpr int kWin = kTile + 2;                     // window side, halo 1
constexpr int kWinPix = kWin * kWin;                // 324
constexpr int kKc = 64;                             // input channels per chunk
constexpr int kRowBytes = kKc * 2;                  // one pixel row of a chunk: 128 B
constexpr int kWinPlaneBytes = kWinPix * kRowBytes; // 41,472
constexpr int kN = 128;                             // output channels per CTA
constexpr int kSliceBytes = kN * kRowBytes;         // one tap, one chunk, one plane: 16,384
constexpr int kConsumers = 256;                     // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;          // + the producer warpgroup
constexpr int kSmemMax = 232448;
constexpr uint64_t kWatchdogNs = 30000000000ull;    // a 30 s wait is a fault: trap

enum { EPI_RELU = 0, EPI_RESIDUAL = 1 };

template <int PASSES> struct Cfg {
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int STAGES = PASSES == 3 ? 2 : 8;
  static constexpr int STAGE_BYTES = PLANES * kSliceBytes;
  static constexpr int WIN_BYTES = PLANES * kWinPlaneBytes;
  static constexpr int BAR_BYTES = (2 + 2 + 2 * STAGES) * 8;
  static constexpr int USED = STAGES * STAGE_BYTES + 2 * WIN_BYTES + BAR_BYTES;
  static constexpr int SMEM = USED + 1024 <= kSmemMax ? USED + 1024 : kSmemMax;
  static_assert(USED <= kSmemMax, "shared-memory budget");
};

struct ConvArgs {
  const __nv_bfloat16* src;  // input planes [PLANES][B][H][W][C]
  const __nv_bfloat16* w;    // packed [C/128][C/64][9][PLANES][128][64], swizzled
  const float* bias;         // [C]
  const void* resid;         // EPI_RESIDUAL: the block's input [B][H][W][C] of T
  void* out;                 // EPI_RESIDUAL: [B][H][W][C] of T (may be resid)
  __nv_bfloat16* planes;     // EPI_RELU: t planes; EPI_RESIDUAL: out's planes or null
  int B, H, W;
  float scale;
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with this parity has completed. A wait of
// 30 s of wall time means a fault in the pipeline: trap, so that the launch
// fails instead of hanging the card. The limit is wall time, far above any
// correct wait, so that a card shared with other processes does not trap a
// healthy launch (a trap ends the process's CUDA context).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - t0 > kWatchdogNs) __trap();
}

// 16-byte copy into shared memory; zero fill when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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

// Keep the compiler from moving accesses to registers that an in-flight
// wgmma owns across the fence, commit and wait instructions.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a K-major B tile with the 128-byte swizzle:
// rows of 64 bf16 (128 B) per output channel, 8-row groups 1024 B apart
// (SBO), start address in 16-byte units; LBO is unused by this layout.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d[64] (+)= A[64 x 16] (registers, mma.m16n8k16 A-fragment order per warp)
//           * B[16 x 128] (shared memory, descriptor).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#undef D8
}

// ------------------------------------------------------------- element I/O

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Store a pair as bf16 hi at `off` of plane 0 and, for bf16x3, lo = bf16(v - hi)
// at `off` of plane 1.
template <int PASSES>
__device__ __forceinline__ void store_split(__nv_bfloat16* planes, size_t plane_elems, size_t off,
                                            float a, float b) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(planes + off) = hi;
  if (PASSES == 3) {
    const float2 h = __bfloat1622float2(hi);
    *reinterpret_cast<__nv_bfloat162*>(planes + plane_elems + off) =
        __floats2bfloat162_rn(a - h.x, b - h.y);
  }
}

// ------------------------------------------------------------------ kernels

// f32 activations -> bf16 planes [PLANES][n], n a multiple of 4.
template <int PASSES>
__global__ void split_kernel(const float4* __restrict__ x, __nv_bfloat16* __restrict__ planes,
                             long long n4) {
  const size_t plane_elems = static_cast<size_t>(n4) * 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    store_split<PASSES>(planes, plane_elems, 4 * i, v.x, v.y);
    store_split<PASSES>(planes, plane_elems, 4 * i + 2, v.z, v.w);
  }
}

struct TileCoord {
  int b, ty0, tx0, nh;
};

template <int C>
__device__ __forceinline__ TileCoord tile_coord(int tile, int H, int W) {
  constexpr int NH = C / kN;
  const int tx_n = (W + kTile - 1) / kTile, ty_n = (H + kTile - 1) / kTile;
  TileCoord t;
  t.nh = tile % NH;
  tile /= NH;
  t.tx0 = (tile % tx_n) * kTile;
  tile /= tx_n;
  t.ty0 = (tile % ty_n) * kTile;
  t.b = tile / ty_n;
  return t;
}

template <typename T, int C, int PASSES, int EPI>
__global__ void __launch_bounds__(kThreads, 1) conv_kernel(const ConvArgs a, int tiles) {
  using K = Cfg<PASSES>;
  constexpr int PLANES = K::PLANES, STAGES = K::STAGES;
  constexpr int KC = C / kKc;  // channel chunks
  const int H = a.H, W = a.W;
  const size_t plane_elems = static_cast<size_t>(a.B) * H * W * C;

  // Layout: [pad to 1024][weight stages][window ring][barriers].
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stage_base = (raw + 1023) & ~1023u;
  const uint32_t win_base = stage_base + STAGES * K::STAGE_BYTES;
  const uint32_t bar_base = win_base + 2 * K::WIN_BYTES;
  if (bar_base + K::BAR_BYTES > raw + K::SMEM) __trap();  // base alignment left no room
  // Barriers: win_full[2], win_empty[2], full[STAGES], empty[STAGES].
  auto win_full = [&](int i) { return bar_base + 8 * i; };
  auto win_empty = [&](int i) { return bar_base + 8 * (2 + i); };
  auto full = [&](int i) { return bar_base + 8 * (4 + i); };
  auto empty = [&](int i) { return bar_base + 8 * (4 + STAGES + i); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(win_full(i), 128);  // one cp.async arrive per producer thread
      mbar_init(win_empty(i), kConsumers / 32);  // one arrive per consumer warp
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);  // the producer's expect_tx arrive
      mbar_init(empty(i), 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ======================= producer warpgroup: all four warps copy the
    // windows, thread 0 of it the weight slices
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    int wbuf = 0, stage = 0;
    uint32_t wphase = 0, sphase = 0;

    // The 18 x 18 window of 64 channels of chunk kc, every plane, zero outside
    // the image, into window buffer wbuf: 16 B per copy, pixel rows swizzled
    // (group g of pixel p at group g ^ (p & 7)) so ldmatrix is conflict-free.
    auto issue_window = [&](int tile, int kc) {
      const TileCoord tc = tile_coord<C>(tile, H, W);
      mbar_wait(win_empty(wbuf), wphase ^ 1);
      const uint32_t dst0 = win_base + wbuf * K::WIN_BYTES;
      for (int i = pt; i < PLANES * kWinPix * 8; i += 128) {
        const int pl = i / (kWinPix * 8), r = i % (kWinPix * 8);
        const int wp = r >> 3, g = r & 7;
        const int iy = tc.ty0 - 1 + wp / kWin, ix = tc.tx0 - 1 + wp % kWin;
        const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const __nv_bfloat16* src = a.src;
        if (valid)
          src += pl * plane_elems + ((static_cast<size_t>(tc.b) * H + iy) * W + ix) * C +
                 kc * kKc + g * 8;
        cp_async16(dst0 + pl * kWinPlaneBytes + wp * kRowBytes + ((g ^ (wp & 7)) << 4), src,
                   valid);
      }
      cp_async_arrive(win_full(wbuf));
      if (++wbuf == 2) { wbuf = 0; wphase ^= 1; }
    };
    // One (chunk, tap) weight slice, every plane, by one bulk copy.
    auto issue_slice = [&](int nh, int kc, int tap) {
      if (pt == 0) {
        mbar_wait(empty(stage), sphase ^ 1);
        mbar_expect_tx(full(stage), K::STAGE_BYTES);
        const __nv_bfloat16* src =
            a.w + static_cast<size_t>((nh * KC + kc) * 9 + tap) * (K::STAGE_BYTES / 2);
        bulk_copy(stage_base + stage * K::STAGE_BYTES, src, K::STAGE_BYTES, full(stage));
      }
      if (++stage == STAGES) { stage = 0; sphase ^= 1; }
    };

    if (static_cast<int>(blockIdx.x) < tiles) issue_window(blockIdx.x, 0);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nh = tile % (C / kN);
      for (int kc = 0; kc < KC; ++kc) {
        issue_slice(nh, kc, 0);
        // The next chunk's window, so that it lands while this chunk runs.
        const int next = kc + 1 < KC ? tile : tile + gridDim.x;
        if (next < tiles) issue_window(next, kc + 1 < KC ? kc + 1 : 0);
        for (int tap = 1; tap < 9; ++tap) issue_slice(nh, kc, tap);
      }
    }
  } else {
    // ======================= two consumer warpgroups: wgmma + epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = threadIdx.x / 128, wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // ldmatrix.x4 addressing: lanes 0-7 rows 0-7 of k 0-7, 8-15 rows 8-15 of
    // k 0-7, 16-23 rows 0-7 of k 8-15, 24-31 rows 8-15 of k 8-15. Row r of
    // warp wq in m64 chunk mc is output pixel (wg*8 + mc*4 + wq, r).
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, khalf = lane >> 4;
    int pix0[2];
#pragma unroll
    for (int mc = 0; mc < 2; ++mc) pix0[mc] = (wg * 8 + mc * 4 + wq) * kWin + arow;

    float acc[2][64];
    uint32_t areg[2][2][PLANES][4];  // [buffer][mc][plane]
    int wbuf = 0, stage = 0, prev = -1;
    uint32_t wphase = 0, sphase = 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
      for (int mc = 0; mc < 2; ++mc)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mc][i] = 0.f;

      for (int kc = 0; kc < KC; ++kc) {
        mbar_wait(win_full(wbuf), wphase);
        const uint32_t win = win_base + wbuf * K::WIN_BYTES;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int shift = (tap / 3) * kWin + tap % 3;
          uint32_t row_addr[2], key[2];
#pragma unroll
          for (int mc = 0; mc < 2; ++mc) {
            const int p = pix0[mc] + shift;
            row_addr[mc] = win + p * kRowBytes;
            key[mc] = p & 7;
          }
          mbar_wait(full(stage), sphase);
          const uint32_t bst = stage_base + stage * K::STAGE_BYTES;
#pragma unroll
          for (int ks = 0; ks < kKc / 16; ++ks) {
            uint32_t(&av)[2][PLANES][4] = areg[ks & 1];
#pragma unroll
            for (int mc = 0; mc < 2; ++mc)
#pragma unroll
              for (int pl = 0; pl < PLANES; ++pl)
                ldmatrix_x4(av[mc][pl], row_addr[mc] + pl * kWinPlaneBytes +
                                            (((ks * 2 + khalf) ^ key[mc]) << 4));
            if (tap == 8 && ks == kKc / 16 - 1) {  // this warp is done with the window
              __syncwarp();
              if (lane == 0) mbar_arrive(win_empty(wbuf));
            }
            const uint64_t d_hi = b_desc(bst + ks * 32);
            fence_regs(acc[0]);
            fence_regs(acc[1]);
            wgmma_fence();
#pragma unroll
            for (int mc = 0; mc < 2; ++mc) {
              wgmma_m64n128k16(acc[mc], av[mc][0], d_hi);
              if (PASSES == 3) {
                const uint64_t d_lo = b_desc(bst + kSliceBytes + ks * 32);
                wgmma_m64n128k16(acc[mc], av[mc][1], d_hi);
                wgmma_m64n128k16(acc[mc], av[mc][0], d_lo);
              }
            }
            wgmma_commit();
            fence_regs(acc[0]);
            fence_regs(acc[1]);
            wgmma_wait<1>();  // every step before this one has retired
            if (ks == 0 && prev >= 0) {  // so the previous tap's stage is free
              if (threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
              prev = -1;
            }
          }
          prev = stage;
          if (++stage == STAGES) { stage = 0; sphase ^= 1; }
        }
        if (++wbuf == 2) { wbuf = 0; wphase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
      prev = -1;

      // Epilogue. Accumulator i of m64 chunk mc holds row g + 8 * ((i / 2) % 2)
      // of warp wq's 16 and channel 8 * (i / 4) + 2 * q + i % 2; this thread's
      // four rows r = 2 * mc + h are pixels (wg*8 + mc*4 + wq, g + 8h). Each
      // row is two segments of 64 channels; the residual of segment s + 1 is
      // loaded before segment s is stored (out may be the residual itself, so
      // the compiler would not hoist the loads).
      const TileCoord tc = tile_coord<C>(tile, H, W);
      const int g = lane / 4, q = lane % 4;
      const float* __restrict__ bias = a.bias + tc.nh * kN + 2 * q;
      size_t pix[4];
      bool inside[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int iy = tc.ty0 + wg * 8 + (r / 2) * 4 + wq, ix = tc.tx0 + g + 8 * (r % 2);
        inside[r] = iy < H && ix < W;
        pix[r] = ((static_cast<size_t>(tc.b) * H + iy) * W + ix) * C + tc.nh * kN + 2 * q;
      }
      constexpr int SEG = kN / 16;  // n8 tiles per segment
      float2 xr[2][SEG];
      auto load_seg = [&](int s, float2(&d)[SEG]) {
        if (EPI == EPI_RESIDUAL && inside[s / 2])
#pragma unroll
          for (int jj = 0; jj < SEG; ++jj)
            d[jj] = load2(static_cast<const T*>(a.resid) + pix[s / 2] + 8 * (SEG * (s % 2) + jj));
      };
      load_seg(0, xr[0]);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s + 1 < 8) load_seg(s + 1, xr[(s + 1) % 2]);
        const int r = s / 2, mc = r / 2, h = r % 2;
        if (!inside[r]) continue;
#pragma unroll
        for (int jj = 0; jj < SEG; ++jj) {
          const int j = SEG * (s % 2) + jj;
          const size_t off = pix[r] + 8 * j;
          const float v0 = acc[mc][4 * j + 2 * h] + __ldg(bias + 8 * j);
          const float v1 = acc[mc][4 * j + 2 * h + 1] + __ldg(bias + 8 * j + 1);
          if (EPI == EPI_RELU) {
            store_split<PASSES>(a.planes, plane_elems, off, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          } else {
            const float o0 = xr[s % 2][jj].x + a.scale * v0, o1 = xr[s % 2][jj].y + a.scale * v1;
            store2(static_cast<T*>(a.out) + off, o0, o1);
            if (a.planes != nullptr) store_split<PASSES>(a.planes, plane_elems, off, o0, o1);
          }
        }
      }
    }
  }
}

// --------------------------------------------------------------- launchers

template <typename T, int C, int PASSES, int EPI>
int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  auto kernel = conv_kernel<T, C, PASSES, EPI>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // Devices whose attribute is set. Mesh shards launch from several host
  // threads at once; setting the attribute twice is harmless, a torn
  // read-modify-write of the mask is not.
  static std::atomic<unsigned long long> ready{0};
  if (dev >= 64) return -1;
  if (!(ready.load(std::memory_order_acquire) & (1ull << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<PASSES>::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(1ull << dev, std::memory_order_release);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = static_cast<long long>(a.B) * ((a.H + kTile - 1) / kTile) *
                          ((a.W + kTile - 1) / kTile) * (C / kN);
  if (tiles <= 0 || tiles > (1LL << 30)) return -1;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, kThreads, Cfg<PASSES>::SMEM, stream>>>(a, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

template <int C>
int dispatch(const ConvArgs& a, int passes, int dtype, int epilogue, cudaStream_t s) {
  if (epilogue == EPI_RELU) {
    if (passes == 1) return launch_conv<float, C, 1, EPI_RELU>(a, s);
    if (passes == 3) return launch_conv<float, C, 3, EPI_RELU>(a, s);
    return -1;
  }
  if (epilogue != EPI_RESIDUAL) return -1;
  if (dtype == 0 && passes == 1) return launch_conv<float, C, 1, EPI_RESIDUAL>(a, s);
  if (dtype == 0 && passes == 3) return launch_conv<float, C, 3, EPI_RESIDUAL>(a, s);
  if (dtype == 1 && passes == 1) return launch_conv<__nv_bfloat16, C, 1, EPI_RESIDUAL>(a, s);
  return -1;
}

}  // namespace

// C interface, bound with ctypes. Each returns 0, a cudaError_t from the
// launch, or -1 for arguments the kernels do not take.

// bf16 planes [passes == 3 ? 2 : 1][n] of f32 x[n]; n a multiple of 4.
extern "C" int dsen2_split_planes(const void* x, void* planes, long long n, int passes,
                                  void* stream) {
  if (n <= 0 || n % 4) return -1;
  const long long n4 = n / 4;
  const int threads = 256;
  const long long want = (n4 + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* xv = static_cast<const float4*>(x);
  __nv_bfloat16* pv = static_cast<__nv_bfloat16*>(planes);
  if (passes == 1) split_kernel<1><<<blocks, threads, 0, s>>>(xv, pv, n4);
  else if (passes == 3) split_kernel<3><<<blocks, threads, 0, s>>>(xv, pv, n4);
  else return -1;
  return (int)cudaGetLastError();
}

// One 3x3 SAME conv of bf16 planes `src` by packed weights `w`.
// epilogue 0: planes = split(relu(conv + bias)).
// epilogue 1: out = resid + scale * (conv + bias); planes = split(out) if given.
// dtype of resid/out: 0 = float32, 1 = bfloat16 (one pass only).
extern "C" int dsen2_conv3x3(const void* src, const void* w, const float* bias,
                             const void* resid, void* out, void* planes, int B, int H, int W,
                             int C, float scale, int passes, int dtype, int epilogue,
                             void* stream) {
  ConvArgs a;
  a.src = static_cast<const __nv_bfloat16*>(src);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.resid = resid;
  a.out = out;
  a.planes = static_cast<__nv_bfloat16*>(planes);
  a.B = B;
  a.H = H;
  a.W = W;
  a.scale = scale;
  if (B <= 0 || H <= 0 || W <= 0) return -1;
  if (epilogue == EPI_RELU && planes == nullptr) return -1;
  if (epilogue == EPI_RESIDUAL && (resid == nullptr || out == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return dispatch<128>(a, passes, dtype, epilogue, s);
    case 256: return dispatch<256>(a, passes, dtype, epilogue, s);
    default: return -1;
  }
}
