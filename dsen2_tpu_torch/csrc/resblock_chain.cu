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
// RCAN (models/rcan.py, ops/channel_attention.py) runs the same conv kernel
// at C = 64 (f32 activations only): a tile is then all 64 output channels
// (kTileN; m64n64k16 wgmmas, weight slices of 8,192 B a plane). Its block
// ends in a gate over the whole image, so conv2 takes a third epilogue,
// EPI_POOL: y = conv(t) + b2 in f32, and each warp's per-channel sums of y
// over its pixels of the tile, one row each, no atomics. ca_gate_kernel, its
// own launch, adds the rows in a fixed order, computes the channel attention
// in f32 and writes x + s * y with the planes the next conv1 reads. The group
// and long-skip convs are EPI_RESIDUAL at scale 1.
//
// DSen2's head and tail convs on the kernel route, which feed B1 its first
// planes and read its output, are two more kernels near the end of this file
// (head_kernel, tail_kernel), with their own note there.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 2 * 9 * C^2 flop per
// pixel per conv, x3 at bf16x3. At [64,128,128,128] one block is 0.625 ms of
// operations at "default" and 1.875 ms at "high"; the function's own bytes
// (x in, out back) are 0.32 ms in f32, so operations bound it. This design
// also moves t and the planes through HBM (about 16 B per element per block
// at "default", 0.64 ms, and 24 B at "high", 0.96 ms), so at "default" it
// cannot reach the operations bound; the split is chosen anyway (limit 4).
//
// Schedule: a cluster of two CTAs (two SMs) takes one 16 x 16 output-pixel
// tile x 128 output channels at a time (M = 256, N = 128); C = 256 runs two
// such N halves per pixel tile. CTA rank r owns rows 8r..8r+7 of the tile: 128
// pixels, M = 128. A persistent grid of as many clusters as fit at once walks
// the tiles. K = 9 taps x C input channels, taken in chunks of 64 channels
// (one 128-byte row per pixel) and taps.
// Threads: 384 = two consumer warpgroups and one producer warpgroup, whose
// thread 0 copies the weight slices and thread 32 loads the windows. The
// consumer warpgroups take the CTA's tiles in turn (ping-pong): warpgroup 0
// the cluster's 1st, 3rd, ... tile, warpgroup 1 the 2nd, 4th, ... Each owns
// a whole 8 x 16 half: 128 pixel rows, two m64 wgmmas per k16 step, 128 f32
// accumulators per thread. A warpgroup runs the epilogue of its tile while
// the other one's wgmmas run the next tile, so the epilogue is off the
// tensor cores' path except for the last tile of each CTA.
//
// Shared memory (bytes; the limit per block is 232,448):
//                       PASSES = 1          PASSES = 3
//   weight ring         8 x 16,384          4 x 32,768   (1024-aligned stages)
//   window ring         4 x 23,552          2 x 47,104   (10 x 18 px x 128 B per plane,
//                                                          planes 1024-aligned)
//   mbarriers           24 x 8              12 x 8
//   sum                 225,472             225,376      (+ alignment slack, checked)
// Registers (setmaxnreg; 65,536 per SM): consumers 232 a thread (128
// accumulators, 32 for two sets of A fragments), producer 40. ptxas spills
// nothing (chip_smoke.py phase 1 checks).
//
// The five limits of PR 3's kernel and what this one does about each:
// 1. mma.sync m16n8k16 -> wgmma.mma_async m64n128k16. A (activations) comes
//    from registers, loaded by ldmatrix at the tap's shifted pixel address
//    (the 3x3 shift makes A's rows non-contiguous, which a shared-memory
//    descriptor cannot express); B (weights) comes from shared memory through
//    a K-major 128-byte-swizzle descriptor. bf16x3 issues three wgmmas per
//    k-step into one accumulator. A registers are double-buffered: a commit
//    group's ldmatrix writes the set whose wgmmas wgmma.wait_group<1> has
//    retired. A group is one k16 step at bf16x3 (6 wgmmas) and two at one
//    pass (4 wgmmas), so that one warpgroup alone keeps the tensor cores
//    fed; four sets in flight instead would spill at bf16x3 and make ptxas
//    serialize the wgmmas at one pass.
// 2. Weights: the host packs them once per call straight into the swizzled
//    layout the descriptor reads (ops/resblock_chain.py, pack_weights). Each
//    (chunk, tap) slice goes into a ring stage of both CTAs of the cluster:
//    each CTA's producer copies half of it by a 1-D bulk copy multicast to
//    the pair (cp.async.bulk ... multicast::cluster), completing on each
//    CTA's full mbarrier; a stage is refilled once both CTAs' consumers have
//    released it (an empty mbarrier that counts one arrive from each CTA;
//    the remote arrive keeps the default CTA-scope release, since a
//    cluster-scope one compiles to a GPU-wide fence in the mainloop). So one
//    L2 read of a slice serves 256 output pixels (the mma.sync kernel: 64),
//    as when one CTA held all 256. L2 -> SM weight bytes per block at
//    [64,128,128,128]: 4,096 tiles x 2 convs x 294,912 B = 2.42 GB at
//    "default", 4.83 GB at "high" (mma.sync: 11.8 / 23.6 GB).
// 3. Overlap: each window (the tile's 10 x 18 pixels of a 64-channel chunk)
//    is one TMA box per plane of a 4-D tensor map (C, W, H, planes x B),
//    zero outside the image (that is the SAME padding), with the 128-byte
//    swizzle, so ldmatrix is conflict-free; it lands while the chunk before
//    it is multiplied, and the weight ring runs ahead the same way. Both
//    rings are consumed in the order the tiles alternate between the
//    warpgroups. Since a parity wait is only sound one phase ahead, a
//    warpgroup starts waiting on its tile's ring slots once the other has
//    passed the waits of its own tile: at the last slice of a tile's
//    mainloop it passes the turn (named barriers 1 and 2), so the next
//    tile's wgmmas queue behind the last ones of this tile, and its
//    epilogue (bias, ReLU or the residual, the plane split, the stores) runs
//    beside them. A warp releases a window only after the wgmmas that take
//    its ldmatrix registers have issued: before that the reads may still be
//    pending, and the next TMA would overwrite them. The ReLU epilogue
//    transposes inside each quad of lanes so that every store is 16
//    contiguous bytes: 4-byte stores, as the earlier epilogue made, held back the
//    other warpgroup's ldmatrix (scripts/diagnose_resblock_torch.py measures
//    each part by ablation).
// 4. Waste: two convs per block instead of one fused tile, so no halo
//    recompute and no padded M rows: 256 MMA rows buy 256 output pixels
//    (PR 3: 320 for 256). Zero fill of conv2's window masks t outside the
//    image. A CTA's window is 10 x 18 pixels for its 8 x 16 (1.41 pixels
//    loaded per output pixel; 1.27 for a 16 x 16 tile in one CTA), a small
//    cost beside the weights. A fused tile with bf16x3 planes of both windows
//    does not fit 232,448 B at a 16 x 16 tile, and an 8 x 16 one brings back
//    the halo.
// 5. Host: packing happens once per wrapper call for all K blocks; the
//    shared-memory attribute and the number of co-resident clusters are set
//    and read once per instantiation and device; the window tensor map is
//    encoded per launch (a host call of microseconds).
//
// Every output element sums the same bf16 products in the same order as in
// the earlier schedule, both warpgroups on one 16 x 16 tile (chunk, tap, k16
// step; hi*hi, lo*hi, hi*lo), from zero, and its epilogue does the same float
// operations, so the outputs are bit-equal to it.

#include <atomic>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                           // a cluster's tile: 16 x 16 pixels
constexpr int kCluster = 2;                         // CTAs per cluster
constexpr int kRows = kTile / kCluster;             // a CTA's rows of the tile: 8
constexpr int kWin = kTile + 2;                     // window row: 18 pixels, halo 1
constexpr int kWinPix = (kRows + 2) * kWin;         // 10 x 18 = 180
constexpr int kKc = 64;                             // input channels per chunk
constexpr int kRowBytes = kKc * 2;                  // one pixel row of a chunk: 128 B
constexpr int kWinPlaneBytes = kWinPix * kRowBytes; // 23,040
constexpr int kWinPlaneStride = 23 * 1024;          // a plane of a window, 1024-aligned
constexpr int kN = 128;                             // output channels per tile (C >= 128)
constexpr int kConsumers = 256;                     // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;          // + the producer warpgroup
constexpr int kSmemMax = 232448;
constexpr uint64_t kWatchdogNs = 30000000000ull;    // a 30 s wait is a fault: trap

enum { EPI_RELU = 0, EPI_RESIDUAL = 1, EPI_POOL = 2 };

// Output channels of a tile: 128, or all of C below that (RCAN's C = 64
// takes one m64n64k16 tile per k16 step where C >= 128 takes m64n128k16).
template <int C> constexpr int kTileN = C < kN ? C : kN;

template <int PASSES, int NT = kN> struct Cfg {
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int STAGES = PASSES == 3 ? 4 : 8;  // weight ring
  static constexpr int WINS = PASSES == 3 ? 2 : 4;    // window ring
  static constexpr int KSG = PASSES == 3 ? 1 : 2;     // k16 steps per wgmma commit group
  static constexpr int SLICE_BYTES = NT * kRowBytes;  // one tap, chunk and plane: 16,384 at NT 128
  static constexpr int STAGE_BYTES = PLANES * SLICE_BYTES;
  static constexpr int WIN_BYTES = PLANES * kWinPlaneStride;
  static constexpr int BAR_BYTES = (2 * WINS + 2 * STAGES) * 8;
  static constexpr int USED = STAGES * STAGE_BYTES + WINS * WIN_BYTES + BAR_BYTES;
  static constexpr int SMEM = USED + 1024 <= kSmemMax ? USED + 1024 : kSmemMax;
  static_assert(USED <= kSmemMax, "shared-memory budget");
  static_assert((kKc / 16) % (2 * KSG) == 0, "the two A sets alternate within a slice");
};

struct ConvArgs {
  const __nv_bfloat16* src;  // input planes [PLANES][B][H][W][C]
  const __nv_bfloat16* w;    // packed [C/NT][C/64][9][PLANES][NT][64], swizzled (NT = kTileN)
  const float* bias;         // [C]
  const void* resid;         // EPI_RESIDUAL: the block's input [B][H][W][C] of T
  void* out;                 // EPI_RESIDUAL: [B][H][W][C] of T (may be resid); EPI_POOL: y, f32
  __nv_bfloat16* planes;     // EPI_RELU: t planes; EPI_RESIDUAL: out's planes or null
  float* pool;               // EPI_POOL: per-warp channel sums [B][tiles of an image][2][4][C]
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

// Copy `bytes` from global memory to CTA-relative address `dst` in every CTA
// of `mask`, completing on the mbarrier at CTA-relative `bar` in each.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// One box of the 4-D tensor map at `map` (a kernel parameter) into shared
// memory at `dst`, completing on `bar`; coordinates innermost first, out of
// range elements zero.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Every thread of both CTAs: release what came before, acquire the peer's.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// Arrive on the mbarrier at CTA-relative address `bar` in CTA `cta` of the
// cluster. The default (CTA-scope) release: a .release.cluster arrive
// compiles to a GPU-wide memory barrier before it, which stalls the
// warpgroup's wgmma issue; what the arrive orders is the retired wgmmas'
// reads of the stage, which wgmma.wait_group has completed.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// The consumer warpgroups' turns: named barrier 1 + w lets warpgroup w start
// its next tile's mainloop once the other warpgroup has passed it on.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kConsumers) : "memory");
}

// Move a ring position (index i of RING, phase parity) n slots on.
template <int RING>
__device__ __forceinline__ void advance(int& i, uint32_t& phase, int n) {
  i += n;
  phase ^= (i / RING) & 1;
  i %= RING;
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
}

// d[32] (+)= A[64 x 16] * B[16 x 64]: the same operands, half the columns.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#undef D8
}

// One k16 step of a tile NT channels wide.
__device__ __forceinline__ void wgmma_tile(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_m64n128k16(d, a, desc);
}

__device__ __forceinline__ void wgmma_tile(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_m64n64k16(d, a, desc);
}

// ------------------------------------------------------------- element I/O

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16x3 lo plane of the pair whose hi plane is `hi`: bf16(v - hi).
__device__ __forceinline__ uint32_t bf16x2_lo_bits(float a, float b, uint32_t hi) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return bf16x2_bits(a - h.x, b - h.y);
}

// Store a pair as bf16 hi at `off` of plane 0 and, for bf16x3, lo = bf16(v - hi)
// at `off` of plane 1.
template <int PASSES>
__device__ __forceinline__ void store_split(__nv_bfloat16* planes, size_t plane_elems, size_t off,
                                            float a, float b) {
  const uint32_t hi = bf16x2_bits(a, b);
  *reinterpret_cast<uint32_t*>(planes + off) = hi;
  if (PASSES == 3)
    *reinterpret_cast<uint32_t*>(planes + plane_elems + off) = bf16x2_lo_bits(a, b, hi);
}

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

__device__ __forceinline__ void store16(__nv_bfloat16* p, const uint32_t (&u)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// Lanes q = 0..3 of a quad hold u[jj] = element (q, jj) of a 4 x 4 matrix;
// afterwards lane q holds column q: u[i] = element (i, q). Two exchanges,
// across lanes q ^ 2 and then q ^ 1; every lane of the warp takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&u)[4], int q) {
  const bool b1 = q & 2, b0 = q & 1;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b1 ? u[p] : u[p + 2], 2);
    if (b1) u[p] = r; else u[p + 2] = r;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b0 ? u[2 * p] : u[2 * p + 1], 1);
    if (b0) u[2 * p] = r; else u[2 * p + 1] = r;
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

// Both halves of a bf16x2 widened to f32 as PyTorch widens a bf16.
__device__ __forceinline__ float2 bf16x2_widen(uint32_t u) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__bfloat162float(p.x), __bfloat162float(p.y));
}

// A pair's class-conv planes as f32 values, rounded as store_split rounds:
// hi = bf16(v) and, for bf16x3, lo = bf16(v - hi).
template <int PASSES>
__device__ __forceinline__ void split_pair(float a, float b, float2& hi, float2& lo) {
  const uint32_t h = bf16x2_bits(a, b);
  hi = bf16x2_widen(h);
  lo = PASSES == 3 ? bf16x2_widen(bf16x2_lo_bits(a, b, h)) : make_float2(0.f, 0.f);
}

// f32 v[n] -> the class conv's planes (ops/conv.py::_planes): f32 hi[n] and,
// for bf16x3, lo[n], each value a bf16 (its low 16 bits zero), in one pass
// that reads v once. VEC (v, hi and lo on 16-byte boundaries): groups of 4
// as float4, then the last n % 4 elements one by one; else all one by one.
template <int PASSES, bool VEC>
__global__ void plane_kernel(const float* __restrict__ v, float* __restrict__ hi,
                             float* __restrict__ lo, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n4 = VEC ? n / 4 : 0;
  for (long long i = t; i < n4; i += stride) {
    const float4 x = reinterpret_cast<const float4*>(v)[i];
    float2 h0, l0, h1, l1;
    split_pair<PASSES>(x.x, x.y, h0, l0);
    split_pair<PASSES>(x.z, x.w, h1, l1);
    reinterpret_cast<float4*>(hi)[i] = make_float4(h0.x, h0.y, h1.x, h1.y);
    if (PASSES == 3) reinterpret_cast<float4*>(lo)[i] = make_float4(l0.x, l0.y, l1.x, l1.y);
  }
  for (long long i = 4 * n4 + t; i < n; i += stride) {
    float2 h, l;
    split_pair<PASSES>(v[i], 0.f, h, l);
    hi[i] = h.x;
    if (PASSES == 3) lo[i] = l.x;
  }
}

// RCAN's channel attention, one launch per residual channel-attention block
// (RCAB) after its conv2 (EPI_POOL), per image b:
//   mean[c] = (the conv's per-warp sums of y, added in row order) / (H W)
//   s = sigmoid(Wu relu(Wd mean + bd) + bu)       (f32, C -> R -> C)
//   out = x + s * y, and out's bf16 planes, which the next conv1 reads.
// Replaces no TPU kernel: the JAX package has no RCAN. Bytes bound it (x and
// y read, out and its planes written: 16 B per element at "high", 14 at
// "default"; 0.32 ms per RCAB at [64,128,128,64] "high"). Each block of
// gridDim.x per image reduces the sums itself (a reduction across blocks
// would need a second launch); at [64,128,128,64] that is 128 KB from L2 per
// block, 6 % of the kernel's bytes. out may be x (in place).
constexpr int kGateThreads = 512;
constexpr int kGateMaxC = 256, kGateMaxR = 64;

struct GateArgs {
  const float* x;          // [B][H][W][C]
  const float* y;          // [B][H][W][C]
  const float* pool;       // [B][rows][C]
  const float* wd;         // [C][R]
  const float* bd;         // [R]
  const float* wu;         // [R][C]
  const float* bu;         // [C]
  float* out;              // [B][H][W][C], may be x
  __nv_bfloat16* planes;   // [PLANES][B][H][W][C]
  int B, H, W, C, R, rows;
};

template <int PASSES>
__global__ void __launch_bounds__(kGateThreads) ca_gate_kernel(const GateArgs g) {
  __shared__ float part[kGateThreads];
  __shared__ float mean[kGateMaxC], hid[kGateMaxR], s[kGateMaxC];
  const int b = blockIdx.y, C = g.C, tid = threadIdx.x;
  // The channel sums: thread tid adds rows k, k + n, ... of channel c, then
  // thread c adds the n partial sums; a fixed order.
  const int n = kGateThreads / C, c = tid % C, k = tid / C;
  const float* rows = g.pool + static_cast<size_t>(b) * g.rows * C;
  float acc = 0.f;
  for (int r = k; r < g.rows; r += n) acc += rows[static_cast<size_t>(r) * C + c];
  part[tid] = acc;
  __syncthreads();
  if (tid < C) {
    float t = 0.f;
    for (int i = 0; i < n; ++i) t += part[i * C + tid];
    mean[tid] = t / static_cast<float>(g.H * g.W);
  }
  __syncthreads();
  if (tid < g.R) {
    float z = g.bd[tid];
    for (int i = 0; i < C; ++i) z += mean[i] * g.wd[i * g.R + tid];
    hid[tid] = fmaxf(z, 0.f);
  }
  __syncthreads();
  if (tid < C) {
    float z = g.bu[tid];
    for (int j = 0; j < g.R; ++j) z += hid[j] * g.wu[j * C + tid];
    s[tid] = 1.f / (1.f + expf(-z));
  }
  __syncthreads();
  // out = x + s * y over this block's share of image b, four channels a
  // thread and step (C is a multiple of 4); the product and the sum are
  // rounded apart, as in the plain version.
  const size_t n4 = static_cast<size_t>(g.H) * g.W * C / 4;
  const size_t base = static_cast<size_t>(b) * n4;
  const size_t plane_elems = static_cast<size_t>(g.B) * n4 * 4;
  const float4* x4 = reinterpret_cast<const float4*>(g.x) + base;
  const float4* y4 = reinterpret_cast<const float4*>(g.y) + base;
  float4* o4 = reinterpret_cast<float4*>(g.out) + base;
  for (size_t i = blockIdx.x * static_cast<size_t>(kGateThreads) + tid; i < n4;
       i += static_cast<size_t>(gridDim.x) * kGateThreads) {
    const float4 xv = x4[i], yv = y4[i];
    const int c0 = static_cast<int>((4 * i) % C);
    float4 o;
    o.x = __fadd_rn(xv.x, __fmul_rn(s[c0], yv.x));
    o.y = __fadd_rn(xv.y, __fmul_rn(s[c0 + 1], yv.y));
    o.z = __fadd_rn(xv.z, __fmul_rn(s[c0 + 2], yv.z));
    o.w = __fadd_rn(xv.w, __fmul_rn(s[c0 + 3], yv.w));
    o4[i] = o;
    const size_t e = 4 * (base + i);
    const uint32_t h0 = bf16x2_bits(o.x, o.y), h1 = bf16x2_bits(o.z, o.w);
    *reinterpret_cast<uint2*>(g.planes + e) = make_uint2(h0, h1);
    if (PASSES == 3)
      *reinterpret_cast<uint2*>(g.planes + plane_elems + e) =
          make_uint2(bf16x2_lo_bits(o.x, o.y, h0), bf16x2_lo_bits(o.z, o.w, h1));
  }
}

struct TileCoord {
  int b, ty0, tx0, nh;
};

template <int C>
__device__ __forceinline__ TileCoord tile_coord(int tile, int H, int W) {
  constexpr int NH = C / kTileN<C>;
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

// `tiles` counts the clusters' 16 x 16 x 128 tiles; cluster c takes tiles c,
// c + clusters, ...; each CTA of it the rows of its rank, each warpgroup of
// the CTA every other one of them.
template <typename T, int C, int PASSES, int EPI>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    conv_kernel(const ConvArgs a, const __grid_constant__ CUtensorMap win_map, int tiles) {
  constexpr int NT = kTileN<C>;  // output channels of a tile
  using K = Cfg<PASSES, NT>;
  constexpr int PLANES = K::PLANES, STAGES = K::STAGES, WINS = K::WINS;
  constexpr int KSG = K::KSG;
  constexpr int KC = C / kKc;     // channel chunks
  constexpr int SLOTS = KC * 9;   // weight slices per tile
  const int H = a.H, W = a.W;
  const size_t plane_elems = static_cast<size_t>(a.B) * H * W * C;
  // A 1-D grid of clusters of kCluster x 1 x 1: the CTA's rank in its
  // cluster (%cluster_ctarank) is blockIdx.x % kCluster.
  const int rank = blockIdx.x % kCluster;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  // Layout: [pad to 1024][weight stages][window ring][barriers], at the same
  // CTA-relative addresses in both CTAs of the cluster.
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stage_base = (raw + 1023) & ~1023u;
  const uint32_t win_base = stage_base + STAGES * K::STAGE_BYTES;
  const uint32_t bar_base = win_base + WINS * K::WIN_BYTES;
  if (bar_base + K::BAR_BYTES > raw + K::SMEM) __trap();  // base alignment left no room
  // Barriers: win_full[WINS], win_empty[WINS], full[STAGES], empty[STAGES].
  auto win_full = [&](int i) { return bar_base + 8 * i; };
  auto win_empty = [&](int i) { return bar_base + 8 * (WINS + i); };
  auto full = [&](int i) { return bar_base + 8 * (2 * WINS + i); };
  auto empty = [&](int i) { return bar_base + 8 * (2 * WINS + STAGES + i); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < WINS; ++i) {
      mbar_init(win_full(i), 1);   // the window thread's expect_tx arrive
      mbar_init(win_empty(i), 4);  // one arrive per warp of the consuming warpgroup
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);          // this CTA's producer's expect_tx arrive
      mbar_init(empty(i), kCluster);  // one arrive from each CTA's consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peer's barriers are ready before any copy or arrive

  if (threadIdx.x >= kConsumers) {
    // ======================= producer warpgroup: thread 0 copies this CTA's
    // half of each weight slice, thread 32 loads the windows, each at its own
    // pace; the other threads have nothing to do
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    if (pt == 0) {
      // One (chunk, tap) weight slice, every plane, per slot: this CTA copies
      // its half to both CTAs once both have released the stage, and expects
      // the whole.
      constexpr int PART = K::STAGE_BYTES / kCluster;
      int stage = 0;
      uint32_t sphase = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const int nh = tile % (C / NT);
        for (int slot = 0; slot < SLOTS; ++slot) {  // (kc, tap) = (slot / 9, slot % 9)
          mbar_wait(empty(stage), sphase ^ 1);
          mbar_expect_tx(full(stage), K::STAGE_BYTES);
          const __nv_bfloat16* src =
              a.w + static_cast<size_t>(nh * SLOTS + slot) * (K::STAGE_BYTES / 2) +
              rank * (PART / 2);
          bulk_copy_multicast(stage_base + stage * K::STAGE_BYTES + rank * PART, src, PART,
                              full(stage), (1u << kCluster) - 1);
          if (++stage == STAGES) { stage = 0; sphase ^= 1; }
        }
      }
    } else if (pt == 32) {
      // Thread 0 of warp 1: the 10 x 18 window of 64 channels of each chunk,
      // one TMA box per plane, zero outside the image (the SAME padding),
      // into the next window buffer. The 128-byte swizzle puts 16-byte group
      // g of window pixel p at group g ^ (p & 7), so ldmatrix is
      // conflict-free.
      int wbuf = 0;
      uint32_t wphase = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const TileCoord tc = tile_coord<C>(tile, H, W);
        for (int kc = 0; kc < KC; ++kc) {
          mbar_wait(win_empty(wbuf), wphase ^ 1);
          mbar_expect_tx(win_full(wbuf), PLANES * kWinPlaneBytes);
          for (int pl = 0; pl < PLANES; ++pl)
            tma_load_4d(win_base + wbuf * K::WIN_BYTES + pl * kWinPlaneStride, &win_map,
                        kc * kKc, tc.tx0 - 1, tc.ty0 + kRows * rank - 1, pl * a.B + tc.b,
                        win_full(wbuf));
          if (++wbuf == WINS) { wbuf = 0; wphase ^= 1; }
        }
      }
    }
  } else {
    // ======================= two consumer warpgroups, tiles in turn: wgmma +
    // epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128, wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // ldmatrix.x4 addressing: lanes 0-7 rows 0-7 of k 0-7, 8-15 rows 8-15 of
    // k 0-7, 16-23 rows 0-7 of k 8-15, 24-31 rows 8-15 of k 8-15. Row r of
    // warp wq in m64 chunk mc is pixel (mc*4 + wq, r) of the CTA's 8 x 16.
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, khalf = lane >> 4;
    int pix0[2];
#pragma unroll
    for (int mc = 0; mc < 2; ++mc) pix0[mc] = (mc * 4 + wq) * kWin + arow;

    float acc[2][NT / 2];
    uint32_t areg[2][KSG][2][PLANES][4];  // [set][k16 step][mc][plane]
    int wbuf = 0, stage = 0, prev = -1;
    uint32_t wphase = 0, sphase = 0;
    // Both rings serve the cluster's tiles in order; warpgroup 1's first
    // tile starts one tile in.
    if (wg == 1) {
      advance<WINS>(wbuf, wphase, KC);
      advance<STAGES>(stage, sphase, SLOTS);
    }

    for (int tile = cluster + wg * clusters; tile < tiles; tile += 2 * clusters) {
      if (tile >= clusters) turn_wait(wg);  // not the cluster's first tile
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
          // Every ring wait of this tile is behind us: the other warpgroup
          // may wait on its own tile's slots now.
          if (kc == KC - 1 && tap == 8 && tile + clusters < tiles) turn_pass(wg);
          const uint32_t bst = stage_base + stage * K::STAGE_BYTES;
#pragma unroll
          for (int gr = 0; gr < kKc / 16 / KSG; ++gr) {
            uint32_t(&av)[KSG][2][PLANES][4] = areg[gr % 2];
#pragma unroll
            for (int u = 0; u < KSG; ++u)
#pragma unroll
              for (int mc = 0; mc < 2; ++mc)
#pragma unroll
                for (int pl = 0; pl < PLANES; ++pl)
                  ldmatrix_x4(av[u][mc][pl], row_addr[mc] + pl * kWinPlaneStride +
                                                 ((((gr * KSG + u) * 2 + khalf) ^ key[mc]) << 4));
            fence_regs(acc[0]);
            fence_regs(acc[1]);
            wgmma_fence();
#pragma unroll
            for (int u = 0; u < KSG; ++u) {
              const int ks = gr * KSG + u;
              const uint64_t d_hi = b_desc(bst + ks * 32);
#pragma unroll
              for (int mc = 0; mc < 2; ++mc) {
                wgmma_tile(acc[mc], av[u][mc][0], d_hi);
                if (PASSES == 3) {
                  const uint64_t d_lo = b_desc(bst + K::SLICE_BYTES + ks * 32);
                  wgmma_tile(acc[mc], av[u][mc][1], d_hi);
                  wgmma_tile(acc[mc], av[u][mc][0], d_lo);
                }
              }
            }
            wgmma_commit();
            if (tap == 8 && gr == kKc / 16 / KSG - 1) {
              // This warp is done with the window: its ldmatrix reads are
              // complete once the wgmmas that take their registers have
              // issued, and only then may the next window's TMA overwrite it.
              __syncwarp();
              if (lane == 0) mbar_arrive(win_empty(wbuf));
            }
            fence_regs(acc[0]);
            fence_regs(acc[1]);
            wgmma_wait<1>();  // every group before this one has retired
            if (gr == 0 && prev >= 0) {  // so the previous tap's stage is free
              // lane c of warp 0 releases it in CTA c
              if (threadIdx.x % 128 < kCluster) mbar_arrive_cluster(empty(prev), lane);
              prev = -1;
            }
          }
          prev = stage;
          if (++stage == STAGES) { stage = 0; sphase ^= 1; }
        }
        if (++wbuf == WINS) { wbuf = 0; wphase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (threadIdx.x % 128 < kCluster) mbar_arrive_cluster(empty(prev), lane);
      prev = -1;
      // The other warpgroup's tile takes the next slots of both rings.
      advance<WINS>(wbuf, wphase, KC);
      advance<STAGES>(stage, sphase, SLOTS);

      // Epilogue, beside the other warpgroup's mainloop. Accumulator i of m64
      // chunk mc holds row g + 8 * ((i / 2) % 2) of warp wq's 16 and channel
      // 8 * (i / 4) + 2 * q + i % 2; this thread's four rows r = 2 * mc + h are
      // pixels (mc*4 + wq, g + 8h) of the CTA's 8 x 16, so a quad (the four
      // lanes q of one g) holds a pixel's channels.
      const TileCoord tc = tile_coord<C>(tile, H, W);
      const int g = lane / 4, q = lane % 4;
      size_t pix[4];  // element offset of this thread's pixels at channel NT nh
      bool inside[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int iy = tc.ty0 + kRows * rank + (r / 2) * 4 + wq, ix = tc.tx0 + g + 8 * (r % 2);
        inside[r] = iy < H && ix < W;
        pix[r] = ((static_cast<size_t>(tc.b) * H + iy) * W + ix) * C + tc.nh * NT;
      }
      // bias + 4 j: the bias of channels 8 j + 2 q, + 1
      const float2* __restrict__ bias = reinterpret_cast<const float2*>(a.bias + tc.nh * NT) + q;
      if (EPI == EPI_RELU) {
        // The bf16 planes of t: per row and four n8 tiles, a transpose inside
        // the quad gives lane q tile 4 t + q's 8 channels, so each lane
        // stores 16 contiguous bytes and a quad a pixel's 64: a quarter of
        // the store instructions of 4-byte pairs, and whole sectors.
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int mc = r / 2, h = r % 2;
          const bool keep = inside[r];
#pragma unroll
          for (int t = 0; t < NT / 32; ++t) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * t + jj;
              const float2 bj = __ldg(bias + 4 * j);
              const float v0 = fmaxf(acc[mc][4 * j + 2 * h] + bj.x, 0.f);
              const float v1 = fmaxf(acc[mc][4 * j + 2 * h + 1] + bj.y, 0.f);
              hi[jj] = bf16x2_bits(v0, v1);
              if (PASSES == 3) lo[jj] = bf16x2_lo_bits(v0, v1, hi[jj]);
            }
            const size_t off = pix[r] + 8 * (4 * t + q);
            quad_transpose(hi, q);
            if (keep) store16(a.planes + off, hi);
            if (PASSES == 3) {
              quad_transpose(lo, q);
              if (keep) store16(a.planes + plane_elems + off, lo);
            }
          }
        }
      } else if (EPI == EPI_POOL) {
        // y = conv + bias in f32 pairs, as the residual epilogue stores them,
        // and the sum of y over this warp's pixels of the tile for each
        // channel: per thread over its four rows, then across the eight
        // lanes g that hold the same channels. Lanes g = 0 write the warp's
        // row of a.pool; the gate kernel adds the rows in a fixed order, so
        // no atomics and the same bits every run.
        float sum[NT / 4];  // channels 8 j + 2 q and + 1 at sum[2 j], sum[2 j + 1]
#pragma unroll
        for (int i = 0; i < NT / 4; ++i) sum[i] = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int mc = r / 2, h = r % 2;
          const bool keep = inside[r];
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const float2 bj = __ldg(bias + 4 * j);
            const float v0 = acc[mc][4 * j + 2 * h] + bj.x;
            const float v1 = acc[mc][4 * j + 2 * h + 1] + bj.y;
            if (keep) {
              store2(static_cast<float*>(a.out) + pix[r] + 8 * j + 2 * q, v0, v1);
              sum[2 * j] += v0;
              sum[2 * j + 1] += v1;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < NT / 4; ++i)
#pragma unroll
          for (int m = 4; m < 32; m *= 2) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], m);
        if (g == 0) {
          const int tx_n = (W + kTile - 1) / kTile, ty_n = (H + kTile - 1) / kTile;
          const int in_image = (tc.ty0 / kTile) * tx_n + tc.tx0 / kTile;
          float* row = a.pool +
                       ((((static_cast<size_t>(tc.b) * ty_n * tx_n + in_image) * kCluster + rank) *
                             4 + wq) * C + tc.nh * NT + 2 * q);
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) store2(row + 8 * j, sum[2 * j], sum[2 * j + 1]);
        }
      } else {
        // f32 (or bf16) pairs: a quad reads and writes a pixel's 8 channels,
        // whole 32-byte sectors in f32. Each row is two segments of NT / 2
        // channels; the residual of segment s + 1 is loaded before segment s
        // is stored (out may be the residual itself, so the compiler would
        // not hoist the loads).
        constexpr int SEG = NT / 16;  // n8 tiles per segment
        float2 xr[2][SEG];
        auto load_seg = [&](int s, float2(&d)[SEG]) {
          if (inside[s / 2])
#pragma unroll
            for (int jj = 0; jj < SEG; ++jj)
              d[jj] = load2(static_cast<const T*>(a.resid) + pix[s / 2] + 8 * (SEG * (s % 2) + jj) +
                            2 * q);
        };
        load_seg(0, xr[0]);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          if (s + 1 < 8) load_seg(s + 1, xr[(s + 1) % 2]);
          const int r = s / 2, mc = r / 2, h = r % 2;
          const bool keep = inside[r];
#pragma unroll
          for (int jj = 0; jj < SEG; ++jj) {
            const int j = SEG * (s % 2) + jj;
            const size_t off = pix[r] + 8 * j + 2 * q;
            const float2 bj = __ldg(bias + 4 * j);
            const float v0 = acc[mc][4 * j + 2 * h] + bj.x;
            const float v1 = acc[mc][4 * j + 2 * h + 1] + bj.y;
            const float o0 = xr[s % 2][jj].x + a.scale * v0, o1 = xr[s % 2][jj].y + a.scale * v1;
            if (keep) {
              store2(static_cast<T*>(a.out) + off, o0, o1);
              if (a.planes != nullptr) store_split<PASSES>(a.planes, plane_elems, off, o0, o1);
            }
          }
        }
      }
    }
  }
  // No CTA leaves while its peer may still arrive on its barriers.
  cluster_sync();
}

// --------------------------------------------------------------- launchers

// The tensor map the window loads read: input planes [planes][B][H][W][C]
// as 4-D (C, W, H, planes * B), a box of 64 channels x 18 x 10 pixels x 1,
// the 128-byte swizzle, zero outside. -2 if the driver cannot encode it.
int encode_window_map(CUtensorMap* map, const ConvArgs& a, int C, int planes) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return -2;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 2;  // bytes per pixel
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(a.W),
                              static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(planes) * a.B};
  const cuuint64_t strides[3] = {row, row * a.W, row * a.W * a.H};
  const cuuint32_t box[4] = {kKc, kWin, kRows + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<__nv_bfloat16*>(a.src), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

// Launch one conv, or with a == nullptr only report in *clusters how many
// clusters of this instantiation fit on the device at once (the grid).
template <typename T, int C, int PASSES, int EPI>
int launch_conv(const ConvArgs* a, cudaStream_t stream, int* clusters) {
  using K = Cfg<PASSES, kTileN<C>>;
  auto kernel = conv_kernel<T, C, PASSES, EPI>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  // Co-resident clusters per device, 0 until set. Mesh shards launch from
  // several host threads at once; setting the attribute and reading the
  // count twice is harmless.
  static std::atomic<int> resident[64];
  int fit = resident[dev].load(std::memory_order_acquire);
  if (fit == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = K::SMEM;
    err = cudaOccupancyMaxActiveClusters(&fit, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit <= 0) return -1;
    resident[dev].store(fit, std::memory_order_release);
  }
  if (clusters != nullptr) *clusters = fit;
  if (a == nullptr) return 0;
  const long long tiles = static_cast<long long>(a->B) * ((a->H + kTile - 1) / kTile) *
                          ((a->W + kTile - 1) / kTile) * (C / kTileN<C>);
  if (tiles <= 0 || tiles > (1LL << 30)) return -1;
  CUtensorMap win_map;
  const int bad = encode_window_map(&win_map, *a, C, K::PLANES);
  if (bad != 0) return bad;
  const int grid = kCluster * (tiles < fit ? static_cast<int>(tiles) : fit);
  kernel<<<grid, kThreads, K::SMEM, stream>>>(*a, win_map, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

// C = 64 (RCAN) takes f32 activations only, and is the one width with the
// pooling epilogue; C = 128 and 256 (DSen2, VDSen2) also take bf16 ones.
template <int C>
int dispatch(const ConvArgs* a, int passes, int dtype, int epilogue, cudaStream_t s,
             int* clusters) {
  if (epilogue == EPI_RELU) {
    if (passes == 1) return launch_conv<float, C, 1, EPI_RELU>(a, s, clusters);
    if (passes == 3) return launch_conv<float, C, 3, EPI_RELU>(a, s, clusters);
    return -1;
  }
  if (epilogue == EPI_POOL) {
    if constexpr (C == 64) {
      if (dtype == 0 && passes == 1) return launch_conv<float, C, 1, EPI_POOL>(a, s, clusters);
      if (dtype == 0 && passes == 3) return launch_conv<float, C, 3, EPI_POOL>(a, s, clusters);
    }
    return -1;
  }
  if (epilogue != EPI_RESIDUAL) return -1;
  if (dtype == 0 && passes == 1) return launch_conv<float, C, 1, EPI_RESIDUAL>(a, s, clusters);
  if (dtype == 0 && passes == 3) return launch_conv<float, C, 3, EPI_RESIDUAL>(a, s, clusters);
  if constexpr (C != 64) {
    if (dtype == 1 && passes == 1)
      return launch_conv<__nv_bfloat16, C, 1, EPI_RESIDUAL>(a, s, clusters);
  }
  return -1;
}

int dispatch_c(const ConvArgs* a, int C, int passes, int dtype, int epilogue, cudaStream_t s,
               int* clusters) {
  switch (C) {
    case 64: return dispatch<64>(a, passes, dtype, epilogue, s, clusters);
    case 128: return dispatch<128>(a, passes, dtype, epilogue, s, clusters);
    case 256: return dispatch<256>(a, passes, dtype, epilogue, s, clusters);
    default: return -1;
  }
}


// ------------------------------------------------ DSen2's head and tail convs
//
// The net's first and last 3x3 convs on the kernel route (ops/head_tail.py):
//   head: x = relu(conv(concat(inputs), w) + b) for 2 or 3 NHWC f32 inputs of
//         at most 16 channels together and F = 128 or 256 outputs; x in
//         f32 and, when asked, x's bf16 planes for B1's first conv1 (what
//         split_kernel would write, bit for bit: store_split's rounding);
//   tail: out = (conv(x, w) + b) + resid for f32 x of F channels and at most
//         8 outputs, resid the net's last input (the global residual).
// Both at the class: "high" sums xh*wh + xl*wh + xh*wl, "default" xh*wh, each
// product of bf16 values exact in the f32 accumulator of mma.m16n8k16, x
// split in registers with store_split's rounding. They replace no TPU
// kernel: the JAX package leaves the head and tail to XLA convs. Training
// keeps the class conv (ops/conv.py): it needs the convs' backward and the
// planes the forward saves for it, which these kernels, made for inference,
// do not have.
//
// Bytes bound them. Per pixel the head reads about 44 B and writes 4 F B of
// x plus 2 F B per plane (1,024 B at F = 128 "high") for 2 x 9 x 16 x F
// products a pass; the tail reads 4 F B of x (512 B) and writes 48 B for
// 2 x 9 x F x 8 products a pass. At [64, 128, 128] that is 0.33 ms for the
// head and 0.18 ms for the tail at 3.35 TB/s, 3x and 3x the time of their
// "high" products at the tensor cores' bf16 peak. So the design spends its
// effort on the memory side:
// - a CTA takes 16 x 16 output pixels at a time from a persistent grid; the
//   18 x 18 pixel window of 16 input channels (one k16 step, f32) lands in
//   shared memory by cp.async (16 B a copy in the tail; 4 B in the head,
//   whose inputs are 4, 6 and 2 channels wide), zero outside the image (the
//   SAME padding), while the CTA computes the window before it (a ring of 2
//   stages in the head; 3 in the tail, whose F / 16 windows a tile follow
//   each other through it, across tiles too);
// - each warp owns 4 output rows x 16 pixels; in the tail an A fragment (16
//   pixels x 16 channels, split to its planes in registers) serves every
//   output row its window row reaches (18 fragments a k16 step for 36 row
//   taps), and a weight fragment all 4 rows;
// - the weights are packed by the host in mma.m16n8k16's B-fragment order
//   (ops/head_tail.py, pack_fragments), so that a warp reads a fragment as
//   256 contiguous bytes: the head's stay in shared memory for the whole
//   launch (74 KB at F = 128 "high"), the tail's come through L1 (4.6 KB a
//   k16 step), which leaves it room for 3 CTAs an SM;
// - the head's epilogue transposes within each quad of lanes so that every
//   store of x and of its planes is 16 contiguous bytes.
// What they reach on an H100 (chip_smoke.py phase 2, PERF.md §6): 47-61 %
// of the bytes bound for the head, 35-53 % for the tail. Neither more CTAs
// an SM for the tail nor an L2 prefetch of its window rows moved it; what is
// left is the wait between a step's window and its 24 to 216 products.
// A pixel's sums run in a fixed order (k16 step, tap, then hi*hi, lo*hi,
// hi*lo) whatever the tile, the batch or the grid, with no atomics, so a
// patch gives the same bits alone and inside any batch.

constexpr int kEdgeTile = 16;                     // a CTA's tile: 16 x 16 output pixels
constexpr int kEdgeWin = kEdgeTile + 2;           // its window: 18 x 18 pixels, halo 1
constexpr int kEdgeWinPix = kEdgeWin * kEdgeWin;  // 324
constexpr int kEdgeRows = 4;                      // output rows of a warp
constexpr int kEdgeStage = kEdgeWinPix * 64;      // a window of 16 f32 channels: 20,736 B
constexpr int kFragBytes = 32 * 8;                // one warp's B fragment of m16n8k16
constexpr int kHeadThreads = 256;                 // 4 row strips x 2 channel quarters
constexpr int kTailThreads = 128;                 // 4 row strips
constexpr int kTailStages = 3;
constexpr int kHeadMaxCin = 16, kTailMaxCout = 8;

struct HeadArgs {
  const float* in0;        // the net's inputs, [B][H][W][c] f32 of c0, c1 and c2
  const float* in1;        // channels (c2 = 0: no third input), element strides
  const float* in2;        // s[i] = (b, y, x, channel) of input i: any layout
  int c0, c1, c2;
  long long s[3][4];
  const uint32_t* frags;   // w as B fragments [9][F / 8][PLANES][32 lanes][2]
  const float* bias;       // [F]
  float* out;              // x [B][H][W][F]
  __nv_bfloat16* planes;   // x's planes [PLANES][B][H][W][F], or null
  int B, H, W;
};

struct TailArgs {
  const float* x;          // [B][H][W][F]
  const uint32_t* frags;   // w as B fragments [F / 16][9][PLANES][32 lanes][2]
  const float* bias;       // [cout]
  const float* resid;      // [B][H][W][cout], element strides rs (b, y, x, channel)
  float* out;              // [B][H][W][cout]
  long long rs[4];
  int B, H, W, cout;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b: one m16n8k16 product of bf16 fragments with f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of the 16-byte group `grp` (channels 4 grp .. 4 grp + 3) of
// window pixel `px` in a stage: 64 B a pixel, the pixel's two halves swapped
// where bit 1 of px is set, so that an A fragment's loads from any 4
// consecutive pixels fall in distinct banks.
__device__ __forceinline__ int edge_off(int px, int grp) {
  return px * 64 + ((grp ^ (px & 2)) << 4);
}

// The A fragment (rows: window pixels px0 .. px0 + 15, columns: the stage's
// 16 channels) split into its planes: hi = bf16(v), lo = bf16(v - hi).
template <int PASSES>
__device__ __forceinline__ void edge_a_frag(const unsigned char* stage, int px0, int lane,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a0: (row g, k 2t), a1: (row g + 8, k 2t), a2: (row g, k 2t + 8), a3: (row g + 8, k 2t + 8)
    const int px = px0 + g + 8 * (i & 1), grp = 2 * (i >> 1) + (t >> 1);
    const float2 v = *reinterpret_cast<const float2*>(stage + edge_off(px, grp) + 8 * (t & 1));
    hi[i] = bf16x2_bits(v.x, v.y);
    if (PASSES == 3) lo[i] = bf16x2_lo_bits(v.x, v.y, hi[i]);
  }
}

__device__ __forceinline__ void edge_tile(int tile, int H, int W, int& b, int& y0, int& x0) {
  const int tx = (W + kEdgeTile - 1) / kEdgeTile, ty = (H + kEdgeTile - 1) / kEdgeTile;
  x0 = (tile % tx) * kEdgeTile;
  tile /= tx;
  y0 = (tile % ty) * kEdgeTile;
  b = tile / ty;
}

// Copy `bytes` (a multiple of 16) of fragments into shared memory.
__device__ __forceinline__ void edge_copy(unsigned char* dst, const uint32_t* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
}

// The head's window of `tile` into the stage at `stage`: channel k of the
// inputs' concatenation at channel k, 4 B a copy (channels cin .. 15 stay
// zero).
__device__ __forceinline__ void head_fill(const HeadArgs& a, uint32_t stage, int tile) {
  int b, y0, x0;
  edge_tile(tile, a.H, a.W, b, y0, x0);
  const int cin = a.c0 + a.c1 + a.c2;
  for (int i = threadIdx.x; i < kEdgeWinPix * cin; i += blockDim.x) {
    const int px = i / cin, k = i - px * cin;
    const int y = y0 - 1 + px / kEdgeWin, x = x0 - 1 + px % kEdgeWin;
    const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
    const long long yy = in ? y : 0, xx = in ? x : 0;
    const float* src;
    if (k < a.c0)
      src = a.in0 + b * a.s[0][0] + yy * a.s[0][1] + xx * a.s[0][2] + k * a.s[0][3];
    else if (k < a.c0 + a.c1)
      src = a.in1 + b * a.s[1][0] + yy * a.s[1][1] + xx * a.s[1][2] + (k - a.c0) * a.s[1][3];
    else
      src = a.in2 + b * a.s[2][0] + yy * a.s[2][1] + xx * a.s[2][2] +
            (k - a.c0 - a.c1) * a.s[2][3];
    cp_async4(stage + edge_off(px, k >> 2) + 4 * (k & 3), src, in);
  }
}

// The tail's window of channels 16 kc .. 16 kc + 15 of `tile`, 16 B a copy.
template <int F>
__device__ __forceinline__ void tail_fill(const TailArgs& a, uint32_t stage, int tile, int kc) {
  int b, y0, x0;
  edge_tile(tile, a.H, a.W, b, y0, x0);
  for (int i = threadIdx.x; i < kEdgeWinPix * 4; i += blockDim.x) {
    const int px = i >> 2, grp = i & 3;
    const int y = y0 - 1 + px / kEdgeWin, x = x0 - 1 + px % kEdgeWin;
    const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
    const size_t pix = (static_cast<size_t>(b) * a.H + (in ? y : 0)) * a.W + (in ? x : 0);
    cp_async16(stage + edge_off(px, grp), a.x + pix * F + 16 * kc + 4 * grp, in);
  }
}

// The head's epilogue for one warp: x = relu(acc + b) for its 4 rows x 16
// pixels x channels 64 nq .. 64 nq + 63, stored with its planes.
template <int F, int PASSES>
__device__ __forceinline__ void head_epilogue(const HeadArgs& a, float (&acc)[kEdgeRows][8][4],
                                              int b, int y, int x0, int nq, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const size_t plane_elems = static_cast<size_t>(a.B) * a.H * a.W * F;
#pragma unroll
  for (int o = 0; o < kEdgeRows; ++o) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int yy = y + o, xx = x0 + g + 8 * hf;
      const bool in = yy < a.H && xx < a.W;
      const size_t pix = (static_cast<size_t>(b) * a.H + yy) * a.W + xx;
#pragma unroll
      for (int gg = 0; gg < 2; ++gg) {
        // Lane t holds columns 2t and 2t + 1 of the 8-column blocks 4 gg ..
        // 4 gg + 3; after the transposes, all 8 columns of block 4 gg + t.
        uint32_t u0[4], u1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          u0[j] = __float_as_uint(acc[o][4 * gg + j][2 * hf]);
          u1[j] = __float_as_uint(acc[o][4 * gg + j][2 * hf + 1]);
        }
        quad_transpose(u0, t);
        quad_transpose(u1, t);
        const int c = 64 * nq + 32 * gg + 8 * t;
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.bias + c));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.bias + c) + 1);
        const float bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float s = __fadd_rn(__uint_as_float((i & 1) ? u1[i >> 1] : u0[i >> 1]), bias[i]);
          v[i] = s < 0.f ? 0.f : s;
        }
        if (!in) continue;
        float4* dst = reinterpret_cast<float4*>(a.out + pix * F + c);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        if (a.planes == nullptr) continue;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[i] = bf16x2_bits(v[2 * i], v[2 * i + 1]);
          lo[i] = bf16x2_lo_bits(v[2 * i], v[2 * i + 1], hi[i]);
        }
        store16(a.planes + pix * F + c, hi);
        if (PASSES == 3) store16(a.planes + plane_elems + pix * F + c, lo);
      }
    }
  }
}

// One head tile: warp w takes rows 4 (w % 4) .. 4 (w % 4) + 3 and the
// channel quarters w / 4, w / 4 + 2, ... (F = 256: two in turn).
template <int F, int PASSES>
__device__ __forceinline__ void head_tile(const HeadArgs& a, const unsigned char* wsm,
                                          const unsigned char* stage, int tile, int warp,
                                          int lane) {
  constexpr int P = PASSES == 3 ? 2 : 1, NB = F / 8;
  int b, y0, x0;
  edge_tile(tile, a.H, a.W, b, y0, x0);
  const int strip = warp & 3;
  for (int nq = warp >> 2; nq < F / 64; nq += 2) {
    float acc[kEdgeRows][8][4];
#pragma unroll
    for (int o = 0; o < kEdgeRows; ++o)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][j][e] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned char* f = wsm + ((tap * NB + 8 * nq + j) * P) * kFragBytes + 8 * lane;
        const uint2 u = *reinterpret_cast<const uint2*>(f);
        bh[j][0] = u.x;
        bh[j][1] = u.y;
        if (PASSES == 3) {
          const uint2 v = *reinterpret_cast<const uint2*>(f + kFragBytes);
          bl[j][0] = v.x;
          bl[j][1] = v.y;
        }
      }
#pragma unroll
      for (int o = 0; o < kEdgeRows; ++o) {
        uint32_t ah[4], al[4];
        edge_a_frag<PASSES>(stage, (kEdgeRows * strip + o + dy) * kEdgeWin + dx, lane, ah, al);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[o][j], ah, bh[j]);
        if (PASSES == 3) {
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16(acc[o][j], al, bh[j]);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16(acc[o][j], ah, bl[j]);
        }
      }
    }
    head_epilogue<F, PASSES>(a, acc, b, y0 + kEdgeRows * strip, x0, nq, lane);
  }
}

// Shared memory: [weight fragments][2 window stages].
template <int F, int PASSES>
__host__ __device__ constexpr int head_smem() {
  return 9 * (F / 8) * (PASSES == 3 ? 2 : 1) * kFragBytes + 2 * kEdgeStage;
}

// Block i takes tiles i, i + gridDim.x, ...; the next tile's window loads
// while this one is computed.
template <int F, int PASSES>
__global__ void __launch_bounds__(kHeadThreads, 1) head_kernel(const HeadArgs a, int tiles) {
  constexpr int WBYTES = head_smem<F, PASSES>() - 2 * kEdgeStage;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = smem_raw + WBYTES;
  const uint32_t st0 = smem_u32(stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  edge_copy(smem_raw, a.frags, WBYTES);
  for (int i = threadIdx.x; i < 2 * kEdgeStage / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(stages)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int first = static_cast<int>(blockIdx.x), step = static_cast<int>(gridDim.x);
  const int mine = tiles > first ? (tiles - 1 - first) / step + 1 : 0;
  if (mine > 0) head_fill(a, st0, first);
  cp_async_commit();
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // window i is in; every warp is done with window i - 1
    if (i + 1 < mine) head_fill(a, st0 + ((i + 1) & 1) * kEdgeStage, first + (i + 1) * step);
    cp_async_commit();
    head_tile<F, PASSES>(a, smem_raw, stages + (i & 1) * kEdgeStage, first + i * step, warp,
                         lane);
  }
}

// One k16 step (channels 16 kc ..) of a tail tile for one warp's 4 rows: each
// A fragment of its 6 window rows x 3 column shifts feeds the rows it reaches.
// The step's weight fragments (4.6 KB at "high") come through L1.
template <int PASSES>
__device__ __forceinline__ void tail_step(const uint32_t* frags, const unsigned char* stage,
                                          int kc, int strip, int lane,
                                          float (&acc)[kEdgeRows][4]) {
  constexpr int P = PASSES == 3 ? 2 : 1;
  uint32_t bh[9][2], bl[9][2];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint2* f = reinterpret_cast<const uint2*>(frags) + ((kc * 9 + tap) * P) * 32 + lane;
    const uint2 u = __ldg(f);
    bh[tap][0] = u.x;
    bh[tap][1] = u.y;
    if (PASSES == 3) {
      const uint2 v = __ldg(f + 32);
      bl[tap][0] = v.x;
      bl[tap][1] = v.y;
    }
  }
#pragma unroll
  for (int wr = 0; wr < kEdgeRows + 2; ++wr) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t ah[4], al[4];
      edge_a_frag<PASSES>(stage, (kEdgeRows * strip + wr) * kEdgeWin + dx, lane, ah, al);
      // Output row o takes this fragment at tap (wr - o, dx), so its taps
      // come in order as wr rises.
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int o = wr - dy;
        if (o < 0 || o >= kEdgeRows) continue;
        mma_bf16(acc[o], ah, bh[3 * dy + dx]);
        if (PASSES == 3) {
          mma_bf16(acc[o], al, bh[3 * dy + dx]);
          mma_bf16(acc[o], ah, bl[3 * dy + dx]);
        }
      }
    }
  }
}

// out = (acc + b) + resid for the warp's 4 rows x 16 pixels, channels < cout.
__device__ __forceinline__ void tail_epilogue(const TailArgs& a, float (&acc)[kEdgeRows][4],
                                              int tile, int strip, int lane) {
  int b, y0, x0;
  edge_tile(tile, a.H, a.W, b, y0, x0);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int o = 0; o < kEdgeRows; ++o) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int y = y0 + kEdgeRows * strip + o, x = x0 + g + 8 * hf;
      if (y >= a.H || x >= a.W) continue;
      const size_t pix = (static_cast<size_t>(b) * a.H + y) * a.W + x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * t + e;
        if (c >= a.cout) continue;
        const float r = __ldg(a.resid + b * a.rs[0] + y * a.rs[1] + x * a.rs[2] + c * a.rs[3]);
        a.out[pix * a.cout + c] = __fadd_rn(__fadd_rn(acc[o][2 * hf + e], __ldg(a.bias + c)), r);
      }
    }
  }
}

// Shared memory: kTailStages window stages.
constexpr int kTailSmem = kTailStages * kEdgeStage;

// Block i takes tiles i, i + gridDim.x, ..., each as F / 16 k16 steps; the
// windows of the next two steps load while a step is computed, across tiles
// too.
template <int F, int PASSES>
__global__ void __launch_bounds__(kTailThreads, 3) tail_kernel(const TailArgs a, int tiles) {
  constexpr int KC = F / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = smem_raw;
  const uint32_t st0 = smem_u32(stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = static_cast<int>(blockIdx.x), step = static_cast<int>(gridDim.x);
  const int steps = (tiles > first ? (tiles - 1 - first) / step + 1 : 0) * KC;
  auto load_step = [&](int s) {
    if (s < steps)
      tail_fill<F>(a, st0 + (s % kTailStages) * kEdgeStage, first + (s / KC) * step, s % KC);
    cp_async_commit();
  };
  for (int s = 0; s < kTailStages - 1; ++s) load_step(s);
  float acc[kEdgeRows][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kTailStages - 2>();
    __syncthreads();  // step s's window is in; every warp is done with step s - 1's
    load_step(s + kTailStages - 1);
    const int kc = s % KC;
    if (kc == 0) {
#pragma unroll
      for (int o = 0; o < kEdgeRows; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
    }
    tail_step<PASSES>(a.frags, stages + (s % kTailStages) * kEdgeStage, kc, warp, lane, acc);
    if (kc == KC - 1) tail_epilogue(a, acc, first + (s / KC) * step, warp, lane);
  }
}

// Blocks of `kernel` (threads, dynamic shared memory) that fit on the current
// device at once, read once per device and instantiation into `cache`;
// returns 0, a cudaError_t, or -1 if none fits.
int edge_resident(const void* kernel, int threads, int smem, std::atomic<int>* cache, int* fit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  int n = cache[dev].load(std::memory_order_acquire);
  if (n == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    n = per_sm * sms;
    if (n <= 0) return -1;
    cache[dev].store(n, std::memory_order_release);
  }
  *fit = n;
  return 0;
}

template <int F, int PASSES>
int launch_head(const HeadArgs& a, long long tiles, cudaStream_t s) {
  static std::atomic<int> cache[64];
  constexpr int smem = head_smem<F, PASSES>();
  static_assert(smem <= kSmemMax, "head shared memory");
  auto kernel = head_kernel<F, PASSES>;
  int fit = 0;
  const int err =
      edge_resident(reinterpret_cast<const void*>(kernel), kHeadThreads, smem, cache, &fit);
  if (err != 0) return err;
  kernel<<<static_cast<int>(tiles < fit ? tiles : fit), kHeadThreads, smem, s>>>(
      a, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

template <int F, int PASSES>
int launch_tail(const TailArgs& a, long long tiles, cudaStream_t s) {
  static std::atomic<int> cache[64];
  constexpr int smem = kTailSmem;
  auto kernel = tail_kernel<F, PASSES>;
  int fit = 0;
  const int err =
      edge_resident(reinterpret_cast<const void*>(kernel), kTailThreads, smem, cache, &fit);
  if (err != 0) return err;
  kernel<<<static_cast<int>(tiles < fit ? tiles : fit), kTailThreads, smem, s>>>(
      a, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

// The 16 x 16 tiles of [B, H, W], or -1 beyond what the kernels index.
long long edge_tiles(int B, int H, int W, int F) {
  const long long tiles = static_cast<long long>(B) * ((H + kEdgeTile - 1) / kEdgeTile) *
                          ((W + kEdgeTile - 1) / kEdgeTile);
  return tiles * (F / 16) > (1LL << 30) ? -1 : tiles;
}

template <int PASSES>
int head_f(const HeadArgs& a, int F, long long tiles, cudaStream_t s) {
  switch (F) {
    case 128: return launch_head<128, PASSES>(a, tiles, s);
    case 256: return launch_head<256, PASSES>(a, tiles, s);
    default: return -1;
  }
}

template <int PASSES>
int tail_f(const TailArgs& a, int F, long long tiles, cudaStream_t s) {
  switch (F) {
    case 128: return launch_tail<128, PASSES>(a, tiles, s);
    case 256: return launch_tail<256, PASSES>(a, tiles, s);
    default: return -1;
  }
}

}  // namespace

// C interface, bound with ctypes. Each returns 0, a cudaError_t from the
// launch, -1 for arguments the kernels do not take, or -2 if the driver
// cannot encode the window loads' tensor map.

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

// The class conv's f32 planes of f32 v[n] (plane_kernel): hi[n] and, for
// passes == 3, lo[n] (null for passes == 1). Any n and alignment.
extern "C" int dsen2_class_planes(const void* v, void* hi, void* lo, long long n, int passes,
                                  void* stream) {
  if (n < 0 || !(passes == 1 || (passes == 3 && lo != nullptr))) return -1;
  if (n == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(hi) |
                     reinterpret_cast<uintptr_t>(lo)) & 15) == 0;
  const int threads = 256;
  const long long want = ((vec ? (n + 3) / 4 : n) + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vv = static_cast<const float*>(v);
  float* hv = static_cast<float*>(hi);
  float* lv = static_cast<float*>(lo);
  if (passes == 1 && vec) plane_kernel<1, true><<<blocks, threads, 0, s>>>(vv, hv, lv, n);
  else if (passes == 1) plane_kernel<1, false><<<blocks, threads, 0, s>>>(vv, hv, lv, n);
  else if (vec) plane_kernel<3, true><<<blocks, threads, 0, s>>>(vv, hv, lv, n);
  else plane_kernel<3, false><<<blocks, threads, 0, s>>>(vv, hv, lv, n);
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
  // 16-byte vector accesses and the tensor map need 16-byte aligned tensors.
  const void* tensors[] = {src, w, bias, resid, out, planes};
  for (const void* p : tensors)
    if (reinterpret_cast<uintptr_t>(p) % 16) return -1;
  if (epilogue == EPI_RELU && planes == nullptr) return -1;
  if (epilogue == EPI_RESIDUAL && (resid == nullptr || out == nullptr)) return -1;
  if (epilogue != EPI_RELU && epilogue != EPI_RESIDUAL) return -1;
  a.pool = nullptr;
  return dispatch_c(&a, C, passes, dtype, epilogue, static_cast<cudaStream_t>(stream), nullptr);
}

// One 3x3 SAME conv of f32 activations' planes `src` with the pooling
// epilogue (C = 64): out = conv + bias (f32), and each warp's per-channel
// sum of out over its pixels of each tile into pool, [B][rows][C] with
// rows = ceil(H / 16) * ceil(W / 16) * 8 per image.
extern "C" int dsen2_conv3x3_pool(const void* src, const void* w, const float* bias, void* out,
                                  void* pool, int B, int H, int W, int C, int passes,
                                  void* stream) {
  ConvArgs a = {};
  a.src = static_cast<const __nv_bfloat16*>(src);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.out = out;
  a.pool = static_cast<float*>(pool);
  a.B = B;
  a.H = H;
  a.W = W;
  a.scale = 1.f;
  if (B <= 0 || H <= 0 || W <= 0) return -1;
  const void* tensors[] = {src, w, bias, out, pool};
  for (const void* p : tensors)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return -1;
  return dispatch_c(&a, C, passes, 0, EPI_POOL, static_cast<cudaStream_t>(stream), nullptr);
}

// RCAN's channel gate after dsen2_conv3x3_pool (ca_gate_kernel): out = x +
// s * y and out's bf16 planes, s from pool's sums of y; f32 throughout.
// C a multiple of 4 dividing 512, at most 256; R at most 64 and C.
extern "C" int dsen2_ca_gate(const void* x, const void* y, const void* pool, const void* wd,
                             const void* bd, const void* wu, const void* bu, void* out,
                             void* planes, int B, int H, int W, int C, int R, int passes,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kGateMaxC || C % 4 || kGateThreads % C ||
      R <= 0 || R > kGateMaxR || R > C || (passes != 1 && passes != 3))
    return -1;
  const void* tensors[] = {x, y, pool, out, planes};
  for (const void* p : tensors)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return -1;
  if (wd == nullptr || bd == nullptr || wu == nullptr || bu == nullptr) return -1;
  GateArgs g;
  g.x = static_cast<const float*>(x);
  g.y = static_cast<const float*>(y);
  g.pool = static_cast<const float*>(pool);
  g.wd = static_cast<const float*>(wd);
  g.bd = static_cast<const float*>(bd);
  g.wu = static_cast<const float*>(wu);
  g.bu = static_cast<const float*>(bu);
  g.out = static_cast<float*>(out);
  g.planes = static_cast<__nv_bfloat16*>(planes);
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.R = R;
  g.rows = ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile) * kCluster * 4;
  // Blocks per image: about 128 float4 steps a thread.
  const long long n4 = static_cast<long long>(H) * W * C / 4;
  const long long per = (n4 + 128LL * kGateThreads - 1) / (128LL * kGateThreads);
  if (B > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(per), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 1) ca_gate_kernel<1><<<grid, kGateThreads, 0, s>>>(g);
  else ca_gate_kernel<3><<<grid, kGateThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// The clusters of two CTAs that the conv of these arguments launches at
// most (fewer when the image has fewer 16 x 16 x 128 tiles), or -1 / a
// cudaError_t. Reads nothing back from the device.
extern "C" int dsen2_conv3x3_clusters(int C, int passes, int dtype, int epilogue) {
  int clusters = 0;
  const int err = dispatch_c(nullptr, C, passes, dtype, epilogue, nullptr, &clusters);
  return err != 0 ? (err > 0 ? -err : err) : clusters;
}

// DSen2's head (head_kernel): out = relu(conv(concat(in0, in1, in2), w) +
// bias), f32 [B][H][W][F], and, unless planes is null, out's bf16 planes
// [passes == 3 ? 2 : 1][B][H][W][F]. Inputs f32 [B][H][W][c] of c0 > 0,
// c1 >= 0 and c2 >= 0 channels, at most 16 together, in any layout:
// strides[4 i .. 4 i + 3] are input i's element strides (b, y, x, channel);
// frags from pack_fragments (ops/head_tail.py); F = 128 or 256.
extern "C" int dsen2_head(const void* in0, const void* in1, const void* in2, int c0, int c1,
                          int c2, const long long* strides, const void* frags, const void* bias,
                          void* out, void* planes, int B, int H, int W, int F, int passes,
                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || c0 <= 0 || c1 < 0 || c2 < 0 ||
      c0 + c1 + c2 > kHeadMaxCin)
    return -1;
  if (in0 == nullptr || (c1 > 0 && in1 == nullptr) || (c2 > 0 && in2 == nullptr) ||
      strides == nullptr || frags == nullptr || bias == nullptr || out == nullptr)
    return -1;
  const void* inputs[] = {in0, in1, in2};
  for (const void* p : inputs)
    if (reinterpret_cast<uintptr_t>(p) % 4) return -1;
  const void* vectors[] = {frags, bias, out, planes};
  for (const void* p : vectors)
    if (reinterpret_cast<uintptr_t>(p) % 16) return -1;
  HeadArgs a;
  a.in0 = static_cast<const float*>(in0);
  a.in1 = static_cast<const float*>(in1);
  a.in2 = static_cast<const float*>(in2);
  a.c0 = c0;
  a.c1 = c1;
  a.c2 = c2;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j) a.s[i][j] = strides[4 * i + j];
  a.frags = static_cast<const uint32_t*>(frags);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.planes = static_cast<__nv_bfloat16*>(planes);
  a.B = B;
  a.H = H;
  a.W = W;
  const long long tiles = edge_tiles(B, H, W, 16);
  if (tiles <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 1) return head_f<1>(a, F, tiles, s);
  if (passes == 3) return head_f<3>(a, F, tiles, s);
  return -1;
}

// DSen2's tail (tail_kernel): out = (conv(x, w) + bias) + resid, f32
// [B][H][W][cout], for contiguous f32 x [B][H][W][F] (F = 128 or 256),
// resid f32 [B][H][W][cout] in any layout (element strides rstrides: b, y,
// x, channel) and 1 <= cout <= 8; frags from pack_fragments.
extern "C" int dsen2_tail(const void* x, const void* frags, const void* bias, const void* resid,
                          const long long* rstrides, void* out, int B, int H, int W, int F,
                          int cout, int passes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cout <= 0 || cout > kTailMaxCout) return -1;
  if (x == nullptr || frags == nullptr || bias == nullptr || resid == nullptr ||
      rstrides == nullptr || out == nullptr)
    return -1;
  const void* vectors[] = {x, frags};
  for (const void* p : vectors)
    if (reinterpret_cast<uintptr_t>(p) % 16) return -1;
  const void* scalars[] = {bias, resid, out};
  for (const void* p : scalars)
    if (reinterpret_cast<uintptr_t>(p) % 4) return -1;
  TailArgs a;
  a.x = static_cast<const float*>(x);
  a.frags = static_cast<const uint32_t*>(frags);
  a.bias = static_cast<const float*>(bias);
  a.resid = static_cast<const float*>(resid);
  a.out = static_cast<float*>(out);
  for (int j = 0; j < 4; ++j) a.rs[j] = rstrides[j];
  a.B = B;
  a.H = H;
  a.W = W;
  a.cout = cout;
  const long long tiles = edge_tiles(B, H, W, F);
  if (tiles <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 1) return tail_f<1>(a, F, tiles, s);
  if (passes == 3) return tail_f<3>(a, F, tiles, s);
  return -1;
}
