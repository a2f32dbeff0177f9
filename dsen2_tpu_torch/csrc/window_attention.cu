// HAT's window attention on Hopper (sm_90a), written by hand: per 16 x 16
// window of queries and per head,
//
//     o = softmax((q / sqrt(d)) k^T + T[rpi] + mask) v
//
// for the two geometries of models/hat.py (ops/window_attention.py has the
// plain version and the index arithmetic):
//   self-attention (KSIDE = 16): 256 keys, the window's own pixels; a shift
//     s rolls the image by -s before the windows are cut and the output back
//     by +s, which here is index arithmetic only: the query and key at rolled
//     (r, c) are read from, and the output written to, pixel ((r + s) mod H,
//     (c + s) mod W). With s > 0 the windows of the last window row or column
//     add the mask (-100 between pixels of different row or column bands).
//   overlapping cross-attention (KSIDE = 24): 576 keys, the 24 x 24 block
//     around the window, zero vectors outside the image (they stay in the
//     softmax), no shift.
// q, k and v are read straight from the qkv tensor [B, H, W, 3C] f32 by
// window coordinates; the output is [B, H, W, C] f32. The head size d (30 in
// HAT) is padded to 32 with zeros, which change no product.
//
// Replaces no TPU kernel: the JAX package has no attention. In plain PyTorch
// one HAB's scores at a batch of 64 patches of 128 x 128 are 64 x 64 windows
// x 6 heads x 256^2 x 4 B = 6.4 GB, written and read twice by the softmax;
// here they never leave the SM.
//
// Accuracy class, as every kernel of the port: PASSES = 3 is bf16x3 (q, k,
// the probabilities p and v each split into hi = bf16(v), lo = bf16(v - hi);
// s = qh.kh + ql.kh + qh.kl and o = ph.vh + pl.vh + ph.vl), PASSES = 1 one
// bf16 pass; every sum in f32, the softmax in f32 (exp2 of scores kept in
// log2 units, HAT's bias and mask scaled by log2 e).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4 N_k d FLOP a query
// a head (q k^T and p v), times PASSES, against q, k, v read once and o
// written once. At [64, 128, 128, 180], 6 heads, "high": self-attention
// 0.58 ms of operations beside 0.90 ms of bytes (f32), overlapping 1.32 ms
// of operations. The kernel does more than the products: an exp2, a bias
// gather and the split of p for every score, at 16 exp2 per SM per clock
// about as many scores a second as the tensor cores take at bf16x3 with d =
// 32, so the score-wise work, and not the products, bounds it first.
//
// Schedule: one CTA per (image, window, head), heads fastest in the grid, so
// the six heads of a window (and then its neighbours, whose overlapping
// blocks share rows) read the same qkv lines while L2 holds them. 256
// threads: 8 warps, each owning two m16 tiles of queries (two window rows),
// with mma.sync m16n8k16 (the products are small: d = 32 is two k16 steps,
// and wgmma's 64-row tiles buy nothing at this size). The CTA first writes
// its window's k and v as bf16 planes into shared memory (rows of 64 B, the
// four 16-byte chunks of a row XOR-swizzled by bits 1-2 of the row, so that
// ldmatrix reads 8 rows without bank conflicts) and the head's bias table
// (x log2 e). Each warp keeps its queries' planes in registers and walks
// the keys in blocks of 64 with the online softmax of FlashAttention: s for
// 64 keys (ldmatrix of k), bias and mask, the running max and sum, then p as
// the A operand of the p v products straight from s's accumulator layout,
// and v by ldmatrix.trans. Shared memory: 2 x planes x N_k x 64 B + the
// table: 65,536 + 3,844 B (self, "high"), 147,456 + 6,084 B (overlapping,
// "high"), half the planes at "default". ptxas spills nothing
// (chip_smoke.py phase 1 checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWindow = 16;              // M: queries are M x M
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHead = 32;                // the head size, padded
constexpr int kRow = kHead * 2;          // bytes of one key row of one bf16 plane
constexpr int kBlock = 64;               // keys per step of the online softmax
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -100.0f;         // HAT's mask value

struct AttnArgs {
  const float* qkv;    // [B, H, W, 3C]
  const float* table;  // [entries, heads]
  float* out;          // [B, H, W, C]
  int h, w, c, heads, d, shift;
  float scale;         // d^-1/2
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 planes: hi = bf16(v), lo = bf16(v - hi) (PASSES = 3 only).
template <int PASSES>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  if (PASSES == 3) {
    const float2 hf = __bfloat1622float2(h);
    lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk `chunk` (0..3) of key row `row` in a plane.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kRow + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// The mask's band of rolled row (or column) r of an n-pixel axis.
__device__ __forceinline__ int band(int r, int n, int shift) {
  return r < n - kWindow ? 0 : (r < n - shift ? 1 : 2);
}

template <int PASSES, int KSIDE>
__global__ void __launch_bounds__(kThreads, 1) window_attention_kernel(const AttnArgs a) {
  constexpr int kKeys = KSIDE * KSIDE;
  constexpr bool kOverlap = KSIDE != kWindow;
  constexpr int kPlanes = PASSES == 3 ? 2 : 1;
  constexpr int kPlane = kKeys * kRow;                                  // bytes
  constexpr int kTable = kOverlap ? kWindow + KSIDE - 1 : 2 * kWindow - 1;
  constexpr int kPad = (KSIDE - kWindow) / 2;
  static_assert(kKeys % kBlock == 0 && KSIDE % 8 == 0, "key blocks of whole n8 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kp = smem;                            // k planes: hi[, lo]
  unsigned char* vp = smem + kPlanes * kPlane;         // v planes: hi[, lo]
  float* tab = reinterpret_cast<float*>(smem + 2 * kPlanes * kPlane);

  const int nwx = a.w / kWindow, nwy = a.h / kWindow;
  const int head = blockIdx.x % a.heads;
  const int win = (blockIdx.x / a.heads) % (nwx * nwy);
  const int img = blockIdx.x / a.heads / (nwx * nwy);
  const int wy = win / nwx, wx = win % nwx;
  const int y0 = wy * kWindow, x0 = wx * kWindow;
  const int shift = kOverlap ? 0 : a.shift;
  const int c3 = 3 * a.c;
  const float* src = a.qkv + (size_t)img * a.h * a.w * c3 + head * a.d;
  const int tid = threadIdx.x;

  // k and v of every key -> bf16 planes; 16 threads a key, two channels each.
  for (int i = tid; i < kKeys * (kHead / 2); i += kThreads) {
    const int key = i >> 4, pr = i & 15;
    int y = y0 + key / KSIDE - kPad, x = x0 + key % KSIDE - kPad;
    bool inside = true;
    if (kOverlap) {
      inside = y >= 0 && y < a.h && x >= 0 && x < a.w;
    } else {
      y = (y + shift) % a.h;
      x = (x + shift) % a.w;
    }
    float2 k = make_float2(0.f, 0.f), v = k;
    if (inside && 2 * pr < a.d) {
      const float* p = src + ((size_t)y * a.w + x) * c3 + 2 * pr;
      k = *reinterpret_cast<const float2*>(p + a.c);
      v = *reinterpret_cast<const float2*>(p + 2 * a.c);
    }
    uint32_t kh, kl = 0, vh, vl = 0;
    split2<PASSES>(k.x, k.y, kh, kl);
    split2<PASSES>(v.x, v.y, vh, vl);
    const uint32_t off = swz(key, pr >> 2) + (pr & 3) * 4;
    *reinterpret_cast<uint32_t*>(kp + off) = kh;
    *reinterpret_cast<uint32_t*>(vp + off) = vh;
    if (PASSES == 3) {
      *reinterpret_cast<uint32_t*>(kp + kPlane + off) = kl;
      *reinterpret_cast<uint32_t*>(vp + kPlane + off) = vl;
    }
  }
  for (int i = tid; i < kTable * kTable; i += kThreads) {
    tab[i] = a.table[i * a.heads + head] * kLog2e;
  }

  // This warp's queries: window rows 2 warp + mt (mt = 0, 1), one m16 tile
  // each; a thread holds rows g and g + 8 (columns of the window).
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  uint32_t qh[2][2][4], ql[2][2][4];  // [m tile][k step][A register]
  int qlab[2][2];                     // the mask's label of each row
  const bool masked = !kOverlap && shift > 0 && (wy == nwy - 1 || wx == nwx - 1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ry = y0 + 2 * warp + mt, rx = x0 + g + 8 * half;  // rolled
      qlab[mt][half] = band(ry, a.h, shift) * 3 + band(rx, a.w, shift);
      const float* p = src + ((size_t)((ry + shift) % a.h) * a.w + (rx + shift) % a.w) * c3;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int dim = 16 * ks + 2 * t + 8 * hc;
          float2 q = make_float2(0.f, 0.f);
          if (dim < a.d) q = *reinterpret_cast<const float2*>(p + dim);
          split2<PASSES>(q.x * a.scale, q.y * a.scale, qh[mt][ks][half + 2 * hc],
                         ql[mt][ks][half + 2 * hc]);
        }
      }
    }
  }
  __syncthreads();

  float o[2][4][4];
  float mx[2][2], sum[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[mt][half] = -INFINITY;
      sum[mt][half] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;
    }
  }
  const uint32_t kbase = static_cast<uint32_t>(__cvta_generic_to_shared(kp));
  const uint32_t vbase = static_cast<uint32_t>(__cvta_generic_to_shared(vp));

#pragma unroll 1
  for (int kb = 0; kb < kKeys; kb += kBlock) {
    // s = q k^T for 64 keys: eight n8 tiles.
    float s[2][8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
      }
      const uint32_t addr = kbase + swz(kb + nt * 8 + (lane & 7), lane >> 3);
      uint32_t kh[4], kl[4];
      ldsm4(kh, addr);
      if (PASSES == 3) ldsm4(kl, addr + kPlane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          mma(s[mt][nt], qh[mt][ks], kh[2 * ks], kh[2 * ks + 1]);
          if (PASSES == 3) {
            mma(s[mt][nt], ql[mt][ks], kh[2 * ks], kh[2 * ks + 1]);
            mma(s[mt][nt], qh[mt][ks], kl[2 * ks], kl[2 * ks + 1]);
          }
        }
      }
    }
    // Bias and mask (log2 units), then the online softmax.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int qy = 2 * warp + mt;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key0 = kb + nt * 8;
        const int ky = key0 / KSIDE, kx0 = key0 % KSIDE + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qx = g + 8 * (e >> 1), kx = kx0 + (e & 1);
          const int idx = kOverlap ? (ky - qy + kWindow - 1) * kTable + (kx - qx + kWindow - 1)
                                   : (qy - ky + kWindow - 1) * kTable + (qx - kx + kWindow - 1);
          float v = fmaf(s[mt][nt][e], kLog2e, tab[idx]);
          if (masked) {
            const int klab = band(y0 + ky, a.h, shift) * 3 + band(x0 + kx, a.w, shift);
            if (klab != qlab[mt][e >> 1]) v += kMask * kLog2e;
          }
          s[mt][nt][e] = v;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = mx[mt][half];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          m = fmaxf(m, fmaxf(s[mt][nt][2 * half], s[mt][nt][2 * half + 1]));
        }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float alpha = ex2(mx[mt][half] - m);
        mx[mt][half] = m;
        float l = sum[mt][half] * alpha;
#pragma unroll
        for (int dt = 0; dt < 4; ++dt) {
          o[mt][dt][2 * half] *= alpha;
          o[mt][dt][2 * half + 1] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 2 * half; e < 2 * half + 2; ++e) {
            const float p = ex2(s[mt][nt][e] - m);
            l += p;
            s[mt][nt][e] = p;
          }
        }
        sum[mt][half] = l;
      }
    }
    // o += p v, sixteen keys a k step: p's A operand is s's accumulator
    // layout of two n8 tiles; v's B operand comes by ldmatrix.trans.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split2<PASSES>(s[mt][2 * j][0], s[mt][2 * j][1], ph[mt][0], pl[mt][0]);
        split2<PASSES>(s[mt][2 * j][2], s[mt][2 * j][3], ph[mt][1], pl[mt][1]);
        split2<PASSES>(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1], ph[mt][2], pl[mt][2]);
        split2<PASSES>(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3], ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        const int key = kb + 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
        const uint32_t addr = vbase + swz(key, 2 * dp + (lane >> 4));
        uint32_t vh[4], vl[4];
        ldsm4_trans(vh, addr);
        if (PASSES == 3) ldsm4_trans(vl, addr + kPlane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(o[mt][2 * dp], ph[mt], vh[0], vh[1]);
          mma(o[mt][2 * dp + 1], ph[mt], vh[2], vh[3]);
          if (PASSES == 3) {
            mma(o[mt][2 * dp], pl[mt], vh[0], vh[1]);
            mma(o[mt][2 * dp + 1], pl[mt], vh[2], vh[3]);
            mma(o[mt][2 * dp], ph[mt], vl[0], vl[1]);
            mma(o[mt][2 * dp + 1], ph[mt], vl[2], vl[3]);
          }
        }
      }
    }
  }

  // o / sum, written where the queries were read.
  float* dst = a.out + (size_t)img * a.h * a.w * a.c + head * a.d;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = sum[mt][half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int y = (y0 + 2 * warp + mt + shift) % a.h, x = (x0 + g + 8 * half + shift) % a.w;
      float* p = dst + ((size_t)y * a.w + x) * a.c;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        const int dim = 8 * dt + 2 * t;
        if (dim < a.d) {
          *reinterpret_cast<float2*>(p + dim) =
              make_float2(o[mt][dt][2 * half] * inv, o[mt][dt][2 * half + 1] * inv);
        }
      }
    }
  }
}

template <int PASSES, int KSIDE>
int launch(const AttnArgs& a, int b, cudaStream_t stream) {
  constexpr int kTable = KSIDE == kWindow ? 2 * kWindow - 1 : kWindow + KSIDE - 1;
  constexpr int kSmem = 2 * (PASSES == 3 ? 2 : 1) * KSIDE * KSIDE * kRow + kTable * kTable * 4;
  auto kernel = window_attention_kernel<PASSES, KSIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (long long)b * (a.h / kWindow) * (a.w / kWindow) * a.heads;
  if (ctas <= 0 || ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ctas), kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, H, W, C] = window attention of qkv [B, H, W, 3C] with the bias
// table [entries, heads]; window 16, overlap 0 (self-attention, shift in
// [0, 16)) or 24 (overlapping, shift 0); passes 3 (bf16x3) or 1. Returns 0,
// a CUDA error, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int dsen2_window_attention(const void* qkv, const void* table, void* out, int b,
                                      int h, int w, int c, int heads, int window, int overlap,
                                      int shift, int passes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (window != kWindow || (overlap != 0 && overlap != 24) || heads <= 0 || c % heads) return bad;
  const int d = c / heads;
  if (d > kHead || d % 2 || b <= 0 || h <= 0 || w <= 0 || h % kWindow || w % kWindow) return bad;
  if (shift < 0 || shift >= kWindow || (overlap && shift) || (passes != 1 && passes != 3)) {
    return bad;
  }
  AttnArgs a{static_cast<const float*>(qkv), static_cast<const float*>(table),
             static_cast<float*>(out), h, w, c, heads, d, shift,
             static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) return passes == 3 ? launch<3, 24>(a, b, s) : launch<1, 24>(a, b, s);
  return passes == 3 ? launch<3, 16>(a, b, s) : launch<1, 16>(a, b, s);
}
