// Fused eval-mode UpBlock for Hopper: nearest 2x upsample -> conv3x3 ->
// folded BatchNorm -> GLU, in one pass (K2, which also serves K3).
//
// Replaces the TPU kernels attngan_tpu/ops/pallas_upblock.py::
// _upblock_kernel (called through _upblock_call) and
// attngan_tpu/ops/pallas_upblock_packed.py::_kernel. The latter computes
// the same function at exactly Ci=64 -> Co=32, with column pairs packed
// into the TPU's 128-wide lanes. That packing has no meaning on Hopper,
// whose form for exactly those dims is upblock_resident_kernel below, so
// K3 (ops/cuda_upblock_packed.py) launches it in bf16, and the CUDA-core
// upblock_kernel in fp32: no kernel of its own.
//
// Math (the exact parity decomposition of attngan_tpu/ops/layers.py::
// upsample_conv3x3_fused): output pixel (2i+py, 2j+px) of the 3x3 conv over
// the nearest-upsampled input reads only the 2x2 source neighbourhood
// xpad[i+py+a][j+px+b], a,b in {0,1}, with weights that are pairwise sums of
// the 3x3 taps. The caller passes those parity weights precomputed,
// wp (4 parities, 4 taps * Ci, 2*Co), summed in fp32 and cast to x's type.
// Each parity is then a product with K = 4*Ci and N = 2*Co; the folded BN
// (y * scale + bias, fp32) and the GLU (y[:Co] * sigmoid(y[Co:])) run on the
// accumulators before the one store.
//
// What bounds it on the H100: operations. One output pixel costs 4*Ci*2*Co
// multiply-adds against 2*Co/4 input and Co output values: at Ci=64, Co=32
// in bf16 ~2000 flops per byte moved, far above the ~295 where the tensor
// cores become the limit. So bf16, the serving type, runs its products on
// the tensor cores: at the serving dims (Ci=64 -> Co=32) in the Hopper form
// below (upblock_resident_kernel: persistent blocks with resident weights,
// a cp.async input ring and wgmma), at other dims warp-level 16x16x16 mma
// through nvcuda::wmma (upblock_mma_kernel), fp32 accumulators in both;
// fp32 keeps exact fp32 FMAs on the CUDA cores (the tensor cores would
// round it to TF32). All keep the property the TPU kernel exists for: the
// input is read from memory once (a tile plus its one-pixel halo, staged
// in shared memory) and only the GLU output is written: the 4x upsampled
// tensor and the 2*Co pre-GLU tensor never reach memory.
//
// Layout: x (B, H, W, Ci) and out (B, 2H, 2W, Co) are NHWC, the
// channels_last view of the port's NCHW tensors.

#include <math.h>
#include <stdint.h>

#include "common.cuh"  // cuda_bf16.h first: mma.h then has the bf16 fragments

#include <mma.h>

namespace attngan {
namespace {

constexpr int kRows = 8;     // source rows of a block's tile
constexpr int kCols = 16;    // source columns of a block's tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory layout of the (kRows+2) x (kCols+2) x Ci input tile, fp32.
// A warp's 32 lanes read 8 rows x 4 column groups (4 pixels apart) at one
// channel: with the pixel stride = 2 (mod 8) and the row stride = 1 (mod 32)
// those 32 addresses fall in 32 different banks.
struct TileLayout {
  int cis;  // floats between neighbouring pixels of a row
  int rs;   // floats between neighbouring rows
  __host__ __device__ explicit TileLayout(int ci) {
    cis = ci + ((2 - ci % 8) + 8) % 8;
    rs = (kCols + 2) * cis;
    rs += ((1 - rs % 32) + 32) % 32;
  }
  __host__ __device__ size_t floats() const { return (size_t)(kRows + 2) * rs; }
};

// Zero-padded input tile: source rows r0-1 .. r0+kRows, cols c0-1 .. c0+kCols.
// Consecutive threads take consecutive channels: coalesced reads.
__device__ void load_tile(const float* __restrict__ x, float* xs, TileLayout t,
                          int b, int r0, int c0, int H, int W, int Ci) {
  const int n = (kRows + 2) * (kCols + 2) * Ci;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ci = i % Ci, pix = i / Ci;
    const int tr = pix / (kCols + 2), tc = pix % (kCols + 2);
    const int gr = r0 - 1 + tr, gc = c0 - 1 + tc;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = x[(((size_t)b * H + gr) * W + gc) * Ci + ci];
    xs[tr * t.rs + tc * t.cis + ci] = v;
  }
}

// Folded BN + GLU on one thread's 4 pixels x 4 channel pairs, then the store
// of the 4 channels of each output pixel (2*(r0+tr)+py, 2*(c0+tc0+q)+px).
__device__ __forceinline__ void epilogue(const float acc[4][8],
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out, int b, int sr,
                                         int sc0, int py, int px, int cn,
                                         int H, int W, int Co) {
  if (sr >= H) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int sc = sc0 + q;
    if (sc >= W) break;
    float v[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = cn + n;
      const float a = acc[q][n] * scale[c] + bias[c];
      const float g = acc[q][4 + n] * scale[Co + c] + bias[Co + c];
      v[n] = a * (1.f / (1.f + expf(-g)));
    }
    const size_t o =
        (((size_t)b * 2 * H + 2 * sr + py) * 2 * W + 2 * sc + px) * Co + cn;
    store4(out + o, v);
  }
}

// K2, fp32: any Ci, Co % 4 == 0. Weights are read from global memory (the
// same address across a warp: one broadcast load through L1).
__global__ void __launch_bounds__(kThreads)
upblock_kernel(const float* __restrict__ x, const float* __restrict__ wp,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ out, int H, int W, int Ci, int Co) {
  extern __shared__ float xs[];
  const TileLayout t(Ci);
  const int b = blockIdx.z, r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  load_tile(x, xs, t, b, r0, c0, H, W, Ci);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tr = lane >> 2, tc0 = (lane & 3) * 4;  // 4 source pixels in a row
  const int two_co = 2 * Co;
  for (int p = 0; p < 4; ++p) {
    const int py = p >> 1, px = p & 1;
    for (int cn = warp * 4; cn < Co; cn += kWarps * 4) {  // 4 channel pairs
      float acc[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[q][n] = 0.f;
      for (int tap = 0; tap < 4; ++tap) {
        const int a = tap >> 1, bt = tap & 1;
        const float* xr = xs + (tr + py + a) * t.rs + (tc0 + px + bt) * t.cis;
        const float* wk = wp + (size_t)(p * 4 + tap) * Ci * two_co + cn;
#pragma unroll 4
        for (int ci = 0; ci < Ci; ++ci) {
          float xv[4], wa[4], wg[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xr[q * t.cis + ci];
          load4(wk + (size_t)ci * two_co, wa);
          load4(wk + (size_t)ci * two_co + Co, wg);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              acc[q][n] += xv[q] * wa[n];
              acc[q][4 + n] += xv[q] * wg[n];
            }
        }
      }
      epilogue(acc, scale, bias, out, b, r0 + tr, c0 + tc0, py, px, cn, H, W,
               Co);
    }
  }
}

// ---- bf16 on the tensor cores (warp-level mma through nvcuda::wmma) -------
//
// The same tile and the same parity decomposition; the products run as
// 16x16x16 bf16 mma with fp32 accumulators. Warp w owns tile row w: the 16
// source pixels of that row are the M=16 rows of its A fragments, read
// straight from the bf16 input tile in shared memory (pixel stride Ci+16:
// 32-byte aligned as wmma requires, and rows 32 bytes apart in the banks).
// Each warp stores its fp32 accumulators to its own staging block, and its
// lanes apply the folded BN and the GLU from there (the accumulator layout
// of wmma is opaque, so the epilogue cannot pair y[c] with y[Co+c] in
// registers).

struct MmaLayout {
  int cis;  // bf16 elements between neighbouring pixels of a tile row
  int rs;   // between neighbouring tile rows
  int sld;  // floats between staged accumulator rows (16 pixels x 2*Co)
  __host__ __device__ MmaLayout(int ci, int co)
      : cis(ci + 16), rs((kCols + 2) * (ci + 16)), sld(2 * co + 4) {}
  __host__ __device__ size_t tile_bytes() const {
    return (size_t)(kRows + 2) * rs * sizeof(__nv_bfloat16);
  }
  __host__ __device__ size_t staging_bytes() const {
    return (size_t)kWarps * 16 * sld * sizeof(float);
  }
};

using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

// The zero-padded bf16 input tile, 16 bytes (8 channels) per copy.
__device__ void load_tile_bf16(const __nv_bfloat16* __restrict__ x,
                               __nv_bfloat16* xs, MmaLayout t, int b, int r0,
                               int c0, int H, int W, int Ci) {
  const int chunks = Ci / 8;
  const int n = (kRows + 2) * (kCols + 2) * chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = i % chunks, pix = i / chunks;
    const int tr = pix / (kCols + 2), tc = pix % (kCols + 2);
    const int gr = r0 - 1 + tr, gc = c0 - 1 + tc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + gr) * W + gc) * Ci + 8 * k);
    *reinterpret_cast<uint4*>(xs + tr * t.rs + tc * t.cis + 8 * k) = v;
  }
}

// One parity for one warp: its 16 pixels x all 2*Co outputs, K = 4*Ci,
// accumulated in fp32 and staged row-major in st[16][t.sld]. w is this
// parity's (4*Ci, 2*Co) weights with row stride wld (global or shared).
__device__ __forceinline__ void mma_parity(const __nv_bfloat16* xs, MmaLayout t,
                           const __nv_bfloat16* w, int wld, int Ci, int Co,
                           int row, int py, int px, float* st) {
  const int n_tiles = 2 * Co / 16;
  for (int nt0 = 0; nt0 < n_tiles; nt0 += 4) {
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);
    for (int tap = 0; tap < 4; ++tap) {
      const int a = tap >> 1, bt = tap & 1;
      const __nv_bfloat16* xa = xs + (row + py + a) * t.rs + (px + bt) * t.cis;
      const __nv_bfloat16* wk = w + (size_t)tap * Ci * wld + nt0 * 16;
      for (int ci0 = 0; ci0 < Ci; ci0 += 16) {
        FragA fa;
        nvcuda::wmma::load_matrix_sync(fa, xa + ci0, t.cis);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nt0 + j < n_tiles) {
            FragB fb;
            nvcuda::wmma::load_matrix_sync(fb, wk + (size_t)ci0 * wld + 16 * j,
                                           wld);
            nvcuda::wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nt0 + j < n_tiles)
        nvcuda::wmma::store_matrix_sync(st + (nt0 + j) * 16, acc[j], t.sld,
                                        nvcuda::wmma::mem_row_major);
  }
  __syncwarp();
}

// Folded BN + GLU from one warp's staged accumulators; lanes take
// consecutive channels, so each pixel's Co outputs are one coalesced store.
__device__ __forceinline__ void glu_store(const float* st, MmaLayout t,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int b, int sr,
                          int c0, int py, int px, int H, int W, int Co) {
  const int lane = threadIdx.x & 31;
  if (sr < H) {
    for (int i = lane; i < 16 * Co; i += 32) {
      const int m = i / Co, c = i % Co, sc = c0 + m;
      if (sc >= W) continue;
      const float a = st[m * t.sld + c] * scale[c] + bias[c];
      const float g = st[m * t.sld + Co + c] * scale[Co + c] + bias[Co + c];
      out[(((size_t)b * 2 * H + 2 * sr + py) * 2 * W + 2 * sc + px) * Co + c] =
          __float2bfloat16(a * (1.f / (1.f + expf(-g))));
    }
  }
  __syncwarp();  // st is overwritten by the next parity
}

// K2, bf16: Ci % 16 == 0, Co % 8 == 0. Where they fit next to the tile
// (stage_w, decided by the launcher from the dims), one parity's weights are
// staged in shared memory at a time with row stride 2*Co+16 (32-byte aligned
// rows that do not share banks); otherwise every warp reads its B fragments
// from global memory (the same ones for all warps: L1 hits after the first).
__global__ void __launch_bounds__(kThreads)
upblock_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int H, int W, int Ci,
                   int Co, int stage_w) {
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const MmaLayout t(Ci, Co);
  const int n = 2 * Co, ws_ld = n + 16;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(mma_smem + t.tile_bytes());
  const size_t ws_bytes =
      stage_w ? (size_t)4 * Ci * ws_ld * sizeof(__nv_bfloat16) : 0;
  const int warp = threadIdx.x >> 5;
  float* st = reinterpret_cast<float*>(mma_smem + t.tile_bytes() + ws_bytes) +
              warp * 16 * t.sld;
  const int b = blockIdx.z, r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  load_tile_bf16(x, xs, t, b, r0, c0, H, W, Ci);
  __syncthreads();
  for (int p = 0; p < 4; ++p) {
    const int py = p >> 1, px = p & 1;
    const __nv_bfloat16* w = wp + (size_t)p * 4 * Ci * n;
    int wld = n;
    if (stage_w) {
      __syncthreads();  // the previous parity's weights are no longer read
      for (int i = threadIdx.x; i < 4 * Ci * n / 8; i += kThreads) {
        const int k = i / (n / 8), n8 = i % (n / 8);
        *reinterpret_cast<uint4*>(ws + k * ws_ld + 8 * n8) =
            *reinterpret_cast<const uint4*>(w + (size_t)k * n + 8 * n8);
      }
      __syncthreads();
      w = ws;
      wld = ws_ld;
    }
    mma_parity(xs, t, w, wld, Ci, Co, warp, py, px, st);
    glu_store(st, t, scale, bias, out, b, r0 + warp, c0, py, px, H, W, Co);
  }
}

// ---- K2, bf16, the Hopper form: resident weights, a cp.async ring, wgmma ---
//
// What held the warp-level form back: every block restaged each parity's
// weights from L2 (4 x 32 KB per 8x16 tile, ~1.3 GB a serving call against
// ~0.5 GB of real input and output), loaded its tile synchronously, gave
// each warp only 16 rows per B fragment, and staged every accumulator in
// shared memory for the epilogue. This form:
// - is persistent: at most one block per SM walks over work units (image,
//   8 source rows, 16 source columns) with a static stride, and copies all
//   four parities' weights into shared memory once, for its whole life;
// - feeds a 4-stage ring of zero-padded input tiles with 16-byte cp.async
//   (src-size 0 for halo pixels outside the image), three units in flight
//   while one is computed;
// - runs the products as wgmma.m64n64k16 (bf16 in, fp32 accumulators) with
//   both operands read from shared memory through descriptors. Each of the
//   two warpgroups owns an 8x8 block of source pixels: M = 64 pixels of one
//   parity, N = 64 = 2*Co (the GLU's halves), K = 4 taps * Ci. It keeps two
//   accumulator sets, so that one parity's products run while the previous
//   parity's epilogue does (a unit's last epilogue is not overlapped: with
//   products pending across the loop's back-edge ptxas serialises them);
// - applies the folded BN and the GLU in registers: in the m64nNk16
//   accumulator layout a thread holding column c of N block j holds column
//   c+32 of block j+4. A 4x4 transpose within each lane quad then gives each
//   lane 8 consecutive channels, stored as 16 bytes.
//
// Operand layouts, canonical and without swizzle (a core matrix is 8 rows
// of 16 bytes, contiguous; K-major for both operands):
// - A, the input tile, is stored as 8-channel planes (Ci/8, pixel, 8): any
//   run of 8 pixels in one tile row is one core matrix. The 8 M groups of a
//   warpgroup's tile are its 8 source rows, a tile row apart (SBO); the two
//   K core matrices of a k16 step are two planes, a plane apart (LBO). Tap
//   (a, b) of parity (py, px) is the same descriptor with its start moved by
//   py+a rows and px+b pixels. The plane stride is 16 (mod 128) bytes, so
//   the 8 chunks of a pixel land in 8 different bank groups when copied.
// - B, the weights, arrives arranged by the wrapper
//   (ops/cuda_upblock.py::resident_weights) as [parity][K/8][N/8][8 n][8 k]:
//   SBO 128 bytes between N groups, LBO N/8 * 128 between K groups.
namespace res {

constexpr int kRows = 8;                 // source rows of a work unit
constexpr int kCols = 16;                // source columns: 8 per warpgroup
constexpr int kTR = kRows + 2, kTC = kCols + 2;   // the tile with its halo
constexpr int kStages = 4;
constexpr int kAhead = kStages - 1;      // units in flight while one computes
constexpr int kThreads = 256;            // two warpgroups
constexpr uint32_t kRowBytes = kTC * 16;   // A's SBO: one tile row

template <int Ci, int Co>
struct Shape {
  static constexpr int kPlanes = Ci / 8;
  static constexpr int kN = 2 * Co;
  static constexpr int kK = 4 * Ci;
  static constexpr int kSteps = kK / 16;            // k16 steps per parity
  static constexpr int kStepsPerTap = Ci / 16;
  static constexpr uint32_t kPlaneBytes =
      ((kTR * kTC * 16 - 16 + 127) / 128) * 128 + 16;   // = 16 (mod 128)
  static constexpr uint32_t kTileBytes = kPlanes * kPlaneBytes;
  static constexpr uint32_t kKGroupBytes = kN / 8 * 128;   // B's LBO
  static constexpr uint32_t kParityBytes = kK * kN * 2;
  static constexpr uint32_t kWeightBytes = 4 * kParityBytes;
  static constexpr uint32_t kSmemBytes = kWeightBytes + kStages * kTileBytes;
  static_assert(kN == 64, "the consumers are m64n64k16: 2*Co must be 64");
  static_assert(Ci % 16 == 0, "a k16 step takes 16 channels of one tap");
  static_assert(kSmemBytes <= 227 * 1024, "weights and ring exceed an SM");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The copies are generic-proxy writes; wgmma reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: start, LBO and SBO in 16-byte
// units. Shared addresses stay below 2^18, so adding (offset >> 4) moves
// the start without touching the other fields.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products that own them.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B^T, m64n64k16, bf16 operands from shared memory, fp32 sums.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A work unit's coordinates: image, first source row, first source column.
struct Unit {
  int b, r0, c0;
  __device__ Unit(int u, int units_c, int per_image)
      : b(u / per_image),
        r0((u % per_image) / units_c * kRows),
        c0((u % per_image) % units_c * kCols) {}
};

// Issue the copies of unit u's zero-padded tile (rows r0-1 .. r0+kRows,
// columns c0-1 .. c0+kCols) into the planes at s_tile, as one commit group
// (an empty one past the last unit, so that the group count stays fixed).
// Consecutive threads take consecutive 16-byte chunks: coalesced reads.
template <int Ci, int Co>
__device__ __forceinline__ void load_unit(const __nv_bfloat16* __restrict__ x,
                                          uint32_t s_tile, int u, int total,
                                          int units_c, int per_image, int H,
                                          int W) {
  using S = Shape<Ci, Co>;
  if (u < total) {
    const Unit t(u, units_c, per_image);
    for (int i = threadIdx.x; i < kTR * kTC * S::kPlanes; i += kThreads) {
      const int k = i % S::kPlanes, pix = i / S::kPlanes;
      const int gr = t.r0 - 1 + pix / kTC, gc = t.c0 - 1 + pix % kTC;
      const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
      const __nv_bfloat16* src =
          in ? x + (((size_t)t.b * H + gr) * W + gc) * Ci + 8 * k : x;
      cp_async16(s_tile + k * S::kPlaneBytes + pix * 16, src, in ? 16 : 0);
    }
  }
  cp_async_commit();
}

// One parity's K = 4*Ci products for this warpgroup, issued and committed
// as one wgmma group into d.
template <int Ci, int Co>
__device__ __forceinline__ void issue_parity(float (&d)[32], uint32_t s_tile,
                                             uint32_t s_w, int p, int wg) {
  using S = Shape<Ci, Co>;
  const int py = p >> 1, px = p & 1;
  const uint64_t da =
      make_desc(s_tile + (py * kTC + 8 * wg + px) * 16, S::kPlaneBytes,
                kRowBytes);
  const uint64_t db =
      make_desc(s_w + p * S::kParityBytes, S::kKGroupBytes, 128);
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < S::kSteps; ++s) {
    const int tap = s / S::kStepsPerTap;
    const uint32_t a_off = 2 * (s % S::kStepsPerTap) * S::kPlaneBytes +
                           ((tap >> 1) * kTC + (tap & 1)) * 16;
    const uint32_t b_off = 2 * s * S::kKGroupBytes;
    wgmma_m64n64k16(d, da + (a_off >> 4), db + (b_off >> 4), s > 0);
  }
  wgmma_commit();
  fence_acc(d);
}

__device__ __forceinline__ float tanh_approx(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(v));
  return t;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The folded BN constants of this thread's 8 channel pairs, halved: index
// 2j+e is channel 8j + 2q + e of the a half (and Co + that of the g half).
// With h = a/2 and t = tanh(g/2), a * sigmoid(g) = h + h*t: two FMAs, one
// MUFU tanh (its error, ~2^-11 relative, is below a bf16 rounding step) and
// one FMA per output, where exp and a division take two MUFU operations.
// Halving is exact in fp32.
struct Epilogue {
  float ka[8], ba[8], kg[8], bg[8];
};

// Folded BN + GLU on one parity's accumulators and the store. Warp w of the
// warpgroup holds source rows 2w (h=0) and 2w+1 (h=1) of the block, lane
// quad lane/4 its column; lane q = lane%4 holds channels 8j+2q, 8j+2q+1.
template <int Co>
__device__ __forceinline__ void glu_store(const float (&d)[32],
                                          const Epilogue& k,
                                          __nv_bfloat16* __restrict__ out,
                                          int b, int sr0, int sc, int p,
                                          int H, int W) {
  const int py = p >> 1, px = p & 1, q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float half_a =
            fmaf(d[4 * j + 2 * h + e], k.ka[2 * j + e], k.ba[2 * j + e]);
        const float t = tanh_approx(
            fmaf(d[4 * (j + 4) + 2 * h + e], k.kg[2 * j + e], k.bg[2 * j + e]));
        y[e] = fmaf(half_a, t, half_a);
      }
      v[j] = pack_bf16(y[0], y[1]);
    }
    // 4x4 transpose of 32-bit words across the quad: lane q ends with the
    // words j = q of lanes 0..3, i.e. channels 8q .. 8q+7 in order.
#pragma unroll
    for (int bit = 1; bit <= 2; bit <<= 1) {
      const bool hi = q & bit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j & bit) continue;
        const uint32_t send = hi ? v[j] : v[j | bit];
        const uint32_t got = __shfl_xor_sync(0xffffffffu, send, bit);
        if (hi)
          v[j] = got;
        else
          v[j | bit] = got;
      }
    }
    const int sr = sr0 + h;
    if (sr < H && sc < W)
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * 2 * H + 2 * sr + py) * 2 * W + 2 * sc + px) * Co +
          8 * q) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int Ci, int Co>
__global__ void __launch_bounds__(kThreads, 1)
upblock_resident_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wr,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int B, int H,
                        int W) {
  using S = Shape<Ci, Co>;
  extern __shared__ __align__(128) unsigned char res_smem[];
  const uint32_t s_w = smem_addr(res_smem);
  const uint32_t s_ring = s_w + S::kWeightBytes;
  const int units_c = (W + kCols - 1) / kCols;
  const int per_image = (H + kRows - 1) / kRows * units_c;
  const int total = B * per_image;
  const int step = gridDim.x;

  // the weights: one commit group, copied once for the block's life
  for (int i = threadIdx.x; i < (int)(S::kWeightBytes / 16); i += kThreads)
    cp_async16(s_w + 16 * i, wr + 8 * i, 16);
  cp_async_commit();
  for (int i = 0; i < kAhead; ++i)
    load_unit<Ci, Co>(x, s_ring + i * S::kTileBytes, blockIdx.x + i * step,
                      total, units_c, per_image, H, W);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, q = lane & 3;
  Epilogue k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * (i >> 1) + 2 * q + (i & 1);
    k.ka[i] = 0.5f * scale[c];
    k.ba[i] = 0.5f * bias[c];
    k.kg[i] = 0.5f * scale[Co + c];
    k.bg[i] = 0.5f * bias[Co + c];
  }

  // parity p+1's products run while parity p's epilogue does; the copies
  // of the unit three ahead are issued once the first products are queued
  float d0[32] = {}, d1[32] = {};
  int stage = 0;
  for (int u = blockIdx.x; u < total; u += step) {
    cp_async_wait<kAhead - 1>();   // this thread's copies of unit u
    fence_proxy_async();
    __syncthreads();   // everyone's copies landed; the unit before is done

    const uint32_t s_tile = s_ring + stage * S::kTileBytes;
    const Unit t(u, units_c, per_image);
    const int sr0 = t.r0 + 2 * warp, sc = t.c0 + 8 * wg + (lane >> 2);
    issue_parity<Ci, Co>(d0, s_tile, s_w, 0, wg);
    issue_parity<Ci, Co>(d1, s_tile, s_w, 1, wg);
    load_unit<Ci, Co>(x, s_ring + ((stage + kAhead) % kStages) * S::kTileBytes,
                      u + kAhead * step, total, units_c, per_image, H, W);
    wgmma_wait<1>();
    fence_acc(d0);
    glu_store<Co>(d0, k, out, t.b, sr0, sc, 0, H, W);
    issue_parity<Ci, Co>(d0, s_tile, s_w, 2, wg);
    wgmma_wait<1>();
    fence_acc(d1);
    glu_store<Co>(d1, k, out, t.b, sr0, sc, 1, H, W);
    issue_parity<Ci, Co>(d1, s_tile, s_w, 3, wg);
    wgmma_wait<1>();
    fence_acc(d0);
    glu_store<Co>(d0, k, out, t.b, sr0, sc, 2, H, W);
    wgmma_wait<0>();
    fence_acc(d1);
    glu_store<Co>(d1, k, out, t.b, sr0, sc, 3, H, W);
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
}

template <int Ci, int Co>
int launch_resident(const void* x, const void* wr, const float* scale,
                    const float* bias, void* out, int B, int H, int W,
                    int grid, cudaStream_t stream) {
  using S = Shape<Ci, Co>;
  cudaError_t e = cudaFuncSetAttribute(
      upblock_resident_kernel<Ci, Co>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  upblock_resident_kernel<Ci, Co><<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wr), scale, bias,
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace res

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

dim3 grid_for(int B, int H, int W) {
  return dim3((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, B);
}

int launch_upblock(int dtype, const void* x, const void* wp,
                   const float* scale, const float* bias, void* out, int B,
                   int H, int W, int Ci, int Co, cudaStream_t stream) {
  if (dtype == kFloat32) {
    const size_t smem = TileLayout(Ci).floats() * sizeof(float);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(upblock_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    upblock_kernel<<<grid_for(B, H, W), kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wp), scale,
        bias, static_cast<float*>(out), H, W, Ci, Co);
    return (int)cudaGetLastError();
  }
  if (dtype != kBFloat16 || Ci % 16 != 0 || Co % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const MmaLayout t(Ci, Co);
  size_t smem = t.tile_bytes() + t.staging_bytes();
  const size_t ws_bytes = (size_t)4 * Ci * (2 * Co + 16) * 2;
  const int stage_w = smem + ws_bytes <= 227 * 1024;
  if (stage_w) smem += ws_bytes;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(upblock_mma_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  upblock_mma_kernel<<<grid_for(B, H, W), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), scale, bias,
      static_cast<__nv_bfloat16*>(out), H, W, Ci, Co, stage_w);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace attngan

// C entry points. Shapes, types and alignment are checked by the Python
// wrappers (ops/cuda_upblock.py, ops/cuda_upblock_packed.py); the
// arguments are re-checked here so that a bad call fails as a CUDA error.
extern "C" int upblock_fused_eval(int dtype, const void* x, const void* wp,
                                  const float* scale, const float* bias,
                                  void* out, int B, int H, int W, int Ci,
                                  int Co, void* stream) {
  using namespace attngan;
  if (B < 1 || H < 1 || W < 1 || Ci < 1 || Co < 4 || Co % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_upblock(dtype, x, wp, scale, bias, out, B, H, W, Ci, Co,
                        static_cast<cudaStream_t>(stream));
}

// K2, bf16, resident-weight form, for the (Ci, Co) it is instantiated at:
// wr is resident_weights' arrangement, grid the number of persistent blocks
// (at most one per SM; ops/cuda_upblock.py::resident_grid).
extern "C" int upblock_fused_eval_resident(const void* x, const void* wr,
                                           const float* scale,
                                           const float* bias, void* out,
                                           int B, int H, int W, int Ci, int Co,
                                           int grid, void* stream) {
  using namespace attngan;
  if (B < 1 || H < 1 || W < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ci == 64 && Co == 32)
    return res::launch_resident<64, 32>(x, wr, scale, bias, out, B, H, W,
                                        grid, s);
  return (int)cudaErrorInvalidValue;
}
