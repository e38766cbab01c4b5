// Fused eval-mode UpBlock for Hopper: nearest 2x upsample -> conv3x3 ->
// folded BatchNorm -> GLU, in one pass (K2, which also serves K3).
//
// Replaces the TPU kernels attngan_tpu/ops/pallas_upblock.py::
// _upblock_kernel (called through _upblock_call) and
// attngan_tpu/ops/pallas_upblock_packed.py::_kernel. The latter computes
// the same function at exactly Ci=64 -> Co=32, with column pairs packed
// into the TPU's 128-wide lanes. That packing has no meaning on Hopper,
// whose form for exactly those dims is upblock_resident_kernel below: K2's
// wrapper (ops/cuda_upblock.py) launches it in bf16, and the CUDA-core
// upblock_kernel in fp32, so K3 needs no kernel of its own.
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
// a cp.async input ring and wgmma), at DM-GAN's (Ci=128 -> Co=64) in its
// cluster form (upblock_cluster_kernel: each of four CTAs keeps one
// parity's weights resident, the four share each input tile by TMA
// multicast), at other dims warp-level 16x16x16 mma through nvcuda::wmma
// (upblock_mma_kernel), fp32 accumulators in all three;
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

#include <cuda.h>      // CUtensorMap; the encoder is fetched at run time
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

// ---- K2, bf16, the cluster form: DM-GAN's (Ci, Co) = (128, 64) --------------
//
// What bounds it: operations, 0.139 + 0.556 ms at batch 64 for DM-GAN's two
// refinement UpBlocks (64^2 -> 128^2 and 128^2 -> 256^2) at 989 TFLOP/s; the
// bytes (input once, output once) take less than half that at 3.35 TB/s.
// What held the other forms back there: the parity weights are
// 4 x (4*128) x 128 bf16 = 512 KB, which no SM's 227 KB holds, so the
// warp-level form reloaded its B fragments from L2 for every 8x16 tile and
// every parity, with a synchronous tile load. This form:
// - splits the weights over a cluster of four CTAs: CTA rank r keeps parity
//   r's B operand (K = 4*Ci = 512 by N = 2*Co = 128, 128 KB, the
//   arrangement of ops/cuda_upblock.py::resident_weights) in shared memory
//   for its whole life, copied once by bulk copies, and writes only parity
//   r's output pixels;
// - is persistent: the grid is the clusters the card holds at once, which
//   walk the work units (image, 8 source rows, 16 source columns; the
//   resident form's) with a static stride, all four CTAs of a cluster on
//   the same unit;
// - loads each unit's zero-padded 10 x 18 x Ci tile once per cluster: each
//   CTA issues a quarter of its 8-channel planes as TMA tensor loads
//   multicast to all four (the out-of-bounds fill gives the halo's zeros),
//   into a ring of two slots. A slot's "full" mbarrier expects the whole
//   tile's bytes; its "empty" mbarrier counts the releases of all four
//   CTAs' consumer warps, so no CTA overwrites a slot a peer still reads;
// - runs the products as wgmma.m64n128k16 with both operands in shared
//   memory: one producer warp, and two consumer warpgroups that take the
//   cluster's units in turn, each a whole unit (two 8x8 pixel blocks, M = 64
//   each, 2 x 64 fp32 accumulators a thread). A named-barrier turn makes
//   one warpgroup issue its products only after the other has issued its
//   own, so that each one's epilogue runs under the other's products;
// - applies the folded BN and the GLU in registers: in the m64n128k16
//   accumulator layout a thread holding column c of N block j holds column
//   c + 64 of block j + 8, so each GLU pair stays in one thread; the
//   halved constants are read from shared memory; two 4x4 transposes in
//   each lane quad give a lane 16 consecutive bytes twice a pixel.
//
// Operand layouts, canonical K-major without swizzle, as the resident form's
// (res:: above): A is the tile as 8-channel planes (Ci/8, 10 rows, 18 pixels,
// 8), a plane 2,880 bytes as TMA writes it, 128-byte aligned apart; B is
// [K/8][N/8][8 n][8 k], SBO 128 bytes, LBO N/8 * 128.
namespace clu {

constexpr int kCluster = 4;                    // CTAs a cluster; rank = parity
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and the producer warp
constexpr int kSlots = 2;                      // tiles in the ring
constexpr int kTR = res::kRows + 2, kTC = res::kCols + 2;  // with the halo
constexpr uint32_t kRowBytes = kTC * 16;       // A's SBO: one tile row
constexpr uint32_t kChunkBytes = 16384;        // a bulk copy of the weights

template <int Ci, int Co>
struct Shape {
  static constexpr int kPlanes = Ci / 8;
  static constexpr int kPlanesPerRank = kPlanes / kCluster;
  static constexpr int kN = 2 * Co;
  static constexpr int kK = 4 * Ci;
  static constexpr int kSteps = kK / 16;             // k16 steps per parity
  static constexpr int kStepsPerTap = Ci / 16;
  static constexpr uint32_t kBoxBytes = kTR * kTC * 16;   // a plane's TMA box
  // TMA writes to 128-byte aligned shared addresses
  static constexpr uint32_t kPlaneBytes = (kBoxBytes + 127) / 128 * 128;
  static constexpr uint32_t kTileBytes = kPlanes * kPlaneBytes;
  static constexpr uint32_t kTileTx = kPlanes * kBoxBytes;  // a full barrier's
  static constexpr uint32_t kKGroupBytes = kN / 8 * 128;    // B's LBO
  static constexpr uint32_t kWeightBytes = kK * kN * 2;     // one parity
  static constexpr uint32_t kRingOff = kWeightBytes;
  static constexpr uint32_t kBarOff = kRingOff + kSlots * kTileBytes;
  static constexpr uint32_t kConstOff = kBarOff + 64;   // 5 mbarriers
  static constexpr uint32_t kSmemBytes = kConstOff + 4 * Co * 4;
  static_assert(kN == 128, "the consumers are m64n128k16: 2*Co must be 128");
  static_assert(Ci % 16 == 0 && kPlanes % kCluster == 0,
                "a k16 step takes 16 channels; the ranks share the planes");
  static_assert(kWeightBytes % kChunkBytes == 0, "whole bulk copies");
  static_assert(kSmemBytes <= 232448, "weights and ring exceed an SM");
};

// this CTA's rank in its cluster, the cluster's index, the clusters
__device__ __forceinline__ int cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return (int)v;
}
__device__ __forceinline__ int cluster_index() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return (int)v;
}
__device__ __forceinline__ int cluster_count() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(v));
  return (int)v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on the barrier at the same offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [a];\n}\n" ::"r"(
          bar),
      "r"(rank)
      : "memory");
}

// bytes from global memory to this CTA's shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One TMA box of the 4-D map (channel, column, row, image) into the same
// shared offset of every CTA in `mask`, counted on each one's bar.
__device__ __forceinline__ void tma_multicast(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, uint16_t mask,
                                              int c, int col, int row,
                                              int img) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c),
      "r"(col), "r"(row), "r"(img)
      : "memory");
}

// bar.sync / bar.arrive on a named barrier of both consumer warpgroups
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B^T, m64n128k16, bf16 operands from shared memory, fp32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, "
      "%63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One 8x8 pixel block's K = 4*Ci products into d: da is the block's tap
// (0, 0) in plane 0, db the parity's weights.
template <int Ci, int Co>
__device__ __forceinline__ void issue_block(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  using S = Shape<Ci, Co>;
#pragma unroll
  for (int s = 0; s < S::kSteps; ++s) {
    const int tap = s / S::kStepsPerTap;
    const uint32_t a_off = 2 * (s % S::kStepsPerTap) * S::kPlaneBytes +
                           ((tap >> 1) * kTC + (tap & 1)) * 16;
    const uint32_t b_off = 2 * s * S::kKGroupBytes;
    wgmma_m64n128k16(d, da + (a_off >> 4), db + (b_off >> 4), s > 0);
  }
}

// A unit's products for one warpgroup: both 8x8 pixel blocks of parity
// (py, px), issued and committed as one wgmma group.
template <int Ci, int Co>
__device__ __forceinline__ void issue_unit(float (&d0)[64], float (&d1)[64],
                                           uint32_t s_tile, uint32_t s_w,
                                           int py, int px) {
  using S = Shape<Ci, Co>;
  const uint64_t db = res::make_desc(s_w, S::kKGroupBytes, 128);
  const uint32_t a0 = s_tile + (py * kTC + px) * 16;
  fence_acc(d0);
  fence_acc(d1);
  res::wgmma_fence();
  issue_block<Ci, Co>(d0, res::make_desc(a0, S::kPlaneBytes, kRowBytes), db);
  issue_block<Ci, Co>(d1, res::make_desc(a0 + 8 * 16, S::kPlaneBytes,
                                         kRowBytes), db);
  res::wgmma_commit();
  fence_acc(d0);
  fence_acc(d1);
}

// Lane q of each quad holds words j = 0..3 of channels 8j+2q, 8j+2q+1; after
// the exchange it holds word j of lane j, i.e. channels 8q .. 8q+7 in order.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
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
}

// Folded BN + GLU on one 8x8 block's accumulators and the store. Warp w of
// the warpgroup holds source rows 2w (h=0) and 2w+1 (h=1) of the block,
// lane quad lane/4 its column; lane q holds channels 8j+2q, 8j+2q+1 of the
// a half (N blocks j < 8) and of the g half (blocks j + 8). k holds the
// halved constants: scale and bias of the a half, then of the g half. With
// h = a/2 and t = tanh(g/2), a * sigmoid(g) = h + h*t, as res::glu_store.
template <int Co>
__device__ __forceinline__ void glu_store(const float (&d)[64],
                                          const float* k,
                                          __nv_bfloat16* __restrict__ out,
                                          int b, int sr0, int sc, int py,
                                          int px, int H, int W) {
  const int q = threadIdx.x & 3;
  uint32_t v[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 ka = *reinterpret_cast<const float2*>(k + c);
    const float2 ba = *reinterpret_cast<const float2*>(k + Co + c);
    const float2 kg = *reinterpret_cast<const float2*>(k + 2 * Co + c);
    const float2 bg = *reinterpret_cast<const float2*>(k + 3 * Co + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ha0 = fmaf(d[4 * j + 2 * h], ka.x, ba.x);
      const float ha1 = fmaf(d[4 * j + 2 * h + 1], ka.y, ba.y);
      const float t0 =
          res::tanh_approx(fmaf(d[4 * (j + 8) + 2 * h], kg.x, bg.x));
      const float t1 =
          res::tanh_approx(fmaf(d[4 * (j + 8) + 2 * h + 1], kg.y, bg.y));
      v[h][j] = res::pack_bf16(fmaf(ha0, t0, ha0), fmaf(ha1, t1, ha1));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t lo[4] = {v[h][0], v[h][1], v[h][2], v[h][3]};
    uint32_t hi[4] = {v[h][4], v[h][5], v[h][6], v[h][7]};
    quad_transpose(lo, q);
    quad_transpose(hi, q);
    const int sr = sr0 + h;
    if (sr < H && sc < W) {
      __nv_bfloat16* o =
          out + (((size_t)b * 2 * H + 2 * sr + py) * 2 * W + 2 * sc + px) * Co +
          8 * q;
      *reinterpret_cast<uint4*>(o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(o + Co / 2) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

template <int Ci, int Co>
__global__ void __launch_bounds__(kThreads, 1)
upblock_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __nv_bfloat16* __restrict__ wr,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  using S = Shape<Ci, Co>;
  extern __shared__ __align__(128) unsigned char clu_smem[];
  const uint32_t s_w = res::smem_addr(clu_smem);
  const uint32_t s_ring = s_w + S::kRingOff;
  const uint32_t full = s_w + S::kBarOff;    // full[2], empty[2], weights
  const uint32_t empty = full + 8 * kSlots;
  const uint32_t wbar = empty + 8 * kSlots;
  float* k = reinterpret_cast<float*>(clu_smem + S::kConstOff);
  const int rank = cluster_rank();           // this CTA's parity
  const int cluster = cluster_index(), clusters = cluster_count();
  const int units_c = (W + res::kCols - 1) / res::kCols;
  const int per_image = (H + res::kRows - 1) / res::kRows * units_c;
  const int total = B * per_image;
  const int n = cluster < total ? (total - 1 - cluster) / clusters + 1 : 0;

  for (int i = threadIdx.x; i < Co; i += kThreads) {
    k[i] = 0.5f * scale[i];
    k[Co + i] = 0.5f * bias[i];
    k[2 * Co + i] = 0.5f * scale[Co + i];
    k[3 * Co + i] = 0.5f * bias[Co + i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      // each consumer warp of the four CTAs releases the slot once
      mbar_init(empty + 8 * s, kCluster * 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // every CTA's barriers exist before a peer's copies land

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {   // the producer
      mbar_expect_tx(wbar, S::kWeightBytes);
      const char* w = reinterpret_cast<const char*>(wr) +
                      (size_t)rank * S::kWeightBytes;
      for (uint32_t off = 0; off < S::kWeightBytes; off += kChunkBytes)
        bulk_load(s_w + off, w + off, kChunkBytes, wbar);
      for (int i = 0; i < n; ++i) {
        const int s = i % kSlots;
        // all four CTAs have released the unit this slot held
        if (i >= kSlots) mbar_wait(empty + 8 * s, (i / kSlots - 1) & 1);
        mbar_expect_tx(full + 8 * s, S::kTileTx);
        const res::Unit t(cluster + i * clusters, units_c, per_image);
        const uint32_t s_tile = s_ring + s * S::kTileBytes;
        for (int p = rank * S::kPlanesPerRank;
             p < (rank + 1) * S::kPlanesPerRank; ++p)
          tma_multicast(s_tile + p * S::kPlaneBytes, &xmap, full + 8 * s,
                        (1 << kCluster) - 1, 8 * p, t.c0 - 1, t.r0 - 1, t.b);
      }
    }
    __syncwarp();
  } else {
    // warpgroup wg takes the cluster's units wg, wg + 2, ... from slot wg;
    // named barrier 1 + wg is its turn to issue
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int py = rank >> 1, px = rank & 1;
    const uint32_t s_tile = s_ring + wg * S::kTileBytes;
    float d0[64] = {}, d1[64] = {};
    mbar_wait(wbar, 0);
    for (int i = wg; i < n; i += kSlots) {
      mbar_wait(full + 8 * wg, (i / kSlots) & 1);
      if (i > 0) turn_wait(1 + wg);          // the other issued unit i - 1
      issue_unit<Ci, Co>(d0, d1, s_tile, s_w, py, px);
      if (i + 1 < n) turn_pass(2 - wg);       // its turn for unit i + 1
      res::wgmma_wait<0>();
      fence_acc(d0);
      fence_acc(d1);
      if (lane == 0)
        for (int r = 0; r < kCluster; ++r) mbar_arrive_at(empty + 8 * wg, r);
      const res::Unit t(cluster + i * clusters, units_c, per_image);
      const int sr0 = t.r0 + 2 * warp, sc = t.c0 + (lane >> 2);
      glu_store<Co>(d0, k, out, t.b, sr0, sc, py, px, H, W);
      glu_store<Co>(d1, k, out, t.b, sr0, sc + 8, py, px, H, W);
    }
  }
  cluster_sync();   // no CTA leaves while a peer may still signal it
}

// cuTensorMapEncodeTiled from the driver, found at run time: the build links
// no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int Ci, int Co>
cudaLaunchConfig_t config(int clusters, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * clusters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Shape<Ci, Co>::kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of upblock_cluster_kernel<Ci, Co> that the card holds at once
template <int Ci, int Co>
int capacity() {
  cudaError_t e = cudaFuncSetAttribute(
      upblock_cluster_kernel<Ci, Co>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Shape<Ci, Co>::kSmemBytes);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<Ci, Co>(1, nullptr, &attr);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, upblock_cluster_kernel<Ci, Co>,
                                       &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

template <int Ci, int Co>
int launch_cluster(const void* x, const void* wr, const float* scale,
                   const float* bias, void* out, int B, int H, int W,
                   int clusters, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // x as (channel, column, row, image); a box is one 8-channel plane of a
  // tile, rows and columns outside the image read as zeros
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Ci * 2, (cuuint64_t)W * Ci * 2,
                                 (cuuint64_t)H * W * Ci * 2};
  const cuuint32_t box[4] = {8, kTC, kTR, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upblock_cluster_kernel<Ci, Co>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Shape<Ci, Co>::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<Ci, Co>(clusters, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, upblock_cluster_kernel<Ci, Co>, map,
                         static_cast<const __nv_bfloat16*>(wr), scale, bias,
                         static_cast<__nv_bfloat16*>(out), B, H, W);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace clu

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
// wrapper (ops/cuda_upblock.py); the arguments are re-checked here so that
// a bad call fails as a CUDA error.
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

// K2, bf16, cluster form, for the (Ci, Co) it is instantiated at: wr is
// resident_weights' arrangement of all four parities (CTA rank r copies
// parity r), clusters the number of persistent clusters (at most
// upblock_cluster_capacity; ops/cuda_upblock.py::cluster_grid).
extern "C" int upblock_fused_eval_cluster(const void* x, const void* wr,
                                          const float* scale,
                                          const float* bias, void* out, int B,
                                          int H, int W, int Ci, int Co,
                                          int clusters, void* stream) {
  using namespace attngan;
  if (B < 1 || H < 1 || W < 1 || clusters < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ci == 128 && Co == 64)
    return clu::launch_cluster<128, 64>(x, wr, scale, bias, out, B, H, W,
                                        clusters, s);
  return (int)cudaErrorInvalidValue;
}

// The clusters of the cluster form at (Ci, Co) that the current device holds
// at once, or minus the cudaError_t of the query.
extern "C" int upblock_cluster_capacity(int Ci, int Co) {
  using namespace attngan;
  if (Ci == 128 && Co == 64) return clu::capacity<128, 64>();
  return -(int)cudaErrorInvalidValue;
}
