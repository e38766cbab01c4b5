// Fused eval-mode UpBlock for Hopper: nearest 2x upsample -> conv3x3 ->
// folded BatchNorm -> GLU, in one pass (K2, and its Ci=64 -> Co=32
// specialisation K3).
//
// Replaces the TPU kernels attngan_tpu/ops/pallas_upblock.py::
// _upblock_kernel (called through _upblock_call) and
// attngan_tpu/ops/pallas_upblock_packed.py::_kernel (the lane-packed
// Ci=64 -> Co=32 form; its column-pair lane packing exists for the TPU's
// 128-wide lanes and has no meaning here, so K3 is the same arithmetic with
// the dims fixed at compile time).
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
// the tensor cores (warp-level 16x16x16 mma through nvcuda::wmma, fp32
// accumulators); fp32 keeps exact fp32 FMAs on the CUDA cores (the
// tensor cores would round it to TF32). Both keep the property the TPU
// kernel exists for: the input is read from memory once (a tile plus its
// one-pixel halo, staged in shared memory) and only the GLU output is
// written: the 4x upsampled tensor and the 2*Co pre-GLU tensor never reach
// memory. wgmma and TMA, the way to the card's full rate, are later work.
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

// K3, fp32: Ci = 64, Co = 32 at compile time. Constant trip counts, and one
// parity's weights (4*64 x 64, fp32) staged in shared memory at a time: the
// eight warps take the eight groups of 4 channel pairs, each warp reading
// its weights as a broadcast float4 from shared memory.
constexpr int kPCi = 64, kPCo = 32;
constexpr int kPK = 4 * kPCi, kPN = 2 * kPCo;
static_assert(kWarps * 4 == kPCo, "one warp per group of 4 channel pairs");

__global__ void __launch_bounds__(kThreads)
upblock_packed_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int H, int W) {
  extern __shared__ float smem[];
  float* ws = smem;               // [kPK][kPN] one parity (16-byte aligned)
  float* xs = smem + kPK * kPN;   // input tile
  const TileLayout t(kPCi);
  const int b = blockIdx.z, r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  load_tile(x, xs, t, b, r0, c0, H, W, kPCi);

  const int lane = threadIdx.x & 31, cn = (threadIdx.x >> 5) * 4;
  const int tr = lane >> 2, tc0 = (lane & 3) * 4;
  for (int p = 0; p < 4; ++p) {
    const int py = p >> 1, px = p & 1;
    __syncthreads();  // the previous parity's weights are no longer read
    const float* src = wp + (size_t)p * kPK * kPN;
    for (int i = threadIdx.x * 4; i < kPK * kPN; i += kThreads * 4) {
      float v[4];
      load4(src + i, v);
      store4(ws + i, v);
    }
    __syncthreads();

    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[q][n] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int a = tap >> 1, bt = tap & 1;
      const float* xr = xs + (tr + py + a) * t.rs + (tc0 + px + bt) * t.cis;
      const float* wk = ws + tap * kPCi * kPN + cn;
#pragma unroll 4
      for (int ci = 0; ci < kPCi; ++ci) {
        float xv[4], wa[4], wg[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xr[q * t.cis + ci];
        load4(wk + ci * kPN, wa);
        load4(wk + ci * kPN + kPCo, wg);
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
             kPCo);
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

// K3, bf16: K2's staged-weights form with Ci = 64, Co = 32 compiled in
// (constant trip counts and offsets; the mma loops unroll).
constexpr int kPWld = kPN + 16;

__global__ void __launch_bounds__(kThreads)
upblock_packed_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wp,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const MmaLayout t(kPCi, kPCo);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(mma_smem + t.tile_bytes());
  const int warp = threadIdx.x >> 5;
  float* st = reinterpret_cast<float*>(mma_smem + t.tile_bytes() +
                                       kPK * kPWld * sizeof(__nv_bfloat16)) +
              warp * 16 * t.sld;
  const int b = blockIdx.z, r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  load_tile_bf16(x, xs, t, b, r0, c0, H, W, kPCi);
  for (int p = 0; p < 4; ++p) {
    const int py = p >> 1, px = p & 1;
    __syncthreads();  // the previous parity's weights are no longer read
    const __nv_bfloat16* src = wp + (size_t)p * kPK * kPN;
    for (int i = threadIdx.x; i < kPK * kPN / 8; i += kThreads) {
      const int k = i / (kPN / 8), n8 = i % (kPN / 8);
      *reinterpret_cast<uint4*>(ws + k * kPWld + 8 * n8) =
          *reinterpret_cast<const uint4*>(src + k * kPN + 8 * n8);
    }
    __syncthreads();
    mma_parity(xs, t, ws, kPWld, kPCi, kPCo, warp, py, px, st);
    glu_store(st, t, scale, bias, out, b, r0 + warp, c0, py, px, H, W, kPCo);
  }
}

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

int launch_packed(int dtype, const void* x, const void* wp, const float* scale,
                  const float* bias, void* out, int B, int H, int W,
                  cudaStream_t stream) {
  if (dtype == kFloat32) {
    const size_t smem =
        (kPK * kPN + TileLayout(kPCi).floats()) * sizeof(float);
    cudaError_t e = allow_smem(upblock_packed_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    upblock_packed_kernel<<<grid_for(B, H, W), kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wp), scale,
        bias, static_cast<float*>(out), H, W);
    return (int)cudaGetLastError();
  }
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const MmaLayout t(kPCi, kPCo);
  const size_t smem = t.tile_bytes() + kPK * kPWld * sizeof(__nv_bfloat16) +
                      t.staging_bytes();
  cudaError_t e = allow_smem(upblock_packed_mma_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  upblock_packed_mma_kernel<<<grid_for(B, H, W), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), scale, bias,
      static_cast<__nv_bfloat16*>(out), H, W);
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

extern "C" int upblock_fused_eval_packed(int dtype, const void* x,
                                         const void* wp, const float* scale,
                                         const float* bias, void* out, int B,
                                         int H, int W, void* stream) {
  using namespace attngan;
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  return launch_packed(dtype, x, wp, scale, bias, out, B, H, W,
                       static_cast<cudaStream_t>(stream));
}
