// DAMSM word-region similarity (K4) and its backward (K5 / K6) for Hopper.
//
// Replaces the TPU kernels of attngan_tpu/ops/pallas_damsm.py: the forward
// _image_cell_kernel (called through _similarity_grid) and the two
// hand-derived backwards, _image_cell_bwd_kernel (_similarity_grid_bwd_square,
// square batches <= 128) and _tiled_bwd_kernel (_similarity_grid_bwd_tiled,
// rectangular or larger batches). One backward design serves both cases.
//
// Per (image j, text i) pair, with ctx = img[j] (R, D) and w = words[i]
// (L, D), everything in fp32 in and out (the products in fp32 on the CUDA
// cores, or in 3xTF32 on the tensor cores, below; 1xTF32 would change the
// loss: tests/test_torch_port_damsm_tf32.py):
//   s[l,r] = w[l].ctx[r] / sqrt(D) + bias[l]       bias = -1e9 at padding
//   a1     = softmax over the L words of each region (shift: the group max),
//            e1 / max(sum, 1e-8)
//   a2     = softmax over the R regions of gamma1 * a1
//   v[l]   = sum_r a2[l,r] ctx[r]
//   cos[l] = w[l].v[l] / max(|w[l]| |v[l]|, 1e-8)
//   sims[j,i] = log sum_l mask[l] exp(gamma2 * cos[l])
//
// What bounds it on the H100: operations. Each pair does two products of
// 2*L*D*R flops against one read of the pair's inputs; at B=64, L=8,
// R=289, D=256 that is ~9.7 GFLOP (~0.15 ms at the fp32 CUDA-core peak)
// for ~19 MB of input. So the design keeps every intermediate out of
// device memory and reuses what it loads:
//   - a block owns (image j, tile of T texts): the tile's T*L word rows
//     (T*L*D <= 16384 floats, 64 KB) stay in shared memory while the
//     image's regions stream through in chunks of 32 (one per lane);
//   - one image is 289 x 256 fp32 = 296 KB, more than an SM holds, so
//     softmax #2 (over all regions) is an online softmax: a running max and
//     sum per word row, with v rescaled as chunks arrive (flash attention's
//     recurrence). Softmax #1 is local to a region and needs nothing across
//     chunks; on the GPU its per-text max is a plain loop over L words (the
//     TPU kernel's roll / selector-matmul workarounds have no use here);
//   - v lives in registers: each thread owns four columns of up to 16 rows;
//   - the products are register-tiled against shared memory's load rate:
//     a lane forms 2 word rows x 4 regions of the scores (rows padded to an
//     odd multiple of 4 floats, so each load is one wavefront), and the
//     accumulations read four regions' weights in one float4.
//
// The backward recomputes the forward per block (pass 1), then walks the
// chain back per word (the cosine and Eq. 10), and streams the regions a
// second time (pass 2). The row term of the region-softmax VJP,
// sum_r d_a2[l,r] a2[l,r], equals d_v[l].v[l], known after pass 1, so pass
// 2 forms d_s chunk by chunk with no (L x R) array in memory: d_ctx rows of
// the chunk (a2^T d_v + scale d_s^T w) and the d_w contribution
// (scale d_s ctx) come out of the same chunk. Accumulations are
// deterministic, with no float atomics: a block owns image j and a fixed
// set of text tiles, and sums d_ctx[j] over them in a fixed order into its
// own output; d_w of each (image, tile) goes to a partial buffer that a
// second kernel sums over the images in order (and, where the tiles of an
// image are split over several blocks to fill the card, the d_ctx
// partials too). Reruns give the same bits.
//
// damsm_bwd_tc_kernel<D>: the same backward pass with its products on the
// tensor cores. It replaces the same TPU kernels (pallas_damsm.py:158
// _image_cell_bwd_kernel, :192 _tiled_bwd_kernel) for D a multiple of 32
// and texts of at most 8 words; damsm_bwd_kernel keeps other shapes (a
// choice by shape, made in ops/cuda_damsm.py::takes_tc and passed to
// damsm_similarity_bwd). What bounds the pass is operations: per (image,
// 64-row tile, 32-region chunk) it does seven 64 x 32 x 256 products (the
// scores in both passes, v, d_a2, d_ctx's two, d_w; the fp32 bound counts
// six), 29 GFLOP of fp32 work at B = 64, 0.43 ms at the CUDA cores' 67
// TFLOP/s. The design:
//   - the products are mma.sync.m16n8k8 in 3xTF32: each fp32 operand is
//     split once, as its fragment is loaded, into TF32 hi + lo (Veltkamp's
//     split, four fp32 operations), and a step adds lo.hi, hi.lo, then
//     hi.hi (relative error ~2^-21; 1xTF32, 2^-11, moves the loss:
//     tests/test_torch_port_damsm_tf32.py). Three TF32 products per fp32
//     product at 495 TFLOP/s bound the work as done at 0.18 ms at B = 64;
//   - v, then d_w, stay in the mma accumulators: warp w holds a 64 x 32
//     share of the tile's rows (TcTile), so the online softmax's rescale by
//     alpha[row] is a multiply in registers and the row sums (w.v, v.v,
//     d_v.v) are two quad shuffles and one pass over shared memory;
//   - fragments load from shared memory without bank conflicts: rows of w,
//     d_v and the chunk are padded to D + 8 floats, the scores take their
//     depth in pair order (8-byte loads), v and d_w read the chunk by
//     rows; only d_ctx's a2 / d_s operand is read at a 2-way conflict;
//   - the score products split their depth over pairs of warps (4 m16 x 4
//     n8 tiles a warp), combined in place in a fixed order;
//   - the image's chunks stream through a two-stage cp.async ring (two 32-
//     region stages fit once a2 shares the score array): the next chunk is
//     in flight while one is computed, across both passes and every tile;
//   - the softmaxes run a warp per text and a lane per region, the text's
//     words in registers and the rows' shuffle reductions interleaved;
//   - n8 tiles and k8 steps wholly past the chunk's last region are not
//     issued: R = 289 leaves 1 region in the tenth chunk, whose products
//     cost a quarter of a full chunk's (d_ctx's, by m16 tiles, a half);
//   - d_ctx is summed over a block's tiles in global memory, every load of
//     a 16-region half before its stores; no float atomics: the same bits
//     on every launch. One block of 8 warps per SM (224 KB of shared
//     memory), 251-255 registers, no spills (chip_smoke.py checks).
//
// damsm_fwd_tc_kernel<D>: the forward on the tensor cores, replacing
// damsm_fwd_kernel (pallas_damsm.py:265 _similarity_grid, body :147) at
// the same shapes as the backward's pass. Its chain is the backward's pass
// 1 and cosine terms, one __forceinline__ function (tc_pass1) that both
// kernels run, so the forward's sims and the backward's recompute come
// from the same instructions; it ends in Eq. 10 per text where the
// backward goes on to words_bwd. The forward's two products, 9.7 GFLOP at
// B = 64, bound it at 0.145 ms on the CUDA cores and 0.059 ms as 3xTF32
// on the tensor cores. A block per (image, split of the text tiles), as
// the backward plans it (ops/cuda_damsm.py::plan), with the ring running
// across the block's tiles; with no d_v and no g its shared memory is
// 149 KB, one block per SM.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace attngan {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // regions per chunk: one per lane
constexpr int kCs = kChunk + 4;            // row stride of the chunk arrays
constexpr int kTileFloats = 16384;         // rows * D of a text tile (64 KB)
constexpr int kMaxRows = 128;              // word rows of a text tile
constexpr int kMaxD = 256;
constexpr int kRowsPerThread = kTileFloats / 4 / kThreads;  // 16 rows x 4 cols
constexpr int kChunkPerThread = kChunk * kMaxD / 4 / kThreads;  // 8
// score products: a lane owns 2 rows x 4 regions (regions q, q+8, q+16,
// q+24 of the chunk), a warp 8 rows, the block 64 rows per sweep
constexpr int kSweepRows = 2 * 4 * kWarps;
constexpr int kRedSlots = kMaxD / 4 / 32;  // warps sharing one row (2)
constexpr float kEps = 1e-8f;
constexpr float kNegInf = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// per-row scalars, rs[k * nr + row]
enum RowScalar : int {
  kBias, kMaskF, kWW, kM2, kL2, kAlpha, kNum, kVV, kExpG, kDNum, kDWn, kWnC,
  kDVn, kVnC, kRowT, kNumRowScalars
};

struct Smem {
  float* w;    // [rows][ws] the tile's words
  float* dv;   // [rows][ws] d_v (backward)
  float* ctx;  // [kChunk][D + 4] one chunk of the image's regions
  float* s;    // [rows][kCs] scores -> a1 -> softmax #2 numerators
  float* a2;   // [rows][kCs] (backward)
  float* g;    // [rows][kCs] d_a2 -> scale * d_s (backward)
  float* rs;   // [kNumRowScalars][nr]
  float* red;  // [nr][kRedSlots] partial row sums
  float* text; // [nr] per-text d_agg
  int nr;      // word rows of a full tile, T * L
  int ws;      // row stride of w and dv, D + 4: rows 4 banks apart
};

__host__ __device__ inline size_t smem_floats(int nr, int D, bool bwd) {
  size_t n = (size_t)nr * (D + 4) + (size_t)kChunk * (D + 4) + (size_t)nr * kCs;
  if (bwd) n += (size_t)nr * (D + 4) + 2 * (size_t)nr * kCs;
  return n + (size_t)nr * (kNumRowScalars + kRedSlots + 1);
}

__device__ inline Smem carve(float* base, int nr, int D, bool bwd) {
  // float4-accessed arrays first: every offset stays a multiple of 4 floats
  Smem sm;
  sm.nr = nr;
  sm.ws = D + 4;
  sm.w = base;
  base += (size_t)nr * sm.ws;
  sm.dv = base;
  if (bwd) base += (size_t)nr * sm.ws;
  sm.ctx = base;
  base += (size_t)kChunk * (D + 4);
  sm.s = base;
  base += (size_t)nr * kCs;
  sm.a2 = base;
  sm.g = base + (size_t)nr * kCs;
  if (bwd) base += 2 * (size_t)nr * kCs;
  sm.rs = base;
  base += (size_t)kNumRowScalars * nr;
  sm.red = base;
  sm.text = base + (size_t)nr * kRedSlots;
  return sm;
}

__device__ inline float* rs(const Smem& sm, int k) { return sm.rs + k * sm.nr; }

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}
__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ inline float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The thread's share of a (rows x D) array: four columns (group cg) of the
// rows rg, rg + RG, ... (up to kRowsPerThread of them).
struct Lanes {
  int ncg, cg, rg, RG;
  __device__ explicit Lanes(int D) {
    ncg = D / 4;
    cg = threadIdx.x % ncg;
    rg = threadIdx.x / ncg;
    RG = kThreads / ncg;
  }
  __device__ int row(int i) const { return rg + RG * i; }
};

// Copies the tile's words, its bias / mask and |w|^2 per row.
__device__ void load_tile(const Smem& sm, const float* words, const int* mask,
                          int text0, int rows, int L, int D) {
  const float* src = words + (size_t)text0 * L * D;
  const int n4 = D / 4;
  for (int i = threadIdx.x; i < rows * n4; i += kThreads)
    st4(sm.w + (i / n4) * sm.ws + 4 * (i % n4), ld4(src + 4 * i));
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int m = mask[(size_t)text0 * L + r];
    rs(sm, kBias)[r] = m == 0 ? kNegInf : 0.f;
    rs(sm, kMaskF)[r] = (float)m;
    rs(sm, kM2)[r] = -INFINITY;
    rs(sm, kL2)[r] = 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc += sm.w[r * sm.ws + d] * sm.w[r * sm.ws + d];
    acc = warp_sum(acc);
    if (lane == 0) rs(sm, kWW)[r] = acc;
  }
}

// Regions r0 .. r0 + 31 of one image into shared memory (zeros past R).
__device__ void load_chunk(const Smem& sm, const float* ctx, int r0, int R,
                           int D) {
  const int n4 = D / 4;
  for (int i = threadIdx.x; i < kChunk * n4; i += kThreads) {
    const int c = i / n4, q = i % n4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + c < R) v = ld4(ctx + (size_t)(r0 + c) * D + 4 * q);
    st4(sm.ctx + c * (D + 4) + 4 * q, v);
  }
}

// s[row][c] = w[row].ctx[c] * scale + bias[row]; with kDv also
// g[row][c] = dv[row].ctx[c]. A lane owns rows 2p, 2p+1 (p = lane / 8) of
// its warp's 8 and regions q + 8k (q = lane % 8, k < 4): per four columns
// it loads two word rows and four region rows, each one shared-memory
// wavefront (the row strides are odd multiples of 4 floats), for 32 FMAs.
template <bool kDv>
__device__ __forceinline__ void chunk_scores(const Smem& sm, int rows, int D,
                                             float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 7, p = lane >> 3;
  for (int r0 = 0; r0 < rows; r0 += kSweepRows) {
    const int ra = r0 + warp * 8 + 2 * p;          // rows ra, ra + 1
    if (ra >= rows) continue;
    const bool two = ra + 1 < rows;
    const float* wa = sm.w + ra * sm.ws;
    const float* wb = sm.w + (two ? ra + 1 : ra) * sm.ws;
    const float* va = sm.dv + ra * sm.ws;
    const float* vb = sm.dv + (two ? ra + 1 : ra) * sm.ws;
    float acc[2][4], acc2[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = acc2[i][k] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 c[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = ld4(sm.ctx + (q + 8 * k) * (D + 4) + d);
      const float4 w0 = ld4(wa + d), w1 = ld4(wb + d);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[0][k] += dot4(w0, c[k]);
        acc[1][k] += dot4(w1, c[k]);
      }
      if (kDv) {
        const float4 v0 = ld4(va + d), v1 = ld4(vb + d);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc2[0][k] += dot4(v0, c[k]);
          acc2[1][k] += dot4(v1, c[k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + i;
      if (i == 1 && !two) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sm.s[r * kCs + q + 8 * k] = acc[i][k] * scale + rs(sm, kBias)[r];
        if (kDv) sm.g[r * kCs + q + 8 * k] = acc2[i][k];
      }
    }
  }
}

// Softmax #1 in place: s -> a1, over the L words of each (text, region).
__device__ void word_softmax(const Smem& sm, int texts, int L, int nvalid) {
  for (int p = threadIdx.x; p < texts * kChunk; p += kThreads) {
    const int c = p % kChunk;
    if (c >= nvalid) continue;
    float* col = sm.s + (p / kChunk) * L * kCs + c;
    float m = -INFINITY;
    for (int l = 0; l < L; ++l) m = fmaxf(m, col[l * kCs]);
    float sum = 0.f;
    for (int l = 0; l < L; ++l) {
      const float e = expf(col[l * kCs] - m);
      col[l * kCs] = e;
      sum += e;
    }
    const float den = fmaxf(sum, kEps);
    for (int l = 0; l < L; ++l) col[l * kCs] = col[l * kCs] / den;
  }
}

// Online softmax #2, one warp per row: folds this chunk's gamma1 * a1 into
// the running max / sum and leaves exp(t - max) in s and the factor that
// rescales the earlier chunks' sums in alpha.
__device__ void region_softmax_step(const Smem& sm, int rows, int nvalid,
                                    float gamma1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = sm.s + r * kCs;
    const float t = lane < nvalid ? row[lane] * gamma1 : -INFINITY;
    const float m_old = rs(sm, kM2)[r];
    const float m_new = fmaxf(m_old, warp_max(t));
    const float p = lane < nvalid ? expf(t - m_new) : 0.f;
    const float sum = warp_sum(p);
    row[lane] = p;
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      rs(sm, kAlpha)[r] = alpha;
      rs(sm, kL2)[r] = rs(sm, kL2)[r] * alpha + sum;
      rs(sm, kM2)[r] = m_new;
    }
  }
}

// acc[i] (*= alpha[row] if kRescale) += sum_c coef[row][c] * ctx[c], four
// regions at a time (coef and ctx are zero past nvalid).
template <bool kRescale>
__device__ __forceinline__ void chunk_accumulate(
    const Smem& sm, const float* coef, float4 (&acc)[kRowsPerThread],
    int rows, int nvalid, int D) {
  const Lanes ln(D);
  if (kRescale) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ln.row(i);
      if (r < rows) {
        const float a = rs(sm, kAlpha)[r];
        acc[i].x *= a; acc[i].y *= a; acc[i].z *= a; acc[i].w *= a;
      }
    }
  }
  for (int c = 0; c < nvalid; c += 4) {
    float4 cv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cv[k] = ld4(sm.ctx + (c + k) * (D + 4) + 4 * ln.cg);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ln.row(i);
      if (r < rows) {
        const float4 p = ld4(coef + r * kCs + c);
        const float pk[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i].x += pk[k] * cv[k].x; acc[i].y += pk[k] * cv[k].y;
          acc[i].z += pk[k] * cv[k].z; acc[i].w += pk[k] * cv[k].w;
        }
      }
    }
  }
}

// out[row] = sum over the row's D columns of each thread's part[i]; the
// threads of one row are D/4 consecutive ones. Block-wide (syncs).
__device__ __forceinline__ void row_reduce(const Smem& sm, const float (&part)[kRowsPerThread],
                           float* out, int rows, int D) {
  const Lanes ln(D);
  const int width = ln.ncg < 32 ? ln.ncg : 32;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float x = part[i];
    for (int off = width / 2; off > 0; off >>= 1)
      x += __shfl_xor_sync(kFull, x, off);
    const int r = ln.row(i);
    if (r < rows && ln.cg % width == 0) sm.red[r * kRedSlots + ln.cg / 32] = x;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float x = sm.red[r * kRedSlots];
    for (int k = 1; k * 32 < ln.ncg; ++k) x += sm.red[r * kRedSlots + k];
    out[r] = x;
  }
  __syncthreads();
}

// Pass 1: streams the image's regions through the tile; leaves v (not yet
// divided by the softmax #2 sum) in acc and the running max / sum per row.
__device__ __forceinline__ void forward_pass(const Smem& sm, const float* ctx,
                             float4 (&acc)[kRowsPerThread], int texts,
                             int rows, int R, int L, int D, float scale,
                             float gamma1) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int nvalid = min(kChunk, R - r0);
    __syncthreads();  // the previous chunk is consumed
    load_chunk(sm, ctx, r0, R, D);
    __syncthreads();
    chunk_scores<false>(sm, rows, D, scale);
    __syncthreads();
    word_softmax(sm, texts, L, nvalid);
    __syncthreads();
    region_softmax_step(sm, rows, nvalid, gamma1);
    __syncthreads();
    chunk_accumulate<true>(sm, sm.s, acc, rows, nvalid, D);
  }
  __syncthreads();
}

// v = acc / sum; the cosine of each row and its Eq. 10 term exp(gamma2 cos)
// (masked). Leaves v in acc.
__device__ __forceinline__ void cosine_terms(const Smem& sm, float4 (&acc)[kRowsPerThread],
                             int rows, int D, float gamma2) {
  const Lanes ln(D);
  float pn[kRowsPerThread], pv[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ln.row(i);
    pn[i] = pv[i] = 0.f;
    if (r < rows) {
      const float l2 = rs(sm, kL2)[r];
      acc[i].x /= l2; acc[i].y /= l2; acc[i].z /= l2; acc[i].w /= l2;
      pn[i] = dot4(ld4(sm.w + r * sm.ws + 4 * ln.cg), acc[i]);
      pv[i] = dot4(acc[i], acc[i]);
    }
  }
  row_reduce(sm, pn, rs(sm, kNum), rows, D);
  row_reduce(sm, pv, rs(sm, kVV), rows, D);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float wn = sqrtf(rs(sm, kWW)[r]), vn = sqrtf(rs(sm, kVV)[r]);
    const float nc = fmaxf(wn * vn, kEps);
    const float cos = rs(sm, kNum)[r] / nc;
    rs(sm, kExpG)[r] = expf(gamma2 * cos) * rs(sm, kMaskF)[r];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
damsm_fwd_kernel(const float* __restrict__ img, const float* __restrict__ words,
                 const int* __restrict__ mask, float* __restrict__ sims, int Bt,
                 int R, int L, int D, int T, float scale, float gamma1,
                 float gamma2) {
  extern __shared__ float4 smem4[];
  const int j = blockIdx.y;
  const int text0 = blockIdx.x * T;
  const int texts = min(T, Bt - text0);
  const int rows = texts * L;
  const Smem sm = carve(reinterpret_cast<float*>(smem4), T * L, D, false);
  load_tile(sm, words, mask, text0, rows, L, D);
  float4 acc[kRowsPerThread];
  forward_pass(sm, img + (size_t)j * R * D, acc, texts, rows, R, L, D, scale,
               gamma1);
  cosine_terms(sm, acc, rows, D, gamma2);
  for (int t = threadIdx.x; t < texts; t += kThreads) {
    float agg = 0.f;
    for (int l = 0; l < L; ++l) agg += rs(sm, kExpG)[t * L + l];
    sims[(size_t)j * Bt + text0 + t] = logf(agg);
  }
}

// Eq. 10 and the cosine, backwards: per text d_agg (g_row: the cotangent of
// the tile's texts), per word row the scalars of d_v and d_w. Block-wide.
__device__ void words_bwd(const Smem& sm, const float* g_row, int texts,
                          int rows, int L, float gamma2) {
  for (int t = threadIdx.x; t < texts; t += kThreads) {
    float agg = 0.f;
    for (int l = 0; l < L; ++l) agg += rs(sm, kExpG)[t * L + l];
    sm.text[t] = agg > 0.f ? g_row[t] / agg : 0.f;  // texts with no real word
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float wn = sqrtf(rs(sm, kWW)[r]), vn = sqrtf(rs(sm, kVV)[r]);
    const float norms = wn * vn, nc = fmaxf(norms, kEps);
    const float num = rs(sm, kNum)[r];
    const float d_cos = sm.text[r / L] * gamma2 * rs(sm, kExpG)[r];
    const float d_norms = norms > kEps ? -d_cos * num / (nc * nc) : 0.f;
    rs(sm, kDNum)[r] = d_cos / nc;
    rs(sm, kDWn)[r] = d_norms * vn;
    rs(sm, kWnC)[r] = fmaxf(wn, kEps);
    rs(sm, kDVn)[r] = d_norms * wn;
    rs(sm, kVnC)[r] = fmaxf(vn, kEps);
  }
  __syncthreads();
}

// Block (split s, image j) walks text tiles s, s + S, ... < K. d_ctx of
// image j accumulates over them into dctx (its own slice); each tile's d_w
// goes to dw_part[j].
__global__ void __launch_bounds__(kThreads)
damsm_bwd_kernel(const float* __restrict__ img, const float* __restrict__ words,
                 const int* __restrict__ mask, const float* __restrict__ gout,
                 float* __restrict__ dctx, float* __restrict__ dw_part, int Bi,
                 int Bt, int R, int L, int D, int T, int S, float scale,
                 float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  const int s_idx = blockIdx.x, j = blockIdx.y;
  const int K = (Bt + T - 1) / T;
  const float* ctx = img + (size_t)j * R * D;
  float* dctx_j = dctx + ((size_t)s_idx * Bi + j) * R * D;
  const Smem sm = carve(reinterpret_cast<float*>(smem4), T * L, D, true);
  const Lanes ln(D);

  for (int k = s_idx, it = 0; k < K; k += S, ++it) {
    const int text0 = k * T;
    const int texts = min(T, Bt - text0);
    const int rows = texts * L;
    __syncthreads();  // the previous tile is consumed
    load_tile(sm, words, mask, text0, rows, L, D);
    float4 acc[kRowsPerThread];
    forward_pass(sm, ctx, acc, texts, rows, R, L, D, scale, gamma1);
    cosine_terms(sm, acc, rows, D, gamma2);
    words_bwd(sm, gout + (size_t)j * Bt + text0, texts, rows, L, gamma2);
    // d_w = d_num v + d_wn w / |w| (kept in acc, where v was);
    // d_v = d_num w + d_vn v / |v| (to shared memory); row term d_v.v
    float pt[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ln.row(i);
      pt[i] = 0.f;
      if (r < rows) {
        const float dn = rs(sm, kDNum)[r], dwn = rs(sm, kDWn)[r];
        const float wnc = rs(sm, kWnC)[r], dvn = rs(sm, kDVn)[r];
        const float vnc = rs(sm, kVnC)[r];
        const float4 w = ld4(sm.w + r * sm.ws + 4 * ln.cg), v = acc[i];
        const float4 dv = make_float4(
            dn * w.x + dvn * v.x / vnc, dn * w.y + dvn * v.y / vnc,
            dn * w.z + dvn * v.z / vnc, dn * w.w + dvn * v.w / vnc);
        st4(sm.dv + r * sm.ws + 4 * ln.cg, dv);
        pt[i] = dot4(dv, v);
        acc[i] = make_float4(dn * v.x + dwn * w.x / wnc, dn * v.y + dwn * w.y / wnc,
                             dn * v.z + dwn * w.z / wnc, dn * v.w + dwn * w.w / wnc);
      }
    }
    row_reduce(sm, pt, rs(sm, kRowT), rows, D);

    // pass 2: the regions again, chunk by chunk
    for (int r0 = 0; r0 < R; r0 += kChunk) {
      const int nvalid = min(kChunk, R - r0);
      __syncthreads();
      load_chunk(sm, ctx, r0, R, D);
      __syncthreads();
      chunk_scores<true>(sm, rows, D, scale);  // s and d_a2 = d_v . ctx
      __syncthreads();
      // per (text, region): a1, a2, d_a1, then d_s over the text's words
      for (int p = threadIdx.x; p < texts * kChunk; p += kThreads) {
        const int c = p % kChunk, base = (p / kChunk) * L;
        if (c >= nvalid) {
          for (int l = 0; l < L; ++l) {
            sm.a2[(base + l) * kCs + c] = 0.f;
            sm.g[(base + l) * kCs + c] = 0.f;
          }
          continue;
        }
        float m = -INFINITY;
        for (int l = 0; l < L; ++l) m = fmaxf(m, sm.s[(base + l) * kCs + c]);
        float sum = 0.f;
        for (int l = 0; l < L; ++l) {
          float* sp = sm.s + (base + l) * kCs + c;
          *sp = expf(*sp - m);
          sum += *sp;
        }
        const float den = fmaxf(sum, kEps);
        float inner = 0.f;
        for (int l = 0; l < L; ++l) {
          const int r = base + l;
          const float a1 = sm.s[r * kCs + c] / den;
          const float a2 =
              expf(a1 * gamma1 - rs(sm, kM2)[r]) / rs(sm, kL2)[r];
          const float d_a1 =
              a2 * (sm.g[r * kCs + c] - rs(sm, kRowT)[r]) * gamma1;
          sm.s[r * kCs + c] = a1;
          sm.a2[r * kCs + c] = a2;
          sm.g[r * kCs + c] = d_a1;
          inner += d_a1 * a1;
        }
        for (int l = 0; l < L; ++l) {
          const int r = base + l;
          sm.g[r * kCs + c] = scale * (sm.s[r * kCs + c] * (sm.g[r * kCs + c] - inner));
        }
      }
      __syncthreads();
      // d_ctx rows of this chunk: sum over the tile's rows of
      // a2 d_v + scale d_s w. The thread owns four columns of cpt
      // consecutive regions (8 at D = 256), read four at a time; a2 and
      // d_s are zero past nvalid.
      {
        const int cpt = ln.RG < kChunk ? kChunk / ln.RG : 1;
        const int c0 = ln.rg * cpt;
        float4 dc[kChunkPerThread];
#pragma unroll
        for (int k2 = 0; k2 < kChunkPerThread; ++k2)
          dc[k2] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < rows && c0 < kChunk; ++r) {
          const float4 dv = ld4(sm.dv + r * sm.ws + 4 * ln.cg);
          const float4 w = ld4(sm.w + r * sm.ws + 4 * ln.cg);
          const float* ar = sm.a2 + r * kCs + c0;
          const float* gr = sm.g + r * kCs + c0;
          float a[kChunkPerThread], gs[kChunkPerThread];
          if (cpt >= 4) {
#pragma unroll
            for (int k4 = 0; k4 < kChunkPerThread; k4 += 4) {
              if (k4 < cpt) {
                const float4 av = ld4(ar + k4), gv = ld4(gr + k4);
                a[k4] = av.x; a[k4 + 1] = av.y; a[k4 + 2] = av.z; a[k4 + 3] = av.w;
                gs[k4] = gv.x; gs[k4 + 1] = gv.y; gs[k4 + 2] = gv.z; gs[k4 + 3] = gv.w;
              }
            }
          } else {
#pragma unroll
            for (int k2 = 0; k2 < kChunkPerThread; ++k2)
              if (k2 < cpt) { a[k2] = ar[k2]; gs[k2] = gr[k2]; }
          }
#pragma unroll
          for (int k2 = 0; k2 < kChunkPerThread; ++k2) {
            if (k2 < cpt) {
              dc[k2].x += a[k2] * dv.x + gs[k2] * w.x;
              dc[k2].y += a[k2] * dv.y + gs[k2] * w.y;
              dc[k2].z += a[k2] * dv.z + gs[k2] * w.z;
              dc[k2].w += a[k2] * dv.w + gs[k2] * w.w;
            }
          }
        }
#pragma unroll
        for (int k2 = 0; k2 < kChunkPerThread; ++k2) {
          const int c = c0 + k2;
          if (k2 < cpt && c < nvalid) {
            float* out = dctx_j + (size_t)(r0 + c) * D + 4 * ln.cg;
            float4 v = dc[k2];
            if (it > 0) {  // this thread wrote it for the previous tile
              const float4 o = ld4(out);
              v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
            }
            st4(out, v);
          }
        }
      }
      // d_w += scale d_s . ctx (scale already in g)
      chunk_accumulate<false>(sm, sm.g, acc, rows, nvalid, D);
    }
    // this (image, tile)'s d_w
    float* dw = dw_part + ((size_t)j * Bt + text0) * L * D;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ln.row(i);
      if (r < rows) st4(dw + (size_t)r * D + 4 * ln.cg, acc[i]);
    }
  }
}

// d_words = sum over images j (in order) of dw_part[j]; with S > 1 also
// d_img = sum over splits s (in order) of dctx_part[s].
__global__ void __launch_bounds__(kThreads)
damsm_bwd_reduce_kernel(const float4* __restrict__ dw_part,
                        float4* __restrict__ d_words, size_t nw4, int Bi,
                        const float4* __restrict__ dctx_part,
                        float4* __restrict__ d_img, size_t ni4, int S) {
  const size_t total = nw4 + (S > 1 ? ni4 : 0);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* src;
    int n;
    size_t stride, at;
    if (i < nw4) {
      src = dw_part; n = Bi; stride = nw4; at = i;
    } else {
      src = dctx_part; n = S; stride = ni4; at = i - nw4;
    }
    for (int k = 0; k < n; ++k) {
      const float4 v = src[k * stride + at];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    (i < nw4 ? d_words : d_img)[at] = acc;
  }
}

// ---- the backward pass on the tensor cores (3xTF32 mma.sync) -------------

constexpr int kTcRows = 64;                 // a warp's share of a (rows x D)
constexpr int kTcCols = 32;                 // array: 4 x 4 m16n8 tiles
constexpr int kTcSlots = kMaxD / kTcCols;   // warps sharing one row (8)

// x = hi + lo, hi with 11 significant bits (a TF32 value: its low 13 bits
// zero) and lo = x - hi exactly: Veltkamp's split, four full-rate fp32
// operations (a cvt.rna.tf32 conversion each for hi and lo ran a quarter
// of the products' time slower). The tensor cores read lo's top 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float t = __fmul_rn(x, 8193.f);  // 2^13 + 1; _rn: never contracted
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Operand fragments of one m16n8k8 step at depth k0, read from shared
// memory (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, t = lane % 4):
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// A stored [m][k] with row stride sa:
__device__ __forceinline__ void frag_a(const float* p, int sa, int k0,
                                       float (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const float* q = p + (lane >> 2) * sa + k0 + (lane & 3);
  a[0] = q[0];
  a[1] = q[8 * sa];
  a[2] = q[4];
  a[3] = q[8 * sa + 4];
}
// A stored [k][m] with row stride sa:
__device__ __forceinline__ void frag_a_t(const float* p, int sa, int k0,
                                         float (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const float* q = p + (k0 + (lane & 3)) * sa + (lane >> 2);
  a[0] = q[0];
  a[1] = q[8];
  a[2] = q[4 * sa];
  a[3] = q[4 * sa + 8];
}
// B stored [k][n] with row stride sb:
__device__ __forceinline__ void frag_b(const float* p, int sb, int k0,
                                       float (&b)[2]) {
  const int lane = threadIdx.x & 31;
  const float* q = p + (k0 + (lane & 3)) * sb + (lane >> 2);
  b[0] = q[0];
  b[1] = q[4 * sb];
}
// A stored [m][k] and B stored [n][k] (a product over a contiguous depth),
// the depth taken in pair order: a lane's depths t and t + 4 are the
// adjacent floats 2t, 2t + 1, one 8-byte load (the same order for A and B,
// so the product is unchanged). Row strides of 8 mod 32 floats put a
// half-warp's loads on 32 distinct banks.
__device__ __forceinline__ void frag_a_pairs(const float* p, int sa, int k0,
                                             float (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const float* q = p + (lane >> 2) * sa + k0 + 2 * (lane & 3);
  const float2 x = ld2(q), y = ld2(q + 8 * sa);
  a[0] = x.x;
  a[1] = y.x;
  a[2] = x.y;
  a[3] = y.y;
}
__device__ __forceinline__ void frag_b_pairs(const float* p, int sb, int k0,
                                             float (&b)[2]) {
  const int lane = threadIdx.x & 31;
  const float2 x = ld2(p + (lane >> 2) * sb + k0 + 2 * (lane & 3));
  b[0] = x.x;
  b[1] = x.y;
}

template <int MW, int NW, bool kFull, class FA, class FB>
__device__ __forceinline__ void mma3_steps(float (&acc)[MW][NW][4], int mw,
                                           int nw, int kn, FA fa, FB fb) {
#pragma unroll 1
  for (int k0 = 0; k0 < kn; k0 += 8) {
    uint32_t ah[MW][4], al[MW][4], bh[NW][2], bl[NW][2];
#pragma unroll
    for (int i = 0; i < MW; ++i)
      if (kFull || i < mw) {
        float a[4];
        fa(i, k0, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[i][e], al[i][e]);
      }
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (kFull || j < nw) {
        float b[2];
        fb(j, k0, b);
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[1], bh[j][1], bl[j][1]);
      }
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (kFull || (i < mw && j < nw)) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (kFull || (i < mw && j < nw)) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (kFull || (i < mw && j < nw)) mma_tf32(acc[i][j], ah[i], bh[j]);
  }
}

// acc[i][j] += A_i B_j over depth [0, kn) (kn a multiple of 8) in 3xTF32:
// each operand is split once, as loaded, into hi + lo, and a step adds
// lo.hi, then hi.lo, then hi.hi (lo.lo, ~2^-22 relative, is dropped),
// each of the three over every tile before the next, so that an mma does
// not wait on the one before it. fa(i, k0, a) loads the A fragment of the
// warp's m16 tile i, fb(j, k0, b) the B fragment of its n8 tile j. Tiles
// i >= mw, j >= nw are skipped; a full set takes a path without the
// guards. (Prefetching the next step's fragments, or three accumulator
// chains per tile, cost registers that ptxas then spilled: both slower.)
template <int MW, int NW, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[MW][NW][4], int mw, int nw,
                                     int kn, FA fa, FB fb) {
  if (mw == MW && nw == NW)
    mma3_steps<MW, NW, true>(acc, mw, nw, kn, fa, fb);
  else
    mma3_steps<MW, NW, false>(acc, mw, nw, kn, fa, fb);
}

// The thread's rows and columns of its warp's 64 x 32 share of a (rows x D)
// array held as acc[i][j][e]: row row0 + 16i + g + 8(e / 2), column
// col0 + 8j + 2t + e % 2. Warp w holds rows 64 (w / (D/32)) and columns
// 32 (w % (D/32)) onwards: rows * D <= kTileFloats fits 8 warps.
struct TcTile {
  int g, t, wn, ncol, row0, col0;
  __device__ explicit TcTile(int D) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    ncol = D / kTcCols;
    wn = warp % ncol;
    row0 = kTcRows * (warp / ncol);
    col0 = kTcCols * wn;
  }
  __device__ int row(int i, int h) const { return row0 + 16 * i + g + 8 * h; }
  __device__ int col(int j) const { return col0 + 8 * j + 2 * t; }
  // m16 tiles of the share that hold rows below `rows`
  __device__ int tiles(int rows) const {
    return min(4, max(0, (rows - row0 + 15) / 16));
  }
};

constexpr int kTcMaxRows = 64;  // word rows of a tensor-core tile (4 m16)
constexpr int kTcMaxL = 8;      // words of a text its softmaxes hold in
                                // registers (DataConfig.max_seqlen)

// The tensor-core kernels' shared memory, in floats: w and (backward) dv
// [nr][D + 8] (rows padded to the pair-order loads' stride), a ring of two
// region chunks [2][kChunk][D + 8], s and (backward) g [nr][kCs] (pass 2
// leaves a2 in s), the row scalars, the texts' d_agg and tc_row_reduce's
// slots. The forward has no dv and no g: 149 KB at nr = 64, D = 256.
__host__ __device__ inline size_t smem_floats_tc(int nr, int D, bool bwd) {
  const int arrays = bwd ? 2 : 1;
  return (size_t)(arrays * nr + 2 * kChunk) * (D + 8) +
         arrays * (size_t)nr * kCs +
         (size_t)nr * (kNumRowScalars + 1 + 2 * kTcSlots);
}

__device__ inline Smem carve_tc(float* base, int nr, int D, bool bwd,
                                float*& red) {
  Smem sm;
  sm.nr = nr;
  sm.ws = D + 8;
  sm.w = base;
  sm.dv = bwd ? sm.w + (size_t)nr * sm.ws : nullptr;
  // ring stage 0; stage 1 follows
  sm.ctx = sm.w + (size_t)(bwd ? 2 : 1) * nr * sm.ws;
  sm.s = sm.ctx + 2 * (size_t)kChunk * sm.ws;
  sm.a2 = sm.s;
  sm.g = bwd ? sm.s + (size_t)nr * kCs : nullptr;
  sm.rs = sm.s + (size_t)(bwd ? 2 : 1) * nr * kCs;
  sm.text = sm.rs + (size_t)kNumRowScalars * nr;
  sm.red = nullptr;
  red = sm.text + nr;
  return sm;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Regions r0 .. r0 + 31 of one image into a ring stage (rows of ws floats,
// zeros past R), as one cp.async group of 16-byte copies.
__device__ __forceinline__ void tc_issue_chunk(float* stage, int ws,
                                               const float* ctx, int r0,
                                               int R, int D) {
  const int n4 = D / 4, q = threadIdx.x % n4;  // D / 4 divides kThreads
  const uint32_t dst = smem_addr(stage) + 16 * q;
  for (int c = threadIdx.x / n4; c < kChunk; c += kThreads / n4) {
    const bool in = r0 + c < R;
    const float* src = ctx + (size_t)(in ? r0 + c : 0) * D + 4 * q;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + 4 * c * ws),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// s[row][c] = w[row].ctx[c] * scale + bias[row] and, with kDv,
// g[row][c] = dv[row].ctx[c], over the chunk cb. Warps 2i and 2i + 1 own
// m16 tile i (16 rows x the 32 regions, n8 tiles wholly past nvalid
// skipped) and the two halves of the depth D; the second half's sums go to
// s and g, where the first adds them after a barrier (a fixed order). With
// kDv one M = 2 x 16 product, so a ctx fragment serves w and d_v. Rows
// from `rows` to the next multiple of 16 get zeros.
template <bool kDv>
__device__ __forceinline__ void tc_scores(const Smem& sm, const float* cb,
                                          int rows, int nvalid, float scale) {
  constexpr int MW = kDv ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp & 1, m0 = 16 * (warp >> 1), kh = (sm.ws - 8) / 2;
  const int nt = (nvalid + 7) / 8;
  const bool active = m0 < rows;
  float acc[MW][4][4] = {};
  if (active) {
    const float* wa = sm.w + m0 * sm.ws + half * kh;
    const float* va = sm.dv + m0 * sm.ws + half * kh;
    const float* ch = cb + half * kh;
    mma3<MW, 4>(
        acc, MW, nt, kh,
        [&](int i, int k0, float (&a)[4]) {
          frag_a_pairs(i == 0 ? wa : va, sm.ws, k0, a);
        },
        [&](int j, int k0, float (&b)[2]) {
          frag_b_pairs(ch + 8 * j * sm.ws, sm.ws, k0, b);
        });
  }
  float* const out[2] = {sm.s, sm.g};
  if (active && half == 1) {
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (j < nt)
            st2(out[i] + (m0 + g + 8 * h) * kCs + 8 * j + 2 * t,
                acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  __syncthreads();
  if (active && half == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      const bool in = r < rows;
      const float b = in ? rs(sm, kBias)[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nt) continue;
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          float* p = out[i] + r * kCs + c;
          const float2 o = ld2(p);
          float x = acc[i][j][2 * h] + o.x, y = acc[i][j][2 * h + 1] + o.y;
          if (i == 0) {
            x = x * scale + b;
            y = y * scale + b;
          }
          st2(p, in ? x : 0.f, in ? y : 0.f);
        }
      }
    }
  }
}

// acc += coef . ctx over the chunk cb's regions (coef [row][kCs], zero
// past nvalid and in the rows past the tile's up to the next multiple of
// 16). k8 steps wholly past nvalid skipped.
__device__ __forceinline__ void tc_accumulate(const Smem& sm, const TcTile& tl,
                                              const float* cb,
                                              const float* coef,
                                              float (&acc)[4][4][4], int rows,
                                              int nvalid) {
  const float* cc = cb + tl.col0;
  const float* ab = coef + tl.row0 * kCs;
  mma3<4, 4>(
      acc, tl.tiles(rows), 4, (nvalid + 7) & ~7,
      [&](int i, int k0, float (&a)[4]) {
        frag_a(ab + 16 * i * kCs, kCs, k0, a);
      },
      [&](int j, int k0, float (&b)[2]) { frag_b(cc + 8 * j, sm.ws, k0, b); });
}

// Softmax #1 of one (text, region): the text's L scores of region `lane`
// (rows base ..) to a1 = e1 / max(sum, 1e-8), in x (one reciprocal, then
// a product per word: a rounding apart from the plain version's quotient;
// both passes use this one function, so they agree).
__device__ __forceinline__ void text_a1(const Smem& sm, int base, int L,
                                        float (&x)[kTcMaxL]) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
#pragma unroll
  for (int l = 0; l < kTcMaxL; ++l)
    if (l < L) {
      x[l] = sm.s[(base + l) * kCs + lane];
      m = fmaxf(m, x[l]);
    }
  float sum = 0.f;
#pragma unroll
  for (int l = 0; l < kTcMaxL; ++l)
    if (l < L) {
      x[l] = expf(x[l] - m);
      sum += x[l];
    }
  const float inv = 1.f / fmaxf(sum, kEps);
#pragma unroll
  for (int l = 0; l < kTcMaxL; ++l)
    if (l < L) x[l] *= inv;
}

// Pass 1's softmaxes for one chunk, a warp per text and a lane per region:
// softmax #1 in registers, then the online step of softmax #2 per word row
// (shuffles over the chunk's regions, the L rows' reductions interleaved),
// leaving exp(t - max) in s and the rescale factor of the earlier chunks'
// sums in alpha (lane l updates row l's scalars).
__device__ __forceinline__ void tc_softmax_fwd(const Smem& sm, int texts,
                                               int L, int nvalid,
                                               float gamma1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool cv = lane < nvalid;
  for (int tx = warp; tx < texts; tx += kWarps) {
    const int base = tx * L;
    float x[kTcMaxL], m_old[kTcMaxL], m[kTcMaxL], sum[kTcMaxL];
    text_a1(sm, base, L, x);
#pragma unroll
    for (int l = 0; l < kTcMaxL; ++l) {
      x[l] = cv && l < L ? x[l] * gamma1 : -INFINITY;
      m[l] = x[l];
      m_old[l] = l < L ? rs(sm, kM2)[base + l] : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int l = 0; l < kTcMaxL; ++l)
        m[l] = fmaxf(m[l], __shfl_xor_sync(kFull, m[l], off));
#pragma unroll
    for (int l = 0; l < kTcMaxL; ++l) {
      m[l] = fmaxf(m_old[l], m[l]);            // the new running max
      x[l] = cv ? expf(x[l] - m[l]) : 0.f;     // p
      sum[l] = x[l];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int l = 0; l < kTcMaxL; ++l)
        sum[l] += __shfl_xor_sync(kFull, sum[l], off);
#pragma unroll
    for (int l = 0; l < kTcMaxL; ++l) {
      if (l >= L) break;
      const int r = base + l;
      sm.s[r * kCs + lane] = x[l];
      if (lane == l) {
        const float alpha = expf(m_old[l] - m[l]);
        rs(sm, kAlpha)[r] = alpha;
        rs(sm, kL2)[r] = rs(sm, kL2)[r] * alpha + sum[l];
        rs(sm, kM2)[r] = m[l];
      }
    }
  }
}

// Pass 2's chain for one chunk, a warp per text and a lane per region:
// from the scores in s and d_a2 in g, leaves a2 in s and scale * d_s in g
// (zeros past nvalid), as damsm_bwd_kernel's pass 2 does (every load before any store).
__device__ __forceinline__ void tc_chunk_bwd(const Smem& sm, int texts, int L,
                                             int nvalid, float gamma1,
                                             float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool cv = lane < nvalid;
  for (int tx = warp; tx < texts; tx += kWarps) {
    const int base = tx * L;
    float x[kTcMaxL], a2[kTcMaxL], d[kTcMaxL];
    text_a1(sm, base, L, x);
    float inner = 0.f;
#pragma unroll
    for (int l = 0; l < kTcMaxL; ++l)
      if (l < L) {
        const int r = base + l;
        a2[l] = expf(x[l] * gamma1 - rs(sm, kM2)[r]) / rs(sm, kL2)[r];
        d[l] = a2[l] * (sm.g[r * kCs + lane] - rs(sm, kRowT)[r]) * gamma1;
        inner += d[l] * x[l];
      }
#pragma unroll
    for (int l = 0; l < kTcMaxL; ++l)
      if (l < L) {
        const int r = base + l;
        sm.s[r * kCs + lane] = cv ? a2[l] : 0.f;
        sm.g[r * kCs + lane] = cv ? scale * (x[l] * (d[l] - inner)) : 0.f;
      }
  }
}

// out_p[row] = sum over the row's D columns of part[p] (the thread's two
// rows per m16 tile): over the lane quad by shuffles, then over the D/32
// warps of the row in a fixed order. red holds NP x nr x kTcSlots floats.
// Block-wide (syncs).
template <int NP>
__device__ __forceinline__ void tc_row_reduce(const Smem& sm, const TcTile& tl,
                                              float* red,
                                              float (&part)[NP][4][2],
                                              float* const (&out)[NP],
                                              int rows) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = part[p][i][h];
        x += __shfl_xor_sync(kFull, x, 1);
        x += __shfl_xor_sync(kFull, x, 2);
        const int r = tl.row(i, h);
        if (tl.t == 0 && r < rows)
          red[(p * sm.nr + r) * kTcSlots + tl.wn] = x;
      }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float* x = red + (p * sm.nr + r) * kTcSlots;
      float sum = x[0];
      for (int k = 1; k < tl.ncol; ++k) sum += x[k];
      out[p][r] = sum;
    }
  __syncthreads();
}

// Built with -DDAMSM_PHASE_CLOCKS (attngan_torch/tools/damsm_phases.py),
// thread 0 of each block of the tensor-core kernels adds the cycles of each
// phase to g_phase_cycles; PHASE_SYNC adds a barrier first, so that the
// phase ends for every warp. Without the flag both are empty, and the
// clock (passed to tc_pass1) is an empty struct.
#ifdef DAMSM_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[16];
struct PhaseClock {
  long long last;
  __device__ void mark(int k) {
    const long long now = clock64();
    if (threadIdx.x == 0)
      atomicAdd(&g_phase_cycles[k], (unsigned long long)(now - last));
    last = now;
  }
};
#define PHASE_CLOCK PhaseClock clock{clock64()}
#define PHASE(k) clock.mark(k)
#define PHASE_SYNC(k) (__syncthreads(), clock.mark(k))
#else
struct PhaseClock {};
#define PHASE_CLOCK PhaseClock clock
#define PHASE(k) ((void)0)
#define PHASE_SYNC(k) ((void)0)
#endif

// Pass 1 of the chain for one tile on the tensor cores, and its cosine
// terms: the tile's texts against every chunk of the image that
// next_chunk() hands out (it waits for the chunk and puts the next one in
// flight), leaving v = a2 . ctx in acc (TcTile layout; acc zero on entry)
// and per row w.v (kNum), v.v (kVV) and Eq. 10's term mask exp(gamma2 cos)
// (kExpG). The forward and the backward's recompute run this one function,
// so they give the same values. Block-wide; ends with a barrier.
template <class NextChunk>
__device__ __forceinline__ void tc_pass1(const Smem& sm, const TcTile& tl,
                                         float* red, NextChunk& next_chunk,
                                         PhaseClock& clock,
                                         float (&acc)[4][4][4], int texts,
                                         int rows, int R, int L, float scale,
                                         float gamma1, float gamma2) {
  const int mw = tl.tiles(rows);
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int nvalid = min(kChunk, R - r0);
    const float* cb = next_chunk();
    PHASE(1);
    tc_scores<false>(sm, cb, rows, nvalid, scale);
    __syncthreads();
    PHASE(2);
    tc_softmax_fwd(sm, texts, L, nvalid, gamma1);
    __syncthreads();
    PHASE(3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tl.row(i, h);
        const float a = i < mw && r < rows ? rs(sm, kAlpha)[r] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c][2 * h] *= a;
          acc[i][c][2 * h + 1] *= a;
        }
      }
    tc_accumulate(sm, tl, cb, sm.s, acc, rows, nvalid);
    PHASE_SYNC(4);
  }

  // v = acc / sum; per row w.v and v.v, then the cosine's Eq. 10 term
  {
    float part[2][4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tl.row(i, h);
        const bool in = i < mw && r < rows;
        const float inv = in ? 1.f / rs(sm, kL2)[r] : 1.f;
        float pn = 0.f, pv = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[i][c][2 * h + e] * inv;
            acc[i][c][2 * h + e] = v;
            if (in) pn += sm.w[r * sm.ws + tl.col(c) + e] * v;
            pv += v * v;
          }
        part[0][i][h] = pn;
        part[1][i][h] = pv;
      }
    float* const out[2] = {rs(sm, kNum), rs(sm, kVV)};
    tc_row_reduce<2>(sm, tl, red, part, out, rows);
  }
  PHASE(5);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float wn = sqrtf(rs(sm, kWW)[r]), vn = sqrtf(rs(sm, kVV)[r]);
    const float cos = rs(sm, kNum)[r] / fmaxf(wn * vn, kEps);
    rs(sm, kExpG)[r] = expf(gamma2 * cos) * rs(sm, kMaskF)[r];
  }
  __syncthreads();
}

// The same pass as damsm_bwd_kernel, its products on the tensor cores
// (mma3) with v and then d_w in the mma accumulators (TcTile layout), its
// softmaxes a warp per text, and the image's chunks streamed through a
// two-stage cp.async ring (the chunk after the one being computed is in
// flight: the stream runs through both passes and every tile of the
// block, which all walk the same image). Tiles hold at most kTcMaxRows
// word rows, padded to nr, a multiple of 16; padded rows read as zero
// wherever a product sums over rows. D is a template parameter (the D
// argument is unused): strides and addresses are then constants, where a
// runtime D left ptxas spilling the addresses it hoists.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_tc_kernel(const float* __restrict__ img,
                    const float* __restrict__ words,
                    const int* __restrict__ mask,
                    const float* __restrict__ gout, float* __restrict__ dctx,
                    float* __restrict__ dw_part, int Bi, int Bt, int R, int L,
                    int, int T, int S, float scale, float gamma1,
                    float gamma2) {
  extern __shared__ float4 smem4[];
  const int s_idx = blockIdx.x, j = blockIdx.y;
  const int K = (Bt + T - 1) / T;
  const int nr = (T * L + 15) & ~15;
  const float* ctx = img + (size_t)j * R * D;
  float* dctx_j = dctx + ((size_t)s_idx * Bi + j) * R * D;
  float* red;
  const Smem sm = carve_tc(reinterpret_cast<float*>(smem4), nr, D, true, red);
  const TcTile tl(D);
  const int warp = threadIdx.x >> 5;
  PHASE_CLOCK;

  // the chunk stream: chunks 0 .. nc - 1 twice per tile
  const int nc = (R + kChunk - 1) / kChunk;
  const int total = 2 * nc * ((K - s_idx + S - 1) / S);
  int n = 0;
  tc_issue_chunk(sm.ctx, sm.ws, ctx, 0, R, D);
  // waits for chunk n, frees the stage of chunk n - 1 (the barrier), puts
  // chunk n + 1 in flight there; returns chunk n's stage
  auto next_chunk = [&]() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (n + 1 < total)
      tc_issue_chunk(sm.ctx + ((n + 1) & 1) * kChunk * sm.ws, sm.ws, ctx,
                     (n + 1) % nc * kChunk, R, D);
    return sm.ctx + (n++ & 1) * kChunk * sm.ws;
  };

  for (int k = s_idx, it = 0; k < K; k += S, ++it) {
    const int text0 = k * T;
    const int texts = min(T, Bt - text0);
    const int rows = texts * L;
    const int mw = tl.tiles(rows);
    __syncthreads();  // the previous tile is consumed
    load_tile(sm, words, mask, text0, rows, L, D);
    // rows past the tile's read as zero in the products over rows
    for (int i = threadIdx.x; i < (nr - rows) * sm.ws; i += kThreads)
      sm.w[rows * sm.ws + i] = 0.f;
    for (int i = threadIdx.x; i < (nr - rows) * kCs; i += kThreads)
      sm.s[rows * kCs + i] = sm.g[rows * kCs + i] = 0.f;
    PHASE_SYNC(0);

    // pass 1: v in acc, the cosine terms per row
    float acc[4][4][4] = {};
    tc_pass1(sm, tl, red, next_chunk, clock, acc, texts, rows, R, L, scale,
             gamma1, gamma2);
    words_bwd(sm, gout + (size_t)j * Bt + text0, texts, rows, L, gamma2);
    PHASE(12);

    // d_w = d_num v + d_wn w / |w| (in acc, where v was);
    // d_v = d_num w + d_vn v / |v| (to shared memory); row term d_v.v
    {
      float part[1][4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tl.row(i, h);
          const bool in = i < mw && r < rows;
          float dn = 0.f, qw = 0.f, qv = 0.f;  // d_wn / |w|, d_vn / |v|
          if (in) {
            dn = rs(sm, kDNum)[r];
            qw = rs(sm, kDWn)[r] / rs(sm, kWnC)[r];
            qv = rs(sm, kDVn)[r] / rs(sm, kVnC)[r];
          }
          float pt = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float w = in ? sm.w[r * sm.ws + tl.col(c) + e] : 0.f;
              const float v = acc[i][c][2 * h + e];
              dv[e] = dn * w + qv * v;
              pt += dv[e] * v;
              acc[i][c][2 * h + e] = dn * v + qw * w;
            }
            if (r < nr) st2(sm.dv + r * sm.ws + tl.col(c), dv[0], dv[1]);
          }
          part[0][i][h] = pt;
        }
      float* const out[1] = {rs(sm, kRowT)};
      tc_row_reduce<1>(sm, tl, red, part, out, rows);
    }
    PHASE(13);

    // pass 2: the regions again, chunk by chunk
    for (int r0 = 0; r0 < R; r0 += kChunk) {
      const int nvalid = min(kChunk, R - r0);
      const float* cb = next_chunk();
      PHASE(6);
      tc_scores<true>(sm, cb, rows, nvalid, scale);  // s and d_a2 = d_v . ctx
      __syncthreads();
      PHASE(7);
      tc_chunk_bwd(sm, texts, L, nvalid, gamma1, scale);
      __syncthreads();
      PHASE(8);
      // d_ctx rows of the chunk: a2^T d_v + (scale d_s)^T w, a K = 2 x rows
      // product; warp w < D/32 owns columns 32w.. of all 32 regions (the
      // second m16 tile skipped when nvalid <= 16).
      if (warp < tl.ncol) {
        float dc[2][4][4] = {};
        const int mr = nvalid > 16 ? 2 : 1, kn = (rows + 7) & ~7;
        const float* const coef[2] = {sm.a2, sm.g};
        const float* const rowv[2] = {sm.dv + tl.col0, sm.w + tl.col0};
#pragma unroll
        for (int p = 0; p < 2; ++p)
          mma3<2, 4>(
              dc, mr, 4, kn,
              [&](int i, int k0, float (&a)[4]) {
                frag_a_t(coef[p] + 16 * i, kCs, k0, a);
              },
              [&](int jj, int k0, float (&b)[2]) {
                frag_b(rowv[p] + 8 * jj, sm.ws, k0, b);
              });
        PHASE(14);
        // add what this thread wrote for the previous tiles, a 16-region
        // half at a time: its loads first (one round trip to L2, where
        // load-store pairs through one pointer would each wait on the
        // store before), then its stores
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2 old[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 16 * i + tl.g + 8 * h;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              old[h][jj] = it > 0 && i < mr && c < nvalid
                               ? ld2(dctx_j + (size_t)(r0 + c) * D +
                                     tl.col(jj))
                               : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 16 * i + tl.g + 8 * h;
            if (i >= mr || c >= nvalid) continue;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              st2(dctx_j + (size_t)(r0 + c) * D + tl.col(jj),
                  old[h][jj].x + dc[i][jj][2 * h],
                  old[h][jj].y + dc[i][jj][2 * h + 1]);
          }
        }
      }
      PHASE_SYNC(9);
      // d_w += scale d_s . ctx (scale already in g)
      tc_accumulate(sm, tl, cb, sm.g, acc, rows, nvalid);
      PHASE_SYNC(10);
    }
    // this (image, tile)'s d_w
    float* dw = dw_part + ((size_t)j * Bt + text0) * L * D;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tl.row(i, h);
        if (i >= mw || r >= rows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st2(dw + (size_t)r * D + tl.col(c), acc[i][c][2 * h],
              acc[i][c][2 * h + 1]);
      }
    PHASE_SYNC(11);
  }
}

// The forward (K4) on the tensor cores: the backward's pass 1 and cosine
// terms (tc_pass1), then Eq. 10 per text. Block (split s, image j) walks
// the text tiles s, s + S, ... < K, as the backward does, with the
// image's chunks streaming through the two-stage cp.async ring across
// every tile of the block (once per tile). Same tiles, padding and D
// template as the backward; one block per SM (149 KB of shared memory).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
damsm_fwd_tc_kernel(const float* __restrict__ img,
                    const float* __restrict__ words,
                    const int* __restrict__ mask, float* __restrict__ sims,
                    int Bt, int R, int L, int T, int S, float scale,
                    float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  const int s_idx = blockIdx.x, j = blockIdx.y;
  const int K = (Bt + T - 1) / T;
  const int nr = (T * L + 15) & ~15;
  const float* ctx = img + (size_t)j * R * D;
  float* red;
  const Smem sm = carve_tc(reinterpret_cast<float*>(smem4), nr, D, false,
                           red);
  const TcTile tl(D);
  PHASE_CLOCK;

  // the chunk stream: chunks 0 .. nc - 1 once per tile
  const int nc = (R + kChunk - 1) / kChunk;
  const int total = nc * ((K - s_idx + S - 1) / S);
  int n = 0;
  tc_issue_chunk(sm.ctx, sm.ws, ctx, 0, R, D);
  auto next_chunk = [&]() {  // as in damsm_bwd_tc_kernel
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (n + 1 < total)
      tc_issue_chunk(sm.ctx + ((n + 1) & 1) * kChunk * sm.ws, sm.ws, ctx,
                     (n + 1) % nc * kChunk, R, D);
    return sm.ctx + (n++ & 1) * kChunk * sm.ws;
  };

  for (int k = s_idx; k < K; k += S) {
    const int text0 = k * T;
    const int texts = min(T, Bt - text0);
    const int rows = texts * L;
    __syncthreads();  // the previous tile is consumed
    load_tile(sm, words, mask, text0, rows, L, D);
    for (int i = threadIdx.x; i < (nr - rows) * sm.ws; i += kThreads)
      sm.w[rows * sm.ws + i] = 0.f;  // pad rows: zeros in every product
    PHASE_SYNC(0);
    float acc[4][4][4] = {};
    tc_pass1(sm, tl, red, next_chunk, clock, acc, texts, rows, R, L, scale,
             gamma1, gamma2);
    for (int t = threadIdx.x; t < texts; t += kThreads) {
      float agg = 0.f;
      for (int l = 0; l < L; ++l) agg += rs(sm, kExpG)[t * L + l];
      sims[(size_t)j * Bt + text0 + t] = logf(agg);
    }
    PHASE(12);
  }
}

// The tensor-core kernels take D a multiple of kTcCols (32 .. 256: a warp
// owns 32 columns of the word rows), texts of at most kTcMaxL words and
// tiles of at most kTcMaxRows rows; the wrapper (ops/cuda_damsm.py,
// takes_tc and plan) chooses them by these shapes and plans their tiles.
bool takes_tc(int L, int D, int T) {
  return D % kTcCols == 0 && L <= kTcMaxL && T * L <= kTcMaxRows;
}

bool valid_dims(int Bi, int Bt, int R, int L, int D, int T) {
  const bool pow2 = D >= 4 && D <= kMaxD && (D & (D - 1)) == 0;
  const int cap = kTileFloats / D < kMaxRows ? kTileFloats / D : kMaxRows;
  return pow2 && Bi >= 1 && Bt >= 1 && R >= 1 && L >= 1 && T >= 1 &&
         T * L <= cap;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
}  // namespace attngan

// C entry points. Shapes and alignment are checked by the Python wrapper
// (ops/cuda_damsm.py); the dimensions are re-checked here so that a bad
// call fails as a CUDA error instead of reading out of bounds. All arrays
// are contiguous fp32 (mask int32): img (Bi, R, D), words (Bt, L, D),
// mask (Bt, L), sims / gout (Bi, Bt).
//
// Launches the forward. tc = 1 runs it on the tensor cores
// (damsm_fwd_tc_kernel, for the shapes takes_tc admits; S blocks per
// image), tc = 0 on the CUDA cores (damsm_fwd_kernel, a block per (image,
// tile); S unused).
extern "C" int damsm_similarity_fwd(const float* img, const float* words,
                                    const int* mask, float* sims, int Bi,
                                    int Bt, int R, int L, int D, int T, int S,
                                    int tc, float scale, float gamma1,
                                    float gamma2, void* stream) {
  using namespace attngan;
  const int K = (Bt + T - 1) / T;
  if (!valid_dims(Bi, Bt, R, L, D, T) || Bi > 65535 ||
      (tc && (S < 1 || S > K || !takes_tc(L, D, T))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc) {
    const size_t bytes = smem_floats(T * L, D, false) * sizeof(float);
    cudaError_t err = set_smem((const void*)damsm_fwd_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    damsm_fwd_kernel<<<dim3(K, Bi), kThreads, bytes, s>>>(
        img, words, mask, sims, Bt, R, L, D, T, scale, gamma1, gamma2);
    return (int)cudaGetLastError();
  }
  const auto kernel = D == 32    ? damsm_fwd_tc_kernel<32>
                      : D == 64  ? damsm_fwd_tc_kernel<64>
                      : D == 128 ? damsm_fwd_tc_kernel<128>
                                 : damsm_fwd_tc_kernel<256>;
  const size_t bytes =
      smem_floats_tc((T * L + 15) & ~15, D, false) * sizeof(float);
  cudaError_t err = set_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(S, Bi), kThreads, bytes, s>>>(img, words, mask, sims, Bt, R,
                                              L, T, S, scale, gamma1, gamma2);
  return (int)cudaGetLastError();
}

#ifdef DAMSM_PHASE_CLOCKS
// Copies g_phase_cycles to out (16 counts) and zeroes it.
extern "C" int damsm_phase_cycles(unsigned long long* out) {
  using namespace attngan;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[16] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros));
}
#endif

// Launches the backward pass and the reduction. dctx_part holds S partial
// d_img arrays (S, Bi, R, D) when S > 1 (unused when S == 1: the pass then
// writes d_img itself); dw_part is (Bi, Bt, L, D). tc = 1 runs the pass on
// the tensor cores (damsm_bwd_tc_kernel, for the shapes takes_tc admits),
// tc = 0 on the CUDA cores (damsm_bwd_kernel).
extern "C" int damsm_similarity_bwd(const float* img, const float* words,
                                    const int* mask, const float* gout,
                                    float* d_img, float* d_words,
                                    float* dctx_part, float* dw_part, int Bi,
                                    int Bt, int R, int L, int D, int T, int S,
                                    int tc, float scale, float gamma1,
                                    float gamma2, void* stream) {
  using namespace attngan;
  const int K = (Bt + T - 1) / T;
  if (!valid_dims(Bi, Bt, R, L, D, T) || S < 1 || S > K || Bi > 65535 ||
      (tc && !takes_tc(L, D, T)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = damsm_bwd_kernel;
  if (tc)
    kernel = D == 32    ? damsm_bwd_tc_kernel<32>
             : D == 64  ? damsm_bwd_tc_kernel<64>
             : D == 128 ? damsm_bwd_tc_kernel<128>
                        : damsm_bwd_tc_kernel<256>;
  const size_t bytes = (tc ? smem_floats_tc((T * L + 15) & ~15, D, true)
                           : smem_floats(T * L, D, true)) * sizeof(float);
  cudaError_t err = set_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(S, Bi), kThreads, bytes, s>>>(
      img, words, mask, gout, S > 1 ? dctx_part : d_img, dw_part, Bi, Bt, R,
      L, D, T, S, scale, gamma1, gamma2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nw4 = (size_t)Bt * L * D / 4, ni4 = (size_t)Bi * R * D / 4;
  const size_t total = nw4 + (S > 1 ? ni4 : 0);
  const int blocks = (int)((total + kThreads - 1) / kThreads < 4096
                               ? (total + kThreads - 1) / kThreads
                               : 4096);
  damsm_bwd_reduce_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(dw_part),
      reinterpret_cast<float4*>(d_words), nw4, Bi,
      reinterpret_cast<const float4*>(dctx_part),
      reinterpret_cast<float4*>(d_img), ni4, S);
  return (int)cudaGetLastError();
}
