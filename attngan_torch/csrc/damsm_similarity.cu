// DAMSM word-region similarity (K4) and its backward (K5 / K6) for Hopper.
//
// Replaces the TPU kernels of attngan_tpu/ops/pallas_damsm.py: the forward
// _image_cell_kernel (called through _similarity_grid) and the two
// hand-derived backwards, _image_cell_bwd_kernel (_similarity_grid_bwd_square,
// square batches <= 128) and _tiled_bwd_kernel (_similarity_grid_bwd_tiled,
// rectangular or larger batches). One backward design serves both cases.
//
// Per (image j, text i) pair, with ctx = img[j] (R, D) and w = words[i]
// (L, D), everything in fp32 (the products on the CUDA cores: TF32 would
// change the loss):
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

    // Eq. 10 and the cosine, backwards, per text and per word row
    for (int t = threadIdx.x; t < texts; t += kThreads) {
      float agg = 0.f;
      for (int l = 0; l < L; ++l) agg += rs(sm, kExpG)[t * L + l];
      const float g = gout[(size_t)j * Bt + text0 + t];
      sm.text[t] = agg > 0.f ? g / agg : 0.f;  // texts with no real word
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
extern "C" int damsm_similarity_fwd(const float* img, const float* words,
                                    const int* mask, float* sims, int Bi,
                                    int Bt, int R, int L, int D, int T,
                                    float scale, float gamma1, float gamma2,
                                    void* stream) {
  using namespace attngan;
  if (!valid_dims(Bi, Bt, R, L, D, T) || Bi > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(T * L, D, false) * sizeof(float);
  cudaError_t err = set_smem((const void*)damsm_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Bt + T - 1) / T, Bi);
  damsm_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      img, words, mask, sims, Bt, R, L, D, T, scale, gamma1, gamma2);
  return (int)cudaGetLastError();
}

// Launches the backward pass and the reduction. dctx_part holds S partial
// d_img arrays (S, Bi, R, D) when S > 1 (unused when S == 1: the pass then
// writes d_img itself); dw_part is (Bi, Bt, L, D).
extern "C" int damsm_similarity_bwd(const float* img, const float* words,
                                    const int* mask, const float* gout,
                                    float* d_img, float* d_words,
                                    float* dctx_part, float* dw_part, int Bi,
                                    int Bt, int R, int L, int D, int T, int S,
                                    float scale, float gamma1, float gamma2,
                                    void* stream) {
  using namespace attngan;
  const int K = (Bt + T - 1) / T;
  if (!valid_dims(Bi, Bt, R, L, D, T) || S < 1 || S > K || Bi > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_floats(T * L, D, true) * sizeof(float);
  cudaError_t err = set_smem((const void*)damsm_bwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  damsm_bwd_kernel<<<dim3(S, Bi), kThreads, bytes, s>>>(
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
