// K11, the attention of CLIP's residual blocks at short sequences, for
// Hopper: GALIP's text transformer (77 tokens, causal, 8 heads) and the
// ViT blocks of its bridge (50 and 51 tokens, unmasked, 12 heads)
// (models/clip.py). It replaces no TPU kernel: the JAX package has no
// GALIP.
//
//   out[b, i, h] = sum_j softmax_j(q_i . k_j / 8) v_j    (j <= i if causal)
//
// It reads the packed in_proj output, (B, L, 3W) with W = heads * 64 and
// q | k | v side by side in each row, as nn.MultiheadAttention packs them,
// and writes (B, L, W), the layout out_proj reads. Scores, the softmax and
// the weighted sum are fp32; the output is rounded once to the storage
// type.
//
// What bounds it: at L <= 80 a head's q, k and v are 15-30 KB, so the
// whole problem of one (sample, head) fits one CTA's shared memory and
// the bytes are read once; the products (2 L^2 64 a head, about 0.76
// MFLOP at L = 77) run on the fp32 CUDA cores, which at these sizes sit
// near the bytes' time rather than far beyond it.
//
// Design: one CTA of 4 warps a (sample, head). The CTA stages K (padded
// to 65 floats a row, so that 32 lanes reading 32 keys' same dimension hit
// 32 banks), V and Q in shared memory as fp32, rows past L zero. A warp
// takes R = 4 query rows at a time: lane l computes the scores of keys l,
// l + 32 and l + 64 for the four rows (each K value read once for four
// rows, each q value a broadcast), the softmax by warp shuffles, and
// writes the unnormalised weights to its own shared-memory strip; then
// lane l sums dimensions 2l and 2l + 1 over the keys, four weights a
// 16-byte broadcast read and one float2 of V a key. Causal rows skip the
// keys above the last row of their group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace attngan {
namespace clip {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kD = 64;        // a head's width
constexpr int kR = 4;         // query rows a warp takes at a time
constexpr int kMaxL = 80;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// KK: key slots a lane holds (L <= 32 KK). Shared memory, with S = 32 KK
// rows: Ks S x 65, Vs S x 64, Qs S x 64, Ps kWarps x kR x S floats.
template <typename T, int KK>
__global__ void __launch_bounds__(kThreads)
clip_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L,
                      int heads, int causal, float scale) {
  constexpr int S = 32 * KK;
  constexpr int KP = kD + 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S * KP;
  float* Qs = Vs + S * kD;
  float* Ps = Qs + S * kD;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int W = heads * kD;
  const T* src = qkv + (size_t)b * L * 3 * W + h * kD;

  // stage q, k and v as fp32; rows past L zero
  constexpr int V = Vec<T>::kN;
  constexpr int kChunks = kD / V;        // 16-byte chunks a row
  for (int t = threadIdx.x; t < 3 * S * kChunks; t += kThreads) {
    const int part = t / (S * kChunks);  // 0 q, 1 k, 2 v
    const int rest = t - part * S * kChunks;
    const int r = rest / kChunks;
    const int c = (rest - r * kChunks) * V;
    float v[V];
    if (r < L) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)r * 3 * W + part * W + c));
      Vec<T>::unpack(raw, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
    float* dst = part == 0 ? Qs + r * kD : part == 1 ? Ks + r * KP
                                                     : Vs + r * kD;
#pragma unroll
    for (int i = 0; i < V; ++i) dst[c + i] = v[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Ps + warp * kR * S;
  T* dst = out + (size_t)b * L * W + h * kD + 2 * lane;

  for (int row0 = warp * kR; row0 < L; row0 += kWarps * kR) {
    const int last = min(row0 + kR, L) - 1;       // the group's last row
    const int keys = causal ? last + 1 : L;       // keys any row reads
    float s[kR][KK];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) s[r][kk] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float kv[KK];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) kv[kk] = Ks[(kk * 32 + lane) * KP + d];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float q = Qs[(row0 + r) * kD + d];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) s[r][kk] = fmaf(q, kv[kk], s[r][kk]);
      }
    }
    float inv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = row0 + r;
      const int lim = causal ? min(i + 1, L) : L;   // keys of row i
      float m = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int j = kk * 32 + lane;
        s[r][kk] = j < lim ? s[r][kk] * scale : -INFINITY;
        m = fmaxf(m, s[r][kk]);
      }
      m = warp_max(m);
      if (m == -INFINITY) m = 0.f;                   // a row past L
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int j = kk * 32 + lane;
        const float p = j < lim ? expf(s[r][kk] - m) : 0.f;
        P[r * S + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      inv[r] = sum > 0.f ? 1.f / sum : 0.f;
    }
    __syncwarp();

    float o[kR][2];
#pragma unroll
    for (int r = 0; r < kR; ++r) o[r][0] = o[r][1] = 0.f;
    for (int j = 0; j < keys; j += 4) {   // P and V are zero past L
      float4 p[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        p[r] = *reinterpret_cast<const float4*>(P + r * S + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 v =
            *reinterpret_cast<const float2*>(Vs + (j + t) * kD + 2 * lane);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float w = t == 0 ? p[r].x : t == 1 ? p[r].y
                                               : t == 2 ? p[r].z : p[r].w;
          o[r][0] = fmaf(w, v.x, o[r][0]);
          o[r][1] = fmaf(w, v.y, o[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = row0 + r;
      if (i >= L) break;
      T* p = dst + (size_t)i * W;
      p[0] = from_f<T>(o[r][0] * inv[r]);
      p[1] = from_f<T>(o[r][1] * inv[r]);
    }
    __syncwarp();    // the strip is rewritten by the next group
  }
}

template <int KK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (32 * KK * (kD + 1) + 2 * 32 * KK * kD
                          + kWarps * kR * 32 * KK);
}

template <typename T, int KK>
int launch_kk(const void* qkv, void* out, int B, int L, int heads,
              int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<KK>();
  static bool configured = false;   // the attribute, once a process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        clip_attn_kernel<T, KK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  clip_attn_kernel<T, KK><<<B * heads, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), L, heads, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qkv, void* out, int B, int L, int heads, int causal,
           float scale, cudaStream_t stream) {
  if (L <= 32)
    return launch_kk<T, 1>(qkv, out, B, L, heads, causal, scale, stream);
  if (L <= 64)
    return launch_kk<T, 2>(qkv, out, B, L, heads, causal, scale, stream);
  return launch_kk<T, 3>(qkv, out, B, L, heads, causal, scale, stream);
}

}  // namespace clip
}  // namespace attngan

// K11: qkv (B, L, 3 heads 64) of type dtype (csrc/common.cuh::DType),
// contiguous and 16-byte aligned; out (B, L, heads 64) of the same type.
// 1 <= L <= 80; causal non-zero masks the keys after each query; scale
// multiplies the scores (1/8 at heads of 64). Returns the launch's
// cudaError_t.
extern "C" int clip_attention(int dtype, const void* qkv, void* out, int B,
                              int L, int heads, int causal, float scale,
                              void* stream) {
  using namespace attngan;
  if (B < 1 || L < 1 || L > clip::kMaxL || heads < 1
      || (long long)B * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return clip::launch<__nv_bfloat16>(qkv, out, B, L, heads, causal, scale,
                                       s);
  if (dtype == kFloat32)
    return clip::launch<float>(qkv, out, B, L, heads, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
