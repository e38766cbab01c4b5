// K7, the fused DF layer of DF-GAN's generator (models/dfgan.py), for
// Hopper:
//
//   out = lrelu(g1 * lrelu(g0 * x + b0) + b1),   lrelu(t) = t > 0 ? t : 0.2 t
//
// with g0, b0, g1, b1 one fp32 value per (sample, channel), broadcast over
// the pixels: DF-GAN's DFBLK, two text-conditioned affines, each followed by
// a LeakyReLU (Tao et al., CVPR 2022, Sec. 3.3). It replaces no TPU kernel:
// the JAX package has no DF-GAN. It was added because, run as PyTorch's
// elementwise operators, a DF layer is four passes over its input, each a
// read and a write of the whole tensor, and the twelve DF layers of a call
// then move several times the bytes the generator's convolutions need.
//
// What bounds it on the H100: bytes. Per value it does 4 multiply-adds and
// 2 selects against 2 bytes read and 2 written (bf16), far below the ~295
// operations a byte at which the tensor cores, let alone the CUDA cores,
// become the limit. So the design moves each byte once: every thread reads
// 16 bytes of one pixel's channels (8 bf16 or 4 fp32 values), keeps its
// channels' four constants in registers for all the pixels it visits, does
// the arithmetic in fp32 and writes one rounding to the storage type.
// Neighbouring threads take neighbouring 16-byte chunks of a pixel, then
// the next pixel, so that a warp reads and writes whole sectors.
//
// The upsampling form reads the (B, H, W, C) input of a G_Block and writes
// the DF layer of its nearest 2x upsample, (B, 2H, 2W, C): the layer is the
// same function at every pixel of a channel, so DF(up(x)) = up(DF(x)), and
// each input chunk is read once, computed once and stored to its 2x2 output
// pixels. The upsampled input never reaches memory.
//
// The resize form does the same for a nearest resize to any (Ho, Wo), as
// GALIP's G_Blocks take their input from 7^2 to 8^2 and from 64^2 to
// 224^2: each thread takes an output pixel's chunk and reads the chunk of
// the source pixel that PyTorch's ``nearest`` picks (a float32 scale
// in / out, then floorf(o * scale), clamped to the last pixel), computes
// it and stores it. Neighbouring output pixels share their sources, so
// the repeated reads hit the caches and the input crosses HBM about once;
// the resized input never reaches memory. An exact 2x resize takes the
// upsampling form, which reads each input chunk once by construction.
//
// Layout: x and out are NHWC (the channels_last view of the port's NCHW
// tensors), contiguous, 16-byte aligned, C a multiple of the vector's
// values; the constants are (B, C) fp32, contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace attngan {
namespace dfb {

constexpr int kThreads = 256;
constexpr int kBatch = 4;    // vectors a thread loads before it computes
constexpr int kRounds = 4;   // batches a thread takes in its block
constexpr float kSlope = 0.2f;

// Block (tile, b) takes pixels [tile * pixels_per_block, + pixels_per_block)
// of image b: thread t the chunk t % chunks of every (kThreads / chunks)-th
// pixel from t / chunks on; the threads past chunks * lanes idle.
template <typename T, bool kUp>
__global__ void __launch_bounds__(kThreads)
dfblock_kernel(const T* __restrict__ x, const float* __restrict__ g0,
               const float* __restrict__ b0, const float* __restrict__ g1,
               const float* __restrict__ b1, T* __restrict__ out, int H,
               int W, int C, int pixels_per_block) {
  constexpr int V = Vec<T>::kN;
  const int chunks = C / V;
  const int lanes = kThreads / chunks;
  const int lane = threadIdx.x / chunks;
  if (lane >= lanes) return;
  const int c0 = (threadIdx.x - lane * chunks) * V;
  const int b = blockIdx.y;
  const int P = H * W;
  const int p0 = blockIdx.x * pixels_per_block;
  const int p1 = min(p0 + pixels_per_block, P);

  float ga[V], ba[V], gb[V], bb[V];
  const size_t k0 = (size_t)b * C + c0;
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    load4(g0 + k0 + i, ga + i);
    load4(b0 + k0 + i, ba + i);
    load4(g1 + k0 + i, gb + i);
    load4(b1 + k0 + i, bb + i);
  }
  const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)b * P * C + c0);
  uint4* ob = reinterpret_cast<uint4*>(out + (size_t)b * P * (kUp ? 4 : 1) * C
                                       + c0);
  const int row = C / V;   // uint4s a pixel

  for (int base = p0 + lane; base < p1; base += kBatch * lanes) {
    uint4 raw[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j * lanes;
      if (p < p1) raw[j] = __ldg(xb + (size_t)p * row);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j * lanes;
      if (p >= p1) break;
      float v[V];
      Vec<T>::unpack(raw[j], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = fmaf(ga[i], v[i], ba[i]);
        t = t > 0.f ? t : kSlope * t;
        t = fmaf(gb[i], t, bb[i]);
        v[i] = t > 0.f ? t : kSlope * t;
      }
      const uint4 r = Vec<T>::pack(v);
      if (kUp) {
        const int y = p / W, xx = p - y * W;
        const size_t o = ((size_t)(2 * y) * (2 * W) + 2 * xx) * row;
        const size_t down = (size_t)(2 * W) * row;
        ob[o] = r;
        ob[o + row] = r;
        ob[o + down] = r;
        ob[o + down + row] = r;
      } else {
        ob[(size_t)p * row] = r;
      }
    }
  }
}

// The resize form: block (tile, b) takes output pixels [tile *
// pixels_per_block, + pixels_per_block) of image b, thread t the chunk
// t % chunks of every (kThreads / chunks)-th output pixel from t / chunks
// on. sh, sw: the float32 scales H / Ho and W / Wo.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dfblock_resize_kernel(const T* __restrict__ x, const float* __restrict__ g0,
                      const float* __restrict__ b0,
                      const float* __restrict__ g1,
                      const float* __restrict__ b1, T* __restrict__ out,
                      int H, int W, int C, int Ho, int Wo, float sh, float sw,
                      int pixels_per_block) {
  constexpr int V = Vec<T>::kN;
  const int chunks = C / V;
  const int lanes = kThreads / chunks;
  const int lane = threadIdx.x / chunks;
  if (lane >= lanes) return;
  const int c0 = (threadIdx.x - lane * chunks) * V;
  const int b = blockIdx.y;
  const int P = Ho * Wo;
  const int p0 = blockIdx.x * pixels_per_block;
  const int p1 = min(p0 + pixels_per_block, P);

  float ga[V], ba[V], gb[V], bb[V];
  const size_t k0 = (size_t)b * C + c0;
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    load4(g0 + k0 + i, ga + i);
    load4(b0 + k0 + i, ba + i);
    load4(g1 + k0 + i, gb + i);
    load4(b1 + k0 + i, bb + i);
  }
  const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)b * H * W * C
                                                   + c0);
  uint4* ob = reinterpret_cast<uint4*>(out + (size_t)b * P * C + c0);
  const int row = C / V;   // uint4s a pixel

  for (int base = p0 + lane; base < p1; base += kBatch * lanes) {
    uint4 raw[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j * lanes;
      if (p < p1) {
        const int oy = p / Wo, ox = p - oy * Wo;
        // PyTorch's nearest source index (a product, no add: no fma)
        const int sy = min((int)floorf(__fmul_rn((float)oy, sh)), H - 1);
        const int sx = min((int)floorf(__fmul_rn((float)ox, sw)), W - 1);
        raw[j] = __ldg(xb + ((size_t)sy * W + sx) * row);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j * lanes;
      if (p >= p1) break;
      float v[V];
      Vec<T>::unpack(raw[j], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = fmaf(ga[i], v[i], ba[i]);
        t = t > 0.f ? t : kSlope * t;
        t = fmaf(gb[i], t, bb[i]);
        v[i] = t > 0.f ? t : kSlope * t;
      }
      ob[(size_t)p * row] = Vec<T>::pack(v);
    }
  }
}

template <typename T>
int launch_resize(const void* x, const float* g0, const float* b0,
                  const float* g1, const float* b1, void* out, int B, int H,
                  int W, int C, int Ho, int Wo, float sh, float sw,
                  cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  if (C % V != 0 || C / V > kThreads) return (int)cudaErrorInvalidValue;
  const int lanes = kThreads / (C / V);
  const int pixels_per_block = lanes * kBatch * kRounds;
  const dim3 grid((Ho * Wo + pixels_per_block - 1) / pixels_per_block, B);
  dfblock_resize_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), g0, b0, g1, b1, static_cast<T*>(out), H, W,
      C, Ho, Wo, sh, sw, pixels_per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* g0, const float* b0, const float* g1,
           const float* b1, void* out, int B, int H, int W, int C, int up,
           cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  if (C % V != 0 || C / V > kThreads) return (int)cudaErrorInvalidValue;
  const int lanes = kThreads / (C / V);
  const int pixels_per_block = lanes * kBatch * kRounds;
  const dim3 grid((H * W + pixels_per_block - 1) / pixels_per_block, B);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (up)
    dfblock_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, g0, b0, g1, b1, ot, H, W, C, pixels_per_block);
  else
    dfblock_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, g0, b0, g1, b1, ot, H, W, C, pixels_per_block);
  return (int)cudaGetLastError();
}

}  // namespace dfb
}  // namespace attngan

// K7: x (B, H, W, C) NHWC of type dtype (csrc/common.cuh::DType), the four
// (B, C) fp32 constants; out (B, H, W, C), or (B, 2H, 2W, C) where upsample
// is non-zero. Returns the launch's cudaError_t.
extern "C" int dfblock(int dtype, const void* x, const float* g0,
                       const float* b0, const float* g1, const float* b1,
                       void* out, int B, int H, int W, int C, int upsample,
                       void* stream) {
  using namespace attngan;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dfb::launch<__nv_bfloat16>(x, g0, b0, g1, b1, out, B, H, W, C,
                                      upsample, s);
  if (dtype == kFloat32)
    return dfb::launch<float>(x, g0, b0, g1, b1, out, B, H, W, C, upsample,
                              s);
  return (int)cudaErrorInvalidValue;
}

// K7's resize form: x (B, H, W, C) as above; out (B, Ho, Wo, C), the DF
// layer of x's nearest resize to (Ho, Wo); sh = H / Ho and sw = W / Wo
// rounded to float32, as PyTorch's ``nearest`` computes them. Returns the
// launch's cudaError_t.
extern "C" int dfblock_resize(int dtype, const void* x, const float* g0,
                              const float* b0, const float* g1,
                              const float* b1, void* out, int B, int H,
                              int W, int C, int Ho, int Wo, float sh,
                              float sw, void* stream) {
  using namespace attngan;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dfb::launch_resize<__nv_bfloat16>(x, g0, b0, g1, b1, out, B, H, W,
                                             C, Ho, Wo, sh, sw, s);
  if (dtype == kFloat32)
    return dfb::launch_resize<float>(x, g0, b0, g1, b1, out, B, H, W, C, Ho,
                                     Wo, sh, sw, s);
  return (int)cudaErrorInvalidValue;
}
