// K8, the AttnGAN generator's eval BatchNorm epilogue for Hopper, in one of
// two forms over an NHWC tensor x of C channels:
//
//   GLU:       out[.., j] = (x[j] k[j] + b[j]) * sigmoid(x[j+C/2] k[j+C/2]
//                                                     + b[j+C/2]),  j < C/2
//   residual:  out = x k + b + skip
//
// with k = weight / sqrt(running_var + eps), b = bias - running_mean k: the
// eval BatchNorm -> GLU of InitialStage, UpBlock and ResBlock, and the
// BatchNorm -> residual add that ends a ResBlock (ops/layers.py). It
// replaces no Pallas kernel: on the TPU, XLA fuses this chain into the
// conv's consumer (attngan_tpu/ops/layers.py:105-114). Run as PyTorch's
// operators a site is some ten kernels: the fold of the constants, their
// casts, a multiply and an add over the tensor on a broadcast operand that
// sends PyTorch to its non-vectorized kernel, then the GLU's sigmoid and
// product over two strided halves, or the residual add.
//
// What bounds it on the H100: bytes. Per value it does two multiply-adds
// and an exponential against 4 bytes read and 2 written (bf16, GLU), far
// below the ~295 operations a byte at which the tensor cores, let alone
// the CUDA cores, become the limit. So the design moves each byte once:
// every thread takes one 16-byte slot of the output's channels (8 bf16 or
// 4 fp32 values) and keeps it for every pixel it visits, so its constants,
// folded from BatchNorm's four fp32 vectors at its start, stay in
// registers; it reads the slot's two 16-byte inputs (x's two halves for
// GLU, x and skip for the residual) a few pixels ahead, computes in fp32
// and writes one rounding to the storage type. Neighbouring threads take
// neighbouring slots of a pixel, then the next pixel, so that a warp reads
// and writes whole sectors. The grid is what the card holds at once, and
// walks the pixels. The statistics are read on every launch, so a CUDA
// graph's replay sees them as they are then.
//
// Layout: x, skip and out NHWC (the channels_last view of the port's NCHW
// tensors), contiguous, 16-byte aligned; the output's channels (C/2 for
// GLU, C for the residual) a multiple of the vector's values; weight,
// bias, running_mean and running_var (C,) fp32, contiguous, 16-byte
// aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace attngan {
namespace bne {

constexpr int kThreads = 256;
constexpr int kBatch = 4;    // pixels a thread loads before it computes

// the fp32 constants (k, b) of channels [c, c + n)
template <int n>
__device__ __forceinline__ void fold(const float* weight, const float* bias,
                                     const float* mean, const float* var,
                                     float eps, int c, float k[n],
                                     float b[n]) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    float w[4], s[4], m[4], v[4];
    load4(weight + c + i, w);
    load4(bias + c + i, s);
    load4(mean + c + i, m);
    load4(var + c + i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[i + j] = w[j] * rsqrtf(v[j] + eps);
      b[i + j] = s[j] - m[j] * k[i + j];
    }
  }
}

// Thread t of block (bx, by) takes the output slot by * per + t % per of
// pixels t / per + (bx + i gridDim.x) lanes, i = 0, 1, ...: per threads
// share a pixel (all the slots of a pixel where it has fewer than
// kThreads, by's share of them where it has more), lanes = kThreads / per
// pixels are walked at once; the threads past per * lanes idle.
template <typename T, bool kGlu>
__global__ void __launch_bounds__(kThreads)
bn_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ var, float eps,
                   T* __restrict__ out, int pixels, int C) {
  constexpr int V = Vec<T>::kN;
  const int out_row = (kGlu ? C / 2 : C) / V;   // 16-byte slots a pixel
  const int in_row = C / V;
  const int per = min(out_row, kThreads);
  const int lanes = kThreads / per;
  const int lane = threadIdx.x / per;
  const int slot = blockIdx.y * per + threadIdx.x - lane * per;
  if (lane >= lanes || slot >= out_row) return;

  float ka[V], ba[V], kb[V], bb[V];
  fold<V>(weight, bias, mean, var, eps, slot * V, ka, ba);
  if (kGlu) fold<V>(weight, bias, mean, var, eps, C / 2 + slot * V, kb, bb);
  const uint4* xa = reinterpret_cast<const uint4*>(x) + slot;
  const uint4* xb = kGlu ? xa + out_row
                         : reinterpret_cast<const uint4*>(skip) + slot;
  uint4* o = reinterpret_cast<uint4*>(out) + slot;
  const int step = gridDim.x * lanes;

  for (int base = blockIdx.x * lanes + lane; base < pixels;
       base += kBatch * step) {
    uint4 ra[kBatch], rb[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j * step;
      if (p < pixels) {
        ra[j] = __ldg(xa + (size_t)p * in_row);
        rb[j] = __ldg(xb + (size_t)p * in_row);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j * step;
      if (p >= pixels) break;
      float a[V], g[V];
      Vec<T>::unpack(ra[j], a);
      Vec<T>::unpack(rb[j], g);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float y = fmaf(a[i], ka[i], ba[i]);
        a[i] = kGlu ? y / (1.f + expf(-fmaf(g[i], kb[i], bb[i])))
                    : y + g[i];
      }
      o[(size_t)p * out_row] = Vec<T>::pack(a);
    }
  }
}

// blocks of a kernel that the card holds at once
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return std::max(sms * per_sm, 1);
}

template <typename T, bool kGlu>
int launch(const void* x, const void* skip, const float* weight,
           const float* bias, const float* mean, const float* var, float eps,
           void* out, int pixels, int C, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const int out_c = kGlu ? C / 2 : C;
  if ((kGlu && C % 2) || out_c % V) return (int)cudaErrorInvalidValue;
  static const int card = resident_blocks(bn_epilogue_kernel<T, kGlu>);
  const int out_row = out_c / V;
  const int per = std::min(out_row, kThreads);
  const int lanes = kThreads / per;
  const int slabs = (out_row + per - 1) / per;
  const int wanted = (pixels + lanes - 1) / lanes;
  const dim3 grid(std::min(wanted, std::max(card / slabs, 1)), slabs);
  bn_epilogue_kernel<T, kGlu><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip), weight, bias,
      mean, var, eps, static_cast<T*>(out), pixels, C);
  return (int)cudaGetLastError();
}

}  // namespace bne
}  // namespace attngan

// K8: x (pixels, C) NHWC of type dtype (csrc/common.cuh::DType); BatchNorm's
// four (C,) fp32 vectors and eps; skip (pixels, C) of x's type for the
// residual form, null for the GLU form; out (pixels, C / 2) for GLU,
// (pixels, C) for the residual. Returns the launch's cudaError_t.
extern "C" int bn_epilogue(int dtype, const void* x, const void* skip,
                           const float* weight, const float* bias,
                           const float* mean, const float* var, float eps,
                           void* out, int pixels, int C, void* stream) {
  using namespace attngan;
  if (pixels < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool glu = skip == nullptr;
  if (dtype == kBFloat16)
    return glu ? bne::launch<__nv_bfloat16, true>(x, skip, weight, bias, mean,
                                                  var, eps, out, pixels, C, s)
               : bne::launch<__nv_bfloat16, false>(x, skip, weight, bias,
                                                   mean, var, eps, out,
                                                   pixels, C, s);
  if (dtype == kFloat32)
    return glu ? bne::launch<float, true>(x, skip, weight, bias, mean, var,
                                          eps, out, pixels, C, s)
               : bne::launch<float, false>(x, skip, weight, bias, mean, var,
                                           eps, out, pixels, C, s);
  return (int)cudaErrorInvalidValue;
}
