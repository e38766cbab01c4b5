// Generator word attention (K1) for Hopper.
//
// Replaces the TPU kernel attngan_tpu/ops/pallas_attention.py::
// _attention_kernel (called through _attention_fwd_flat): pixels attend over
// the caption's words,
//   scores = pix . words^T / sqrt(C) + bias   (bias = -1e9 at padded words)
//   attn   = softmax over the L words          (fp32)
//   ctx    = attn . words                      (attn rounded to the words'
//                                               type first, as the TPU does)
// images (B, P, C) and words (B, L, C) share one type (fp32 or bf16); ctx
// (B, P, C) has that type; attn is written straight into the public
// (B, L, P) layout, which saves the transpose the TPU kernel leaves to XLA.
//
// What bounds it on the H100: bytes. Per pixel it reads C values and
// writes C + L values, against 4*L*C flops: at C=32, L=5 in bf16 that is
// ~5 flops per byte, far below the ~295 at which the tensor cores would
// be the limit. So the design moves every byte once: one block per
// (image, tile of 128 pixels), the image's words and additive bias staged
// once in shared memory (read by every thread as a broadcast), one thread
// per pixel with its L scores and the softmax in registers. The pixel row
// is read with 16-byte (fp32) or 8-byte (bf16) loads, and the scores never
// leave registers: the (P, L) score matrix the two-matmul form keeps in
// memory is not written at all.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace attngan {
namespace {

constexpr int kThreads = 128;

template <typename T, int kMaxWords>
__global__ void __launch_bounds__(kThreads)
word_attention_kernel(const T* __restrict__ images, const T* __restrict__ words,
                      const float* __restrict__ bias, T* __restrict__ ctx,
                      float* __restrict__ attn, int P, int C, int L,
                      float scale) {
  extern __shared__ float smem[];
  float* w_s = smem;          // [L][C] this image's words, fp32
  float* b_s = smem + L * C;  // [L] additive mask bias
  const int b = blockIdx.y;
  const T* wb = words + (size_t)b * L * C;
  for (int i = threadIdx.x; i < L * C; i += blockDim.x) w_s[i] = to_f(wb[i]);
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    b_s[i] = bias[(size_t)b * L + i];
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;  // ragged pixel edge
  const T* x = images + ((size_t)b * P + p) * C;

  float s[kMaxWords];
#pragma unroll
  for (int l = 0; l < kMaxWords; ++l) s[l] = 0.f;
  for (int c = 0; c < C; c += 4) {
    float xv[4];
    load4(x + c, xv);
#pragma unroll
    for (int l = 0; l < kMaxWords; ++l) {
      if (l < L) {
        const float* wl = w_s + l * C + c;
        s[l] += xv[0] * wl[0] + xv[1] * wl[1] + xv[2] * wl[2] + xv[3] * wl[3];
      }
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int l = 0; l < kMaxWords; ++l) {
    if (l < L) {
      s[l] = s[l] * scale + b_s[l];
      m = fmaxf(m, s[l]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxWords; ++l) {
    if (l < L) {
      s[l] = expf(s[l] - m);
      sum += s[l];
    }
  }
  float* ab = attn + (size_t)b * L * P + p;
#pragma unroll
  for (int l = 0; l < kMaxWords; ++l) {
    if (l < L) {
      s[l] = s[l] / sum;
      ab[(size_t)l * P] = s[l];    // coalesced: neighbouring threads,
      s[l] = to_f(from_f<T>(s[l]));  // neighbouring pixels
    }
  }

  T* out = ctx + ((size_t)b * P + p) * C;
  for (int c = 0; c < C; c += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < kMaxWords; ++l) {
      if (l < L) {
        const float* wl = w_s + l * C + c;
        acc[0] += s[l] * wl[0];
        acc[1] += s[l] * wl[1];
        acc[2] += s[l] * wl[2];
        acc[3] += s[l] * wl[3];
      }
    }
    store4(out + c, acc);
  }
}

template <typename T, int kMaxWords>
void launch(const void* images, const void* words, const float* bias,
            void* ctx, float* attn, int B, int P, int C, int L, float scale,
            cudaStream_t stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)(L * C + L) * sizeof(float);
  word_attention_kernel<T, kMaxWords><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(images), static_cast<const T*>(words), bias,
      static_cast<T*>(ctx), attn, P, C, L, scale);
}

template <typename T>
void dispatch_words(const void* images, const void* words, const float* bias,
                    void* ctx, float* attn, int B, int P, int C, int L,
                    float scale, cudaStream_t stream) {
  // the score array lives in registers: its bound is a compile-time
  // constant, the smallest bucket that holds L
  if (L <= 8)
    launch<T, 8>(images, words, bias, ctx, attn, B, P, C, L, scale, stream);
  else if (L <= 16)
    launch<T, 16>(images, words, bias, ctx, attn, B, P, C, L, scale, stream);
  else
    launch<T, 32>(images, words, bias, ctx, attn, B, P, C, L, scale, stream);
}

}  // namespace
}  // namespace attngan

// C entry point. Shapes and alignment are checked by the Python wrapper
// (ops/cuda_attention.py); the arguments are re-checked here so that a bad
// call fails as a CUDA error instead of reading out of bounds.
extern "C" int word_attention(int dtype, const void* images, const void* words,
                              const float* bias, void* ctx, float* attn, int B,
                              int P, int C, int L, float scale, void* stream) {
  using namespace attngan;
  if (L < 1 || L > 32 || C < 4 || C % 4 != 0 || P < 1 || B < 1 ||
      (size_t)(L * C + L) * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    dispatch_words<float>(images, words, bias, ctx, attn, B, P, C, L, scale, s);
  else if (dtype == kBFloat16)
    dispatch_words<__nv_bfloat16>(images, words, bias, ctx, attn, B, P, C, L,
                                  scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
