// Generator word attention (K1) for Hopper.
//
// Replaces the TPU kernel attngan_tpu/ops/pallas_attention.py::
// _attention_kernel (called through _attention_fwd_flat): pixels attend over
// the caption's words,
//   scores = pix . words^T / sqrt(C), -1e9 at padded words (mask == 0)
//   attn   = softmax over the L words          (fp32)
//   ctx    = attn . words                      (attn rounded to the words'
//                                               type first, as the TPU does)
// images (B, P, C) and words (B, L, C) share one type (fp32 or bf16); ctx
// (B, P, C) has that type; attn is written straight into the public
// (B, L, P) layout, which saves the transpose the TPU kernel leaves to XLA.
// The mask is the int32 (B, L) mask itself: the kernel applies the -1e9
// where the TPU kernel adds a bias array, so no bias pass runs before it.
//
// What bounds it on the H100: bytes. Per pixel it reads C values and
// writes C + L values, against 4*L*C flops: at C=32, L=5 in bf16 that is
// ~5 flops per byte, far below the ~295 at which the tensor cores would
// be the limit. So the design moves every byte once, in full sectors, with
// enough of them in flight, and keeps the instructions per pixel few
// enough that the SMs keep up with the memory:
// - persistent blocks (two per SM) each walk a contiguous run of work
//   units (image, tile of pt pixels); a tile of (B, P, C) is one contiguous
//   run of pt*C values (16 KB at pt = 256, bf16, C = 32);
// - one thread issues each tile as a 1-D bulk copy (cp.async.bulk, no
//   tensor map) into a ring of stages guarded by mbarriers (two from the
//   wrapper's plan; up to 4), so the next tile is in flight while one is
//   computed; the first image's words load meanwhile. A tile whose bytes or
//   address are not multiples of 16 (only bf16 with C % 8 == 4) is copied
//   by the block's threads instead (the tail path); the wrapper pads
//   nothing;
// - G lanes share a pixel, each holding 16 bytes of its row (4 fp32 or 8
//   bf16 values; 8 bytes for bf16 at C % 8 == 4), and each lane takes two
//   pixels a pass (one above 8 words): partial dots for the L words,
//   finished by __shfl_xor across the G lanes; every lane of the group
//   runs the fp32 softmax (ex2 and rcp on the MUFU) and writes its own 16
//   bytes of ctx, so a warp's ctx store is one contiguous 512-byte run;
// - the (L, pt) fp32 attention tile is staged in shared memory (two
//   buffers, one barrier per tile) and leaves a word row at a time as a
//   bulk copy issued by another thread than the tiles' (plain stores by
//   the threads where rows are not 16-byte runs);
// - an image's words are staged once per image change, as fp32, in shared
//   memory; where a lane has one chunk of the row (C / V == G: the serving
//   shapes) it keeps its chunk of every word in registers.
// L is compiled in (up to 8 words; 16 or 32 with the padding masked), so
// the pixel loop has no branch on L.
//
// The memory form (memread_stream_kernel, DM-GAN's memory read and
// response gate; its plain version is ops/attention.py::memory_read) is a
// second instantiation of the same streaming body (kMem):
//   scores = r . key^T, unscaled, -1e9 at padded words
//   attn   = softmax over the L words           (fp32, written as K1's)
//   o      = attn . value                       (fp32; attn not rounded)
//   g      = sigmoid(w_g[:C] . r + w_g[C:] . o + b_g)
//   out    = [r'; r'],  r' = o g + r (1 - g)    (rounded once to T)
// The key and the value rows are staged apart (two fp32 tables), w_g and
// b_g once a block beside them. A lane holds one chunk of its pixel's row
// (the wrapper takes C / V == G), so after the value product it holds its
// chunk of r (from the tile in the ring) and of o: its partial gate dot
// is finished by __shfl_xor across the G lanes, and it writes its chunk of
// r' into both halves of the (B, P, 2C) output.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace attngan {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
// thread 0 issues the tiles' copies; the first lane of the last warp the
// attention rows' (bulk groups belong to the thread that commits them), so
// that no warp does both beside its pixels
constexpr int kStorer = kThreads - 32;
constexpr float kNegInf = -1e9f;   // attngan_tpu/ops/attention.py NEG_INF

// V consecutive values of type T <-> fp32: 16 bytes, or 8 for 4 bf16.
template <typename T, int V>
struct Chunk;
template <>
struct Chunk<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    load4(p, v);
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    store4(p, v);
  }
};
template <>
struct Chunk<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[4]) {
    load4(p, v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float v[4]) {
    store4(p, v);
  }
};
template <>
struct Chunk<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__host__ __device__ inline size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Shared memory of one block, in bytes from its start (the Python mirror
// is ops/cuda_attention.py::smem_bytes): the stages' mbarriers, the
// image's words (fp32, `words` rows: L padded to the kernel's kWords; the
// memory form's keys, then its values and the gate's 2C + 1 floats) and
// mask flags, two (L, ld) attention tiles, the ring.
struct Layout {
  int ld;              // floats between word rows of an attention tile
  size_t stage_bytes;  // bytes between ring stages
  size_t w_off, v_off, gate_off, valid_off, attn_off, ring_off, total;
  __host__ __device__ Layout(int C, int L, int words, int elem, int pt,
                             int g, int stages, bool mem = false) {
    const int ppw = 32 / g;                 // pixels per warp and pass
    ld = pt + (ppw < 4 ? 4 : ppw);          // rows in other banks
    stage_bytes = round_up((size_t)pt * C * elem, 128);
    w_off = 128;
    v_off = w_off + round_up((size_t)words * C * 4, 16);
    gate_off = v_off + (mem ? round_up((size_t)words * C * 4, 16) : 0);
    valid_off = gate_off + (mem ? round_up((size_t)(2 * C + 1) * 4, 16) : 0);
    attn_off = round_up(valid_off + (size_t)words * 4, 128);
    ring_off = round_up(attn_off + (size_t)2 * L * ld * 4, 128);
    total = ring_off + (size_t)stages * stage_bytes;
  }
};

// Built with -DK1_PHASE_CLOCKS (attngan_torch/tools/attention_plans.py
// --clocks), thread 0 of each block adds the cycles of each phase of its
// units to g_k1_cycles: 0 staging the words, 1 waiting for the tile, 2 the
// tail path's copy, 3 its own pixels, 4 the barrier after them (the other
// warps' pixels), 5 issuing the next copy, 6 writing the attention tile.
// Without the flag the marks are empty.
#ifdef K1_PHASE_CLOCKS
__device__ unsigned long long g_k1_cycles[8];
#define K1_CLOCK long long k1_last = clock64()
#define K1_MARK(k)                                                       \
  do {                                                                   \
    const long long now = clock64();                                     \
    if (threadIdx.x == 0)                                                \
      atomicAdd(&g_k1_cycles[k], (unsigned long long)(now - k1_last));   \
    k1_last = now;                                                       \
  } while (0)
#else
#define K1_CLOCK
#define K1_MARK(k) \
  do {             \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the phase of the given parity to complete. A copy that never
// lands traps (a launch error) after 2^24 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 24)) __trap();
  } while (!done);
}

// A work unit: image b, first pixel p0, n pixels; and whether its tile
// goes by bulk copy (byte count and global address multiples of 16; the
// images' base is 16-byte aligned, the wrapper checks).
struct Unit {
  int b, p0, n;
  bool bulk;
  __device__ Unit(int u, int P, int pt, int tiles, size_t row) {
    b = u / tiles;
    p0 = (u % tiles) * pt;
    n = min(pt, P - p0);
    bulk = ((((size_t)b * P + p0) * row) % 16 == 0) && ((n * row) % 16 == 0);
  }
};

// Thread 0: start unit u's tile into ring stage s, or, for a tail-path
// tile, only complete the stage's phase (its threads copy it themselves).
template <typename T>
__device__ __forceinline__ void issue(const T* images, unsigned char* stage,
                                      uint64_t* bar, const Unit& t, int P,
                                      size_t row) {
  const uint32_t b = smem_u32(bar);
  if (t.bulk) {
    const uint32_t bytes = (uint32_t)(t.n * row);
    const char* src = reinterpret_cast<const char*>(images) +
                      ((size_t)t.b * P + t.p0) * row;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stage)), "l"(src), "r"(bytes), "r"(b)
        : "memory");
  } else {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(b) : "memory");
  }
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, MUFU alone
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {   // 1/x for x >= 1
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kWords: L itself for L <= 8, else 16 or 32 with the words past L zero
// and masked. The pixel loop then has no branch on L: every word's loads
// and products are straight-line code the compiler can schedule together.
// kMem: the memory form (values, gate_w, gate_b read; ctx is the (B, P,
// 2C) output); else K1 (words are key and value; the three are null).
template <typename T, int V, int kWords, bool kMem>
__device__ __forceinline__ void stream_body(
    const T* __restrict__ images, const T* __restrict__ words,
    const T* __restrict__ values, const int* __restrict__ mask,
    const float* __restrict__ gate_w, const float* __restrict__ gate_b,
    T* __restrict__ ctx, float* __restrict__ attn, int B, int P, int C,
    int L, int pt, int g, int stages, float scale) {
  // pixels a lane takes in one pass: two, for independent work between
  // the waits on shared memory, shuffles and MUFU, where registers allow
  constexpr int kPix = kWords <= 8 ? 2 : 1;
  // a lane keeps its chunk of every word in registers when it has one
  // chunk (C / V == g, the serving shapes) and they fit (K1 only)
  constexpr bool kRegWords = !kMem && kWords * V <= 40;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(C, L, kWords, sizeof(T), pt, g, stages, kMem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + lay.w_off);
  float* v_s = reinterpret_cast<float*>(smem + lay.v_off);
  float* gate_s = reinterpret_cast<float*>(smem + lay.gate_off);
  int* valid_s = reinterpret_cast<int*>(smem + lay.valid_off);
  float* attn_s = reinterpret_cast<float*>(smem + lay.attn_off);
  unsigned char* ring = smem + lay.ring_off;

  const size_t row = (size_t)C * sizeof(T);
  const int tiles = (P + pt - 1) / pt;
  const int units = B * tiles;
  // this block's contiguous run of units: few image changes per block
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  // attention rows go out as bulk copies where they are 16-byte runs
  const bool bulk_attn = P % 4 == 0 && pt % 4 == 0;
  K1_CLOCK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane & (g - 1);    // this lane's place in its pixel's group
  const int ppw = 32 / g;          // pixels of a warp in one pass
  const int qw = warp * ppw + lane / g;   // its pixel in each pass
  const int nc = C / V;            // chunks of a pixel's row
  const bool reg_words = kRegWords && nc == g;
  uint32_t own = 0;                // bit l: this lane stores word l's attn
#pragma unroll
  for (int l = 0; l < kWords; ++l)
    if ((l & (g - 1)) == j && (kWords <= 8 || l < L)) own |= 1u << l;

  // warps 1.. stage an image's words (fp32, zero past L) and mask flags,
  // while thread 0 may issue copies
  auto stage_words = [&](int b) {
    if (threadIdx.x < 32) return;
    const T* wb = words + (size_t)b * L * C;
    for (int i = threadIdx.x - 32; i < kWords * C; i += kThreads - 32)
      w_s[i] = i < L * C ? to_f(wb[i]) : 0.f;
    if constexpr (kMem) {
      const T* vb = values + (size_t)b * L * C;
      for (int i = threadIdx.x - 32; i < kWords * C; i += kThreads - 32)
        v_s[i] = i < L * C ? to_f(vb[i]) : 0.f;
    }
    for (int i = threadIdx.x - 32; i < kWords; i += kThreads - 32)
      valid_s[i] = i < L && mask[(size_t)b * L + i] != 0;
  };
  // after a barrier: bit l of the result, word l is real; and this lane's
  // chunk of each word into wr
  float4 wr[kRegWords ? kWords : 1][V / 4];
  auto load_words = [&]() {
    uint32_t v = 0;
#pragma unroll
    for (int l = 0; l < kWords; ++l) v |= (uint32_t)valid_s[l] << l;
    if constexpr (kRegWords) {
      if (reg_words) {
#pragma unroll
        for (int l = 0; l < kWords; ++l)
#pragma unroll
          for (int i = 0; i < V; i += 4)
            wr[l][i / 4] = *reinterpret_cast<const float4*>(
                w_s + l * C + j * V + i);
      }
    }
    return v;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first image's words load while thread 0 issues the first tiles
  int cur_b = -1;
  if (u0 < u1) {
    cur_b = Unit(u0, P, pt, tiles, row).b;
    stage_words(cur_b);
  }
  if constexpr (kMem) {           // the gate's weights and bias, once
    if (threadIdx.x >= 32)
      for (int i = threadIdx.x - 32; i <= 2 * C; i += kThreads - 32)
        gate_s[i] = i < 2 * C ? gate_w[i] : gate_b[0];
  }
  if (threadIdx.x == 0)
    for (int k = 0; k < stages && u0 + k < u1; ++k)
      issue(images, ring + k * lay.stage_bytes, &full[k],
            Unit(u0 + k, P, pt, tiles, row), P, row);
  __syncthreads();
  uint32_t valid = load_words();
  const float scale2 = scale * 1.44269504088896341f;   // scores in log2 units

  for (int k = 0; u0 + k < u1; ++k) {
    const Unit t(u0 + k, P, pt, tiles, row);
    const int s = k % stages;
    if (t.b != cur_b) {            // block-uniform: the next image
      stage_words(t.b);
      cur_b = t.b;
      __syncthreads();
      valid = load_words();
    }
    K1_MARK(0);
    mbar_wait(&full[s], (uint32_t)((k / stages) & 1));
    K1_MARK(1);
    const T* tile = reinterpret_cast<const T*>(ring + s * lay.stage_bytes);
    if (!t.bulk) {                 // tail path: 8-byte copies (row % 8 == 0)
      const uint2* src = reinterpret_cast<const uint2*>(
          reinterpret_cast<const char*>(images) +
          ((size_t)t.b * P + t.p0) * row);
      uint2* dst = reinterpret_cast<uint2*>(ring + s * lay.stage_bytes);
      for (int i = threadIdx.x; i < (int)(t.n * row / 8); i += kThreads)
        dst[i] = src[i];
      __syncthreads();
    }
    K1_MARK(2);
    float* a_s = attn_s + (k & 1) * L * lay.ld;

    // one pass over kPix pixels of this lane's group; fetch(l, ch, i)
    // gives channels ch*V + i .. + 3 of word l
    auto pass = [&](int q0, auto fetch) {
      int q[kPix];                 // pixels within the tile
      bool active[kPix];
      float sc[kPix][kWords];
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        q[p] = q0 + p * kWarps * ppw + qw;
        active[p] = q[p] < t.n;
#pragma unroll
        for (int l = 0; l < kWords; ++l) sc[p][l] = 0.f;
      }
      for (int ch = j; ch < nc; ch += g) {
        float x[kPix][V];
        // a pixel past the tile's end reads the last one (no branch); its
        // results are not stored
#pragma unroll
        for (int p = 0; p < kPix; ++p)
          Chunk<T, V>::load(tile + (size_t)min(q[p], t.n - 1) * C + ch * V,
                            x[p]);
#pragma unroll
        for (int l = 0; l < kWords; ++l) {
#pragma unroll
          for (int i = 0; i < V; i += 4) {
            const float4 wv = fetch(l, ch, i);
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              sc[p][l] = fmaf(x[p][i], wv.x, sc[p][l]);
              sc[p][l] = fmaf(x[p][i + 1], wv.y, sc[p][l]);
              sc[p][l] = fmaf(x[p][i + 2], wv.z, sc[p][l]);
              sc[p][l] = fmaf(x[p][i + 3], wv.w, sc[p][l]);
            }
          }
        }
      }
      for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int p = 0; p < kPix; ++p)
#pragma unroll
          for (int l = 0; l < kWords; ++l)
            sc[p][l] += __shfl_xor_sync(0xffffffffu, sc[p][l], off);
      }
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        float m = -INFINITY;
#pragma unroll
        for (int l = 0; l < kWords; ++l) {
          sc[p][l] = (valid >> l) & 1 ? sc[p][l] * scale2 : kNegInf;
          m = fmaxf(m, sc[p][l]);
        }
        float sum = 0.f;
#pragma unroll
        for (int l = 0; l < kWords; ++l) {
          // a padded word (l >= L) weighs exactly 0, also in a row whose
          // real words are all masked (every score is then -1e9)
          sc[p][l] = kWords <= 8 || l < L ? ex2(sc[p][l] - m) : 0.f;
          sum += sc[p][l];
        }
        const float inv = rcp(sum);   // sum >= 1: the largest term is 1
        float* r = a_s + q[p];
#pragma unroll
        for (int l = 0; l < kWords; ++l, r += lay.ld) {
          sc[p][l] *= inv;
          if (active[p] && ((own >> l) & 1)) *r = sc[p][l];
          if constexpr (!kMem)
            sc[p][l] = to_f(from_f<T>(sc[p][l]));  // the TPU's cast to T
        }
      }
      for (int ch = j; ch < nc; ch += g) {
        float acc[kPix][V];
#pragma unroll
        for (int p = 0; p < kPix; ++p)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[p][i] = 0.f;
#pragma unroll
        for (int l = 0; l < kWords; ++l) {
#pragma unroll
          for (int i = 0; i < V; i += 4) {
            float4 wv;
            if constexpr (kMem)
              wv = *reinterpret_cast<const float4*>(v_s + l * C + ch * V + i);
            else
              wv = fetch(l, ch, i);
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              acc[p][i] = fmaf(sc[p][l], wv.x, acc[p][i]);
              acc[p][i + 1] = fmaf(sc[p][l], wv.y, acc[p][i + 1]);
              acc[p][i + 2] = fmaf(sc[p][l], wv.z, acc[p][i + 2]);
              acc[p][i + 3] = fmaf(sc[p][l], wv.w, acc[p][i + 3]);
            }
          }
        }
        if constexpr (kMem) {
          // the response gate: this lane's chunk of r (still in the ring)
          // and of o, its partial dot finished across the pixel's G lanes
          // (every lane runs this loop once: C / V == G)
          float x[kPix][V], z[kPix];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            Chunk<T, V>::load(tile + (size_t)min(q[p], t.n - 1) * C + ch * V,
                              x[p]);
            z[p] = 0.f;
#pragma unroll
            for (int i = 0; i < V; ++i) {
              z[p] = fmaf(gate_s[ch * V + i], x[p][i], z[p]);
              z[p] = fmaf(gate_s[C + ch * V + i], acc[p][i], z[p]);
            }
          }
          for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int p = 0; p < kPix; ++p)
              z[p] += __shfl_xor_sync(0xffffffffu, z[p], off);
          }
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const float gr = 1.f / (1.f + __expf(-(z[p] + gate_s[2 * C])));
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[p][i] = acc[p][i] * gr + x[p][i] * (1.f - gr);
            if (active[p]) {
              T* o = ctx + ((size_t)t.b * P + t.p0 + q[p]) * 2 * C + ch * V;
              Chunk<T, V>::store(o, acc[p]);
              Chunk<T, V>::store(o + C, acc[p]);
            }
          }
        } else {
#pragma unroll
          for (int p = 0; p < kPix; ++p)
            if (active[p])
              Chunk<T, V>::store(
                  ctx + ((size_t)t.b * P + t.p0 + q[p]) * C + ch * V, acc[p]);
        }
      }
    };
    const int step = kPix * kWarps * ppw;
    bool done = false;
    if constexpr (kRegWords) {
      if (reg_words) {
        for (int q0 = 0; q0 < t.n; q0 += step)
          pass(q0, [&](int l, int, int i) { return wr[l][i / 4]; });
        done = true;
      }
    }
    if (!done)
      for (int q0 = 0; q0 < t.n; q0 += step)
        pass(q0, [&](int l, int ch, int i) {
          return *reinterpret_cast<const float4*>(w_s + l * C + ch * V + i);
        });
    if (bulk_attn)   // this thread's a_s writes, before the async reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    K1_MARK(3);
    if (threadIdx.x == kStorer && bulk_attn)
      // the previous tile's attention rows have left its a_s buffer,
      // which the next tile overwrites after this barrier
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();   // stage s and a_s complete; stage s free for reuse
    K1_MARK(4);
    float* dst = attn + (size_t)t.b * L * P + t.p0;
    if (threadIdx.x == 0 && u0 + k + stages < u1) {
      // on the tail path the stage was written through the generic proxy;
      // the bulk copy writes it through the async proxy
      if (!t.bulk)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(images, ring + s * lay.stage_bytes, &full[s],
            Unit(u0 + k + stages, P, pt, tiles, row), P, row);
    }
    if (threadIdx.x == kStorer && bulk_attn) {
      for (int l = 0; l < L; ++l)
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            :: "l"(dst + (size_t)l * P), "r"(smem_u32(a_s + l * lay.ld)),
               "r"(t.n * 4)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    K1_MARK(5);
    if (!bulk_attn) {
      for (int i = threadIdx.x; i < L * t.n; i += kThreads) {
        const int l = i / t.n, c = i - l * t.n;
        dst[(size_t)l * P + c] = a_s[l * lay.ld + c];
      }
    }
    K1_MARK(6);
  }
  if (threadIdx.x == kStorer && bulk_attn)   // a_s is read until they end
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T, int V, int kWords>
__global__ void __launch_bounds__(kThreads, 2)
word_attention_stream_kernel(const T* __restrict__ images,
                             const T* __restrict__ words,
                             const int* __restrict__ mask, T* __restrict__ ctx,
                             float* __restrict__ attn, int B, int P, int C,
                             int L, int pt, int g, int stages, float scale) {
  stream_body<T, V, kWords, false>(images, words, nullptr, mask, nullptr,
                                   nullptr, ctx, attn, B, P, C, L, pt, g,
                                   stages, scale);
}

// The memory form: unscaled (scale 1), out (B, P, 2C).
template <typename T, int V, int kWords>
__global__ void __launch_bounds__(kThreads, 2)
memread_stream_kernel(const T* __restrict__ images, const T* __restrict__ key,
                      const T* __restrict__ value,
                      const int* __restrict__ mask,
                      const float* __restrict__ gate_w,
                      const float* __restrict__ gate_b, T* __restrict__ out,
                      float* __restrict__ attn, int B, int P, int C, int L,
                      int pt, int g, int stages) {
  stream_body<T, V, kWords, true>(images, key, value, mask, gate_w, gate_b,
                                  out, attn, B, P, C, L, pt, g, stages, 1.f);
}

// One launch's operands; values, gate_w and gate_b are the memory form's.
struct Args {
  const void *images, *words, *values;
  const int* mask;
  const float *gate_w, *gate_b;
  void* ctx;
  float* attn;
  int B, P, C, L, pt, g, stages, grid;
  float scale;
  cudaStream_t stream;
};

template <typename T, int V, int kWords, bool kMem>
int launch(const Args& a) {
  const Layout lay(a.C, a.L, kWords, sizeof(T), a.pt, a.g, a.stages, kMem);
  if (lay.total > 227 * 1024) return (int)cudaErrorInvalidValue;
  const void* kernel;
  if constexpr (kMem)
    kernel = (const void*)memread_stream_kernel<T, V, kWords>;
  else
    kernel = (const void*)word_attention_stream_kernel<T, V, kWords>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  const T* images = static_cast<const T*>(a.images);
  const T* words = static_cast<const T*>(a.words);
  if constexpr (kMem)
    memread_stream_kernel<T, V, kWords><<<a.grid, kThreads, lay.total,
                                          a.stream>>>(
        images, words, static_cast<const T*>(a.values), a.mask, a.gate_w,
        a.gate_b, static_cast<T*>(a.ctx), a.attn, a.B, a.P, a.C, a.L, a.pt,
        a.g, a.stages);
  else
    word_attention_stream_kernel<T, V, kWords><<<a.grid, kThreads, lay.total,
                                                 a.stream>>>(
        images, words, a.mask, static_cast<T*>(a.ctx), a.attn, a.B, a.P,
        a.C, a.L, a.pt, a.g, a.stages, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kMem>
int dispatch_words(const Args& a) {
  // the scores live in registers, so their count is a compile-time
  // constant: L itself up to 8 words, else a padded 16 or 32
  const int L = a.L;
#define K1_WORDS(n) return launch<T, V, n, kMem>(a)
  switch (L) {
    case 1: K1_WORDS(1);
    case 2: K1_WORDS(2);
    case 3: K1_WORDS(3);
    case 4: K1_WORDS(4);
    case 5: K1_WORDS(5);
    case 6: K1_WORDS(6);
    case 7: K1_WORDS(7);
    case 8: K1_WORDS(8);
  }
  if (L <= 16) K1_WORDS(16);
  K1_WORDS(32);
#undef K1_WORDS
}

}  // namespace
}  // namespace attngan

// C entry points. Shapes, alignment and the plan (pt pixels a tile, g
// lanes a pixel, ring stages, persistent blocks) come from the Python
// wrapper (ops/cuda_attention.py::plan); they are re-checked here so that
// a bad call fails as a CUDA error instead of reading out of bounds.
extern "C" int word_attention(int dtype, const void* images, const void* words,
                              const int* mask, void* ctx, float* attn, int B,
                              int P, int C, int L, int pt, int g, int stages,
                              int grid, float scale, void* stream) {
  using namespace attngan;
  const int elem = dtype == kFloat32 ? 4 : 2;
  // values per lane chunk: 16 bytes where the row allows, else 4 values
  const int v = (C * elem) % 16 == 0 ? 16 / elem : 4;
  if (L < 1 || L > 32 || C < 4 || C % 4 != 0 || P < 1 || B < 1 ||
      (size_t)(L * C + L) * sizeof(float) > 48 * 1024 || pt < 1 ||
      g < 1 || g > 32 || (g & (g - 1)) != 0 || g > C / v || stages < 1 ||
      stages > kMaxStages || grid < 1 || (dtype != kFloat32 &&
                                          dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  const Args a{images, words, nullptr, mask, nullptr, nullptr, ctx, attn,
               B, P, C, L, pt, g, stages, grid, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_words<float, 4, false>(a);
  if (v == 8) return dispatch_words<__nv_bfloat16, 8, false>(a);
  return dispatch_words<__nv_bfloat16, 4, false>(a);
}

// The memory form: rows of 16-byte chunks, one a lane (g == C / v), so
// fp32 at C % 4 == 0 and bf16 at C % 8 == 0; out is (B, P, 2C).
extern "C" int memory_read(int dtype, const void* images, const void* key,
                           const void* value, const int* mask,
                           const float* gate_w, const float* gate_b,
                           void* out, float* attn, int B, int P, int C, int L,
                           int pt, int g, int stages, int grid,
                           void* stream) {
  using namespace attngan;
  const int elem = dtype == kFloat32 ? 4 : 2;
  const int v = 16 / elem;
  if (L < 1 || L > 32 || C < v || C % v != 0 || P < 1 || B < 1 || pt < 1 ||
      g < 1 || g > 32 || (g & (g - 1)) != 0 || g != C / v || stages < 1 ||
      stages > kMaxStages || grid < 1 || (dtype != kFloat32 &&
                                          dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  const Args a{images, key, value, mask, gate_w, gate_b, out, attn,
               B, P, C, L, pt, g, stages, grid, 1.f,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_words<float, 4, true>(a);
  return dispatch_words<__nv_bfloat16, 8, true>(a);
}

#ifdef K1_PHASE_CLOCKS
// Copies g_k1_cycles to out (8 counts) and zeroes it.
extern "C" int k1_phase_cycles(unsigned long long* out) {
  using namespace attngan;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k1_cycles, sizeof(g_k1_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[8] = {};
  return (int)cudaMemcpyToSymbol(g_k1_cycles, zeros, sizeof(zeros));
}
#endif
