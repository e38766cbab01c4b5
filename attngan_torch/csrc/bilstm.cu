// K9, the text encoder's masked bidirectional LSTM recurrence for Hopper: one
// launch runs both directions over all L steps of a (B, L) caption batch,
// reading each row's length from the device.
//
// Per direction d and row b, from the input projection G_d = x W_ih,d^T
// (B, L, 4H), computed ahead of the kernel as one GEMM a direction:
//
//   z = G_d[b, p] + b_ih,d + b_hh,d + h W_hh,d^T   (gates i, f, g, o)
//   c = sigmoid(f) c + sigmoid(i) tanh(g),  h = sigmoid(o) tanh(c)
//
// over the positions p = 0, 1, ..., len - 1 (forward) or len - 1, ..., 0
// (backward). The carry is frozen at padded steps and the output there is
// zero; a row of length 0 gives zero words and a zero sentence embedding.
// words (B, L, 2H) holds the forward h at p in its first H channels and the
// backward h at p in its last H; sent (B, 2H) each direction's final h.
// This is models/rnn_encoder.py::BiLSTMEncoder.forward_masked, the JAX
// package's masked scan (attngan_tpu/models/rnn_encoder.py), for which the
// TPU has no Pallas kernel: it replaces cuDNN's packed RNN, whose host
// lengths cost the serving call four blocking calls and kept the encoder
// out of its CUDA graph.
//
// What bounds it on the H100: the chain of L dependent steps. The work is
// small (2 B L 4H H multiply-adds: 0.15 G at (64, 18)) and so are the bytes
// (W_hh 2 x 256 KB), but each step needs the whole h of the step before.
// The design keeps a step short: W_hh, 512 x 128 fp32 a direction, does
// not fit one SM's registers or shared memory, so a direction's hidden
// units are split over a cluster of 4 CTAs (32 units each), and each CTA
// keeps its 128 gate rows of W_hh in registers for all L steps, one row a
// thread (128 values): no step reads a weight from memory. h lives in
// shared memory, double-buffered; at each step every thread reads all of
// it as 16-byte broadcasts, forms its gate row's sum for each of the
// CTA's rows of the batch, the four gates of a unit meet by warp
// shuffles, and the threads of each (unit, row) update the carry and write
// the new h into the next buffer of all four CTAs (distributed shared
// memory); one cluster barrier ends the step. The batch is split over
// clusters, 1 to 8 rows each: the fewest rows a cluster with which every
// cluster is resident at once. The gates' inputs for the next step are
// loaded while the current one computes. fp32 FFMA throughout, no TF32.
// A cluster stops its recurrence at the longest of its rows and writes the
// zeros of the padding left.
//
// Layout: gates_f, gates_b (B, L, 4H) fp32, contiguous; w_hh_f, w_hh_b
// (4H, H) fp32, contiguous, 16-byte aligned; the four biases (4H,) fp32;
// lengths (B,) int64 (clamped to 0..L); words (B, L, 2H) and sent (B, 2H)
// fp32. H = 128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace attngan {
namespace bilstm {

constexpr int kHidden = 128;               // units a direction
constexpr int kGates = 4 * kHidden;        // rows of W_hh: i, f, g, o
constexpr int kCluster = 4;                // CTAs a direction's recurrence
constexpr int kUnits = kHidden / kCluster; // units a CTA
constexpr int kThreads = 4 * kUnits;       // one gate row a thread
constexpr int kVec = kHidden / 4;          // float4s in a row of W_hh
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ int row_length(const long long* lengths, int row,
                                          int B, int L) {
  if (row >= B) return 0;
  const long long n = lengths[row];
  return n < 0 ? 0 : (n > L ? L : (int)n);
}

// the gates' inputs of step s for a thread's pairs (zero where s is past
// a row's length)
template <int kRows, int kPairs>
__device__ __forceinline__ void load_inputs(const float* gates, int row0,
                                            int L, int unit, int lane,
                                            int dir, const int (&len)[kPairs],
                                            int s, float (&g)[kPairs][4]) {
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int b = (lane & 3) + 4 * k;
#pragma unroll
    for (int q = 0; q < 4; ++q) g[k][q] = 0.f;
    if (b < kRows && s < len[k]) {
      const int p = dir ? len[k] - 1 - s : s;
      const float* src =
          gates + ((size_t)(row0 + b) * L + p) * kGates + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) g[k][q] = __ldg(src + q * kHidden);
    }
  }
}

// Thread t of CTA rank r holds gate row q = t % 4 of unit u = 32 r + t / 4
// (W_hh row q H + u), and updates the (unit u, row (t % 4) + 4 k) pairs,
// k < kPairs, of the cluster's kRows batch rows. A warp holds 8 units with
// all four gates of each, so a unit's gates meet by shuffles.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
bilstm_kernel(const float* __restrict__ gates_f,
              const float* __restrict__ gates_b,
              const float* __restrict__ w_hh_f,
              const float* __restrict__ w_hh_b,
              const float* __restrict__ b_ih_f,
              const float* __restrict__ b_hh_f,
              const float* __restrict__ b_ih_b,
              const float* __restrict__ b_hh_b,
              const long long* __restrict__ lengths,
              float* __restrict__ words, float* __restrict__ sent, int B,
              int L) {
  constexpr int kPairs = kRows >= 4 ? kRows / 4 : 1;
  constexpr int kSplit = kRows >= 4 ? 1 : 4 / kRows;  // partial sums a row
  __shared__ __align__(16) float hs[2][kRows][kHidden];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int unit = rank * kUnits + t / 4;
  const float* gates = dir ? gates_b : gates_f;
  const float* w_hh = dir ? w_hh_b : w_hh_f;
  const float* b_ih = dir ? b_ih_b : b_ih_f;
  const float* b_hh = dir ? b_hh_b : b_hh_f;

  float w[kHidden];
  {
    const float4* src = reinterpret_cast<const float4*>(
        w_hh + (size_t)((t & 3) * kHidden + unit) * kHidden);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float4 v = __ldg(src + j);
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  }
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bias[q] = __ldg(b_ih + q * kHidden + unit) +
              __ldg(b_hh + q * kHidden + unit);

  // this thread's pairs: row, length, carry
  int len[kPairs];
  float c[kPairs], h[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int b = (lane & 3) + 4 * k;
    len[k] = b < kRows ? row_length(lengths, row0 + b, B, L) : 0;
    c[k] = h[k] = 0.f;
  }
  int steps = 0;  // the longest row of the cluster: every CTA agrees
#pragma unroll
  for (int b = 0; b < kRows; ++b)
    steps = max(steps, row_length(lengths, row0 + b, B, L));

  float* flat = &hs[0][0][0];
  for (int i = t; i < 2 * kRows * kHidden; i += kThreads) flat[i] = 0.f;
  // every CTA of the cluster has started and zeroed its h before any
  // peer writes into it
  cluster.sync();

  float next[kPairs][4];
  if (steps > 0)
    load_inputs<kRows>(gates, row0, L, unit, lane, dir, len, 0, next);

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    float gin[kPairs][4];
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) gin[k][q] = next[k][q];
    if (s + 1 < steps)
      load_inputs<kRows>(gates, row0, L, unit, lane, dir, len, s + 1, next);

    // this thread's gate row times h, for each row of the cluster
    float acc[kRows][kSplit];
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int i = 0; i < kSplit; ++i) acc[b][i] = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const float4 v = reinterpret_cast<const float4*>(hs[cur][b])[j];
        acc[b][0] = fmaf(w[4 * j], v.x, acc[b][0]);
        acc[b][1 % kSplit] = fmaf(w[4 * j + 1], v.y, acc[b][1 % kSplit]);
        acc[b][2 % kSplit] = fmaf(w[4 * j + 2], v.z, acc[b][2 % kSplit]);
        acc[b][3 % kSplit] = fmaf(w[4 * j + 3], v.w, acc[b][3 % kSplit]);
      }
    }
    float sum[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      sum[b] = acc[b][0];
#pragma unroll
      for (int i = 1; i < kSplit; ++i) sum[b] += acc[b][i];
    }

    // the four gates of this thread's unit, for each of its pairs' rows
    float z[kPairs][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int src = (lane & ~3) | q;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) z[k][q] = 0.f;
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const float v = __shfl_sync(kFull, sum[b], src);
#pragma unroll
        for (int k = 0; k < kPairs; ++k)
          if (b == (lane & 3) + 4 * k) z[k][q] = v;
      }
    }

    const int nxt = cur ^ 1;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int b = (lane & 3) + 4 * k;
      if (b >= kRows) continue;
      const bool live = s < len[k];
      if (live) {
        const float gi = sigmoid(z[k][0] + gin[k][0] + bias[0]);
        const float gf = sigmoid(z[k][1] + gin[k][1] + bias[1]);
        const float gg = tanhf(z[k][2] + gin[k][2] + bias[2]);
        const float go = sigmoid(z[k][3] + gin[k][3] + bias[3]);
        c[k] = gf * c[k] + gi * gg;
        h[k] = go * tanhf(c[k]);
      }
      const int row = row0 + b;
      if (row < B) {
        const int p = live ? (dir ? len[k] - 1 - s : s) : s;
        words[((size_t)row * L + p) * (2 * kHidden) + dir * kHidden + unit] =
            live ? h[k] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        *cluster.map_shared_rank(&hs[nxt][b][unit], r) = h[k];
    }
    // the new h is in every CTA's next buffer, and nobody reads the
    // current one any more
    cluster.sync();
  }

#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int b = (lane & 3) + 4 * k;
    const int row = row0 + b;
    if (b >= kRows || row >= B) continue;
    for (int s = steps; s < L; ++s)
      words[((size_t)row * L + s) * (2 * kHidden) + dir * kHidden + unit] =
          0.f;
    sent[(size_t)row * (2 * kHidden) + dir * kHidden + unit] = h[k];
  }
}

template <int kRows>
cudaLaunchConfig_t config(int B, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, (B + kRows - 1) / kRows, 2);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of bilstm_kernel<kRows> that the card holds at once
template <int kRows>
int resident_clusters() {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<kRows>(kRows, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, bilstm_kernel<kRows>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <int kRows>
int launch(const float* gf, const float* gb, const float* wf,
           const float* wb, const float* bif, const float* bhf,
           const float* bib, const float* bhb, const long long* lengths,
           float* words, float* sent, int B, int L, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<kRows>(B, stream, &attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, bilstm_kernel<kRows>, gf, gb, wf, wb, bif,
                         bhf, bib, bhb, lengths, words, sent, B, L);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// the rows a cluster takes for a batch of B: the fewest with which every
// cluster of both directions is resident at once, else 8
int rows_per_cluster(int B) {
  // asked once, before any stream capture can be in progress
  static const int resident[4] = {resident_clusters<1>(),
                                  resident_clusters<2>(),
                                  resident_clusters<4>(),
                                  resident_clusters<8>()};
  for (int i = 0, rows = 1; i < 4; ++i, rows *= 2)
    if (2 * ((B + rows - 1) / rows) <= resident[i]) return rows;
  return 8;
}

}  // namespace bilstm
}  // namespace attngan

// K9: gates_f / gates_b (B, L, 512) = x W_ih^T of each direction (no bias);
// w_hh_f / w_hh_b (512, 128); the biases (512,); lengths (B,) int64 on the
// device; words (B, L, 256), sent (B, 256). All fp32 but the lengths.
// Returns the launch's cudaError_t.
extern "C" int bilstm(const float* gates_f, const float* gates_b,
                      const float* w_hh_f, const float* w_hh_b,
                      const float* b_ih_f, const float* b_hh_f,
                      const float* b_ih_b, const float* b_hh_b,
                      const long long* lengths, float* words, float* sent,
                      int B, int L, void* stream) {
  using namespace attngan::bilstm;
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_cluster(B)) {
    case 1:
      return launch<1>(gates_f, gates_b, w_hh_f, w_hh_b, b_ih_f, b_hh_f,
                       b_ih_b, b_hh_b, lengths, words, sent, B, L, s);
    case 2:
      return launch<2>(gates_f, gates_b, w_hh_f, w_hh_b, b_ih_f, b_hh_f,
                       b_ih_b, b_hh_b, lengths, words, sent, B, L, s);
    case 4:
      return launch<4>(gates_f, gates_b, w_hh_f, w_hh_b, b_ih_f, b_hh_f,
                       b_ih_b, b_hh_b, lengths, words, sent, B, L, s);
    default:
      return launch<8>(gates_f, gates_b, w_hh_f, w_hh_b, b_ih_f, b_hh_f,
                       b_ih_b, b_hh_b, lengths, words, sent, B, L, s);
  }
}

// the rows a cluster takes at batch B, for the wrapper's tests and reports
extern "C" int bilstm_rows_per_cluster(int B) {
  return attngan::bilstm::rows_per_cluster(B);
}
