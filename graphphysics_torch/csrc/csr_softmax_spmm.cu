// Fused segment softmax + SpMM over a sender-sorted edge list, for Hopper
// (sm_90a). For each node n, over its real unmasked edges e, and each head h:
//
//   m[h, n]   = max_e scores[e, h]                        (-1e30 if none)
//   l[h, n]   = sum_e exp(scores[e, h] - m[h, n])
//   out[n, c] = sum_e exp(scores[e, h] - m[h, n]) * values[e, c] / (l[h, n] + 1e-16)
//
// where column c of the head-blocked values belongs to head c / (D / H).
// Rows without such edges give out = 0, m = -1e30 and l = 0. The kernel also
// writes ml = [m; l] as [2H, N] for the backward pass.
//
// Replaces the Pallas TPU kernel `_softmax_spmm_impl` / `_kernel` in
// graphphysics_tpu/ops/pallas_attention.py, which the sparse transformer's
// attention runs once per TransformerBlock (`csr_sparse_attention`). The TPU
// kernel packed [values | scores | segment] into 128-lane rows, streamed
// 512-edge chunks per 128-node block and reduced them with one-hot matmuls on
// the matrix unit; segment ids rode in float lanes (base-256 digits in bf16).
// Those were TPU workarounds and are not carried over: this kernel reads
// int32 per-node [start, end) edge ranges and the f32 arrays as they are.
//
// Bound: memory. Per edge and column it does one multiply-add and per edge
// and head two exponentials, far below the card's operations-per-byte
// balance. With E the real edges (the ranges stop before trailing padding,
// which is never read), N the nodes, H the heads and D the width, the bytes
// that must move are
//   E*(4H + 4D + 1)   scores, values, mask byte
//   + N*(4D + 8H + 8)  out, ml, the two bounds
// (the per-edge segment ids are not read: the ranges carry them).
//
// Design. One warp or lane group owns one output row, so there are no
// atomics, nothing is shared between rows, and every sum runs in a fixed
// order (deterministic). Four geometries, chosen before the launch by
// width, heads and alignment (the rule of ops/csr_attention.py
// softmax_spmm_geometry and softmax_spmm_columns):
// - 16-byte words, where a head's width is a multiple of 4, D <= 128 and
//   values and out 16-byte aligned:
//   a lane owns 4 adjacent f32 columns of one head, read as one 16-byte
//   word an edge (words.cuh, as K1's f32 words), and reads its head's
//   score once an edge (all lanes of a head the same address). A row takes
//   L = D / 4 lanes (rounded up to a power of two), so a warp serves 32 / L
//   rows: one at D = 128, two at 64, four at 32. A lane walks its row's
//   range in windows of kEdgeGroup edges: it starts the loads of the
//   window's mask bytes, scores and words together, without a branch (a
//   slot past the row's end reads the row's last edge and adds nothing;
//   guarded loads took 96 registers and were 5-7% slower on an H100),
//   then takes each slot's online step in edge order and keeps the live
//   slots' results, so no exponential waits on a branch, where the
//   V-column kernel below chains each edge's score and value loads on the
//   edge before. The step is the V-column kernel's (online_step), so each
//   column's arithmetic and the outputs are the same bits as that
//   kernel's. The bf16 stream's order (a window's maximum first, one
//   exponential a live edge and one a window) rounds otherwise: with it,
//   the unsplit partitioned transformer's first step read 6.5e-4 of a
//   gradient against the split-edge step (K5, an online step an edge),
//   over the 1e-4 it is held to, ReLU inputs within round-off of 0
//   flipping. A 64-register cap, so that part 0's 4,096 row warps fit the
//   card at once, spilled and was 16-21% slower.
// - V columns, where D = 32 V, a head's width is a multiple of V and the
//   values aligned to the loads below (D = 256 and 512; D = 32 in 16 heads
//   of 2): the first design, one warp a row, each lane V contiguous columns
//   inside one head, loaded as one 16- or 8-byte vector where V allows
//   (4 min(4, V & -V) bytes), so a warp reads each value row as one
//   contiguous D*4-byte span; the warp walks its row's edges once with the
//   online softmax: per edge, m' = max(m, s), acc = acc*exp(m - m') +
//   exp(s - m')*v, l = l*exp(m - m') + exp(s - m'). Masked edges are
//   skipped. It stays beside the general geometry, which takes these
//   widths too, because it is faster there: on an H100 its f32 forward
//   took 0.70 and 0.65 of the general geometry's time at D = 256 in 4 heads
//   and 512 in 8, its bf16 stream 0.55 at 512 in 4 (chip_smoke.py's and
//   chip_stream.py's geometry cases, the panels batch).
// - 16-byte words that may span heads (f32), where the first two do not
//   take the width, D % 4 == 0, values and out 16-byte aligned and 32
//   lanes of words hold the row with at most 16 heads (word_heads.cuh
//   blocked_word_geometry, K3's rule too: D = 40 in 8 heads of 5, 36 in 4
//   of 9, 20 in 4 of 5): forward_span_words, a lane owns one word of 4
//   adjacent columns; a row takes L lanes (D / 4 rounded up to a power of
//   two, and to the power of two at least H), 32 / L rows a warp. The
//   window loop above, 8 edges in flight (4 ran slower at the mesh part
//   on an H100). A word touches at most K heads (2 at 40 x 8: the word of
//   columns 4-7 holds heads 0 and 1 of 5); the lane loads those K scores an
//   edge and takes each head's online step, and each column its head's
//   step, picked by selects. Of the two designs that fit, one lane a head
//   keeping m and l with the weights read back by shuffles
//   (attention_words.cuh) and this one, this one: a lane waits on no other
//   (no shuffle, so a lane past the row leaves at once), and a lane's K
//   steps overlap where a head's lane and its shuffles would chain. Each
//   column's arithmetic is the general geometry's (expf(m - m') and
//   expf(s - m') on the same operands, an edge at a time), so out and ml
//   are the same bits; a window's maximum first would round otherwise
//   (above). 8- and 4-byte words (views 8 or 4 bytes aligned, D % 4 != 0)
//   ran slower than the general geometry on an H100 (chip_compare.py
//   --k2, PERF.md), which keeps them.
// - the general geometry (softmax_general.cuh, K5's on one edge set) for
//   every other width and view with D <= 512 and D % H == 0 (D = 160 in 5
//   heads of 32: 40 words, past 32 lanes; a 4-byte view past 32 columns;
//   more than 16 heads): lane j owns the columns j, j + 32, ..., one scalar
//   load each, so a warp reads an edge's value row as 128-byte spans, and
//   takes the same online step an edge for each of its columns.
// The first lane of each head writes that head's m and l. The models'
// attention does not run this entry: csr_attention.cu fuses the q/k/v
// gathers and the per-edge dot products into the same loop. The unsplit
// partitioned attention runs it, on each part's scores and values
// segmented by the part's receivers (ops/attention.py); split-edge
// partitioned attention runs K5 (csr_softmax_spmm_pair.cu).
//
// stream_dtype="bf16" (entry csr_softmax_spmm_bf16_stream). The TPU kernel's
// second mode packs the scores and values in bf16 and computes in f32 from
// the rounded values (pallas_attention.py:255-302): it halves the edge
// bytes, and what changes in the result is the input rounding alone. The
// wrapper rounds the f32 scores and values to bf16 (one PyTorch cast each,
// as JAX's packing is XLA's), and this entry reads the bf16 rows, widens
// each element to f32, and does every sum, exponential and the (m, l) in
// f32; out and ml stay f32. Its bytes are
//   E*(2H + 2D + 1) + N*(4D + 8H + 8).
// It takes K5's bf16 word geometries (csr_softmax_spmm_pair.cu,
// pair_forward_words) on its one edge set, the window loop above with
// bf16 words, chosen before the launch by width, heads and alignment (the
// rule of ops/csr_attention.py stream_geometry):
// - 16-byte words, where a head's width is a multiple of 8, D <= 256 and
//   values and out are 16-byte aligned: a lane owns 8 adjacent columns of
//   one head, read as one 16-byte word, and reads one bf16 score an edge.
//   A row takes L = D / 8 lanes (rounded up to a power of two): two rows a
//   warp at D = 128, four at D = 64. Branch-free window loads were 2.6-10.6%
//   faster than guarded ones in trial builds on an H100. A warp at
//   D = 128 keeps 2 x 16 x 8 words of 16 bytes in flight.
// - 8-byte words, where a head's width is a multiple of 4, D <= 128 and the
//   values 8-byte aligned (D = 32 with 8 heads of 4): the same with 4
//   columns a lane.
// - the V-column kernel on bf16 rows where it takes the shape and the
//   values are aligned to its vector loads (2 min(8, V & -V) bytes; D = 512,
//   heads narrower than 4): V/8 16-byte loads where V allows, one edge at a
//   time.
// - else the general geometry on bf16 rows (D = 40 in 8 heads of 5; values
//   only 4- or 2-byte aligned), each element read as its own 2-byte load.
//   With it K2's stream rule is K5's (stream_geometry, the rule of both).
// Each keeps the invariants above: one warp or lane group owns a row, no
// atomics, every sum in a fixed order, so two runs give the same bits; an
// empty row, or one whose edges are all masked, keeps m = -1e30, l = 0 and
// out = 0. The backward of both entries is the f32 one
// (csr_softmax_spmm_bwd.cu), on the unrounded inputs with this pass's ml
// and out, as JAX's `_fwd` saves them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "softmax_general.cuh"
#include "word_heads.cuh"
#include "words.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block
constexpr float kNeg = -1e30f;    // finite -inf stand-in, as the TPU kernel
constexpr float kEps = 1e-16f;    // the epsilon of segment_softmax
constexpr int kEdgeGroup = 8;     // edges a lane has in flight (word geometries)
constexpr int kWordWarps = 4;     // warps per block (word geometries)
constexpr int kF32WordCols = 4;   // f32 columns in a 16-byte word

template <int V>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// V bf16 columns at p as f32: 16-, 8- or 4-byte loads where V allows
template <int V>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ p, float (&v)[V]) {
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[8 * i + 2 * j] = f.x;
        v[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const uint2 w = reinterpret_cast<const uint2*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[4 * i + 2 * j] = f.x;
        v[4 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One edge of the online softmax, score s and the N columns v:
// m' = max(m, s), l = l*exp(m - m') + exp(s - m'),
// acc = acc*exp(m - m') + exp(s - m')*v.
template <int N>
__device__ __forceinline__ void online_step(float& m, float& l, float (&acc)[N], float s, const float (&v)[N]) {
  const float m_new = fmaxf(m, s);
  const float alpha = expf(m - m_new);
  const float p = expf(s - m_new);
  l = l * alpha + p;
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = acc[c] * alpha + p * v[c];
  m = m_new;
}

template <int V, typename T>
__global__ void csr_softmax_spmm_kernel(const T* __restrict__ scores,
                                        const T* __restrict__ values,
                                        const int32_t* __restrict__ bounds,
                                        const uint8_t* __restrict__ mask,
                                        float* __restrict__ out,
                                        float* __restrict__ ml,
                                        int64_t num_rows, int64_t num_edges,
                                        int32_t num_heads, int32_t head_dim) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;
  constexpr int width = kLanes * V;
  const int col0 = threadIdx.x * V;
  const int head = col0 / head_dim;
  // bounds is [2, num_rows]: starts, then ends; clamp to the edge array
  int64_t start = bounds[row];
  int64_t end = bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > num_edges ? num_edges : end;

  float m = kNeg;
  float l = 0.0f;
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
  for (int64_t e = start; e < end; ++e) {
    if (mask != nullptr && !mask[e]) continue;
    const float s = to_f32(scores[e * num_heads + head]);
    float v[V];
    load_cols<V>(values + e * width + col0, v);
    online_step<V>(m, l, acc, s, v);
  }
  float* o = out + row * width + col0;
#pragma unroll
  for (int c = 0; c < V; ++c) o[c] = acc[c] / (l + kEps);
  if (col0 % head_dim == 0) {
    ml[head * num_rows + row] = m;
    ml[(num_heads + head) * num_rows + row] = l;
  }
}

// ---- the word geometries: W adjacent columns of T of one head a lane, read
// as one word (WordOf, unpack_word: words.cuh): f32 W = 4 (16-byte words),
// bf16 W = 8 (16-byte) or 4 (8-byte words); `lanes` lanes a row (a power of
// two), 32 / lanes rows a warp.

template <typename T, int W>
__global__ void forward_words(const T* __restrict__ scores, const T* __restrict__ values,
                              const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                              float* __restrict__ out, float* __restrict__ ml, int64_t num_rows,
                              int64_t num_edges, int width, int num_heads, int lanes) {
  using Word = typename WordOf<T, W>::type;
  const int slot = threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWordWarps + threadIdx.y) * (kLanes / lanes) + slot;
  const int col0 = sub * W;
  if (row >= num_rows || col0 >= width) return;  // no shuffles: a lane waits on no other
  const int head_dim = width / num_heads;
  const int head = col0 / head_dim;
  int64_t start = bounds[row];
  int64_t end = bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > num_edges ? num_edges : end;
  float m = kNeg, l = 0.0f, acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  for (int64_t e0 = start; e0 < end; e0 += kEdgeGroup) {
    Word w[kEdgeGroup];
    float x[kEdgeGroup];
    bool live[kEdgeGroup];
#pragma unroll
    for (int u = 0; u < kEdgeGroup; ++u) {
      const int64_t e = e0 + u < end ? e0 + u : end - 1;  // past the row: its last edge, not added
      live[u] = e0 + u < end && (mask == nullptr || mask[e] != 0);
      x[u] = to_f32(scores[e * num_heads + head]);
      w[u] = *reinterpret_cast<const Word*>(values + e * width + col0);
    }
    if constexpr (sizeof(T) == 4) {
      // f32: the online step an edge, in edge order, as the V-column kernel;
      // taken for every slot and kept for the live ones, so no slot's
      // exponentials wait on a branch
#pragma unroll
      for (int u = 0; u < kEdgeGroup; ++u) {
        float v[W], m1 = m, l1 = l, a1[W];
        unpack_word<T, W>(w[u], v);
#pragma unroll
        for (int c = 0; c < W; ++c) a1[c] = acc[c];
        online_step<W>(m1, l1, a1, x[u], v);
        if (live[u]) {
          m = m1;
          l = l1;
#pragma unroll
          for (int c = 0; c < W; ++c) acc[c] = a1[c];
        }
      }
    } else {
      // bf16 stream: the window's maximum first, one rescale a window
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kEdgeGroup; ++u) {
        if (live[u]) m_new = fmaxf(m_new, x[u]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] *= alpha;
#pragma unroll
      for (int u = 0; u < kEdgeGroup; ++u) {
        if (!live[u]) continue;
        float v[W];
        unpack_word<T, W>(w[u], v);
        const float p = expf(x[u] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] += p * v[c];
      }
      m = m_new;
    }
  }
  float4* o = reinterpret_cast<float4*>(out + row * width + col0);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    o[i] = make_float4(acc[4 * i] / (l + kEps), acc[4 * i + 1] / (l + kEps), acc[4 * i + 2] / (l + kEps),
                       acc[4 * i + 3] / (l + kEps));
  }
  if (col0 % head_dim == 0) {
    ml[head * num_rows + row] = m;
    ml[(num_heads + head) * num_rows + row] = l;
  }
}

// ---- the f32 words that may span heads: one 16-byte word of 4 columns a
// lane, touching at most K heads (h0 .. h0 + K - 1 from the head of its
// first column h0); `lanes` lanes a row (a power of two), 32 / lanes rows a
// warp. forward_words' window loop and f32 online step, once for each head
// the word touches, each column taking its head's step.

// v[k] for a run-time k < K, by selects: no register array indexed at run
// time (which would live in local memory)
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K], int k) {
  float r = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j) r = k == j ? v[j] : r;
  return r;
}

template <int K>
__global__ void forward_span_words(const float* __restrict__ scores, const float* __restrict__ values,
                                   const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                                   float* __restrict__ out, float* __restrict__ ml, int64_t num_rows,
                                   int64_t num_edges, int width, int num_heads, int lanes) {
  constexpr int W = kF32WordCols;
  const int slot = threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWordWarps + threadIdx.y) * (kLanes / lanes) + slot;
  const int col0 = sub * W;
  if (row >= num_rows || col0 >= width) return;  // no shuffles: a lane past its row leaves at once
  const int head_dim = width / num_heads;
  const int head = col0 / head_dim;
  int hk[K], of[W];  // the word's heads; each column's head slot k (its head hk[k])
#pragma unroll
  for (int k = 0; k < K; ++k) hk[k] = head + k < num_heads ? head + k : num_heads - 1;
#pragma unroll
  for (int c = 0; c < W; ++c) of[c] = (col0 + c) / head_dim - head;
  int64_t start = bounds[row];
  int64_t end = bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > num_edges ? num_edges : end;
  float m[K], l[K], acc[W];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m[k] = kNeg;
    l[k] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  for (int64_t e0 = start; e0 < end; e0 += kEdgeGroup) {
    uint4 w[kEdgeGroup];
    float x[kEdgeGroup][K];
    bool live[kEdgeGroup];
#pragma unroll
    for (int u = 0; u < kEdgeGroup; ++u) {
      const int64_t e = e0 + u < end ? e0 + u : end - 1;  // past the row: its last edge, not added
      live[u] = e0 + u < end && (mask == nullptr || mask[e] != 0);
#pragma unroll
      for (int k = 0; k < K; ++k) x[u][k] = scores[e * num_heads + hk[k]];
      w[u] = *reinterpret_cast<const uint4*>(values + e * width + col0);
    }
    // the online step an edge, in edge order, once a head the word touches;
    // taken for every slot and kept for the live ones, so no slot's
    // exponentials wait on a branch
#pragma unroll
    for (int u = 0; u < kEdgeGroup; ++u) {
      float v[W], m1[K], l1[K], alpha[K], p[K], a1[W];
      unpack_word<float, W>(w[u], v);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m_new = fmaxf(m[k], x[u][k]);
        alpha[k] = expf(m[k] - m_new);
        p[k] = expf(x[u][k] - m_new);
        l1[k] = l[k] * alpha[k] + p[k];
        m1[k] = m_new;
      }
#pragma unroll
      for (int c = 0; c < W; ++c) a1[c] = acc[c] * pick<K>(alpha, of[c]) + pick<K>(p, of[c]) * v[c];
      if (live[u]) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          m[k] = m1[k];
          l[k] = l1[k];
        }
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] = a1[c];
      }
    }
  }
  *reinterpret_cast<float4*>(out + row * width + col0) =
      make_float4(acc[0] / (pick<K>(l, of[0]) + kEps), acc[1] / (pick<K>(l, of[1]) + kEps),
                  acc[2] / (pick<K>(l, of[2]) + kEps), acc[3] / (pick<K>(l, of[3]) + kEps));
  // the lane of each head's first column writes its m and l
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if ((col0 + c) % head_dim == 0) {
      const int h = (col0 + c) / head_dim;
      ml[h * num_rows + row] = pick<K>(m, of[c]);
      ml[(num_heads + h) * num_rows + row] = pick<K>(l, of[c]);
    }
  }
}

// The columns of T a lane owns in a word geometry, or 0 for the others;
// `lanes` the lanes a row then takes. f32: 4 (a 16-byte word) where a head
// is 4k wide, D <= 128 and values and out 16-byte aligned (the rule of
// ops/csr_attention.py softmax_spmm_geometry); bf16: 8 or 4 where the head
// width, D and the alignment of values and out allow (stream_geometry,
// K5's rule).
template <typename T>
int word_columns(int width, int num_heads, const void* values, const void* out, int& lanes) {
  const int head_dim = width / num_heads;
  for (int w : {8, 4}) {
    if (head_dim % w != 0 || width > kLanes * w) continue;
    if (sizeof(T) == 4 && w != kF32WordCols) continue;
    if (reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(values) % (sizeof(T) * w) != 0) {
      continue;
    }
    lanes = 1;
    while (lanes * w < width) lanes *= 2;
    return w;
  }
  return 0;
}

// The most heads a word of `cols` columns touches, over the row's words.
inline int heads_a_word(int width, int num_heads, int cols) {
  const int head_dim = width / num_heads;
  int most = 1;
  for (int c0 = 0; c0 < width; c0 += cols) {
    const int k = (c0 + cols - 1) / head_dim - c0 / head_dim + 1;
    most = k > most ? k : most;
  }
  return most;
}

template <typename T, int W>
cudaError_t launch_words(const void* scores, const void* values, const void* bounds, const void* mask,
                         void* out, void* ml, long long num_rows, long long num_edges, int num_heads,
                         int width, int lanes, cudaStream_t stream) {
  const long long rows = static_cast<long long>(kWordWarps) * (kLanes / lanes);  // a block
  const dim3 block(kLanes, kWordWarps);
  const dim3 grid(static_cast<unsigned>((num_rows + rows - 1) / rows));
  forward_words<T, W><<<grid, block, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<const T*>(values), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(ml), num_rows,
      num_edges, width, num_heads, lanes);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_span_words(const void* scores, const void* values, const void* bounds, const void* mask,
                              void* out, void* ml, long long num_rows, long long num_edges, int num_heads,
                              int width, int lanes, cudaStream_t stream) {
  const long long rows = static_cast<long long>(kWordWarps) * (kLanes / lanes);  // a block
  const dim3 block(kLanes, kWordWarps);
  const dim3 grid(static_cast<unsigned>((num_rows + rows - 1) / rows));
  forward_span_words<K><<<grid, block, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(values), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(ml), num_rows,
      num_edges, width, num_heads, lanes);
  return cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch(const void* scores, const void* values, const void* bounds,
                   const void* mask, void* out, void* ml, long long num_rows,
                   long long num_edges, int num_heads, cudaStream_t stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  csr_softmax_spmm_kernel<V, T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<const T*>(values),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<float*>(ml), num_rows, num_edges,
      num_heads, (kLanes * V) / num_heads);
  return cudaGetLastError();
}

// K, the most heads a 4-column word touches, of the words that span heads: 2
// (heads of 2 columns or more that are not 4k wide) or 4 (heads of 1; no
// width gives 3: 4 columns from a multiple of 4 touch 4 heads of one
// column, else at most 2). K = 1 is forward_words' 16-byte words of one
// head, taken first.
#define F32_SPAN_CASES(CASE) CASE(2) CASE(4)

// The word geometry of width D, heads and alignment where one applies,
// else the V-column kernel's instantiation of width D = 32 V for element
// type T where it takes the shape and alignment, else (f32) the 16-byte
// words that may span heads where they hold the row, else the general geometry
// (softmax_general.cuh) on one edge set.
template <typename T>
int run(const void* scores, const void* values, const void* bounds, const void* mask, void* out,
        void* ml, long long num_rows, long long num_edges, int num_heads, int width,
        void* stream) {
  if (num_rows <= 0) return 0;
  if (!softmax_general::valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int lanes = 0;
  const int w = word_columns<T>(width, num_heads, values, out, lanes);
  if constexpr (sizeof(T) == 2) {
    if (w == 8) {
      return static_cast<int>(launch_words<T, 8>(scores, values, bounds, mask, out, ml, num_rows, num_edges,
                                                 num_heads, width, lanes, s));
    }
  }
  if (w == 4) {
    return static_cast<int>(launch_words<T, 4>(scores, values, bounds, mask, out, ml, num_rows, num_edges,
                                               num_heads, width, lanes, s));
  }
  if (softmax_general::v_columns(width, num_heads, sizeof(T), {values})) {
#define CASE(V) \
  case V:       \
    return static_cast<int>(launch<V, T>(scores, values, bounds, mask, out, ml, num_rows, num_edges, num_heads, s));
    switch (width / kLanes) {
      CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
      CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef CASE
  }
  if constexpr (sizeof(T) == 4) {
    // 16-byte words that may span heads (the rule of ops/csr_attention.py
    // softmax_spmm_words, K3's too)
    word_heads::WordGeometry geo;
    if (word_heads::blocked_word_geometry(width, num_heads, word_heads::alignment_of({values, out}), &geo)) {
      switch (heads_a_word(width, num_heads, geo.cols)) {
#define CASE(K)                                                                                              \
  case K:                                                                                                    \
    return static_cast<int>(launch_span_words<K>(scores, values, bounds, mask, out, ml, num_rows, num_edges, \
                                                 num_heads, width, geo.lanes, s));
        F32_SPAN_CASES(CASE)
#undef CASE
        default:
          return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  const softmax_general::EdgeSetOf<T> edges{static_cast<const T*>(scores), static_cast<const T*>(values),
                                            static_cast<const int32_t*>(bounds),
                                            static_cast<const uint8_t*>(mask), num_edges};
  return static_cast<int>(softmax_general::launch_forward<1, T>(
      softmax_general::EdgeSets<T, 1>{{edges}}, static_cast<float*>(out), static_cast<float*>(ml), num_rows,
      width, num_heads, s));
}

}  // namespace

// scores [E, H] f32, values [E, D] f32, bounds [2, N] int32, mask [E] bool
// (or null), out [N, D] f32, ml [2H, N] f32; all device pointers,
// contiguous, of any element alignment. D <= 512 and D % H == 0 (the
// wrapper checks; other shapes return cudaErrorInvalidValue): 16-byte words
// where a head is 4k wide, D <= 128 and values and out 16-byte aligned; else
// V = D/32 columns a lane where a head is whole V-column lanes and the
// values aligned to their loads; else words that may span heads where 32
// lanes of them hold the row and H <= 16; else the general geometry. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_softmax_spmm_f32(const void* scores, const void* values,
                                    const void* bounds, const void* mask,
                                    void* out, void* ml, long long num_rows,
                                    long long num_edges, int num_heads,
                                    int width, void* stream) {
  return run<float>(scores, values, bounds, mask, out, ml, num_rows, num_edges, num_heads, width,
                    stream);
}

// The same with scores [E, H] and values [E, D] in bf16: stream_dtype="bf16",
// in the 16-byte, 8-byte, V-column or general geometry by width, heads and
// alignment. out and ml stay f32.
extern "C" int csr_softmax_spmm_bf16_stream(const void* scores, const void* values,
                                            const void* bounds, const void* mask,
                                            void* out, void* ml, long long num_rows,
                                            long long num_edges, int num_heads,
                                            int width, void* stream) {
  return run<__nv_bfloat16>(scores, values, bounds, mask, out, ml, num_rows, num_edges,
                            num_heads, width, stream);
}
