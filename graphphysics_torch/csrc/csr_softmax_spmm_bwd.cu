// Backward of the fused segment softmax + SpMM (K3), for Hopper (sm_90a).
// With the forward's statistics m, l per node and head, its output out and
// the output's gradient g, for each node n and head h:
//
//   delta[n, h]    = sum over the head's columns c of out[n, c] * g[n, c]
//
// and for each real unmasked edge e of node n:
//
//   attn[e, h]     = exp(scores[e, h] - m[h, n]) / (l[h, n] + 1e-16)
//   dvalues[e, c]  = attn[e, h(c)] * g[n, c]
//   dscores[e, h]  = attn[e, h] * (sum over the head's c of values[e, c] * g[n, c]
//                                  - delta[n, h])
//
// Every other edge (masked, outside every range, padding) gets exactly 0,
// and so does every edge of a row without real unmasked edges (m = -1e30,
// l = 0), with no NaN.
//
// Replaces the backward of the TPU kernel's custom VJP, `_bwd` with
// `_pack_node_side` and `_edge_grads` in graphphysics_tpu/ops/pallas_attention.py:
// XLA ops that pack [m | l | delta | g] per node with an all-zero row for
// masked edges, gather that pack per edge and do the per-edge math. Here
// the node side stays in registers and nothing is packed or gathered.
//
// Bound: memory. Per edge and column a few multiply-adds, per edge and head
// one exponential: far below the card's operations-per-byte balance. With
// E the real edges (inside the ranges), E_pad every edge, N the nodes, H
// the heads and D the width, the bytes that must move are
//   reads   E*(4H + 4D + 1)        scores, values, mask byte
//           + N*(8D + 8H + 8)      out and g rows, m and l, the two bounds
//   writes  E_pad*(4H + 4D)        dscores and dvalues, padding included.
//
// Design. One warp or lane group owns one sender row, as in the forward
// (csr_softmax_spmm.cu): no atomics, nothing shared between rows, every
// sum in a fixed order (two runs give the same bits). Three geometries,
// chosen before the launch by width, heads and alignment (the rule of
// ops/csr_attention.py softmax_spmm_columns):
// - V columns, where D = 32 V, a head's width is a multiple of V and values,
//   out, g and dvalues are aligned to the vector accesses of V columns
//   (4 min(4, V & -V) bytes). Each lane owns V = D/32 contiguous columns,
//   all inside one head, so the 32/H lanes of a head are an aligned group
//   of a power-of-two size, and a head's sums (delta, and per edge the
//   values . g dot) are butterfly shuffles within that group (xor offsets
//   below the group size never leave it). The warp loads the row's g and
//   out once, reduces delta, reads m and l, then walks the row's edges: per
//   edge one 16- or 8-byte vector load of the value columns and one store
//   of dvalues, and the head's first lane stores dscores. The edges no
//   range covers are zeroed by the warp of the row just before them: row r
//   writes zeros to [end_r, start_{r+1}) (the last row up to E, row 0 also
//   [0, start_0)). That covers every edge once because the ranges ascend
//   and do not overlap, as the padding (graphphysics_torch/core/graph.py)
//   and concat_graphs lay them out; the wrapper trusts that layout as the
//   forward does.
// - 16-byte words, where the V columns do not take the width, D % 4 == 0,
//   the arrays are 16-byte aligned and 32 lanes of words hold the row with
//   at most 16 heads (word_heads.cuh blocked_word_geometry, K2's f32 rule
//   too: D = 48 in 4 heads of 12, 96 in 3 of 32, 40 in 8 of 5): a lane owns
//   one word of 4 adjacent columns, loaded and stored as one vector; a row
//   takes L lanes (D / 4 rounded up to a power of two, and to the power of
//   two at least H), 32 / L rows a warp. A head's sums (delta = <out, g>
//   once a row, and per edge <values, g>) are word_heads.cuh's, the fused
//   word kernels' (attention_words.cuh): a lane's partials in column
//   order, then reduce-scattered by shuffles to one head a lane, ALIGNED
//   where a head's words are a power-of-two group of lanes (96 x 3: 8
//   lanes a head; P = 1) and a select by each column's head elsewhere
//   (48 x 4, 40 x 8: P = 4, 8); no shared memory and no barrier. A lane
//   holding a head reads its m, l and the edge's score, computes attn =
//   exp(s - m) / (l + 1e-16) once, and one lane a head stores dscores =
//   attn (<v, g> - delta), so a row's head lanes store consecutive floats;
//   the columns read attn back from their head's lane by shuffles and
//   store dvalues = attn g as one word. attn and dvalues take the general
//   geometry's operands, so dvalues are the same bits; dscores sum <v, g>
//   and delta in another order. The warp walks its rows' ranges in windows
//   of kWordEdges edges (every lane of the warp takes every window: the
//   shuffles name the whole warp, the rows past the last in the last warp
//   included): the window's mask bytes, scores and value words load
//   together without a branch (a slot past a row's end reads its last edge
//   and stores nothing), their <values, g> sums go through one
//   reduce-scatter together. Masked edges in a range get 0; each row's L
//   lanes zero the edges between its range's end and the next row's start
//   (row 0 also [0, start_0), the last row up to E) as flat spans of words
//   and floats. 8- and 4-byte words ran slower than the general geometry
//   at 40 x 8 and 20 x 4 on an H100 (chip_compare.py --k2, PERF.md).
// - The general geometry (softmax_general.cuh, K5's backward on one edge
//   set) for every other width and view with D <= 512 and D % H == 0 (D =
//   160 in 5 heads of 32: 40 words, past 32 lanes; a 4-byte view past 32
//   columns; more than 16 heads): lane j owns the columns j, j + 32, ..., a
//   head's sums are butterflies over the warp or a lane group where its
//   columns are whole 32-column slots or aligned groups, else sums through
//   shared memory; the same zeros on masked edges and on the edges no range
//   covers.
// The models' attention does not run this kernel: csr_attention_bwd.cu
// fuses the backward of the q/k/v gathers and the per-edge dot products
// into the same loop. The unsplit partitioned attention runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_general.cuh"
#include "word_heads.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block
constexpr float kEps = 1e-16f;    // the epsilon of the forward's normalization
constexpr int kWordWarps = 4;     // warps per block (word geometry)
constexpr int kWordEdges = 2;     // edges a lane has in flight (word geometry; 4 and 8 ran slower on an H100)

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

template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// Sum of x over the aligned group of `group` lanes (a power of two) that
// holds this lane; every lane of the warp must call it.
__device__ __forceinline__ float group_sum(float x, int group) {
  for (int offset = group >> 1; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

template <int V>
__device__ __forceinline__ void zero_edges(float* __restrict__ dscores,
                                           float* __restrict__ dvalues, int64_t first,
                                           int64_t last, int32_t num_heads, int col0,
                                           int head, bool head_lane) {
  constexpr int width = kLanes * V;
  float zeros[V];
#pragma unroll
  for (int c = 0; c < V; ++c) zeros[c] = 0.0f;
  for (int64_t e = first; e < last; ++e) {
    store_cols<V>(dvalues + e * width + col0, zeros);
    if (head_lane) dscores[e * num_heads + head] = 0.0f;
  }
}

template <int V>
__global__ void csr_softmax_spmm_bwd_kernel(const float* __restrict__ scores,
                                            const float* __restrict__ values,
                                            const int32_t* __restrict__ bounds,
                                            const uint8_t* __restrict__ mask,
                                            const float* __restrict__ ml,
                                            const float* __restrict__ out,
                                            const float* __restrict__ g,
                                            float* __restrict__ dscores,
                                            float* __restrict__ dvalues,
                                            int64_t num_rows, int64_t num_edges,
                                            int32_t num_heads, int32_t head_dim) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  constexpr int width = kLanes * V;
  const int col0 = threadIdx.x * V;
  const int head = col0 / head_dim;
  const int group = head_dim / V;  // lanes of one head: 32 / H
  const bool head_lane = col0 % head_dim == 0;

  // bounds is [2, num_rows]: starts, then ends; clamp to the edge array
  auto clamp = [num_edges](int64_t x) { return x < 0 ? 0 : (x > num_edges ? num_edges : x); };
  const int64_t start = clamp(bounds[row]);
  const int64_t end = clamp(bounds[num_rows + row]);
  const int64_t next = row + 1 < num_rows ? clamp(bounds[row + 1]) : num_edges;

  float gr[V];
  load_cols<V>(g + row * width + col0, gr);
  float delta;
  {
    float o[V];
    load_cols<V>(out + row * width + col0, o);
    delta = 0.0f;
#pragma unroll
    for (int c = 0; c < V; ++c) delta += o[c] * gr[c];
  }
  delta = group_sum(delta, group);
  const float m = ml[head * num_rows + row];
  const float l = ml[(num_heads + head) * num_rows + row];

  for (int64_t e = start; e < end; ++e) {
    const bool live = mask == nullptr || mask[e];  // uniform across the warp
    float attn = 0.0f;
    float dot = 0.0f;
    if (live) {
      attn = expf(scores[e * num_heads + head] - m) / (l + kEps);
      float v[V];
      load_cols<V>(values + e * width + col0, v);
#pragma unroll
      for (int c = 0; c < V; ++c) dot += v[c] * gr[c];
    }
    dot = group_sum(dot, group);
    float dv[V];
#pragma unroll
    for (int c = 0; c < V; ++c) dv[c] = attn * gr[c];
    store_cols<V>(dvalues + e * width + col0, dv);
    if (head_lane) dscores[e * num_heads + head] = live ? attn * (dot - delta) : 0.0f;
  }
  // the edges no range covers: after this row's range up to the next one's
  zero_edges<V>(dscores, dvalues, end, next, num_heads, col0, head, head_lane);
  if (row == 0) zero_edges<V>(dscores, dvalues, 0, start, num_heads, col0, head, head_lane);
}

// ---- the word geometry (word_heads.cuh): W = 4 columns a lane as one
// 16-byte word, L lanes a row, 32 / L rows a warp.

// Lane `sub`'s row, its [start, end) range clamped to the edge array (empty
// past the last row), its first column, and whether it owns a word.
struct WordRow {
  int64_t row;
  int64_t start;
  int64_t end;
  int32_t len;
  int32_t sub;
  int32_t col0;
  bool has_row;
  bool live;
};

// The largest x over the warp (every lane of the warp must call it).
__device__ __forceinline__ int32_t warp_max(int32_t x) {
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset >>= 1) x = max(x, __shfl_xor_sync(word_heads::kFull, x, offset));
  return x;
}

// 0 into the gradients of the edges [first, last) by the row's L lanes, as
// the flat spans of dvalues' 16-byte words (4 divides D) and of dscores'
// floats
template <int W>
__device__ __forceinline__ void zero_span(float* __restrict__ dscores, float* __restrict__ dvalues, int64_t first,
                                          int64_t last, const word_heads::WordGeometry& geo, int sub) {
  if (last <= first) return;
  float zeros[W];
#pragma unroll
  for (int c = 0; c < W; ++c) zeros[c] = 0.0f;
  const int64_t words = geo.width / W;
  for (int64_t k = first * words + sub; k < last * words; k += geo.lanes) store_cols<W>(dvalues + k * W, zeros);
  for (int64_t k = first * geo.heads + sub; k < last * geo.heads; k += geo.lanes) dscores[k] = 0.0f;
}

template <int W, int P, bool ALIGNED>
__global__ void __launch_bounds__(kLanes * kWordWarps)
backward_words(const float* __restrict__ scores, const float* __restrict__ values,
               const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
               const float* __restrict__ ml, const float* __restrict__ out, const float* __restrict__ g,
               float* __restrict__ dscores, float* __restrict__ dvalues, int64_t num_rows, int64_t num_edges,
               word_heads::WordGeometry geo) {
  using namespace word_heads;
  using Hd = Heads<W, P, ALIGNED>;
  WordRow r;
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * (kLanes * kWordWarps) + threadIdx.x;
  r.row = thread / geo.lanes;
  r.sub = static_cast<int32_t>(thread % geo.lanes);
  r.col0 = r.sub * W;
  r.live = r.col0 < geo.width;
  r.has_row = r.row < num_rows;
  r.start = r.end = 0;
  r.len = 0;
  int64_t next = 0;
  if (r.has_row) {
    auto clamp = [num_edges](int64_t x) { return x < 0 ? 0 : (x > num_edges ? num_edges : x); };
    r.start = clamp(bounds[r.row]);
    r.end = clamp(bounds[num_rows + r.row]);
    r.len = r.end > r.start ? static_cast<int32_t>(r.end - r.start) : 0;
    next = r.row + 1 < num_rows ? clamp(bounds[r.row + 1]) : num_edges;
  }
  const bool words = r.has_row && r.live;
  float gr[W], o[W];
  if (words) {
    load_cols<W>(g + r.row * geo.width + r.col0, gr);
    load_cols<W>(out + r.row * geo.width + r.col0, o);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) gr[i] = o[i] = 0.0f;
  }
  const Hd h = make_heads<W, P, ALIGNED>(geo, r);
  const float delta = head_sum<W, P, ALIGNED>(geo, r, h, o, gr);
  // a lane holding a head reads its m, l and scores; one of them writes its dscores
  const bool holds = r.has_row && h.own < geo.heads;
  float m = 0.0f, l = 0.0f;
  if (holds) {
    m = ml[h.own * num_rows + r.row];
    l = ml[(geo.heads + h.own) * num_rows + r.row];
  }
  const int32_t trips = warp_max(r.len);  // every lane of the warp takes every window
  for (int32_t t0 = 0; t0 < trips; t0 += kWordEdges) {
    int64_t e[kWordEdges];
    bool in[kWordEdges], live[kWordEdges];
    float s[kWordEdges], v[kWordEdges][W], gv[kWordEdges][W], dot[kWordEdges];
    // the window's loads, without a branch: a slot past the row reads its
    // last edge (an empty row edge 0) and writes nothing
#pragma unroll
    for (int u = 0; u < kWordEdges; ++u) {
      const int32_t t = t0 + u;
      in[u] = t < r.len;
      e[u] = r.len > 0 ? r.start + (in[u] ? t : r.len - 1) : 0;
      live[u] = in[u] && (mask == nullptr || mask[e[u]] != 0);
      s[u] = holds ? scores[e[u] * geo.heads + h.own] : 0.0f;
      if (r.live) {
        load_cols<W>(values + e[u] * geo.width + r.col0, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) v[u][i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < W; ++i) gv[u][i] = gr[i];
    }
    head_sums<kWordEdges, W, P, ALIGNED>(geo, r, h, v, gv, dot);  // <values, g> a head, the window's edges
#pragma unroll
    for (int u = 0; u < kWordEdges; ++u) {
      // the head's weight, once a head; its columns read it back
      const float attn = live[u] ? expf(s[u] - m) / (l + kEps) : 0.0f;
      if (in[u] && h.writes && r.has_row) dscores[e[u] * geo.heads + h.own] = live[u] ? attn * (dot[u] - delta) : 0.0f;
      float attns[Hd::kValues];
      read_back<W, P, ALIGNED>(geo, h, attn, attns);
      if (in[u] && words) {
        float dv[W];
#pragma unroll
        for (int i = 0; i < W; ++i) dv[i] = live[u] ? attns[value_of<W, P, ALIGNED>(i)] * gr[i] : 0.0f;
        store_cols<W>(dvalues + e[u] * geo.width + r.col0, dv);
      }
    }
  }
  if (!r.has_row) return;  // past the last shuffle
  // the edges no range covers: after this row's range up to the next one's
  zero_span<W>(dscores, dvalues, r.end < r.start ? r.start : r.end, next, geo, r.sub);
  if (r.row == 0) zero_span<W>(dscores, dvalues, 0, r.start, geo, r.sub);
}

// (W, P, ALIGNED) of K3's word geometry on head-blocked rows (16-byte words):
// P = 1 where a head's words are a power-of-two group of lanes (or H = 1),
// else the select
#define K3_WORD_CASES(CASE) \
  CASE(4, 1, true) CASE(4, 2, false) CASE(4, 4, false) CASE(4, 8, false) CASE(4, 16, false)

template <int W, int P, bool ALIGNED>
cudaError_t launch_words(const void* scores, const void* values, const void* bounds, const void* mask,
                         const void* ml, const void* out, const void* g, void* dscores, void* dvalues,
                         long long num_rows, long long num_edges, const word_heads::WordGeometry& geo,
                         cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const int block = kLanes * kWordWarps;
  const dim3 grid(static_cast<unsigned>((threads + block - 1) / block));
  backward_words<W, P, ALIGNED><<<grid, block, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(values), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(ml), static_cast<const float*>(out),
      static_cast<const float*>(g), static_cast<float*>(dscores), static_cast<float*>(dvalues), num_rows,
      num_edges, geo);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(const void* scores, const void* values, const void* bounds,
                   const void* mask, const void* ml, const void* out, const void* g,
                   void* dscores, void* dvalues, long long num_rows, long long num_edges,
                   int num_heads, cudaStream_t stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  csr_softmax_spmm_bwd_kernel<V><<<grid, block, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(values),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(ml), static_cast<const float*>(out),
      static_cast<const float*>(g), static_cast<float*>(dscores),
      static_cast<float*>(dvalues), num_rows, num_edges, num_heads,
      (kLanes * V) / num_heads);
  return cudaGetLastError();
}

}  // namespace

// scores [E, H] f32, values [E, D] f32, bounds [2, N] int32, mask [E] bool
// (or null), ml [2H, N] f32, out [N, D] f32, g [N, D] f32, dscores [E, H]
// f32, dvalues [E, D] f32; all device pointers, contiguous. D <= 512 and
// D % H == 0 (the wrapper checks; other shapes return
// cudaErrorInvalidValue): V = D/32 columns a lane where a head is whole
// V-column lanes and the [*, D] arrays aligned to their vector accesses,
// else 16-byte words where 32 lanes of them hold the row and H <= 16, else
// the general geometry. Writes every row of dscores and dvalues when N > 0. Launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).
extern "C" int csr_softmax_spmm_bwd_f32(const void* scores, const void* values,
                                        const void* bounds, const void* mask,
                                        const void* ml, const void* out, const void* g,
                                        void* dscores, void* dvalues, long long num_rows,
                                        long long num_edges, int num_heads, int width,
                                        void* stream) {
  if (num_rows <= 0 || num_edges <= 0) return 0;
  if (!softmax_general::valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softmax_general::v_columns(width, num_heads, 4, {values, out, g, dvalues})) {
#define CASE(V)                                                                        \
  case V:                                                                              \
    return static_cast<int>(launch<V>(scores, values, bounds, mask, ml, out, g, dscores, \
                                      dvalues, num_rows, num_edges, num_heads, s));
    switch (width / kLanes) {
      CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
      CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef CASE
  }
  word_heads::WordGeometry geo;
  if (word_heads::blocked_word_geometry(width, num_heads, word_heads::alignment_of({values, out, g, dvalues}),
                                        &geo)) {
#define CASE(W, P, ALIGNED)                                                                              \
  if (geo.cols == W && geo.partials == P && (geo.aligned != 0) == ALIGNED) {                            \
    return static_cast<int>(launch_words<W, P, ALIGNED>(scores, values, bounds, mask, ml, out, g, dscores, \
                                                        dvalues, num_rows, num_edges, geo, s));          \
  }
    K3_WORD_CASES(CASE)
#undef CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const softmax_general::EdgeSetOf<float> edges{
      static_cast<const float*>(scores), static_cast<const float*>(values),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask), num_edges};
  return static_cast<int>(softmax_general::launch_backward<1, true>(
      softmax_general::EdgeSets<float, 1>{{edges}},
      softmax_general::GradSets<1>{{static_cast<float*>(dscores)}, {static_cast<float*>(dvalues)}},
      static_cast<const float*>(ml), static_cast<const float*>(out), static_cast<const float*>(g), num_rows,
      width, num_heads, s));
}
