// Segment softmax + SpMM over the union of two edge sets that share one
// segment space (K5), forward and backward, for Hopper (sm_90a).
//
// Set a (the local edges of a partitioned part) and set b (its halo edges)
// are each sorted by receiver and carry their own per-row [start, end)
// ranges. For each row n, head h and column c of head h(c) = c / (D / H),
// over the real unmasked edges e of both sets' ranges of n:
//
//   m[h, n]   = max_e s[e, h]                                 (-1e30 if none)
//   l[h, n]   = sum_e exp(s[e, h] - m[h, n])
//   out[n, c] = sum_e exp(s[e, h(c)] - m[h(c), n]) * v[e, c] / (l[h(c), n] + 1e-16)
//
// so a row without such edges in either set gives out = 0, m = -1e30 and
// l = 0; ml = [m; l] is written as [2H, N] for the backward. The backward
// takes the output's gradient g and, per row, delta[n, h] = sum over the
// head's columns of out[n, c] * g[n, c]; then for every real unmasked edge
// of either set
//
//   attn[e, h]    = exp(s[e, h] - m[h, n]) / (l[h, n] + 1e-16)
//   dv[e, c]      = attn[e, h(c)] * g[n, c]
//   ds[e, h]      = attn[e, h] * (sum over the head's c of v[e, c] * g[n, c] - delta[n, h])
//
// against the merged statistics. The wrapper hands in zeroed gradient
// arrays: edges no range covers and masked edges keep 0.
//
// Replaces the TPU pair function `csr_softmax_spmm_pair` in
// graphphysics_tpu/ops/pallas_attention.py (forward `_pair_impl`, two
// launches of the Pallas kernel `_softmax_spmm_impl` and an XLA merge of
// their (m, l); backward `_pair_bwd` with `_pack_node_side` and
// `_edge_grads`, XLA ops). It is not two K2 launches and a merge: one warp
// walks its row's local range, then its halo range, with the online
// softmax's (m, l) and the accumulator in registers, and the merge is the
// online softmax itself.
//
// Bound: memory. Per edge and column one multiply-add, per edge and head
// two exponentials (forward); far below the card's operations-per-byte
// balance. With E the real edges of both sets, E_pad all their slots, N
// the rows, H the heads, D the width, the bytes that must move are
//   forward   E*(4H + 4D + 1) + N*16 (four bounds) + N*(4D + 8H) written
//   backward  E*(4H + 4D + 1) + N*(16 + 8D + 8H) read, E_pad*(4H + 4D) written.
//
// Design. One warp owns one row (one lane group in the bf16 stream's word
// geometries, below): no atomics, nothing shared between warps or groups,
// every sum in a fixed order, so two runs agree bit for bit (backward
// included: each edge belongs to one row and is written by that row's warp
// only). Two lane geometries. Where D % 32 == 0 and a head's columns split
// evenly over its lanes (every power-of-two head count of the models'
// widths) a lane owns D/32 adjacent columns of one head, as K2 and K3
// (csr_softmax_spmm.cu, csr_softmax_spmm_bwd.cu) do: one score and two
// exponentials a lane and edge, vector loads, a head's sums a butterfly
// within its lane group. Every other width takes the general geometry
// (softmax_general.cuh, on two edge sets; K2 and K3 run it on one): lane j
// owns the columns j, j + 32, ... below D (up to 16 of them: D <= 512), so
// a warp reads an edge's value row as coalesced 128-byte spans, for every
// D with D % H == 0. Each column keeps its head's running (m, l), which all
// columns of a head compute alike; the first column of a head writes its m
// and l. The backward's per-head sums over columns (delta, and per edge the
// values . g dot) are butterfly shuffles when a head's columns are whole
// 32-column slots or aligned lane groups (every D = 32k with H | k, and
// every head width dividing 32), else they go through shared memory; the
// lane of a head's first column writes its dscores.
//
// stream_dtype="bf16" (entry csr_softmax_spmm_pair_bf16_stream): JAX's pair
// runs both partials' K2 in its bf16 stream mode (pallas_attention.py:460,
// :255-302), which computes in f32 from scores and values rounded to bf16.
// The wrapper rounds them (one PyTorch cast each); the kernel reads both
// sets' bf16 scores and values, widens each element to f32 and merges in
// f32 as the f32 entry does; out and ml stay f32. Its bytes are
//   E*(2H + 2D + 1) + N*16 + N*(4D + 8H).
// Three geometries, chosen before the launch by shape and alignment (the
// rule of ops/csr_attention.py stream_geometry, K2's too):
// - 16-byte words, where a head's width is a multiple of 8, D <= 256 and
//   both sets' value arrays are 16-byte aligned: a lane owns 8 adjacent
//   columns of one head, read as one 16-byte word, reads one bf16 score an
//   edge and computes its exponentials once a head (not once a column). A
//   row takes L = D / 8 lanes (rounded up to a power of two), so a warp
//   serves 32 / L rows: two at D = 128, four at D = 64. A lane walks the
//   two ranges as one sequence (set a's edges, then set b's) in windows of
//   kEdgeGroup edges: it starts the loads of the window's mask bytes,
//   scores and words together, then takes the window's maximum, rescales
//   (m, l) and its sums once, and adds the live edges' weights and weighted
//   values in edge order: one exponential a live edge and one a window,
//   none of them waiting on the one before (an online softmax over the
//   edges one at a time chains two exponentials an edge; chosen from trial
//   builds on an H100). A warp at D = 128 keeps 2 x 16 x 8 words of 16
//   bytes in flight where the general geometry kept one 64-byte span of
//   one edge.
// - 8-byte words, where a head's width is a multiple of 4, D <= 128 and the
//   value arrays 8-byte aligned (D = 48 with 4 heads of 12): the same with
//   4 columns a lane.
// - the general geometry above for every other width and view (D = 40 with
//   8 heads of 5; a value array only 2- or 4-byte aligned): lane j owns the
//   columns j, j + 32, ..., each read as its own 2-byte load, and computes a
//   column's head's two exponentials for every column it owns.
// Each keeps the invariants above: one warp or lane group owns a row, no
// atomics, every sum in edge order, two runs give the same bits. The
// backward is the f32 one on the unrounded inputs with this pass's merged
// ml and out: JAX's `_pair_bwd`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "softmax_general.cuh"
#include "words.cuh"

#include <initializer_list>

namespace {

constexpr int kEdgeGroup = 8;  // edges a lane has in flight (bf16 word geometries)
constexpr int kWordWarps = 4;  // warps per block (bf16 word geometries)

using softmax_general::EdgeSetOf;
using softmax_general::EdgeSets;
using softmax_general::GradSets;
using softmax_general::kEps;
using softmax_general::kLanes;
using softmax_general::kNeg;
using softmax_general::kRowsPerBlock;
using softmax_general::row_range;
using EdgeSet = EdgeSetOf<float>;

// ---- the contiguous geometry: V = D/32 adjacent columns a lane, all in
// one head (D % 32 == 0 and (D/H) % V == 0, so H divides 32 and a head's
// lanes are an aligned group of G = 32/H, a power of two): one score and
// two exponentials a lane and edge, vector loads and stores of the columns,
// and a head's sums a butterfly within its group (log2 G shuffles).

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

// the sum of `x` over this lane's head group of `group` lanes
__device__ __forceinline__ float group_sum(float x, int group) {
  for (int off = group / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int V>
__device__ __forceinline__ void walk_fast(const EdgeSet& s, int64_t start, int64_t end, int col0,
                                          int head, int num_heads, float& m, float& l,
                                          float (&acc)[V]) {
  constexpr int width = kLanes * V;
  for (int64_t e = start; e < end; ++e) {
    if (s.mask != nullptr && !s.mask[e]) continue;
    const float x = s.scores[e * num_heads + head];
    float v[V];
    load_cols<V>(s.values + e * width + col0, v);
    const float m_new = fmaxf(m, x);
    const float alpha = expf(m - m_new);
    const float p = expf(x - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = acc[c] * alpha + p * v[c];
    m = m_new;
  }
}

template <int V>
__global__ void pair_forward_fast(EdgeSet a, EdgeSet b, float* __restrict__ out,
                                  float* __restrict__ ml, int64_t num_rows, int num_heads) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;
  constexpr int width = kLanes * V;
  const int head_dim = width / num_heads;
  const int col0 = threadIdx.x * V;
  const int head = col0 / head_dim;
  float m = kNeg, l = 0.0f, acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
  int64_t start, end;
  row_range(a, row, num_rows, start, end);
  walk_fast<V>(a, start, end, col0, head, num_heads, m, l, acc);
  row_range(b, row, num_rows, start, end);
  walk_fast<V>(b, start, end, col0, head, num_heads, m, l, acc);
  float o[V];
#pragma unroll
  for (int c = 0; c < V; ++c) o[c] = acc[c] / (l + kEps);
  store_cols<V>(out + row * width + col0, o);
  if (col0 % head_dim == 0) {
    ml[head * num_rows + row] = m;
    ml[(num_heads + head) * num_rows + row] = l;
  }
}

template <int V>
__device__ __forceinline__ void edge_grads_fast(const EdgeSet& s, float* __restrict__ ds,
                                                float* __restrict__ dv, int64_t start,
                                                int64_t end, int col0, int head, int num_heads,
                                                int group, float m, float l, float delta,
                                                const float (&g)[V]) {
  constexpr int width = kLanes * V;
  for (int64_t e = start; e < end; ++e) {
    if (s.mask != nullptr && !s.mask[e]) continue;  // its gradients stay 0
    const float attn = expf(s.scores[e * num_heads + head] - m) / (l + kEps);
    float v[V], d[V];
    load_cols<V>(s.values + e * width + col0, v);
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      d[c] = attn * g[c];
      dot += v[c] * g[c];
    }
    store_cols<V>(dv + e * width + col0, d);
    dot = group_sum(dot, group);
    if (threadIdx.x % group == 0) ds[e * num_heads + head] = attn * (dot - delta);
  }
}

template <int V>
__global__ void pair_backward_fast(EdgeSet a, EdgeSet b, const float* __restrict__ ml,
                                   const float* __restrict__ out, const float* __restrict__ g,
                                   float* __restrict__ ds_a, float* __restrict__ dv_a,
                                   float* __restrict__ ds_b, float* __restrict__ dv_b,
                                   int64_t num_rows, int num_heads) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // whole warps leave together
  constexpr int width = kLanes * V;
  const int head_dim = width / num_heads;
  const int group = head_dim / V;
  const int col0 = threadIdx.x * V;
  const int head = col0 / head_dim;
  float gr[V], o[V];
  load_cols<V>(g + row * width + col0, gr);
  load_cols<V>(out + row * width + col0, o);
  float delta = 0.0f;
#pragma unroll
  for (int c = 0; c < V; ++c) delta += o[c] * gr[c];
  delta = group_sum(delta, group);
  const float m = ml[head * num_rows + row];
  const float l = ml[(num_heads + head) * num_rows + row];
  int64_t start, end;
  row_range(a, row, num_rows, start, end);
  edge_grads_fast<V>(a, ds_a, dv_a, start, end, col0, head, num_heads, group, m, l, delta, gr);
  row_range(b, row, num_rows, start, end);
  edge_grads_fast<V>(b, ds_b, dv_b, start, end, col0, head, num_heads, group, m, l, delta, gr);
}

// ---- the bf16 stream's word geometries: W = 8 (16-byte words) or 4
// (8-byte words) adjacent bf16 columns of one head a lane (WordOf,
// unpack_word: words.cuh), `lanes` lanes a row (a power of two),
// 32 / lanes rows a warp.

template <int W>
__global__ void pair_forward_words(EdgeSetOf<__nv_bfloat16> a, EdgeSetOf<__nv_bfloat16> b,
                                   float* __restrict__ out, float* __restrict__ ml, int64_t num_rows,
                                   int width, int num_heads, int lanes) {
  using Word = typename WordOf<__nv_bfloat16, W>::type;
  const int slot = threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWordWarps + threadIdx.y) * (kLanes / lanes) + slot;
  const int col0 = sub * W;
  if (row >= num_rows || col0 >= width) return;  // no shuffles: a lane waits on no other
  const int head_dim = width / num_heads;
  const int head = col0 / head_dim;
  int64_t start_a, end_a, start_b, end_b;
  row_range(a, row, num_rows, start_a, end_a);
  row_range(b, row, num_rows, start_b, end_b);
  const int64_t len_a = end_a > start_a ? end_a - start_a : 0;
  const int64_t len = len_a + (end_b > start_b ? end_b - start_b : 0);
  float m = kNeg, l = 0.0f, acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  // slot t of the row's sequence: edge start_a + t of set a, then start_b +
  // t - len_a of set b
  for (int64_t t0 = 0; t0 < len; t0 += kEdgeGroup) {
    Word w[kEdgeGroup];
    float x[kEdgeGroup];
    bool live[kEdgeGroup];
#pragma unroll
    for (int u = 0; u < kEdgeGroup; ++u) {
      const int64_t t = t0 + u;
      live[u] = false;
      x[u] = 0.0f;
      w[u] = Word{};
      if (t < len) {
        const bool in_a = t < len_a;
        const int64_t e = in_a ? start_a + t : start_b + (t - len_a);
        const uint8_t* mask = in_a ? a.mask : b.mask;
        live[u] = mask == nullptr || mask[e] != 0;
        x[u] = __bfloat162float((in_a ? a.scores : b.scores)[e * num_heads + head]);
        w[u] = *reinterpret_cast<const Word*>((in_a ? a.values : b.values) + e * width + col0);
      }
    }
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
      unpack_word<__nv_bfloat16, W>(w[u], v);
      const float p = expf(x[u] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] += p * v[c];
    }
    m = m_new;
  }
  float o[W];
#pragma unroll
  for (int c = 0; c < W; ++c) o[c] = acc[c] / (l + kEps);
  store_cols<W>(out + row * width + col0, o);
  if (col0 % head_dim == 0) {
    ml[head * num_rows + row] = m;
    ml[(num_heads + head) * num_rows + row] = l;
  }
}

// The columns a lane owns in the bf16 stream's word geometries (8 or 4),
// or 0 for the general geometry; `lanes` the lanes a row then takes (the
// rule of ops/csr_attention.py stream_geometry, K2's too).
int word_columns(int width, int num_heads, std::initializer_list<const void*> values, int& lanes) {
  const int head_dim = width / num_heads;
  for (int w : {8, 4}) {
    if (head_dim % w != 0 || width > kLanes * w) continue;
    bool aligned = true;
    for (const void* p : values) aligned = aligned && reinterpret_cast<uintptr_t>(p) % (2 * w) == 0;
    if (!aligned) continue;
    lanes = 1;
    while (lanes * w < width) lanes *= 2;
    return w;
  }
  return 0;
}

// the contiguous geometry takes the width and head count, and its vector
// accesses need every column array 16-byte aligned
bool fast(int width, int num_heads, std::initializer_list<const void*> arrays) {
  if (width % kLanes != 0 || (width / num_heads) % (width / kLanes) != 0) return false;
  for (const void* p : arrays) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

template <typename T = float>
EdgeSetOf<T> edge_set(const void* scores, const void* values, const void* bounds,
                      const void* mask, long long num_edges) {
  return EdgeSetOf<T>{static_cast<const T*>(scores), static_cast<const T*>(values),
                      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask),
                      num_edges};
}

}  // namespace

#define PAIR_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// Set a: scores_a [Ea, H] f32, values_a [Ea, D] f32, bounds_a [2, N] int32,
// mask_a [Ea] bool or null; set b likewise. out [N, D] f32, ml [2H, N] f32.
// All device pointers, contiguous. D <= 512, D % H == 0 (else
// cudaErrorInvalidValue). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_softmax_spmm_pair_f32(const void* scores_a, const void* values_a,
                                         const void* bounds_a, const void* mask_a,
                                         const void* scores_b, const void* values_b,
                                         const void* bounds_b, const void* mask_b, void* out,
                                         void* ml, long long num_rows, long long edges_a,
                                         long long edges_b, int num_heads, int width,
                                         void* stream) {
  if (num_rows <= 0) return 0;
  if (!softmax_general::valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const EdgeSet a = edge_set(scores_a, values_a, bounds_a, mask_a, edges_a);
  const EdgeSet b = edge_set(scores_b, values_b, bounds_b, mask_b, edges_b);
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast(width, num_heads, {values_a, values_b, out})) {
#define FAST(V)                                                                               \
  case V:                                                                                     \
    pair_forward_fast<V><<<grid, block, 0, s>>>(a, b, static_cast<float*>(out),               \
                                                static_cast<float*>(ml), num_rows, num_heads); \
    break;
    switch (width / kLanes) {
      PAIR_CASES(FAST)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FAST
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(softmax_general::launch_forward<2, float>(
      EdgeSets<float, 2>{{a, b}}, static_cast<float*>(out), static_cast<float*>(ml), num_rows, width,
      num_heads, s));
}

// The same with both sets' scores and values in bf16 (stream_dtype="bf16"),
// in the 16-byte, 8-byte or general geometry by width, heads and
// alignment; out and ml f32.
extern "C" int csr_softmax_spmm_pair_bf16_stream(const void* scores_a, const void* values_a,
                                                 const void* bounds_a, const void* mask_a,
                                                 const void* scores_b, const void* values_b,
                                                 const void* bounds_b, const void* mask_b,
                                                 void* out, void* ml, long long num_rows,
                                                 long long edges_a, long long edges_b,
                                                 int num_heads, int width, void* stream) {
  if (num_rows <= 0) return 0;
  if (!softmax_general::valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const auto a = edge_set<__nv_bfloat16>(scores_a, values_a, bounds_a, mask_a, edges_a);
  const auto b = edge_set<__nv_bfloat16>(scores_b, values_b, bounds_b, mask_b, edges_b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<float*>(ml);
  int lanes = 0;
  const int w = reinterpret_cast<uintptr_t>(out) % 16 == 0
                    ? word_columns(width, num_heads, {values_a, values_b}, lanes)
                    : 0;
  if (w > 0) {
    const long long rows = static_cast<long long>(kWordWarps) * (kLanes / lanes);  // a block
    const dim3 block(kLanes, kWordWarps);
    const dim3 grid(static_cast<unsigned>((num_rows + rows - 1) / rows));
    if (w == 8) {
      pair_forward_words<8><<<grid, block, 0, s>>>(a, b, o, st, num_rows, width, num_heads, lanes);
    } else {
      pair_forward_words<4><<<grid, block, 0, s>>>(a, b, o, st, num_rows, width, num_heads, lanes);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(softmax_general::launch_forward<2, __nv_bfloat16>(
      EdgeSets<__nv_bfloat16, 2>{{a, b}}, o, st, num_rows, width, num_heads, s));
}

// The forward's inputs, its ml and out, and g [N, D] f32; ds_a [Ea, H],
// dv_a [Ea, D], ds_b [Eb, H], dv_b [Eb, D] f32, zeroed by the caller.
extern "C" int csr_softmax_spmm_pair_bwd_f32(
    const void* scores_a, const void* values_a, const void* bounds_a, const void* mask_a,
    const void* scores_b, const void* values_b, const void* bounds_b, const void* mask_b,
    const void* ml, const void* out, const void* g, void* ds_a, void* dv_a, void* ds_b,
    void* dv_b, long long num_rows, long long edges_a, long long edges_b, int num_heads,
    int width, void* stream) {
  if (num_rows <= 0) return 0;
  if (!softmax_general::valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const EdgeSet a = edge_set(scores_a, values_a, bounds_a, mask_a, edges_a);
  const EdgeSet b = edge_set(scores_b, values_b, bounds_b, mask_b, edges_b);
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast(width, num_heads, {values_a, values_b, out, g, dv_a, dv_b})) {
#define FAST(V)                                                                               \
  case V:                                                                                     \
    pair_backward_fast<V><<<grid, block, 0, s>>>(                                             \
        a, b, static_cast<const float*>(ml), static_cast<const float*>(out),                  \
        static_cast<const float*>(g), static_cast<float*>(ds_a), static_cast<float*>(dv_a),   \
        static_cast<float*>(ds_b), static_cast<float*>(dv_b), num_rows, num_heads);           \
    break;
    switch (width / kLanes) {
      PAIR_CASES(FAST)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FAST
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(softmax_general::launch_backward<2, false>(
      EdgeSets<float, 2>{{a, b}},
      GradSets<2>{{static_cast<float*>(ds_a), static_cast<float*>(ds_b)},
                  {static_cast<float*>(dv_a), static_cast<float*>(dv_b)}},
      static_cast<const float*>(ml), static_cast<const float*>(out), static_cast<const float*>(g),
      num_rows, width, num_heads, s));
}
