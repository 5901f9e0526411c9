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
// Design. One warp owns one row: no atomics, nothing shared between warps,
// every sum in a fixed order, so two runs agree bit for bit (backward
// included: each edge belongs to one row and is written by that row's warp
// only). Two lane geometries. Where D % 32 == 0 and a head's columns split
// evenly over its lanes (every power-of-two head count of the models'
// widths) a lane owns D/32 adjacent columns of one head, as K2 and K3
// (csr_softmax_spmm.cu, csr_softmax_spmm_bwd.cu) do: one score and two
// exponentials a lane and edge, vector loads, a head's sums a butterfly
// within its lane group. Every other width takes the general geometry:
// lane j owns the columns j, j + 32, ... below D (up to 16 of them:
// D <= 512), so a warp reads an edge's value row as coalesced 128-byte
// spans, for every D with D % H == 0. Each column keeps its head's running
// (m, l), which all columns of a head compute alike; the first column of a
// head writes its m and l. The backward's per-head sums over columns
// (delta, and per edge the values . g dot) are butterfly shuffles when a
// head's columns are whole 32-column slots or aligned lane groups (every
// D = 32k with H | k, and every head width dividing 32), else they go
// through shared memory; the lane of a head's first column writes its
// dscores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block
constexpr int kMaxWidth = 512;
constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernel
constexpr float kEps = 1e-16f;  // the epsilon of segment_softmax

struct EdgeSet {
  const float* scores;   // [E, H]
  const float* values;   // [E, D]
  const int32_t* bounds; // [2, N]
  const uint8_t* mask;   // [E] or null
  int64_t num_edges;
};

__device__ __forceinline__ void row_range(const EdgeSet& s, int64_t row, int64_t num_rows,
                                          int64_t& start, int64_t& end) {
  start = s.bounds[row];
  end = s.bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > s.num_edges ? s.num_edges : end;
}

template <int NC>
__device__ __forceinline__ void walk(const EdgeSet& s, int64_t start, int64_t end, int width,
                                     int num_heads, const int (&head)[NC], float (&m)[NC],
                                     float (&l)[NC], float (&acc)[NC]) {
  for (int64_t e = start; e < end; ++e) {
    if (s.mask != nullptr && !s.mask[e]) continue;
    const float* sc = s.scores + e * num_heads;
    const float* v = s.values + e * width;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      if (c < width) {
        const float x = sc[head[i]];
        const float m_new = fmaxf(m[i], x);
        const float alpha = expf(m[i] - m_new);
        const float p = expf(x - m_new);
        l[i] = l[i] * alpha + p;
        acc[i] = acc[i] * alpha + p * v[c];
        m[i] = m_new;
      }
    }
  }
}

template <int NC>
__global__ void pair_forward_kernel(EdgeSet a, EdgeSet b, float* __restrict__ out,
                                    float* __restrict__ ml, int64_t num_rows, int width,
                                    int num_heads) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;
  const int head_dim = width / num_heads;
  int head[NC];
  float m[NC], l[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = threadIdx.x + i * kLanes;
    head[i] = c < width ? c / head_dim : 0;
    m[i] = kNeg;
    l[i] = 0.0f;
    acc[i] = 0.0f;
  }
  int64_t start, end;
  row_range(a, row, num_rows, start, end);
  walk<NC>(a, start, end, width, num_heads, head, m, l, acc);
  row_range(b, row, num_rows, start, end);
  walk<NC>(b, start, end, width, num_heads, head, m, l, acc);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = threadIdx.x + i * kLanes;
    if (c < width) {
      out[row * width + c] = acc[i] / (l[i] + kEps);
      if (c % head_dim == 0) {
        ml[head[i] * num_rows + row] = m[i];
        ml[(num_heads + head[i]) * num_rows + row] = l[i];
      }
    }
  }
}

// How a row's per-head sums over columns are formed: a head's columns are
// whole 32-column slots (kWarp: butterfly over the warp, then the slots of
// a head added in order), aligned lane groups within a slot (kGroup:
// butterfly within the group), or neither (kShared: through shared memory,
// each lane adding its columns' head in order).
enum HeadSums { kWarp = 0, kGroup = 1, kShared = 2 };

__host__ __device__ inline int head_sums_mode(int head_dim) {
  if (head_dim % kLanes == 0) return kWarp;
  if (kLanes % head_dim == 0) return kGroup;
  return kShared;
}

// sums[i]: the sum of `p` over the head of this lane's column slot i
// (column threadIdx.x + 32 i; p is 0 past the width), on every lane
template <int NC>
__device__ __forceinline__ void column_head_sums(const float (&p)[NC], int mode, int head_dim,
                                                 int width, float* buf, float (&sums)[NC]) {
  if (mode == kWarp) {
    float t[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float v = p[i];
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      t[i] = v;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if ((kLanes * j) / head_dim == (kLanes * i) / head_dim) v += t[j];
      }
      sums[i] = v;
    }
  } else if (mode == kGroup) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float v = p[i];
      for (int off = head_dim / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      sums[i] = v;
    }
  } else {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      if (c < width) buf[c] = p[i];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      float v = 0.0f;
      if (c < width) {
        const int first = (c / head_dim) * head_dim;
        for (int j = 0; j < head_dim; ++j) v += buf[first + j];
      }
      sums[i] = v;
    }
  }
}

template <int NC>
__device__ __forceinline__ void edge_grads(const EdgeSet& s, float* __restrict__ ds,
                                           float* __restrict__ dv, int64_t start, int64_t end,
                                           int width, int num_heads, int head_dim, int mode,
                                           const int (&head)[NC], const float (&mc)[NC],
                                           const float (&lc)[NC], const float (&gc)[NC],
                                           const float (&delta)[NC], float* buf) {
  for (int64_t e = start; e < end; ++e) {
    if (s.mask != nullptr && !s.mask[e]) continue;  // its gradients stay 0
    const float* sc = s.scores + e * num_heads;
    const float* v = s.values + e * width;
    float attn[NC], prod[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      attn[i] = 0.0f;
      prod[i] = 0.0f;
      if (c < width) {
        attn[i] = expf(sc[head[i]] - mc[i]) / (lc[i] + kEps);
        dv[e * width + c] = attn[i] * gc[i];
        prod[i] = v[c] * gc[i];
      }
    }
    float dattn[NC];
    column_head_sums<NC>(prod, mode, head_dim, width, buf, dattn);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      if (c < width && c % head_dim == 0) {
        ds[e * num_heads + head[i]] = attn[i] * (dattn[i] - delta[i]);
      }
    }
  }
}

template <int NC>
__global__ void pair_backward_kernel(EdgeSet a, EdgeSet b, const float* __restrict__ ml,
                                     const float* __restrict__ out, const float* __restrict__ g,
                                     float* __restrict__ ds_a, float* __restrict__ dv_a,
                                     float* __restrict__ ds_b, float* __restrict__ dv_b,
                                     int64_t num_rows, int width, int num_heads) {
  __shared__ float shared[kRowsPerBlock][kMaxWidth];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // whole warps leave together
  float* buf = shared[threadIdx.y];
  const int head_dim = width / num_heads;
  const int mode = head_sums_mode(head_dim);
  int head[NC];
  float gc[NC], mc[NC], lc[NC], og[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = threadIdx.x + i * kLanes;
    head[i] = c < width ? c / head_dim : 0;
    gc[i] = mc[i] = lc[i] = og[i] = 0.0f;
    if (c < width) {
      gc[i] = g[row * width + c];
      mc[i] = ml[head[i] * num_rows + row];
      lc[i] = ml[(num_heads + head[i]) * num_rows + row];
      og[i] = out[row * width + c] * gc[i];
    }
  }
  float delta[NC];
  column_head_sums<NC>(og, mode, head_dim, width, buf, delta);
  int64_t start, end;
  row_range(a, row, num_rows, start, end);
  edge_grads<NC>(a, ds_a, dv_a, start, end, width, num_heads, head_dim, mode, head, mc, lc, gc,
                 delta, buf);
  row_range(b, row, num_rows, start, end);
  edge_grads<NC>(b, ds_b, dv_b, start, end, width, num_heads, head_dim, mode, head, mc, lc, gc,
                 delta, buf);
}

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

// the contiguous geometry takes the width and head count, and its vector
// accesses need every column array 16-byte aligned
bool fast(int width, int num_heads, std::initializer_list<const void*> arrays) {
  if (width % kLanes != 0 || (width / num_heads) % (width / kLanes) != 0) return false;
  for (const void* p : arrays) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

bool valid(int width, int num_heads) {
  return num_heads > 0 && width > 0 && width <= kMaxWidth && width % num_heads == 0;
}

EdgeSet edge_set(const void* scores, const void* values, const void* bounds, const void* mask,
                 long long num_edges) {
  return EdgeSet{static_cast<const float*>(scores), static_cast<const float*>(values),
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
  if (!valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
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
#define CASE(NC)                                                                              \
  case NC:                                                                                    \
    pair_forward_kernel<NC><<<grid, block, 0, s>>>(a, b, static_cast<float*>(out),            \
                                                   static_cast<float*>(ml), num_rows, width,  \
                                                   num_heads);                                \
    break;
  switch ((width + kLanes - 1) / kLanes) {
    PAIR_CASES(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
  return static_cast<int>(cudaGetLastError());
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
  if (!valid(width, num_heads)) return static_cast<int>(cudaErrorInvalidValue);
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
#define CASE(NC)                                                                              \
  case NC:                                                                                    \
    pair_backward_kernel<NC><<<grid, block, 0, s>>>(                                          \
        a, b, static_cast<const float*>(ml), static_cast<const float*>(out),                  \
        static_cast<const float*>(g), static_cast<float*>(ds_a), static_cast<float*>(dv_a),   \
        static_cast<float*>(ds_b), static_cast<float*>(dv_b), num_rows, width, num_heads);    \
    break;
  switch ((width + kLanes - 1) / kLanes) {
    PAIR_CASES(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
  return static_cast<int>(cudaGetLastError());
}
