// Device code shared by the fused CSR attention forward (csr_attention.cu)
// and backward (csr_attention_bwd.cu): the lane geometry, row ranges,
// vector loads, per-head sums and the score of one edge. The backward
// recomputes each score with the forward's own `edge_scores`, so the two
// round alike.
//
// Geometry. A group of G lanes (G in {8, 16, 32}, aligned inside its warp)
// serves one sender row; lane `sub` of the group owns the V = D/G
// consecutive floats [sub*V, sub*V + V) of a node row of width D, in memory
// order, and loads them as 16- or 8-byte vectors where V allows. A node
// row holds its H heads in one of two layouts:
//   blocked      [H, Dh]  (a contiguous [N, H, Dh] tensor): column c is in
//                head c / Dh; with Dh % V == 0 a lane's columns lie in one
//                head, and the head's Dh/V lanes are an aligned group;
//   interleaved  [Dh, H]  (the (N, Dh, H) view that the model's Attention
//                passes as [N, H, Dh] with strides (D, 1, H)): column c is
//                in head c % H; with V % H == 0 a lane holds all H heads,
//                with H % V == 0 it holds V of them.
// Either way a lane keeps NP = (blocked ? 1 : min(V, H)) partial sums, its
// column i feeding partial i % NP, and a head's sum is the butterfly of
// that partial over the lanes whose xor offsets lie in [lo, hi) (blocked:
// lo = 1, hi = Dh/V; interleaved: lo = max(1, H/V), hi = G). A butterfly
// leaves the same bits in every lane of the set.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace csr_attention {

constexpr int kWarp = 32;
constexpr int kThreads = 128;      // threads per block: 4 warps
constexpr float kNeg = -1e30f;     // finite -inf stand-in, as the TPU kernel
constexpr float kEps = 1e-16f;     // the epsilon of the softmax's normalization

struct Geometry {
  int32_t lanes;        // G, lanes per sender row
  int32_t width;        // D
  int32_t heads;        // H
  int32_t head_dim;     // Dh
  int32_t interleaved;  // 1: [Dh, H] rows, 0: [H, Dh] rows
  int32_t lo, hi;       // xor offsets of a head's butterfly: lo, 2lo, ... < hi
};

// Lane `sub`'s row, its [start, end) edge range clamped to the edge array
// (empty past the last row), and its first column.
struct RowSlot {
  int64_t row;
  int64_t start;
  int32_t len;
  int32_t sub;
  int32_t col0;
  bool has_row;
};

template <int V>
__device__ __forceinline__ RowSlot row_slot(const Geometry& geo, const int32_t* __restrict__ bounds,
                                            int64_t num_rows, int64_t num_edges) {
  RowSlot r;
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  r.row = thread / geo.lanes;
  r.sub = static_cast<int32_t>(thread % geo.lanes);
  r.col0 = r.sub * V;
  r.has_row = r.row < num_rows;
  r.start = 0;
  r.len = 0;
  if (r.has_row) {
    int64_t start = bounds[r.row];
    int64_t end = bounds[num_rows + r.row];
    start = start < 0 ? 0 : (start > num_edges ? num_edges : start);
    end = end > num_edges ? num_edges : end;
    r.start = start;
    r.len = end > start ? static_cast<int32_t>(end - start) : 0;
  }
  return r;
}

// The head of partial p of the lane whose first column is col0.
__device__ __forceinline__ int head_of(const Geometry& geo, int col0, int p) {
  return geo.interleaved ? (col0 + p) % geo.heads : col0 / geo.head_dim;
}

// Whether this lane writes the per-head statistics of its partials: the
// first lane of each butterfly set.
__device__ __forceinline__ bool writes_heads(const Geometry& geo, int sub) {
  return (sub & (geo.hi - 1)) < geo.lo;
}

template <int V>
__device__ __forceinline__ void zero_cols(float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0f;
}

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
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// Node row j's columns of this lane, or zeros for j < 0 (no edge).
template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ base, int32_t j, int width, int col0,
                                         float (&v)[V]) {
  if (j >= 0) {
    load_cols<V>(base + static_cast<int64_t>(j) * width + col0, v);
  } else {
    zero_cols<V>(v);
  }
}

// Per-head sums of a[i] * b[i] over the lane's butterfly set, into part[NP];
// every lane of the warp must call it.
template <int V, int NP>
__device__ __forceinline__ void head_dots(const Geometry& geo, const float (&a)[V], const float (&b)[V],
                                          float (&part)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) part[p] = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) part[i % NP] += a[i] * b[i];
  for (int offset = geo.lo; offset < geo.hi; offset <<= 1) {
#pragma unroll
    for (int p = 0; p < NP; ++p) part[p] += __shfl_xor_sync(0xffffffffu, part[p], offset);
  }
}

// The scores of one edge per head: scale * <q[n, h, :], k[j, h, :]>.
template <int V, int NP>
__device__ __forceinline__ void edge_scores(const Geometry& geo, const float (&q)[V], const float (&k)[V],
                                            float scale, float (&s)[NP]) {
  head_dots<V, NP>(geo, q, k, s);
#pragma unroll
  for (int p = 0; p < NP; ++p) s[p] *= scale;
}

// The largest edge count of the warp's rows: the trip count every lane of
// the warp runs, so that the shuffles see the whole warp.
__device__ __forceinline__ int32_t warp_max(int32_t x) {
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    x = max(x, __shfl_xor_sync(0xffffffffu, x, offset));
  }
  return x;
}

// The gather index of edge `first + sub` of the row for this lane, -1 where
// that edge is past the range or masked: one coalesced load of a group's
// next G indices and mask bytes, broadcast later by shuffles.
__device__ __forceinline__ int32_t chunk_index(const int32_t* __restrict__ gather_idx,
                                               const uint8_t* __restrict__ mask, const RowSlot& r,
                                               int32_t first) {
  const int32_t t = first + r.sub;
  if (t >= r.len) return -1;
  const int64_t e = r.start + t;
  if (mask != nullptr && !mask[e]) return -1;
  return gather_idx[e];
}

// Validates a geometry on the host; returns false for one the kernels do
// not take.
inline bool make_geometry(int lanes, int width, int heads, int interleaved, int max_cols, Geometry* geo) {
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  if (!(lanes == 8 || lanes == 16 || lanes == 32) || heads <= 0 || width <= 0) return false;
  if (width % lanes || width % heads) return false;
  const int v = width / lanes;
  const int dh = width / heads;
  if (v > max_cols) return false;
  geo->lanes = lanes;
  geo->width = width;
  geo->heads = heads;
  geo->head_dim = dh;
  geo->interleaved = interleaved;
  if (!interleaved) {
    if (dh % v || !pow2(dh / v)) return false;
    geo->lo = 1;
    geo->hi = dh / v;
  } else if (v % heads == 0) {
    if (!pow2(heads)) return false;
    geo->lo = 1;
    geo->hi = lanes;
  } else if (heads % v == 0) {
    if (!pow2(v) || !pow2(heads / v) || heads / v > lanes) return false;
    geo->lo = heads / v;
    geo->hi = lanes;
  } else {
    return false;
  }
  return true;
}

// NP of a valid geometry.
inline int partials(const Geometry& geo) {
  const int v = geo.width / geo.lanes;
  return geo.interleaved ? (v < geo.heads ? v : geo.heads) : 1;
}

// The (V, NP) pairs a valid geometry can give: V in 1..16 and NP a power
// of two dividing V, one kernel instantiation each.
#define CSR_ATTENTION_CASES(CASE)                                                   \
  CASE(1, 1) CASE(2, 1) CASE(2, 2) CASE(3, 1) CASE(4, 1) CASE(4, 2) CASE(4, 4)      \
  CASE(5, 1) CASE(6, 1) CASE(6, 2) CASE(7, 1) CASE(8, 1) CASE(8, 2) CASE(8, 4)      \
  CASE(8, 8) CASE(9, 1) CASE(10, 1) CASE(10, 2) CASE(11, 1) CASE(12, 1) CASE(12, 2) \
  CASE(12, 4) CASE(13, 1) CASE(14, 1) CASE(14, 2) CASE(15, 1) CASE(16, 1)           \
  CASE(16, 2) CASE(16, 4) CASE(16, 8) CASE(16, 16)

}  // namespace csr_attention
