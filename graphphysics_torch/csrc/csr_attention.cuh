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
// leaves the same bits in every lane of the set. These are the fast
// geometries; they need D % G == 0 and a power-of-two head split.
//
// The general geometry takes every other width D <= 16 G with D % H == 0:
// lane `sub` holds the V = ceil(D/G) strided columns sub + G i (so a group's
// loads stay coalesced as scalars), the columns past D are masked (the tail),
// and each column is its own partial (NP = V). A head's sum goes through the
// row's slice of shared memory: every lane writes its columns' products,
// the lanes sub, sub + G, ... sum one head each over its Dh columns and
// write the head's total back, and every lane reads the totals of its
// columns' heads, so a head is reduced over exactly the lanes that hold its
// columns whatever H and D are. It is the same kernel, instantiated with
// GEN = true.
//
// Element types. Node rows (q, k, v, out, g, dq) are float, the kernels'
// template parameter T, loaded as 16-byte float4s where V allows; all
// arithmetic is f32. The bf16 kernels (csr_attention_bf16.cu,
// csr_attention_bwd_bf16.cu) take this file's row slots, index chunks and
// general geometry with T = __nv_bfloat16 (scalar loads converted to f32,
// stores rounded to bf16 once) and their own 16-byte lanes
// (csr_attention_bf16.cuh).

#pragma once

#include <cuda_bf16.h>
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
  int32_t general;      // 1: the general geometry (strided columns, shared-memory head sums)
};

// The general geometry's shared memory: per row, D products and H head sums.
extern __shared__ float csr_attention_smem[];

// Lane `sub`'s row, its [start, end) edge range clamped to the edge array
// (empty past the last row), and its first column (its column i is col0 + i,
// or col0 + G i in the general geometry).
struct RowSlot {
  int64_t row;
  int64_t start;
  int32_t len;
  int32_t sub;
  int32_t col0;
  bool has_row;
};

template <int V, bool GEN>
__device__ __forceinline__ RowSlot row_slot(const Geometry& geo, const int32_t* __restrict__ bounds,
                                            int64_t num_rows, int64_t num_edges) {
  RowSlot r;
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  r.row = thread / geo.lanes;
  r.sub = static_cast<int32_t>(thread % geo.lanes);
  r.col0 = GEN ? r.sub : r.sub * V;
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

// Column i of the lane (general geometry: may lie past D, in the tail).
template <int V, bool GEN>
__device__ __forceinline__ int column(const Geometry& geo, const RowSlot& r, int i) {
  return GEN ? r.col0 + geo.lanes * i : r.col0 + i;
}

// The head of memory column c.
__device__ __forceinline__ int head_of_column(const Geometry& geo, int c) {
  return geo.interleaved ? c % geo.heads : c / geo.head_dim;
}

// The head of partial p of the lane (fast: partial p takes the columns
// i % NP == p; general: partial p is column p, which must be live).
template <int V, bool GEN>
__device__ __forceinline__ int head_of(const Geometry& geo, const RowSlot& r, int p) {
  return GEN ? head_of_column(geo, column<V, GEN>(geo, r, p))
             : (geo.interleaved ? (r.col0 + p) % geo.heads : r.col0 / geo.head_dim);
}

// Whether partial p of the lane holds a column of the row (false only for
// the general geometry's tail).
template <int V, bool GEN>
__device__ __forceinline__ bool partial_live(const Geometry& geo, const RowSlot& r, int p) {
  return !GEN || column<V, GEN>(geo, r, p) < geo.width;
}

// Whether the lane writes the per-head statistics of partial p: the first
// lane of each butterfly set, or (general) the lane holding the head's
// first column.
template <int V, bool GEN>
__device__ __forceinline__ bool writes_head(const Geometry& geo, const RowSlot& r, int p) {
  if constexpr (GEN) {
    const int c = column<V, GEN>(geo, r, p);
    return c < geo.width && (geo.interleaved ? c < geo.heads : c % geo.head_dim == 0);
  } else {
    return (r.sub & (geo.hi - 1)) < geo.lo;
  }
}

// The row's slice of shared memory (general geometry), else null.
template <bool GEN>
__device__ __forceinline__ float* row_scratch(const Geometry& geo) {
  if constexpr (GEN) {
    return csr_attention_smem + (threadIdx.x / geo.lanes) * (geo.width + geo.heads);
  } else {
    return nullptr;
  }
}

template <int V>
__device__ __forceinline__ void zero_cols(float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0f;
}

// x rounded to the element type T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

__device__ __forceinline__ void load4(const float* __restrict__ p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load2(const float* __restrict__ p, float* v) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}

__device__ __forceinline__ void store4(float* __restrict__ p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store2(float* __restrict__ p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// The lane's V consecutive columns at p (16- or 8-byte vectors where V
// allows), as f32.
template <int V, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) load4(p + 4 * i, v + 4 * i);
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) load2(p + 2 * i, v + 2 * i);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(p[i]);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) store4(p + 4 * i, v + 4 * i);
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) store2(p + 2 * i, v + 2 * i);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_float<T>(v[i]);
  }
}

// Node row j's columns of this lane, or zeros for j < 0 (no edge) and for
// the general geometry's tail.
template <int V, bool GEN, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ base, int32_t j, const Geometry& geo,
                                         const RowSlot& r, float (&v)[V]) {
  if (j < 0) {
    zero_cols<V>(v);
    return;
  }
  const T* row = base + static_cast<int64_t>(j) * geo.width;
  if constexpr (GEN) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = column<V, GEN>(geo, r, i);
      v[i] = c < geo.width ? to_float(row[c]) : 0.0f;
    }
  } else {
    load_cols<V>(row + r.col0, v);
  }
}

// Stores the lane's columns of node row n (the tail left out), rounded to T.
template <int V, bool GEN, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ base, int64_t n, const Geometry& geo,
                                          const RowSlot& r, const float (&v)[V]) {
  T* row = base + n * geo.width;
  if constexpr (GEN) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = column<V, GEN>(geo, r, i);
      if (c < geo.width) row[c] = from_float<T>(v[i]);
    }
  } else {
    store_cols<V>(row + r.col0, v);
  }
}

// Per-head sums of a[i] * b[i] into part[NP]: each partial gets the sum over
// its head's columns of the row. Fast geometry: a butterfly over the lane's
// set. General: through the row's shared memory `scratch` (D products, then
// H sums), each head summed by one lane in column order; a tail partial
// gets 0. Every lane of the warp must call it. No barrier is needed after
// the last read: the next call's first barrier orders its writes after it.
template <int V, int NP, bool GEN>
__device__ __forceinline__ void head_dots(const Geometry& geo, const RowSlot& r, const float (&a)[V],
                                          const float (&b)[V], float (&part)[NP], float* scratch) {
  if constexpr (GEN) {
    static_assert(NP == V, "the general geometry keeps one partial per column");
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = column<V, GEN>(geo, r, i);
      if (c < geo.width) scratch[c] = a[i] * b[i];
    }
    __syncwarp();
    for (int h = r.sub; h < geo.heads; h += geo.lanes) {
      float sum = 0.0f;
      for (int t = 0; t < geo.head_dim; ++t) {
        sum += scratch[geo.interleaved ? t * geo.heads + h : h * geo.head_dim + t];
      }
      scratch[geo.width + h] = sum;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = column<V, GEN>(geo, r, i);
      part[i] = c < geo.width ? scratch[geo.width + head_of_column(geo, c)] : 0.0f;
    }
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) part[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) part[i % NP] += a[i] * b[i];
    for (int offset = geo.lo; offset < geo.hi; offset <<= 1) {
#pragma unroll
      for (int p = 0; p < NP; ++p) part[p] += __shfl_xor_sync(0xffffffffu, part[p], offset);
    }
  }
}

// The scores of one edge per head: scale * <q[n, h, :], k[j, h, :]>.
template <int V, int NP, bool GEN>
__device__ __forceinline__ void edge_scores(const Geometry& geo, const RowSlot& r, const float (&q)[V],
                                            const float (&k)[V], float scale, float (&s)[NP],
                                            float* scratch) {
  head_dots<V, NP, GEN>(geo, r, q, k, s, scratch);
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
// not take. A fast geometry where the width and head split allow one, else
// the general one (D <= max_cols * G).
inline bool make_geometry(int lanes, int width, int heads, int interleaved, int max_cols, Geometry* geo) {
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  if (!(lanes == 8 || lanes == 16 || lanes == 32) || heads <= 0 || width <= 0) return false;
  if (width % heads) return false;
  const int dh = width / heads;
  geo->lanes = lanes;
  geo->width = width;
  geo->heads = heads;
  geo->head_dim = dh;
  geo->interleaved = interleaved;
  geo->general = 0;
  geo->lo = 1;
  geo->hi = 1;
  bool fast = width % lanes == 0 && width / lanes <= max_cols;
  if (fast) {
    const int v = width / lanes;
    if (!interleaved) {
      fast = dh % v == 0 && pow2(dh / v);
      geo->hi = fast ? dh / v : 1;
    } else if (v % heads == 0) {
      fast = pow2(heads);
      geo->hi = lanes;
    } else if (heads % v == 0) {
      fast = pow2(v) && pow2(heads / v) && heads / v <= lanes;
      geo->lo = heads / v;
      geo->hi = lanes;
    } else {
      fast = false;
    }
  }
  if (fast) return true;
  geo->lo = 1;
  geo->hi = 1;
  geo->general = 1;
  return (width + lanes - 1) / lanes <= max_cols;
}

// V (columns a lane) of a valid geometry.
inline int columns(const Geometry& geo) { return (geo.width + geo.lanes - 1) / geo.lanes; }

// NP of a valid geometry.
inline int partials(const Geometry& geo) {
  const int v = columns(geo);
  if (geo.general) return v;
  return geo.interleaved ? (v < geo.heads ? v : geo.heads) : 1;
}

// The kernel instantiation of a valid geometry: a key of the cases below.
inline int case_key(const Geometry& geo) {
  return geo.general ? 1024 + columns(geo) : columns(geo) * 32 + partials(geo);
}

// Dynamic shared memory of a launch: the general geometry's per-row scratch.
inline size_t shared_bytes(const Geometry& geo) {
  return geo.general ? sizeof(float) * (kThreads / geo.lanes) * (geo.width + geo.heads) : 0;
}

// The (V, NP) pairs a fast geometry can give: V in 1..16 and NP a power of
// two dividing V, one kernel instantiation each; then the general
// geometry's V in 1..16 (NP = V).
#define CSR_ATTENTION_CASES(CASE)                                                   \
  CASE(1, 1) CASE(2, 1) CASE(2, 2) CASE(3, 1) CASE(4, 1) CASE(4, 2) CASE(4, 4)      \
  CASE(5, 1) CASE(6, 1) CASE(6, 2) CASE(7, 1) CASE(8, 1) CASE(8, 2) CASE(8, 4)      \
  CASE(8, 8) CASE(9, 1) CASE(10, 1) CASE(10, 2) CASE(11, 1) CASE(12, 1) CASE(12, 2) \
  CASE(12, 4) CASE(13, 1) CASE(14, 1) CASE(14, 2) CASE(15, 1) CASE(16, 1)           \
  CASE(16, 2) CASE(16, 4) CASE(16, 8) CASE(16, 16)
#define CSR_ATTENTION_GENERAL_CASES(CASE)                                           \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)  \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

}  // namespace csr_attention
