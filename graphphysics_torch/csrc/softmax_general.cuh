// The general lane geometry of the segment softmax + SpMM kernels: K2 and K3
// (csr_softmax_spmm.cu, csr_softmax_spmm_bwd.cu) on one edge set, K5
// (csr_softmax_spmm_pair.cu) on two. It takes every width D <= 512 with
// D % H == 0, and values of any element alignment. K2's f32 entry and K3
// run it only where neither their V columns nor their words (word_heads.cuh)
// take the width; K2's bf16 stream and K5 wherever their other geometries
// do not.
//
// One warp owns one row: no atomics, nothing shared between warps, every sum
// in a fixed order, so two runs give the same bits. Lane j owns the columns
// j, j + 32, ... below D (up to kMaxColumns of them), so a warp reads an
// edge's value row as coalesced 128-byte spans, one scalar load a column
// (f32, or bf16 widened to f32). The forward walks the row's range of each
// set in turn, one edge at a time; each column keeps its head's running
// (m, l), which all columns of a head compute alike, with the online step
// m' = max(m, s), l = l exp(m - m') + exp(s - m'), acc = acc exp(m - m') +
// exp(s - m') v; the lane of a head's first column writes its m and l. An
// empty row, or one whose edges are all masked, keeps m = -1e30, l = 0 and
// out = 0.
//
// The backward's per-head sums over columns (delta = <out, g>, and per edge
// the values . g dot) are butterfly shuffles when a head's columns are whole
// 32-column slots or aligned lane groups (every D = 32k with H | k, and
// every head width dividing 32), else they go through shared memory; the
// lane of a head's first column writes its dscores. K5's caller hands in
// zeroed gradients and masked edges are skipped; K3's (kZeroFill) are
// written here: 0 on masked edges, and the row before each gap zeroes the
// edges no range covers (csr_softmax_spmm_bwd.cu), as flat spans the whole
// warp stores. Each edge's score and value loads start before its mask byte
// is known, so a walk waits on one round of loads an edge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace softmax_general {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block
constexpr int kMaxColumns = 16;   // columns a lane
constexpr int kMaxWidth = kLanes * kMaxColumns;
constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernel
constexpr float kEps = 1e-16f;  // the epsilon of segment_softmax

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
struct EdgeSetOf {
  const T* scores;        // [E, H]
  const T* values;        // [E, D]
  const int32_t* bounds;  // [2, N]
  const uint8_t* mask;    // [E] or null
  int64_t num_edges;
};

// NS edge sets walked in turn for each row
template <typename T, int NS>
struct EdgeSets {
  EdgeSetOf<T> set[NS];
};

// each set's gradients: ds [E, H], dv [E, D]
template <int NS>
struct GradSets {
  float* ds[NS];
  float* dv[NS];
};

// the widths the geometry takes
inline bool valid(int width, int num_heads) {
  return num_heads > 0 && width > 0 && width <= kMaxWidth && width % num_heads == 0;
}

// Whether K2's and K3's V-column kernels (V = D / 32 adjacent columns of
// one head a lane) take the width, heads and arrays: D = 32 V, a head
// whole V-column lanes, and each array aligned to their vector accesses of
// V elements of `itemsize` bytes (itemsize min(16 / itemsize, V & -V)
// bytes; the rule of ops/csr_attention.py softmax_spmm_columns). Else K2
// and K3 take this general geometry.
inline bool v_columns(int width, int num_heads, int itemsize, std::initializer_list<const void*> arrays) {
  const int v = width / kLanes;
  if (width % kLanes != 0 || (width / num_heads) % v != 0) return false;
  const int bytes = itemsize * ((v & -v) < 16 / itemsize ? (v & -v) : 16 / itemsize);
  for (const void* p : arrays) {
    if (reinterpret_cast<uintptr_t>(p) % bytes != 0) return false;
  }
  return true;
}

template <typename S>
__device__ __forceinline__ void row_range(const S& s, int64_t row, int64_t num_rows, int64_t& start,
                                          int64_t& end) {
  start = s.bounds[row];
  end = s.bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > s.num_edges ? s.num_edges : end;
}

template <int NC, typename T>
__device__ __forceinline__ void walk(const EdgeSetOf<T>& s, int64_t start, int64_t end, int width,
                                     int num_heads, const int (&head)[NC], float (&m)[NC],
                                     float (&l)[NC], float (&acc)[NC]) {
  for (int64_t e = start; e < end; ++e) {
    // the edge's loads start together, before its mask byte is known
    const T* sc = s.scores + e * num_heads;
    const T* v = s.values + e * width;
    float x[NC], ve[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      x[i] = c < width ? to_f32(sc[head[i]]) : 0.0f;
      ve[i] = c < width ? to_f32(v[c]) : 0.0f;
    }
    if (s.mask != nullptr && !s.mask[e]) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      if (c < width) {
        const float m_new = fmaxf(m[i], x[i]);
        const float alpha = expf(m[i] - m_new);
        const float p = expf(x[i] - m_new);
        l[i] = l[i] * alpha + p;
        acc[i] = acc[i] * alpha + p * ve[i];
        m[i] = m_new;
      }
    }
  }
}

// NC = ceil(D / 32) columns a lane; a block of kLanes x kRowsPerBlock
template <int NC, int NS, typename T>
__global__ void forward_kernel(EdgeSets<T, NS> sets, float* __restrict__ out, float* __restrict__ ml,
                               int64_t num_rows, int width, int num_heads) {
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
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    int64_t start, end;
    row_range(sets.set[k], row, num_rows, start, end);
    walk<NC>(sets.set[k], start, end, width, num_heads, head, m, l, acc);
  }
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

// 0 into the gradients of the edges [first, last), written as the flat
// spans ds[first H, last H) and dv[first D, last D): the warp's lanes store
// consecutive floats, whatever the width
__device__ __forceinline__ void zero_edges(float* __restrict__ ds, float* __restrict__ dv, int64_t first,
                                           int64_t last, int width, int num_heads) {
  if (last <= first) return;
  for (int64_t k = first * width + threadIdx.x; k < last * width; k += kLanes) dv[k] = 0.0f;
  for (int64_t k = first * num_heads + threadIdx.x; k < last * num_heads; k += kLanes) ds[k] = 0.0f;
}

// is_first[i]: whether this lane's column slot i is its head's first column
template <int NC, bool kZeroFill>
__device__ __forceinline__ void edge_grads(const EdgeSetOf<float>& s, float* __restrict__ ds,
                                           float* __restrict__ dv, int64_t start, int64_t end,
                                           int width, int num_heads, int head_dim, int mode,
                                           const int (&head)[NC], const bool (&is_first)[NC],
                                           const float (&mc)[NC], const float (&lc)[NC],
                                           const float (&gc)[NC], const float (&delta)[NC], float* buf) {
  for (int64_t e = start; e < end; ++e) {
    // the edge's loads start together, before its mask byte is known
    const float* sc = s.scores + e * num_heads;
    const float* v = s.values + e * width;
    float x[NC], ve[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      x[i] = c < width ? sc[head[i]] : 0.0f;
      ve[i] = c < width ? v[c] : 0.0f;
    }
    if (s.mask != nullptr && !s.mask[e]) {  // uniform across the warp
      if constexpr (kZeroFill) zero_edges(ds, dv, e, e + 1, width, num_heads);
      continue;  // else its gradients stay the caller's 0
    }
    float attn[NC], prod[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = threadIdx.x + i * kLanes;
      attn[i] = 0.0f;
      prod[i] = 0.0f;
      if (c < width) {
        attn[i] = expf(x[i] - mc[i]) / (lc[i] + kEps);
        dv[e * width + c] = attn[i] * gc[i];
        prod[i] = ve[i] * gc[i];
      }
    }
    float dattn[NC];
    column_head_sums<NC>(prod, mode, head_dim, width, buf, dattn);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (is_first[i]) ds[e * num_heads + head[i]] = attn[i] * (dattn[i] - delta[i]);
    }
  }
}

// kZeroFill: also write 0 to masked edges and to the edges no range covers
// (the row before each gap: [end_r, start_{r+1}), the last row up to E, row
// 0 also [0, start_0)); for one edge set whose ranges ascend without overlap
template <int NC, int NS, bool kZeroFill>
__global__ void backward_kernel(EdgeSets<float, NS> sets, GradSets<NS> grads, const float* __restrict__ ml,
                                const float* __restrict__ out, const float* __restrict__ g,
                                int64_t num_rows, int width, int num_heads) {
  static_assert(!kZeroFill || NS == 1, "the gaps are those of one edge set");
  __shared__ float shared[kRowsPerBlock][kMaxWidth];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // whole warps leave together
  float* buf = shared[threadIdx.y];
  const int head_dim = width / num_heads;
  const int mode = head_sums_mode(head_dim);
  int head[NC];
  bool is_first[NC];
  float gc[NC], mc[NC], lc[NC], og[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = threadIdx.x + i * kLanes;
    head[i] = c < width ? c / head_dim : 0;
    is_first[i] = c < width && c % head_dim == 0;
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
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    int64_t start, end;
    row_range(sets.set[k], row, num_rows, start, end);
    edge_grads<NC, kZeroFill>(sets.set[k], grads.ds[k], grads.dv[k], start, end, width, num_heads,
                              head_dim, mode, head, is_first, mc, lc, gc, delta, buf);
    if constexpr (kZeroFill) {
      const EdgeSetOf<float>& s = sets.set[k];
      int64_t next = s.num_edges;
      if (row + 1 < num_rows) {
        next = s.bounds[row + 1];
        next = next < 0 ? 0 : (next > s.num_edges ? s.num_edges : next);
      }
      const int64_t after = end < start ? start : end;
      zero_edges(grads.ds[k], grads.dv[k], after, next, width, num_heads);
      if (row == 0) zero_edges(grads.ds[k], grads.dv[k], 0, start, width, num_heads);
    }
  }
}

// the launches: NC = ceil(D / 32) instantiated for 1..kMaxColumns
#define SOFTMAX_GENERAL_COLUMNS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

template <int NS, typename T>
cudaError_t launch_forward(const EdgeSets<T, NS>& sets, float* out, float* ml, int64_t num_rows,
                           int width, int num_heads, cudaStream_t stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
#define SOFTMAX_GENERAL_FORWARD(NC)                                                        \
  case NC:                                                                                 \
    forward_kernel<NC, NS, T><<<grid, block, 0, stream>>>(sets, out, ml, num_rows, width, num_heads); \
    break;
  switch ((width + kLanes - 1) / kLanes) {
    SOFTMAX_GENERAL_COLUMNS(SOFTMAX_GENERAL_FORWARD)
    default:
      return cudaErrorInvalidValue;
  }
#undef SOFTMAX_GENERAL_FORWARD
  return cudaGetLastError();
}

template <int NS, bool kZeroFill>
cudaError_t launch_backward(const EdgeSets<float, NS>& sets, const GradSets<NS>& grads, const float* ml,
                            const float* out, const float* g, int64_t num_rows, int width, int num_heads,
                            cudaStream_t stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
#define SOFTMAX_GENERAL_BACKWARD(NC)                                                          \
  case NC:                                                                                    \
    backward_kernel<NC, NS, kZeroFill><<<grid, block, 0, stream>>>(sets, grads, ml, out, g, num_rows, \
                                                            width, num_heads);                \
    break;
  switch ((width + kLanes - 1) / kLanes) {
    SOFTMAX_GENERAL_COLUMNS(SOFTMAX_GENERAL_BACKWARD)
    default:
      return cudaErrorInvalidValue;
  }
#undef SOFTMAX_GENERAL_BACKWARD
  return cudaGetLastError();
}

}  // namespace softmax_general
