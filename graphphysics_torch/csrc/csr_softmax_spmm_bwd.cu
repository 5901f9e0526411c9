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
// Design. One warp owns one sender row, as in the forward
// (csr_softmax_spmm.cu): no atomics, nothing shared between warps. Two
// geometries, chosen before the launch by width, heads and alignment (the
// rule of ops/csr_attention.py softmax_spmm_columns):
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
// - The general geometry (softmax_general.cuh, K5's backward on one edge
//   set) for every other width and view with D <= 512 and D % H == 0 (D =
//   48 in 4 heads of 12, 96 in 3 of 32, 40 in 8 of 5; values only 4-byte
//   aligned): lane j owns the columns j, j + 32, ..., a head's sums are
//   butterflies over the warp or a lane group where its columns are whole
//   32-column slots or aligned groups, else sums through shared memory; the
//   same zeros on masked edges and on the edges no range covers.
// The models' attention does not run this kernel: csr_attention_bwd.cu
// fuses the backward of the q/k/v gathers and the per-edge dot products
// into the same loop. The unsplit partitioned attention runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_general.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block
constexpr float kEps = 1e-16f;    // the epsilon of the forward's normalization

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
// else the general geometry. Writes every row of dscores and dvalues when
// N > 0. Launches on `stream` and returns cudaGetLastError() (0 when the
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
  const softmax_general::EdgeSetOf<float> edges{
      static_cast<const float*>(scores), static_cast<const float*>(values),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask), num_edges};
  return static_cast<int>(softmax_general::launch_backward<1, true>(
      softmax_general::EdgeSets<float, 1>{{edges}},
      softmax_general::GradSets<1>{{static_cast<float*>(dscores)}, {static_cast<float*>(dvalues)}},
      static_cast<const float*>(ml), static_cast<const float*>(out), static_cast<const float*>(g), num_rows,
      width, num_heads, s));
}
