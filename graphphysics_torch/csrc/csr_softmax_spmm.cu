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
// Design. One warp owns one output row, so there are no atomics, nothing is
// shared between warps, and the sum runs in a fixed order (deterministic).
// Each lane owns V = D/32 contiguous columns, all inside one head (the
// wrapper requires head_dim % V == 0), and loads them as one 16- or 8-byte
// vector where V allows, so a warp reads each value row as one contiguous
// D*4-byte span. The warp walks its row's edges once with the online
// softmax: per edge, m' = max(m, s), acc = acc*exp(m - m') + exp(s - m')*v,
// l = l*exp(m - m') + exp(s - m'). Masked edges are skipped. The first lane
// of each head writes that head's m and l. The models' attention does not
// run this kernel: csr_attention.cu fuses the q/k/v gathers and the
// per-edge dot products into the same loop, with several rows per warp and
// the next edge's rows prefetched. This one stays for callers that hand in
// their own scores, as split-edge partitioned attention will.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;  // warps (rows) per block
constexpr float kNeg = -1e30f;    // finite -inf stand-in, as the TPU kernel
constexpr float kEps = 1e-16f;    // the epsilon of segment_softmax

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
__global__ void csr_softmax_spmm_kernel(const float* __restrict__ scores,
                                        const float* __restrict__ values,
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
    const float s = scores[e * num_heads + head];
    float v[V];
    load_cols<V>(values + e * width + col0, v);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = acc[c] * alpha + p * v[c];
    m = m_new;
  }
  float* o = out + row * width + col0;
#pragma unroll
  for (int c = 0; c < V; ++c) o[c] = acc[c] / (l + kEps);
  if (col0 % head_dim == 0) {
    ml[head * num_rows + row] = m;
    ml[(num_heads + head) * num_rows + row] = l;
  }
}

template <int V>
cudaError_t launch(const void* scores, const void* values, const void* bounds,
                   const void* mask, void* out, void* ml, long long num_rows,
                   long long num_edges, int num_heads, cudaStream_t stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  csr_softmax_spmm_kernel<V><<<grid, block, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(values),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<float*>(ml), num_rows, num_edges,
      num_heads, (kLanes * V) / num_heads);
  return cudaGetLastError();
}

}  // namespace

// scores [E, H] f32, values [E, D] f32 (16-byte aligned), bounds [2, N]
// int32, mask [E] bool (or null), out [N, D] f32, ml [2H, N] f32; all device
// pointers, contiguous. D = 32*V for V in 1..16, D % H == 0 and
// (D / H) % V == 0 (the wrapper checks; other shapes return
// cudaErrorInvalidValue). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_softmax_spmm_f32(const void* scores, const void* values,
                                    const void* bounds, const void* mask,
                                    void* out, void* ml, long long num_rows,
                                    long long num_edges, int num_heads,
                                    int width, void* stream) {
  if (num_rows <= 0) return 0;
  if (num_heads <= 0 || width % kLanes != 0 || width % num_heads != 0 ||
      ((width / num_heads) % (width / kLanes)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(V) \
  case V:       \
    return static_cast<int>(launch<V>(scores, values, bounds, mask, out, ml, num_rows, num_edges, num_heads, s));
  switch (width / kLanes) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
