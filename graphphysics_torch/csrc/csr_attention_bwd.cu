// Backward of the fused CSR attention (csr_attention.cu), for Hopper
// (sm_90a): the gradients of q, k and v from the forward's out, its
// statistics ml = [m; l] and the output's gradient g. For each sender row n
// and head h:
//
//   delta[n, h] = <out[n, h, :], g[n, h, :]>
//
// and for each real unmasked edge e of n's range, with j = gather_idx[e]:
//
//   s         = scale * <q[n, h, :], k[j, h, :]>    (the forward's edge_scores)
//   attn      = exp(s - m[h, n]) / (l[h, n] + 1e-16)
//   ds        = attn * (<v[j, h, :], g[n, h, :]> - delta[n, h])
//   dq[n, h] += ds * scale * k[j, h, :]        summed in registers
//   dk[j, h] += ds * scale * q[n, h, :]        atomics
//   dv[j, h] += attn * g[n, h, :]              atomics
//
// Masked edges, edges outside every range and rows without edges add
// exactly nothing; dq of such a row is 0. dk and dv must be zero on entry
// (the wrapper allocates them zeroed).
//
// Replaces the backward of the TPU kernel's custom VJP (`_bwd` with
// `_pack_node_side` and `_edge_grads` in graphphysics_tpu/ops/pallas_attention.py)
// together with the backward of its caller's gathers and SDDMM, which on
// Hopper ran as csr_softmax_spmm_bwd.cu writing [E, H] and [E, D] edge
// gradients, then PyTorch kernels for the dot's backward and three
// index_add_ scatters of [E, D] rows into q, k and v.
//
// Bound: memory, as the forward: per edge and column five multiply-adds and
// two atomic adds, per edge and head an exponential and a division. No [E, *]
// array is read or written. The bytes that must move are
//   N*4D*5           q, k, v, out and g read
//   + E_real*(4 + 1) the gather index and mask byte of each real edge
//   + N*(8 + 8H)     the two bounds and ml
//   + N*4D*3         dq, dk, dv written
// (the k, v rows and the dk, dv rows an edge touches are node rows that fit
// the L2, so device memory sees each about once; the atomics resolve in L2).
//
// Design: the forward's (csr_attention.cu): a group of G lanes a row,
// coalesced index loads broadcast by shuffles, the next edge's k and v rows
// loaded while the current edge computes. dq needs no atomics: one group
// owns the row. dk and dv are sums over the edges that gather a node, which
// lie in other rows; they go by Hopper's 16-byte vector atomicAdd on global
// memory (float4; float2 or scalar where V is not a multiple of 4), so
// their order of summation changes from run to run, as the index_add_
// scatters' did. A deterministic pass over a transposed CSR is later work.

#include "csr_attention.cuh"

namespace {

using namespace csr_attention;

template <int V>
__device__ __forceinline__ void add_cols(float* __restrict__ p, const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      atomicAdd(reinterpret_cast<float4*>(p) + i, make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]));
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) atomicAdd(reinterpret_cast<float2*>(p) + i, make_float2(x[2 * i], x[2 * i + 1]));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) atomicAdd(p + i, x[i]);
  }
}

template <int V, int NP>
__global__ void __launch_bounds__(kThreads)
csr_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int32_t* __restrict__ gather_idx,
                         const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                         const float* __restrict__ ml, const float* __restrict__ out,
                         const float* __restrict__ g, float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int64_t num_rows, int64_t num_edges, Geometry geo,
                         float scale) {
  const RowSlot r = row_slot<V>(geo, bounds, num_rows, num_edges);
  const int width = geo.width;
  const int32_t self = r.has_row ? static_cast<int32_t>(r.row) : -1;
  float qr[V], gr[V];
  load_row<V>(q, self, width, r.col0, qr);
  load_row<V>(g, self, width, r.col0, gr);
  float delta[NP];
  {
    float o[V];
    load_row<V>(out, self, width, r.col0, o);
    head_dots<V, NP>(geo, o, gr, delta);
  }
  float m[NP], l[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    m[p] = kNeg;
    l[p] = 0.0f;
    if (r.has_row) {
      const int h = head_of(geo, r.col0, p);
      m[p] = ml[h * num_rows + r.row];
      l[p] = ml[(geo.heads + h) * num_rows + r.row];
    }
  }
  float dqa[V];
  zero_cols<V>(dqa);

  const int32_t trips = warp_max(r.len);  // uniform across the warp
  for (int32_t first = 0; first < trips; first += geo.lanes) {
    const int32_t mine = chunk_index(gather_idx, mask, r, first);
    const int32_t count = min(geo.lanes, trips - first);
    int32_t j = __shfl_sync(0xffffffffu, mine, 0, geo.lanes);
    float kc[V], vc[V];
    load_row<V>(k, j, width, r.col0, kc);
    load_row<V>(v, j, width, r.col0, vc);
    for (int32_t t = 0; t < count; ++t) {
      const int32_t jn = t + 1 < count ? __shfl_sync(0xffffffffu, mine, t + 1, geo.lanes) : -1;
      float kn[V], vn[V];
      load_row<V>(k, jn, width, r.col0, kn);
      load_row<V>(v, jn, width, r.col0, vn);
      float s[NP], vg[NP];
      edge_scores<V, NP>(geo, qr, kc, scale, s);
      head_dots<V, NP>(geo, vc, gr, vg);
      if (j >= 0) {  // uniform across the row's lanes
        float attn[NP], ds[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          attn[p] = expf(s[p] - m[p]) / (l[p] + kEps);
          ds[p] = attn[p] * (vg[p] - delta[p]);
        }
        float dkr[V], dvr[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dkr[i] = ds[i % NP] * scale * qr[i];
          dvr[i] = attn[i % NP] * gr[i];
        }
#pragma unroll
        for (int i = 0; i < V; ++i) dqa[i] += ds[i % NP] * scale * kc[i];
        add_cols<V>(dk + static_cast<int64_t>(j) * width + r.col0, dkr);
        add_cols<V>(dv + static_cast<int64_t>(j) * width + r.col0, dvr);
      }
      j = jn;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        kc[i] = kn[i];
        vc[i] = vn[i];
      }
    }
  }
  if (r.has_row) store_cols<V>(dq + r.row * width + r.col0, dqa);
}

template <int V, int NP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* gather_idx,
                   const void* bounds, const void* mask, const void* ml, const void* out,
                   const void* g, void* dq, void* dk, void* dv, long long num_rows,
                   long long num_edges, const Geometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_bwd_kernel<V, NP><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(ml),
      static_cast<const float*>(out), static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), num_rows, num_edges, geo, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, g [N, D] f32 node rows in one layout (interleaved: [Dh, H]
// rows, else [H, Dh]), 16-byte aligned; gather_idx [E] int32; bounds
// [2, N] int32; mask [E] bool (or null); ml [2H, N] f32; dq, dk, dv [N, D]
// f32 in the inputs' layout, 16-byte aligned, dk and dv zeroed; all device
// pointers, contiguous. `lanes` and the geometry as csr_attention_f32.
// Writes every row of dq. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_attention_bwd_f32(const void* q, const void* k, const void* v,
                                     const void* gather_idx, const void* bounds, const void* mask,
                                     const void* ml, const void* out, const void* g, void* dq,
                                     void* dk, void* dv, long long num_rows, long long num_edges,
                                     int num_heads, int width, int interleaved, int lanes,
                                     float scale, void* stream) {
  if (num_rows <= 0) return 0;
  Geometry geo;
  if (!make_geometry(lanes, width, num_heads, interleaved, 16, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (width / lanes) * 32 + partials(geo);
#define CASE(V, NP)      \
  case (V) * 32 + (NP): \
    return static_cast<int>(launch<V, NP>(q, k, v, gather_idx, bounds, mask, ml, out, g, dq, dk, dv, num_rows, num_edges, geo, scale, s));
  switch (key) {
    CSR_ATTENTION_CASES(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
