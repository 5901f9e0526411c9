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
// loaded while the current edge computes, and the same two geometries (the
// general one sums each head through shared memory and adds its strided
// columns with scalar atomics, the tail left out). dq needs no atomics: one group
// owns the row. dk and dv are sums over the edges that gather a node, which
// lie in other rows; they go by Hopper's 16-byte vector atomicAdd on global
// memory (float4; float2 or scalar where V is not a multiple of 4), so
// their order of summation changes from run to run, as the index_add_
// scatters' did. A deterministic pass over a transposed CSR is later work.
//
// The entry is csr_attention_bwd_f32. The bf16 backward is
// csr_attention_bwd_bf16.cu: no atomics, dk and dv summed by gather rows
// over a transposed CSR.

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

// Adds the lane's columns into node row j (the tail left out).
template <int V, bool GEN>
__device__ __forceinline__ void add_row(float* __restrict__ base, int32_t j, const Geometry& geo,
                                        const RowSlot& r, const float (&x)[V]) {
  float* row = base + static_cast<int64_t>(j) * geo.width;
  if constexpr (GEN) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = column<V, GEN>(geo, r, i);
      if (c < geo.width) atomicAdd(row + c, x[i]);
    }
  } else {
    add_cols<V>(row + r.col0, x);
  }
}

template <typename T, int V, int NP, bool GEN>
__global__ void __launch_bounds__(kThreads)
csr_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int32_t* __restrict__ gather_idx,
                         const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                         const float* __restrict__ ml, const T* __restrict__ out,
                         const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int64_t num_rows, int64_t num_edges, Geometry geo,
                         float scale) {
  const RowSlot r = row_slot<V, GEN>(geo, bounds, num_rows, num_edges);
  float* scratch = row_scratch<GEN>(geo);
  const int32_t self = r.has_row ? static_cast<int32_t>(r.row) : -1;
  float qr[V], gr[V];
  load_row<V, GEN>(q, self, geo, r, qr);
  load_row<V, GEN>(g, self, geo, r, gr);
  float delta[NP];
  {
    float o[V];
    load_row<V, GEN>(out, self, geo, r, o);
    head_dots<V, NP, GEN>(geo, r, o, gr, delta, scratch);
  }
  float m[NP], l[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    m[p] = kNeg;
    l[p] = 0.0f;
    if (!partial_live<V, GEN>(geo, r, p)) {
      m[p] = 0.0f;  // a tail column: its unused terms stay finite
    } else if (r.has_row) {
      const int h = head_of<V, GEN>(geo, r, p);
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
    load_row<V, GEN>(k, j, geo, r, kc);
    load_row<V, GEN>(v, j, geo, r, vc);
    for (int32_t t = 0; t < count; ++t) {
      const int32_t jn = t + 1 < count ? __shfl_sync(0xffffffffu, mine, t + 1, geo.lanes) : -1;
      float kn[V], vn[V];
      load_row<V, GEN>(k, jn, geo, r, kn);
      load_row<V, GEN>(v, jn, geo, r, vn);
      float s[NP], vg[NP];
      edge_scores<V, NP, GEN>(geo, r, qr, kc, scale, s, scratch);
      head_dots<V, NP, GEN>(geo, r, vc, gr, vg, scratch);
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
          dvr[i] = round_to<T>(attn[i % NP] * gr[i]);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) dqa[i] += ds[i % NP] * scale * kc[i];
        add_row<V, GEN>(dk, j, geo, r, dkr);
        add_row<V, GEN>(dv, j, geo, r, dvr);
      }
      j = jn;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        kc[i] = kn[i];
        vc[i] = vn[i];
      }
    }
  }
  if (r.has_row) store_row<V, GEN>(dq, r.row, geo, r, dqa);
}

template <typename T, int V, int NP, bool GEN>
cudaError_t launch(const void* q, const void* k, const void* v, const void* gather_idx,
                   const void* bounds, const void* mask, const void* ml, const void* out,
                   const void* g, void* dq, void* dk, void* dv, long long num_rows,
                   long long num_edges, const Geometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_bwd_kernel<T, V, NP, GEN><<<grid, kThreads, shared_bytes(geo), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(ml),
      static_cast<const T*>(out), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), num_rows, num_edges, geo, scale);
  return cudaGetLastError();
}

// The instantiation of the geometry's case for element type T.
template <typename T>
int run(const void* q, const void* k, const void* v, const void* gather_idx, const void* bounds,
        const void* mask, const void* ml, const void* out, const void* g, void* dq, void* dk,
        void* dv, long long num_rows, long long num_edges, int num_heads, int width,
        int interleaved, int lanes, float scale, void* stream) {
  if (num_rows <= 0) return 0;
  Geometry geo;
  if (!make_geometry(lanes, width, num_heads, interleaved, 16, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(V, NP)      \
  case (V) * 32 + (NP): \
    return static_cast<int>(launch<T, V, NP, false>(q, k, v, gather_idx, bounds, mask, ml, out, g, dq, dk, dv, num_rows, num_edges, geo, scale, s));
#define GENERAL_CASE(V) \
  case 1024 + (V):      \
    return static_cast<int>(launch<T, V, V, true>(q, k, v, gather_idx, bounds, mask, ml, out, g, dq, dk, dv, num_rows, num_edges, geo, scale, s));
  switch (case_key(geo)) {
    CSR_ATTENTION_CASES(CASE)
    CSR_ATTENTION_GENERAL_CASES(GENERAL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
#undef GENERAL_CASE
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
  return run<float>(q, k, v, gather_idx, bounds, mask, ml, out, g, dq, dk, dv, num_rows,
                    num_edges, num_heads, width, interleaved, lanes, scale, stream);
}
