// Fused sparse graph attention over a sender-sorted (CSR) edge list, for
// Hopper (sm_90a): the q/k/v gathers, the per-edge per-head scores (SDDMM),
// the segment softmax and the weighted sum of values (SpMM) in one pass.
// For each sender row n, head h and real unmasked edge e of n's range, with
// j = gather_idx[e]:
//
//   s[e, h]   = scale * <q[n, h, :], k[j, h, :]>          (f32)
//   m[h, n]   = max_e s[e, h]                              (-1e30 if none)
//   l[h, n]   = sum_e exp(s[e, h] - m[h, n])
//   out[n, h] = sum_e exp(s[e, h] - m[h, n]) * v[j, h, :] / (l[h, n] + 1e-16)
//
// by the online softmax of csr_softmax_spmm.cu (m from -1e30, l from 0).
// Rows without such edges give out 0, m -1e30 and l 0. It also writes
// ml = [m; l] as [2H, N] for the backward (csr_attention_bwd.cu).
//
// Replaces the Pallas TPU kernel `_softmax_spmm_impl` / `_kernel` in
// graphphysics_tpu/ops/pallas_attention.py together with the XLA work of its
// caller `csr_sparse_attention` there (the gathers of q at the segments and
// of k, v at gather_idx, the per-head dot times scale, the -1e30 masking),
// which the TPU build leaves to XLA for fusion with the projections. On
// Hopper that work ran as a dozen PyTorch kernels around csr_softmax_spmm.cu
// with [E, D] intermediates (gathered q, k, v) written and read back.
//
// Bound: memory. Per edge and column two multiply-adds, per edge and head a
// few shuffles and two exponentials: about 1 operation per byte, far below
// the card's balance. No [E, *] array is read or written. q, k and v are
// read as node rows: each gathered k, v row is read once per edge that
// names it, but every node row of the model's shapes fits the 50 MB L2
// (16.8 MB at 16,384 x 128, 34 MB at 66,560 x 64 for k and v), so device
// memory sees each about once. The bytes that must move are
//   N*4D*3           q, k, v
//   + E_real*(4 + 1) the gather index and mask byte of each real edge
//   + N*(8 + 4D + 8H) the two bounds, out, ml.
//
// Design, one answer to each limit of the kernels it replaces:
// - no gathered [E, D] intermediates: the loop reads q once per row, and k, v
//   per edge straight from the node rows;
// - a group of G lanes serves one row (csr_attention.cuh); the group loads
//   the next G edges' gather indices and mask bytes in one coalesced load
//   and broadcasts each by a shuffle, so no lane waits on a dependent index
//   load inside the loop;
// - the next edge's k and v rows are loaded into a second register buffer
//   before the current edge's dot, max and exponentials run, so their
//   latency hides behind that chain (a register double buffer: a row is
//   V <= 16 floats a lane, and a shared-memory ring would add a copy and a
//   barrier for data that each lane alone consumes);
// - G = 32, 16 or 8 lanes by width (ops/csr_attention.py chooses): fewer
//   lanes a row give each lane more columns, fewer butterfly levels per head
//   and more rows per warp;
// - a width or head split that no lane count divides into power-of-two head
//   partials takes the general geometry (csr_attention.cuh): strided columns
//   with a masked tail, and per-head sums through shared memory, one lane a
//   head; each lane keeps the softmax state of each of its columns' heads.
// Tensor cores do not apply: the per-row dots are 32-wide heads against ~6
// rows, far below a wgmma tile, and the bound is bytes.
//
// The entry is csr_attention_f32 (q, k, v, out float). The bf16 entry is
// csr_attention_bf16.cu, a kernel of its own with 16-byte bf16 lanes.
//
// stream_dtype="bf16" (entry csr_attention_f32_stream): the JAX caller
// computes the f32 scores, then streams them and the gathered v rows to its
// K2 rounded to bf16 (pallas_attention.py:598-619, :287-302), which
// computes in f32 from the rounded values. Here neither ever reaches device
// memory, so the mode is a compile-time flag of the same kernel (STREAM):
// each edge's scores are rounded to bf16 (to nearest even) before they
// enter the online softmax, and each gathered v element before it is
// weighted. The bytes are the f32 entry's. The backward is the f32 one
// (csr_attention_bwd.cu), which recomputes the unrounded scores, with this
// pass's ml and out: JAX's gradient through `_bwd`.

#include "csr_attention.cuh"

namespace {

using namespace csr_attention;

template <typename T, int V, int NP, bool GEN, bool STREAM>
__global__ void __launch_bounds__(kThreads)
csr_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int32_t* __restrict__ gather_idx,
                     const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ ml, int64_t num_rows,
                     int64_t num_edges, Geometry geo, float scale) {
  const RowSlot r = row_slot<V, GEN>(geo, bounds, num_rows, num_edges);
  float* scratch = row_scratch<GEN>(geo);
  float qr[V];
  load_row<V, GEN>(q, r.has_row ? static_cast<int32_t>(r.row) : -1, geo, r, qr);

  float m[NP], l[NP], acc[V];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    m[p] = kNeg;
    l[p] = 0.0f;
  }
  zero_cols<V>(acc);

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
      float s[NP];
      edge_scores<V, NP, GEN>(geo, r, qr, kc, scale, s, scratch);
      if constexpr (STREAM) {
#pragma unroll
        for (int p = 0; p < NP; ++p) s[p] = round_to<__nv_bfloat16>(s[p]);
      }
      if (j >= 0) {  // uniform across the row's lanes
        float alpha[NP], pe[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float m_new = fmaxf(m[p], s[p]);
          alpha[p] = expf(m[p] - m_new);
          pe[p] = expf(s[p] - m_new);
          l[p] = l[p] * alpha[p] + pe[p];
          m[p] = m_new;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x = STREAM ? round_to<__nv_bfloat16>(vc[i]) : vc[i];
          acc[i] = acc[i] * alpha[i % NP] + pe[i % NP] * x;
        }
      }
      j = jn;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        kc[i] = kn[i];
        vc[i] = vn[i];
      }
    }
  }
  if (!r.has_row) return;
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = acc[i] / (l[i % NP] + kEps);
  store_row<V, GEN>(out, r.row, geo, r, o);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (writes_head<V, GEN>(geo, r, p)) {
      const int h = head_of<V, GEN>(geo, r, p);
      ml[h * num_rows + r.row] = m[p];
      ml[(geo.heads + h) * num_rows + r.row] = l[p];
    }
  }
}

template <typename T, int V, int NP, bool GEN, bool STREAM>
cudaError_t launch(const void* q, const void* k, const void* v, const void* gather_idx,
                   const void* bounds, const void* mask, void* out, void* ml, long long num_rows,
                   long long num_edges, const Geometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_kernel<T, V, NP, GEN, STREAM><<<grid, kThreads, shared_bytes(geo), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(ml),
      num_rows, num_edges, geo, scale);
  return cudaGetLastError();
}

// The instantiation of the geometry's case for element type T, with the
// bf16 stream's roundings or without.
template <typename T, bool STREAM>
int run(const void* q, const void* k, const void* v, const void* gather_idx, const void* bounds,
        const void* mask, void* out, void* ml, long long num_rows, long long num_edges,
        int num_heads, int width, int interleaved, int lanes, float scale, void* stream) {
  if (num_rows <= 0) return 0;
  Geometry geo;
  if (!make_geometry(lanes, width, num_heads, interleaved, 16, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(V, NP)      \
  case (V) * 32 + (NP): \
    return static_cast<int>(launch<T, V, NP, false, STREAM>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, geo, scale, s));
#define GENERAL_CASE(V) \
  case 1024 + (V):      \
    return static_cast<int>(launch<T, V, V, true, STREAM>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, geo, scale, s));
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

// q, k, v [N, D] f32 node rows in one layout (interleaved: [Dh, H] rows,
// else [H, Dh]), 16-byte aligned; gather_idx [E] int32; bounds [2, N]
// int32; mask [E] bool (or null); out [N, D] f32 in the same layout; ml
// [2H, N] f32; all device pointers, contiguous. `lanes` (8, 16 or 32) lanes
// serve a row; the geometry must pass make_geometry (the wrapper checks;
// other shapes return cudaErrorInvalidValue), which takes every D <= 16 *
// lanes with D % H == 0. Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_attention_f32(const void* q, const void* k, const void* v, const void* gather_idx,
                                 const void* bounds, const void* mask, void* out, void* ml,
                                 long long num_rows, long long num_edges, int num_heads, int width,
                                 int interleaved, int lanes, float scale, void* stream) {
  return run<float, false>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges,
                           num_heads, width, interleaved, lanes, scale, stream);
}

// The same with stream_dtype="bf16": each score and each gathered v
// element rounded to bf16 before use.
extern "C" int csr_attention_f32_stream(const void* q, const void* k, const void* v,
                                        const void* gather_idx, const void* bounds,
                                        const void* mask, void* out, void* ml, long long num_rows,
                                        long long num_edges, int num_heads, int width,
                                        int interleaved, int lanes, float scale, void* stream) {
  return run<float, true>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges,
                          num_heads, width, interleaved, lanes, scale, stream);
}
