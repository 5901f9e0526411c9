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
//   and more rows per warp.
// Tensor cores do not apply: the per-row dots are 32-wide heads against ~6
// rows, far below a wgmma tile, and the bound is bytes.

#include "csr_attention.cuh"

namespace {

using namespace csr_attention;

template <int V, int NP>
__global__ void __launch_bounds__(kThreads)
csr_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int32_t* __restrict__ gather_idx,
                     const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ ml, int64_t num_rows,
                     int64_t num_edges, Geometry geo, float scale) {
  const RowSlot r = row_slot<V>(geo, bounds, num_rows, num_edges);
  const int width = geo.width;
  float qr[V];
  load_row<V>(q, r.has_row ? static_cast<int32_t>(r.row) : -1, width, r.col0, qr);

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
    load_row<V>(k, j, width, r.col0, kc);
    load_row<V>(v, j, width, r.col0, vc);
    for (int32_t t = 0; t < count; ++t) {
      const int32_t jn = t + 1 < count ? __shfl_sync(0xffffffffu, mine, t + 1, geo.lanes) : -1;
      float kn[V], vn[V];
      load_row<V>(k, jn, width, r.col0, kn);
      load_row<V>(v, jn, width, r.col0, vn);
      float s[NP];
      edge_scores<V, NP>(geo, qr, kc, scale, s);
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
        for (int i = 0; i < V; ++i) acc[i] = acc[i] * alpha[i % NP] + pe[i % NP] * vc[i];
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
  store_cols<V>(out + r.row * width + r.col0, o);
  if (writes_heads(geo, r.sub)) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int h = head_of(geo, r.col0, p);
      ml[h * num_rows + r.row] = m[p];
      ml[(geo.heads + h) * num_rows + r.row] = l[p];
    }
  }
}

template <int V, int NP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* gather_idx,
                   const void* bounds, const void* mask, void* out, void* ml, long long num_rows,
                   long long num_edges, const Geometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_kernel<V, NP><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(ml),
      num_rows, num_edges, geo, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v [N, D] f32 node rows in one layout (interleaved: [Dh, H] rows,
// else [H, Dh]), 16-byte aligned; gather_idx [E] int32; bounds [2, N]
// int32; mask [E] bool (or null); out [N, D] f32 in the same layout; ml
// [2H, N] f32; all device pointers, contiguous. `lanes` (8, 16 or 32) lanes
// serve a row; the geometry must pass make_geometry (the wrapper checks;
// other shapes return cudaErrorInvalidValue). Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_attention_f32(const void* q, const void* k, const void* v, const void* gather_idx,
                                 const void* bounds, const void* mask, void* out, void* ml,
                                 long long num_rows, long long num_edges, int num_heads, int width,
                                 int interleaved, int lanes, float scale, void* stream) {
  if (num_rows <= 0) return 0;
  Geometry geo;
  if (!make_geometry(lanes, width, num_heads, interleaved, 16, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (width / lanes) * 32 + partials(geo);
#define CASE(V, NP)      \
  case (V) * 32 + (NP): \
    return static_cast<int>(launch<V, NP>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, geo, scale, s));
  switch (key) {
    CSR_ATTENTION_CASES(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
