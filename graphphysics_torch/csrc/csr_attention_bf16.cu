// Fused sparse graph attention over a sender-sorted (CSR) edge list on bf16
// node rows, for Hopper (sm_90a): csr_attention.cu's function on q, k, v
// bf16 [N, D], out bf16. For each sender row n, head h and real unmasked
// edge e of n's range, with j = gather_idx[e]:
//
//   s[e, h]   = scale * <q[n, h, :], k[j, h, :]>          (f32)
//   m[h, n]   = max_e s[e, h]                              (-1e30 if none)
//   l[h, n]   = sum_e exp(s[e, h] - m[h, n])
//   out[n, h] = bf16(sum_e exp(s[e, h] - m[h, n]) * v[j, h, :] / (l[h, n] + 1e-16))
//
// Every loaded element becomes f32 before any product; the scores, the
// online max and sum and the weighted sum are f32, and out is rounded to
// bf16 once, as the JAX package's K2 does (`out.astype(values.dtype)`).
// ml = [m; l] ([2H, N], f32) feeds the backward (csr_attention_bwd_bf16.cu).
// Rows without such edges give out 0, m -1e30 and l 0.
//
// Replaces the Pallas TPU kernel `_softmax_spmm_impl` / `_kernel` in
// graphphysics_tpu/ops/pallas_attention.py together with the XLA work of its
// caller `csr_sparse_attention` there (gathers, per-head dot, masking) fed
// bf16 q, k, v.
//
// Bound: memory. The bytes that must move are
//   N*2D*3             q, k, v
//   + E_real*(4 + 1)   the gather index and mask byte of each real edge
//   + N*(8 + 2D + 8H)  the two bounds, out, ml
// and the work is about 1 operation per byte. At these shapes the gathers
// are bound by latency and issue, not bytes: each edge reads two rows at a
// node picked by an index just loaded. The design's answers:
// - 16-byte lanes (csr_attention_bf16.cuh): V = 8 bf16 columns a lane, one
//   load a row; at D = 128 16 lanes a row, so twice the rows a warp of the
//   f32 entry's 32-lane fast geometry;
// - U edges a group (4 at V = 8): the group's U k rows and U v rows are
//   loaded, as raw 16-byte words, before the first score is computed, so U
//   gathers are in flight where the first design had one; the group's
//   online-softmax update takes one max and one rescale for the U edges;
// - per-head sums by reduce-scatter: each lane ends with NP >> RS heads'
//   scores, computes only their exponentials, and the weights go back to
//   the lanes' columns by the inverse all-gather;
// - the widths or layouts the 16-byte one does not take (a width not a
//   multiple of 8, a head split that is not a power of two, a row base that
//   is only 8-byte aligned) run the word geometry of
//   csr_attention_bf16_words.cu, an entry of its own, where its lanes hold
//   the row; the rest (past 32 lanes of words or 16 heads) the general
//   geometry here (strided columns, per-head sums through shared memory).
//   The host chooses by shape (ops/csr_attention.py, `bf16_geometry`).
// Tensor cores do not apply: every edge dots a different k row.
//
// stream_dtype="bf16" (entry csr_attention_bf16_stream): JAX's caller
// rounds the f32 scores to bf16 before its K2 (pallas_attention.py:287-302;
// the v rows are bf16 already), so the mode is a compile-time flag of this
// kernel (STREAM) that rounds each edge's scores to bf16 (to nearest even)
// before they enter the online softmax. The bytes are the bf16 entry's. The
// backward is the bf16 one (csr_attention_bwd_bf16.cu), which recomputes
// the unrounded scores, with this pass's ml and out.

#include "csr_attention_bf16.cuh"

namespace {

using namespace csr_attention16;

template <int V, int NP, int RS, bool GEN, bool STREAM>
__global__ void __launch_bounds__(kThreads)
csr_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ gather_idx,
                          const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ ml, int64_t num_rows,
                          int64_t num_edges, Geometry geo, float scale) {
  constexpr int NPR = NP >> RS;
  constexpr int U = group_edges<GEN>(kForwardGroup);
  const RowSlot r = row_slot<V, GEN>(geo, bounds, num_rows, num_edges);
  float* scratch = row_scratch<GEN>(geo);
  float qr[V];
  {
    RowBuf<V, GEN> qb;
    fetch<V, GEN>(q, r.has_row ? static_cast<int32_t>(r.row) : -1, geo, r, qb);
    unpack<V, GEN>(qb, qr);
  }
  float m[NPR], l[NPR], acc[V];
#pragma unroll
  for (int p = 0; p < NPR; ++p) {
    m[p] = kNeg;
    l[p] = 0.0f;
  }
  zero_cols<V>(acc);

  const int32_t trips = warp_max(r.len);  // uniform across the warp
  for (int32_t first = 0; first < trips; first += geo.lanes) {
    const int32_t mine = chunk_index(gather_idx, mask, r, first);
    const int32_t count = min(geo.lanes, trips - first);
    for (int32_t t0 = 0; t0 < count; t0 += U) {
      int32_t js[U];
      RowBuf<V, GEN> kb[U], vb[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int32_t j = __shfl_sync(kFull, mine, t0 + u, geo.lanes);
        js[u] = t0 + u < count ? j : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        fetch<V, GEN>(k, js[u], geo, r, kb[u]);
        fetch<V, GEN>(v, js[u], geo, r, vb[u]);
      }
      float s[U][NPR];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kr[V];
        unpack<V, GEN>(kb[u], kr);
        head_sums<V, NP, RS, GEN>(geo, r, qr, kr, s[u], scratch);
#pragma unroll
        for (int p = 0; p < NPR; ++p) s[u][p] *= scale;
        if constexpr (STREAM) {
#pragma unroll
          for (int p = 0; p < NPR; ++p) s[u][p] = round_to<__nv_bfloat16>(s[u][p]);
        }
      }
      // one online-softmax step for the group: its max, one rescale
      float alpha[NPR];
#pragma unroll
      for (int p = 0; p < NPR; ++p) {
        float m_new = m[p];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (js[u] >= 0) m_new = fmaxf(m_new, s[u][p]);
        }
        alpha[p] = expf(m[p] - m_new);
        l[p] *= alpha[p];
        m[p] = m_new;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u][p] = js[u] >= 0 ? expf(s[u][p] - m_new) : 0.0f;  // the edge's weight
          l[p] += s[u][p];
        }
      }
      float af[NP];
      head_spread<NP, RS>(geo, r.sub, alpha, af);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] *= af[i % NP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float pf[NP], vr[V];
        head_spread<NP, RS>(geo, r.sub, s[u], pf);
        unpack<V, GEN>(vb[u], vr);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += pf[i % NP] * vr[i];
      }
    }
  }
  float lf[NP];
  head_spread<NP, RS>(geo, r.sub, l, lf);  // every lane: before any returns
  if (!r.has_row) return;
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = acc[i] / (lf[i % NP] + kEps);
  store<V, GEN>(out, r.row, geo, r, o);
  const int base = GEN ? 0 : partial_base<NP, RS>(geo, r.sub);
#pragma unroll
  for (int p = 0; p < NPR; ++p) {
    if (writes<V, RS, GEN>(geo, r, p)) {
      const int h = head_of<V, GEN>(geo, r, base + p);
      ml[h * num_rows + r.row] = m[p];
      ml[(geo.heads + h) * num_rows + r.row] = l[p];
    }
  }
}

template <int V, int NP, int RS, bool GEN, bool STREAM>
cudaError_t launch(const void* q, const void* k, const void* v, const void* gather_idx,
                   const void* bounds, const void* mask, void* out, void* ml, long long num_rows,
                   long long num_edges, const Geometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_bf16_kernel<V, NP, RS, GEN, STREAM><<<grid, kThreads, shared_bytes(geo), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(gather_idx),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ml), num_rows, num_edges, geo, scale);
  return cudaGetLastError();
}

// The instantiation of the geometry's case, with the bf16 stream's score
// rounding or without.
template <bool STREAM>
int run(const void* q, const void* k, const void* v, const void* gather_idx, const void* bounds,
        const void* mask, void* out, void* ml, long long num_rows, long long num_edges,
        int num_heads, int width, int interleaved, int lanes, int general, float scale,
        void* stream) {
  if (num_rows <= 0) return 0;
  Geometry geo;
  if (!make_geometry16(lanes, width, num_heads, interleaved, general, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(V, NP, RS)                \
  case (V) * 256 + (NP) * 8 + (RS): \
    return static_cast<int>(launch<V, NP, RS, false, STREAM>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, geo, scale, s));
#define GENERAL_CASE(V) \
  case 1024 + (V):      \
    return static_cast<int>(launch<V, V, 0, true, STREAM>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, geo, scale, s));
  switch (case_key16(geo)) {
    CSR_ATTENTION16_CASES(CASE)
    CSR_ATTENTION_GENERAL_CASES(GENERAL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
#undef GENERAL_CASE
}

}  // namespace

// q, k, v [N, D] bf16 node rows in one layout (interleaved: [Dh, H] rows,
// else [H, Dh]); gather_idx [E] int32; bounds [2, N] int32; mask [E] bool
// (or null); out [N, D] bf16 in the same layout; ml [2H, N] f32; all device
// pointers, contiguous. general == 0: the 16-byte geometry, `lanes` = D / 8
// or D / 16 lanes a row, every row base 16-byte aligned; general == 1: the
// general geometry, `lanes` 8, 16 or 32, 2-byte aligned (make_geometry16;
// the wrapper chooses, other shapes return cudaErrorInvalidValue).
// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).
extern "C" int csr_attention_bf16(const void* q, const void* k, const void* v, const void* gather_idx,
                                  const void* bounds, const void* mask, void* out, void* ml,
                                  long long num_rows, long long num_edges, int num_heads, int width,
                                  int interleaved, int lanes, int general, float scale, void* stream) {
  return run<false>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, num_heads,
                    width, interleaved, lanes, general, scale, stream);
}

// The same with stream_dtype="bf16": each score rounded to bf16 before use.
extern "C" int csr_attention_bf16_stream(const void* q, const void* k, const void* v,
                                         const void* gather_idx, const void* bounds,
                                         const void* mask, void* out, void* ml, long long num_rows,
                                         long long num_edges, int num_heads, int width,
                                         int interleaved, int lanes, int general, float scale,
                                         void* stream) {
  return run<true>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, num_heads,
                   width, interleaved, lanes, general, scale, stream);
}
