// Backward of the fused CSR attention on bf16 node rows
// (csr_attention_bf16.cu), for Hopper (sm_90a), without atomics: the same
// inputs give the same bits on every run. From the forward's out, its
// statistics ml = [m; l] and the output's gradient g, for each sender row n
// and head h:
//
//   delta[n, h] = <out[n, h, :], g[n, h, :]>
//
// and for each real unmasked edge e of n's range, with j = gather_idx[e]:
//
//   s         = scale * <q[n, h, :], k[j, h, :]>
//   attn      = exp(s - m[h, n]) / (l[h, n] + 1e-16)
//   ds        = attn * (<v[j, h, :], g[n, h, :]> - delta[n, h])
//   dq[n, h]  = sum_e ds * scale * k[j, h, :]
//   dk[j, h]  = sum_e ds * scale * q[n, h, :]
//   dv[j, h]  = sum_e bf16(attn * g[n, h, :])
//
// all f32 but the bf16 rows read and the bf16 rounding of each dv term (the
// JAX backward rounds its per-edge dvalues to the values' dtype,
// pallas_attention.py `_edge_grads`); dq, dk and dv are rounded to bf16
// once. Masked edges, edges outside every range and rows without edges add
// exactly nothing; a row that no edge gathers gets dk = dv = 0.
//
// Replaces the backward of the TPU kernel's custom VJP (`_bwd` with
// `_pack_node_side` and `_edge_grads` in graphphysics_tpu/ops/pallas_attention.py)
// and of its caller's gathers and SDDMM, fed bf16 q, k, v.
//
// Two kernels, launched in turn by the one entry:
// - part A, by sender rows (csr_attention_bf16.cu's lane geometry, edge
//   groups and reduce-scatter head sums): delta, then per edge its score
//   and <v, g> per head, attn and ds; dq summed in registers; attn and ds
//   written per real unmasked edge as one [E, H, 2] f32 row (each head's
//   pair side by side: one 8-byte store a head, and the heads' lanes write
//   one contiguous run). At the 8 x 2,048 batch (88,694 real edges, H = 4) that is
//   2.8 MB, written and read back through the L2. Writing only delta
//   instead would make part B recompute each score and <v, g> from four
//   rows gathered per edge in place of two.
// - part B, by gather rows over the transposed CSR (ops/csr_attention.py
//   `gather_csr`, built once per graph and step): for node j the slots
//   [gather_bounds[0, j], gather_bounds[1, j]) list the real unmasked edges
//   with gather_idx[e] == j in ascending edge id (gather_order) and their
//   sender rows (gather_senders). A group of G lanes walks them in that
//   order, U edges' q and g rows and attn, ds rows in flight at once, sums
//   dk and dv in f32 registers and writes each row once, as bf16.
// No atomics: a gather row's dk and dv are summed by one lane group in a
// fixed order, so there is no read-modify-write of f32 rows in the L2 per
// edge, no zeroed f32 buffer and no cast pass, and the sums take the same
// order on every run. Part A's and part B's lanes hold 16 columns each
// where the width allows (8 lanes a row at D = 128; ops/csr_attention.py
// `BF16_BACKWARD_COLUMNS`). The widths without the 16-byte geometry run the
// same two parts in the word geometry (csr_attention_bf16_words.cu) where
// its lanes hold the row, the general geometry here past that.
//
// Bound: memory. The bytes that must move are
//   N*2D*5           q, k, v, out and g read
//   + E_real*(4 + 1) the gather index and mask byte of each real edge
//   + N*(8 + 8H)     the two bounds and ml
//   + N*2D*3         dq, dk, dv written
// (part A's [E, H, 2] rows and the transposed CSR's indices are this design's
// own traffic, not the function's). Tensor cores do not apply: every edge
// dots a different k row.

#include "csr_attention_bf16.cuh"

namespace {

using namespace csr_attention16;

// Part A: per sender row, dq and each edge's attn and ds.
template <int V, int NP, int RS, bool GEN>
__global__ void __launch_bounds__(kThreads)
csr_attention_bwd_rows_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ gather_idx,
                              const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                              const float* __restrict__ ml, const __nv_bfloat16* __restrict__ out,
                              const __nv_bfloat16* __restrict__ g, float* __restrict__ attn_ds,
                              __nv_bfloat16* __restrict__ dq, int64_t num_rows, int64_t num_edges,
                              Geometry geo, float scale) {
  constexpr int NPR = NP >> RS;
  constexpr int U = group_edges<GEN>(kRowsGroup);
  const RowSlot r = row_slot<V, GEN>(geo, bounds, num_rows, num_edges);
  float* scratch = row_scratch<GEN>(geo);
  const int32_t self = r.has_row ? static_cast<int32_t>(r.row) : -1;
  float qr[V], gr[V];
  float delta[NPR];
  {
    RowBuf<V, GEN> qb, gb, ob;
    fetch<V, GEN>(q, self, geo, r, qb);
    fetch<V, GEN>(g, self, geo, r, gb);
    fetch<V, GEN>(out, self, geo, r, ob);
    float o[V];
    unpack<V, GEN>(qb, qr);
    unpack<V, GEN>(gb, gr);
    unpack<V, GEN>(ob, o);
    head_sums<V, NP, RS, GEN>(geo, r, o, gr, delta, scratch);
  }
  const int base = GEN ? 0 : partial_base<NP, RS>(geo, r.sub);
  float m[NPR], inv_l[NPR];  // inv_l: 1 / (l + 1e-16), one division a row and head
#pragma unroll
  for (int p = 0; p < NPR; ++p) {
    float l = 0.0f;
    m[p] = kNeg;
    if (!partial_live<V, GEN>(geo, r, base + p)) {
      m[p] = 0.0f;  // a tail column: its unused terms stay finite
    } else if (r.has_row) {
      const int h = head_of<V, GEN>(geo, r, base + p);
      m[p] = ml[h * num_rows + r.row];
      l = ml[(geo.heads + h) * num_rows + r.row];
    }
    inv_l[p] = 1.0f / (l + kEps);
  }
  const int64_t row_width = 2 * geo.heads;  // an [E, H, 2] row: (attn, ds) by head
  float dqa[V];
  zero_cols<V>(dqa);

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
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kr[V], vr[V];
        unpack<V, GEN>(kb[u], kr);
        unpack<V, GEN>(vb[u], vr);
        float s[NPR], vg[NPR];
        head_sums<V, NP, RS, GEN>(geo, r, qr, kr, s, scratch);
        head_sums<V, NP, RS, GEN>(geo, r, vr, gr, vg, scratch);
        float attn[NPR], ds[NPR];
#pragma unroll
        for (int p = 0; p < NPR; ++p) {
          attn[p] = expf(s[p] * scale - m[p]) * inv_l[p];
          ds[p] = attn[p] * (vg[p] - delta[p]);
        }
        if (js[u] >= 0) {  // uniform across the row's lanes
          float* row = attn_ds + (r.start + first + t0 + u) * row_width;
#pragma unroll
          for (int p = 0; p < NPR; ++p) {
            if (writes<V, RS, GEN>(geo, r, p)) {
              const int h = head_of<V, GEN>(geo, r, base + p);
              *reinterpret_cast<float2*>(row + 2 * h) = make_float2(attn[p], ds[p]);
            }
          }
        }
        float df[NP];
        head_spread<NP, RS>(geo, r.sub, ds, df);
        if (js[u] >= 0) {
#pragma unroll
          for (int i = 0; i < V; ++i) dqa[i] += df[i % NP] * scale * kr[i];
        }
      }
    }
  }
  if (r.has_row) store<V, GEN>(dq, r.row, geo, r, dqa);
}

// The per-head (attn, ds) of one edge for the lane's NP partials: the
// 16-byte geometry's partials hold the consecutive heads h0 .. h0 + NP - 1
// (16-byte loads of two heads' pairs); the general geometry's partial p
// the head of column p.
template <int V, int NP, bool GEN>
__device__ __forceinline__ void load_edge_terms(const float* __restrict__ attn_ds, int32_t e, int h0,
                                                const Geometry& geo, const RowSlot& r, float (&a)[NP],
                                                float (&d)[NP]) {
  if (e < 0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) a[p] = d[p] = 0.0f;
    return;
  }
  const float* row = attn_ds + static_cast<int64_t>(e) * 2 * geo.heads;
  if constexpr (GEN || NP % 2) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int h = !GEN ? h0 + p : (partial_live<V, GEN>(geo, r, p) ? head_of<V, GEN>(geo, r, p) : 0);
      const float2 x = *reinterpret_cast<const float2*>(row + 2 * h);
      a[p] = x.x;
      d[p] = x.y;
    }
  } else {
#pragma unroll
    for (int p = 0; p < NP; p += 2) {
      const float4 x = *reinterpret_cast<const float4*>(row + 2 * (h0 + p));
      a[p] = x.x;
      d[p] = x.y;
      a[p + 1] = x.z;
      d[p + 1] = x.w;
    }
  }
}

// Part B: per gather row j, dk and dv summed over the transposed CSR's
// slots of j in order.
template <int V, int NP, bool GEN>
__global__ void __launch_bounds__(kThreads)
csr_attention_bwd_gather_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
                                const int32_t* __restrict__ gather_bounds,
                                const int32_t* __restrict__ gather_order,
                                const int32_t* __restrict__ gather_senders,
                                const float* __restrict__ attn_ds, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int64_t num_rows, int64_t num_edges,
                                Geometry geo, float scale) {
  constexpr int U = group_edges<GEN>(kGatherGroup);
  const RowSlot r = row_slot<V, GEN>(geo, gather_bounds, num_rows, num_edges);
  const int h0 = GEN ? 0 : head_of<V, GEN>(geo, r, 0);
  float dka[V], dva[V];
  zero_cols<V>(dka);
  zero_cols<V>(dva);

  const int32_t trips = warp_max(r.len);  // uniform across the warp
  for (int32_t first = 0; first < trips; first += geo.lanes) {
    // one coalesced load of the group's next G slots: edge and sender
    const int32_t t = first + r.sub;
    const bool live = t < r.len;
    const int32_t my_edge = live ? gather_order[r.start + t] : -1;
    const int32_t my_sender = live ? gather_senders[r.start + t] : -1;
    const int32_t count = min(geo.lanes, trips - first);
    for (int32_t t0 = 0; t0 < count; t0 += U) {
      int32_t es[U], ns[U];
      RowBuf<V, GEN> qb[U], gb[U];
      float a[U][NP], d[U][NP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int32_t e = __shfl_sync(kFull, my_edge, t0 + u, geo.lanes);
        const int32_t n = __shfl_sync(kFull, my_sender, t0 + u, geo.lanes);
        const bool in = t0 + u < count && e >= 0;
        es[u] = in ? e : -1;
        ns[u] = in ? n : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        fetch<V, GEN>(q, ns[u], geo, r, qb[u]);
        fetch<V, GEN>(g, ns[u], geo, r, gb[u]);
        load_edge_terms<V, NP, GEN>(attn_ds, es[u], h0, geo, r, a[u], d[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (es[u] < 0) continue;  // uniform across the row's lanes
        float qr[V], gr[V];
        unpack<V, GEN>(qb[u], qr);
        unpack<V, GEN>(gb[u], gr);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dka[i] += d[u][i % NP] * scale * qr[i];
          dva[i] += round_to<__nv_bfloat16>(a[u][i % NP] * gr[i]);
        }
      }
    }
  }
  if (r.has_row) {
    store<V, GEN>(dk, r.row, geo, r, dka);
    store<V, GEN>(dv, r.row, geo, r, dva);
  }
}

template <int V, int NP, int RS, bool GEN>
cudaError_t launch(const void* q, const void* k, const void* v, const void* gather_idx,
                   const void* bounds, const void* mask, const void* ml, const void* out,
                   const void* g, const void* gather_bounds, const void* gather_order,
                   const void* gather_senders, void* attn_ds, void* dq, void* dk, void* dv,
                   long long num_rows, long long num_edges, const Geometry& geo, float scale,
                   cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_bwd_rows_kernel<V, NP, RS, GEN><<<grid, kThreads, shared_bytes(geo), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(ml), static_cast<const bf16*>(out),
      static_cast<const bf16*>(g), static_cast<float*>(attn_ds), static_cast<bf16*>(dq), num_rows,
      num_edges, geo, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  csr_attention_bwd_gather_kernel<V, NP, GEN><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(g),
      static_cast<const int32_t*>(gather_bounds), static_cast<const int32_t*>(gather_order),
      static_cast<const int32_t*>(gather_senders), static_cast<const float*>(attn_ds),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), num_rows, num_edges, geo, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, g [N, D] bf16 node rows in one layout (interleaved: [Dh,
// H] rows, else [H, Dh]); gather_idx [E] int32; bounds [2, N] int32; mask
// [E] bool (or null); ml [2H, N] f32; the transposed CSR: gather_bounds
// [2, N], gather_order [E] and gather_senders [E] int32; attn_ds [E, H, 2]
// f32 scratch (no zeroing: part A writes every row part B reads); dq, dk,
// dv [N, D] bf16 in the inputs' layout, every row written; all device
// pointers, contiguous. `lanes` and `general` as csr_attention_bf16.
// Launches part A then part B on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 when both launches were accepted).
extern "C" int csr_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* gather_idx, const void* bounds, const void* mask,
                                      const void* ml, const void* out, const void* g,
                                      const void* gather_bounds, const void* gather_order,
                                      const void* gather_senders, void* attn_ds, void* dq, void* dk,
                                      void* dv, long long num_rows, long long num_edges,
                                      int num_heads, int width, int interleaved, int lanes,
                                      int general, float scale, void* stream) {
  if (num_rows <= 0) return 0;
  Geometry geo;
  if (!make_geometry16(lanes, width, num_heads, interleaved, general, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                                        \
  q, k, v, gather_idx, bounds, mask, ml, out, g, gather_bounds, gather_order, gather_senders, attn_ds, \
      dq, dk, dv, num_rows, num_edges, geo, scale, s
#define CASE(V, NP, RS)                \
  case (V) * 256 + (NP) * 8 + (RS): \
    return static_cast<int>(launch<V, NP, RS, false>(ARGS));
#define GENERAL_CASE(V) \
  case 1024 + (V):      \
    return static_cast<int>(launch<V, V, 0, true>(ARGS));
  switch (case_key16(geo)) {
    CSR_ATTENTION16_CASES(CASE)
    CSR_ATTENTION_GENERAL_CASES(GENERAL_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
#undef CASE
#undef GENERAL_CASE
}
