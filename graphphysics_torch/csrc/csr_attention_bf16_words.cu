// The fused CSR attention on bf16 node rows in the word geometry, for
// Hopper (sm_90a): csr_attention_bf16.cu's forward and
// csr_attention_bwd_bf16.cu's backward (the same functions, roundings and
// bytes) at the widths the 16-byte geometry of csr_attention_bf16.cuh does
// not take and the words of attention_words.cuh hold: a width not a
// multiple of 8 or a row base only 8-byte aligned (8-byte words), a head
// split that no lane count of 8 or 16 columns a lane divides into
// power-of-two partials (48 or 40 columns in 4 heads, 96 in 3, 40 in 8).
//
// Replaces the Pallas TPU kernel `_softmax_spmm_impl` / `_kernel`
// (graphphysics_tpu/ops/pallas_attention.py:255) with the XLA work of its
// caller `csr_sparse_attention` (:556: gathers, per-head dot, masking) fed
// bf16 q, k, v at such widths (any D % H == 0, :269), and the backward of
// its custom VJP (`_bwd`, `_pack_node_side`, `_edge_grads`, :398-452; the
// per-edge dvalues rounded to bf16, :449) with the backward of those
// gathers and SDDMM.
//
// Bound: memory, the bf16 entries' bytes (2 a q, k, v, out, g, dq, dk and dv
// element: csr_attention_bf16.cu, csr_attention_bwd_bf16.cu). At these
// shapes the gathers are bound by latency and issue: each edge reads two
// rows at a node picked by an index just loaded.
//
// Design (attention_words.cuh): a lane owns one word of W bf16 columns, 8
// (16 bytes) where D % 8 == 0 and every row base is 16-byte aligned, else 4
// (8 bytes); a row takes D / W lanes rounded up to a power of two (at least
// H), so 48 x 4 runs 8 lanes and four rows a warp, one 16-byte load a
// gathered row a lane. Words stay raw bf16 bits until used. Per-head
// partials go through a reduce-scatter of shuffles to one head a lane,
// which alone keeps that head's softmax state and computes its exponentials
// (one a head and edge, not one a column); the columns read their head's
// weights back by shuffles. No shared memory and no barrier. Each part has
// the k and v (part B: q and g) words of kEdges (2) edges in flight, as the
// f32 entries (trial builds on an H100: 4 edges slower in the forward and
// part B, 1 edge slower in part A at 48 x 4).
// - forward (entries csr_attention_bf16_words and its stream twin): the
//   shared csr_attention_words_kernel with T = bf16; out rounded to bf16
//   once, ml f32; STREAM rounds each score to bf16 before the softmax (the
//   v rows are bf16 already);
// - backward (entry csr_attention_bwd_bf16_words), without atomics, in
//   csr_attention_bwd_bf16.cu's two parts, so two runs give the same bits.
//   Part A by sender rows: delta = <out, g> a head; per edge the head sums
//   of the score and of <v, g> in one reduce-scatter; the lane holding a
//   head forms attn (times 1 / (l + 1e-16), one division a row and head, as
//   the 16-byte geometry's part A) and ds and writes that head's (attn, ds)
//   pair into the [E, H, 2] f32 rows; dq summed in registers, ds read back
//   by shuffles.
//   Part B by gather rows over the transposed CSR (ops/csr_attention.py
//   `gather_csr`): the same words; per slot the (attn, ds) pairs of the
//   heads the lane's columns hold: an aligned lane's P consecutive heads as
//   16-byte loads; for a select one 8-byte load a column of its head's
//   pair, within the edge's 8H bytes (all H pairs loaded at once and then
//   picked by each column's head went to local memory, slower on an H100);
//   dk += ds * scale * q and dv += bf16(attn * g) per column in the
//   transposed CSR's order (the parent design's per-column arithmetic); dk
//   and dv written once, as bf16.
// Tensor cores do not apply: every edge dots a different k row.

#include "attention_words.cuh"

namespace {

using namespace attention_words;
using bf16 = __nv_bfloat16;

// Part A: per sender row, dq and each real unmasked edge's (attn, ds) a head.
template <int W, int P, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
csr_attention_bwd_rows_words_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const int32_t* __restrict__ gather_idx,
                                    const int32_t* __restrict__ bounds, const uint8_t* __restrict__ mask,
                                    const float* __restrict__ ml, const bf16* __restrict__ out,
                                    const bf16* __restrict__ g, float* __restrict__ attn_ds,
                                    bf16* __restrict__ dq, int64_t num_rows, int64_t num_edges,
                                    WordGeometry geo, float scale) {
  using Hd = Heads<W, P, ALIGNED>;
  const WordSlot r = word_slot(geo, bounds, num_rows, num_edges);
  float qr[W], gr[W], o[W];
  {
    Word<bf16, W> qw, gw, ow;
    load_word<bf16, W>(q, r.self, geo, r, qw);
    load_word<bf16, W>(g, r.self, geo, r, gw);
    load_word<bf16, W>(out, r.self, geo, r, ow);
    widen<bf16, W>(qw, qr);
    widen<bf16, W>(gw, gr);
    widen<bf16, W>(ow, o);
  }
  const Hd h = make_heads<W, P, ALIGNED>(geo, r);
  const float delta = head_sum<W, P, ALIGNED>(geo, r, h, o, gr);
  // inv_l: 1 / (l + 1e-16), one division a row and head; a padding
  // partial's or an idle lane's terms stay finite
  float m = 0.0f, inv_l = 1.0f;
  if (h.own < geo.heads && r.has_row) {
    m = ml[h.own * num_rows + r.row];
    inv_l = 1.0f / (ml[(geo.heads + h.own) * num_rows + r.row] + kEps);
  }
  const int64_t row_width = 2 * geo.heads;  // an [E, H, 2] row: (attn, ds) by head
  float dqa[W];
#pragma unroll
  for (int i = 0; i < W; ++i) dqa[i] = 0.0f;

  const int32_t trips = warp_max(r.len);  // uniform across the warp
  for (int32_t first = 0; first < trips; first += geo.lanes) {
    const int32_t mine = word_chunk_index(gather_idx, mask, r, first);
    const int32_t count = min(geo.lanes, trips - first);
    for (int32_t t0 = 0; t0 < count; t0 += kEdges) {
      int32_t j[kEdges];
      Word<bf16, W> kw[kEdges], vw[kEdges];
      load_window<bf16, W>(k, v, geo, r, mine, t0, count, j, kw, vw);
      float ds[kEdges];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        float a[2][W], b[2][W], sums[2];  // the score's dot and <v, g>: one reduce-scatter
        widen<bf16, W>(kw[u], b[0]);
        widen<bf16, W>(vw[u], a[1]);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          a[0][i] = qr[i];
          b[1][i] = gr[i];
        }
        head_sums<2, W, P, ALIGNED>(geo, r, h, a, b, sums);
        const float attn = j[u] >= 0 ? expf(sums[0] * scale - m) * inv_l : 0.0f;
        ds[u] = attn * (sums[1] - delta);
        if (j[u] >= 0 && h.writes) {  // one lane of each head
          float* row = attn_ds + (r.start + first + t0 + u) * row_width;
          *reinterpret_cast<float2*>(row + 2 * h.own) = make_float2(attn, ds[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        float kr[W], dss[Hd::kValues];
        widen<bf16, W>(kw[u], kr);
        read_back<W, P, ALIGNED>(geo, h, ds[u], dss);
#pragma unroll
        for (int i = 0; i < W; ++i) dqa[i] += dss[value_of<W, P, ALIGNED>(i)] * scale * kr[i];
      }
    }
  }
  if (r.has_row && r.live) store_word<bf16, W>(dq, r.row, geo, r, dqa);
}

// The (attn, ds) pairs of edge e that the lane's columns take, K of them:
// ALIGNED (K = P), the P consecutive heads h0 .. h0 + P - 1 of its partials
// (one 8-byte load at P = 1, else 16-byte loads of two heads' pairs); the
// select (K = W), one 8-byte load a column of its head's pair (`head`),
// within the edge's 8H bytes. Zeros for e < 0 and on an idle lane.
template <int W, int P, bool ALIGNED, int K>
__device__ __forceinline__ void load_pairs(const float* __restrict__ attn_ds, int32_t e, int h0,
                                           const int (&head)[W], const WordGeometry& geo, const WordSlot& r,
                                           float (&a)[K], float (&d)[K]) {
#pragma unroll
  for (int x = 0; x < K; ++x) a[x] = d[x] = 0.0f;
  if (e < 0 || !r.live) return;
  const float* row = attn_ds + static_cast<int64_t>(e) * 2 * geo.heads;
  if constexpr (ALIGNED && P == 1) {
    const float2 x = *reinterpret_cast<const float2*>(row + 2 * h0);
    a[0] = x.x;
    d[0] = x.y;
  } else if constexpr (ALIGNED) {
#pragma unroll
    for (int p = 0; p < P; p += 2) {
      const float4 x = *reinterpret_cast<const float4*>(row + 2 * (h0 + p));
      a[p] = x.x;
      d[p] = x.y;
      a[p + 1] = x.z;
      d[p + 1] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(row + 2 * head[i]);
      a[i] = x.x;
      d[i] = x.y;
    }
  }
}

// Part B: per gather row, dk and dv summed over the transposed CSR's slots
// of the row in order.
template <int W, int P, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
csr_attention_bwd_gather_words_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g,
                                      const int32_t* __restrict__ gather_bounds,
                                      const int32_t* __restrict__ gather_order,
                                      const int32_t* __restrict__ gather_senders,
                                      const float* __restrict__ attn_ds, bf16* __restrict__ dk,
                                      bf16* __restrict__ dv, int64_t num_rows, int64_t num_edges,
                                      WordGeometry geo, float scale) {
  const WordSlot r = word_slot(geo, gather_bounds, num_rows, num_edges);
  constexpr int K = ALIGNED ? P : W;    // the pairs a lane takes an edge
  const int h0 = word_head(geo, r, 0);  // ALIGNED: the head of partial 0
  int head[W];                          // the select: each column's head
#pragma unroll
  for (int i = 0; i < W; ++i) head[i] = word_head(geo, r, i);
  float dka[W], dva[W];
#pragma unroll
  for (int i = 0; i < W; ++i) dka[i] = dva[i] = 0.0f;

  const int32_t trips = warp_max(r.len);  // uniform across the warp
  for (int32_t first = 0; first < trips; first += geo.lanes) {
    // one coalesced load of the group's next L slots: edge and sender
    const int32_t t = first + r.sub;
    const bool slot = t < r.len;
    const int32_t my_edge = slot ? gather_order[r.start + t] : -1;
    const int32_t my_sender = slot ? gather_senders[r.start + t] : -1;
    const int32_t count = min(geo.lanes, trips - first);
    for (int32_t t0 = 0; t0 < count; t0 += kEdges) {
      int32_t es[kEdges];
      Word<bf16, W> qw[kEdges], gw[kEdges];
      float a[kEdges][K], d[kEdges][K];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        const int src = min(t0 + u, geo.lanes - 1);
        const int32_t e = __shfl_sync(kFull, my_edge, src, geo.lanes);
        const int32_t n = __shfl_sync(kFull, my_sender, src, geo.lanes);
        const bool in = t0 + u < count && e >= 0;
        es[u] = in ? e : -1;
        const int32_t row = in ? n : r.self;  // a slot without an edge adds zeros
        load_word<bf16, W>(q, row, geo, r, qw[u]);
        load_word<bf16, W>(g, row, geo, r, gw[u]);
        load_pairs<W, P, ALIGNED, K>(attn_ds, es[u], h0, head, geo, r, a[u], d[u]);
      }
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        float qr[W], gr[W];
        widen<bf16, W>(qw[u], qr);
        widen<bf16, W>(gw[u], gr);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int x = ALIGNED ? i % P : i;  // the column's head's pair: partial i % P, or its own
          dka[i] += d[u][x] * scale * qr[i];
          dva[i] += round_to<bf16>(a[u][x] * gr[i]);
        }
      }
    }
  }
  if (r.has_row && r.live) {
    store_word<bf16, W>(dk, r.row, geo, r, dka);
    store_word<bf16, W>(dv, r.row, geo, r, dva);
  }
}

template <int W, int P, bool ALIGNED>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* gather_idx,
                            const void* bounds, const void* mask, const void* ml, const void* out, const void* g,
                            const void* gather_bounds, const void* gather_order, const void* gather_senders,
                            void* attn_ds, void* dq, void* dk, void* dv, long long num_rows, long long num_edges,
                            const WordGeometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_bwd_rows_words_kernel<W, P, ALIGNED><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(ml), static_cast<const bf16*>(out),
      static_cast<const bf16*>(g), static_cast<float*>(attn_ds), static_cast<bf16*>(dq), num_rows, num_edges,
      geo, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  csr_attention_bwd_gather_words_kernel<W, P, ALIGNED><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(g), static_cast<const int32_t*>(gather_bounds),
      static_cast<const int32_t*>(gather_order), static_cast<const int32_t*>(gather_senders),
      static_cast<const float*>(attn_ds), static_cast<bf16*>(dk), static_cast<bf16*>(dv), num_rows, num_edges,
      geo, scale);
  return cudaGetLastError();
}

// The word geometry the host asks for: `lanes` lanes a row, 16-byte words
// where `wide` (every row base 16-byte aligned) and D % 8 == 0, else 8-byte
// ones; false for any other (a width not a multiple of 4 among them).
bool word_geometry16(int width, int num_heads, int interleaved, int lanes, int wide, WordGeometry* geo) {
  return make_word_geometry(width, num_heads, interleaved, lanes, geo, wide != 0) && geo->cols >= 4;
}

template <bool STREAM>
int run_forward(const void* q, const void* k, const void* v, const void* gather_idx, const void* bounds,
                const void* mask, void* out, void* ml, long long num_rows, long long num_edges, int num_heads,
                int width, int interleaved, int lanes, int wide, float scale, void* stream) {
  if (num_rows <= 0) return 0;
  WordGeometry geo;
  if (!word_geometry16(width, num_heads, interleaved, lanes, wide, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(W, P, ALIGNED)                                                                                   \
  case (W) * 256 + (P) * 2 + (ALIGNED):                                                                       \
    return static_cast<int>(launch_words_forward<bf16, W, P, ALIGNED, STREAM>(                         \
        q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, geo, scale, s));
  switch (word_case_key(geo)) {
    ATTENTION_WORD16_CASES(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}

}  // namespace

// q, k, v [N, D] bf16 node rows in one layout (interleaved: [Dh, H] rows,
// else [H, Dh]), D % 4 == 0, every row base 8-byte aligned (16-byte with
// `wide`); gather_idx [E] int32; bounds [2, N] int32; mask [E] bool (or
// null); out [N, D] bf16 in the same layout; ml [2H, N] f32; all device
// pointers, contiguous. `lanes` must be the width's word geometry's
// (make_word_geometry with 16-byte words where `wide`; the wrapper chooses,
// ops/csr_attention.py bf16_word_geometry; other shapes return
// cudaErrorInvalidValue). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_attention_bf16_words(const void* q, const void* k, const void* v, const void* gather_idx,
                                        const void* bounds, const void* mask, void* out, void* ml,
                                        long long num_rows, long long num_edges, int num_heads, int width,
                                        int interleaved, int lanes, int wide, float scale, void* stream) {
  return run_forward<false>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, num_heads, width,
                            interleaved, lanes, wide, scale, stream);
}

// The same with stream_dtype="bf16": each score rounded to bf16 before use.
extern "C" int csr_attention_bf16_words_stream(const void* q, const void* k, const void* v,
                                               const void* gather_idx, const void* bounds, const void* mask,
                                               void* out, void* ml, long long num_rows, long long num_edges,
                                               int num_heads, int width, int interleaved, int lanes, int wide,
                                               float scale, void* stream) {
  return run_forward<true>(q, k, v, gather_idx, bounds, mask, out, ml, num_rows, num_edges, num_heads, width,
                           interleaved, lanes, wide, scale, stream);
}

// The backward: q, k, v, out, g [N, D] bf16 node rows in one layout, as
// csr_attention_bf16_words; ml [2H, N] f32; the transposed CSR:
// gather_bounds [2, N], gather_order [E] and gather_senders [E] int32;
// attn_ds [E, H, 2] f32 scratch (no zeroing: part A writes every row part B
// reads); dq, dk, dv [N, D] bf16 in the inputs' layout, every row written;
// all device pointers, contiguous. `lanes` and `wide` as
// csr_attention_bf16_words. Launches part A then part B on `stream` and
// returns the first cudaGetLastError() that is not 0 (0 when both launches
// were accepted).
extern "C" int csr_attention_bwd_bf16_words(const void* q, const void* k, const void* v,
                                            const void* gather_idx, const void* bounds, const void* mask,
                                            const void* ml, const void* out, const void* g,
                                            const void* gather_bounds, const void* gather_order,
                                            const void* gather_senders, void* attn_ds, void* dq, void* dk,
                                            void* dv, long long num_rows, long long num_edges, int num_heads,
                                            int width, int interleaved, int lanes, int wide, float scale,
                                            void* stream) {
  if (num_rows <= 0) return 0;
  WordGeometry geo;
  if (!word_geometry16(width, num_heads, interleaved, lanes, wide, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(W, P, ALIGNED)                                                                                   \
  case (W) * 256 + (P) * 2 + (ALIGNED):                                                                       \
    return static_cast<int>(launch_backward<W, P, ALIGNED>(q, k, v, gather_idx, bounds, mask, ml, out, g,     \
                                                           gather_bounds, gather_order, gather_senders,       \
                                                           attn_ds, dq, dk, dv, num_rows, num_edges, geo,     \
                                                           scale, s));
  switch (word_case_key(geo)) {
    ATTENTION_WORD16_CASES(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
