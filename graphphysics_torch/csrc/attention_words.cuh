// The word geometry of the fused attention: the widths whose head split no
// lane count of the fast geometries (csr_attention.cuh, and the bf16
// entries' 16-byte lanes, csr_attention_bf16.cuh) divides into power-of-two
// head partials, such as 48 or 40 columns in 4 heads, 96 in 3, 40 in 8. The
// f32 entries (csr_attention.cu, csr_attention_bwd.cu) and the bf16 ones
// (csr_attention_bf16_words.cu) take it, each with node rows of its element
// type T.
//
// Geometry. A lane owns W consecutive columns of a node row, in memory
// order, loaded as one word: f32, 4 columns (16 bytes) where D % 4 == 0,
// else 2 (8 bytes) where D % 2 == 0, else 1; bf16 (`eight`), 8 columns (16
// bytes) where D % 8 == 0 and every row base is 16-byte aligned, else 4 (8
// bytes; the bf16 entries take D % 4 == 0 and 8-byte aligned rows only). W
// divides D, so every word lies whole in its row. A row takes L lanes,
// D / W rounded up to a power of two and to at least the power of two at
// least H, at most 32: 32 / L rows a warp (make_word_geometry). Lanes past
// the row's last word (idle lanes) load nothing and add zeros. Column c of
// a row is in head c % H (interleaved [Dh, H] rows, the model's layout) or
// c / Dh (blocked [H, Dh] rows). A word is kept as loaded (f32 columns, or
// bf16 bits) until it is used, then widened to f32; all arithmetic is f32,
// and a bf16 output word is rounded once.
//
// Head sums in registers and shuffles (word_heads.cuh, shared with K3's
// word kernel): a lane adds its columns into P per-head partials, ALIGNED
// where the heads of its columns follow from the column index, else a
// select by each column's head; the lanes reduce-scatter them to one head
// a lane and butterfly the rest of the row's lanes. Several dots of an edge
// (the backward's score and <v, g>) go through one reduce-scatter, level by
// level together. No shared memory, no loop over Dh, no barrier.
//
// Softmax state per head. The lane holding a head's sum keeps that head's
// m and l. A window of kEdges edges is taken at once: its scores first (the
// head sums of the window's edges, independent of one another), then the
// window's largest live score per head, one exponential for the rescale
// and one per edge, then each column reads its head's weights from a lane
// holding them by shuffles (one value a partial where ALIGNED, else one a
// column). Nothing in the window branches, so the window's shuffles and
// exponentials overlap; the order of additions is the plain version's
// two-pass softmax's within a window.
//
// A width whose heads outnumber kMaxPartials, or whose words need more than
// 32 lanes (f32: D > 128 with D % 4 == 0, 64 at 2-column words, 32 at
// single columns; bf16: D > 256 on 16-byte words, 128 on 8-byte ones),
// keeps the general geometry of csr_attention.cuh: a choice by shape
// (make_word_geometry, the rule of ops/csr_attention.py word_geometry and
// bf16_word_geometry), taken before the launch.
//
// Edges in flight. A lane group loads the gather indices and mask bytes of
// its row's next L edges in one coalesced load (as the other geometries),
// then issues the k and v words of kEdges (2) edges before it uses the
// first, in the f32 and the bf16 entries (chosen from trial builds on an
// H100).

#pragma once

#include "csr_attention.cuh"
#include "word_heads.cuh"
#include "words.cuh"

namespace attention_words {

using namespace csr_attention;
using namespace word_heads;

constexpr int kEdges = 2;         // edges whose k and v words a lane has in flight: one window

// The kernel instantiation of a word geometry: a key of the cases below.
inline int word_case_key(const WordGeometry& geo) {
  return geo.cols * 256 + geo.partials * 2 + geo.aligned;
}

// The (W, P, ALIGNED) triples a word geometry can give: ALIGNED with P
// dividing W; the select with every P > 1 (an odd width, W = 1, has an odd
// head count: no P = 2). The f32 entries take W in {4, 2, 1}.
#define ATTENTION_WORD_CASES(CASE)                                                                  \
  CASE(1, 1, true) CASE(2, 1, true) CASE(2, 2, true) CASE(4, 1, true) CASE(4, 2, true)              \
  CASE(4, 4, true) CASE(1, 4, false) CASE(1, 8, false) CASE(1, 16, false) CASE(2, 2, false)         \
  CASE(2, 4, false) CASE(2, 8, false) CASE(2, 16, false) CASE(4, 2, false) CASE(4, 4, false)        \
  CASE(4, 8, false) CASE(4, 16, false)

// The bf16 entries' triples: W in {8, 4} (16- and 8-byte words of bf16).
#define ATTENTION_WORD16_CASES(CASE)                                                                \
  CASE(8, 1, true) CASE(8, 2, true) CASE(8, 4, true) CASE(8, 8, true) CASE(8, 2, false)             \
  CASE(8, 4, false) CASE(8, 8, false) CASE(8, 16, false) CASE(4, 1, true) CASE(4, 2, true)          \
  CASE(4, 4, true) CASE(4, 2, false) CASE(4, 4, false) CASE(4, 8, false) CASE(4, 16, false)

// Lane `sub`'s row, its [start, end) edge range clamped to the edge array
// (empty past the last row), its first column, and whether it owns a word.
struct WordSlot {
  int64_t row;
  int64_t start;
  int32_t len;
  int32_t sub;
  int32_t col0;
  int32_t self;  // the row, or 0 past the last row: a row whose words every lane may load
  bool has_row;
  bool live;
};

__device__ __forceinline__ WordSlot word_slot(const WordGeometry& geo, const int32_t* __restrict__ bounds,
                                              int64_t num_rows, int64_t num_edges) {
  WordSlot r;
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  r.row = thread / geo.lanes;
  r.sub = static_cast<int32_t>(thread % geo.lanes);
  r.col0 = r.sub * geo.cols;
  r.live = r.col0 < geo.width;
  r.has_row = r.row < num_rows;
  r.self = r.has_row ? static_cast<int32_t>(r.row) : 0;
  r.start = 0;
  r.len = 0;
  if (r.has_row) {
    int64_t start = bounds[r.row];
    int64_t end = bounds[num_rows + r.row];
    start = start < 0 ? 0 : (start > num_edges ? num_edges : start);
    end = end > num_edges ? num_edges : end;
    r.start = start;
    r.len = end > start ? static_cast<int32_t>(end - start) : 0;
  }
  return r;
}

// The gather index of edge `first + sub` of the row, -1 where that edge is
// past the range or masked (csr_attention.cuh's chunk_index).
__device__ __forceinline__ int32_t word_chunk_index(const int32_t* __restrict__ gather_idx,
                                                    const uint8_t* __restrict__ mask, const WordSlot& r,
                                                    int32_t first) {
  const int32_t t = first + r.sub;
  if (t >= r.len) return -1;
  const int64_t e = r.start + t;
  if (mask != nullptr && !mask[e]) return -1;
  return gather_idx[e];
}

// A lane's word of a node row as loaded: f32 columns, or the raw bits of W
// bf16 columns (widened to f32 where used).
template <typename T, int W>
struct Word {
  float v[W];
};

template <int W>
struct Word<__nv_bfloat16, W> {
  typename WordOf<__nv_bfloat16, W>::type bits;
};

// The lane's W columns of node row j as its word (zeros on an idle lane).
template <typename T, int W>
__device__ __forceinline__ void load_word(const T* __restrict__ base, int32_t j, const WordGeometry& geo,
                                          const WordSlot& r, Word<T, W>& w) {
  if (!r.live) {
    w = Word<T, W>{};
    return;
  }
  const T* p = base + static_cast<int64_t>(j) * geo.width + r.col0;
  if constexpr (sizeof(T) == 4) {
    load_cols<W>(p, w.v);
  } else {
    w.bits = *reinterpret_cast<const typename WordOf<T, W>::type*>(p);
  }
}

// The word's columns as f32.
template <typename T, int W>
__device__ __forceinline__ void widen(const Word<T, W>& w, float (&v)[W]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = w.v[i];
  } else {
    unpack_word<T, W>(w.bits, v);
  }
}

// Stores the lane's W columns of node row n, rounded to T once.
template <typename T, int W>
__device__ __forceinline__ void store_word(T* __restrict__ base, int64_t n, const WordGeometry& geo,
                                           const WordSlot& r, const float (&v)[W]) {
  T* p = base + n * geo.width + r.col0;
  if constexpr (sizeof(T) == 4) {
    store_cols<W>(p, v);
  } else {
    *reinterpret_cast<typename WordOf<T, W>::type*>(p) = pack_word<T, W>(v);
  }
}

// The window's k and v words: the gather indices of slots t0 .. t0 + kEdges - 1
// of the lane group's chunk `mine` (-1 past `count` and where the edge is
// masked or past the range) and their rows' words, every load issued before
// the first is used (a slot without an edge loads the lane's own row, which
// exists, and adds nothing).
template <typename T, int W>
__device__ __forceinline__ void load_window(const T* __restrict__ k, const T* __restrict__ v,
                                            const WordGeometry& geo, const WordSlot& r, int32_t mine,
                                            int32_t t0, int32_t count, int32_t (&j)[kEdges],
                                            Word<T, W> (&kw)[kEdges], Word<T, W> (&vw)[kEdges]) {
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    j[u] = __shfl_sync(kFull, mine, min(t0 + u, geo.lanes - 1), geo.lanes);
    if (t0 + u >= count) j[u] = -1;
    const int32_t row = j[u] < 0 ? r.self : j[u];
    load_word<T, W>(k, row, geo, r, kw[u]);
    load_word<T, W>(v, row, geo, r, vw[u]);
  }
}

// The forward in the word geometry, for node rows of T (f32, or bf16 with
// out rounded to bf16 once; ml f32): W columns a lane as one word, P head
// partials reduce-scattered to one head a lane, which alone keeps that
// head's m and l; a window of kEdges edges at once, without a branch: the
// window's scores, its largest live score a head, one rescale and one
// weight an edge, read back by each column. Each score rounded to bf16
// (STREAM) by the lanes holding its head, and in f32 each value before it
// is weighted (bf16 values are bf16 already).
template <typename T, int W, int P, bool ALIGNED, bool STREAM>
__global__ void __launch_bounds__(kThreads)
csr_attention_words_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           const int32_t* __restrict__ gather_idx, const int32_t* __restrict__ bounds,
                           const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ ml,
                           int64_t num_rows, int64_t num_edges, WordGeometry geo, float scale) {
  using Hd = Heads<W, P, ALIGNED>;
  const WordSlot r = word_slot(geo, bounds, num_rows, num_edges);
  float qr[W];
  {
    Word<T, W> qw;
    load_word<T, W>(q, r.self, geo, r, qw);
    widen<T, W>(qw, qr);
  }
  const Hd h = make_heads<W, P, ALIGNED>(geo, r);
  float m = kNeg, l = 0.0f, acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.0f;

  const int32_t trips = warp_max(r.len);  // uniform across the warp
  for (int32_t first = 0; first < trips; first += geo.lanes) {
    const int32_t mine = word_chunk_index(gather_idx, mask, r, first);
    const int32_t count = min(geo.lanes, trips - first);
    for (int32_t t0 = 0; t0 < count; t0 += kEdges) {
      int32_t j[kEdges];
      Word<T, W> kw[kEdges], vw[kEdges];
      load_window<T, W>(k, v, geo, r, mine, t0, count, j, kw, vw);
      float s[kEdges];
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        float kr[W];
        widen<T, W>(kw[u], kr);
        s[u] = head_sum<W, P, ALIGNED>(geo, r, h, qr, kr) * scale;
        if constexpr (STREAM) s[u] = round_to<__nv_bfloat16>(s[u]);
        m_new = j[u] >= 0 ? fmaxf(m_new, s[u]) : m_new;
      }
      const float alpha = expf(m - m_new);
      float pe[kEdges];
      l *= alpha;
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        pe[u] = j[u] >= 0 ? expf(s[u] - m_new) : 0.0f;
        l += pe[u];
      }
      m = m_new;
      float w[Hd::kValues];
      read_back<W, P, ALIGNED>(geo, h, alpha, w);
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] *= w[value_of<W, P, ALIGNED>(i)];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        float vr[W];
        widen<T, W>(vw[u], vr);
        read_back<W, P, ALIGNED>(geo, h, pe[u], w);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float x = STREAM && sizeof(T) == 4 ? round_to<__nv_bfloat16>(vr[i]) : vr[i];
          acc[i] += w[value_of<W, P, ALIGNED>(i)] * x;
        }
      }
    }
  }
  float ls[Hd::kValues];
  read_back<W, P, ALIGNED>(geo, h, l, ls);
  if (!r.has_row) return;
  if (r.live) {
    float o[W];
#pragma unroll
    for (int i = 0; i < W; ++i) o[i] = acc[i] / (ls[value_of<W, P, ALIGNED>(i)] + kEps);
    store_word<T, W>(out, r.row, geo, r, o);
  }
  if (h.writes) {  // one lane of each head
    ml[h.own * num_rows + r.row] = m;
    ml[(geo.heads + h.own) * num_rows + r.row] = l;
  }
}

template <typename T, int W, int P, bool ALIGNED, bool STREAM>
cudaError_t launch_words_forward(const void* q, const void* k, const void* v, const void* gather_idx,
                                 const void* bounds, const void* mask, void* out, void* ml, long long num_rows,
                                 long long num_edges, const WordGeometry& geo, float scale, cudaStream_t stream) {
  const long long threads = num_rows * geo.lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  csr_attention_words_kernel<T, W, P, ALIGNED, STREAM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(gather_idx), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(ml), num_rows, num_edges,
      geo, scale);
  return cudaGetLastError();
}

}  // namespace attention_words
