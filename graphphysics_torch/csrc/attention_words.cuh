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
// Head sums in registers and shuffles. A lane keeps P partial sums and adds
// each column's product into one of them in column order:
// - ALIGNED, where the heads of a lane's columns follow from the column
//   index as in the fast geometries: interleaved rows with H dividing W
//   (P = H, column i in partial i), interleaved rows with H / W a power of
//   two (P = W; lanes whose index differs in a bit below lo = H / W hold
//   other heads), blocked rows with Dh / W a power of two (P = 1; a head's
//   Dh / W lanes an aligned group, the xor offsets below hi = Dh / W), or
//   H = 1: column i straight into partial i % P;
// - else a select: P is the power of two at least H (at most
//   kMaxPartials), partial p is head p, and each column's product goes into
//   its head's partial.
// The lanes then reduce-scatter the P partials over the xor offsets lo,
// 2 lo, ..., lo P / 2 (at offset o a lane keeps the half its bit o selects
// and adds its partner's copy of it) and butterfly the one partial left over
// the offsets lo P, ..., up to hi (L where no blocked group bounds it). Every
// lane ends with the sum of one head, its owned partial (the bit reversal
// of its bits lo .. lo P / 2); every lane holding a head holds the same
// bits. Several dots of an edge (the backward's score and <v, g>) go
// through one reduce-scatter, level by level together (head_sums). No
// shared memory, no loop over Dh, no barrier.
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
#include "words.cuh"

namespace attention_words {

using namespace csr_attention;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPartials = 16;  // the most head partials a lane keeps
constexpr int kMaxLanes = 32;     // a row's lanes lie in one warp
constexpr int kEdges = 2;         // edges whose k and v words a lane has in flight: one window

struct WordGeometry {
  int32_t lanes;        // L, lanes a row
  int32_t width;        // D
  int32_t heads;        // H
  int32_t head_dim;     // Dh
  int32_t interleaved;  // 1: [Dh, H] rows, 0: [H, Dh] rows
  int32_t cols;         // W, columns a lane: one word
  int32_t partials;     // P, head partials a lane
  int32_t aligned;      // 1: column i in partial i % P; 0: the select
  int32_t lo, hi;       // xor offsets of a head's reduction: lo, 2 lo, ... < hi
};

__host__ __device__ constexpr int log2_of(int x) { return x > 1 ? 1 + log2_of(x >> 1) : 0; }

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The word geometry of a width, head count and layout with `lanes` lanes a
// row; false where it has none (H not dividing D, more than kMaxPartials
// heads, more than kMaxLanes lanes) or another lane count. `eight`: 8-column
// words where D % 8 == 0 (16 bytes of bf16 in 16-byte aligned rows). The
// launch takes it where the fast geometry does not take the lane count it
// is given (csr_attention.cu, csr_attention_bwd.cu), or where the bf16
// entries' host asks for it (csr_attention_bf16_words.cu).
inline bool make_word_geometry(int width, int heads, int interleaved, int lanes, WordGeometry* geo,
                               bool eight = false) {
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  if (width <= 0 || heads <= 0 || width % heads) return false;
  const int cols = eight && width % 8 == 0 ? 8 : (width % 4 == 0 ? 4 : (width % 2 == 0 ? 2 : 1));
  const int head_dim = width / heads;
  const int select = pow2_at_least(heads);
  const int need = pow2_at_least(width / cols);
  if (select > kMaxPartials || (need < select ? select : need) != lanes || lanes > kMaxLanes) return false;
  geo->lanes = lanes;
  geo->width = width;
  geo->heads = heads;
  geo->head_dim = head_dim;
  geo->interleaved = interleaved;
  geo->cols = cols;
  geo->aligned = 1;
  geo->lo = 1;
  geo->hi = lanes;
  if (heads == 1) {
    geo->partials = 1;
  } else if (interleaved && cols % heads == 0) {
    geo->partials = heads;
  } else if (interleaved && heads % cols == 0 && pow2(heads / cols)) {
    geo->partials = cols;
    geo->lo = heads / cols;
  } else if (!interleaved && head_dim % cols == 0 && pow2(head_dim / cols)) {
    geo->partials = 1;
    geo->hi = head_dim / cols;
  } else {
    geo->partials = select;
    geo->aligned = 0;
  }
  return true;
}

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

// The owned partial of a lane with index `sub`: its bits lo << j, j <
// log2(P), are the choices of the reduce-scatter's levels (bit reversal).
template <int P>
__device__ __forceinline__ int owned_partial(const WordGeometry& geo, int sub) {
  int p = 0;
#pragma unroll
  for (int j = 0, half = P >> 1; half > 0; ++j, half >>= 1) {
    if (sub & (geo.lo << j)) p += half;
  }
  return p;
}

// The lane of the row, nearest this one, that owns partial p: this lane's
// index with its reduce-scatter bits set to p's.
template <int P>
__device__ __forceinline__ int owner_of(const WordGeometry& geo, int sub, int p) {
  int lane = sub & ~(geo.lo * P - geo.lo);
#pragma unroll
  for (int j = 0, half = P >> 1; half > 0; ++j, half >>= 1) {
    if (p & half) lane |= geo.lo << j;
  }
  return lane;
}

// The head of the lane's column i (an idle column: head 0).
__device__ __forceinline__ int word_head(const WordGeometry& geo, const WordSlot& r, int i) {
  const int c = r.col0 + i;
  if (c >= geo.width) return 0;
  return geo.interleaved ? c % geo.heads : c / geo.head_dim;
}

// The lane's view of the row's heads: each column's head (the select's
// partial), the lanes each column's weights are read from, the head of the
// lane's owned partial (H or more for a padding partial or an idle blocked
// lane) and whether the lane writes that head's statistics (one lane a
// head).
template <int W, int P, bool ALIGNED>
struct Heads {
  static constexpr int kValues = ALIGNED ? P : W;  // values read back a quantity
  int column[W];
  int src[kValues];
  int own;
  bool writes;
};

template <int W, int P, bool ALIGNED>
__device__ __forceinline__ Heads<W, P, ALIGNED> make_heads(const WordGeometry& geo, const WordSlot& r) {
  Heads<W, P, ALIGNED> h;
#pragma unroll
  for (int i = 0; i < W; ++i) h.column[i] = word_head(geo, r, i);
#pragma unroll
  for (int g = 0; g < Heads<W, P, ALIGNED>::kValues; ++g) {
    h.src[g] = owner_of<P>(geo, r.sub, ALIGNED ? g : h.column[g]);
  }
  const int own = owned_partial<P>(geo, r.sub);
  if constexpr (ALIGNED) {
    h.own = geo.interleaved ? (r.col0 + own) % geo.heads : r.col0 / geo.head_dim;
  } else {
    h.own = own;
  }
  h.writes = (r.sub & (geo.hi - 1) & ~(geo.lo * P - 1)) == 0 && h.own < geo.heads;
  return h;
}

// x of the lanes holding each value's head (every lane of the warp must
// call it).
template <int W, int P, bool ALIGNED>
__device__ __forceinline__ void read_back(const WordGeometry& geo, const Heads<W, P, ALIGNED>& h, float x,
                                          float (&out)[Heads<W, P, ALIGNED>::kValues]) {
#pragma unroll
  for (int g = 0; g < Heads<W, P, ALIGNED>::kValues; ++g) out[g] = __shfl_sync(kFull, x, h.src[g], geo.lanes);
}

// The index into read_back()'s values of the lane's column i.
template <int W, int P, bool ALIGNED>
__device__ __forceinline__ constexpr int value_of(int i) {
  return ALIGNED ? i % P : i;
}

// For each of N dots, the sum over the row of the lane's owned head of
// a[n][i] * b[n][i]: the lane's partials in column order, one reduce-scatter
// over the offsets lo .. lo P / 2 for the N dots together, the butterfly
// over lo P .. hi / 2 (see the note above). A padding partial (P > H) sums
// to 0. Every lane of the warp must call it.
template <int N, int W, int P, bool ALIGNED>
__device__ __forceinline__ void head_sums(const WordGeometry& geo, const WordSlot& r,
                                          const Heads<W, P, ALIGNED>& h, const float (&a)[N][W],
                                          const float (&b)[N][W], float (&sum)[N]) {
  float part[N][P];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int p = 0; p < P; ++p) part[n][p] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float x = a[n][i] * b[n][i];
      if constexpr (ALIGNED) {
        part[n][i % P] += x;
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) part[n][p] += h.column[i] == p ? x : 0.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < log2_of(P); ++j) {
    const int offset = geo.lo << j;
    const bool upper = (r.sub & offset) != 0;
    const int half = P >> (j + 1);
#pragma unroll
    for (int i = 0; i < P / 2; ++i) {
      if (i < half) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float send = upper ? part[n][i] : part[n][i + half];
          const float keep = upper ? part[n][i + half] : part[n][i];
          part[n][i] = keep + __shfl_xor_sync(kFull, send, offset);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) sum[n] = part[n][0];
  for (int offset = geo.lo * P; offset < geo.hi; offset <<= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) sum[n] += __shfl_xor_sync(kFull, sum[n], offset);
  }
}

// The sum over the row of the lane's owned head of a[i] * b[i] (head_sums
// of one dot).
template <int W, int P, bool ALIGNED>
__device__ __forceinline__ float head_sum(const WordGeometry& geo, const WordSlot& r,
                                          const Heads<W, P, ALIGNED>& h, const float (&a)[W],
                                          const float (&b)[W]) {
  float x[1][W], y[1][W], sum[1];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[0][i] = a[i];
    y[0][i] = b[i];
  }
  head_sums<1, W, P, ALIGNED>(geo, r, h, x, y, sum);
  return sum[0];
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
