// The word geometry's head sums, shared by the fused attention's word
// kernels (attention_words.cuh: csr_attention.cu, csr_attention_bwd.cu,
// csr_attention_bf16_words.cu) and K3's word kernel (csr_softmax_spmm_bwd.cu).
//
// A row of D columns in H heads takes L lanes, each owning W consecutive
// columns as one word (W divides D, so no word is cut by the row's end);
// lanes past the row's last word are idle and add zeros. Column c is in
// head c % H (interleaved [Dh, H] rows) or c / Dh (blocked [H, Dh] rows).
// A lane keeps P partial sums and adds each column's product into one of
// them in column order:
// - ALIGNED, where the heads of a lane's columns follow from the column
//   index: interleaved rows with H dividing W (P = H, column i in partial
//   i), interleaved rows with H / W a power of two (P = W; lanes whose index
//   differs in a bit below lo = H / W hold other heads), blocked rows with
//   Dh / W a power of two (P = 1; a head's Dh / W lanes an aligned group,
//   the xor offsets below hi = Dh / W), or H = 1: column i straight into
//   partial i % P;
// - else a select: P is the power of two at least H (at most
//   kMaxPartials), partial p is head p, and each column's product goes into
//   its head's partial.
// The lanes then reduce-scatter the P partials over the xor offsets lo,
// 2 lo, ..., lo P / 2 (at offset o a lane keeps the half its bit o selects
// and adds its partner's copy of it) and butterfly the one partial left over
// the offsets lo P, ..., up to hi (L where no blocked group bounds it). Every
// lane ends with the sum of one head, its owned partial (the bit reversal
// of its bits lo .. lo P / 2); every lane holding a head holds the same
// bits. Several dots go through one reduce-scatter, level by level together
// (head_sums). No shared memory, no loop over Dh, no barrier. Each value a
// head's lane computes goes back to the columns of that head by shuffles
// (read_back): one value a partial where ALIGNED, else one a column.
//
// Every shuffle names the whole warp: every lane of the warp, idle lanes
// and the rows past the last included, must reach each of them.
//
// A row slot type `Slot` has `sub` (the lane's index in its row) and `col0`
// (its first column, sub * W).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace word_heads {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPartials = 16;  // the most head partials a lane keeps
constexpr int kMaxLanes = 32;     // a row's lanes lie in one warp

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
// entries' host asks for it (csr_attention_bf16_words.cu), or K2's and K3's
// hosts (blocked_word_geometry).
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

// The largest power of two, at most 16, that divides every address: the
// byte alignment the word loads are chosen by.
inline int alignment_of(std::initializer_list<const void*> arrays) {
  int found = 16;
  for (const void* p : arrays) {
    while (reinterpret_cast<uintptr_t>(p) % found != 0) found /= 2;
  }
  return found;
}

// The word geometry of head-blocked f32 rows whose arrays are `aligned`
// bytes aligned: 16-byte words of 4 columns where D % 4 == 0 and the
// arrays are 16-byte aligned, the lanes its words and heads need; false
// elsewhere and where it has none (past 32 lanes or kMaxPartials heads).
// K2's f32 entry and K3 take it (the rule of ops/csr_attention.py
// softmax_spmm_words); 8- and 4-byte words ran no faster than the general
// geometry on an H100 (chip_compare.py --k2).
inline bool blocked_word_geometry(int width, int heads, int aligned, WordGeometry* geo) {
  if (width <= 0 || heads <= 0 || width % 4 != 0 || aligned % 16 != 0) return false;
  const int need = pow2_at_least(width / 4);
  const int select = pow2_at_least(heads);
  return make_word_geometry(width, heads, 0, need < select ? select : need, geo);
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
template <typename Slot>
__device__ __forceinline__ int word_head(const WordGeometry& geo, const Slot& r, int i) {
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

template <int W, int P, bool ALIGNED, typename Slot>
__device__ __forceinline__ Heads<W, P, ALIGNED> make_heads(const WordGeometry& geo, const Slot& r) {
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
template <int N, int W, int P, bool ALIGNED, typename Slot>
__device__ __forceinline__ void head_sums(const WordGeometry& geo, const Slot& r,
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
template <int W, int P, bool ALIGNED, typename Slot>
__device__ __forceinline__ float head_sum(const WordGeometry& geo, const Slot& r,
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

}  // namespace word_heads
