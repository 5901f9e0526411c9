// Device code shared by the fused CSR attention's bf16 forward
// (csr_attention_bf16.cu) and backward (csr_attention_bwd_bf16.cu): the
// 16-byte lane geometry, node rows kept as raw bf16 words until used, and
// per-head sums by reduce-scatter. The row slots, index chunks and the
// general geometry are csr_attention.cuh's.
//
// The 16-byte geometry. A row of width D (D % 8 == 0, every row base
// 16-byte aligned) is served by G = D / V lanes with V = 8 (or 16 where
// D / 8 > 32) consecutive bf16 columns each, loaded as one (two) 16-byte
// words: at D = 128 16 lanes a row, two rows a warp; at D = 64 8 lanes,
// four rows. G is 4, 8, 16 or 32. Heads split over the lanes as in
// csr_attention.cuh's fast geometries (blocked: one head a lane, a head's
// Dh / V lanes an aligned group; interleaved: NP = min(V, H) heads a lane,
// partial p holding the columns i % NP == p), with the xor offsets of a
// head's lanes in [lo, hi).
//
// Head sums by reduce-scatter. A dot's NP partials are not butterflied one
// by one over the head's lanes (NP log2(hi / lo) shuffles, every lane ending
// with every head). The first RS = min(log2 NP, log2(hi / lo)) levels halve
// them: at offset o = lo << j a lane keeps the half of its partials that its
// bit o selects and adds its partner's copy of that half (NP / 2^(j+1)
// shuffles); the remaining levels butterfly the NPR = NP >> RS partials
// left. At D = 128 with H = 4 in the interleaved layout that is 2 + 1 + 1 +
// 1 = 5 shuffles a dot in place of 16, and each lane ends with one head: it
// computes that head's exponentials alone (one a head, not one a lane and
// head) and spreads the weights back by the inverse all-gather (NP - NPR
// shuffles). A head's sum leaves the same bits in every lane that holds it.

#pragma once

#include "csr_attention.cuh"

namespace csr_attention16 {

using namespace csr_attention;

constexpr unsigned kFull = 0xffffffffu;

// Edges whose rows a lane has in flight at once (the forward's and part
// A's k and v, part B's q and g): every load of a group is issued before
// the first is used. 2 in the general geometry. More take registers, and
// with them resident warps, from the latency they hide: the backward's
// parts, which hold more per edge, take 2, the forward 4 (chosen from
// trial builds on an H100).
constexpr int kForwardGroup = 4;
constexpr int kRowsGroup = 2;
constexpr int kGatherGroup = 2;

template <bool GEN>
__host__ __device__ constexpr int group_edges(int fast) {
  return GEN ? 2 : fast;
}

__device__ __forceinline__ void unpack8(const uint4& w, float* v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.z));
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.w));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
  v[4] = c.x;
  v[5] = c.y;
  v[6] = d.x;
  v[7] = d.y;
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 w;
  *reinterpret_cast<__nv_bfloat162*>(&w.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&w.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<__nv_bfloat162*>(&w.z) = __floats2bfloat162_rn(v[4], v[5]);
  *reinterpret_cast<__nv_bfloat162*>(&w.w) = __floats2bfloat162_rn(v[6], v[7]);
  return w;
}

// A lane's V columns of one node row: raw 16-byte words (the 16-byte
// geometry, converted to f32 where used) or f32 columns (the general one).
template <int V, bool GEN>
struct RowBuf {
  uint4 w[V / 8];
};

template <int V>
struct RowBuf<V, true> {
  float f[V];
};

// Node row j's columns of this lane, zeros for j < 0 (no edge).
template <int V, bool GEN>
__device__ __forceinline__ void fetch(const __nv_bfloat16* __restrict__ base, int32_t j,
                                      const Geometry& geo, const RowSlot& r, RowBuf<V, GEN>& b) {
  if constexpr (GEN) {
    load_row<V, true>(base, j, geo, r, b.f);
  } else {
    if (j < 0) {
#pragma unroll
      for (int i = 0; i < V / 8; ++i) b.w[i] = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    const uint4* p = reinterpret_cast<const uint4*>(base + static_cast<int64_t>(j) * geo.width + r.col0);
#pragma unroll
    for (int i = 0; i < V / 8; ++i) b.w[i] = p[i];
  }
}

template <int V, bool GEN>
__device__ __forceinline__ void unpack(const RowBuf<V, GEN>& b, float (&v)[V]) {
  if constexpr (GEN) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = b.f[i];
  } else {
#pragma unroll
    for (int i = 0; i < V / 8; ++i) unpack8(b.w[i], v + 8 * i);
  }
}

// Stores the lane's columns of node row n, each rounded to bf16 once.
template <int V, bool GEN>
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ base, int64_t n, const Geometry& geo,
                                      const RowSlot& r, const float (&v)[V]) {
  if constexpr (GEN) {
    store_row<V, true>(base, n, geo, r, v);
  } else {
    uint4* p = reinterpret_cast<uint4*>(base + n * geo.width + r.col0);
#pragma unroll
    for (int i = 0; i < V / 8; ++i) p[i] = pack8(v + 8 * i);
  }
}

// The first partial of the NPR a lane holds after the reduce-scatter: bit
// lo << j of the lane kept the upper half at level j.
template <int NP, int RS>
__device__ __forceinline__ int partial_base(const Geometry& geo, int sub) {
  int base = 0;
#pragma unroll
  for (int j = 0; j < RS; ++j) {
    if (sub & (geo.lo << j)) base += NP >> (j + 1);
  }
  return base;
}

// Whether the lane writes the per-head values of its partials: the 16-byte
// geometry's lanes whose bits in [lo << RS, hi) are 0 (one of each head's
// copies); the general geometry's lane holding the head's first column.
template <int V, int RS, bool GEN>
__device__ __forceinline__ bool writes(const Geometry& geo, const RowSlot& r, int p) {
  if constexpr (GEN) {
    return writes_head<V, true>(geo, r, p);
  } else {
    return (r.sub & (geo.hi - 1) & ~((geo.lo << RS) - 1)) == 0;
  }
}

// Per-head sums of a[i] * b[i]: out[i] is the sum over the head of partial
// partial_base + i of the row's columns. The 16-byte geometry: partials,
// reduce-scatter, butterfly (see the note above). The general geometry:
// csr_attention.cuh's head_dots through the row's shared memory (NP = V,
// RS = 0). Every lane of the warp must call it.
template <int V, int NP, int RS, bool GEN>
__device__ __forceinline__ void head_sums(const Geometry& geo, const RowSlot& r, const float (&a)[V],
                                          const float (&b)[V], float (&out)[NP >> RS], float* scratch) {
  if constexpr (GEN) {
    static_assert(RS == 0, "the general geometry sums each head through shared memory");
    head_dots<V, NP, true>(geo, r, a, b, out, scratch);
  } else {
    float cur[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) cur[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i % NP] += a[i] * b[i];
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const int offset = geo.lo << j;
      const bool upper = (r.sub & offset) != 0;
      constexpr int kMax = NP / 2;
      const int half = NP >> (j + 1);
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        if (i < half) {
          const float send = upper ? cur[i] : cur[i + half];
          const float keep = upper ? cur[i + half] : cur[i];
          cur[i] = keep + __shfl_xor_sync(kFull, send, offset);
        }
      }
    }
    constexpr int NPR = NP >> RS;
    for (int offset = geo.lo << RS; offset < geo.hi; offset <<= 1) {
#pragma unroll
      for (int i = 0; i < NPR; ++i) cur[i] += __shfl_xor_sync(kFull, cur[i], offset);
    }
#pragma unroll
    for (int i = 0; i < NPR; ++i) out[i] = cur[i];
  }
}

// The inverse of the reduce-scatter: every lane gets the values of all its
// NP partials from the lanes that hold them (identity for RS = 0). Every
// lane of the warp must call it.
template <int NP, int RS>
__device__ __forceinline__ void head_spread(const Geometry& geo, int sub, const float (&red)[NP >> RS],
                                            float (&full)[NP]) {
  float cur[NP];
#pragma unroll
  for (int i = 0; i < (NP >> RS); ++i) cur[i] = red[i];
#pragma unroll
  for (int j = RS - 1; j >= 0; --j) {
    const int offset = geo.lo << j;
    const bool upper = (sub & offset) != 0;
    constexpr int kMax = NP / 2;
    const int half = NP >> (j + 1);  // the values held before this level
#pragma unroll
    for (int i = kMax - 1; i >= 0; --i) {
      if (i < half) {
        const float mine = cur[i];
        const float other = __shfl_xor_sync(kFull, mine, offset);
        cur[i] = upper ? other : mine;
        cur[i + half] = upper ? mine : other;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) full[i] = cur[i];
}

// Validates a geometry on the host; false for one the kernels do not take.
// general == 0: the 16-byte geometry (V = D / lanes in {8, 16}, lanes in
// {4, 8, 16, 32}, a power-of-two head split); general == 1: the general
// geometry of csr_attention.cuh (lanes in {8, 16, 32}, D <= 16 lanes).
inline bool make_geometry16(int lanes, int width, int heads, int interleaved, int general, Geometry* geo) {
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  if (heads <= 0 || width <= 0 || width % heads) return false;
  const int dh = width / heads;
  geo->lanes = lanes;
  geo->width = width;
  geo->heads = heads;
  geo->head_dim = dh;
  geo->interleaved = interleaved;
  geo->general = general ? 1 : 0;
  geo->lo = 1;
  geo->hi = 1;
  if (general) {
    return (lanes == 8 || lanes == 16 || lanes == 32) && (width + lanes - 1) / lanes <= 16;
  }
  if (!(lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32) || width % lanes) return false;
  const int v = width / lanes;
  if (v != 8 && v != 16) return false;
  if (!interleaved) {
    if (dh % v || !pow2(dh / v)) return false;
    geo->hi = dh / v;
  } else if (v % heads == 0) {
    if (!pow2(heads)) return false;
    geo->hi = lanes;
  } else if (heads % v == 0) {
    if (!pow2(heads / v) || heads / v > lanes) return false;
    geo->lo = heads / v;
    geo->hi = lanes;
  } else {
    return false;
  }
  return true;
}

// RS of a valid 16-byte geometry with NP partials: min(log2 NP, log2(hi / lo)).
inline int scatter_levels(const Geometry& geo, int np) {
  int rs = 0;
  while ((1 << (rs + 1)) <= np && (geo.lo << (rs + 1)) <= geo.hi) ++rs;
  return rs;
}

// The kernel instantiation of a valid geometry: a key of the cases below.
inline int case_key16(const Geometry& geo) {
  const int v = columns(geo);
  const int np = partials(geo);
  return geo.general ? 1024 + v : v * 256 + np * 8 + scatter_levels(geo, np);
}

// The (V, NP, RS) triples of the 16-byte geometry, then the general
// geometry's V in 1..16 (NP = V, RS = 0).
#define CSR_ATTENTION16_CASES(CASE)                                                          \
  CASE(8, 1, 0) CASE(8, 2, 0) CASE(8, 2, 1) CASE(8, 4, 0) CASE(8, 4, 1) CASE(8, 4, 2)         \
  CASE(8, 8, 0) CASE(8, 8, 1) CASE(8, 8, 2) CASE(8, 8, 3) CASE(16, 1, 0) CASE(16, 2, 0)       \
  CASE(16, 2, 1) CASE(16, 4, 0) CASE(16, 4, 1) CASE(16, 4, 2) CASE(16, 8, 0) CASE(16, 8, 1)   \
  CASE(16, 8, 2) CASE(16, 8, 3) CASE(16, 16, 0) CASE(16, 16, 1) CASE(16, 16, 2)               \
  CASE(16, 16, 3) CASE(16, 16, 4)

}  // namespace csr_attention16
