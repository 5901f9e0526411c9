// Segment sum over a receiver-sorted edge list, for Hopper (sm_90a).
//
//   out[n, :] = sum of data[e, :] over the real edges e of node n
//
// Replaces the Pallas TPU kernel `_csr_segment_sum_fwd_impl` / `_kernel` in
// graphphysics_tpu/ops/pallas_segment.py, which GraphNetBlock's "add"
// aggregation runs in the port. The TPU kernel reduced 512-edge chunks with
// a one-hot matmul on the matrix unit and padded lanes to 128; both were
// TPU workarounds and are not carried over.
//
// Bound: memory. Each edge row is read once and added once, so the work is
// E*H f32 additions against E*H*4 bytes of data: far below the card's
// operations-per-byte balance. With E the real edges (those inside the row
// ranges; trailing padding is never read), the bytes that must move are
//   E*H*4 (data) + 8*N (row bounds) + E (edge mask) + N*H*4 (out),
// the counterpart of the TPU kernel's E*H*4 + E*4 (receivers) + N*H*4.
//
// Design. The host sorts edges by receiver and hands over each node's
// [start, end) range of real edges (graphphysics_torch/ops/csr_segment.py),
// so every output row belongs to exactly one warp or lane group: no
// atomics, each row is written once, and the sum runs in a fixed order
// (deterministic). Edges whose mask byte is 0 add nothing; rows with no
// edges store 0. Time follows the row gathers a warp has in flight, not
// the bytes, so every entry takes a geometry chosen before the launch by
// width and alignment (the rule of ops/csr_segment.py
// segment_sum_geometry):
// - 16-byte words, where H is a multiple of a word's columns (4 f32, 8
//   bf16 or f16) and data and out are 16-byte aligned: a lane owns the
//   columns of one word, read as one 16-byte load; a row takes L = H / 4
//   (f32) or H / 8 (16-bit) lanes, rounded up to a power of two, at most
//   32 (a column block of 128 f32 or 256 16-bit columns a lane group past
//   that), so a warp serves 32 / L rows: one at H = 128 in f32, two at
//   H = 64 (16-bit: two at 128, four at 64). A lane walks its row's edges
//   in windows of kEdgeGroup: it starts the window's mask-byte and word
//   loads together (a masked edge's word is read and not added), then
//   adds the live words in edge order. So each column's f32 sum is the
//   same sequence of additions as one edge at a time, and the outputs are
//   bit-equal to the one-column-a-lane geometry's (the build has no
//   fast-math, so nothing reorders the additions). A warp at H = 128 keeps
//   8 words of 16 bytes a lane (4 KB) in flight where one edge at a time
//   kept one 128-byte line.
// - single columns otherwise (f32 widths that are not a multiple of 4,
//   views only 4- or 8-byte aligned): a warp covers 32 consecutive columns
//   of one row, one edge at a time, its lanes reading 32 neighbouring
//   elements (one 128-byte line in f32), the first design. The
//   16-bit entries have a third geometry between the two, below.
// TMA staging and balancing long rows across warps are not tried.
//
// 16-bit data (entries csr_segment_sum_bf16, csr_segment_sum_f16). The
// TPU kernel meant to take bf16 or f16 data as it is: it pads the data in
// its own dtype, sums into an f32 buffer and casts the rows back
// (pallas_segment.py:161, :189-193), the function of the JAX
// masked_segment_sum on 16-bit input (sum in f32, round once). Each element
// is widened to f32 as it is read, the sum stays in an f32 register, and
// the row is rounded once (to nearest even) to the data's dtype when it is
// stored. A sum in 16 bits would be wrong, not slower: 4,096 ones summed in
// bf16 stop at 256. The bytes are the f32 entry's with 2 bytes an element:
// E*H*2 + 8*N + E + N*H*2. Their geometries: the 16-byte words above,
// where H % 8 == 0 and the arrays 16-byte aligned; else 4-byte
// pairs, where H is even and both arrays 4-byte aligned: the single-column
// kernel on the element type, a lane taking two adjacent columns in one
// 4-byte load (a warp reads one 128-byte line of an edge row), one edge at
// a time; else single columns (odd widths, 2-byte aligned views). All
// three give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "words.cuh"

namespace {

constexpr int kLanes = 32;        // lanes (column groups) per warp
constexpr int kRowsPerBlock = 8;  // warps (rows) per block
constexpr int kWordCols = 8;      // 16-bit columns in a 16-byte word
constexpr int kF32WordCols = 4;   // f32 columns in a 16-byte word
constexpr int kEdgeGroup = 8;     // edges whose words a lane has in flight (16-byte geometry)
constexpr int kWordWarps = 8;     // warps per block (16-byte geometry)

// the columns of element type T in a 16-byte word
template <typename T>
__host__ __device__ constexpr int word_cols() {
  return sizeof(T) == 4 ? kF32WordCols : kWordCols;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// x rounded once, to nearest even, to the element type T
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f32(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The C (1, or 2 for a 16-bit pair in one 4-byte word) columns at p, as f32.
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float (&x)[C]) {
  if constexpr (C == 2) {
    const float2 f = pair_f32(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = to_f32(p[0]);
  }
}

template <typename T, int C>
__device__ __forceinline__ void store_cols(T* __restrict__ p, const float (&x)[C]) {
  if constexpr (C == 2) {
    store_pair(p, x[0], x[1]);
  } else {
    p[0] = from_f32<T>(x[0]);
  }
}

// Lane threadIdx.x of warp threadIdx.y sums columns [col, col + C) of one
// row in f32 and stores them rounded to T once.
template <typename T, int C>
__global__ void csr_segment_sum_kernel(const T* __restrict__ data,
                                       const int32_t* __restrict__ bounds,
                                       const uint8_t* __restrict__ mask,
                                       T* __restrict__ out,
                                       int64_t num_rows, int64_t num_edges,
                                       int32_t width) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * kLanes + threadIdx.x) * C;
  if (row >= num_rows || col >= width) return;
  // bounds is [2, num_rows]: starts, then ends; clamp to the edge array
  int64_t start = bounds[row];
  int64_t end = bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > num_edges ? num_edges : end;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int64_t e = start; e < end; ++e) {
    if (mask == nullptr || mask[e]) {
      float x[C];
      load_cols<T, C>(data + e * width + col, x);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += x[c];
    }
  }
  store_cols<T, C>(out + row * width + col, acc);
}

// The 16-bit pair in the bits b (the lower address in the low half), as
// f32; and two f32 values rounded once, to nearest even, to such a pair.
template <typename T>
__device__ __forceinline__ float2 bits_f32(uint32_t b);
template <>
__device__ __forceinline__ float2 bits_f32<__nv_bfloat16>(uint32_t b) {
  __nv_bfloat162 h;
  memcpy(&h, &b, sizeof(h));
  return __bfloat1622float2(h);
}
template <>
__device__ __forceinline__ float2 bits_f32<__half>(uint32_t b) {
  __half2 h;
  memcpy(&h, &b, sizeof(h));
  return __half22float2(h);
}

template <typename T>
__device__ __forceinline__ uint32_t pair_bits(float a, float b);
template <>
__device__ __forceinline__ uint32_t pair_bits<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t bits;
  memcpy(&bits, &h, sizeof(bits));
  return bits;
}
template <>
__device__ __forceinline__ uint32_t pair_bits<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  uint32_t bits;
  memcpy(&bits, &h, sizeof(bits));
  return bits;
}

// adds the columns of the word w (4 f32, unpacked as K2's f32 words are:
// words.cuh; or 8 16-bit ones widened to f32) to acc
template <typename T>
__device__ __forceinline__ void add_word(const uint4& w, float (&acc)[word_cols<T>()]) {
  if constexpr (sizeof(T) == 4) {
    float v[kF32WordCols];
    unpack_word<float, kF32WordCols>(w, v);
#pragma unroll
    for (int i = 0; i < kF32WordCols; ++i) acc[i] += v[i];
  } else {
    const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bits_f32<T>(bits[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
}

// the f32 sums acc as one 16-byte word of T (16-bit: rounded once, to
// nearest even)
template <typename T>
__device__ __forceinline__ uint4 word_of(const float (&acc)[word_cols<T>()]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                      __float_as_uint(acc[3]));
  } else {
    return make_uint4(pair_bits<T>(acc[0], acc[1]), pair_bits<T>(acc[2], acc[3]),
                      pair_bits<T>(acc[4], acc[5]), pair_bits<T>(acc[6], acc[7]));
  }
}

// The 16-byte geometry: lane sub of row slot `slot` (lanes a row, 32 /
// lanes slots a warp) sums the C = word_cols<T>() columns [col, col + C)
// of its row in f32, a window of kEdgeGroup edges' words in flight, and
// stores them (rounded to T once). blockIdx.y is the 32-word column block
// of rows wider than 32 words.
template <typename T>
__global__ void csr_segment_sum_words(const T* __restrict__ data, const int32_t* __restrict__ bounds,
                                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                                      int64_t num_rows, int64_t num_edges, int32_t width, int lanes) {
  constexpr int C = word_cols<T>();
  const int slot = threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWordWarps + threadIdx.y) * (kLanes / lanes) + slot;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * kLanes + sub) * C;
  if (row >= num_rows || col >= width) return;  // no lane waits on another
  int64_t start = bounds[row];
  int64_t end = bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > num_edges ? num_edges : end;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int64_t e0 = start; e0 < end; e0 += kEdgeGroup) {
    uint4 w[kEdgeGroup];
    bool live[kEdgeGroup];
#pragma unroll
    for (int u = 0; u < kEdgeGroup; ++u) {
      const int64_t e = e0 + u;
      live[u] = false;
      w[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < end) {
        live[u] = mask == nullptr || mask[e] != 0;
        w[u] = *reinterpret_cast<const uint4*>(data + e * width + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kEdgeGroup; ++u) {
      if (live[u]) add_word<T>(w[u], acc);  // edge order: one edge at a time's additions
    }
  }
  *reinterpret_cast<uint4*>(out + row * width + col) = word_of<T>(acc);
}

// Backward of the segment sum (K1b):
//
//   ddata[e, :] = g[recv[e], :]   for an unmasked edge e inside its
//                                 receiver's range [bounds[0, r], bounds[1, r])
//   ddata[e, :] = 0               for every other edge (masked, padding)
//
// Replaces the backward of the TPU kernel's custom VJP, `_bwd` in
// graphphysics_tpu/ops/pallas_segment.py, an XLA gather `jnp.take(g,
// receivers)` that gathers for every edge and leaves masked edges to the
// caller, who zeroes their data upstream. The forward above skips masked
// edges and edges outside the ranges, so their gradient is exactly 0 here.
//
// Bound: memory. No arithmetic; the bytes that must move are
//   E_pad*H*4 (ddata written) + E_pad*(4 + 1) (receivers, mask byte)
//   + N*(H*4 + 8) (each node's g row and bounds, read once)
// (2 bytes an element in place of 4 for the 16-bit entries)
// with E_pad every edge, padding included: each one is written.
//
// Design. Edge-parallel, so each edge row, padding included, is written by
// exactly one group of threads and no zero pass is needed: in a
// concatenated batch a graph's padded edges sit between its real edges and
// the next graph's, and a walk over the row ranges would miss them. A
// thread moves one word W of one edge row: 16 bytes (4 f32 or 8 16-bit
// columns) when the width allows it and both rows are 16-byte aligned, one
// column otherwise. The 16-bit entries (csr_segment_sum_bwd_bf16, _f16)
// copy g's bits as they are, since the gradient of a sum is a gather: JAX's
// `jnp.take(g, receivers)` in g's dtype. Neighbouring threads take
// neighbouring words, so a warp at H = 128 in f32 reads one g row and
// writes one ddata row, each 512 contiguous bytes (two rows in 16 bits).
// Consecutive receiver-sorted edges mostly share a receiver, so the g rows
// come from L2 after their first read.

template <typename W>
__global__ void csr_segment_sum_bwd_kernel(const W* __restrict__ g,
                                           const int32_t* __restrict__ recv,
                                           const int32_t* __restrict__ bounds,
                                           const uint8_t* __restrict__ mask,
                                           W* __restrict__ ddata,
                                           int64_t num_rows, int64_t num_edges,
                                           int64_t words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_edges * words) return;
  const int64_t e = i / words;  // ddata[i] is word i - e * words of edge row e
  const int64_t r = recv[e];
  bool live = (mask == nullptr || mask[e]) && r >= 0 && r < num_rows;
  if (live) live = bounds[r] <= e && e < bounds[num_rows + r];
  W v{};  // zero bits: 0.0 in every element type
  if (live) v = g[r * words + (i - e * words)];
  ddata[i] = v;
}

constexpr int kBwdThreads = 256;

// The lanes a row takes in the 16-byte geometry (H / C rounded up to a
// power of two, at most 32, with C a word's columns), or 0 where it does
// not take the width or the arrays' alignment (the rule of
// ops/csr_segment.py segment_sum_geometry).
int word_lanes(int width, int cols, const void* data, const void* out) {
  if (width <= 0 || width % cols != 0 || reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return 0;
  }
  int lanes = 1;
  while (lanes < kLanes && lanes * cols < width) lanes *= 2;
  return lanes;
}

template <typename T>
int forward(const void* data, const void* bounds, const void* mask, void* out,
            long long num_rows, long long num_edges, int width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const T*>(data);
  const auto* bp = static_cast<const int32_t*>(bounds);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<T*>(out);
  constexpr int cols = word_cols<T>();
  const int lanes = word_lanes(width, cols, data, out);
  if (lanes > 0) {
    const long long rows = static_cast<long long>(kWordWarps) * (kLanes / lanes);  // a block
    const int words = width / cols;
    const dim3 grid(static_cast<unsigned>((num_rows + rows - 1) / rows),
                    static_cast<unsigned>((words + kLanes - 1) / kLanes));
    csr_segment_sum_words<T><<<grid, dim3(kLanes, kWordWarps), 0, s>>>(dp, bp, mp, op, num_rows, num_edges,
                                                                      width, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  const bool pairs = sizeof(T) == 2 && width % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(data) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int cover = pairs ? 2 * kLanes : kLanes;  // columns a warp covers
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>((width + cover - 1) / cover));
  if constexpr (sizeof(T) == 2) {
    if (pairs) {
      csr_segment_sum_kernel<T, 2><<<grid, block, 0, s>>>(dp, bp, mp, op, num_rows, num_edges, width);
      return static_cast<int>(cudaGetLastError());
    }
  }
  csr_segment_sum_kernel<T, 1><<<grid, block, 0, s>>>(dp, bp, mp, op, num_rows, num_edges, width);
  return static_cast<int>(cudaGetLastError());
}

// The gather, `words` words W an edge row.
template <typename W>
int gather(const void* g, const void* recv, const void* bounds, const void* mask, void* ddata,
           long long num_rows, long long num_edges, long long words, void* stream) {
  const long long threads = num_edges * words;
  const dim3 grid(static_cast<unsigned>((threads + kBwdThreads - 1) / kBwdThreads));
  csr_segment_sum_bwd_kernel<W><<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(g), static_cast<const int32_t*>(recv),
      static_cast<const int32_t*>(bounds), static_cast<const uint8_t*>(mask),
      static_cast<W*>(ddata), num_rows, num_edges, words);
  return static_cast<int>(cudaGetLastError());
}

// One 16-byte word a thread where the width fills whole words and both
// arrays are 16-byte aligned, else one column (`Scalar`) a thread.
template <typename Scalar, typename Word>
int backward(const void* g, const void* recv, const void* bounds, const void* mask, void* ddata,
             long long num_rows, long long num_edges, int width, void* stream) {
  if (num_edges <= 0 || width <= 0) return 0;
  constexpr int per = sizeof(Word) / sizeof(Scalar);  // columns a word
  const bool vec = width % per == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ddata) % 16 == 0;
  if (vec) return gather<Word>(g, recv, bounds, mask, ddata, num_rows, num_edges, width / per, stream);
  return gather<Scalar>(g, recv, bounds, mask, ddata, num_rows, num_edges, width, stream);
}

}  // namespace

// data [E, H], bounds [2, N] int32, mask [E] bool (or null), out [N, H] in
// data's element type (f32, bf16 or f16 by the entry); all device pointers,
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int csr_segment_sum_f32(const void* data, const void* bounds, const void* mask,
                                   void* out, long long num_rows, long long num_edges, int width,
                                   void* stream) {
  return forward<float>(data, bounds, mask, out, num_rows, num_edges, width, stream);
}

extern "C" int csr_segment_sum_bf16(const void* data, const void* bounds, const void* mask,
                                    void* out, long long num_rows, long long num_edges, int width,
                                    void* stream) {
  return forward<__nv_bfloat16>(data, bounds, mask, out, num_rows, num_edges, width, stream);
}

extern "C" int csr_segment_sum_f16(const void* data, const void* bounds, const void* mask,
                                   void* out, long long num_rows, long long num_edges, int width,
                                   void* stream) {
  return forward<__half>(data, bounds, mask, out, num_rows, num_edges, width, stream);
}

// g [N, H], recv [E] int32, bounds [2, N] int32, mask [E] bool (or null),
// ddata [E, H] in g's element type (f32, bf16 or f16 by the entry); all
// device pointers, contiguous. Writes every row of ddata. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_segment_sum_bwd_f32(const void* g, const void* recv, const void* bounds,
                                       const void* mask, void* ddata, long long num_rows,
                                       long long num_edges, int width, void* stream) {
  return backward<float, float4>(g, recv, bounds, mask, ddata, num_rows, num_edges, width, stream);
}

extern "C" int csr_segment_sum_bwd_bf16(const void* g, const void* recv, const void* bounds,
                                        const void* mask, void* ddata, long long num_rows,
                                        long long num_edges, int width, void* stream) {
  return backward<uint16_t, uint4>(g, recv, bounds, mask, ddata, num_rows, num_edges, width, stream);
}

extern "C" int csr_segment_sum_bwd_f16(const void* g, const void* recv, const void* bounds,
                                       const void* mask, void* ddata, long long num_rows,
                                       long long num_edges, int width, void* stream) {
  return backward<uint16_t, uint4>(g, recv, bounds, mask, ddata, num_rows, num_edges, width, stream);
}
