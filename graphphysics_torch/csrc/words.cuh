// Words of the kernels' word geometries: W adjacent columns of element type
// T read as one load, and their columns as f32. bf16: W = 8 (a 16-byte
// word) or 4 (an 8-byte word), each column widened to f32 (the bf16 stream
// entries of K2, csr_softmax_spmm.cu, and K5, csr_softmax_spmm_pair.cu).
// f32: W = 4 (a 16-byte word), the columns as they are (K1's f32 entry,
// csr_segment_sum.cu, and K2's f32 entry).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

template <typename T, int W>
struct WordOf;
template <>
struct WordOf<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct WordOf<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct WordOf<float, 4> {
  using type = uint4;
};

// the W f32 columns v as a word of T, each rounded to T once (to nearest
// even)
template <typename T, int W>
__device__ __forceinline__ typename WordOf<T, W>::type pack_word(const float (&v)[W]) {
  typename WordOf<T, W>::type w;
  uint32_t bits[sizeof(w) / 4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < W; ++i) bits[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      memcpy(&bits[i], &h, sizeof(h));
    }
  }
  memcpy(&w, bits, sizeof(w));
  return w;
}

// the W columns of T in the word w, as f32
template <typename T, int W>
__device__ __forceinline__ void unpack_word(const typename WordOf<T, W>::type& w, float (&v)[W]) {
  static_assert(sizeof(w) == sizeof(T) * W, "a word holds W columns of T");
  uint32_t bits[sizeof(w) / 4];
  memcpy(bits, &w, sizeof(bits));
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __uint_as_float(bits[i]);
  } else {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &bits[i], sizeof(h));
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}
