// bf16 words of the stream entries' word geometries (csr_softmax_spmm.cu,
// K2; csr_softmax_spmm_pair.cu, K5): W = 8 (a 16-byte word) or 4 (an
// 8-byte word) adjacent bf16 columns, read as one load, and their columns
// widened to f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

template <int W>
struct WordOf;
template <>
struct WordOf<8> {
  using type = uint4;
};
template <>
struct WordOf<4> {
  using type = uint2;
};

// the W bf16 columns of a word (W / 2 pairs), as f32
template <typename Word, int W>
__device__ __forceinline__ void unpack_word(const Word& w, float (&v)[W]) {
  static_assert(sizeof(Word) == 2 * W, "a word holds W bf16 columns");
  uint32_t bits[W / 2];
  memcpy(bits, &w, sizeof(bits));
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &bits[i], sizeof(h));
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
