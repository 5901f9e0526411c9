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
// so every output row belongs to exactly one warp: no atomics, each row is
// written once, and the sum runs in a fixed order (deterministic). A warp
// covers 32 consecutive columns of one row; for each edge of the row its
// lanes read 32 neighbouring floats (one 128-byte line), accumulate in an f32
// register, and store once. Edges whose mask byte is 0 add nothing; rows
// with no edges store 0. What this simple version leaves for later:
// 16-byte vector loads, TMA staging, and balancing long rows across warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;        // columns per warp
constexpr int kRowsPerBlock = 8;  // warps (rows) per block

__global__ void csr_segment_sum_kernel(const float* __restrict__ data,
                                       const int32_t* __restrict__ bounds,
                                       const uint8_t* __restrict__ mask,
                                       float* __restrict__ out,
                                       int64_t num_rows, int64_t num_edges,
                                       int32_t width) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kLanes + threadIdx.x;
  if (row >= num_rows || col >= width) return;
  // bounds is [2, num_rows]: starts, then ends; clamp to the edge array
  int64_t start = bounds[row];
  int64_t end = bounds[num_rows + row];
  start = start < 0 ? 0 : start;
  end = end > num_edges ? num_edges : end;
  float acc = 0.0f;
  for (int64_t e = start; e < end; ++e) {
    if (mask == nullptr || mask[e]) acc += data[e * width + col];
  }
  out[row * width + col] = acc;
}

}  // namespace

// data [E, H] f32, bounds [2, N] int32, mask [E] bool (or null), out [N, H]
// f32; all device pointers, contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int csr_segment_sum_f32(const void* data, const void* bounds,
                                   const void* mask, void* out,
                                   long long num_rows, long long num_edges,
                                   int width, void* stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>((width + kLanes - 1) / kLanes));
  csr_segment_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(bounds),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), num_rows,
      num_edges, width);
  return static_cast<int>(cudaGetLastError());
}
