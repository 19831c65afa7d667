// K2: in-place row read-modify-write with compact lazy Adam (easyrec_torch).
//
// Replaces the TPU kernel _rmw_pallas (easyrec_tpu/ops/packed_table.py:701,
// pallas_call at :989 pipelined and :1008) with the compact Adam block math
// of sparse_adam().compact_math (easyrec_tpu/optim/sparse.py:186-198).
//
// Table layout: one row per logical row, [rows, 2*dim] f32 holding
// w[0:dim] | mv[0:dim]; each mv element is a bf16 pair bit-packed in a
// float32, m in the top 16 bits and v in the low 16.
//
// One warp per deduplicated slot k, one lane per column (dim 32 is one
// lane each). For slot k with row = uids[k]:
//   1. a sentinel (row outside [0, rows)) is skipped;
//   2. touched = any summed gradient of the row != 0; an untouched row
//      keeps its bytes (the documented zero-sum divergence,
//      packed_table.py:51-56);
//   3. m and v are unpacked, Adam runs with lr, c1 = 1/(1-b1^t) and
//      c2 = 1/(1-b2^t) read from the device tensor `hypers` (no host scalar
//      per step); the weight update uses the pre-rounding f32 moments;
//   4. m and v are repacked with round-to-nearest-even integer rounding.
// Steps 3 and 4 are compact_adam.cuh's, which K3 shares. Dedup makes rows
// unique across slots, so writes never race.
//
// Bound on the H100: memory. For U touched rows it reads and writes
// U * 2*dim*4 bytes (256 B each way at dim 32) and reads the n slots' ids
// and U gradient rows (n*8 + U*dim*4 bytes); the arithmetic is ~20 flops
// per element. Each row is read and written by one warp as whole 128-byte
// lines, so the random row order costs no partial-line traffic.

#include <cuda_runtime.h>

#include <cstdint>

#include "compact_adam.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rmw_adam_kernel(float* __restrict__ table,
                const int64_t* __restrict__ uids,
                const float* __restrict__ gsum,
                const float* __restrict__ hypers,
                int64_t n, int64_t rows, int dim,
                float b1, float omb1, float b2, float omb2, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  const int64_t row = uids[k];
  if (row < 0 || row >= rows) return;            // sentinel slot
  const float* g = gsum + k * dim;
  bool nz = false;
  for (int c = lane; c < dim; c += 32) nz |= (g[c] != 0.f);
  if (!__any_sync(0xffffffffu, nz)) return;      // untouched: keep bytes
  const float lr = hypers[0];
  const float c1 = hypers[1];
  const float c2 = hypers[2];
  float* w = table + row * (2 * static_cast<int64_t>(dim));
  uint32_t* mv = reinterpret_cast<uint32_t*>(w + dim);
  for (int c = lane; c < dim; c += 32)
    easyrec::compact_adam(w + c, mv + c, g[c], lr, c1, c2, b1, omb1, b2,
                          omb2, eps);
}

}  // namespace

extern "C" int easyrec_rmw_adam(float* table, const int64_t* uids,
                                const float* gsum, const float* hypers,
                                int64_t n, int64_t rows, int dim, float b1,
                                float omb1, float b2, float omb2, float eps,
                                cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  rmw_adam_kernel<<<grid, block, 0, stream>>>(
      table, uids, gsum, hypers, n, rows, dim, b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}
