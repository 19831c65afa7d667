// K1: segmented gradient sum of the sparse embedding update (easyrec_torch).
//
// Replaces the TPU kernel _seg_sum_pallas (easyrec_tpu/ops/packed_table.py:
// 301, pallas_call at :470) and the segment-sum step of group_prep
// (:559-623): duplicate ids of a batch sum their pulled-row gradients so
// the optimizer sees each touched row once.
//
// Inputs (ids sorted beforehand by torch.sort, outside this kernel):
//   sids   [n]     sorted ids
//   order  [n]     sorted slot -> original slot (row of grads)
//   starts [n+1]   first sorted slot of segment k; n for unused k, and
//                  starts[n] == n, so segment k spans [starts[k], starts[k+1])
//   grads  [n,dim] f32 gradients of the pulled rows, in original order
// Outputs:
//   uids   [n]     id of segment k, `sentinel` for unused k (a tail)
//   sums   [n,dim] summed gradient of segment k, zero rows for unused k
//
// One warp per segment, one lane per column: the warp walks its segment's
// slots in sorted order, so the sum is deterministic and needs no atomics.
// Segment slots are read 32 at a time (one coalesced load of `order`,
// broadcast by shuffle) and the row loads of a group are independent, so
// several are in flight per lane.
//
// EASYREC_GG_BF16 modes (the JAX package's values, packed_table.py:87-110):
//   0 ("0")    f32 payload, f32 sum
//   1 ("1")    payload rounded to bf16, f32 register sum rounded to bf16 once
//              at the end. XLA's bf16 segment_sum rounds after every add, so
//              the two differ by at most bf16 rounding of the partial sums.
//   2 ("mix")  payload rounded to bf16, f32 sum
//
// Bound on the H100: memory. Per call it reads n*dim*4 bytes of gradients,
// 2*n*8 + 8 bytes of order and starts and L*8 bytes of sids (the first of
// each of L segments), and writes n*dim*4 + n*8 bytes; the work is
// one add per gradient element. Rows are 128-byte lines at dim 32, so every
// gradient load is one full line. A segment of many duplicates (a hot id)
// is walked by one warp alone: that serial walk, not bandwidth, bounds a
// batch whose ids repeat thousands of times.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float bf16_round(float x) {
  // round-to-nearest-even to bf16, kept in an f32 (packed_table.py
  // _np_bf16_bits)
  uint32_t u = __float_as_uint(x);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(u);
}

template <int kMode>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
seg_sum_kernel(const int64_t* __restrict__ sids,
               const int64_t* __restrict__ order,
               const int64_t* __restrict__ starts,
               const float* __restrict__ grads,
               int64_t* __restrict__ uids,
               float* __restrict__ sums,
               int64_t n, int dim, int64_t sentinel) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  const int64_t s = starts[k];
  const int64_t e = starts[k + 1];
  if (lane == 0) uids[k] = s < n ? sids[s] : sentinel;
  float* out = sums + k * dim;
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int64_t j0 = s; j0 < e; j0 += 32) {
      const int64_t cnt = e - j0 < 32 ? e - j0 : 32;
      const int64_t mine = lane < cnt ? order[j0 + lane] : 0;
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) {
        const int64_t r = __shfl_sync(0xffffffffu, mine, i);
        if (c < dim) {
          float g = grads[r * dim + c];
          if (kMode != 0) g = bf16_round(g);
          acc = __fadd_rn(acc, g);
        }
      }
    }
    if (kMode == 1) acc = bf16_round(acc);
    if (c < dim) out[c] = acc;
  }
}

}  // namespace

extern "C" int easyrec_seg_sum(const int64_t* sids, const int64_t* order,
                               const int64_t* starts, const float* grads,
                               int64_t* uids, float* sums, int64_t n,
                               int dim, int64_t sentinel, int mode,
                               cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  switch (mode) {
    case 0:
      seg_sum_kernel<0><<<grid, block, 0, stream>>>(
          sids, order, starts, grads, uids, sums, n, dim, sentinel);
      break;
    case 1:
      seg_sum_kernel<1><<<grid, block, 0, stream>>>(
          sids, order, starts, grads, uids, sums, n, dim, sentinel);
      break;
    case 2:
      seg_sum_kernel<2><<<grid, block, 0, stream>>>(
          sids, order, starts, grads, uids, sums, n, dim, sentinel);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
