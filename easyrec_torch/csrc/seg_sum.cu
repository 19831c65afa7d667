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
// The sum is seg_chunk_sum.cuh's chunk tree, which K3 shares: chunks of
// 256 sorted slots, each summed by one warp as eight strided chains
// combined pairwise, and a long segment's chunk sums added by the same
// tree; segments of at most 8 slots (most ids of a batch) summed by a few
// lanes each, several a warp. Deterministic and free of atomics; the
// plain version (packed_table.seg_sum_plain) runs the same tree, bit for
// bit.
//
// Two launches on one stream, from one call:
//   seg_sum_kernel        grid-stride loops over (a) the windows of 256
//                         sorted slots, summing each long-segment chunk
//                         that starts in one into `partial`; (b) live
//                         segments, tiny ones a lane group each and the
//                         others up to 256 slots a warp each, into `sums`;
//                         (c) every segment index, 32 a warp, for `uids`
//                         and the zero rows of unused segments;
//   seg_sum_finish_kernel each long segment's chunk sums into `sums`.
// So the flagship's 13 hot segments of 4,096 slots are 208 chunks summed
// at once, and no warp walks an unused segment index alone.
//
// EASYREC_GG_BF16 modes (the JAX package's values, packed_table.py:87-110):
//   0 ("0")    f32 payload, f32 sum
//   1 ("1")    payload rounded to bf16, the tree's f32 sum rounded to bf16
//              once at the end. XLA's bf16 segment_sum rounds after every
//              add, so the two differ by at most bf16 rounding of the
//              partial sums.
//   2 ("mix")  payload rounded to bf16, f32 sum
//
// Bound on the H100: memory. Per call it reads n*dim*4 bytes of gradients,
// 2*n*8 + 8 bytes of order and starts and L*8 bytes of sids (the first of
// each of L segments), and writes n*dim*4 + n*8 bytes; the work is one add
// per gradient element. Most segments are a slot or two, so latency
// bounds it instead: a tiny segment is a chain of three dependent loads
// (starts, order, the row), which the lane groups overlap eight (dim 16)
// or four (dim 32) a warp.

#include <cuda_runtime.h>

#include <cstdint>

#include "seg_chunk_sum.cuh"

namespace {

using easyrec::kChunk;
using easyrec::kWarpsPerBlock;

template <int kMode, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
seg_sum_kernel(const int64_t* __restrict__ sids,
               const int64_t* __restrict__ order,
               const int64_t* __restrict__ starts,
               const float* __restrict__ grads, int64_t* __restrict__ uids,
               float* __restrict__ sums, float* __restrict__ partial,
               int64_t n, int dim, int64_t sentinel, int group) {
  constexpr bool kRound = kMode != 0;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // (a) long-segment chunks, by window: level 1 into `partial`
  easyrec::sum_long_chunks<kVec, kRound>(order, starts, grads, partial, n,
                                         dim, warp, warps, lane);
  // (b) live segments, 32 / group a warp: tiny ones by their lane group,
  // the others up to a chunk by the whole warp
  const int gcol = 4 * (lane % group);
  easyrec::for_live_segments(
      starts, n, warp, warps, lane, group,
      [&](int64_t k, int64_t s, int64_t e, bool tiny) {
        if (!tiny) return;
        for (int c = gcol; c < dim; c += 4 * group) {
          float4 v = easyrec::tiny_sum<kVec, kRound>(order, grads, s, e,
                                                     dim, c);
          if (kMode == 1) v = easyrec::round4(v);
          easyrec::store4<kVec>(sums + k * dim, c, dim, v);
        }
      },
      [&](int64_t k, int64_t s, int64_t e) {
        easyrec::warp_sum_into<kVec, kRound, kMode == 1>(
            easyrec::SlotRows{order}, grads, s, e, dim, sums + k * dim,
            lane);
      });
  // (c) uids of every segment index and zero rows of the unused ones
  for (int64_t k0 = warp * 32; k0 < n; k0 += warps * 32) {
    const int64_t k = k0 + lane;
    const int64_t s = k < n ? starts[k] : n;
    if (k < n) uids[k] = s < n ? sids[s] : sentinel;
    unsigned dead = __ballot_sync(easyrec::kFullMask, k < n && s >= n);
    while (dead != 0) {
      const int64_t row = k0 + __ffs(dead) - 1;
      dead &= dead - 1;
      for (int c = lane; c < dim; c += 32) sums[row * dim + c] = 0.f;
    }
  }
}

// Level 2: each long segment's chunk sums, at the warp of the window of
// its first chunk.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
seg_sum_finish_kernel(const int64_t* __restrict__ starts,
                      const float* __restrict__ partial,
                      float* __restrict__ sums, int64_t n, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  easyrec::for_window_items(
      starts, n, warp, warps, lane,
      [&](const easyrec::ChunkItem& it, int64_t) {
    if (it.j != 0) return;
    easyrec::warp_sum_into<kVec, false, kMode == 1>(
        easyrec::ChunkRows{it.s}, partial, 0,
        (it.e - it.s + kChunk - 1) / kChunk, dim, sums + it.k * dim, lane);
  });
}

template <int kMode, bool kVec>
cudaError_t launch(const int64_t* sids, const int64_t* order,
                   const int64_t* starts, const float* grads, int64_t* uids,
                   float* sums, float* partial, int64_t n, int dim,
                   int64_t sentinel, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  seg_sum_kernel<kMode, kVec>
      <<<easyrec::persistent_blocks(n), block, 0, stream>>>(
          sids, order, starts, grads, uids, sums, partial, n, dim, sentinel,
          easyrec::tiny_group(dim));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_sum_finish_kernel<kMode, kVec>
      <<<easyrec::persistent_blocks(easyrec::windows(n)), block, 0,
         stream>>>(starts, partial, sums, n, dim);
  return cudaGetLastError();
}

}  // namespace

// partial: [2 * ceil(n / 256), dim] scratch; vec: rows of grads, partial
// and sums are 16-byte aligned and dim % 4 == 0.
extern "C" int easyrec_seg_sum(const int64_t* sids, const int64_t* order,
                               const int64_t* starts, const float* grads,
                               int64_t* uids, float* sums, float* partial,
                               int64_t n, int dim, int64_t sentinel,
                               int mode, int vec, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (mode * 2 + (vec ? 1 : 0)) {
#define EASYREC_SEG_SUM_CASE(m, v)                                         \
  case m * 2 + v:                                                          \
    err = launch<m, v>(sids, order, starts, grads, uids, sums, partial, n, \
                       dim, sentinel, stream);                             \
    break;
    EASYREC_SEG_SUM_CASE(0, 0)
    EASYREC_SEG_SUM_CASE(0, 1)
    EASYREC_SEG_SUM_CASE(1, 0)
    EASYREC_SEG_SUM_CASE(1, 1)
    EASYREC_SEG_SUM_CASE(2, 0)
    EASYREC_SEG_SUM_CASE(2, 1)
#undef EASYREC_SEG_SUM_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
