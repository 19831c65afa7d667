// K3: fused segmented gradient sum + row read-modify-write with compact
// lazy Adam (easyrec_torch).
//
// Replaces the TPU kernel _rmw_fused_pallas (easyrec_tpu/ops/
// packed_table.py:1024, pallas_call at :1218): the function of K1
// (seg_sum.cu, f32 mode) followed by K2 (rmw_adam.cu), with no [n, dim]
// array of gradient sums in device memory, as the TPU kernel keeps its
// summed gradients out of HBM.
//
// Inputs (ids sorted beforehand by packed_table.sort_segments):
//   table  [rows, 2*dim]  w[0:dim] | mv[0:dim] per row, updated in place;
//                         each mv element packs bf16 m (top 16 bits) and
//                         bf16 v (low 16 bits)
//   sids   [n]            sorted ids
//   order  [n]            sorted slot -> original slot (row of grads)
//   starts [n+1]          first sorted slot of segment k; n for unused k,
//                         and starts[n] == n
//   grads  [n, dim]       f32 gradients of the pulled rows, slot order
//   hypers [3]            lr, 1/(1-b1^t), 1/(1-b2^t) on the device
//   partial [2 ceil(n/256), dim] scratch for the chunk sums of long
//                         segments
//
// Order of additions: seg_chunk_sum.cuh's chunk tree, the one K1 runs, so
// K3 equals K1 (mode 0) followed by K2 bit for bit at every segment
// length, and its plain version (packed_table.rmw_fused_adam_plain) runs
// the same tree.
//
// Two launches on one stream, from one call:
//   fused_sum_kernel     grid-stride loops over (a) the windows of 256
//                        sorted slots, summing each long-segment chunk that
//                        starts in one into `partial` (level 1); (b) live
//                        segments: a tiny one (at most 8 slots, most ids of
//                        a batch) is summed and its row updated by a group
//                        of dim / 4 lanes, several a warp; one of up to 256
//                        slots by a whole warp;
//   fused_finish_kernel  each long segment's chunk sums (level 2) and its
//                        row's update, once.
// No warp walks an unused segment index alone: the grid is at most eight
// blocks an SM, and the live-segment loop stops at the unused tail.
//
// Numerics. The gradient sum is f32 with f32 accumulation; the TPU kernel
// splits each f32 term into bf16 hi + lo (about 16 significant bits) for
// its one-hot matmuls, so this is at least as exact. EASYREC_GG_BF16 does
// not apply, as on the TPU's fused path. Adam is K2's, the same
// compact_adam.cuh. A row whose summed gradient is all zero keeps its
// bytes; an unused segment or an id outside [0, rows) is skipped. Ids are
// unique across segments, so row writes never race.
//
// Bound on the H100: memory. One call reads n*dim*4 bytes of gradients,
// 2*n*8 + 8 bytes of order and starts, L*8 bytes of sids (the first sid of
// each of L live segments), and reads and writes U rows of 2*dim*4 bytes
// for U touched rows (128 B each way at dim 16); the Adam math is ~13
// operations per element. At the Taobao DIN shape (n = 471,040, dim 16,
// L about 98.5k, U about 98k) that is about 30 MB + 8 MB + 0.8 MB + 25 MB.

#include <cuda_runtime.h>

#include <cstdint>

#include "compact_adam.cuh"
#include "seg_chunk_sum.cuh"

namespace {

using easyrec::kChunk;
using easyrec::kFullMask;
using easyrec::kPassCols;
using easyrec::kWarpsPerBlock;

constexpr int kMaxPasses = 8;      // dim <= 128

// K2's update of one row from its summed gradient g (warp-wide): pass p's
// columns 16p + 4q + i are component i of lane 4i + q's g[p].
__device__ __forceinline__ void adam_row(float* __restrict__ table,
                                         int64_t row, int64_t rows, int dim,
                                         int lane,
                                         const float4 (&g)[kMaxPasses],
                                         const float* __restrict__ hypers,
                                         float b1, float omb1, float b2,
                                         float omb2, float eps) {
  if (row < 0 || row >= rows) return;              // outside the table
  bool nz = false;                                 // columns >= dim are 0
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) nz |= easyrec::nonzero4(g[p]);
  if (!__any_sync(kFullMask, nz)) return;          // untouched: keep bytes
  const int i = lane >> 2;
  if (i >= 4) return;
  const float lr = hypers[0];
  const float c1 = hypers[1];
  const float c2 = hypers[2];
  float* w = table + row * (2 * static_cast<int64_t>(dim));
  uint32_t* mv = reinterpret_cast<uint32_t*>(w + dim);
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int c = p * kPassCols + 4 * (lane & 3) + i;
    if (c < dim)
      easyrec::compact_adam(w + c, mv + c, easyrec::part(g[p], i), lr, c1,
                            c2, b1, omb1, b2, omb2, eps);
  }
}

// The passes of one segment's sum by the whole warp (short segments and
// level 2); passes past dim are zero. Unlike K1's warp_sum_into, which
// stores each pass, all passes stay in registers: a row whose whole sum
// is zero keeps its bytes, and that is known only after the last pass.
template <bool kVec, typename Rows>
__device__ __forceinline__ void warp_sum(Rows rows,
                                         const float* __restrict__ src,
                                         int64_t lo, int64_t hi, int dim,
                                         int lane, float4 (&g)[kMaxPasses]) {
  const int col = 4 * (lane & 3);
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p)
    g[p] = p * kPassCols < dim
               ? easyrec::tree_pass<kVec, false>(rows, src, lo, hi, dim,
                                                 p * kPassCols + col, lane)
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_sum_kernel(float* __restrict__ table,
                 const int64_t* __restrict__ sids,
                 const int64_t* __restrict__ order,
                 const int64_t* __restrict__ starts,
                 const float* __restrict__ grads,
                 const float* __restrict__ hypers,
                 float* __restrict__ partial,
                 int64_t n, int64_t rows, int dim, int group,
                 float b1, float omb1, float b2, float omb2, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // (a) long-segment chunks, by window: level 1 into `partial`
  easyrec::sum_long_chunks<kVec, false>(order, starts, grads, partial, n,
                                        dim, warp, warps, lane);
  // (b) live segments, 32 / group a warp: a tiny one summed and updated by
  // its lane group (group * 4 >= dim, so each lane has one float4 of
  // columns), the others up to a chunk by the whole warp
  const int gcol = 4 * (lane % group);
  const unsigned gmask = group == 32
                             ? kFullMask
                             : ((1u << group) - 1u) << (lane / group * group);
  const float lr = hypers[0];
  const float c1 = hypers[1];
  const float c2 = hypers[2];
  easyrec::for_live_segments(
      starts, n, warp, warps, lane, group,
      [&](int64_t, int64_t s, int64_t e, bool tiny) {
        const int64_t row = tiny ? sids[s] : -1;
        const float4 v =
            tiny ? easyrec::tiny_sum<kVec, false>(order, grads, s, e, dim,
                                                  gcol)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        // a row is touched where any lane of its group has a nonzero sum
        const unsigned nz = __ballot_sync(kFullMask, easyrec::nonzero4(v));
        if (!tiny || (nz & gmask) == 0 || row < 0 || row >= rows) return;
        float* w = table + row * (2 * static_cast<int64_t>(dim));
        uint32_t* mv = reinterpret_cast<uint32_t*>(w + dim);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gcol + i < dim)
            easyrec::compact_adam(w + gcol + i, mv + gcol + i,
                                  easyrec::part(v, i), lr, c1, c2, b1, omb1,
                                  b2, omb2, eps);
      },
      [&](int64_t, int64_t s, int64_t e) {
        float4 gs[kMaxPasses];
        warp_sum<kVec>(easyrec::SlotRows{order}, grads, s, e, dim, lane, gs);
        adam_row(table, sids[s], rows, dim, lane, gs, hypers, b1, omb1, b2,
                 omb2, eps);
      });
}

// Level 2 and the update of each long segment, at the warp of the window
// of its first chunk.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_finish_kernel(float* __restrict__ table,
                    const int64_t* __restrict__ sids,
                    const int64_t* __restrict__ starts,
                    const float* __restrict__ hypers,
                    const float* __restrict__ partial,
                    int64_t n, int64_t rows, int dim,
                    float b1, float omb1, float b2, float omb2, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  easyrec::for_window_items(
      starts, n, warp, warps, lane,
      [&](const easyrec::ChunkItem& it, int64_t) {
    if (it.j != 0) return;
    float4 gs[kMaxPasses];
    warp_sum<kVec>(easyrec::ChunkRows{it.s}, partial, 0,
                   (it.e - it.s + kChunk - 1) / kChunk, dim, lane, gs);
    adam_row(table, sids[it.s], rows, dim, lane, gs, hypers, b1, omb1, b2,
             omb2, eps);
  });
}

template <bool kVec>
cudaError_t launch(float* table, const int64_t* sids, const int64_t* order,
                   const int64_t* starts, const float* grads,
                   const float* hypers, float* partial, int64_t n,
                   int64_t rows, int dim, float b1, float omb1, float b2,
                   float omb2, float eps, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  fused_sum_kernel<kVec><<<easyrec::persistent_blocks(n), block, 0,
                           stream>>>(
      table, sids, order, starts, grads, hypers, partial, n, rows, dim,
      easyrec::tiny_group(dim), b1, omb1, b2, omb2, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_finish_kernel<kVec>
      <<<easyrec::persistent_blocks(easyrec::windows(n)), block, 0,
         stream>>>(table, sids, starts, hypers, partial, n, rows, dim, b1,
                   omb1, b2, omb2, eps);
  return cudaGetLastError();
}

}  // namespace

// partial: [2 * ceil(n / 256), dim] scratch; vec: rows of grads and
// partial are 16-byte aligned and dim % 4 == 0.
extern "C" int easyrec_rmw_fused_adam(
    float* table, const int64_t* sids, const int64_t* order,
    const int64_t* starts, const float* grads, const float* hypers,
    float* partial, int64_t n, int64_t rows, int dim, float b1, float omb1,
    float b2, float omb2, float eps, int vec, cudaStream_t stream) {
  if (dim <= 0 || dim > kPassCols * kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      vec ? launch<true>(table, sids, order, starts, grads, hypers, partial,
                         n, rows, dim, b1, omb1, b2, omb2, eps, stream)
          : launch<false>(table, sids, order, starts, grads, hypers,
                          partial, n, rows, dim, b1, omb1, b2, omb2, eps,
                          stream);
  return static_cast<int>(err);
}
