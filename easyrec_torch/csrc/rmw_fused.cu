// K3: fused segmented gradient sum + row read-modify-write with any sparse
// optimizer's block math (easyrec_torch).
//
// Replaces the TPU kernel _rmw_fused_pallas (easyrec_tpu/ops/
// packed_table.py:1024, pallas_call at :1218) with each `math_fn` it takes
// (the block maths of easyrec_tpu/optim/sparse.py:89-251 and the EV aux
// tables' add_math and set_math, easyrec_tpu/features/ev.py:202-206;
// block_math.cuh's functors here): the function of K1 (seg_sum.cu, f32
// mode) followed by K2
// (rmw_rows.cu), with no [n, dim] array of gradient sums in device memory,
// as the TPU kernel keeps its summed gradients out of HBM.
//
// Inputs (ids sorted beforehand by packed_table.sort_segments):
//   table  [rows, P*dim]  P parts [w | s1 | s2] of dim f32 per row (compact
//                         Adam: [w | mv]), updated in place
//   sids   [n]            sorted ids
//   order  [n]            sorted slot -> original slot (row of grads)
//   starts [n+1]          first sorted slot of segment k; n for unused k,
//                         and starts[n] == n
//   grads  [n, dim]       f32 gradients of the pulled rows, slot order
//   hypers [1 or 3]       lr (Adam: and its bias corrections) on the device
//   partial [2 ceil(n/256), dim] scratch for the chunk sums of long
//                         segments
//
// Order of additions: seg_chunk_sum.cuh's chunk tree, the one K1 runs, so
// K3 equals K1 (mode 0) followed by K2 bit for bit at every segment
// length, and its plain version (packed_table.rmw_fused_plain) runs the
// same tree.
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
// Any dim: up to 128 a row's whole sum stays in registers (a tiny segment's
// lane a float4, a warp's eight 16-column passes) until the touched test
// has seen all of it. Above 128 the columns past the first 128 are summed
// twice, once for the test and once for the update, by the same tree, so
// the bits are the same; the JAX package's kernel goes to dim 256 (its
// supported(): 512 lanes of compact Adam), sgd to 512.
//
// Numerics. The gradient sum is f32 with f32 accumulation; the TPU kernel
// splits each f32 term into bf16 hi + lo (about 16 significant bits) for
// its one-hot matmuls, so this is at least as exact. EASYREC_GG_BF16 does
// not apply, as on the TPU's fused path. The math is K2's, the same
// block_math.cuh. A row whose summed gradient is all zero keeps its bytes;
// an unused segment or an id outside [0, rows) is skipped. Ids are unique
// across segments, so row writes never race.
//
// Bound on the H100: memory. One call reads n*dim*4 bytes of gradients,
// 2*n*8 + 8 bytes of order and starts, L*8 bytes of sids (the first sid of
// each of L live segments), and reads and writes U rows of P*dim*4 bytes
// for U touched rows (128 B each way at dim 16, P = 2); the math is 2 to 30
// operations per element. At the Taobao DIN shape (n = 471,040, dim 16,
// L about 98.5k, U about 98k) that is about 30 MB + 8 MB + 0.8 MB + 25 MB
// with compact Adam.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "block_math.cuh"
#include "seg_chunk_sum.cuh"

namespace {

using easyrec::kChunk;
using easyrec::kFullMask;
using easyrec::kPassCols;
using easyrec::kWarpsPerBlock;

constexpr int kMaxPasses = 8;      // passes held in registers: dim 128

// Pass p of a warp's sum for this lane: columns p*16 + 4q.. of the lane's
// column-lane q (the same sum on every slot-lane).
template <bool kVec, typename Rows>
__device__ __forceinline__ float4 pass_sum(Rows rows,
                                           const float* __restrict__ src,
                                           int64_t lo, int64_t hi, int dim,
                                           int p, int lane) {
  return easyrec::tree_pass<kVec, false>(rows, src, lo, hi, dim,
                                         p * kPassCols + 4 * (lane & 3),
                                         lane);
}

// The update of pass p's columns of one row from its sum v: columns
// 16p + 4q + i are component i of lane 4i + q's v.
template <typename M>
__device__ __forceinline__ void update_pass(const M& math, float* row,
                                            int dim, int lane, int p,
                                            const float4& v) {
  const int i = lane >> 2;
  if (i >= 4) return;
  const int c = p * kPassCols + 4 * (lane & 3) + i;
  if (c < dim) easyrec::update_element(math, row, dim, c, easyrec::part(v, i));
}

// One segment's (or chunk list's) sum by the whole warp and its row's
// update: the first kMaxPasses passes stay in registers; passes past them
// (dim > 128) are summed once for the touched test and again for the
// update. Passes past dim are zero.
template <typename M, bool kVec, typename Rows>
__device__ __forceinline__ void warp_update(const M& math, Rows rows_of,
                                            const float* __restrict__ src,
                                            int64_t lo, int64_t hi,
                                            float* __restrict__ table,
                                            int64_t row, int64_t rows,
                                            int dim, int lane) {
  if (row < 0 || row >= rows) return;             // outside the table
  float4 g[kMaxPasses];
  bool nz = false;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    g[p] = p * kPassCols < dim
               ? pass_sum<kVec>(rows_of, src, lo, hi, dim, p, lane)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    nz |= easyrec::nonzero4(g[p]);
  }
  for (int p = kMaxPasses; p * kPassCols < dim; ++p)
    nz |= easyrec::nonzero4(pass_sum<kVec>(rows_of, src, lo, hi, dim, p,
                                           lane));
  if (!__any_sync(kFullMask, nz)) return;         // untouched: keep bytes
  float* r = table + row * (static_cast<int64_t>(M::kParts) * dim);
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) update_pass(math, r, dim, lane, p, g[p]);
  for (int p = kMaxPasses; p * kPassCols < dim; ++p)
    update_pass(math, r, dim, lane, p,
                pass_sum<kVec>(rows_of, src, lo, hi, dim, p, lane));
}

template <typename M, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_sum_kernel(float* __restrict__ table,
                 const int64_t* __restrict__ sids,
                 const int64_t* __restrict__ order,
                 const int64_t* __restrict__ starts,
                 const float* __restrict__ grads,
                 const float* __restrict__ hypers,
                 float* __restrict__ partial, easyrec::Consts consts,
                 int64_t n, int64_t rows, int dim, int group) {
  const M math(hypers, consts);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // (a) long-segment chunks, by window: level 1 into `partial`
  easyrec::sum_long_chunks<kVec, false>(order, starts, grads, partial, n,
                                        dim, warp, warps, lane);
  // (b) live segments, 32 / group a warp: a tiny one summed and updated by
  // its lane group (group * 4 >= dim up to dim 128, so each lane has one
  // float4 of columns; above, blocks of 128 columns summed twice), the
  // others up to a chunk by the whole warp
  const int gcol = 4 * (lane % group);
  const int stride = 4 * group;
  const unsigned gmask = group == 32
                             ? kFullMask
                             : ((1u << group) - 1u) << (lane / group * group);
  const int64_t width = static_cast<int64_t>(M::kParts) * dim;
  easyrec::for_live_segments(
      starts, n, warp, warps, lane, group,
      [&](int64_t, int64_t s, int64_t e, bool tiny) {
        const int64_t row = tiny ? sids[s] : -1;
        const float4 v =
            tiny ? easyrec::tiny_sum<kVec, false>(order, grads, s, e, dim,
                                                  gcol)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        bool mine = easyrec::nonzero4(v);
        for (int c = gcol + stride; c < dim; c += stride)
          mine |= tiny && easyrec::nonzero4(easyrec::tiny_sum<kVec, false>(
                              order, grads, s, e, dim, c));
        // a row is touched where any lane of its group has a nonzero sum
        const unsigned nz = __ballot_sync(kFullMask, mine);
        if (!tiny || (nz & gmask) == 0 || row < 0 || row >= rows) return;
        float* r = table + row * width;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gcol + i < dim)
            easyrec::update_element(math, r, dim, gcol + i,
                                    easyrec::part(v, i));
        for (int c = gcol + stride; c < dim; c += stride) {
          const float4 w = easyrec::tiny_sum<kVec, false>(order, grads, s, e,
                                                          dim, c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c + i < dim)
              easyrec::update_element(math, r, dim, c + i,
                                      easyrec::part(w, i));
        }
      },
      [&](int64_t, int64_t s, int64_t e) {
        warp_update<M, kVec>(math, easyrec::SlotRows{order}, grads, s, e,
                             table, sids[s], rows, dim, lane);
      });
}

// Level 2 and the update of each long segment, at the warp of the window
// of its first chunk.
template <typename M, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_finish_kernel(float* __restrict__ table,
                    const int64_t* __restrict__ sids,
                    const int64_t* __restrict__ starts,
                    const float* __restrict__ hypers,
                    const float* __restrict__ partial,
                    easyrec::Consts consts, int64_t n, int64_t rows,
                    int dim) {
  const M math(hypers, consts);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  easyrec::for_window_items(
      starts, n, warp, warps, lane,
      [&](const easyrec::ChunkItem& it, int64_t) {
    if (it.j != 0) return;
    warp_update<M, kVec>(math, easyrec::ChunkRows{it.s}, partial, 0,
                         (it.e - it.s + kChunk - 1) / kChunk, table,
                         sids[it.s], rows, dim, lane);
  });
}

template <typename M, bool kVec>
cudaError_t launch(float* table, const int64_t* sids, const int64_t* order,
                   const int64_t* starts, const float* grads,
                   const float* hypers, float* partial,
                   const easyrec::Consts& consts, int64_t n, int64_t rows,
                   int dim, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  fused_sum_kernel<M, kVec><<<easyrec::persistent_blocks(n), block, 0,
                              stream>>>(
      table, sids, order, starts, grads, hypers, partial, consts, n, rows,
      dim, easyrec::tiny_group(dim));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_finish_kernel<M, kVec>
      <<<easyrec::persistent_blocks(easyrec::windows(n)), block, 0,
         stream>>>(table, sids, starts, hypers, partial, consts, n, rows,
                   dim);
  return cudaGetLastError();
}

}  // namespace

// math: a block_math.cuh MathId; consts: host float[kMaxConsts] of the
// math's constants; partial: [2 * ceil(n / 256), dim] scratch; vec: rows
// of grads and partial are 16-byte aligned and dim % 4 == 0.
extern "C" int easyrec_rmw_fused(int math, float* table, const int64_t* sids,
                                 const int64_t* order, const int64_t* starts,
                                 const float* grads, const float* hypers,
                                 float* partial, const float* consts,
                                 int64_t n, int64_t rows, int dim, int vec,
                                 cudaStream_t stream) {
  if (dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  easyrec::Consts k;
  std::memcpy(k.c, consts, sizeof(k.c));
  cudaError_t err = cudaErrorInvalidValue;
  easyrec::dispatch_math(math, [&](auto tag) {
    using M = typename decltype(tag)::type;
    err = vec ? launch<M, true>(table, sids, order, starts, grads, hypers,
                                partial, k, n, rows, dim, stream)
              : launch<M, false>(table, sids, order, starts, grads, hypers,
                                 partial, k, n, rows, dim, stream);
  });
  return static_cast<int>(err);
}
