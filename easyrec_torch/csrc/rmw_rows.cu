// K2: in-place row read-modify-write with any sparse optimizer's block math
// (easyrec_torch).
//
// Replaces the TPU kernel _rmw_pallas (easyrec_tpu/ops/packed_table.py:701,
// pallas_call at :989 pipelined and :1008) with each `math_fn` it takes:
// the block_math of sparse_sgd, sparse_momentum, sparse_adagrad,
// sparse_adam (3-part, and compact_math) and sparse_ftrl
// (easyrec_tpu/optim/sparse.py:89-251), and the EV aux tables' add_math
// and set_math (easyrec_tpu/features/ev.py:202-206, on [rows, 1] tables:
// a lane group of one lane, scalar loads), here the functors of
// block_math.cuh.
//
// Inputs:
//   table  [rows, P*dim]  one row per logical row, P parts [w | s1 | s2]
//                         of dim f32 each (compact Adam: [w | mv], mv the
//                         bf16 pair of m and v), updated in place
//   uids   [n]            the row of slot k; a slot whose id lies outside
//                         [0, rows) is skipped (K1's sentinel tail)
//   gsum   [n, dim]       summed gradient of slot k
//   hypers [1 or 3]       lr (Adam: and its bias corrections) on the device
// A row whose summed gradient is all zero keeps its bytes (the JAX
// package's touched mask, packed_table.py:51-56 and _math_and_mask). Rows
// are unique across live slots, so writes never race.
//
// Bound on the H100: memory. For U touched rows of L live slots it reads
// n*8 bytes of ids, L*dim*4 of gradients, and reads and writes U*P*dim*4
// (256 B each way for a flagship row at dim 32, P = 2); the math is 2 to
// 30 operations an element. The rows are random and 128-384 B, so the
// limit in practice is how many row loads are in flight, not bandwidth.
//
// Design (Hopper): a lane group of G lanes takes one row, G the power of
// two >= dim/4 (8 at dim 32, so four rows a warp); lane q of a group holds
// columns 4q..4q+3 of every part, as 16-byte float4 loads where each part
// starts 16-byte aligned (vec), else four scalars. Each group takes kRows
// slots a round of a grid-stride loop over at most eight blocks an SM, and
// loads all its slots' ids, then every gradient and table word of those
// rows, before any math: the chain is id -> {gradient, row}, two loads deep,
// with kRows rows in flight a group. The touched test is a ballot masked to
// the group; the math then runs on every row of the round with no branch
// between rows (a dead row's zeros stay finite), so the rows' dependent
// chains of IEEE divisions and roots interleave, and only touched rows are
// written. Above dim 128 (one float4 a lane no longer covers a row) each
// slot is done alone: the gradient's column blocks are read once for the
// touched test and again with the row for the update. No shared memory, no
// TMA: registers and L2 are the tools for 128-384 B random rows.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "block_math.cuh"
#include "seg_chunk_sum.cuh"

namespace {

using easyrec::kFullMask;
using easyrec::kWarpsPerBlock;

constexpr int kRows = 2;           // slots a lane group takes a round

// Component i < 4 of v set to x.
__device__ __forceinline__ void set_part(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// `math` on four columns c..c+3 of one row: v[p] holds part p's columns,
// g the gradient's; columns at or past dim are left alone.
template <typename M>
__device__ __forceinline__ void update4(const M& math,
                                        float4 (&v)[M::kParts],
                                        const float4& g, int c, int dim) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c + i < dim) {
      float x[M::kParts];
#pragma unroll
      for (int p = 0; p < M::kParts; ++p) x[p] = easyrec::part(v[p], i);
      math(x, easyrec::part(g, i));
#pragma unroll
      for (int p = 0; p < M::kParts; ++p) set_part(v[p], i, x[p]);
    }
  }
}

template <typename M, bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int c, int dim,
                                         float4 (&v)[M::kParts]) {
#pragma unroll
  for (int p = 0; p < M::kParts; ++p)
    v[p] = easyrec::load4<kVec, false>(row + p * dim, c, dim);
}

template <typename M, bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ row, int c,
                                          int dim,
                                          const float4 (&v)[M::kParts]) {
#pragma unroll
  for (int p = 0; p < M::kParts; ++p)
    easyrec::store4<kVec>(row + p * dim, c, dim, v[p]);
}

template <typename M, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rmw_rows_kernel(float* __restrict__ table, const int64_t* __restrict__ uids,
                const float* __restrict__ gsum,
                const float* __restrict__ hypers, easyrec::Consts consts,
                int64_t n, int64_t rows, int dim, int group) {
  const M math(hypers, consts);
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int c = 4 * (lane % group);
  const unsigned gmask = group == 32
                             ? kFullMask
                             : ((1u << group) - 1u) << (lane / group * group);
  const int64_t width = static_cast<int64_t>(M::kParts) * dim;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t round = static_cast<int64_t>(per_warp) * kRows;
  const bool wide = dim > 4 * group;        // then group == 32, one slot
  for (int64_t k0 = warp * round; k0 < n; k0 += warps * round) {
    // slot r * per_warp + lane / group of the round: neighbouring groups
    // read neighbouring ids
    int64_t k[kRows], row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      k[r] = k0 + r * per_warp + lane / group;
      row[r] = k[r] < n ? uids[k[r]] : -1;
    }
    if (!wide) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 g[kRows];
      float4 v[kRows][M::kParts];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool live = row[r] >= 0 && row[r] < rows;
        g[r] = live ? easyrec::load4<kVec, false>(gsum + k[r] * dim, c, dim)
                    : zero;
        if (live) {
          load_row<M, kVec>(table + row[r] * width, c, dim, v[r]);
        } else {
#pragma unroll
          for (int p = 0; p < M::kParts; ++p) v[r][p] = zero;
        }
      }
      bool touched[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        touched[r] = (__ballot_sync(kFullMask, easyrec::nonzero4(g[r])) &
                      gmask) != 0;
      // the math of every row at once, with no branch between rows, so
      // their chains interleave; a dead row's zeros stay finite and only
      // touched rows are written (untouched or dead: keep bytes)
#pragma unroll
      for (int r = 0; r < kRows; ++r) update4(math, v[r], g[r], c, dim);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (touched[r])
          store_row<M, kVec>(table + row[r] * width, c, dim, v[r]);
      continue;
    }
    // above dim 128: the whole warp on one slot at a time
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool live = row[r] >= 0 && row[r] < rows;
      const float* gr = gsum + k[r] * dim;
      bool nz = false;
      if (live)
        for (int cb = c; cb < dim; cb += 128)
          nz |= easyrec::nonzero4(easyrec::load4<kVec, false>(gr, cb, dim));
      if (!__any_sync(kFullMask, nz)) continue;
      float* tr = table + row[r] * width;
      for (int cb = c; cb < dim; cb += 128) {
        const float4 gv = easyrec::load4<kVec, false>(gr, cb, dim);
        float4 v[M::kParts];
        load_row<M, kVec>(tr, cb, dim, v);
        update4(math, v, gv, cb, dim);
        store_row<M, kVec>(tr, cb, dim, v);
      }
    }
  }
}

// Lanes a row takes: the power of two >= dim / 4, from 1 to 32.
int row_group(int dim) {
  int g = 1;
  while (g < 32 && 4 * g < dim) g *= 2;
  return g;
}

template <typename M>
cudaError_t launch(float* table, const int64_t* uids, const float* gsum,
                   const float* hypers, const easyrec::Consts& consts,
                   int64_t n, int64_t rows, int dim, bool vec,
                   cudaStream_t stream) {
  const int group = row_group(dim);
  const int64_t warps =
      (n + static_cast<int64_t>(32 / group) * kRows - 1) /
      (static_cast<int64_t>(32 / group) * kRows);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(easyrec::persistent_blocks(warps));
  if (vec)
    rmw_rows_kernel<M, true><<<grid, block, 0, stream>>>(
        table, uids, gsum, hypers, consts, n, rows, dim, group);
  else
    rmw_rows_kernel<M, false><<<grid, block, 0, stream>>>(
        table, uids, gsum, hypers, consts, n, rows, dim, group);
  return cudaGetLastError();
}

}  // namespace

// math: a block_math.cuh MathId; consts: host float[kMaxConsts] of the
// math's constants; vec: rows of table and gsum start 16-byte aligned and
// dim % 4 == 0.
extern "C" int easyrec_rmw_rows(int math, float* table, const int64_t* uids,
                                const float* gsum, const float* hypers,
                                const float* consts, int64_t n, int64_t rows,
                                int dim, int vec, cudaStream_t stream) {
  if (dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  easyrec::Consts k;
  std::memcpy(k.c, consts, sizeof(k.c));
  cudaError_t err = cudaErrorInvalidValue;
  easyrec::dispatch_math(math, [&](auto tag) {
    using M = typename decltype(tag)::type;
    err = launch<M>(table, uids, gsum, hypers, k, n, rows, dim, vec != 0,
                    stream);
  });
  return static_cast<int>(err);
}
