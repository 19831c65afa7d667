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
//   chunk_seg  [n_chunks] segment of chunk slot c, -1 where none
//   chunk_base [n]        first chunk slot of segment k (long segments)
//   partial [n_chunks, dim] scratch for the chunk sums of long segments
//
// Order of additions, fixed and free of atomics: every segment is cut into
// chunks of kChunk sorted slots. A chunk is summed in f32 in slot order
// from 0. A segment of at most kChunk slots is one chunk, and its sum is
// final. A longer segment's chunk sums go to `partial`, and its sum is
// 0 + chunk 0 + chunk 1 + ... in chunk order. The plain version
// (packed_table.rmw_fused_adam_plain) follows the same tree, so the two
// agree bit for bit on w, m and v.
//
// Two launches on one stream:
//   fused_sum_kernel  one warp per segment k < n: a segment of at most
//                     kChunk slots is summed in registers and updated in
//                     place at once; and one warp per chunk slot c of the
//                     long segments, which writes its chunk sum to
//                     `partial`;
//   long_finish_kernel one warp per long segment (the warp of its first
//                     chunk slot): adds its chunk sums in order and
//                     updates the row.
// So no warp walks more than kChunk slots: a padding id that collects
// 100k-200k slots of one batch (Taobao DIN sequences) is summed by
// hundreds of warps at once.
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
// Rows and gradients are 64- or 128-byte lines read whole by one warp.

#include <cuda_runtime.h>

#include <cstdint>

#include "compact_adam.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int64_t kChunk = 256;      // packed_table.FUSED_CHUNK
constexpr int kMaxColGroups = 4;     // dim <= 128
constexpr unsigned kFull = 0xffffffffu;

// f32 sum, in sorted-slot order from 0, of gradient rows order[lo..hi)
// for columns c0 + lane of every 32-column group.
__device__ __forceinline__ void chunk_sum(const int64_t* __restrict__ order,
                                          const float* __restrict__ grads,
                                          int64_t lo, int64_t hi, int dim,
                                          int lane,
                                          float (&acc)[kMaxColGroups]) {
#pragma unroll
  for (int q = 0; q < kMaxColGroups; ++q) acc[q] = 0.f;
  for (int64_t j0 = lo; j0 < hi; j0 += 32) {
    const int cnt = hi - j0 < 32 ? static_cast<int>(hi - j0) : 32;
    const int64_t mine = lane < cnt ? order[j0 + lane] : 0;
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
      const int64_t r = __shfl_sync(kFull, mine, i);
      const float* g = grads + r * dim;
#pragma unroll
      for (int q = 0; q < kMaxColGroups; ++q) {
        const int c = q * 32 + lane;
        if (c < dim) acc[q] = __fadd_rn(acc[q], g[c]);
      }
    }
  }
}

// K2's update of one row from its summed gradient (warp-wide).
__device__ __forceinline__ void adam_row(float* __restrict__ table,
                                         int64_t row, int64_t rows, int dim,
                                         int lane,
                                         const float (&g)[kMaxColGroups],
                                         const float* __restrict__ hypers,
                                         float b1, float omb1, float b2,
                                         float omb2, float eps) {
  if (row < 0 || row >= rows) return;              // outside the table
  bool nz = false;
#pragma unroll
  for (int q = 0; q < kMaxColGroups; ++q)
    nz |= (q * 32 + lane < dim) && (g[q] != 0.f);
  if (!__any_sync(kFull, nz)) return;              // untouched: keep bytes
  const float lr = hypers[0];
  const float c1 = hypers[1];
  const float c2 = hypers[2];
  float* w = table + row * (2 * static_cast<int64_t>(dim));
  uint32_t* mv = reinterpret_cast<uint32_t*>(w + dim);
#pragma unroll
  for (int q = 0; q < kMaxColGroups; ++q) {
    const int c = q * 32 + lane;
    if (c < dim)
      easyrec::compact_adam(w + c, mv + c, g[q], lr, c1, c2, b1, omb1, b2,
                            omb2, eps);
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_sum_kernel(float* __restrict__ table,
                 const int64_t* __restrict__ sids,
                 const int64_t* __restrict__ order,
                 const int64_t* __restrict__ starts,
                 const float* __restrict__ grads,
                 const float* __restrict__ hypers,
                 const int64_t* __restrict__ chunk_seg,
                 const int64_t* __restrict__ chunk_base,
                 float* __restrict__ partial,
                 int64_t n, int64_t n_chunks, int64_t rows, int dim,
                 float b1, float omb1, float b2, float omb2, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  float acc[kMaxColGroups];
  if (w < n) {
    // segment w: summed and updated here unless it is long
    const int64_t s = starts[w];
    if (s >= n) return;                            // unused segment
    const int64_t e = starts[w + 1];
    if (e - s > kChunk) return;
    chunk_sum(order, grads, s, e, dim, lane, acc);
    adam_row(table, sids[s], rows, dim, lane, acc, hypers, b1, omb1, b2,
             omb2, eps);
    return;
  }
  // chunk slot c of a long segment: its chunk sum into `partial`
  const int64_t c = w - n;
  if (c >= n_chunks) return;
  const int64_t seg = chunk_seg[c];
  if (seg < 0) return;
  const int64_t s = starts[seg];
  const int64_t e = starts[seg + 1];
  const int64_t lo = s + (c - chunk_base[seg]) * kChunk;
  if (lo >= e) return;                             // past the last chunk
  const int64_t hi = lo + kChunk < e ? lo + kChunk : e;
  chunk_sum(order, grads, lo, hi, dim, lane, acc);
  float* out = partial + c * dim;
#pragma unroll
  for (int q = 0; q < kMaxColGroups; ++q)
    if (q * 32 + lane < dim) out[q * 32 + lane] = acc[q];
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
long_finish_kernel(float* __restrict__ table,
                   const int64_t* __restrict__ sids,
                   const int64_t* __restrict__ starts,
                   const float* __restrict__ hypers,
                   const int64_t* __restrict__ chunk_seg,
                   const int64_t* __restrict__ chunk_base,
                   const float* __restrict__ partial,
                   int64_t n_chunks, int64_t rows, int dim,
                   float b1, float omb1, float b2, float omb2, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int64_t seg = chunk_seg[c];
  if (seg < 0 || chunk_base[seg] != c) return;     // first chunks only
  const int64_t s = starts[seg];
  const int64_t n_ch = (starts[seg + 1] - s + kChunk - 1) / kChunk;
  float acc[kMaxColGroups];
#pragma unroll
  for (int q = 0; q < kMaxColGroups; ++q) acc[q] = 0.f;
  for (int64_t j = 0; j < n_ch; ++j) {
    const float* p = partial + (c + j) * dim;
#pragma unroll
    for (int q = 0; q < kMaxColGroups; ++q) {
      const int col = q * 32 + lane;
      if (col < dim) acc[q] = __fadd_rn(acc[q], p[col]);
    }
  }
  adam_row(table, sids[s], rows, dim, lane, acc, hypers, b1, omb1, b2, omb2,
           eps);
}

unsigned blocks_for(int64_t warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int easyrec_rmw_fused_adam(
    float* table, const int64_t* sids, const int64_t* order,
    const int64_t* starts, const float* grads, const float* hypers,
    const int64_t* chunk_seg, const int64_t* chunk_base, float* partial,
    int64_t n, int64_t n_chunks, int64_t rows, int dim, float b1, float omb1,
    float b2, float omb2, float eps, cudaStream_t stream) {
  if (dim <= 0 || dim > 32 * kMaxColGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32 * kWarpsPerBlock);
  fused_sum_kernel<<<blocks_for(n + n_chunks), block, 0, stream>>>(
      table, sids, order, starts, grads, hypers, chunk_seg, chunk_base,
      partial, n, n_chunks, rows, dim, b1, omb1, b2, omb2, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks > 0) {
    long_finish_kernel<<<blocks_for(n_chunks), block, 0, stream>>>(
        table, sids, starts, hypers, chunk_seg, chunk_base, partial,
        n_chunks, rows, dim, b1, omb1, b2, omb2, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
