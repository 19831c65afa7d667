// Deterministic chunk-tree segmented sum (easyrec_torch), shared by K1
// (seg_sum.cu) and K3 (rmw_fused.cu); K2 (rmw_rows.cu) takes its float4
// helpers and persistent_blocks.
//
// Inputs of both callers (ids sorted beforehand by
// packed_table.sort_segments):
//   order  [n]      sorted slot -> row of the gradients
//   starts [n+1]    first sorted slot of segment k; n for unused k, which
//                   form a tail (live segments are 0..L-1), and
//                   starts[n] == n
//
// The tree of f32 additions is fixed by a segment's length alone. The
// plain version (packed_table.segment_sums_by_chunk) adds in the same
// order, so the two agree bit for bit:
//   level 1  the segment's sorted slots are cut into chunks of kChunk
//            slots (the last may be shorter). In a chunk, slot-lane
//            p < kSlotLanes adds the chunk's slots p, p + 8, p + 16, ...
//            in that order to +0.0; then the eight lane sums combine
//            pairwise, v[:o] + v[o:2o] for o = 4, 2, 1.
//   level 2  a segment of one chunk has its chunk's sum. A longer one adds
//            its chunk sums by the same strided-then-pairwise tree, chunk
//            q on slot-lane q % 8, so a padding segment of 100k slots (391
//            chunks) is eight chains of 49 adds, not one of 391.
// A round-to-nearest f32 sum that starts at +0.0 is never -0.0, so adding
// +0.0 for a missing slot changes no bit: the plain version pads with
// zeros where the kernels skip.
//
// Three shapes of work, none per unused segment index, all walked by
// grid-stride loops over at most eight blocks an SM, with no host sync
// and no atomics:
//   tiny segments (at most kSlotLanes slots, most ids of a batch): a group
//     of G lanes per segment, G the power of two >= dim / 4 (4 at dim 16,
//     so eight segments a warp). Each lane loads its columns of all the
//     segment's rows at once, then adds them as the tree does: slot i is
//     slot-lane i's only term.
//   short segments (up to kChunk slots): one warp, lane 4p + q being
//     slot-lane p and column-lane q. A pass covers 16 columns: column-lane
//     q loads columns 4q..4q+3 of a row as one 16-byte float4 where
//     dim % 4 == 0 and rows are 16-byte aligned (kVec), else as four
//     scalars; each lane has kAhead loads in flight before its adds; the
//     pairwise combine is three __shfl_xor_sync steps.
//   long segments: each chunk is summed as a short segment is, into a
//     scratch row, then a second launch adds a segment's chunk sums (level
//     2) at the warp of its first chunk. Chunks are found by window: the
//     sorted slots are cut into windows of kChunk; a window holds the
//     start of at most two long-segment chunks, one of the segment that
//     contains the window's first slot (t = 0) and one of a long segment
//     that starts inside it (t = 1), each found by a 32-way warp search
//     of `starts` (four dependent loads at n = 471,040). The chunk takes
//     scratch row 2w + t, so the scratch has 2 ceil(n / kChunk) rows and
//     no work list is built.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace easyrec {

constexpr int64_t kChunk = 256;    // packed_table.FUSED_CHUNK
constexpr int kSlotLanes = 8;      // packed_table.SLOT_LANES
constexpr int kPassCols = 16;      // columns of one pass of a warp
constexpr int kAhead = 8;          // loads in flight a lane
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// round-to-nearest-even to bf16, kept in an f32 (packed_table.bf16_round)
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(u);
}

template <bool kVec, bool kRound>
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int c, int dim) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kVec) {
    if (c < dim) v = *reinterpret_cast<const float4*>(row + c);
  } else {
    if (c < dim) v.x = row[c];
    if (c + 1 < dim) v.y = row[c + 1];
    if (c + 2 < dim) v.z = row[c + 2];
    if (c + 3 < dim) v.w = row[c + 3];
  }
  if (kRound) {
    v.x = round_bf16(v.x);
    v.y = round_bf16(v.y);
    v.z = round_bf16(v.z);
    v.w = round_bf16(v.w);
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ row, int c,
                                       int dim, float4 v) {
  if (kVec) {
    if (c < dim) *reinterpret_cast<float4*>(row + c) = v;
  } else {
    if (c < dim) row[c] = v.x;
    if (c + 1 < dim) row[c + 1] = v.y;
    if (c + 2 < dim) row[c + 2] = v.z;
    if (c + 3 < dim) row[c + 3] = v.w;
  }
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

__device__ __forceinline__ bool nonzero4(const float4& v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

// Component i < 4 of v.
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------ the tree

// Rows of level 1: sorted slot j -> order[j].
struct SlotRows {
  const int64_t* __restrict__ order;
  __device__ __forceinline__ int64_t operator()(int64_t j) const {
    return order[j];
  }
};

// Scratch row of chunk j of the long segment whose first slot is s (see
// the window note above).
__host__ __device__ __forceinline__ int64_t chunk_row(int64_t s,
                                                      int64_t j) {
  return 2 * ((s + j * kChunk) / kChunk) + (j == 0 && s % kChunk != 0);
}

// Rows of level 2: chunk j of the segment starting at s -> its scratch row.
struct ChunkRows {
  int64_t s;
  __device__ __forceinline__ int64_t operator()(int64_t j) const {
    return chunk_row(s, j);
  }
};

// One 16-column pass of the tree for a whole warp: the sum of rows
// src[rows(j)] for j in [lo, hi), columns c..c+3 of this lane (c = 16 *
// pass + 4q). Every slot-lane returns the same sum. kRound rounds each
// loaded value to bf16 first (EASYREC_GG_BF16 '1' and 'mix').
template <bool kVec, bool kRound, typename Rows>
__device__ __forceinline__ float4 tree_pass(Rows rows,
                                            const float* __restrict__ src,
                                            int64_t lo, int64_t hi, int dim,
                                            int c, int lane) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t j = lo + (lane >> 2);
  for (; j + (kAhead - 1) * kSlotLanes < hi; j += kAhead * kSlotLanes) {
    int64_t r[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) r[i] = rows(j + i * kSlotLanes);
    float4 v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      v[i] = load4<kVec, kRound>(src + r[i] * dim, c, dim);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) acc = add4(acc, v[i]);
  }
  for (; j < hi; j += kSlotLanes)
    acc = add4(acc, load4<kVec, kRound>(src + rows(j) * dim, c, dim));
  // slot-lanes 4, 2, 1 apart are lanes 16, 8, 4 apart
#pragma unroll
  for (int o = 16; o >= 4; o >>= 1) {
    float4 other;
    other.x = __shfl_xor_sync(kFullMask, acc.x, o);
    other.y = __shfl_xor_sync(kFullMask, acc.y, o);
    other.z = __shfl_xor_sync(kFullMask, acc.z, o);
    other.w = __shfl_xor_sync(kFullMask, acc.w, o);
    acc = add4(acc, other);
  }
  return acc;
}

// The tree of a tiny segment [s, e), e - s <= kSlotLanes, for one lane's
// columns c..c+3: slot s + i is slot-lane i's only term (0 + x), then the
// pairwise combine. All rows are loaded before the first add.
template <bool kVec, bool kRound>
__device__ __forceinline__ float4 tiny_sum(const int64_t* __restrict__ order,
                                           const float* __restrict__ src,
                                           int64_t s, int64_t e, int dim,
                                           int c) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v[kSlotLanes];
#pragma unroll
  for (int i = 0; i < kSlotLanes; ++i)
    v[i] = s + i < e ? load4<kVec, kRound>(src + order[s + i] * dim, c, dim)
                     : zero;
#pragma unroll
  for (int i = 0; i < kSlotLanes; ++i) v[i] = add4(zero, v[i]);
#pragma unroll
  for (int o = kSlotLanes / 2; o >= 1; o >>= 1)
#pragma unroll
    for (int i = 0; i < o; ++i) v[i] = add4(v[i], v[i + o]);
  return v[0];
}

// ------------------------------------------------------ finding the work

// The first k in [0, m) with a[k] > x, for a non-decreasing and
// a[m - 1] > x. Warp-wide; every lane returns the same k.
__device__ __forceinline__ int64_t first_above(const int64_t* __restrict__ a,
                                               int64_t m, int64_t x,
                                               int lane) {
  int64_t lo = 0, hi = m;                      // the answer is in [lo, hi)
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t at = lo + lane * step;
    const unsigned past = __ballot_sync(kFullMask, at >= hi || a[at] > x);
    if (past == 0) {                           // beyond lane 31's probe
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(past) - 1;
    const int64_t new_hi = lo + f * step + 1 < hi ? lo + f * step + 1 : hi;
    lo = f == 0 ? lo : lo + (f - 1) * step + 1;
    hi = new_hi;
  }
  const int64_t at = lo + lane;
  const unsigned past = __ballot_sync(kFullMask, at >= hi || a[at] > x);
  return lo + (__ffs(past) - 1);
}

// A chunk of a long segment: segment k, its slots [s, e), chunk j.
struct ChunkItem {
  int64_t k, s, e, j;
};

// Chunk t (0 or 1) of window w, if there is one (warp-wide): t = 0 is the
// chunk of the segment that contains slot w * kChunk, where that segment
// is long and one of its chunks starts in the window; t = 1 the first
// chunk of a long segment that starts inside the window after its first
// slot. Its scratch row is 2w + t == chunk_row(s, j).
__device__ __forceinline__ bool window_item(
    const int64_t* __restrict__ starts, int64_t n, int64_t w, int t,
    int lane, ChunkItem* item) {
  const int64_t lo = w * kChunk;
  const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
  // the last segment starting at or before slot lo (t = 0) or hi - 1
  const int64_t k = first_above(starts, n + 1, t == 0 ? lo : hi - 1,
                                lane) - 1;
  const int64_t s = starts[k];
  const int64_t e = starts[k + 1];
  if (e - s <= kChunk) return false;
  if (t == 1) {
    if (s <= lo) return false;                 // that is t = 0's segment
    *item = ChunkItem{k, s, e, 0};
    return true;
  }
  const int64_t j = (lo - s + kChunk - 1) / kChunk;
  const int64_t first = s + j * kChunk;
  if (first >= hi || first >= e) return false;
  *item = ChunkItem{k, s, e, j};
  return true;
}

__host__ __device__ __forceinline__ int64_t windows(int64_t n) {
  return (n + kChunk - 1) / kChunk;
}

// Every pass of one segment's (or chunk's) sum by the whole warp into
// dst[0:dim]; kRoundOut rounds the sum to bf16 once (EASYREC_GG_BF16 '1').
template <bool kVec, bool kRoundIn, bool kRoundOut, typename Rows>
__device__ __forceinline__ void warp_sum_into(Rows rows,
                                              const float* __restrict__ src,
                                              int64_t lo, int64_t hi,
                                              int dim, float* __restrict__ dst,
                                              int lane) {
  const int col = 4 * (lane & 3);
  for (int p = 0; p < dim; p += kPassCols) {
    float4 v = tree_pass<kVec, kRoundIn>(rows, src, lo, hi, dim, p + col,
                                         lane);
    if (kRoundOut) v = round4(v);
    if (lane < 4) store4<kVec>(dst, p + col, dim, v);
  }
}

// f(item, row) for each long-segment chunk item of the windows this warp
// takes in a grid-stride loop; row is its scratch row 2w + t.
template <typename F>
__device__ __forceinline__ void for_window_items(
    const int64_t* __restrict__ starts, int64_t n, int64_t warp,
    int64_t warps, int lane, F f) {
  const int64_t n_win = windows(n);
  for (int64_t w = warp; w < n_win; w += warps) {
    for (int t = 0; t < 2; ++t) {
      ChunkItem it;
      if (window_item(starts, n, w, t, lane, &it)) f(it, 2 * w + t);
    }
  }
}

// The live segments, walked by a grid-stride loop, 32 / group a warp
// (lane group g = lane / group holds segment k0 + g). Each round every
// lane calls tiny(k, s, e, is_tiny), is_tiny where its group's segment is
// live and at most kSlotLanes slots (so tiny may vote across the warp);
// then the whole warp calls whole(k, s, e) for each segment of the round
// of more than kSlotLanes and at most kChunk slots. Longer segments are
// left to the window items. The loop stops at the unused tail.
template <typename Tiny, typename Whole>
__device__ __forceinline__ void for_live_segments(
    const int64_t* __restrict__ starts, int64_t n, int64_t warp,
    int64_t warps, int lane, int group, Tiny tiny, Whole whole) {
  const int per_warp = 32 / group;
  for (int64_t k0 = warp * per_warp; k0 < n; k0 += warps * per_warp) {
    const int64_t k = k0 + lane / group;
    const int64_t s = k < n ? starts[k] : n;
    const int64_t e = k < n ? starts[k + 1] : n;
    const bool live = s < n;
    tiny(k, s, e, live && e - s <= kSlotLanes);
    // lane 0 of each group votes for its segment
    unsigned mid = __ballot_sync(
        kFullMask,
        lane % group == 0 && live && e - s > kSlotLanes && e - s <= kChunk);
    while (mid != 0) {
      const int src = __ffs(mid) - 1;
      mid &= mid - 1;
      whole(__shfl_sync(kFullMask, k, src), __shfl_sync(kFullMask, s, src),
            __shfl_sync(kFullMask, e, src));
    }
    if (__ballot_sync(kFullMask, live) == 0) break;  // the unused tail
  }
}

// Level 1 of every long segment: each chunk's sum into its scratch row.
template <bool kVec, bool kRound>
__device__ __forceinline__ void sum_long_chunks(
    const int64_t* __restrict__ order, const int64_t* __restrict__ starts,
    const float* __restrict__ grads, float* __restrict__ partial, int64_t n,
    int dim, int64_t warp, int64_t warps, int lane) {
  for_window_items(starts, n, warp, warps, lane,
                   [&](const ChunkItem& it, int64_t row) {
    const int64_t lo = it.s + it.j * kChunk;
    const int64_t hi = lo + kChunk < it.e ? lo + kChunk : it.e;
    warp_sum_into<kVec, kRound, false>(SlotRows{order}, grads, lo, hi, dim,
                                       partial + row * dim, lane);
  });
}

// Blocks of 32 * kWarpsPerBlock threads for `warps` work items: one block
// per eight items, at most eight blocks an SM (grid-stride loops do the
// rest).
inline unsigned persistent_blocks(int64_t warps) {
  int device = 0;
  int sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = 8 * static_cast<int64_t>(sms);
  return static_cast<unsigned>(want < 1 ? 1 : want < cap ? want : cap);
}

// Lanes a tiny segment takes: the power of two >= dim / 4, from 4 to 32.
inline int tiny_group(int dim) {
  int g = 4;
  while (g < 32 && 4 * g < dim) g *= 2;
  return g;
}

}  // namespace easyrec
