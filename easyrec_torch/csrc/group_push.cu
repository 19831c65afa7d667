// K4: scattered whole-group write-back into a packed table (easyrec_torch).
//
// Replaces the three TPU kernels that write [8, W] groups back to their
// places with one DMA per group from a scalar loop over SMEM ids:
//   push_variant        benchmarks/bench_packed_stages.py:52 (pallas_call :77)
//   _pallas_apply       benchmarks/experimental_packed_update.py:169 (:215)
//   push_groups_pallas  benchmarks/bench_packed_v2.py:127 (:170)
//
// Function, in place: table[gids[i]] = rows[i] for every slot i < n. The
// table is [groups, elems] f32 (a [G, 8, W] table has elems = 8*W), rows
// is [n, elems], gids int32 or int64. Ids are unique except for pad slots
// that name the scratch group and carry its current bytes, so duplicate
// writes store identical bytes and the result is deterministic. A slot
// whose id lies outside [0, groups) is not written: the kernel sets *bad
// to 1 instead, and the wrapper's check_ids (ops/group_dma.py) raises on
// it, as the plain version's index_copy_ raises on such an id at once.
//
// Bound on the H100: memory. The call reads each row once, writes each
// group once and reads the ids: n * elems * 4 * 2 + n * sizeof(id) bytes,
// 872,841,216 at the bench_packed_v2 deep shape (106,496 slots, W 128,
// int32 ids), 0.2605 ms at 3.35 TB/s. There is no arithmetic.
//
// Design: the TPU kernel pages ids into SMEM and walks them with a scalar
// loop that issues one DMA per group. On Hopper each group gets kThreads
// threads (kPerBlock groups a block) that read the group's id once and
// move it with 16-byte loads and stores, consecutive threads on
// consecutive addresses, so every group moves as whole 128-byte lines.
// Each thread issues kUnroll loads before its stores, and many groups are
// resident on every SM, so enough bytes are in flight to cover the
// latency of the random group order. No shared memory, no atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;     // threads a group
constexpr int kPerBlock = 4;     // groups a block
constexpr int kUnroll = 4;       // float4 loads in flight a thread

template <typename Id>
__global__ void __launch_bounds__(kThreads * kPerBlock)
group_push_kernel(float4* __restrict__ table, const Id* __restrict__ gids,
                  const float4* __restrict__ rows, int* __restrict__ bad,
                  int64_t n, int64_t groups, int64_t nvec) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kPerBlock + threadIdx.y;
  if (i >= n) return;
  const int64_t g = static_cast<int64_t>(gids[i]);
  if (g < 0 || g >= groups) {
    if (threadIdx.x == 0) *bad = 1;
    return;
  }
  float4* dst = table + g * nvec;
  const float4* src = rows + i * nvec;
  for (int64_t base = threadIdx.x; base < nvec;
       base += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + u * kThreads;
      if (e < nvec) v[u] = __ldcs(src + e);     // read once: evict first
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + u * kThreads;
      if (e < nvec) dst[e] = v[u];
    }
  }
}

}  // namespace

// elems must be a multiple of 4 and table and rows 16-byte aligned (the
// wrapper checks both); bad is one device int the kernel sets to 1 on an id
// outside the table. Returns cudaGetLastError() after the launch.
extern "C" int easyrec_group_push(float* table, const void* gids,
                                  const float* rows, int* bad, int64_t n,
                                  int64_t groups, int64_t elems, int idx64,
                                  cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (elems <= 0 || elems % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads, kPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock));
  float4* t = reinterpret_cast<float4*>(table);
  const float4* r = reinterpret_cast<const float4*>(rows);
  if (idx64)
    group_push_kernel<int64_t><<<grid, block, 0, stream>>>(
        t, static_cast<const int64_t*>(gids), r, bad, n, groups, elems / 4);
  else
    group_push_kernel<int32_t><<<grid, block, 0, stream>>>(
        t, static_cast<const int32_t*>(gids), r, bad, n, groups, elems / 4);
  return static_cast<int>(cudaGetLastError());
}
