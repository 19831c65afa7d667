// K5: in-place affine read-modify-write of whole groups (easyrec_torch).
//
// Replaces the three TPU kernels that pull a chunk of [8, W] groups into
// VMEM by DMA, run an affine stand-in for the optimizer math on them and
// push them back:
//   kernel       benchmarks/bench_pallas_group_dma.py:22 (pallas_call :45):
//                x*0.999 + 0.001
//   make_kernel  benchmarks/bench_dma_issue.py:34 (pallas_call :115):
//                x*0.999 - 0.001
//   rmw_variant  benchmarks/bench_packed_stages.py:96 (pallas_call :133):
//                x*0.999 - 0.001*gg
//
// Function, in place, for every slot i < n and every element x of group
// gids[i]:
//   without gg:  x' = round(round(a*x) + b)
//   with gg:     x' = round(round(a*x) + round(c*gg[i][e]))
// with __fmul_rn / __fadd_rn, so nvcc cannot contract the two roundings
// into an FMA and the plain PyTorch version (index_select, the same ops in
// the same order, index_copy_) is bit-equal. The table is [groups, elems]
// f32, gg [n, elems] f32, gids int32 or int64. Ids are unique except for
// pad slots that name the scratch group; every slot is updated, pads
// included, as on the TPU, so the scratch group's bytes afterwards are
// unspecified (its slots race). A slot whose id lies outside
// [0, groups) is not touched: the kernel sets *bad to 1 instead, and the
// wrapper's check_ids (ops/group_dma.py) raises on it, as the plain
// version's index_select raises on such an id at once.
//
// Bound on the H100: memory. Each group is read and written once, each gg
// row read once, and the ids read: n * elems * 4 * (2 or 3) + n *
// sizeof(id) bytes; 2 flops an element (0.3 flop a byte) is far below the
// card's ridge. At the bench_pallas_group_dma shape (98,304 groups, W 384,
// int32 ids) 2,416,312,320 bytes, 0.7213 ms at 3.35 TB/s; at the
// rmw_variant shape (106,496 slots with gg, W 128) 1,309,048,832 bytes,
// 0.3908 ms.
//
// Design: the TPU kernel's chunk, DMA issue loop and semaphore waits exist
// to hide HBM latency from one sequential core. Here `threads` threads
// (a power of two, 32..1024) take one group and `per_block` groups share a
// block; they read the id once and stream the group with 16-byte loads,
// kUnroll loads in flight a thread before the stores, consecutive threads
// on consecutive addresses. The launch shape is the caller's, so a
// benchmark can compare shapes (easyrec_torch/benchmarks/bench_dma_issue.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kUnroll = 4;       // float4 loads in flight a thread

__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(a, x), b);
}

__device__ __forceinline__ float affine_gg(float x, float g, float a,
                                           float c) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(c, g));
}

template <typename Id, bool kGrad>
__global__ void group_rmw_kernel(float4* __restrict__ table,
                                 const Id* __restrict__ gids,
                                 const float4* __restrict__ gg,
                                 int* __restrict__ bad, int64_t n,
                                 int64_t groups, int64_t nvec, float a,
                                 float b, float c) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const int64_t g = static_cast<int64_t>(gids[i]);
  if (g < 0 || g >= groups) {
    if (threadIdx.x == 0) *bad = 1;
    return;
  }
  float4* x = table + g * nvec;
  const float4* d = kGrad ? gg + i * nvec : nullptr;
  const int step = blockDim.x;
  for (int64_t base = threadIdx.x; base < nvec; base += kUnroll * step) {
    float4 v[kUnroll];
    float4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + static_cast<int64_t>(u) * step;
      if (e < nvec) {
        v[u] = x[e];
        if (kGrad) w[u] = __ldcs(d + e);        // read once: evict first
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + static_cast<int64_t>(u) * step;
      if (e >= nvec) continue;
      float4 r;
      if (kGrad) {
        r.x = affine_gg(v[u].x, w[u].x, a, c);
        r.y = affine_gg(v[u].y, w[u].y, a, c);
        r.z = affine_gg(v[u].z, w[u].z, a, c);
        r.w = affine_gg(v[u].w, w[u].w, a, c);
      } else {
        r.x = affine(v[u].x, a, b);
        r.y = affine(v[u].y, a, b);
        r.z = affine(v[u].z, a, b);
        r.w = affine(v[u].w, a, b);
      }
      x[e] = r;
    }
  }
}

template <typename Id>
void launch(dim3 grid, dim3 block, cudaStream_t stream, float4* t,
            const void* gids, const float4* gg, int* bad, int64_t n,
            int64_t groups, int64_t nvec, float a, float b, float c) {
  const Id* ids = static_cast<const Id*>(gids);
  if (gg != nullptr)
    group_rmw_kernel<Id, true><<<grid, block, 0, stream>>>(
        t, ids, gg, bad, n, groups, nvec, a, b, c);
  else
    group_rmw_kernel<Id, false><<<grid, block, 0, stream>>>(
        t, ids, gg, bad, n, groups, nvec, a, b, c);
}

}  // namespace

// gg may be null (no gradient term). elems must be a multiple of 4 and
// table and gg 16-byte aligned (the wrapper checks both); threads a power
// of two in [32, 1024] with threads * per_block <= 1024; bad is one device
// int the kernel sets to 1 on an id outside the table. Returns
// cudaGetLastError() after the launch.
extern "C" int easyrec_group_rmw(float* table, const void* gids,
                                 const float* gg, int* bad, int64_t n,
                                 int64_t groups,
                                 int64_t elems, int idx64, float a, float b,
                                 float c, int threads, int per_block,
                                 cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (elems <= 0 || elems % 4 != 0 || threads < 32 || threads > 1024 ||
      (threads & (threads - 1)) != 0 || per_block < 1 ||
      threads * per_block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(threads, per_block);
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block));
  float4* t = reinterpret_cast<float4*>(table);
  const float4* d = reinterpret_cast<const float4*>(gg);
  if (idx64)
    launch<int64_t>(grid, block, stream, t, gids, d, bad, n, groups,
                    elems / 4, a, b, c);
  else
    launch<int32_t>(grid, block, stream, t, gids, d, bad, n, groups,
                    elems / 4, a, b, c);
  return static_cast<int>(cudaGetLastError());
}
