// K7: the bags of one pulled pack pooled at once, and their gradient
// written into the pack (easyrec_torch).
//
// Replaces no TPU kernel: the JAX package leaves `combine`
// (easyrec_tpu/ops/embedding.py:241) to XLA. In the port it takes the place
// of one einsum('bk,bkd->bd') a bag forward and one a bag backward
// (ops/embedding.py combine, sum and mean), and of the backward of the
// split that cut the pack into those bags' pieces.
//
// Function. A pack rows [B, T, D] f32 holds, for each example, the pulled
// rows of the bags of one fused table, bag j in slots [start_j,
// start_j + k_j), the bags consecutive and covering [0, T); w [B, T] f32
// weighs each slot (0 marks padding). Forward, for every example b and bag
// j:  out[b, j] = sum_{t in bag j} w[b, t] * rows[b, t],  summed in slot
// order from 0, each product and each sum rounded to f32 on its own (no
// FMA contraction); a `mean` bag then divides by max(sum_t w[b, t], 1e-9),
// its weights summed in the same order. Backward, from g [B, nbags, D]:
// grad_rows[b, t] = w[b, t] * g'[b, bag(t)], g' = g, or g divided by the
// same denominator in a `mean` bag: every element of the pack's gradient
// written once, nothing filled. The plain versions (ops/embedding.py
// pool_bags_plain, pool_bags_grad_plain) compute the same roundings in the
// same order, so the two are bit-equal.
//
// Bound on the H100: memory. Forward reads the pack and the weights once
// and writes the bags: B*T*D*4 + B*T*4 + B*nbags*D*4 bytes; backward reads
// the bags' gradient and the weights and writes the pack's gradient, the
// same count. At the DLRM-DCNv2 cell's shape (B 16,384, T 214 slots in 26
// bags, D 128) that is 2,027,290,624 B each way, 0.605 ms at 3.35 TB/s.
// There are 2*B*T*D f32 operations, far under the arithmetic bound.
//
// Design. One thread a lane of one (example, bag): a float4 where the row
// is a whole number of float4 and both [.., D] buffers are 16-byte
// aligned, so that a 128-wide row is one warp's 512 B, read and written
// with 16-byte accesses; else a float, the same code on scalar lanes.
// Consecutive lanes lie on consecutive addresses, and consecutive warps
// walk an example's bags in slot order, so the pack streams through in its
// own order. A thread issues the loads of kUnroll slots of its bag before
// it adds them (bags run from 1 to 100 slots), and the sums keep slot
// order. The bag table, at most kMaxBags entries, is a __grid_constant__
// kernel parameter, read from the constant bank; a warp reads one entry of
// it. The pack and the gradient are touched once: loads and stores evict
// first. No shared memory, no atomics, nothing allocated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBags = 256;    // entries of the bag table
constexpr int kThreads = 128;    // threads a block
constexpr int kUnroll = 8;       // slots in flight a thread

struct BagTable {
  int start[kMaxBags];
  int k[kMaxBags];
  int mean[kMaxBags];
};

__device__ __forceinline__ float add_product(float acc, float w, float r) {
  return __fadd_rn(acc, __fmul_rn(w, r));
}

__device__ __forceinline__ float4 add_product(float4 acc, float w, float4 r) {
  return make_float4(add_product(acc.x, w, r.x), add_product(acc.y, w, r.y),
                     add_product(acc.z, w, r.z), add_product(acc.w, w, r.w));
}

__device__ __forceinline__ float scale(float a, float w) {
  return __fmul_rn(w, a);
}

__device__ __forceinline__ float4 scale(float4 a, float w) {
  return make_float4(scale(a.x, w), scale(a.y, w), scale(a.z, w),
                     scale(a.w, w));
}

__device__ __forceinline__ float divide(float a, float d) {
  return __fdiv_rn(a, d);
}

__device__ __forceinline__ float4 divide(float4 a, float d) {
  return make_float4(divide(a.x, d), divide(a.y, d), divide(a.z, d),
                     divide(a.w, d));
}

__device__ __forceinline__ void set_zero(float* a) { *a = 0.f; }

__device__ __forceinline__ void set_zero(float4* a) {
  *a = make_float4(0.f, 0.f, 0.f, 0.f);
}

// max(sum of the bag's weights in slot order, 1e-9), NaN kept as
// torch.clamp keeps it
__device__ __forceinline__ float denominator(const float* __restrict__ wb,
                                             int k) {
  float den = 0.f;
  for (int t = 0; t < k; ++t) den = __fadd_rn(den, __ldg(wb + t));
  return den < 1e-9f ? 1e-9f : den;
}

// V, the lane, is float4 or float; nvec lanes a row
template <typename V>
__global__ void __launch_bounds__(kThreads)
bag_pool_kernel(const V* __restrict__ rows, const float* __restrict__ w,
                V* __restrict__ out, const __grid_constant__ BagTable bags,
                int64_t items, int tot_k, int nbags, int nvec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= items) return;
  const int v = static_cast<int>(i % nvec);
  const int64_t bj = i / nvec;
  const int j = static_cast<int>(bj % nbags);
  const int64_t b = bj / nbags;
  const int start = bags.start[j], k = bags.k[j];
  const float* wb = w + b * tot_k + start;
  const V* rb = rows + (b * tot_k + start) * nvec + v;
  V acc;
  set_zero(&acc);
  float den = 0.f;
  for (int t = 0; t < k; t += kUnroll) {
    float ww[kUnroll];
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < k) {
        ww[u] = __ldg(wb + t + u);
        r[u] = __ldcs(rb + static_cast<int64_t>(t + u) * nvec);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < k) {
        acc = add_product(acc, ww[u], r[u]);
        den = __fadd_rn(den, ww[u]);
      }
    }
  }
  if (bags.mean[j]) acc = divide(acc, den < 1e-9f ? 1e-9f : den);
  out[bj * nvec + v] = acc;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
bag_pool_grad_kernel(const V* __restrict__ g, const float* __restrict__ w,
                     V* __restrict__ grad_rows,
                     const __grid_constant__ BagTable bags, int64_t items,
                     int tot_k, int nbags, int nvec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= items) return;
  const int v = static_cast<int>(i % nvec);
  const int64_t bj = i / nvec;
  const int j = static_cast<int>(bj % nbags);
  const int64_t b = bj / nbags;
  const int start = bags.start[j], k = bags.k[j];
  const float* wb = w + b * tot_k + start;
  V gv = __ldcs(g + bj * nvec + v);
  if (bags.mean[j]) gv = divide(gv, denominator(wb, k));
  V* dst = grad_rows + (b * tot_k + start) * nvec + v;
  for (int t = 0; t < k; t += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < k)
        __stcs(dst + static_cast<int64_t>(t + u) * nvec,
               scale(gv, __ldg(wb + t + u)));
    }
  }
}

// The bag table from the host's int triples (start, k, mean) a bag; false
// where it does not describe consecutive bags covering [0, tot_k).
bool read_bags(const int* table, int nbags, int tot_k, BagTable* bags) {
  if (nbags <= 0 || nbags > kMaxBags) return false;
  int at = 0;
  for (int j = 0; j < nbags; ++j) {
    bags->start[j] = table[3 * j];
    bags->k[j] = table[3 * j + 1];
    bags->mean[j] = table[3 * j + 2];
    if (bags->start[j] != at || bags->k[j] < 1) return false;
    at += bags->k[j];
  }
  return at == tot_k;
}

// float4 lanes where a row of dim floats is a whole number of them and
// both [.., dim] buffers are 16-byte aligned
bool wide_lanes(const float* a, const float* b, int dim) {
  return dim % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// pool (forward) or spread (backward) on lanes V: src [batch, *, dim] to
// dst [batch, *, dim]
template <typename V>
void launch(bool forward, const float* src, const float* w, float* dst,
            const BagTable& bags, int64_t batch, int tot_k, int nbags,
            int dim, cudaStream_t stream) {
  const int nvec = dim / static_cast<int>(sizeof(V) / sizeof(float));
  const int64_t items = batch * nbags * nvec;
  const unsigned blocks =
      static_cast<unsigned>((items + kThreads - 1) / kThreads);
  if (forward)
    bag_pool_kernel<V><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const V*>(src), w, reinterpret_cast<V*>(dst), bags,
        items, tot_k, nbags, nvec);
  else
    bag_pool_grad_kernel<V><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const V*>(src), w, reinterpret_cast<V*>(dst), bags,
        items, tot_k, nbags, nvec);
}

int run(bool forward, const float* src, const float* w, const int* table,
        float* dst, int64_t batch, int tot_k, int nbags, int dim,
        cudaStream_t stream) {
  BagTable bags;
  if (dim <= 0 || !read_bags(table, nbags, tot_k, &bags))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (wide_lanes(src, dst, dim))
    launch<float4>(forward, src, w, dst, bags, batch, tot_k, nbags, dim,
                   stream);
  else
    launch<float>(forward, src, w, dst, bags, batch, tot_k, nbags, dim,
                  stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows [batch, tot_k, dim] and out [batch, nbags, dim] f32, contiguous;
// w [batch, tot_k] f32 contiguous; table: 3 * nbags host ints (start, k,
// mean) of consecutive bags covering [0, tot_k), nbags <= 256. Returns
// cudaGetLastError() after the launch.
extern "C" int easyrec_bag_pool(const float* rows, const float* w,
                                const int* table, float* out, int64_t batch,
                                int tot_k, int nbags, int dim,
                                cudaStream_t stream) {
  return run(true, rows, w, table, out, batch, tot_k, nbags, dim, stream);
}

// g [batch, nbags, dim] and grad_rows [batch, tot_k, dim] f32, contiguous;
// w and table as above. Writes every element of grad_rows. Returns
// cudaGetLastError() after the launch.
extern "C" int easyrec_bag_pool_grad(const float* g, const float* w,
                                     const int* table, float* grad_rows,
                                     int64_t batch, int tot_k, int nbags,
                                     int dim, cudaStream_t stream) {
  return run(false, g, w, table, grad_rows, batch, tot_k, nbags, dim,
             stream);
}
