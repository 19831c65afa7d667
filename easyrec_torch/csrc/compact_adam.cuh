// Compact lazy Adam of one table element (easyrec_torch), shared by K2
// (rmw_adam.cu) and K3 (rmw_fused_adam.cu).
//
// The block math of sparse_adam().compact_math (easyrec_tpu/optim/
// sparse.py:186-198): m and v are a bf16 pair bit-packed in one f32 slot,
// m in the top 16 bits and v in the low 16; the update uses the
// pre-rounding f32 moments, and the moments are repacked with
// round-to-nearest-even integer rounding. Every operation is an explicit
// IEEE intrinsic (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so nothing
// contracts into an FMA and both kernels repeat the roundings of their
// plain versions (packed_table.rmw_adam_plain) bit for bit.

#pragma once

#include <cstdint>

namespace easyrec {

// round-to-nearest-even bf16 bits in the top 16 of a u32
// (optim/sparse.py _bf16_bits)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// One element: weight *w and packed moments *mv from summed gradient g,
// with lr, c1 = 1/(1-b1^t) and c2 = 1/(1-b2^t).
__device__ __forceinline__ void compact_adam(float* w, uint32_t* mv, float g,
                                             float lr, float c1, float c2,
                                             float b1, float omb1, float b2,
                                             float omb2, float eps) {
  const uint32_t bits = *mv;
  const float m = __uint_as_float(bits & 0xFFFF0000u);
  const float v = __uint_as_float(bits << 16);
  const float m_new = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
  const float v_new =
      __fadd_rn(__fmul_rn(b2, v), __fmul_rn(omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(-lr, __fmul_rn(m_new, c1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v_new, c2)), eps);
  *w = __fadd_rn(*w, __fdiv_rn(num, den));
  *mv = bf16_bits(m_new) | (bf16_bits(v_new) >> 16);
}

}  // namespace easyrec
