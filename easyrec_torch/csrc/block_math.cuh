// The block math of the sparse optimizers, one table element at a time
// (easyrec_torch), shared by K2 (rmw_rows.cu) and K3 (rmw_fused.cu).
//
// Each functor is the counterpart of one block_math of easyrec_tpu/optim/
// sparse.py (:89-251) and of its plain version in easyrec_torch/optim/
// sparse.py (`block`, `compact_block`), and of the EV aux tables' add and
// set maths. kParts is the number of physical
// parts of a row, [w | s1 | s2], each `dim` wide; x[p] is one element of
// part p (for compact Adam x[1] carries the bf16 pair (m, v) as the bits of
// an f32), g its summed gradient. The learning rate and Adam's bias
// corrections come from the device tensor `hypers` ([lr] or [lr, c1, c2]),
// the static hyperparameters from `Consts`, in the order of each
// optimizer's kernel_math(), already rounded to f32 as JAX rounds a Python
// float against an f32 array.
//
// Every operation is an explicit IEEE intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fsqrt_rn, __fdiv_rn), so nothing contracts into an FMA and
// the kernels repeat the roundings of the plain versions bit for bit. The
// JAX package on the CPU may contract a*b + c into an FMA and lowers rsqrt
// its own way; the CPU tests hold the plain versions to it within a stated
// tolerance.

#pragma once

#include <cstdint>

namespace easyrec {

// math ids: easyrec_torch/optim/sparse.py MATH_*
enum MathId : int {
  kSgd = 0,
  kMomentum = 1,
  kAdagrad = 2,
  kAdam = 3,
  kCompactAdam = 4,
  kFtrl = 5,
  kEvAdd = 6,
  kEvSet = 7,
};

constexpr int kMaxConsts = 8;      // optim/sparse.py MAX_CONSTS

struct Consts {
  float c[kMaxConsts];
};

// round-to-nearest-even bf16 bits in the top 16 of a u32
// (optim/sparse.py bf16_bits)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// 1 / sqrt(x) with two correct roundings (optim/sparse.py _rsqrt); the
// JAX package's lax.rsqrt
__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.f, __fsqrt_rn(x));
}

// sparse_sgd: w - lr g
struct SgdMath {
  static constexpr int kParts = 1;
  float lr;
  __device__ SgdMath(const float* hyp, const Consts&) : lr(hyp[0]) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    x[0] = __fsub_rn(x[0], __fmul_rn(lr, g));
  }
};

// sparse_momentum: m' = momentum m + g; w - lr m'.  Consts: momentum
struct MomentumMath {
  static constexpr int kParts = 2;
  float lr, momentum;
  __device__ MomentumMath(const float* hyp, const Consts& k)
      : lr(hyp[0]), momentum(k.c[0]) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    const float m = __fadd_rn(__fmul_rn(momentum, x[1]), g);
    x[0] = __fsub_rn(x[0], __fmul_rn(lr, m));
    x[1] = m;
  }
};

// sparse_adagrad: acc' = acc + g^2; w - (lr g) rsqrt(acc' + eps).
// Consts: eps
struct AdagradMath {
  static constexpr int kParts = 2;
  float lr, eps;
  __device__ AdagradMath(const float* hyp, const Consts& k)
      : lr(hyp[0]), eps(k.c[0]) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    const float acc = __fadd_rn(x[1], __fmul_rn(g, g));
    x[0] = __fsub_rn(x[0],
                     __fmul_rn(__fmul_rn(lr, g), rsqrt_rn(__fadd_rn(acc, eps))));
    x[1] = acc;
  }
};

// sparse_adam's update of one element from f32 moments m, v: the new
// moments and w's update, -lr (m' c1) / (sqrt(v' c2) + eps), minus
// (lr weight_decay) w where weight_decay is set.
// Consts: b1, 1-b1, b2, 1-b2, eps, weight_decay
struct AdamCore {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  __device__ AdamCore(const float* hyp, const Consts& k)
      : lr(hyp[0]), c1(hyp[1]), c2(hyp[2]), b1(k.c[0]), omb1(k.c[1]),
        b2(k.c[2]), omb2(k.c[3]), eps(k.c[4]), wd(k.c[5]) {}
  __device__ __forceinline__ float step(float w, float g, float& m,
                                        float& v) const {
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(omb2, __fmul_rn(g, g)));
    const float num = __fmul_rn(-lr, __fmul_rn(m, c1));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), eps);
    float upd = __fdiv_rn(num, den);
    if (wd != 0.f) upd = __fsub_rn(upd, __fmul_rn(__fmul_rn(lr, wd), w));
    return __fadd_rn(w, upd);
  }
};

// sparse_adam, 3-part [w | m | v]
struct AdamMath {
  static constexpr int kParts = 3;
  AdamCore core;
  __device__ AdamMath(const float* hyp, const Consts& k) : core(hyp, k) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    x[0] = core.step(x[0], g, x[1], x[2]);
  }
};

// sparse_adam().compact_math, [w | mv]: m and v unpacked from the bf16
// pair, the update from the pre-rounding f32 moments, the moments repacked
// with round-to-nearest-even integer rounding
struct CompactAdamMath {
  static constexpr int kParts = 2;
  AdamCore core;
  __device__ CompactAdamMath(const float* hyp, const Consts& k)
      : core(hyp, k) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    const uint32_t bits = __float_as_uint(x[1]);
    float m = __uint_as_float(bits & 0xFFFF0000u);
    float v = __uint_as_float(bits << 16);
    x[0] = core.step(x[0], g, m, v);
    x[1] = __uint_as_float(bf16_bits(m) | (bf16_bits(v) >> 16));
  }
};

// acc^p as the plain version computes it (optim/sparse.py ftrl_pow): ATen's
// pow special-cases some exponents (0.5 becomes sqrt), so those are written
// out on both sides, each with the same IEEE roundings; any other p is
// powf here and torch.pow there.
__device__ __forceinline__ float ftrl_pow(float x, float p) {
  if (p == 0.5f) return __fsqrt_rn(x);
  if (p == -0.5f) return rsqrt_rn(x);
  if (p == 1.f) return x;
  if (p == 2.f) return __fmul_rn(x, x);
  if (p == -1.f) return __fdiv_rn(1.f, x);
  return powf(x, p);
}

// sparse_ftrl, [w | accum | z]: acc' = acc + g^2;
// sigma = (acc'^p - acc^p) / lr; z' = z + g' - sigma w with g' = g +
// 2 l2_shrinkage w where l2_shrinkage is set; w' = 0 where |z'| <= l1, else
// -(z' - sign(z') l1) / (acc'^p / lr + 2 l2).
// Consts: p (= -learning_rate_power), l1, 2 l2, 2 l2_shrinkage, shrink?
struct FtrlMath {
  static constexpr int kParts = 3;
  float lr, p, l1, two_l2, two_l2s;
  bool shrink;
  __device__ FtrlMath(const float* hyp, const Consts& k)
      : lr(hyp[0]), p(k.c[0]), l1(k.c[1]), two_l2(k.c[2]), two_l2s(k.c[3]),
        shrink(k.c[4] != 0.f) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    const float w = x[0];
    const float acc = __fadd_rn(x[1], __fmul_rn(g, g));
    const float pow_new = ftrl_pow(acc, p);
    const float sigma = __fdiv_rn(__fsub_rn(pow_new, ftrl_pow(x[1], p)), lr);
    const float gz = shrink ? __fadd_rn(g, __fmul_rn(two_l2s, w)) : g;
    const float z = __fsub_rn(__fadd_rn(x[2], gz), __fmul_rn(sigma, w));
    const float sign = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
    const float den = __fadd_rn(__fdiv_rn(pow_new, lr), two_l2);
    x[0] = fabsf(z) <= l1
               ? 0.f
               : __fdiv_rn(-__fsub_rn(z, __fmul_rn(sign, l1)), den);
    x[1] = acc;
    x[2] = z;
  }
};

// The EV aux tables' maths (easyrec_tpu/features/ev.py:202-206), one part
// of dim 1. add_math, the admission count: c + g, g the row's occurrences
// in the batch. set_math, the last-seen step: every touched row set to
// hypers[0], the step as f32.
struct EvAddMath {
  static constexpr int kParts = 1;
  __device__ EvAddMath(const float*, const Consts&) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float g) const {
    x[0] = __fadd_rn(x[0], g);
  }
};

struct EvSetMath {
  static constexpr int kParts = 1;
  float step;
  __device__ EvSetMath(const float* hyp, const Consts&) : step(hyp[0]) {}
  __device__ __forceinline__ void operator()(float (&x)[kParts],
                                             float) const {
    x[0] = step;
  }
};

template <typename M>
struct MathTag {
  using type = M;
};

// f(MathTag<functor of `id`>{}) on the host, so a caller instantiates its
// kernels once per math; false for an unknown id.
template <typename F>
inline bool dispatch_math(int id, F f) {
  switch (id) {
    case kSgd: f(MathTag<SgdMath>{}); return true;
    case kMomentum: f(MathTag<MomentumMath>{}); return true;
    case kAdagrad: f(MathTag<AdagradMath>{}); return true;
    case kAdam: f(MathTag<AdamMath>{}); return true;
    case kCompactAdam: f(MathTag<CompactAdamMath>{}); return true;
    case kFtrl: f(MathTag<FtrlMath>{}); return true;
    case kEvAdd: f(MathTag<EvAddMath>{}); return true;
    case kEvSet: f(MathTag<EvSetMath>{}); return true;
    default: return false;
  }
}

// One element of a row: part p of column c at row[c + p * dim], read,
// updated by `math` with summed gradient g, and written back.
template <typename M>
__device__ __forceinline__ void update_element(const M& math,
                                               float* __restrict__ row,
                                               int dim, int c, float g) {
  float x[M::kParts];
#pragma unroll
  for (int p = 0; p < M::kParts; ++p) x[p] = row[c + p * dim];
  math(x, g);
#pragma unroll
  for (int p = 0; p < M::kParts; ++p) row[c + p * dim] = x[p];
}

}  // namespace easyrec
