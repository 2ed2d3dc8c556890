// The device code of adam.cu: one Adam step of one f32 element, and of
// four neighbouring ones through 16-byte loads and stores.
//
// The step is the plain version's (volrt_torch/train/adam.py:
// adam_step_plain, torch.optim.Adam's single-tensor step on the CPU)
// operation for operation, each rounded where ATen's CPU kernels round it:
//
//   m = m + (1 - b1) (g - m)          lerp_, one FMA as ATen's fmadd
//   v = (v b2) + ((1 - b2) g) g       mul_, then addcmul_, one FMA
//   denom = sqrt(v) / sqrt(bc2) + eps
//   p = p + ((-step_size) m) / denom  addcdiv_: ATen's CPU kernel scales
//                                     the numerator before dividing
//   p = clamp(p, lo, hi)              NaN kept, as clamp_ keeps it
//
// Every other multiply, add, divide and square root is rounded on its own
// (__f*_rn, __fsqrt_rn). ATen's CPU square root of a long tensor is not
// always correctly rounded (an ulp off on 0.6-0.75 % of random elements),
// so where that happens p may differ from the plain version on the host by
// up to 3 or 4 ulps of the larger of p and its step, past the 2 asked of
// it (tests/test_torch_adam.py:STEP_ULPS); m and v never do.

#pragma once

#include <cuda_runtime.h>

namespace volrt {

struct AdamArgs {
  float* p;         // the leaf, updated in place
  const float* g;   // its gradient
  float* m;         // first moment (exp_avg), updated in place
  float* v;         // second moment (exp_avg_sq), updated in place
  long long n;      // elements of each
  float w1;         // 1 - beta1, the lerp's weight (under 0.5)
  float beta2;
  float w2;         // 1 - beta2
  float neg_step;   // -lr / (1 - beta1^t)
  float bc2_sqrt;   // sqrt(1 - beta2^t)
  float eps;
  float lo, hi;     // the clamp's bounds
  int clamp;        // 0: Adam alone
};

__device__ __forceinline__ float adam_element(const AdamArgs& a, float p,
                                              float g, float& m, float& v) {
  m = __fmaf_rn(a.w1, __fsub_rn(g, m), m);
  v = __fmaf_rn(__fmul_rn(a.w2, g), g, __fmul_rn(v, a.beta2));
  const float denom =
      __fadd_rn(__fdiv_rn(__fsqrt_rn(v), a.bc2_sqrt), a.eps);
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(a.neg_step, m), denom));
  if (a.clamp) {
    // Comparisons, so that a NaN passes through as clamp_ passes it.
    p = p < a.lo ? a.lo : p;
    p = p > a.hi ? a.hi : p;
  }
  return p;
}

// Elements 4 i .. 4 i + 3: each stream read once and p, m, v written
// once, 16 B a thread a stream, marked streaming (evict first): no element
// is read again in the pass.
__device__ __forceinline__ void adam_quad(const AdamArgs& a, long long i) {
  float4 p = __ldcs(reinterpret_cast<const float4*>(a.p) + i);
  const float4 g = __ldcs(reinterpret_cast<const float4*>(a.g) + i);
  float4 m = __ldcs(reinterpret_cast<const float4*>(a.m) + i);
  float4 v = __ldcs(reinterpret_cast<const float4*>(a.v) + i);
  p.x = adam_element(a, p.x, g.x, m.x, v.x);
  p.y = adam_element(a, p.y, g.y, m.y, v.y);
  p.z = adam_element(a, p.z, g.z, m.z, v.z);
  p.w = adam_element(a, p.w, g.w, m.w, v.w);
  __stcs(reinterpret_cast<float4*>(a.p) + i, p);
  __stcs(reinterpret_cast<float4*>(a.m) + i, m);
  __stcs(reinterpret_cast<float4*>(a.v) + i, v);
}

}  // namespace volrt
