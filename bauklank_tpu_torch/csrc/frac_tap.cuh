// The two-tap linear interpolation shared by frac_gather.cu and
// chainfetch.cu: one rounding sequence, written once, so that the fused
// fetch equals the gathers it replaces bit for bit.
//
//     i0 = floor(pos);  frac = pos - i0;  ok(i) = 0 <= i < B
//     out = (v[i0] * ok(i0)) * (1 - frac) + (v[i0 + 1] * ok(i0 + 1)) * frac
//
// Every product and the sum round separately (__fmul_rn, __fadd_rn; the
// library is built with --fmad=false): the rounding sequence of
// engine.spectral._get_fractional.

#pragma once

#include <cuda_runtime.h>

namespace bk {

struct FracTap {
  int c0, c1;       // the two rows, clamped into [0, B)
  float ok0, ok1;   // 1 where the unclamped row lies in [0, B), else 0
  float w0, frac;   // the weights 1 - frac and frac
};

__device__ __forceinline__ FracTap frac_tap(float pos, int b_n) {
  const float f0 = floorf(pos);
  const int i0 = static_cast<int>(f0);
  const int i1 = i0 + 1;
  FracTap t;
  t.frac = __fsub_rn(pos, f0);
  t.w0 = __fsub_rn(1.0f, t.frac);
  t.ok0 = (i0 >= 0 && i0 < b_n) ? 1.0f : 0.0f;
  t.ok1 = (i1 >= 0 && i1 < b_n) ? 1.0f : 0.0f;
  t.c0 = min(max(i0, 0), b_n - 1);
  t.c1 = min(max(i1, 0), b_n - 1);
  return t;
}

__device__ __forceinline__ float frac_mix(float a0, float a1, const FracTap& t) {
  const float v0 = __fmul_rn(a0, t.ok0);
  const float v1 = __fmul_rn(a1, t.ok1);
  return __fadd_rn(__fmul_rn(v0, t.w0), __fmul_rn(v1, t.frac));
}

}  // namespace bk
