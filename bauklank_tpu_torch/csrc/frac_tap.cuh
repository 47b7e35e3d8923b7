// The two-tap linear interpolation shared by frac_gather.cu and
// chainfetch.cu: one rounding sequence and one set of row movers, written
// once, so that the fused fetch equals the gathers it replaces bit for bit
// and moves its rows the same way.
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

// P consecutive floats, moved at the widest vector the row stride allows
// (the wrappers check that every base pointer is 16-byte aligned)
template <int P>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P / 4; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src) + i);
      v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z, v[4 * i + 3] = x.w;
    }
  } else if constexpr (P % 2 == 0) {
#pragma unroll
    for (int i = 0; i < P / 2; ++i) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(src) + i);
      v[2 * i] = x.x, v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = __ldg(src + i);
  }
}

template <int P>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (P % 2 == 0) {
#pragma unroll
    for (int i = 0; i < P / 2; ++i)
      reinterpret_cast<float2*>(dst)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) dst[i] = v[i];
  }
}

// out[0:P] = the interpolation of the rows of `base` (row stride P) at `tap`
template <int P>
__device__ __forceinline__ void mix_row(const float* __restrict__ base,
                                        const FracTap& tap, float* out) {
  float a0[P], a1[P];
  load_row<P>(base + static_cast<long long>(tap.c0) * P, a0);
  load_row<P>(base + static_cast<long long>(tap.c1) * P, a1);
#pragma unroll
  for (int q = 0; q < P; ++q) out[q] = frac_mix(a0[q], a1[q], tap);
}

}  // namespace bk
