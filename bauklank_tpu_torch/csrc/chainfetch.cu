// chainfetch: the fidelity step's fused six-family fetch (deterministic
// regime, every stream at time factor <= 2).
//
// Replaces the TPU kernel bauklank_tpu/ops/pallas/chainfetch.py
// (chainfetch).  For each row n and band k it interpolates at six
// positions, with c = step[n] = clamp(time factor, 0.5, 2) and
// L = long_step:
//
//     pred    spec       @ input_bin[k]
//     down_s  spec       @ input_bin[k] - c
//     down_l  spec       @ input_bin[k] - L * c
//     us      spec       @ us_pos[k]
//     ul      spec       @ ul_pos[k]
//     comb    prev | en  @ input_bin[k]
//
// spec, prev [N, B, 2C], energy [N, B, C], input_bin, us_pos, ul_pos
// [N, B], step [N] -> five [N, 5B, 2C] (family-major: pred | down_s |
// down_l | us | ul) and comb [N, B, 3C].  Each value is the two-tap
// interpolation of frac_tap.cuh with zeros outside [0, B), the products
// and the sum rounded separately and the two differences rounded in
// float32, so the result equals, bit for bit, the two frac_gather
// launches it replaces (on the concatenated positions and planes).
//
// What bounds it on the H100: device-memory bandwidth.  Per (n, k) it must
// read 5C plane values and 3 positions and write 13C values; the twelve
// taps it loads fall within L * c + 2 bands of input_bin[k] (and of
// input_bin[k + 1], input_bin[k + L] for us, ul), so all but the first
// touch of a row is served by L1.
//
// Design: the TPU kernel's window tensor, one-hot selection matmul, band
// blocking and pre-shifted masks exist to run a gather on the matrix
// unit; here a gather is an indexed load.  One thread per (n, k), bands
// minor, so a warp reads 32 neighbouring positions and writes each
// family's 32 neighbouring rows in one coalesced store.  The taps are
// addressed directly from the positions: nothing assumes a monotone map,
// and the us/ul families need no tail repair.  With the channel count
// known at compile time (1 or 2) a row of planes moves as one float4 or
// float2; any other count takes the scalar form of the same arithmetic.
// Offsets are 64-bit (N * 5B * 2C exceeds 2^31 at large pools).

#include <cuda_runtime.h>

#include "frac_tap.cuh"

namespace {

// the five spec positions of band t (row n): pred, down_s, down_l, us, ul
__device__ __forceinline__ void family_positions(float ib, float c, int long_step,
                                                 float us, float ul, float (&pos)[5]) {
  pos[0] = ib;
  pos[1] = __fsub_rn(ib, c);
  pos[2] = __fsub_rn(ib, __fmul_rn(static_cast<float>(long_step), c));
  pos[3] = us;
  pos[4] = ul;
}

template <int C>
__global__ void chainfetch_kernel(const float* __restrict__ spec,
                                  const float* __restrict__ prev,
                                  const float* __restrict__ energy,
                                  const float* __restrict__ input_bin,
                                  const float* __restrict__ us_pos,
                                  const float* __restrict__ ul_pos,
                                  const float* __restrict__ step,
                                  float* __restrict__ five, float* __restrict__ comb,
                                  int n_n, int b_n, int long_step) {
  constexpr int PS = 2 * C;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(n_n) * b_n) return;
  const long long n = t / b_n;
  const long long k = t - n * b_n;
  const float ib = input_bin[t];
  float pos[5];
  family_positions(ib, step[n], long_step, us_pos[t], ul_pos[t], pos);

  const long long row0 = n * b_n;
  const float* srow = spec + row0 * PS;
  float* frow = five + row0 * 5 * PS;
  bk::FracTap tap0;
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    const bk::FracTap tap = bk::frac_tap(pos[f], b_n);
    if (f == 0) tap0 = tap;
    float out[PS];
    bk::mix_row<PS>(srow, tap, out);
    bk::store_row<PS>(frow + (static_cast<long long>(f) * b_n + k) * PS, out);
  }
  float out[3 * C];
  bk::mix_row<PS>(prev + row0 * PS, tap0, out);
  bk::mix_row<C>(energy + row0 * C, tap0, out + PS);
  bk::store_row<3 * C>(comb + t * 3 * C, out);
}

// any channel count: the same arithmetic, one float at a time
__global__ void chainfetch_kernel_any(const float* __restrict__ spec,
                                      const float* __restrict__ prev,
                                      const float* __restrict__ energy,
                                      const float* __restrict__ input_bin,
                                      const float* __restrict__ us_pos,
                                      const float* __restrict__ ul_pos,
                                      const float* __restrict__ step,
                                      float* __restrict__ five,
                                      float* __restrict__ comb, int n_n, int b_n,
                                      int c_n, int long_step) {
  const int ps = 2 * c_n;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(n_n) * b_n) return;
  const long long n = t / b_n;
  const long long k = t - n * b_n;
  const float ib = input_bin[t];
  float pos[5];
  family_positions(ib, step[n], long_step, us_pos[t], ul_pos[t], pos);

  const long long row0 = n * b_n;
  const float* srow = spec + row0 * ps;
  float* frow = five + row0 * 5 * ps;
  for (int f = 0; f < 5; ++f) {
    const bk::FracTap tap = bk::frac_tap(pos[f], b_n);
    const float* r0 = srow + static_cast<long long>(tap.c0) * ps;
    const float* r1 = srow + static_cast<long long>(tap.c1) * ps;
    float* o = frow + (static_cast<long long>(f) * b_n + k) * ps;
    for (int q = 0; q < ps; ++q) o[q] = bk::frac_mix(r0[q], r1[q], tap);
  }
  const bk::FracTap tap = bk::frac_tap(ib, b_n);
  float* o = comb + t * 3 * c_n;
  const float* p0 = prev + (row0 + tap.c0) * ps;
  const float* p1 = prev + (row0 + tap.c1) * ps;
  for (int q = 0; q < ps; ++q) o[q] = bk::frac_mix(p0[q], p1[q], tap);
  const float* e0 = energy + (row0 + tap.c0) * c_n;
  const float* e1 = energy + (row0 + tap.c1) * c_n;
  for (int q = 0; q < c_n; ++q) o[ps + q] = bk::frac_mix(e0[q], e1[q], tap);
}

}  // namespace

extern "C" int bk_chainfetch(const float* spec, const float* prev, const float* energy,
                             const float* input_bin, const float* us_pos,
                             const float* ul_pos, const float* step, float* five,
                             float* comb, int n_n, int b_n, int c_n, int long_step,
                             cudaStream_t stream) {
  const long long rows = static_cast<long long>(n_n) * b_n;
  if (rows == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  if (c_n == 1) {
    chainfetch_kernel<1><<<blocks, threads, 0, stream>>>(
        spec, prev, energy, input_bin, us_pos, ul_pos, step, five, comb, n_n, b_n,
        long_step);
  } else if (c_n == 2) {
    chainfetch_kernel<2><<<blocks, threads, 0, stream>>>(
        spec, prev, energy, input_bin, us_pos, ul_pos, step, five, comb, n_n, b_n,
        long_step);
  } else {
    chainfetch_kernel_any<<<blocks, threads, 0, stream>>>(
        spec, prev, energy, input_bin, us_pos, ul_pos, step, five, comb, n_n, b_n,
        c_n, long_step);
  }
  return static_cast<int>(cudaGetLastError());
}
