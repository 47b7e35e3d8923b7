// frac_gather and pallas_gather: the fidelity step's fractional row gather.
//
// Replaces the TPU kernel bauklank_tpu/ops/pallas/wintaps.py
// (window_taps_fused) together with its caller's weighted combine
// (bauklank_tpu/engine/spectral.py, _hop_inputs_hoisted), the generic
// one-hot block gathers (bauklank_tpu/ops/blockgather.py) that serve the
// MINSTD regime (time factor > 2), and the TPU kernel
// bauklank_tpu/ops/pallas/selection.py (pallas_gather), which computes the
// same function: one device function, two entry points (bk_frac_gather,
// bk_pallas_gather).  planes [N, B, P], pos [N, K] -> out [N, K, P]:
//
//     i0 = floor(pos);  frac = pos - i0;  ok(i) = 0 <= i < B
//     out = (v[i0] * ok(i0)) * (1 - frac) + (v[i0 + 1] * ok(i0 + 1)) * frac
//
// with every product and the sum rounded separately (frac_tap.cuh): the
// exact rounding sequence of engine.spectral._get_fractional, so the
// result is bit-identical to the plain version.  One formula serves both
// the deterministic regime (positions within a few bands of the map) and
// the MINSTD regime (arbitrary positions), with no branch between them;
// the TPU kernels' shape limits (a band axis that splits into at most 128
// blocks, a lane-tileable K) do not exist here.
//
// What bounds it on the H100: device-memory bandwidth, N * K * P reads of
// two taps and N * K * P writes.  The TPU forms existed to put this gather
// on the matrix unit (one-hot block matmuls, shared-window strips); on
// Hopper a gather is a direct indexed load.
//
// Design: one thread per (n, k) output row, looping over the P planes.
// The P plane values of a band are contiguous, so a thread's loads of one
// tap fall in one or two 32-byte sectors, and neighbouring k read
// neighbouring bands (positions are near-monotone in k), which L1 merges.

#include <cuda_runtime.h>

#include "frac_tap.cuh"

namespace {

__global__ void frac_gather_kernel(const float* __restrict__ planes,
                                   const float* __restrict__ pos,
                                   float* __restrict__ out, int n_n, int b_n,
                                   int p_n, int k_n) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(n_n) * k_n) return;
  const long long n = t / k_n;
  const bk::FracTap tap = bk::frac_tap(pos[t], b_n);
  const float* row = planes + n * b_n * static_cast<long long>(p_n);
  const float* r0 = row + static_cast<long long>(tap.c0) * p_n;
  const float* r1 = row + static_cast<long long>(tap.c1) * p_n;
  float* o = out + t * p_n;
  for (int q = 0; q < p_n; ++q) o[q] = bk::frac_mix(r0[q], r1[q], tap);
}

int launch(const float* planes, const float* pos, float* out, int n_n, int b_n,
           int p_n, int k_n, cudaStream_t stream) {
  const long long rows = static_cast<long long>(n_n) * k_n;
  if (rows == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  frac_gather_kernel<<<blocks, threads, 0, stream>>>(planes, pos, out, n_n, b_n,
                                                     p_n, k_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bk_frac_gather(const float* planes, const float* pos, float* out,
                              int n_n, int b_n, int p_n, int k_n,
                              cudaStream_t stream) {
  return launch(planes, pos, out, n_n, b_n, p_n, k_n, stream);
}

extern "C" int bk_pallas_gather(const float* planes, const float* pos, float* out,
                                int n_n, int b_n, int p_n, int k_n,
                                cudaStream_t stream) {
  return launch(planes, pos, out, n_n, b_n, p_n, k_n, stream);
}
