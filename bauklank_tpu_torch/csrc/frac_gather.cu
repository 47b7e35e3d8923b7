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
// Design: P is a template parameter for P in {1, 2, 3, 4, 6} (one or two
// channels: an envelope, the spectra's 2C, prev|energy's 3C), so a row of
// planes moves through the row movers of frac_tap.cuh, shared with
// chainfetch.cu: one float4 at P = 4, float2s at P = 2 and 6, so a warp's
// store covers neighbouring addresses in 8- or 16-byte pieces.  A block
// owns one row n (blockIdx.y, no 64-bit division) and a tile of
// 512 positions; a thread takes two of them a block-stride apart,
// loads both positions, then all its taps (four independent row
// loads in flight), then mixes and stores.  Neighbouring k read
// neighbouring bands (positions are near-monotone in k), which L1 merges.
// At P = 1 with K a multiple of 4 a thread takes four consecutive k: one
// float4 of positions in, one float4 out.  Any other P takes the scalar
// kernel, the same arithmetic one float at a time.  Offsets are 64-bit:
// N * K * P may exceed 2^31 elements.
//
// Chosen from the times on the card at the fidelity pools' shapes
// (PERF.md has them all): two positions a thread (one is 3-15% slower at
// P = 2 and 4, four 0-3% slower at P = 4 and 6).  Where a row is not a
// whole number of 16-byte vectors (P = 3, 6) the stores could instead go
// through shared memory, the block staging its tile's rows and writing
// them back as consecutive float4s; that form read within 1% of the direct
// stores at both P, so the direct stores serve alone.

#include <cuda_runtime.h>

#include "frac_tap.cuh"

namespace {

constexpr int kThreads = 256;

// positions a thread takes, a block-stride apart
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;

template <int P>
__global__ void __launch_bounds__(kThreads)
frac_gather_kernel(const float* __restrict__ planes, const float* __restrict__ pos,
                   float* __restrict__ out, int n_n, int b_n, int k_n) {
  const int k0 = blockIdx.x * kTile + threadIdx.x;
  for (int n = blockIdx.y; n < n_n; n += gridDim.y) {
    const long long row0 = static_cast<long long>(n) * k_n;
    const float* prow = planes + static_cast<long long>(n) * b_n * P;
    float p[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = k0 + i * kThreads;
      p[i] = k < k_n ? pos[row0 + k] : 0.0f;
    }
    bk::FracTap tap[kPerThread];
    float a0[kPerThread][P], a1[kPerThread][P];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      tap[i] = bk::frac_tap(p[i], b_n);
      bk::load_row<P>(prow + static_cast<long long>(tap[i].c0) * P, a0[i]);
      bk::load_row<P>(prow + static_cast<long long>(tap[i].c1) * P, a1[i]);
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = k0 + i * kThreads;
      float v[P];
#pragma unroll
      for (int q = 0; q < P; ++q) v[q] = bk::frac_mix(a0[i][q], a1[i][q], tap[i]);
      if (k < k_n) bk::store_row<P>(out + (row0 + k) * P, v);
    }
  }
}

// P = 1, K a multiple of 4: four consecutive k a thread
__global__ void __launch_bounds__(kThreads)
frac_gather_p1x4_kernel(const float* __restrict__ planes, const float* __restrict__ pos,
                        float* __restrict__ out, int n_n, int b_n, int k_n) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (4 * g >= k_n) return;
  for (int n = blockIdx.y; n < n_n; n += gridDim.y) {
    const long long row0 = static_cast<long long>(n) * k_n;
    const float* prow = planes + static_cast<long long>(n) * b_n;
    const float4 p4 = reinterpret_cast<const float4*>(pos + row0)[g];
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
    bk::FracTap tap[4];
    float a0[4], a1[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tap[i] = bk::frac_tap(p[i], b_n);
      a0[i] = __ldg(prow + tap[i].c0);
      a1[i] = __ldg(prow + tap[i].c1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = bk::frac_mix(a0[i], a1[i], tap[i]);
    reinterpret_cast<float4*>(out + row0)[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// any P: the same arithmetic, one float at a time
__global__ void __launch_bounds__(kThreads)
frac_gather_kernel_any(const float* __restrict__ planes, const float* __restrict__ pos,
                       float* __restrict__ out, int n_n, int b_n, int p_n, int k_n) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= k_n) return;
  for (int n = blockIdx.y; n < n_n; n += gridDim.y) {
    const long long t = static_cast<long long>(n) * k_n + k;
    const bk::FracTap tap = bk::frac_tap(pos[t], b_n);
    const float* prow = planes + static_cast<long long>(n) * b_n * p_n;
    const float* r0 = prow + static_cast<long long>(tap.c0) * p_n;
    const float* r1 = prow + static_cast<long long>(tap.c1) * p_n;
    float* o = out + t * p_n;
    for (int q = 0; q < p_n; ++q) o[q] = bk::frac_mix(r0[q], r1[q], tap);
  }
}

template <int P>
void launch_p(const float* planes, const float* pos, float* out, int n_n, int b_n,
              int k_n, unsigned rows_y, cudaStream_t stream) {
  const dim3 grid((k_n + kTile - 1) / kTile, rows_y);
  frac_gather_kernel<P><<<grid, kThreads, 0, stream>>>(planes, pos, out, n_n, b_n, k_n);
}

int launch(const float* planes, const float* pos, float* out, int n_n, int b_n,
           int p_n, int k_n, cudaStream_t stream) {
  if (n_n == 0 || k_n == 0 || p_n == 0) return 0;
  const unsigned rows_y = static_cast<unsigned>(n_n < 65535 ? n_n : 65535);
  if (p_n == 1 && k_n % 4 == 0) {
    const dim3 grid((k_n / 4 + kThreads - 1) / kThreads, rows_y);
    frac_gather_p1x4_kernel<<<grid, kThreads, 0, stream>>>(planes, pos, out, n_n, b_n, k_n);
  } else if (p_n == 1) {
    launch_p<1>(planes, pos, out, n_n, b_n, k_n, rows_y, stream);
  } else if (p_n == 2) {
    launch_p<2>(planes, pos, out, n_n, b_n, k_n, rows_y, stream);
  } else if (p_n == 3) {
    launch_p<3>(planes, pos, out, n_n, b_n, k_n, rows_y, stream);
  } else if (p_n == 4) {
    launch_p<4>(planes, pos, out, n_n, b_n, k_n, rows_y, stream);
  } else if (p_n == 6) {
    launch_p<6>(planes, pos, out, n_n, b_n, k_n, rows_y, stream);
  } else {
    const dim3 grid((k_n + kThreads - 1) / kThreads, rows_y);
    frac_gather_kernel_any<<<grid, kThreads, 0, stream>>>(planes, pos, out, n_n, b_n,
                                                          p_n, k_n);
  }
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
