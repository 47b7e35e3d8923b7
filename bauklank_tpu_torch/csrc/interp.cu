// banded_interp: the fast engine's pitch-map gather.
//
// Replaces the TPU kernel bauklank_tpu/ops/pallas/interp.py
// (banded_interp).  x [S, P, bins], pos [S, bins_out] (monotone per
// stream) -> out [S, P, bins_out]: linear interpolation of every row of
// stream s at that stream's positions, computing the TPU kernel's windowed
// function (not its matrix-unit mechanics).  With win = min(window + 128,
// bins), each 128-wide output tile t reads the input window
//
//     start = ((clip(floor(pos[s, 128 t]) - 1, 0, bins - win)) / 128) * 128
//
// and for each output band j
//
//     rel = pos - start;  i0 = floor(rel);  w = rel - i0
//     out = x[start + i0] * ((1 - w) * ok(i0)) + x[start + i0 + 1] * (w * ok(i0 + 1))
//
// where a tap is ok only inside the window [0, win) and inside [0, bins):
// a tap the window does not cover reads 0, as on the TPU (which is why a
// tile spanning more than the window, below about -31 semitones, drops
// taps).  Every product and the sum are rounded on their own (__fmul_rn,
// __fadd_rn, and the library is built with --fmad=false), the order of the
// plain version, so the result is bit-identical to it.
//
// What bounds it on the H100: device-memory bandwidth.  Each output costs
// two taps that neighbouring threads share (L1), one position that the
// P rows of a stream share (L2), and one write: about 4 bytes read and 4
// written per output, ~0.7 GB a launch at the 128-voice preset pool.
//
// Design: one thread per (s, p, j), j fastest, so a warp writes 32
// consecutive outputs (coalesced) and, positions being monotone, reads
// its taps from a few consecutive cache lines.  The TPU kernel's DMA of a
// 128-aligned window into VMEM and its comparison-built interpolation
// matrix existed to put the gather on the matrix unit; on Hopper it is
// two direct loads.  Offsets are 64-bit (S * P * bins reaches 8.8e7 at
// the preset pool and more beyond it).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__global__ void banded_interp_kernel(const float* __restrict__ x,
                                     const float* __restrict__ pos,
                                     float* __restrict__ out, int p_n,
                                     int bins, int bins_out, int win,
                                     long long total) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % bins_out);
  const long long row = t / bins_out;            // s * P + p
  const long long s = row / p_n;
  const float* ps = pos + s * bins_out;
  const int hi = max(bins - win, 0);
  const int first = static_cast<int>(floorf(ps[(j / kTile) * kTile])) - 1;
  const int start = (min(max(first, 0), hi) / kTile) * kTile;
  const float rel = __fsub_rn(ps[j], static_cast<float>(start));
  const float f0 = floorf(rel);
  const int i0 = static_cast<int>(f0);
  const float w = __fsub_rn(rel, f0);
  const int g0 = start + i0;
  const bool ok0 = i0 >= 0 && i0 < win && g0 >= 0 && g0 < bins;
  const bool ok1 = i0 + 1 >= 0 && i0 + 1 < win && g0 + 1 >= 0 && g0 + 1 < bins;
  const float a = ok0 ? __fsub_rn(1.0f, w) : 0.0f;
  const float b = ok1 ? w : 0.0f;
  const float* xr = x + row * bins;
  const float x0 = ok0 ? xr[g0] : 0.0f;
  const float x1 = ok1 ? xr[g0 + 1] : 0.0f;
  out[t] = __fadd_rn(__fmul_rn(x0, a), __fmul_rn(x1, b));
}

}  // namespace

extern "C" int bk_banded_interp(const float* x, const float* pos, float* out,
                                int s_n, int p_n, int bins, int bins_out,
                                int win, cudaStream_t stream) {
  const long long total = static_cast<long long>(s_n) * p_n * bins_out;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  banded_interp_kernel<<<blocks, threads, 0, stream>>>(x, pos, out, p_n, bins,
                                                       bins_out, win, total);
  return static_cast<int>(cudaGetLastError());
}
