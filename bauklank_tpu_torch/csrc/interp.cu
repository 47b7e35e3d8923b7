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
// P rows of a stream share, and one write: about 4 bytes read and 4
// written per output, ~0.7 GB a launch at the 128-voice preset pool.
//
// Design: the taps of an output band depend only on (s, j), so they are
// computed once and reused over the rows.  A block owns one stream, one
// 128-band output tile (one `start`) and a chunk of kRows rows; its 128
// threads take one band each, form g0, the two weights and the two `ok`
// flags once, in registers, then take the rows: two loads, two products,
// one sum and one store per output, the four rows' eight tap loads all in
// flight before the first is used.  Nothing divides per output; the row
// offsets advance by `bins` and `bins_out`.  A warp writes 32 consecutive outputs
// (a full line) and, positions being monotone, reads its taps from a few
// consecutive lines.  A second entry point, bk_banded_interp_c, takes
// interleaved complex rows, x [S, P, bins, 2] -> out [S, P, bins_out, 2]:
// each tap is one float2 load and each output one float2 store, the
// arithmetic per component unchanged, so complex spectra need no planar
// copy before the gather and none after it.  The TPU kernel's DMA of a
// 128-aligned window into VMEM and its comparison-built interpolation
// matrix existed to put the gather on the matrix unit; on Hopper it is
// two direct loads.  Offsets are 64-bit (S * P * bins reaches 8.8e7 at
// the preset pool and more beyond it).  kRows = 4 was chosen from the
// times on the card at the fast pool's shapes (PERF.md): the interleaved
// spectra are 4% slower at 8 rows, 8-11% at 2, 16, 32 and 64, the planar
// rows within 1% from 4 to 16; more, smaller blocks hide the loads'
// latency better than longer loops save tap arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
// rows a block takes: their taps are all loaded before any is used
constexpr int kRows = 4;

__device__ __forceinline__ float mix(float x0, float x1, bool ok0, bool ok1, float a,
                                     float b) {
  return __fadd_rn(__fmul_rn(ok0 ? x0 : 0.0f, a), __fmul_rn(ok1 ? x1 : 0.0f, b));
}

__device__ __forceinline__ float2 mix(float2 x0, float2 x1, bool ok0, bool ok1, float a,
                                      float b) {
  return make_float2(mix(x0.x, x1.x, ok0, ok1, a, b), mix(x0.y, x1.y, ok0, ok1, a, b));
}

// T = float (planar rows) or float2 (interleaved complex rows)
template <typename T>
__global__ void __launch_bounds__(kTile)
banded_interp_kernel(const T* __restrict__ x, const float* __restrict__ pos,
                     T* __restrict__ out, int s_n, int p_n, int bins, int bins_out,
                     int win) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, p_n - r0);
  const int hi = max(bins - win, 0);
  for (int s = blockIdx.z; s < s_n; s += gridDim.z) {
    const float* ps = pos + static_cast<long long>(s) * bins_out;
    const int first = static_cast<int>(floorf(ps[blockIdx.x * kTile])) - 1;
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
    // a tap that is not ok reads band 0 and is replaced by 0 before use
    const int c0 = ok0 ? g0 : 0, c1 = ok1 ? g0 + 1 : 0;
    const long long row = static_cast<long long>(s) * p_n + r0;
    const T* xr = x + row * bins;
    T* o = out + row * bins_out + j;
    if (rows == kRows) {
      T x0[kRows], x1[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        x0[i] = __ldg(xr + static_cast<long long>(i) * bins + c0);
        x1[i] = __ldg(xr + static_cast<long long>(i) * bins + c1);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        o[static_cast<long long>(i) * bins_out] = mix(x0[i], x1[i], ok0, ok1, a, b);
    } else {
      for (int r = 0; r < rows; ++r) {
        *o = mix(__ldg(xr + c0), __ldg(xr + c1), ok0, ok1, a, b);
        xr += bins;
        o += bins_out;
      }
    }
  }
}

template <typename T>
int launch(const T* x, const float* pos, T* out, int s_n, int p_n, int bins,
           int bins_out, int win, cudaStream_t stream) {
  if (s_n == 0 || p_n == 0 || bins_out == 0) return 0;
  const dim3 grid(bins_out / kTile, (p_n + kRows - 1) / kRows, s_n < 65535 ? s_n : 65535);
  banded_interp_kernel<T><<<grid, kTile, 0, stream>>>(x, pos, out, s_n, p_n, bins,
                                                      bins_out, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bk_banded_interp(const float* x, const float* pos, float* out,
                                int s_n, int p_n, int bins, int bins_out,
                                int win, cudaStream_t stream) {
  return launch<float>(x, pos, out, s_n, p_n, bins, bins_out, win, stream);
}

// x, out: interleaved (re, im) pairs, 8-byte aligned
extern "C" int bk_banded_interp_c(const float* x, const float* pos, float* out,
                                  int s_n, int p_n, int bins, int bins_out,
                                  int win, cudaStream_t stream) {
  return launch<float2>(reinterpret_cast<const float2*>(x), pos,
                        reinterpret_cast<float2*>(out), s_n, p_n, bins, bins_out, win,
                        stream);
}
